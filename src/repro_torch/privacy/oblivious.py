"""Oblivious-access mode for the sharded code store (server defense).

Port of ``repro.privacy.oblivious``. Even when payload contents are
privatized (§2.5), *which client's codes are touched when* is a side
channel: a storage observer watching partition I/O learns participation
schedules and client-to-shard bindings. :class:`ObliviousCodeStore` wraps
a :class:`~repro_torch.server.store.ShardedCodeStore` and makes every
operation's *touch sequence* independent of its arguments:

  * every op touches EVERY partition of the live grid exactly once, in an
    order drawn from ``np.random.default_rng((oblivious_seed, op))``, a
    pure function of (seed, op index, grid size): the ``access_log`` is
    the reference's bit for bit;
  * real work happens when the schedule reaches the relevant partition;
    every other touch is a dummy access of the same shape (a full
    partition scan for reads, a ledger probe for writes);
  * ``open_version`` pre-creates a version's full shard grid, so lazy
    partition creation cannot reveal which shard got first traffic.

Results are BIT-EXACT with the plain store: the plain ``get`` answers
from the minimum (version, shard) partition key holding a match, so the
oblivious scan collects every partition's candidate and answers from the
same minimum key. A ``get`` unpacks the matching record of every
partition that holds one (one ``unpack_codes`` launch each). Everything
else (``dataset``, ``codes``, ledgers, snapshots) delegates to the wrapped
store. :meth:`overhead` reports the touched/useful counters, the measured
cost of obliviousness.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.dvqae import DVQAEConfig
from repro_torch.server.store import ShardedCodeStore, StoreRecord
from repro_torch.wire.payload import CodePayload, LabelsLike


class ObliviousCodeStore:
    """Access-pattern-hiding facade over a ``ShardedCodeStore``.

    Same constructor surface as the plain sharded store plus
    ``oblivious_seed``, the schedule stream (an observer who knows it still
    learns nothing, because schedules never depend on the query; it makes
    runs replayable).
    """

    def __init__(self, cfg: DVQAEConfig, *, n_shards: int = 4,
                 capacity_samples: Optional[int] = None,
                 policy: str = "fifo", seed: int = 0, shard_fn=None,
                 oblivious_seed: int = 0):
        self.inner = ShardedCodeStore(
            cfg, n_shards=n_shards, capacity_samples=capacity_samples,
            policy=policy, seed=seed, shard_fn=shard_fn)
        self.oblivious_seed = int(oblivious_seed)
        self._op_counter = 0
        #: (op name, partition-key schedule) per operation, for audit
        self.access_log: List[Tuple[str, Tuple[Tuple[int, int], ...]]] = []
        self.touched_partitions = 0
        self.useful_partitions = 0
        self.touched_bytes = 0
        self.useful_bytes = 0

    # ------------------------------------------------------------ schedule

    def open_version(self, version: int) -> None:
        """Pre-create the FULL shard grid for ``version``, at version-open
        time (public knowledge) rather than on first traffic."""
        for s in range(self.inner.n_shards):
            self.inner.partition(int(version), s)

    def _schedule(self, op: str) -> List[Tuple[int, int]]:
        """All live partition keys, in an order drawn purely from
        (oblivious_seed, op counter)."""
        keys = sorted(self.inner.partitions)
        rng = np.random.default_rng((self.oblivious_seed, self._op_counter))
        order = [keys[i] for i in rng.permutation(len(keys))]
        self._op_counter += 1
        self.access_log.append((op, tuple(order)))
        return order

    def _touch(self, key: Tuple[int, int], *, useful: bool) -> None:
        part = self.inner.partitions[key]
        self.touched_partitions += 1
        self.touched_bytes += part.total_bytes
        if useful:
            self.useful_partitions += 1
            self.useful_bytes += part.total_bytes

    # ----------------------------------------------------------------- add

    def add(self, packed: CodePayload, *, client_ids=None, round: int = 0,
            version: Optional[int] = None, labels: LabelsLike = None
            ) -> StoreRecord:
        """Ingest one payload obliviously: the full grid is touched in
        schedule order; the record lands in its real partition when the
        schedule reaches it, every other touch is a ledger probe. The
        stored result is the plain store's."""
        if version is None:
            version = int(getattr(packed, "version", 0))
        self.open_version(version)
        target = (int(version), int(self.inner.shard_of(client_ids)))
        rec: Optional[StoreRecord] = None
        for key in self._schedule("add"):
            self._touch(key, useful=key == target)
            if key == target:
                rec = self.inner.partition(*key).add(
                    packed, client_ids=client_ids, round=round,
                    version=version, labels=labels)
            else:
                # dummy write: the same read shape as an admission check
                _ = self.inner.partitions[key].n_samples
        self.inner._set_gauges()
        if rec is None:
            raise RuntimeError(f"the schedule missed partition {target}")
        return rec

    # ----------------------------------------------------------------- get

    def get(self, client_id: int, round: int):
        """One client's codes without revealing which partition held them:
        EVERY partition is scanned in schedule order and the answer is the
        hit from the minimum partition key, the plain store's answer."""
        hits: Dict[Tuple[int, int], tuple] = {}
        for key in self._schedule("get"):
            try:
                hits[key] = self.inner.partitions[key].get(client_id, round)
                found = True
            except KeyError:
                found = False
            self._touch(key, useful=found)
        if not hits:
            raise KeyError((client_id, round))
        return hits[min(hits)]

    # ------------------------------------------------------------ overhead

    def overhead(self) -> Dict[str, float]:
        """Measured cost of obliviousness on the workload so far: a plain
        store touches only the useful partitions and bytes, this one
        touches them all; the ratios are the overhead factor."""
        return {
            "ops": float(self._op_counter),
            "touched_partitions": float(self.touched_partitions),
            "useful_partitions": float(self.useful_partitions),
            "partition_touch_ratio": self.touched_partitions
            / max(1, self.useful_partitions),
            "touched_bytes": float(self.touched_bytes),
            "useful_bytes": float(self.useful_bytes),
            "byte_touch_ratio": self.touched_bytes
            / max(1, self.useful_bytes),
        }

    # --------------------------------------------------------- delegation

    def __len__(self) -> int:
        return len(self.inner)

    def __getattr__(self, name):
        # everything not overridden (dataset, codes, ledgers, snapshots,
        # partitions, ...) behaves exactly as the wrapped store
        return getattr(self.__dict__["inner"], name)
