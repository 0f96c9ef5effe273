"""Codebook version registry (Step 5 bookkeeping for an async server).

Port of ``repro.server.registry``. Every merged dictionary is pinned as an
immutable snapshot under a monotonically increasing version, so each
payload decodes against exactly the table it was packed under, however
many merges happened since.

A rolling upgrade is a :class:`MigrationWindow`: while a ``src -> dst``
window is open, payloads of BOTH versions ingest (src-version ones get a
``migrated`` verdict); when it closes, src-version records are kept,
retired, or re-encoded under the window's policy, and the src version may
be retired so new src-version uplinks are rejected at admission. Snapshots
are never deleted: a retired version still decodes bit-exactly.
``snapshot_state`` / ``load_state`` use the reference's manifest and array
layout.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core import octopus as OC

#: how a closing migration window disposes of src-version records:
#:   keep     — records stay, still decoded against their pinned snapshot
#:   retire   — records evicted (ledgered), src version refused at the door
#:   reencode — records transcoded to the dst codebook, then src retired
MIGRATION_POLICIES = ("keep", "retire", "reencode")


class MigrationWindow(NamedTuple):
    """An open ``src -> dst`` rolling-upgrade window."""
    src: int
    dst: int
    policy: str


class CodebookRegistry:
    """Immutable (K, M) codebook snapshots, one per merge."""

    def __init__(self, codebook: torch.Tensor):
        self._versions: Dict[int, torch.Tensor] = {0: codebook.clone()}
        self.latest = 0
        self.migration: Optional[MigrationWindow] = None
        self._retired: Set[int] = set()

    def __len__(self) -> int:
        return len(self._versions)

    def __contains__(self, version: int) -> bool:
        return int(version) in self._versions

    def get(self, version: int) -> torch.Tensor:
        """Snapshot for ``version``; KeyError if it was never registered."""
        return self._versions[int(version)]

    @property
    def current(self) -> torch.Tensor:
        return self._versions[self.latest]

    def register(self, codebook: torch.Tensor) -> int:
        """Pin a new global dictionary; returns its version number."""
        self.latest += 1
        self._versions[self.latest] = codebook.clone()
        return self.latest

    def pin_current(self, codebook: torch.Tensor) -> int:
        """Replace the LATEST snapshot in place (no new version)."""
        self._versions[self.latest] = codebook.clone()
        return self.latest

    # --------------------------------------------------------- migration

    @property
    def retired(self) -> Tuple[int, ...]:
        return tuple(sorted(self._retired))

    def is_retired(self, version: int) -> bool:
        return int(version) in self._retired

    def begin_migration(self, *, src: Optional[int] = None,
                        dst: Optional[int] = None,
                        policy: str = "keep") -> MigrationWindow:
        """Open a rolling ``src -> dst`` upgrade window; ``dst`` defaults
        to the latest version, ``src`` to ``dst - 1``."""
        if self.migration is not None:
            raise ValueError(
                f"migration window {self.migration.src}->"
                f"{self.migration.dst} is still open")
        if policy not in MIGRATION_POLICIES:
            raise ValueError(f"policy must be one of {MIGRATION_POLICIES}, "
                             f"got {policy!r}")
        dst = self.latest if dst is None else int(dst)
        src = dst - 1 if src is None else int(src)
        if src not in self._versions or dst not in self._versions:
            raise KeyError(f"migration {src}->{dst}: both versions must be "
                           f"registered (have {sorted(self._versions)})")
        if src == dst:
            raise ValueError(f"migration src and dst are both {src}")
        if self.is_retired(src):
            raise ValueError(f"version {src} is already retired")
        self.migration = MigrationWindow(src=src, dst=dst, policy=policy)
        return self.migration

    def close_migration(self) -> MigrationWindow:
        if self.migration is None:
            raise ValueError("no migration window is open")
        win, self.migration = self.migration, None
        return win

    def retire(self, version: int) -> None:
        """Refuse future uplinks packed under ``version``; the snapshot
        stays pinned, so stored payloads keep decoding bit-exactly."""
        version = int(version)
        if version == self.latest:
            raise ValueError(f"cannot retire the latest version {version}")
        if version not in self._versions:
            raise KeyError(version)
        self._retired.add(version)

    # --------------------------------------------------------- durability

    def snapshot_state(self) -> Tuple[dict, Dict[str, np.ndarray]]:
        """Durable state -> (JSON-able manifest, {key: numpy array}): every
        pinned snapshot, the retired set and any OPEN migration window."""
        arrays = {f"v{v}": cb.detach().cpu().numpy()
                  for v, cb in self._versions.items()}
        manifest = {"latest": int(self.latest),
                    "retired": sorted(int(v) for v in self._retired),
                    "migration": (None if self.migration is None
                                  else [int(self.migration.src),
                                        int(self.migration.dst),
                                        self.migration.policy]),
                    "versions": sorted(int(v) for v in self._versions)}
        return manifest, arrays

    def load_state(self, manifest: dict, arrays, *, device=None
                   ) -> "CodebookRegistry":
        """Restore :meth:`snapshot_state` output (from either package);
        the snapshots go to ``device`` (cuda unless ``device="cpu"``)."""
        from repro_torch import resolve_device
        dev = resolve_device(device)
        self._versions = {
            int(v): torch.as_tensor(np.array(arrays[f"v{v}"]), device=dev)
            for v in manifest["versions"]}
        self.latest = int(manifest["latest"])
        self._retired = {int(v) for v in manifest["retired"]}
        mig = manifest["migration"]
        self.migration = None if mig is None else MigrationWindow(
            src=int(mig[0]), dst=int(mig[1]), policy=str(mig[2]))
        return self

    # ----------------------------------------------------------- merging

    def merge(self, server: OC.ServerState, client_codebooks, client_counts,
              *, client_versions=None, staleness_decay: float = 1.0
              ) -> Tuple[OC.ServerState, int]:
        """Staleness-weighted Step 5 merge, then registration of the merged
        dictionary. ``client_versions``: the registry version each client
        last deployed from; staleness ``max(latest - version, 0)``
        discounts its counts by ``staleness_decay ** staleness`` (only
        when the decay is not 1). Returns (merged state, new version)."""
        staleness = None
        if client_versions is not None and staleness_decay != 1.0:
            staleness = (self.latest - torch.as_tensor(
                client_versions, dtype=torch.int32)).clamp(min=0)
        merged = OC.server_merge_codebooks(
            server, client_codebooks, client_counts, staleness=staleness,
            staleness_decay=staleness_decay)
        return merged, self.register(merged.params["codebook"])
