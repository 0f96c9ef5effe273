"""Session facades over the wire protocol: one client entry, one server
entry.

Port of ``repro.wire.session``:

  * :class:`OctopusClient` — ``round(batch)`` is the uplink entry: Step 2
    (``n_local_steps`` of frozen-codebook fine-tuning, one by default),
    then ONE encoder pass feeding ONE ``ops.encode_codes`` dispatch that
    quantizes, bit-packs and sums the EMA statistics, the Step 5 refresh
    from those statistics, and a :class:`CodePayload` back.
    ``transmit(batch)`` is the encode-only uplink (Steps 3-4);
    ``finetune(batch)`` is Step 2 alone; ``sync(server)`` adopts the
    server's latest merged dictionary and its version. ``send`` /
    ``uplink`` offer a payload under a ``(client_id, seq)`` envelope and
    retry transient verdicts under a :class:`RetryPolicy`.
  * :class:`OctopusServer` — ``pretrain`` is Step 1; ``ingest(payload)``
    returns an :class:`AdmissionResult` verdict (accepted / migrated /
    rejected); admitted payloads land in a versioned store (a
    ``CodeStore`` or a ``ShardedCodeStore``) keyed on the payload's OWN
    codebook version, and ``features()`` / ``decode()`` decode against the
    registry snapshot the payload was packed under, one fused dispatch per
    version. ``merge`` / ``merge_clients`` (count- and staleness-weighted
    float merge) and ``merge_stats`` (the associative fixed-point merge)
    are the Step 5 tail: each registers a new version. Rolling codebook
    upgrades run through ``begin_migration`` / ``complete_migration``; the
    ``reencode`` policy transcodes records through ``ops.vq_nearest`` and
    re-packs them through ``CodePayload.pack`` (``ops.pack_codes``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU they raise rather than fall back (``repro_torch.resolve_device``).

While a flight recorder is active (:mod:`repro_torch.obs`), ``round`` logs
an ``encode`` and an ``uplink`` event, ``ingest`` an ``ingest`` event,
``decode`` a ``decode`` event, ``merge`` / ``merge_stats`` a ``merge``
event, ``send`` a ``retry`` event a retry and the migrations a
``migration`` event at each end, at the reference's sites and with its
fields.
"""
from __future__ import annotations

import time
import zlib
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import octopus as OC
from repro_torch.core.dvqae import DVQAEConfig
from repro_torch.core.ema import init_ema
from repro_torch.obs import recorder as _obs

from .payload import SUPPORTED_WIRE_VERSIONS, CodePayload


#: admission verdicts an ingest path can return (§2.8: ALL of them keep
#: the payload's measured bytes on the ledger, accepted or not)
ADMISSION_VERDICTS = ("accepted", "migrated", "deferred", "rejected",
                      "duplicate")

#: rejection reasons worth retrying: the condition is transient (load or
#: channel noise), so the SAME envelope re-sent later can land
TRANSIENT_REASONS = ("queue_full", "radio_drop", "corrupt")


class RetryPolicy(NamedTuple):
    """Capped exponential backoff for transient uplink failures.

    Attempt ``a`` waits ``min(base_ticks * 2**a, cap_ticks)`` service
    ticks plus a deterministic jitter in ``[0, jitter_ticks]`` hashed
    (CRC32) from (salt, attempt): retries de-synchronize across clients
    without consuming any PRNG stream.
    """
    max_attempts: int = 4
    base_ticks: int = 1
    cap_ticks: int = 8
    jitter_ticks: int = 1

    def backoff(self, attempt: int, *, salt="") -> int:
        wait = min(self.base_ticks * (2 ** int(attempt)), self.cap_ticks)
        if self.jitter_ticks:
            h = zlib.crc32(f"retry|{salt}|{int(attempt)}".encode())
            wait += h % (self.jitter_ticks + 1)
        return int(wait)

    def retryable(self, result: "AdmissionResult") -> bool:
        """deferred and transient rejections retry; accepted / migrated /
        duplicate (the server already holds this envelope) stop."""
        return (result.verdict == "deferred"
                or (result.verdict == "rejected"
                    and result.reason in TRANSIENT_REASONS))


class AdmissionResult(NamedTuple):
    """Structured verdict for one uplink payload at the server door.

    ``verdict``: accepted (stored or queued on a current version),
    migrated (stored, packed under the src version of an OPEN migration
    window), deferred (queued under backpressure), rejected (refused,
    ``reason`` says why; bytes still ledgered) or duplicate (this
    ``(client_id, seq)`` envelope was already admitted: acknowledged, not
    stored again). ``nbytes`` is the payload's measured wire size;
    ``record`` the StoreRecord of a stored payload, else None.
    """
    verdict: str
    reason: str = ""
    nbytes: int = 0
    record: Optional[object] = None

    @property
    def ok(self) -> bool:
        return self.verdict != "rejected"


def index_shape(cfg: DVQAEConfig, z_shape) -> Tuple[int, ...]:
    """Transmitted index shape for latents of shape (..., M): GSVQ sends
    one group index per slice per position."""
    base = tuple(int(d) for d in z_shape[:-1])
    if cfg.n_groups > 1 or cfg.n_slices > 1:
        return base + (cfg.n_slices,)
    return base


def _round_core(client: OC.ClientState, cfg: DVQAEConfig, batch, *,
                lr: float = 1e-4, gamma: float = 0.99,
                n_local_steps: int = 1, refresh: bool = True):
    """Steps 2-5: ``n_local_steps`` of fine-tuning, ONE encoder pass, ONE
    ``ops.encode_codes`` dispatch, optional Step 5 refresh from the
    dispatch's statistics -> (client, z, words). The whole batch is ONE
    record: z.reshape(1, B*P, M)."""
    from repro_torch.kernels.ops import encode_codes
    client, z = OC.client_finetune_encode(client, cfg, batch, lr=lr,
                                          n_local_steps=n_local_steps)
    words, counts, sums = encode_codes(
        z.reshape(1, -1, z.shape[-1]), client.params["codebook"][None],
        bits=OC.transmit_bits(cfg), n_groups=cfg.n_groups,
        n_slices=cfg.n_slices)
    if refresh:
        client = OC.client_codebook_refresh(client, cfg, gamma=gamma,
                                            stats=(counts[0], sums[0]))
    return client, z, words


def _on_device(state: OC.ServerState, device) -> OC.ServerState:
    """The server state with its modules, codebook and AdamW moments on
    ``device`` (modules move in place)."""
    params = {"encoder": state.params["encoder"].to(device),
              "decoder": state.params["decoder"].to(device),
              "codebook": state.params["codebook"].to(device)}
    opt = state.opt
    if opt is not None:
        opt = opt._replace(mu=[t.to(device) for t in opt.mu],
                           nu=[t.to(device) for t in opt.nu])
    return state._replace(params=params, opt=opt)


class OctopusClient:
    """One client device's session: local DVQ-AE state + uplink policy.
    Deployed from an :class:`OctopusServer`, it runs on the server's
    device and stamps payloads with the server's codebook version."""

    def __init__(self, server: "OctopusServer", *, lr: float = 1e-4,
                 gamma: float = 0.99, n_local_steps: int = 1,
                 client_id: int = 0):
        self.cfg = server.cfg
        self.device = server.device
        self.lr = lr
        self.gamma = gamma
        self.n_local_steps = n_local_steps
        self.client_id = int(client_id)
        self.state = OC.client_init(server.state)
        self.version = int(server.version)
        self._seq = 0                    # next uplink envelope sequence no.

    @property
    def codebook(self) -> torch.Tensor:
        return self.state.params["codebook"]

    def _batch(self, batch) -> torch.Tensor:
        return torch.as_tensor(batch, dtype=torch.float32, device=self.device)

    def finetune(self, batch, *, steps: int = 1,
                 lr: Optional[float] = None) -> None:
        """Step 2 alone: ``steps`` of frozen-codebook local fine-tuning
        under one fresh AdamW state."""
        x = self._batch(batch)
        opt = None
        for _ in range(steps):
            self.state, opt, _ = OC.client_finetune_step(
                self.state, self.cfg, x, lr=self.lr if lr is None else lr,
                opt=opt)

    def round(self, batch, *, labels=None, finetune: Optional[int] = None,
              refresh: bool = True) -> CodePayload:
        """The uplink entry: Steps 2-5 through the fused encode path,
        stamped with the codebook version this client deployed from.
        ``finetune`` overrides the session's ``n_local_steps`` for this
        round (0 skips Step 2); ``refresh=False`` skips the Step 5 EMA
        refresh."""
        n_local = self.n_local_steps if finetune is None else int(finetune)
        rec = _obs.active()
        t0 = time.perf_counter() if rec is not None else 0.0
        self.state, z, words = _round_core(
            self.state, self.cfg, self._batch(batch), lr=self.lr,
            gamma=self.gamma, n_local_steps=n_local, refresh=refresh)
        payload = CodePayload.from_words(
            words, bits=OC.transmit_bits(self.cfg),
            shape=(1,) + index_shape(self.cfg, z.shape), n_records=1,
            version=self.version, labels=labels, n_samples=int(z.shape[0]),
            privatized=True)
        if rec is not None:
            _obs.settle(payload.payload, self.codebook)
            rec.event("encode", dur_ms=(time.perf_counter() - t0) * 1e3,
                      client_id=self.client_id, n_local_steps=n_local,
                      refresh=bool(refresh), **_obs.payload_meta(payload))
            rec.uplink(payload, client_id=self.client_id)
        return payload

    def transmit(self, batch, *, labels=None) -> CodePayload:
        """Encode-only uplink (Steps 3-4): no fine-tuning, no refresh."""
        return self.round(batch, labels=labels, finetune=0, refresh=False)

    # ---------------------------------------------------- exactly-once send

    def next_seq(self) -> int:
        """Mint the next envelope sequence number: ``(client_id, seq)`` is
        the idempotency key the server dedups retransmits on."""
        seq, self._seq = self._seq, self._seq + 1
        return seq

    def send(self, target, payload: CodePayload, *,
             retry: Optional[RetryPolicy] = None,
             clock=None) -> AdmissionResult:
        """Offer ONE payload under a fresh ``(client_id, seq)`` envelope,
        retrying transient verdicts with capped exponential backoff.
        ``target`` has the continuous ``offer`` door (a
        ``ContinuousIngestService``); between attempts the client waits
        ``retry.backoff`` ticks by calling ``clock()`` (default
        ``target.tick``). The key stays fixed across attempts, so a
        retransmit of an admitted payload comes back ``duplicate``."""
        seq = self.next_seq()
        step = clock if clock is not None else getattr(target, "tick", None)
        rec = _obs.active()
        attempt = 0
        while True:
            res = target.offer(payload, client_ids=[self.client_id],
                               uplink_id=(self.client_id, seq))
            if (retry is None or not retry.retryable(res)
                    or attempt >= retry.max_attempts):
                return res
            wait = retry.backoff(attempt, salt=f"{self.client_id}.{seq}")
            if rec is not None:
                rec.metrics.inc("retries")
                rec.event("retry", client_id=self.client_id, seq=seq,
                          attempt=attempt, wait_ticks=wait,
                          verdict=res.verdict, reason=res.reason)
            if step is not None:
                for _ in range(wait):
                    step()
            attempt += 1

    def uplink(self, target, batch, *, labels=None,
               retry: Optional[RetryPolicy] = None,
               clock=None) -> AdmissionResult:
        """``round`` + exactly-once ``send``: encode the batch ONCE, then
        (re)transmit the same payload under one envelope until the server
        holds it or the retries run out."""
        return self.send(target, self.round(batch, labels=labels),
                         retry=retry, clock=clock)

    def sync(self, server: "OctopusServer") -> None:
        """Adopt the server's latest merged dictionary and its version (the
        Step 5 tail on the client side): the local EMA restarts from the
        adopted atoms, the fine-tuned encoder and decoder stay."""
        cb = server.registry.current.clone()
        self.state = OC.ClientState(
            params={**self.state.params, "codebook": cb},
            ema=init_ema(cb), step=self.state.step)
        self.version = int(server.version)


class OctopusServer:
    """Server session: versioned registry + code store behind ONE door.

    ``store`` (a ``CodeStore`` or ``ShardedCodeStore``) and ``registry``
    default to fresh ones; ``require_privatized=False`` admits payloads
    whose §2.5 flag is cleared (the store still refuses them)."""

    def __init__(self, server: OC.ServerState, cfg: DVQAEConfig, *,
                 store=None, registry=None, require_privatized: bool = True,
                 device=None):
        from repro_torch.server.registry import CodebookRegistry
        from repro_torch.server.store import CodeStore
        if not isinstance(server, OC.ServerState):
            raise TypeError("OctopusServer wraps an octopus.ServerState; "
                            "build one with OctopusServer.init(seed, cfg)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.state = _on_device(server, self.device)
        self.registry = registry if registry is not None else \
            CodebookRegistry(self.state.params["codebook"])
        self.store = store if store is not None else CodeStore(cfg)
        self.require_privatized = require_privatized

    @classmethod
    def init(cls, seed: int, cfg: DVQAEConfig, *, device=None,
             d_model: Optional[int] = None) -> "OctopusServer":
        """A server whose global model is drawn from ``seed`` in the
        reference's layout (``convert.init_numpy_params``), with a fresh
        AdamW state; ``d_model`` is a sequence DVQ-AE's hidden width."""
        dev = resolve_device(device)
        return cls(OC.server_init(seed, cfg, device=dev, d_model=d_model),
                   cfg, device=dev)

    @property
    def version(self) -> int:
        """Current (latest merged) codebook version."""
        return self.registry.latest

    def pretrain(self, generator: torch.Generator, x, *, steps: int,
                 batch: int = 32, lr: float = 1e-3):
        """Step 1: ATD pretraining of the global DVQ-AE on ``x``, minibatches
        drawn from ``generator``. Re-pins the pretrained dictionary as the
        current registry snapshot, which is only legal before any payload
        landed: stored codes would otherwise decode against a dictionary
        they were not packed under. Returns the last step's DVQAEOut."""
        if len(self.store):
            raise RuntimeError(
                f"pretrain would move codebook version "
                f"{self.registry.latest} under {len(self.store)} stored "
                f"payload(s); pretrain before ingesting (Step 1 precedes "
                f"Step 4)")
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        self.state, out = OC.server_pretrain(generator, self.state, self.cfg,
                                             x, steps=steps, batch=batch,
                                             lr=lr)
        self.registry.pin_current(self.state.params["codebook"])
        return out

    def deploy(self, **client_kw) -> OctopusClient:
        """Step 2: hand a client a session on the current global model;
        ``client_kw`` go to :class:`OctopusClient` (``lr``, ``gamma``,
        ``n_local_steps``, ``client_id``)."""
        return OctopusClient(self, **client_kw)

    def _coerce(self, payload) -> CodePayload:
        """The wire endpoint takes a :class:`CodePayload` (the reference's
        legacy ``Transmission`` carrier is not ported)."""
        if not isinstance(payload, CodePayload):
            raise TypeError(f"the wire endpoint wants a CodePayload, got "
                            f"{type(payload).__name__}")
        return payload

    def precheck(self, p: CodePayload) -> Tuple[str, str]:
        """Wire-invariant admission check -> (verdict, reason), without
        touching the store: unknown wire revision, missing §2.5 privatized
        flag, retired or never-registered codebook version, or a failed
        integrity check (short word stream, CRC mismatch) -> ``corrupt``.
        A payload packed under the src version of an OPEN migration window
        admits as ``migrated``."""
        if p.wire not in SUPPORTED_WIRE_VERSIONS:
            return "rejected", "wire_revision"
        if self.require_privatized and not p.privatized:
            return "rejected", "unprivatized"
        if self.registry.is_retired(p.version):
            return "rejected", "retired_version"
        if p.version not in self.registry:
            return "rejected", "unknown_version"
        if not p.verify():
            return "rejected", "corrupt"
        win = self.registry.migration
        if win is not None and int(p.version) == win.src:
            return "migrated", "migration_window"
        return "accepted", ""

    def ingest(self, payload: CodePayload, *, client_ids=None,
               round: int = 0) -> AdmissionResult:
        """The downlink entry: one payload into the versioned store.
        Rejected payloads do not enter the store; their measured bytes
        are reported all the same (§2.8 counts refusals)."""
        payload = self._coerce(payload)
        verdict, reason = self.precheck(payload)
        rec = _obs.active()
        if verdict == "rejected":
            if rec is not None:
                rec.metrics.inc("uplinks_rejected")
                rec.metrics.inc("bytes_rejected", payload.nbytes)
            return AdmissionResult(verdict, reason, payload.nbytes, None)
        out = self.store.add(payload, client_ids=client_ids, round=round)
        if rec is not None:
            rec.metrics.inc("uplinks_ingested")
            rec.metrics.inc("bytes_ingested", payload.nbytes)
            if verdict == "migrated":
                rec.metrics.inc("uplinks_migrated")
            rec.event("ingest", round=int(round), verdict=verdict,
                      **_obs.payload_meta(payload))
        return AdmissionResult(verdict, reason, payload.nbytes, out)

    def features(self, *, version: Optional[int] = None):
        """Bulk decode of everything ingested, each version group against
        its own registry snapshot, ONE fused dispatch per version.
        Returns (features (N, ...), {task: (N,) labels})."""
        return self.store.dataset(self.state, registry=self.registry,
                                  version=version)

    def decode(self, payload: CodePayload) -> torch.Tensor:
        """Directly decode ONE payload (store bypass) against the snapshot
        it was packed under; merges the client axis."""
        payload = self._coerce(payload)
        rec = _obs.active()
        t0 = time.perf_counter() if rec is not None else 0.0
        feats = OC.codes_to_features(self.cfg, payload,
                                     self.registry.get(payload.version))
        out = feats.reshape((-1,) + tuple(feats.shape[2:]))
        if rec is not None:
            _obs.settle(out)
            dur_ms = (time.perf_counter() - t0) * 1e3
            rec.event("decode", version=int(payload.version), dur_ms=dur_ms,
                      n_samples=int(out.shape[0]))
            rec.metrics.observe(f"decode_ms/v{int(payload.version)}", dur_ms)
        return out

    # ----------------------------------------------------------- migration

    def begin_migration(self, *, src: Optional[int] = None,
                        dst: Optional[int] = None, policy: str = "keep"):
        """Open a rolling ``src -> dst`` codebook upgrade window (defaults:
        latest-1 -> latest). While open, payloads of BOTH versions ingest;
        src-version ones get ``migrated`` verdicts."""
        win = self.registry.begin_migration(src=src, dst=dst, policy=policy)
        rec = _obs.active()
        if rec is not None:
            rec.metrics.set_gauge("migration_open", 1)
            rec.event("migration", phase="begin", src=win.src, dst=win.dst,
                      policy=win.policy)
        return win

    def migration_progress(self) -> Dict[str, int]:
        """Record and byte counts for the open window's src and dst
        versions: how much of the store still speaks the old dictionary."""
        win = self.registry.migration
        if win is None:
            raise ValueError("no migration window is open")
        by_v = self.store.stored_bytes_by_version
        recs = self.store.records
        return {
            "src": win.src, "dst": win.dst,
            "src_records": sum(1 for r in recs if r.version == win.src),
            "dst_records": sum(1 for r in recs if r.version == win.dst),
            "src_bytes": by_v.get(win.src, 0),
            "dst_bytes": by_v.get(win.dst, 0),
        }

    def complete_migration(self) -> Dict[str, int]:
        """Close the window and apply its policy to src-version records:
        ``keep`` leaves them decoding against their pinned snapshot;
        ``retire`` evicts them (bytes stay ledgered) and refuses future
        src uplinks; ``reencode`` transcodes them to the dst codebook
        before retiring src. Returns the final progress summary."""
        progress = self.migration_progress()
        win = self.registry.close_migration()
        n_reencoded = 0
        if win.policy in ("retire", "reencode"):
            gone = self.store.retire_version(win.src)
            if win.policy == "reencode":
                for r in gone:
                    p = self._reencode_payload(r.packed, win.dst)
                    self.store.add(p, client_ids=r.client_ids,
                                   round=r.round, labels=r.labels)
                    n_reencoded += 1
            self.registry.retire(win.src)
        progress["n_reencoded"] = n_reencoded
        rec = _obs.active()
        if rec is not None:
            rec.metrics.set_gauge("migration_open", 0)
            rec.event("migration", phase="complete", src=win.src,
                      dst=win.dst, policy=win.policy,
                      src_records=progress["src_records"],
                      src_bytes=progress["src_bytes"],
                      n_reencoded=n_reencoded)
        return progress

    def _reencode_payload(self, packed: CodePayload, dst: int
                          ) -> CodePayload:
        """Transcode one payload to the ``dst`` codebook: decode against
        the snapshot it was packed under, take each feature's nearest dst
        atom (``ops.vq_nearest``: the lower index on ties, as the
        reference's argmin), re-pack under ``dst`` (``ops.pack_codes``).
        Plain VQ only: a GSVQ index names a (group, slice) product atom,
        which a nearest-atom lookup cannot transcode."""
        from repro_torch.kernels.ops import vq_nearest
        if self.cfg.n_groups > 1 or self.cfg.n_slices > 1:
            raise ValueError("reencode migration supports plain VQ only "
                             f"(cfg has n_groups={self.cfg.n_groups}, "
                             f"n_slices={self.cfg.n_slices})")
        feats = OC.codes_to_features(self.cfg, packed,
                                     self.registry.get(packed.version))
        cb = self.registry.get(dst)                      # (K, M)
        idx = vq_nearest(feats.reshape(-1, feats.shape[-1]), cb)
        return CodePayload.pack(idx.reshape(feats.shape[:-1]),
                                bits=packed.bits, version=int(dst),
                                privatized=True)

    # --------------------------------------------------------- Step 5 tail

    def merge(self, client_codebooks, client_counts, *, client_versions=None,
              staleness_decay: float = 1.0) -> int:
        """Staleness-weighted Step 5 merge; registers and returns the new
        codebook version."""
        self.state, version = self.registry.merge(
            self.state, client_codebooks, client_counts,
            client_versions=client_versions,
            staleness_decay=staleness_decay)
        rec = _obs.active()
        if rec is not None:
            rec.metrics.inc("merges")
            rec.event("merge", version=int(version),
                      n_clients=int(len(client_counts)))
        return version

    def merge_clients(self, clients: OC.ClientState, **kw) -> int:
        """Merge a stacked population (:func:`octopus.stack_clients`)."""
        return self.merge(clients.params["codebook"], clients.ema.counts,
                          **kw)

    def merge_stats(self, stats) -> int:
        """Step 5 tail from associative cohort statistics
        (:class:`~repro_torch.core.ema.MergeStats`): bit-identical for any
        cohort partition or order of the same clients. Registers and
        returns the new version."""
        self.state = OC.server_merge_stats(self.state, stats)
        version = self.registry.register(self.state.params["codebook"])
        rec = _obs.active()
        if rec is not None:
            rec.metrics.inc("merges")
            rec.event("merge", version=int(version), source="stats")
        return version
