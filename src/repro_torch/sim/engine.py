"""Batched multi-client simulation engine (OCTOPUS §2.2 at population scale).

Port of ``repro.sim.engine`` on one device. A round advances every client
of a stacked population:

  * each client runs ``n_local_steps`` of frozen-codebook fine-tuning and
    the round's ONE encoder pass
    (:func:`~repro_torch.core.octopus.client_finetune_encode`) at its own
    (B, ...) batch shape;
  * ONE ``ops.encode_codes`` dispatch then quantizes every client's
    latents against that client's OWN codebook, packs each client's
    record stream and sums its Eq. 7-8 statistics: (C, B*P, M) latents
    against (C, K, M) codebooks;
  * each client's EMA refresh (Eq. 9) runs from its own (K,) counts and
    (K, M) sums of that dispatch.

The reference vmaps one client round over the population. Here the encoder
passes stay per client on purpose: cuDNN picks a convolution's algorithm by
its shapes, so one batched (C*B, ...) pass would make a client's latents
depend on the size of the cohort it rides in. With per-client passes, the
encode kernel's per-record results (independent of R) and per-client EMA
updates, a client's round is the same bits in any population, and the same
as :meth:`repro_torch.wire.session.OctopusClient.round` on its own.

State: the port's :class:`~repro_torch.core.octopus.ClientState` holds
modules. A stacked population holds the (C, K, M) codebooks, the stacked
EMA fields, a (C,) step tensor, and either one encoder and decoder shared by
every client (``n_local_steps = 0``: nothing trains them, so the server's
modules serve every client, as fresh deploys do) or a tuple of each
client's own copies.

Typical use::

    eng = SimEngine(cfg, lr=1e-4, gamma=0.99)
    clients = eng.init_clients(server, n_clients=256)
    clients, packed = eng.round(clients, data)     # data: (C, B, ...)
    server = eng.merge_into_server(server, clients)   # Step 5 tail

``round_indices`` is the async code server's entry: Steps 2-5 a client,
returning the unpacked int32 codes so the server can split them into
delivery groups. ``mesh=`` waits for the process-group port
(``ROADMAP.md``).
"""
from __future__ import annotations

import copy
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import octopus as OC
from repro_torch.core.dvqae import DVQAEConfig
from repro_torch.core.ema import EMAState, ema_update_from_stats
from repro_torch.wire.payload import CodePayload
from repro_torch.wire.session import index_shape


def __getattr__(name):
    if name == "PackedCodes":
        raise ImportError(
            "sim.engine.PackedCodes was removed; use "
            "repro_torch.wire.payload.CodePayload (same carrier, versioned "
            "wire format)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# ----------------------------------------------------------- client batches

def _client_module(modules, i: int) -> torch.nn.Module:
    """Client ``i``'s module: the shared one, or its own copy."""
    return modules if isinstance(modules, torch.nn.Module) else modules[i]


def replicate_clients(server: OC.ServerState, n_clients: int, *,
                      share_modules: bool = False) -> OC.ClientState:
    """Step 2 deployment for a population: the server's codebook and a
    fresh EMA accumulator for each of ``n_clients`` clients, stacked on a
    leading axis; the encoder and decoder shared (``share_modules``) or
    copied for each client."""
    cb = server.params["codebook"].detach()
    cbs = cb[None].expand((n_clients,) + tuple(cb.shape)).clone()
    ema = EMAState(counts=torch.ones(cbs.shape[:2], dtype=torch.float32,
                                     device=cb.device),
                   sums=cbs.float().clone(), codebook=cbs)
    params = {"codebook": cbs}
    for key in ("encoder", "decoder"):
        module = server.params[key]
        params[key] = module if share_modules else tuple(
            copy.deepcopy(module) for _ in range(n_clients))
    return OC.ClientState(params=params, ema=ema,
                          step=torch.zeros((n_clients,), dtype=torch.int64))


def stack_clients(clients: Sequence[OC.ClientState]) -> OC.ClientState:
    """List of per-client states -> one stacked population (each client's
    own modules in a tuple)."""
    stacked = OC.stack_clients(clients)
    params = {**stacked.params,
              "encoder": tuple(c.params["encoder"] for c in clients),
              "decoder": tuple(c.params["decoder"] for c in clients)}
    return stacked._replace(params=params)


def client_state(batch: OC.ClientState, i: int) -> OC.ClientState:
    """Client ``i`` of a stacked population (views of its rows)."""
    p = batch.params
    return OC.ClientState(
        params={"encoder": _client_module(p["encoder"], i),
                "decoder": _client_module(p["decoder"], i),
                "codebook": p["codebook"][i]},
        ema=EMAState(*(f[i] for f in batch.ema)), step=int(batch.step[i]))


def unstack_clients(batch: OC.ClientState) -> List[OC.ClientState]:
    """Stacked population -> list of per-client states."""
    return [client_state(batch, i) for i in range(client_batch_size(batch))]


def client_batch_size(batch: OC.ClientState) -> int:
    return int(batch.params["codebook"].shape[0])


def select_clients(batch: OC.ClientState, ids) -> OC.ClientState:
    """The stacked sub-population of rows ``ids`` (copies of their
    codebooks and EMA fields; their own modules, or the shared ones)."""
    ids = [int(i) for i in np.asarray(ids).reshape(-1)]
    rows = torch.as_tensor(ids, dtype=torch.long,
                           device=batch.params["codebook"].device)
    params = {"codebook": batch.params["codebook"][rows]}
    for key in ("encoder", "decoder"):
        m = batch.params[key]
        params[key] = m if isinstance(m, torch.nn.Module) \
            else tuple(m[i] for i in ids)
    return OC.ClientState(params=params,
                          ema=EMAState(*(f[rows] for f in batch.ema)),
                          step=batch.step[rows.cpu()])


def scatter_clients(batch: OC.ClientState, ids, sub: OC.ClientState
                    ) -> OC.ClientState:
    """``batch`` with rows ``ids`` replaced by the stacked ``sub``."""
    ids = [int(i) for i in np.asarray(ids).reshape(-1)]
    cb = batch.params["codebook"]
    rows = torch.as_tensor(ids, dtype=torch.long, device=cb.device)
    params = {"codebook": cb.index_copy(0, rows, sub.params["codebook"])}
    for key in ("encoder", "decoder"):
        m, new = batch.params[key], sub.params[key]
        if isinstance(m, torch.nn.Module):
            if new is not m:
                raise ValueError("a population with shared modules cannot "
                                 "take per-client ones")
            params[key] = m
        else:
            own = list(m)
            for j, i in enumerate(ids):
                own[i] = new if isinstance(new, torch.nn.Module) else new[j]
            params[key] = tuple(own)
    ema = EMAState(*(f.index_copy(0, rows, g)
                     for f, g in zip(batch.ema, sub.ema)))
    step = batch.step.index_copy(0, rows.cpu(), sub.step.to(batch.step.dtype))
    return OC.ClientState(params=params, ema=ema, step=step)


# ------------------------------------------------------------------ engine

class SimEngine:
    """One population round (Steps 2-5) over a stacked population.

    ``mesh`` (the reference's ``shard_map`` over the mesh 'data' axis) is
    not ported: a ``mesh`` raises.
    """

    def __init__(self, cfg: DVQAEConfig, *, lr: float = 1e-4,
                 gamma: float = 0.99, n_local_steps: int = 1, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "SimEngine(mesh=...) shards clients over a device mesh, "
                "which waits for the process-group port (ROADMAP.md, "
                "Queue 1 item 7); run it without a mesh on one device")
        self.cfg = cfg
        self.lr = lr
        self.gamma = gamma
        self.n_local_steps = int(n_local_steps)
        self.bits = OC.transmit_bits(cfg)

    # ------------------------------------------------------------- rounds

    def init_clients(self, server: OC.ServerState, n_clients: int
                     ) -> OC.ClientState:
        """Fresh deploys: modules shared when no local step trains them."""
        return replicate_clients(server, n_clients,
                                 share_modules=self.n_local_steps == 0)

    def round(self, clients: OC.ClientState, data, *, version: int = 0,
              labels=None) -> Tuple[OC.ClientState, CodePayload]:
        """Advance every client one full round (Steps 2-5).

        ``data``: (C, B, ...), one local batch a client. Returns the new
        population state and the round's payload: one record stream a
        client (``n_records == C``) straight from ONE fused encode
        dispatch, stamped with ``version``; ``labels`` (a per-task dict or
        a bare (C, B) array) ride the payload into the server's store.
        """
        from repro_torch.kernels.ops import encode_codes
        cfg = self.cfg
        C = client_batch_size(clients)
        cbs = clients.params["codebook"]
        x = torch.as_tensor(data, dtype=torch.float32, device=cbs.device)
        if x.shape[0] != C:
            raise ValueError(f"data has {x.shape[0]} client batches for "
                             f"{C} clients")
        own = {}
        for key in ("encoder", "decoder"):
            m = clients.params[key]
            if isinstance(m, torch.nn.Module) and self.n_local_steps > 0:
                m = tuple(copy.deepcopy(m) for _ in range(C))  # they train
            own[key] = m
        pop = clients._replace(params={**clients.params, **own})
        z_all, steps, z_shape = None, [], None
        for i in range(C):
            client, z = OC.client_finetune_encode(
                client_state(pop, i), cfg, x[i], lr=self.lr,
                n_local_steps=self.n_local_steps)
            if z_all is None:                   # (B, P, M) latents a client
                z_shape = tuple(z.shape)
                z_all = torch.empty((C, z[..., 0].numel(), z.shape[-1]),
                                    dtype=z.dtype, device=z.device)
            z_all[i] = z.reshape(-1, z.shape[-1])
            steps.append(int(client.step))
        words, counts, sums = encode_codes(
            z_all, cbs, bits=self.bits, n_groups=cfg.n_groups,
            n_slices=cfg.n_slices)
        # each client's refresh from its own statistics, at one client's
        # shapes: its bits do not depend on the population's size
        emas = [ema_update_from_stats(EMAState(*(f[i] for f in clients.ema)),
                                      counts[i], sums[i], gamma=self.gamma)
                for i in range(C)]
        ema = EMAState(*(torch.stack(f) for f in zip(*emas)))
        params = {**own, "codebook": ema.codebook}
        clients = OC.ClientState(params=params, ema=ema,
                                 step=torch.tensor(steps, dtype=torch.int64))
        B = int(x.shape[1])
        return clients, CodePayload.from_words(
            words, bits=self.bits, shape=(C,) + index_shape(cfg, z_shape),
            n_records=C, version=int(version), labels=labels,
            n_samples=C * B, privatized=True)

    def round_indices(self, clients: OC.ClientState, data
                      ) -> Tuple[OC.ClientState, torch.Tensor]:
        """Steps 2-5 for the (sub)population, returning the UNPACKED int32
        code indices (C, B, T[, n_c]).

        The async code server splits participants into delivery groups
        (stragglers, drops, per-version lanes) and packs each group on its
        own, so this returns codes instead of one population payload. A
        client's round is the reference's ``client_round``: fine-tuning,
        one encoder pass, its codes through ``ops.vq_nearest`` (or the
        GSVQ search), the Eq. 7-8 statistics of those codes and the EMA
        refresh, each at one client's shapes.
        """
        cfg = self.cfg
        C = client_batch_size(clients)
        cbs = clients.params["codebook"]
        x = torch.as_tensor(data, dtype=torch.float32, device=cbs.device)
        if x.shape[0] != C:
            raise ValueError(f"data has {x.shape[0]} client batches for "
                             f"{C} clients")
        own = {}
        for key in ("encoder", "decoder"):
            m = clients.params[key]
            if isinstance(m, torch.nn.Module) and self.n_local_steps > 0:
                m = tuple(copy.deepcopy(m) for _ in range(C))  # they train
            own[key] = m
        pop = clients._replace(params={**clients.params, **own})
        codes, emas, steps = [], [], []
        for i in range(C):
            client, z = OC.client_finetune_encode(
                client_state(pop, i), cfg, x[i], lr=self.lr,
                n_local_steps=self.n_local_steps)
            idx = OC.quantize_indices(cfg, z, cbs[i])
            stats = OC.refresh_stats(cfg, z, idx)
            emas.append(ema_update_from_stats(client.ema, *stats,
                                              gamma=self.gamma))
            codes.append(idx.to(torch.int32).reshape(index_shape(cfg,
                                                                 z.shape)))
            steps.append(int(client.step))
        ema = EMAState(*(torch.stack(f) for f in zip(*emas)))
        params = {**own, "codebook": ema.codebook}
        return OC.ClientState(params=params, ema=ema,
                              step=torch.tensor(steps, dtype=torch.int64)), \
            torch.stack(codes)

    # ------------------------------------------------------- server side

    def merge_into_server(self, server: OC.ServerState,
                          clients: OC.ClientState) -> OC.ServerState:
        """Step 5 tail: count-weighted merge of the population's codebooks
        into the global dictionary."""
        return OC.server_merge_codebooks(server, clients.params["codebook"],
                                         clients.ema.counts)

    def dequantize(self, server: OC.ServerState, packed: CodePayload
                   ) -> torch.Tensor:
        """Step 6 entry: ONE fused decode of a round's payload against the
        server's CURRENT codebook, the client axis merged."""
        feats = OC.codes_to_features(self.cfg, packed,
                                     server.params["codebook"])
        return feats.reshape((-1,) + tuple(feats.shape[2:]))
