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
delivery groups.

``mesh=`` (a ``DeviceMesh`` with a 'data' axis, as the reference's
``shard_map`` over it): each data rank advances its contiguous shard of
the clients (the cohort must divide by ``sharding.data_axis_size``), and
the outputs are gathered over the data group, so ``round`` and
``round_indices`` return what the engine returns without a mesh, on every
rank. A client's round is the same bits wherever it runs.
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

    mesh=None        — one device.
    mesh=DeviceMesh  — the client axis sharded over the mesh's data axes:
                       each data rank advances its slice of the
                       population, the results gathered (n_clients must
                       divide by the data-axis size).
    """

    def __init__(self, cfg: DVQAEConfig, *, lr: float = 1e-4,
                 gamma: float = 0.99, n_local_steps: int = 1, mesh=None):
        self.mesh = mesh
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
        dispatch (one a data rank on a mesh), stamped with ``version``;
        ``labels`` (a per-task dict or a bare (C, B) array) ride the
        payload into the server's store.
        """
        if self.mesh is None:
            return self._round(clients, data, version=version,
                               labels=labels)
        sub, x, C = self._my_shard(clients, data)
        sub, payload = self._round(sub, x, version=version)
        words = self._gather(payload.payload)
        clients = self._gather_state(clients, sub, C)
        return clients, CodePayload.from_words(
            words, bits=self.bits, shape=(C,) + tuple(payload.shape[1:]),
            n_records=C, version=int(version), labels=labels,
            n_samples=C * int(x.shape[1]), privatized=True)

    def _round(self, clients, data, *, version: int = 0, labels=None):
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
        if self.mesh is None:
            return self._round_indices(clients, data)
        sub, x, C = self._my_shard(clients, data)
        sub, codes = self._round_indices(sub, x)
        return self._gather_state(clients, sub, C), self._gather(codes)

    def _round_indices(self, clients, data):
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

    # --------------------------------------------------------------- mesh

    def _my_shard(self, clients, data):
        """This data rank's contiguous slice of the clients and their
        batches -> (sub-population, batches, C)."""
        from repro_torch.distributed.sharding import (data_axis_size,
                                                      data_group)
        C = client_batch_size(clients)
        n = data_axis_size(self.mesh)
        if C % n:
            raise ValueError(f"{C} clients do not split over {n} data "
                             f"shards")
        self._group, r = data_group(self.mesh)
        per = C // n
        ids = list(range(r * per, (r + 1) * per))
        x = torch.as_tensor(data)[r * per:(r + 1) * per]
        return select_clients(clients, ids), x, C

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``t`` beside every data rank's, in rank
        order (the clients' order)."""
        import torch.distributed as dist
        if dist.get_world_size(self._group) == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(self._group))]
        dist.all_gather(parts, t, group=self._group)
        return torch.cat(parts)

    def _gather_state(self, clients, sub, C: int) -> OC.ClientState:
        """The whole population after a round from each data rank's
        ``sub``: the stacked fields gathered, and each client's own
        modules (when they train) sent from the rank that ran it."""
        import torch.distributed as dist
        ema = EMAState(*(self._gather(f) for f in sub.ema))
        params = {"codebook": self._gather(sub.params["codebook"])}
        n = dist.get_world_size(self._group)
        for key in ("encoder", "decoder"):
            m = sub.params[key]
            if isinstance(m, torch.nn.Module) or n == 1:
                params[key] = m
                continue
            per, r = C // n, dist.get_rank(self._group)
            own = []
            for i in range(C):
                src = i // per
                mod = m[i - r * per] if src == r else copy.deepcopy(m[0])
                for t in list(mod.parameters()) + list(mod.buffers()):
                    dist.broadcast(t.data, dist.get_global_rank(
                        self._group, src), group=self._group)
                own.append(mod)
            params[key] = tuple(own)
        step = self._gather(sub.step.to(ema.counts.device)).cpu()
        return OC.ClientState(params=params, ema=ema, step=step)

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
