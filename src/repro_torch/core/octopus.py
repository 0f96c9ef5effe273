"""The OCTOPUS protocol (§2.2): Steps 1-6.

Port of ``repro.core.octopus``. ``ClientState`` / ``ServerState`` hold the
parameters (``{"encoder": nn.Module, "decoder": nn.Module, "codebook":
(K, M) tensor}``) and, for the server, its AdamW state.

The reference's transitions are pure functions of immutable arrays. Here
a training step updates the parameters and the optimizer moments IN
PLACE and returns the state that holds them; a client owns copies of the
server's modules from :func:`client_init` on, so fine-tuning a client
never moves the global model.

Server:  Step 1  pretrain the global DVQ-AE on public data (ATD)
Clients: Step 2  one-shot local fine-tune, codebook frozen
         Steps 3-4  quantize and transmit codes (``wire.session``)
         Step 5  EMA codebook refresh
Server:  Step 5 tail  merge the clients' codebooks into the global one
Server:  Step 6  downstream training on the gathered codes
"""
from __future__ import annotations

import copy
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     leaves)

from .dvqae import DVQAEConfig, DVQAEOut, forward
from .ema import (EMAState, MergeStats, as_stacked, assignment_stats,
                  ema_update_from_stats, init_ema, merge_codebook)


class ClientState(NamedTuple):
    params: dict              # local DVQ-AE (encoder/decoder fine-tuned)
    ema: EMAState             # local codebook EMA accumulator
    step: int


class ServerState(NamedTuple):
    params: dict              # global DVQ-AE
    opt: Optional[AdamWState] = None    # None: fresh at the first step
    step: int = 0


def transmit_bits(cfg: DVQAEConfig) -> int:
    """Bits per transmitted code index (§2.8). GSVQ sends one group index
    per slice per position, so its alphabet is n_groups (1-bit floor)."""
    from repro_torch.kernels.pack_bits import code_bits
    if cfg.n_groups > 1 or cfg.n_slices > 1:
        return code_bits(cfg.n_groups)
    return code_bits(cfg.codebook_size)


def trainable(params, keys=("encoder", "decoder", "codebook")) -> dict:
    """The parameter tree a step trains: ``{key: params[key]}``; its leaves
    are the modules' parameters and the codebook, in that order."""
    return {k: params[k] for k in keys}


def _detached(out: DVQAEOut) -> DVQAEOut:
    """A step's outputs without their autograd graph."""
    lat = out.latent._replace(**{f: getattr(out.latent, f).detach()
                                 for f in out.latent._fields})
    return DVQAEOut(recon=out.recon.detach(), latent=lat,
                    loss=out.loss.detach(),
                    recon_loss=out.recon_loss.detach())


def loss_grads(params, cfg: DVQAEConfig, batch: torch.Tensor, *,
               keys=("encoder", "decoder", "codebook"), group_axis=None
               ) -> Tuple[list, DVQAEOut]:
    """One :func:`forward` and the gradients of its Eq. 6 loss with respect
    to the leaves of ``trainable(params, keys)``, in leaf order. The
    returned DVQAEOut holds no autograd graph."""
    cb = params["codebook"].detach()
    if "codebook" in keys:
        cb = cb.requires_grad_(True)
    out = forward({**params, "codebook": cb}, cfg, batch,
                  group_axis=group_axis)
    wrt = leaves(trainable({**params, "codebook": cb}, keys))
    grads = torch.autograd.grad(out.loss, wrt)
    return list(grads), _detached(out)


# --------------------------------------------------------------- Step 1

def server_init(seed: int, cfg: DVQAEConfig, *, device,
                d_model: Optional[int] = None) -> ServerState:
    """A global model drawn in the reference's layout from ``seed``, with a
    fresh AdamW state; ``d_model`` is a sequence DVQ-AE's hidden width."""
    from repro_torch.convert import init_numpy_params, params_from_numpy
    params = params_from_numpy(init_numpy_params(cfg, seed, d_model=d_model),
                               cfg, device=device)
    return ServerState(params=params, opt=adamw_init(trainable(params)))


def server_pretrain_step(state: ServerState, cfg: DVQAEConfig,
                         batch: torch.Tensor, lr: float = 1e-3,
                         group_axis=None) -> Tuple[ServerState, DVQAEOut]:
    """One ATD pretraining step of the global DVQ-AE (Step 1): every
    parameter, the codebook included, is trained."""
    grads, out = loss_grads(state.params, cfg, batch, group_axis=group_axis)
    params = trainable(state.params)
    opt = state.opt if state.opt is not None else adamw_init(params)
    _, opt = adamw_update(params, grads, opt, lr=lr)
    return ServerState(params=state.params, opt=opt,
                       step=state.step + 1), out


def server_pretrain(generator: torch.Generator, server: ServerState,
                    cfg: DVQAEConfig, x: torch.Tensor, *, steps: int,
                    batch: int = 32, lr: float = 1e-3
                    ) -> Tuple[ServerState, Optional[DVQAEOut]]:
    """Step 1 loop: ``steps`` pretraining steps over minibatches of ``x``
    drawn with replacement from ``generator``. Returns (server, the last
    step's DVQAEOut, None when steps == 0)."""
    out = None
    n = x.shape[0]
    for _ in range(steps):
        sel = torch.randint(0, n, (batch,), generator=generator)
        server, out = server_pretrain_step(server, cfg,
                                           x[sel.to(x.device)], lr=lr)
    return server, out


# --------------------------------------------------------------- Step 2

def client_init(server: ServerState) -> ClientState:
    """Deploy the global model to a client: its own copies of the encoder,
    decoder and codebook, and a fresh EMA accumulator."""
    params = {"encoder": copy.deepcopy(server.params["encoder"]),
              "decoder": copy.deepcopy(server.params["decoder"]),
              "codebook": server.params["codebook"].detach().clone()}
    return ClientState(params=params, ema=init_ema(params["codebook"]),
                       step=0)


def client_finetune_step(client: ClientState, cfg: DVQAEConfig,
                         batch: torch.Tensor, lr: float = 1e-4,
                         opt: Optional[AdamWState] = None
                         ) -> Tuple[ClientState, AdamWState, DVQAEOut]:
    """One-shot fine-tuning: encoder + decoder, codebook FROZEN (§2.6);
    a fresh AdamW state when ``opt`` is None."""
    keys = ("encoder", "decoder")
    params = trainable(client.params, keys)
    if opt is None:
        opt = adamw_init(params)
    grads, out = loss_grads(client.params, cfg, batch, keys=keys)
    _, opt = adamw_update(params, grads, opt, lr=lr)
    return client._replace(step=client.step + 1), opt, out


def client_finetune_encode(client: ClientState, cfg: DVQAEConfig,
                           batch: torch.Tensor, *, lr: float = 1e-4,
                           n_local_steps: int = 1
                           ) -> Tuple[ClientState, torch.Tensor]:
    """``n_local_steps`` of frozen-codebook fine-tuning, then the round's
    ONE encoder pass into quantizer space."""
    opt = None
    for _ in range(n_local_steps):
        client, opt, _ = client_finetune_step(client, cfg, batch, lr=lr,
                                              opt=opt)
    z, _ = client_encode(client.params, cfg, batch)
    return client, z


# ------------------------------------------------------------- Steps 3-5

@torch.no_grad()
def client_encode(params, cfg: DVQAEConfig, batch: torch.Tensor):
    """ONE encoder pass into quantizer space: (z, spatial), z being
    IN(z_e) when the disentanglement layer is on."""
    from .disentangle import instance_norm_latent
    from .dvqae import encode
    z_e, spatial = encode(params, cfg, batch)
    if cfg.apply_in:
        z_e = instance_norm_latent(z_e)
    return z_e, spatial


def quantize_indices(cfg: DVQAEConfig, z: torch.Tensor,
                     codebook: torch.Tensor) -> torch.Tensor:
    """Transmitted codes of quantizer-space latents (..., M): (...,) atom
    ids for plain VQ, (..., n_c) per-slice group indices for GSVQ."""
    from .gsvq import gsvq_indices
    from .vq import kernel_nearest_atom
    if cfg.n_groups > 1 or cfg.n_slices > 1:
        return gsvq_indices(z, codebook, n_groups=cfg.n_groups,
                            n_slices=cfg.n_slices)
    return kernel_nearest_atom(z, codebook)


def refresh_stats(cfg: DVQAEConfig, z: torch.Tensor, indices: torch.Tensor):
    """Eq. 7-8 statistics (counts (K,), sums (K, M)) of one batch. GSVQ
    group indices vote their position's FULL latent onto the group's
    representative atom ``g*ng + ng//2``."""
    if cfg.n_groups > 1 or cfg.n_slices > 1:
        ng = cfg.codebook_size // cfg.n_groups
        indices = indices.long() * ng + ng // 2
        z = z.unsqueeze(-2).expand(indices.shape + z.shape[-1:])
    return assignment_stats(z, indices, cfg.codebook_size)


def client_codebook_refresh(client: ClientState, cfg: DVQAEConfig,
                            batch=None, gamma: float = 0.99, *,
                            stats=None) -> ClientState:
    """Step 5 EMA refresh of the local codebook (Eq. 9). With ``stats``
    (the encode kernel's (counts, sums)) no network pass runs; without
    them, one encoder pass over ``batch`` derives them."""
    if stats is None:
        z, _ = client_encode(client.params, cfg, batch)
        idx = quantize_indices(cfg, z, client.params["codebook"])
        stats = refresh_stats(cfg, z, idx)
    ema = ema_update_from_stats(client.ema, *stats, gamma=gamma)
    params = {**client.params, "codebook": ema.codebook}
    return ClientState(params=params, ema=ema, step=client.step)


def stack_clients(clients: Sequence[ClientState]) -> ClientState:
    """Client states -> one ClientState whose codebook, EMA fields and step
    carry a leading (n_clients, ...) axis, the stacked population the
    merge takes. The encoders and decoders are modules and are not
    stacked: the stacked state holds only the codebook."""
    ema = EMAState(*(torch.stack([getattr(c.ema, f) for c in clients])
                     for f in EMAState._fields))
    return ClientState(
        params={"codebook": torch.stack([c.params["codebook"]
                                         for c in clients])},
        ema=ema, step=torch.tensor([int(c.step) for c in clients]))


def server_merge_codebooks(server: ServerState, client_codebooks,
                           client_counts, *, staleness=None,
                           staleness_decay: float = 1.0) -> ServerState:
    """Count-weighted average of synced client codebooks (the Step 5
    tail), on the device of the server's codebook. Takes sequences of
    per-client (K, M) / (K,) tensors or numpy arrays, or stacked (C, K, M)
    / (C, K) ones.
    ``staleness`` ((C,) int, optional) discounts each client's counts by
    ``staleness_decay ** staleness``. Atoms whose total weight is at most
    1e-9 keep the current dictionary."""
    cur = server.params["codebook"]
    cbs = as_stacked(client_codebooks, cur.device)
    w = as_stacked(client_counts, cur.device)
    if staleness is not None:
        # decay ** staleness formed on the host: the card's pow is not
        # correctly rounded, so the weights would differ card to CPU
        st = torch.as_tensor(staleness).detach().cpu().numpy()
        decay = np.float32(staleness_decay) ** st.astype(np.float32)
        w = w * torch.from_numpy(np.asarray(decay, np.float32)) \
            .to(cur.device)[:, None]
    tot = w.sum(dim=0)                                        # (K,)
    merged = torch.einsum("ck,ckm->km", w / tot[None].clamp(min=1e-9), cbs)
    # atoms with no effective contribution keep the current dictionary
    merged = torch.where(tot[:, None] > 1e-9, merged,
                         cur.detach().to(merged.dtype))
    params = {**server.params, "codebook": merged.to(cur.dtype)}
    return ServerState(params=params, opt=server.opt, step=server.step)


def server_merge_stats(server: ServerState, stats: MergeStats
                       ) -> ServerState:
    """The Step 5 tail from associative fixed-point statistics
    (:func:`~repro_torch.core.ema.merge_stats`, or the reference's numpy
    int64 ones): bit-identical for any cohort partition or order of the
    same clients; atoms with no weight keep the current dictionary."""
    merged = merge_codebook(stats, server.params["codebook"].detach())
    params = {**server.params, "codebook": merged}
    return ServerState(params=params, opt=server.opt, step=server.step)


def decode_table(cfg: DVQAEConfig, codebook: torch.Tensor):
    """Decode-side lookup table: ((rows, F), n_slices). Plain VQ: the
    codebook. GSVQ: the stacked per-slice group-mean table
    ((n_slices * n_groups, m), n_slices)."""
    from .gsvq import gsvq_group_mean_table
    if cfg.n_groups > 1 or cfg.n_slices > 1:
        t = gsvq_group_mean_table(codebook, n_groups=cfg.n_groups,
                                  n_slices=cfg.n_slices)
        return t.reshape(cfg.n_slices * cfg.n_groups, -1), cfg.n_slices
    return codebook, 1


def codes_to_features(cfg: DVQAEConfig, payload, codebook: torch.Tensor):
    """Dequantize a :class:`~repro_torch.wire.payload.CodePayload` into
    downstream features in ONE fused decode dispatch, against
    ``codebook``, the registry snapshot the codes were packed under."""
    from repro_torch.wire.codec import decode_payloads
    return decode_payloads([payload], cfg, codebook)[0]
