"""The OCTOPUS protocol (§2.2) on the serving path: Steps 3-6.

Port of the parts of ``repro.core.octopus`` that the uplink and the
server decode run. ``ClientState`` / ``ServerState`` hold the parameters
(``{"encoder": nn.Module, "codebook": (K, M) tensor}``); the optimizer
state and the training transitions (Steps 1-2) come with the training
slice.
"""
from __future__ import annotations

import copy
from typing import NamedTuple

import torch

from .dvqae import DVQAEConfig
from .ema import EMAState, ema_update_from_stats, init_ema


class ClientState(NamedTuple):
    params: dict              # local DVQ-AE encoder + codebook
    ema: EMAState             # local codebook EMA accumulator
    step: int


class ServerState(NamedTuple):
    params: dict              # global DVQ-AE encoder + codebook
    step: int = 0


def transmit_bits(cfg: DVQAEConfig) -> int:
    """Bits per transmitted code index (§2.8). GSVQ sends one group index
    per slice per position, so its alphabet is n_groups (1-bit floor)."""
    from repro_torch.kernels.pack_bits import code_bits
    if cfg.n_groups > 1 or cfg.n_slices > 1:
        return code_bits(cfg.n_groups)
    return code_bits(cfg.codebook_size)


def server_init(seed: int, cfg: DVQAEConfig, *, device) -> ServerState:
    """A global model drawn in the reference's layout from ``seed``."""
    from repro_torch.convert import init_numpy_params, params_from_numpy
    return ServerState(params=params_from_numpy(
        init_numpy_params(cfg, seed), cfg, device=device))


def client_init(server: ServerState) -> ClientState:
    """Deploy the global model to a client: its own copy of the encoder
    and codebook, and a fresh EMA accumulator."""
    params = {"encoder": copy.deepcopy(server.params["encoder"]),
              "codebook": server.params["codebook"].clone()}
    return ClientState(params=params, ema=init_ema(params["codebook"]),
                       step=0)


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


def client_codebook_refresh(client: ClientState, cfg: DVQAEConfig, *,
                            stats, gamma: float = 0.99) -> ClientState:
    """Step 5 EMA refresh of the local codebook (Eq. 9) from the encode
    kernel's (counts, sums); no network pass runs."""
    ema = ema_update_from_stats(client.ema, *stats, gamma=gamma)
    params = {**client.params, "codebook": ema.codebook}
    return ClientState(params=params, ema=ema, step=client.step)


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
