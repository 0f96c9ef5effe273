"""Distributed Vector-Quantized Autoencoder (OCTOPUS §2.3).

Port of ``repro.core.dvqae``: the configuration (its own copy of the
reference's dataclass), the encoders and decoders as ``nn.Module``s,
:func:`encode`, :func:`decode` and the training pass :func:`forward` with
the Eq. 6 loss. Parameters are ``{"encoder": nn.Module, "decoder":
nn.Module, "codebook": (K, M)}``.

The modules take the reference's layouts — (B, H, W, C) images, (B, T, C)
frames and (B, T, d_model) sequences — and :func:`encode` returns (B, P,
M) latents, P = (H/4)*(W/4), T/4 or T. Inside the conv kinds run in
PyTorch's NCHW / NCT layout. The ``sequence`` kind is one bias-free
projection each way, whose width ``d_model`` is not part of the config:
the caller passes it, as the reference's ``init_dvqae(..., d_model=)``
takes it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.layers import (Conv1d, Conv2d, ConvTranspose2d,
                                   _instance_norm, dense_init)

from .disentangle import DisentangledLatent, recombine, split_public_private


@dataclass(frozen=True)
class DVQAEConfig:
    kind: str = "image"            # image | speech | sequence
    in_channels: int = 3           # image channels / speech feature dim
    hidden: int = 128              # conv channel width
    n_res_blocks: int = 2
    latent_dim: int = 64           # M, codebook atom dim
    codebook_size: int = 256       # K
    n_groups: int = 1              # GSVQ groups (1 = plain VQ)
    n_slices: int = 1              # GSVQ slices
    apply_in: bool = True          # InstanceNorm disentanglement on/off
    encoder_in: bool = True        # IN inside the encoder convs
    alpha: float = 1.0             # codebook loss weight
    beta: float = 0.25             # commitment weight
    lam: float = 0.01              # latent (IN-pull) weight, paper lambda

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class _ResBlock(nn.Module):
    def __init__(self, conv, c: int, generator=None):
        super().__init__()
        self.c1 = conv(c, c, 3, generator=generator)
        self.c2 = conv(c, c, 1, generator=generator)

    def forward(self, x):
        h = self.c1(F.relu(x))
        return x + self.c2(F.relu(h))


class _ConvEncoder(nn.Module):
    """Two stride-2 convs (with IN), a mid conv, res blocks, to_latent."""

    conv = Conv2d
    spatial = (2, 3)

    def __init__(self, cfg: DVQAEConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c, h = cfg.in_channels, cfg.hidden
        g = generator
        self.encoder_in = cfg.encoder_in
        self.down1 = self.conv(c, h // 2, 4, generator=g)
        self.down2 = self.conv(h // 2, h, 4, generator=g)
        self.mid = self.conv(h, h, 3, generator=g)
        self.to_latent = self.conv(h, cfg.latent_dim, 1, generator=g)
        for i in range(cfg.n_res_blocks):
            self.add_module(f"res{i}", _ResBlock(self.conv, h, generator=g))
        self.n_res_blocks = cfg.n_res_blocks

    def _trunk(self, x):
        h = F.relu(self.down1(x, stride=2))
        if self.encoder_in:
            h = _instance_norm(h, self.spatial, 1e-5)
        h = F.relu(self.down2(h, stride=2))
        if self.encoder_in:
            h = _instance_norm(h, self.spatial, 1e-5)
        h = self.mid(h)
        for i in range(self.n_res_blocks):
            h = getattr(self, f"res{i}")(h)
        return self.to_latent(F.relu(h))


class ImageEncoder(_ConvEncoder):
    """(B, H, W, C) images -> (B, H/4, W/4, M) latents."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._trunk(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SpeechEncoder(_ConvEncoder):
    """(B, T, C) frames -> (B, T/4, M) latents."""

    conv = Conv1d
    spatial = (2,)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._trunk(x.transpose(1, 2)).transpose(1, 2)


class _ConvDecoder(nn.Module):
    """from_latent conv, res blocks, then two 2x upsampling stages."""

    def __init__(self, cfg: DVQAEConfig, conv, up, ksize: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c, h = cfg.in_channels, cfg.hidden
        g = generator
        self.from_latent = conv(cfg.latent_dim, h, 3, generator=g)
        self.up1 = up(h, h // 2, ksize, generator=g)
        self.up2 = up(h // 2, c, ksize, generator=g)
        for i in range(cfg.n_res_blocks):
            self.add_module(f"res{i}", _ResBlock(conv, h, generator=g))
        self.n_res_blocks = cfg.n_res_blocks

    def _res(self, z):
        h = self.from_latent(z)
        for i in range(self.n_res_blocks):
            h = getattr(self, f"res{i}")(h)
        return h


class ImageDecoder(_ConvDecoder):
    """(B, H/4, W/4, M) latents -> (B, H, W, C) images: two stride-2
    transposed convs (k=4)."""

    def __init__(self, cfg: DVQAEConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, Conv2d, ConvTranspose2d, 4,
                         generator=generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self._res(z.permute(0, 3, 1, 2))
        h = F.relu(self.up1(F.relu(h), stride=2))
        return self.up2(h, stride=2).permute(0, 2, 3, 1)


class SpeechDecoder(_ConvDecoder):
    """(B, T/4, M) latents -> (B, T, C) frames: two (repeat x2, conv k=3)
    stages."""

    def __init__(self, cfg: DVQAEConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, Conv1d, Conv1d, 3, generator=generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self._res(z.transpose(1, 2))
        h = F.relu(self.up1(F.relu(h).repeat_interleave(2, dim=-1)))
        return self.up2(h.repeat_interleave(2, dim=-1)).transpose(1, 2)


class SequenceProjection(nn.Module):
    """The ``sequence`` kind's encoder or decoder: ``x @ proj``, ``proj``
    (d_in, d_out), no bias (d_model -> M encodes, M -> d_model decodes)."""

    def __init__(self, d_in: int, d_out: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = nn.Parameter(dense_init(d_in, d_out, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.proj


def _d_model(d_model: Optional[int]) -> int:
    if d_model is None:
        raise ValueError("a sequence DVQ-AE needs d_model, the width of "
                         "the hidden states it encodes")
    return int(d_model)


def make_encoder(cfg: DVQAEConfig, *,
                 generator: Optional[torch.Generator] = None,
                 d_model: Optional[int] = None) -> nn.Module:
    if cfg.kind == "image":
        return ImageEncoder(cfg, generator=generator)
    if cfg.kind == "speech":
        return SpeechEncoder(cfg, generator=generator)
    if cfg.kind == "sequence":
        return SequenceProjection(_d_model(d_model), cfg.latent_dim,
                                  generator=generator)
    raise ValueError(f"unknown DVQ-AE kind={cfg.kind!r}")


def make_decoder(cfg: DVQAEConfig, *,
                 generator: Optional[torch.Generator] = None,
                 d_model: Optional[int] = None) -> nn.Module:
    if cfg.kind == "image":
        return ImageDecoder(cfg, generator=generator)
    if cfg.kind == "speech":
        return SpeechDecoder(cfg, generator=generator)
    if cfg.kind == "sequence":
        return SequenceProjection(cfg.latent_dim, _d_model(d_model),
                                  generator=generator)
    raise ValueError(f"unknown DVQ-AE kind={cfg.kind!r}")


class DVQAEOut(NamedTuple):
    recon: torch.Tensor
    latent: DisentangledLatent
    loss: torch.Tensor
    recon_loss: torch.Tensor


def encode(params, cfg: DVQAEConfig, x: torch.Tensor):
    """-> (z (B, P, M), spatial): (H/4, W/4) for images, None for speech
    and sequences."""
    z = params["encoder"](x)
    if cfg.kind == "image":
        B, H, W, M = z.shape
        return z.reshape(B, H * W, M), (H, W)
    return z, None


def decode(params, cfg: DVQAEConfig, z: torch.Tensor, spatial=None
           ) -> torch.Tensor:
    """(B, P, M) latents -> reconstructions in the input's layout."""
    if cfg.kind == "image":
        H, W = spatial
        z = z.reshape(z.shape[0], H, W, cfg.latent_dim)
    return params["decoder"](z)


def forward(params, cfg: DVQAEConfig, x: torch.Tensor, *,
            group_axis=None) -> DVQAEOut:
    """Full autoencoding pass with disentanglement (Eq. 6 objective)."""
    z_e, spatial = encode(params, cfg, x)
    dis = split_public_private(
        z_e, params["codebook"], group_axis=group_axis,
        apply_in=cfg.apply_in, n_groups=cfg.n_groups, n_slices=cfg.n_slices)
    x_rec = decode(params, cfg, recombine(dis.public, dis.private), spatial)
    recon = (x - x_rec).square().mean()
    loss = (recon + cfg.alpha * dis.codebook_loss
            + cfg.beta * dis.commit_loss + cfg.lam * dis.latent_loss)
    return DVQAEOut(recon=x_rec, latent=dis, loss=loss, recon_loss=recon)
