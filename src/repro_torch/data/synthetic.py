"""Synthetic content/style factorized images and speech, and LM tokens.

Port of ``repro.data.synthetic``. Images: content = which glyph is drawn
(the downstream label), style = an identity's channel gains, bias and
background tint (the private attribute). Speech: content = a sequence of
phonemes, each a characteristic band pattern over the feature channels
(the label is the first), style = a speaker's channel gains and bias.
Tokens: Zipf marginals and a bigram structure. The reference draws with
``jax.random``; the port draws with an explicit CPU ``torch.Generator``,
so the two make different data from one seed. Data is drawn on the host,
as a client's data is, and the session entry points move it to their
device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class LabeledData(NamedTuple):
    x: torch.Tensor          # images (N, H, W, C) or speech (N, T, C)
    content: torch.Tensor    # public label (N,)
    style: torch.Tensor      # private label / identity (N,)


N_SHAPES = 8


def _linspace(size: int) -> torch.Tensor:
    """``jnp.linspace(-1, 1, size)`` in float32, by its own formula
    ``start * (1 - t) + stop * t`` with ``t = i / (size - 1)``, so the
    glyph edges fall on the same pixels as the reference's."""
    if size == 1:
        return torch.full((1,), -1.0)
    t = torch.arange(size - 1, dtype=torch.float32) / (size - 1)
    return torch.cat([-1.0 * (1.0 - t) + t, torch.ones(1)])


def _shape_stencils(size: int) -> torch.Tensor:
    """(N_SHAPES, size, size) binary glyphs: circle, disk, square, ..."""
    r = _linspace(size)
    yy, xx = torch.meshgrid(r, r, indexing="ij")
    rad = torch.sqrt(xx ** 2 + yy ** 2)
    ax, ay = xx.abs(), yy.abs()
    glyphs = [
        (rad - 0.6).abs() < 0.18,                                # circle
        rad < 0.55,                                              # disk
        (ax < 0.6) & (ay < 0.6) & ((ax > 0.35) | (ay > 0.35)),   # square
        (ax < 0.18) | (ay < 0.18),                               # cross
        (xx - yy).abs() < 0.22,                                  # diag
        (xx + yy).abs() < 0.22,                                  # anti
        ay < 0.25,                                               # hbar
        ax < 0.25,                                               # vbar
    ]
    return torch.stack(glyphs).float()


def make_images(generator: Optional[torch.Generator], n: int, *,
                size: int = 32, channels: int = 3,
                n_identities: int = 10) -> LabeledData:
    """Factorized images on the CPU: x = style(identity)(glyph(content))."""
    g = generator
    content = torch.randint(0, N_SHAPES, (n,), generator=g)
    style = torch.randint(0, n_identities, (n,), generator=g)
    base = _shape_stencils(size)[content][..., None]           # (n, s, s, 1)
    # per-identity style: channel gains, bias, background tint
    gains = 0.5 + torch.rand((n_identities, channels), generator=g)
    bias = 0.3 * torch.randn((n_identities, channels), generator=g)
    tint = 0.2 * torch.rand((n_identities, channels), generator=g)
    gs = gains[style][:, None, None, :]
    b = bias[style][:, None, None, :]
    t = tint[style][:, None, None, :]
    noise = 0.05 * torch.randn((n, size, size, channels), generator=g)
    x = base * gs + (1.0 - base) * t + b + noise
    return LabeledData(x=x, content=content, style=style)


# ------------------------------------------------------------------ speech

N_PHONEMES = 16


def _phoneme_bank(channels: int) -> torch.Tensor:
    """(N_PHONEMES, channels) characteristic spectral patterns: a Gaussian
    band around the phoneme's centre channel plus a phoneme-specific
    ripple."""
    c = torch.arange(channels, dtype=torch.float32)
    width = channels / (N_PHONEMES * 1.5)
    pat = []
    for p in range(N_PHONEMES):
        centre = (p + 0.5) * channels / N_PHONEMES
        pat.append(torch.exp(-0.5 * ((c - centre) / width) ** 2)
                   + 0.3 * torch.sin(c * (p + 1) * 0.37))
    return torch.stack(pat)


def assemble_speech(seq: torch.Tensor, style: torch.Tensor,
                    gains: torch.Tensor, bias: torch.Tensor,
                    noise: torch.Tensor, *, frames: int) -> LabeledData:
    """Clips from their draws: phonemes ``seq`` (n, per_clip), speakers
    ``style`` (n,), per-speaker ``gains`` and ``bias`` (speakers, C) and
    additive ``noise`` (n, frames, C). Each phoneme holds
    ``frames // per_clip`` frames; x = bank[phoneme] * gain + bias +
    noise."""
    seg = frames // seq.shape[1]
    per_frame = seq.repeat_interleave(seg, dim=1)[:, :frames]  # (n, frames)
    base = _phoneme_bank(gains.shape[1])[per_frame]           # (n, frames, C)
    x = base * gains[style][:, None, :] + bias[style][:, None, :]
    return LabeledData(x=x + noise, content=seq[:, 0], style=style)


def make_speech(generator: Optional[torch.Generator], n: int, *,
                frames: int = 64, channels: int = 16, n_speakers: int = 10,
                phonemes_per_clip: int = 4) -> LabeledData:
    """Speech-like clips on the CPU: phoneme band patterns under a
    speaker's channel transform. The label is the first phoneme; the
    whole sequence is recoverable frame by frame."""
    g = generator
    seq = torch.randint(0, N_PHONEMES, (n, phonemes_per_clip), generator=g)
    style = torch.randint(0, n_speakers, (n,), generator=g)
    gains = 0.5 + torch.rand((n_speakers, channels), generator=g)
    bias = 0.3 * torch.randn((n_speakers, channels), generator=g)
    noise = 0.05 * torch.randn((n, frames, channels), generator=g)
    return assemble_speech(seq, style, gains, bias, noise, frames=frames)


# ---------------------------------------------------------- LM token data

def make_tokens(generator: Optional[torch.Generator], n_seqs: int,
                seq_len: int, vocab: int) -> torch.Tensor:
    """Synthetic LM corpus (n_seqs, seq_len) int32 on the CPU: Zipf
    marginals (p(rank r) proportional to 1/r) and a bigram structure --
    each next token is ``(tok + 1) % vocab`` with probability 0.5, else a
    fresh Zipf draw -- as the reference's ``make_tokens``."""
    g = generator
    probs = 1.0 / torch.arange(1, vocab + 1, dtype=torch.float64)
    probs = probs / probs.sum()
    first = torch.multinomial(probs, n_seqs, replacement=True, generator=g)
    rest = max(seq_len - 1, 0)
    fresh = torch.multinomial(probs, n_seqs * rest, replacement=True,
                              generator=g).reshape(rest, n_seqs)
    mix = torch.rand((rest, n_seqs), generator=g) < 0.5
    cols, tok = [first], first
    for t in range(rest):
        tok = torch.where(mix[t], (tok + 1) % vocab, fresh[t])
        cols.append(tok)
    return torch.stack(cols, dim=1)[:, :seq_len].to(torch.int32)
