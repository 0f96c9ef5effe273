"""Communication-overhead accounting (§2.8): closed-form byte models for
ordinary FL, gradient-compressed FL, split learning, and OCTOPUS.

Port of ``repro.core.overheads``, pure integer arithmetic equal to the
reference's. These are the formulas behind the paper's efficiency claims;
callers evaluate them with byte counts measured from the built system
(model parameter bytes, packed code bytes).
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class CommModel:
    n_clients: int            # N_C
    model_bytes: int          # N_M (bytes of model params)
    n_samples: int            # N_D (dataset size, samples)
    n_epochs: int             # N_E (global rounds)
    code_bytes_per_sample: int  # N_Z (OCTOPUS latent bytes per sample)
    smashed_bytes_per_sample: int = 0   # N_S (split learning cut layer)
    client_frac_params: float = 1.0     # eta (split learning client share)
    codebook_bytes: int = 0             # N_B
    codebook_sync_rounds: int = 10      # pi (paper: 'generally less than 10')
    downstream_model_bytes: int = 0     # N_A (final model download)


def federated_bytes(c: CommModel) -> int:
    """Ordinary FL: 2 * N_C * N_M * N_E (upload + download per round)."""
    return 2 * c.n_clients * c.model_bytes * c.n_epochs


def gradient_compressed_fl_bytes(c: CommModel, *, up_compress: float = 0.01,
                                 selected_frac: float = 0.1,
                                 round_multiplier: float = 3.0) -> int:
    """(N_C^sel * N_M^up + N_C * N_M) * N_E'; compression inflates rounds
    (N_E' >> N_E) — the paper's convergence-distortion caveat."""
    n_e = int(c.n_epochs * round_multiplier)
    sel = int(c.n_clients * selected_frac)
    up = int(c.model_bytes * up_compress)
    return (sel * up + c.n_clients * c.model_bytes) * n_e


def split_learning_bytes(c: CommModel) -> int:
    """(2 * N_S * N_D + eta * N_C * N_M) * N_E."""
    return int((2 * c.smashed_bytes_per_sample * c.n_samples
                + c.client_frac_params * c.n_clients * c.model_bytes)
               * c.n_epochs)


def octopus_bytes(c: CommModel) -> int:
    """N_D * N_Z + N_M + pi * N_B + N_A: once-off code upload, once-off
    model download, few-shot codebook syncs."""
    return (c.n_samples * c.code_bytes_per_sample
            + c.model_bytes
            + c.codebook_sync_rounds * c.codebook_bytes
            + c.downstream_model_bytes)


def code_bytes(n_positions: int, codebook_size: int, n_slices: int = 1) -> int:
    """Packed bytes of one sample's index matrix."""
    bits = max(1, math.ceil(math.log2(max(codebook_size, 2))))
    return (n_positions * n_slices * bits + 7) // 8


def comparison_table(c: CommModel) -> dict:
    fl = federated_bytes(c)
    oct_ = octopus_bytes(c)
    rows = {
        "federated": fl,
        "fl_grad_compressed": gradient_compressed_fl_bytes(c),
        "split_learning": split_learning_bytes(c),
        "octopus": oct_,
    }
    rows["octopus_vs_fl_ratio"] = fl / max(oct_, 1)
    return rows


def multi_task_bytes(c: CommModel, n_tasks: int) -> dict:
    """§2.8 multi-task: FL reruns everything per task; OCTOPUS reuses the
    gathered codes and only downloads each trained model once."""
    return {
        "federated": n_tasks * federated_bytes(c),
        "octopus": (c.n_samples * c.code_bytes_per_sample
                    + c.model_bytes
                    + c.codebook_sync_rounds * c.codebook_bytes
                    + n_tasks * max(c.downstream_model_bytes, 1)),
    }
