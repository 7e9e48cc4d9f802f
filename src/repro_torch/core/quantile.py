"""Private per-group quantile estimation for adaptive clipping thresholds.

The counterpart of `repro.core.quantile`: the geometric-update quantile
tracker of Andrew et al. (2019) in the per-layer setting of the paper
(Algorithm 1, lines 15-17):

    b_k      = #(examples in batch whose group-k grad norm <= C_k)
    b~_k     = (b_k + N(0, sigma_b^2)) / B          (privatized fraction)
    C_k     <- C_k * exp(-eta * (b~_k - q))         (geometric update)

The count noise comes from a `torch.Generator` the caller passes (torch's
Philox, not JAX's threefry: the tests substitute draws to compare).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class QuantileState(NamedTuple):
    """State of K independent quantile trackers (one per clipping group).
    The scalars are Python floats holding float32 values, as the
    reference's float32 scalars: a checkpoint stores them as float32 and
    reads back the same values (the tensor ops round a Python scalar to
    float32 anyway)."""

    thresholds: torch.Tensor  # (K,) float32 current thresholds C_k (> 0)
    target_quantile: float  # q in [0, 1]
    lr: float  # eta (the paper uses 0.3 everywhere)
    sigma_b: float  # noise multiplier of the count release


def init_quantile_state(init_thresholds, *, target_quantile: float = 0.5,
                        lr: float = 0.3, sigma_b: float = 10.0,
                        device: str | torch.device = "cpu") -> QuantileState:
    thresholds = torch.as_tensor(init_thresholds, dtype=torch.float32,
                                 device=device)
    if thresholds.dim() == 0:
        thresholds = thresholds[None]
    return QuantileState(thresholds=thresholds,
                         target_quantile=_f32(target_quantile),
                         lr=_f32(lr), sigma_b=_f32(sigma_b))


def _f32(x: float) -> float:
    """x rounded to float32, as the reference holds its scalars."""
    return float(np.float32(x))


def export_state(state: QuantileState) -> dict:
    """Plain-python snapshot of the tracker (JSON / msgpack safe), equal
    to the reference's for the same state. It rides in a checkpoint
    manifest's `meta`; the authoritative thresholds are the checkpointed
    DPState's."""
    return {
        "thresholds": [float(t) for t in
                       state.thresholds.detach().cpu().numpy()],
        "target_quantile": float(state.target_quantile),
        "lr": float(state.lr),
        "sigma_b": float(state.sigma_b),
    }


def restore_state(snapshot: dict) -> QuantileState:
    """Inverse of `export_state` (the float32 round trip is exact), with
    the thresholds on the CPU."""
    return QuantileState(
        thresholds=torch.tensor(snapshot["thresholds"], dtype=torch.float32),
        target_quantile=_f32(snapshot["target_quantile"]),
        lr=_f32(snapshot["lr"]), sigma_b=_f32(snapshot["sigma_b"]))


def clip_counts(norms_sq: torch.Tensor,
                thresholds: torch.Tensor) -> torch.Tensor:
    """b_k = sum_i 1[ ||g_k^(i)|| <= C_k ].

    norms_sq: (K, B) per-group per-example squared norms; thresholds: (K,).
    Returns (K,) float counts."""
    return torch.sum((norms_sq <= thresholds[:, None] ** 2).float(), dim=-1)


def count_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal draws for the count release, one per tracker (its
    own function, so a test can substitute the reference's draws)."""
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device)


def update_thresholds(state: QuantileState, counts: torch.Tensor,
                      batch_size: int,
                      generator: torch.Generator) -> QuantileState:
    """One private geometric update of all K thresholds (Alg. 1 l.15-17)."""
    noise = state.sigma_b * count_noise(state.thresholds.shape, generator)
    frac = (counts + noise) / float(batch_size)
    new = state.thresholds * torch.exp(
        -state.lr * (frac - state.target_quantile))
    # keep thresholds strictly positive and finite
    return state._replace(thresholds=torch.clamp(new, 1e-10, 1e10))
