"""Noise allocation for group-wise clipping (paper Sec. 3.3).

The counterpart of `repro.core.noise`. The Gaussian mechanism is applied
to the scaled concatenation g_hat = (g~_1/gamma_1, ..., g~_K/gamma_K),
whose L2 sensitivity is S = sqrt(sum_k C_k^2 / gamma_k^2); unscaling
afterwards gives group k per-coordinate std sigma_new * S * gamma_k
(Algorithm 1, line 13). Strategies for gamma_k:

  * global       : gamma_k = 1
  * equal_budget : gamma_k = C_k          (S = sqrt(K))
  * weighted     : gamma_k = C_k/sqrt(d_k)

The draws themselves live in `core.dp_sgd` (one generator per leaf path).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.spec import stable_hash

Strategy = str  # 'global' | 'equal_budget' | 'weighted'
_STRATEGIES = ("global", "equal_budget", "weighted")


def gammas(strategy: Strategy, thresholds: torch.Tensor,
           dims: torch.Tensor) -> torch.Tensor:
    """Scaling coefficients gamma_k, shape (K,)."""
    if strategy == "global":
        return torch.ones_like(thresholds)
    if strategy == "equal_budget":
        return thresholds
    if strategy == "weighted":
        return thresholds / torch.sqrt(dims.float())
    raise ValueError(f"unknown noise allocation strategy {strategy!r}; "
                     f"expected one of {_STRATEGIES}")


def sensitivity(thresholds: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """S = sqrt(sum_k C_k^2 / gamma_k^2)."""
    return torch.sqrt(torch.sum((thresholds / g) ** 2))


def group_noise_stds(strategy: Strategy, thresholds: torch.Tensor,
                     dims: torch.Tensor, sigma_new: float) -> torch.Tensor:
    """Per-group per-coordinate noise std, shape (K,): sigma_new*S*gamma_k."""
    g = gammas(strategy, thresholds, dims)
    return float(sigma_new) * sensitivity(thresholds, g) * g


def check_leaf_key_collisions(paths: list[str],
                              hash_fn: Callable[[str], int] = stable_hash
                              ) -> dict[int, str]:
    """Raise if two distinct leaf paths fold to the SAME 31-bit hash.

    Colliding paths would receive IDENTICAL noise draws, and correlated
    noise voids the Gaussian mechanism's guarantee while each leaf's draw
    still looks Gaussian. Returns the (hash -> path) table."""
    seen: dict[int, str] = {}
    for path in paths:
        h = hash_fn(path)
        other = seen.get(h)
        if other is not None and other != path:
            raise ValueError(
                f"PRNG leaf-key collision: parameter paths {other!r} and "
                f"{path!r} both fold to key hash {h} — their noise draws "
                f"would be identical (correlated noise voids the DP "
                f"guarantee). Rename one of the parameters.")
        seen[h] = path
    return seen
