"""Rényi-DP accounting for the subsampled Gaussian mechanism.

Implements:
  * RDP of the Poisson-subsampled Gaussian mechanism (Mironov 2017;
    Mironov, Talwar, Zhang 2019 "RDP of the Sampled Gaussian Mechanism"),
    evaluated over a standard grid of orders.
  * Conversion RDP -> (eps, delta)  (Canonne-Kamath-Steinke-style tight
    conversion as used by TF-Privacy / Opacus).
  * Bisection calibration of the noise multiplier sigma from a target
    (eps, delta, sampling_rate, steps).
  * Proposition 3.1 of the paper: budget split between gradient noising and
    private per-layer quantile estimation,
        sigma_new = (sigma^-2 - K / (2 sigma_b)^2)^(-1/2),
    and Remark 3.1's fraction r = K sigma^2 / (4 sigma_b^2).

Pure numpy: a copy of `repro.core.accounting`, so the port imports
nothing of the JAX package; the parity tests hold the two to 1e-12. The
incremental accountant and ledger replay of the training service come
with it (ROADMAP A.12).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

# Standard order grid (matches TF-privacy defaults plus a fine low range).
DEFAULT_ORDERS: tuple[float, ...] = tuple(
    [1.0 + x / 10.0 for x in range(1, 100)]
    + list(range(11, 64))
    + [128.0, 256.0, 512.0, 1024.0]
)


def _log_add(a: float, b: float) -> float:
    """log(exp(a) + exp(b)) stably."""
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    hi, lo = (a, b) if a > b else (b, a)
    return hi + math.log1p(math.exp(lo - hi))


def _log_sub(a: float, b: float) -> float:
    """log(exp(a) - exp(b)) stably, requires a >= b."""
    if b == -math.inf:
        return a
    if a == b:
        return -math.inf
    return a + math.log1p(-math.exp(b - a))


def _log_comb(n: int, k: int) -> float:
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def _rdp_int_order(q: float, sigma: float, alpha: int) -> float:
    """RDP at integer order alpha for the sampled Gaussian (MTZ'19, Sec 3.3)."""
    # log( sum_k C(alpha,k) (1-q)^(alpha-k) q^k exp(k(k-1)/(2 sigma^2)) )
    log_a = -math.inf
    for k in range(alpha + 1):
        term = (
            _log_comb(alpha, k)
            + k * math.log(q)
            + (alpha - k) * math.log1p(-q)
            + (k * k - k) / (2.0 * sigma * sigma)
        )
        log_a = _log_add(log_a, term)
    return log_a / (alpha - 1)


def _rdp_frac_order(q: float, sigma: float, alpha: float) -> float:
    """RDP at fractional order via the stable series of MTZ'19 (Sec 3.2).

    Mirrors tensorflow-privacy's `_compute_log_a_frac` (two-series
    decomposition around z0 with generalized binomial coefficients).
    """
    log_a0, log_a1 = -math.inf, -math.inf
    z0 = sigma * sigma * math.log(1.0 / q - 1.0) + 0.5
    sqrt2s = math.sqrt(2.0) * sigma
    i = 0
    # generalized binom(alpha, i), tracked as (sign, log|.|)
    coef_sign, log_coef = 1.0, 0.0
    while True:
        j = alpha - i
        log_t0 = log_coef + i * math.log(q) + j * math.log1p(-q)
        log_t1 = log_coef + j * math.log(q) + i * math.log1p(-q)
        log_e0 = math.log(0.5) + _log_erfc((i - z0) / sqrt2s)
        log_e1 = math.log(0.5) + _log_erfc((z0 - j) / sqrt2s)
        log_s0 = log_t0 + (i * i - i) / (2.0 * sigma * sigma) + log_e0
        log_s1 = log_t1 + (j * j - j) / (2.0 * sigma * sigma) + log_e1
        if coef_sign > 0:
            log_a0 = _log_add(log_a0, log_s0)
            log_a1 = _log_add(log_a1, log_s1)
        else:
            log_a0 = _log_sub(log_a0, log_s0)
            log_a1 = _log_sub(log_a1, log_s1)
        # next coefficient: binom(alpha, i+1) = binom(alpha, i) * (alpha-i)/(i+1)
        factor = (alpha - i) / (i + 1)
        if factor == 0.0:
            break
        if factor < 0:
            coef_sign = -coef_sign
        log_coef += math.log(abs(factor))
        i += 1
        if max(log_s0, log_s1) < -30:
            break
        if i > 1024:  # safety bound
            break
    return _log_add(log_a0, log_a1) / (alpha - 1)


def _log_erfc(x: float) -> float:
    """log(erfc(x)) stably for large positive x."""
    if x > 6.0:
        # asymptotic expansion
        return -x * x - math.log(x * math.sqrt(math.pi)) + math.log1p(-1.0 / (2 * x * x))
    return math.log(math.erfc(x))


def rdp_sampled_gaussian(
    q: float, sigma: float, steps: int, orders: Sequence[float] = DEFAULT_ORDERS
) -> np.ndarray:
    """RDP (per order) of `steps` compositions of the sampled Gaussian."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"sampling rate q must be in [0, 1], got {q}")
    if not math.isfinite(sigma) or sigma <= 0:
        raise ValueError(f"noise multiplier sigma must be positive, got {sigma}")
    if steps < 0:
        raise ValueError(f"steps must be non-negative, got {steps}")
    if len(orders) == 0:
        raise ValueError("order grid is empty")
    if any(a <= 1.0 for a in orders):
        raise ValueError("all RDP orders must be > 1")
    if q == 0:
        return np.zeros(len(orders))
    out = np.empty(len(orders))
    for idx, alpha in enumerate(orders):
        if q == 1.0:
            rdp = alpha / (2 * sigma * sigma)
        elif float(alpha).is_integer():
            rdp = _rdp_int_order(q, sigma, int(alpha))
        else:
            rdp = _rdp_frac_order(q, sigma, alpha)
        out[idx] = rdp * steps
    return out


def rdp_to_eps(
    rdp: np.ndarray, delta: float, orders: Sequence[float] = DEFAULT_ORDERS
) -> float:
    """Tight RDP -> (eps, delta) conversion (CKS'20 / TF-privacy)."""
    orders_arr = np.asarray(orders, dtype=float)
    rdp = np.asarray(rdp, dtype=float)
    if orders_arr.size == 0:
        raise ValueError("order grid is empty")
    if rdp.shape != orders_arr.shape:
        raise ValueError(
            f"rdp grid has shape {rdp.shape}, orders {orders_arr.shape}")
    if np.any(orders_arr <= 1.0):
        raise ValueError("all RDP orders must be > 1")
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    with np.errstate(over="ignore", invalid="ignore"):
        eps = (
            rdp
            + np.log1p(-1.0 / orders_arr)
            - (np.log(delta) + np.log(orders_arr)) / (orders_arr - 1.0)
        )
    eps = np.where(np.isnan(eps), np.inf, eps)
    return float(max(0.0, np.min(eps)))


def compute_epsilon(
    *,
    sigma: float,
    sampling_rate: float,
    steps: int,
    delta: float,
    orders: Sequence[float] = DEFAULT_ORDERS,
) -> float:
    """(eps) spent by `steps` DP-SGD iterations at noise multiplier sigma."""
    rdp = rdp_sampled_gaussian(sampling_rate, sigma, steps, orders)
    return rdp_to_eps(rdp, delta, orders)


def calibrate_sigma(
    *,
    target_eps: float,
    sampling_rate: float,
    steps: int,
    delta: float,
    sigma_lo: float = 0.1,
    sigma_hi: float = 64.0,
    tol: float = 1e-4,
) -> float:
    """Smallest sigma achieving <= target_eps, by bisection."""
    if target_eps <= 0:
        raise ValueError("target_eps must be positive")
    if not 0.0 < sampling_rate <= 1.0:
        raise ValueError(
            f"sampling_rate must be in (0, 1], got {sampling_rate}")
    if steps <= 0:
        raise ValueError(f"steps must be positive, got {steps}")
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    # grow hi until feasible
    while compute_epsilon(
        sigma=sigma_hi, sampling_rate=sampling_rate, steps=steps, delta=delta
    ) > target_eps:
        sigma_hi *= 2.0
        if sigma_hi > 1e6:
            raise RuntimeError("cannot calibrate sigma: eps target too small")
    lo, hi = sigma_lo, sigma_hi
    while hi / lo > 1.0 + tol:
        mid = math.sqrt(lo * hi)
        eps = compute_epsilon(
            sigma=mid, sampling_rate=sampling_rate, steps=steps, delta=delta
        )
        if eps > target_eps:
            lo = mid
        else:
            hi = mid
    return hi


# ---------------------------------------------------------------------------
# Proposition 3.1: budget split for private quantile estimation.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BudgetSplit:
    sigma: float        # original noise multiplier (all budget to gradients)
    sigma_new: float    # gradient noise multiplier after paying for quantiles
    sigma_b: float      # clip-count noise multiplier (sensitivity 1/2)
    num_groups: int     # K
    r: float            # fraction of (RDP) budget spent on quantile releases


def split_noise_multiplier(sigma: float, sigma_b: float, num_groups: int) -> BudgetSplit:
    """Proposition 3.1: sigma_new = (sigma^-2 - K/(2 sigma_b)^2)^(-1/2)."""
    k = num_groups
    denom = sigma ** (-2) - k / (2.0 * sigma_b) ** 2
    if denom <= 0:
        raise ValueError(
            f"quantile-estimation budget exhausts the whole budget: "
            f"sigma={sigma}, sigma_b={sigma_b}, K={k}; increase sigma_b"
        )
    sigma_new = denom ** (-0.5)
    r = (k * sigma * sigma) / (4.0 * sigma_b * sigma_b)  # Remark 3.1
    return BudgetSplit(sigma=sigma, sigma_new=sigma_new, sigma_b=sigma_b,
                       num_groups=k, r=r)


def sigma_b_for_fraction(sigma: float, num_groups: int, r: float) -> float:
    """Invert Remark 3.1: the sigma_b that spends fraction r on K quantiles."""
    if not 0.0 < r < 1.0:
        raise ValueError("r must be in (0, 1)")
    return math.sqrt(num_groups * sigma * sigma / (4.0 * r))
