"""Mamba2 (SSD) block: Zamba2's backbone layer. The counterpart of
`repro.models.mamba2`.

The chunked State-Space-Duality computation of Dao & Gu (2024): within a
chunk of `ssm_chunk` steps the output is an attention-like masked
product; across chunks a recurrence carries the (H, P, N) state.

DP mapping, as in the reference: `in_proj` and `out_proj` are DP linears
(ghost norms; the hand-written kernels on the card); the depthwise conv
weight, `dt_bias`, `a_log` and the `d_skip` vector go through
`dp_broadcast` (their per-example cotangents are O(B x |param|)), each
its own clipping group; the gated norm's scale through `dp_scale`.

One deliberate difference from the reference: `_ssd_chunked` masks the
intra-chunk log-decay differences BEFORE the exponential. The reference
takes `exp` over the whole (q, q) matrix and masks afterwards; above the
diagonal the differences are positive sums of up to q steps, which
overflow to inf at zamba2's chunk of 256, and the backward of the mask
then forms 0 * inf: non-finite gradients (ROADMAP.md C). Where the
reference is finite, the forward values are the same numbers.

Decode keeps a (K - 1, C) conv window and the (H, P, N) SSM state per
layer and slot: O(1) in the sequence length.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.spec import P
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def dims(cfg: ModelConfig):
    """(d_inner, heads, state size N, head dim P)."""
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    return d_in, nheads, cfg.ssm_state, cfg.ssm_head_dim


def mamba2_spec(cfg: ModelConfig, *, stack: tuple[int, ...] = (),
                sensitivity_mult: float = 1.0) -> dict:
    d = cfg.d_model
    d_in, nh, n, _ = dims(cfg)
    conv_ch = d_in + 2 * n  # x, B and C go through the depthwise conv
    s = len(stack)
    sm = sensitivity_mult
    return {
        "in_proj": L.linear_spec(d, 2 * d_in + 2 * n + nh, stack=stack,
                                 dtype=cfg.dtype, sensitivity_mult=sm),
        "conv_w": P(stack + (cfg.ssm_conv_kernel, conv_ch), init="normal",
                    scale=0.2, dtype=cfg.dtype, stack=s, sensitivity_mult=sm),
        "dt_bias": P(stack + (nh,), init="uniform", scale=0.5,
                     dtype=cfg.dtype, stack=s, sensitivity_mult=sm),
        "a_log": P(stack + (nh,), init="uniform", scale=0.5, dtype=cfg.dtype,
                   stack=s, sensitivity_mult=sm),
        "d_skip": P(stack + (nh,), init="ones", dtype=cfg.dtype, stack=s,
                    sensitivity_mult=sm),
        "norm": L.rmsnorm_spec(d_in, stack=stack, dtype=cfg.dtype),
        "out_proj": L.linear_spec(d_in, d, stack=stack, dtype=cfg.dtype,
                                  sensitivity_mult=sm),
    }


def _th(th, name):
    return None if th is None else th[name]


def _split_in(cfg, zxbcdt):
    d_in, _, n, _ = dims(cfg)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in: 2 * d_in + 2 * n]
    dt = zxbcdt[..., 2 * d_in + 2 * n:]
    return z, xbc, dt


def _causal_conv(xbc, w_b):
    """Depthwise causal conv by K shifted adds. xbc: (B, T, C); w_b: (B,
    K, C)."""
    k = w_b.shape[1]
    out = torch.zeros_like(xbc)
    for i in range(k):
        shift = k - 1 - i
        seg = xbc[:, : xbc.shape[1] - shift] if shift else xbc
        seg = F.pad(seg, (0, 0, shift, 0))
        out = out + seg * w_b[:, i][:, None, :]
    return out


def _ssd_chunked(xh, dt, a, B_, C_, chunk: int):
    """Chunked SSD. xh: (B, T, H, P); dt: (B, T, H) f32; a: (B, H)
    (negative); B_, C_: (B, T, N). Returns (y (B, T, H, P) in xh's dtype,
    the final state (B, H, P, N) f32)."""
    b, t, h, p = xh.shape
    n = B_.shape[-1]
    q = min(chunk, t)
    nc = -(-t // q)
    pad = nc * q - t

    def padt(x):  # zeros after the last step along T
        return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))

    xh_, dt_, B__, C__ = padt(xh), padt(dt), padt(B_), padt(C_)
    adt = a[:, None, :] * dt_  # (B, T', H) log-decay per step (<= 0)
    xdt = xh_ * dt_[..., None]

    def r(x):  # (B, nc, q, ...)
        return x.reshape((b, nc, q) + tuple(x.shape[2:]))

    adt_c, xdt_c = r(adt), r(xdt).float()
    B_c, C_c = r(B__).float(), r(C__).float()
    cum = torch.cumsum(adt_c, dim=2)  # (B, nc, q, H)
    total = cum[:, :, -1]  # (B, nc, H)

    # intra-chunk: Y[q_] = sum_{k <= q_} C_q . B_k exp(cum_q - cum_k) xdt_k,
    # the exponent masked to -inf above the diagonal BEFORE exp (module doc)
    ldiff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,q,q,H)
    mask = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    lmat = torch.exp(ldiff.masked_fill(~mask[None, None, :, :, None],
                                       float("-inf")))
    cb = torch.einsum("bcqn,bckn->bcqk", C_c, B_c)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", cb[..., None] * lmat, xdt_c)

    # chunk states: S_c = sum_k exp(total - cum_k) B_k xdt_kᵀ
    decay_k = torch.exp(total[:, :, None, :] - cum)  # (B, nc, q, H)
    states = torch.einsum("bckn,bckhp->bchpn", B_c,
                          xdt_c * decay_k[..., None])

    # inter-chunk recurrence: the state BEFORE each chunk
    s = torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * torch.exp(total[:, c])[:, :, None, None] + states[:, c]
    s_prev = torch.stack(s_prevs, dim=1)  # (B, nc, H, P, N)

    # inter-chunk contribution: Y[q] += C_q . (exp(cum_q) * S_prev)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", C_c, s_prev) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, nc * q, h, p)[:, :t]
    return y.to(xh.dtype), s


def mamba2_block(cfg: ModelConfig, params, x, th=None):
    """x: (B, T, D) -> (B, T, D). th: this block's thresholds (`m`'s
    slice), or None for the plain forward."""
    b, t, _ = x.shape
    d_in, nh, n, p = dims(cfg)
    zxbcdt = L.linear(params["in_proj"], x, _th(th, "in_proj"))
    z, xbc, dt_raw = _split_in(cfg, zxbcdt)

    conv_w = L.broadcast(params["conv_w"], _th(th, "conv_w"), b)  # (B, K, C)
    xbc = F.silu(_causal_conv(xbc, conv_w).float()).to(x.dtype)
    xs = xbc[..., :d_in]
    B_ = xbc[..., d_in: d_in + n]
    C_ = xbc[..., d_in + n:]

    dt_bias = L.broadcast(params["dt_bias"], _th(th, "dt_bias"), b)  # (B, H)
    dt = F.softplus(dt_raw.float() + dt_bias[:, None, :])
    a_log = L.broadcast(params["a_log"], _th(th, "a_log"), b)  # (B, H)
    a = -torch.exp(a_log.float())

    xh = xs.reshape(b, t, nh, p)
    y, _ = _ssd_chunked(xh, dt, a, B_, C_, cfg.ssm_chunk)
    d_skip = L.broadcast(params["d_skip"], _th(th, "d_skip"), b)  # (B, H)
    y = y + xh.float() * d_skip[:, None, :, None]
    y = y.reshape(b, t, d_in).to(x.dtype)

    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = y * F.silu(z.float()).to(y.dtype)
    y = L.rmsnorm(params["norm"], y, _th(th, "norm"), eps=cfg.norm_eps)
    return L.linear(params["out_proj"], y, _th(th, "out_proj"))


def mamba2_decode(cfg: ModelConfig, params, x, conv_state, ssm_state,
                  th=None):
    """One-token decode. x: (B, 1, D); conv_state: (B, K - 1, C);
    ssm_state: (B, H, P, N) f32. Returns (y (B, 1, D), the new conv
    window, the new SSM state); the caller writes them."""
    b = x.shape[0]
    d_in, nh, n, p = dims(cfg)
    zxbcdt = L.linear(params["in_proj"], x, _th(th, "in_proj"))
    z, xbc_new, dt_raw = _split_in(cfg, zxbcdt)  # (B, 1, *)

    conv_w = L.broadcast(params["conv_w"], _th(th, "conv_w"), b)  # (B, K, C)
    window = torch.cat([conv_state, xbc_new[:, :1]], dim=1)  # (B, K, C)
    xbc = torch.sum(window * conv_w, dim=1, keepdim=True)
    xbc = F.silu(xbc.float()).to(x.dtype)
    new_conv_state = window[:, 1:]

    xs = xbc[..., :d_in]
    B_ = xbc[:, 0, d_in: d_in + n].float()
    C_ = xbc[:, 0, d_in + n:].float()
    dt_bias = L.broadcast(params["dt_bias"], _th(th, "dt_bias"), b)
    dt = F.softplus(dt_raw[:, 0].float() + dt_bias)  # (B, H)
    a_log = L.broadcast(params["a_log"], _th(th, "a_log"), b)
    a = -torch.exp(a_log.float())

    xh = xs[:, 0].reshape(b, nh, p).float()
    decay = torch.exp(a * dt)  # (B, H)
    upd = (xh[..., None] * B_[:, None, None, :]) * dt[:, :, None, None]
    new_ssm = ssm_state * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_ssm, C_)
    d_skip = L.broadcast(params["d_skip"], _th(th, "d_skip"), b)
    y = y + xh * d_skip[:, :, None]
    y = y.reshape(b, 1, d_in).to(x.dtype)
    y = y * F.silu(z.float()).to(y.dtype)
    y = L.rmsnorm(params["norm"], y, _th(th, "norm"), eps=cfg.norm_eps)
    return (L.linear(params["out_proj"], y, _th(th, "out_proj")),
            new_conv_state, new_ssm)
