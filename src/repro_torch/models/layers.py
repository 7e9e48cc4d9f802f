"""Shared building blocks: norms, linear, SwiGLU, rotary embeddings
(RoPE and Qwen2-VL's multimodal M-RoPE), Whisper's sinusoidal positions.

`rmsnorm`, `linear`, `swiglu` and `broadcast` take an optional `th`,
this module's slice of the encoded-threshold dict (tensors, or the BK
capture's channels, `repro_torch.core.bk`). With it (training) every parameter
goes through a DP primitive (`repro_torch.core.dp_layers`), so clipping is
fused into backprop; without it (serving) they are the plain forward.
Every bf16 rounding point of the reference is mirrored: normalisation and
silu run in f32 and cast back before the scale or the gate multiply, and
RoPE angles are f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import dp_layers as dpl
from repro_torch.core.spec import P


def rmsnorm_spec(d: int, *, stack: tuple[int, ...] = (),
                 dtype=torch.float32) -> dict:
    return {"s": P(stack + (d,), init="ones", dtype=dtype, stack=len(stack))}


def _normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    mu = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(mu + eps)).to(x.dtype)


def rmsnorm(params, x, th=None, *, eps: float = 1e-5):
    if th is None:
        return _normalize(x, eps) * params["s"]
    return dpl.dp_scale(params["s"], _normalize(x, eps), th)


def broadcast(p, th, bsz: int):
    """p expanded to (bsz,) + p.shape: `dp_broadcast` under thresholds
    (each example's cotangent is its gradient), the plain expand without
    them."""
    if th is None:
        return p.expand((bsz,) + tuple(p.shape))
    return dpl.dp_broadcast(p, th)


def linear_spec(din: int, dout: int, *, bias: bool = False,
                stack: tuple[int, ...] = (), dtype=torch.float32,
                blocks: int = 1, sensitivity_mult: float = 1.0) -> dict:
    """sensitivity_mult: the call sites of a shared layer (its group's
    clipped sum adds one clipped gradient per site)."""
    s = len(stack)
    out = {"w": P(stack + (din, dout), dtype=dtype, stack=s, blocks=blocks,
                  sensitivity_mult=sensitivity_mult)}
    if bias:
        # a blocked layer splits the bias into the same M column blocks, so
        # the {w, b} pair stays one group per block
        out["b"] = P(stack + (dout,), init="zeros", dtype=dtype, stack=s,
                     blocks=blocks, sensitivity_mult=sensitivity_mult)
    return out


def linear(params, x, th=None):
    if th is None:
        y = x @ params["w"]
        return y + params["b"] if "b" in params else y
    return dpl.dp_linear(params["w"], params.get("b"), x, th)


def linear_blocked(params, x, th):
    """A linear clipped per column block. th: (M, B) from the layout, or
    a BK channel of it -> (B, M) for the primitive."""
    return dpl.dp_linear_blocked(params["w"], params.get("b"), x, th.T,
                                 "out")


def swiglu_spec(d: int, f: int, *, stack: tuple[int, ...] = (),
                dtype=torch.float32, sensitivity_mult: float = 1.0) -> dict:
    sm = sensitivity_mult
    return {
        "gate_up": linear_spec(d, 2 * f, stack=stack, dtype=dtype,
                               sensitivity_mult=sm),
        "down": linear_spec(f, d, stack=stack, dtype=dtype,
                            sensitivity_mult=sm),
    }


def swiglu(params, x, th_prefix=None, *, f: int):
    th = th_prefix if th_prefix is not None else {"gate_up": None,
                                                  "down": None}
    gu = linear(params["gate_up"], x, th["gate_up"])
    gate, up = gu[..., :f], gu[..., f:]
    h = F.silu(gate.float()).to(x.dtype) * up
    return linear(params["down"], h, th["down"])


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Interleaved-pair RoPE (pairs x[..., ::2], x[..., 1::2]), as the
    reference; not the half-split form. x: (B, T, H, hd); positions:
    (B, T) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs  # (B, T, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_m_rope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                 sections: tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL), interleaved pairs as `apply_rope`: the
    head_dim / 2 frequency slots split into `sections` (t, h, w), each
    slot rotated by its section's stream. x: (B, T, H, hd); positions3:
    (3, B, T) int. Equal streams give `apply_rope` of that stream bit for
    bit."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"m_rope sections {tuple(sections)} must sum to "
                         f"head_dim / 2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)
    sec_ids = torch.cat([torch.full((s,), i, dtype=torch.long,
                                    device=x.device)
                         for i, s in enumerate(sections)])
    pos = positions3.float()[sec_ids]  # (hd/2, B, T): a slot's stream
    ang = pos.movedim(0, -1) * freqs  # (B, T, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def sinusoidal_positions(seq_len: int, d: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal embeddings, (seq_len, d) f32: sin on the
    even columns, cos on the odd ones, angle pos / 10000^(2i / d). The
    denominators are rounded to f32 from float64: torch's f32 `pow` is
    one f32 step off the correctly rounded value (the reference's) at a
    few exponents, which moves the angle at position 65,535 by ~2e-3."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float64, device=device)[None, :]
    ang = pos / (10_000.0 ** (dim / d)).float()
    out = torch.zeros((seq_len, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out
