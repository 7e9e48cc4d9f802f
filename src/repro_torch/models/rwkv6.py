"""RWKV-6 "Finch": linear-attention time-mix with data-dependent decay.
The counterpart of `repro.models.rwkv6`.

Time-mix recurrence per head (k-dim x v-dim state S):
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    o_t = r_t (S_{t-1} + diag(u) k_t v_tᵀ)
with the data-dependent decay w_t = exp(-exp(w_base + tanh(x A_w) B_w)).
Channel-mix is the squared-ReLU FFN with token shift.

Two training formulations:
  * 'scan'    the recurrence step by step over T in f32 (the train CLI's
    default, as the reference's `build_model`);
  * 'chunked' block-parallel: intra-chunk masked products and an
    inter-chunk state recurrence.

`_wkv_chunked` differs from the reference's on purpose. The reference
factors each intra-chunk decay exp(c_{t-1} - c_j) through the chunk's
midpoint and clamps both half-exponents at +-70; where t and j lie on the
same side of the midpoint, the clamp turns a small true factor into
e^70 e^-70 = 1, so at the decays `w_base`'s init gives it misses the scan
by O(|o|) at its default chunk of 128 (ROADMAP.md C). Here a pair in two
different sub-blocks of at most `_SUB` steps factors through the end of
the earlier sub-block (both exponents <= 0, so neither overflows and an
underflow only drops a factor below e^-87), and a pair inside one
sub-block takes its exact exponent, masked before `exp`. It agrees with
the scan up to f32 rounding at any decay.

DP mapping, as in the reference: r/k/v/g/o, the decay LoRA and the
channel-mix's k/v/r are DP linears; the token-shift mixes, `w_base` and
the bonus `u` go through `dp_broadcast`; the group-norm scale through
`dp_scale`. Decode state is O(1) in the sequence length.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.spec import P
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

_DECAY_LORA = 64
_SUB = 16  # `_wkv_chunked`'s sub-block: pairs within one take exact exps


def dims(cfg: ModelConfig):
    """(d_model, heads, head dim)."""
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    return d, d // hd, hd


def rwkv6_spec(cfg: ModelConfig, *, stack: tuple[int, ...] = ()) -> dict:
    d, nh, hd = dims(cfg)
    s = len(stack)
    lora = _DECAY_LORA
    dt = cfg.dtype
    return {
        "tm": {  # time mix
            # r, k, v, g, w token-shift mixes
            "mix": P(stack + (5, d), init="uniform", scale=0.5, dtype=dt,
                     stack=s),
            "r": L.linear_spec(d, d, stack=stack, dtype=dt),
            "k": L.linear_spec(d, d, stack=stack, dtype=dt),
            "v": L.linear_spec(d, d, stack=stack, dtype=dt),
            "g": L.linear_spec(d, d, stack=stack, dtype=dt),
            "o": L.linear_spec(d, d, stack=stack, dtype=dt),
            "w_base": P(stack + (d,), init="uniform", scale=1.0, dtype=dt,
                        stack=s),
            "w_lora_a": L.linear_spec(d, lora, stack=stack, dtype=dt),
            "w_lora_b": L.linear_spec(lora, d, stack=stack, dtype=dt),
            # per-head bonus
            "u": P(stack + (nh, hd), init="uniform", scale=0.5, dtype=dt,
                   stack=s),
            "ln": L.rmsnorm_spec(d, stack=stack, dtype=dt),
        },
        "cm": {  # channel mix
            "mix": P(stack + (2, d), init="uniform", scale=0.5, dtype=dt,
                     stack=s),
            "k": L.linear_spec(d, cfg.d_ff, stack=stack, dtype=dt),
            "v": L.linear_spec(cfg.d_ff, d, stack=stack, dtype=dt),
            "r": L.linear_spec(d, d, stack=stack, dtype=dt),
        },
    }


def _th(th, name):
    return None if th is None else th[name]


def _token_shift(x, x_prev_last):
    """shifted(x)[t] = x[t - 1]; position 0 takes x_prev_last (B, 1, D)."""
    return torch.cat([x_prev_last, x[:, :-1]], dim=1)


def _wkv_scan(r, k, v, w, u, s0):
    """The recurrence step by step. r, k, v: (B, T, H, hd); w: (B, T, H,
    hd) decay in (0, 1); u: (B, H, hd); s0: (B, H, hd, hd). Returns (o
    (B, T, H, hd), sT)."""
    s = s0
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B, H, hd, hd)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 s + u[..., :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def _wkv_chunked(r, k, v, w, u, s0, chunk: int):
    """Block-parallel form; the same contract as `_wkv_scan` (module doc
    for the intra-chunk factorisation)."""
    b, t, h, d = r.shape
    q = min(chunk, t)
    nc = -(-t // q)
    pad = nc * q - t

    def padt(x, val=0.0):
        return F.pad(x, (0, 0, 0, 0, 0, pad), value=val)

    rc, kc, vc = (padt(x).float().reshape(b, nc, q, h, d) for x in (r, k, v))
    logw = torch.log(torch.clamp(padt(w, 1.0).float(), 1e-12, 1.0))
    lw = logw.reshape(b, nc, q, h, d)
    cum = torch.cumsum(lw, dim=2)  # c_t = log prod_{j <= t} w_j
    cprev = cum - lw  # c_{t-1} (0 at a chunk's first step)
    ninf = float("-inf")

    # o_t = sum_{j < t} [r_t exp(c_{t-1} - c_j) . k_j] v_j
    #       + (r_t u . k_t) v_t
    o_intra = torch.einsum("bcthd,bhd,bcthd->bcth", rc, u.float(),
                           kc)[..., None] * vc
    pos = torch.arange(q, device=r.device)
    for s0_ in range(0, q, _SUB):
        e = min(s0_ + _SUB, q)
        kj, vj, cj = kc[:, :, s0_:e], vc[:, :, s0_:e], cum[:, :, s0_:e]
        # pairs inside the sub-block: exact exponents, masked before exp
        ti = pos[s0_:e]
        inside = (ti[:, None] > ti[None, :])[None, None, :, :, None, None]
        lexp = cprev[:, :, s0_:e, None] - cj[:, :, None]  # (B,nc,s,s,H,d)
        dec = torch.exp(lexp.masked_fill(~inside, ninf))
        sc = torch.einsum("bcthd,bcjhd,bctjhd->bcthj", rc[:, :, s0_:e], kj,
                          dec)
        o_intra[:, :, s0_:e] += torch.einsum("bcthj,bcjhd->bcthd", sc, vj)
        if e == q:
            continue
        # later steps t >= e: through the sub-block's last step e - 1
        ref = cum[:, :, e - 1:e]  # (B, nc, 1, H, d)
        k_s = kj * torch.exp(ref - cj)
        r_s = rc[:, :, e:] * torch.exp(cprev[:, :, e:] - ref)
        sc = torch.einsum("bcthd,bcjhd->bcthj", r_s, k_s)
        o_intra[:, :, e:] += torch.einsum("bcthj,bcjhd->bcthd", sc, vj)

    # chunk states: S_c = sum_j exp(c_total - c_j) k_j v_jᵀ
    total = cum[:, :, -1]  # (B, nc, H, d)
    states = torch.einsum("bcjhk,bcjhv->bchkv",
                          kc * torch.exp(total[:, :, None] - cum), vc)
    s = s0.float()
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * torch.exp(total[:, c])[..., None] + states[:, c]
    s_prev = torch.stack(s_prevs, dim=1)  # (B, nc, H, K, V)
    # inter-chunk: r_t exp(c_{t-1}) . S_prev
    o_inter = torch.einsum("bcthk,bchkv->bcthv", rc * torch.exp(cprev),
                           s_prev)
    o = (o_intra + o_inter).reshape(b, nc * q, h, d)[:, :t]
    return o.to(r.dtype), s


def _ddlerp(x, xs, mix):
    """x + mix * (xs - x); mix: (B, D), broadcast over T."""
    return x + mix[:, None, :] * (xs - x)


def _decay(p, xw, th, bsz):
    """w = exp(-exp(w_base + tanh(x A_w) B_w)), f32, (B, T, D)."""
    w_base = L.broadcast(p["w_base"], _th(th, "w_base"), bsz)  # (B, D)
    dd = L.linear(p["w_lora_b"],
                  torch.tanh(L.linear(p["w_lora_a"], xw,
                                      _th(th, "w_lora_a"))),
                  _th(th, "w_lora_b"))
    return torch.exp(-torch.exp(w_base[:, None].float() + dd.float()))


def time_mix(cfg: ModelConfig, params, x, th=None, *, x_prev, state,
             formulation: str = "scan", chunk: int = 128):
    """x: (B, T, D); x_prev: (B, 1, D) the last token of the previous
    segment (zeros at the start); state: (B, H, hd, hd) f32. Returns (out,
    the new x_prev, the new state)."""
    d, nh, hd = dims(cfg)
    b, t, _ = x.shape
    p = params
    xs = _token_shift(x, x_prev)
    mix = L.broadcast(p["mix"], _th(th, "mix"), b)  # (B, 5, D)
    xr, xk, xv, xg, xw = (_ddlerp(x, xs, mix[:, i]) for i in range(5))

    r = L.linear(p["r"], xr, _th(th, "r")).reshape(b, t, nh, hd)
    k = L.linear(p["k"], xk, _th(th, "k")).reshape(b, t, nh, hd)
    v = L.linear(p["v"], xv, _th(th, "v")).reshape(b, t, nh, hd)
    g = L.linear(p["g"], xg, _th(th, "g"))
    w = _decay(p, xw, th, b).reshape(b, t, nh, hd)

    u = L.broadcast(p["u"], _th(th, "u"), b)  # (B, H, hd)
    if formulation == "chunked":
        o, s_t = _wkv_chunked(r, k, v, w, u, state, chunk)
    elif formulation == "scan":
        o, s_t = _wkv_scan(r.float(), k.float(), v.float(), w, u, state)
    else:
        raise ValueError(f"rwkv formulation must be 'scan' or 'chunked', "
                         f"got {formulation!r}")
    o = o.reshape(b, t, d)
    o = L.rmsnorm(p["ln"], o.to(x.dtype), _th(th, "ln"), eps=cfg.norm_eps)
    o = o * F.silu(g.float()).to(o.dtype)
    return L.linear(p["o"], o, _th(th, "o")), x[:, -1:], s_t


def channel_mix(cfg: ModelConfig, params, x, th=None, *, x_prev):
    """Returns (out, the new x_prev)."""
    p = params
    xs = _token_shift(x, x_prev)
    mix = L.broadcast(p["mix"], _th(th, "mix"), x.shape[0])  # (B, 2, D)
    xk = _ddlerp(x, xs, mix[:, 0])
    xr = _ddlerp(x, xs, mix[:, 1])
    k = L.linear(p["k"], xk, _th(th, "k"))
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    kv = L.linear(p["v"], k, _th(th, "v"))
    rgate = torch.sigmoid(L.linear(p["r"], xr, _th(th, "r")).float())
    return (rgate * kv.float()).to(x.dtype), x[:, -1:]


def time_mix_decode(cfg: ModelConfig, params, x, *, x_prev, state, th=None):
    """One-token decode: x (B, 1, D), x_prev (B, 1, D), state (B, H, hd,
    hd) f32. Returns (out, x as the next x_prev, the new state)."""
    d, nh, hd = dims(cfg)
    b = x.shape[0]
    p = params
    mix = L.broadcast(p["mix"], _th(th, "mix"), b)
    xr, xk, xv, xg, xw = (_ddlerp(x, x_prev, mix[:, i]) for i in range(5))
    r = L.linear(p["r"], xr, _th(th, "r")).reshape(b, nh, hd).float()
    k = L.linear(p["k"], xk, _th(th, "k")).reshape(b, nh, hd).float()
    v = L.linear(p["v"], xv, _th(th, "v")).reshape(b, nh, hd).float()
    g = L.linear(p["g"], xg, _th(th, "g"))
    w = _decay(p, xw, th, b).reshape(b, nh, hd)
    u = L.broadcast(p["u"], _th(th, "u"), b).float()
    kv = k[..., :, None] * v[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", r, state + u[..., :, None] * kv)
    new_state = w[..., :, None] * state + kv
    o = o.reshape(b, 1, d)
    o = L.rmsnorm(p["ln"], o.to(x.dtype), _th(th, "ln"), eps=cfg.norm_eps)
    o = o * F.silu(g.float()).to(o.dtype)
    return L.linear(p["o"], o, _th(th, "o")), x, new_state


def channel_mix_decode(cfg: ModelConfig, params, x, *, x_prev, th=None):
    """One-token channel mix: (out, x as the next x_prev)."""
    p = params
    mix = L.broadcast(p["mix"], _th(th, "mix"), x.shape[0])
    xk = _ddlerp(x, x_prev, mix[:, 0])
    xr = _ddlerp(x, x_prev, mix[:, 1])
    k = L.linear(p["k"], xk, _th(th, "k"))
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    kv = L.linear(p["v"], k, _th(th, "v"))
    rgate = torch.sigmoid(L.linear(p["r"], xr, _th(th, "r")).float())
    return (rgate * kv.float()).to(x.dtype), x
