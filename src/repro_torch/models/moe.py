"""Mixture-of-Experts: token-choice top-k routing with capacity dispatch.

The counterpart of `repro.models.moe`, both dispatches:

* flat (`moe_block`, `moe_dispatch = "flat"`): one global capacity per
  expert over all B·T tokens, tokens dispatched into stacked (E, C, d)
  expert buffers by slots from a cumsum over the routing one-hot (no
  (tokens, E, C) dispatch tensors), overflow tokens dropped. Slots mix
  examples, so the exact per-example norms need example-masked grams
  (`core.dp_layers.dp_expert_linear`).
* grouped (`moe_block_grouped`, `moe_dispatch = "grouped"`): the same
  routing, with a capacity per (example, expert) (`capacity_per_example`)
  and (B, E, C, d) buffers. Every example owns its slots, so the norms
  are block-diagonal (`core.dp_layers.dp_expert_linear_grouped`), about B
  times cheaper. The two drop different tokens on overflow, as in the
  reference.

Every expert is its own clipping group; the router is a plain
`dp_linear`. The Switch-style load-balance auxiliary loss is returned
per example, since DP needs per-example attribution end to end. The same
blocks serve a decode step: without thresholds the expert products are
plain `torch.bmm` / `torch.einsum` (the reference computes them in XLA
too) and every row of the step is routed, inactive ones included, as the
reference routes them.

Two places where torch differs from JAX and the port keeps the
reference's result: `jax.lax.top_k` puts the lower expert index first on
a tie, so the experts come from a stable descending sort and the gate
values from a `gather` on the probabilities (which keeps their gradient);
and the reference's `mode="drop"` scatter of tokens into the buffers
becomes a gather: each slot reads the (token, choice) row routed to it,
or a zero row, through an index built with one scatter whose every index
is distinct (a dropped choice writes to a discarded position of its own).
Every gradient then flows through `index_select`, whose backward adds
into distinct rows (the shared zero row aside, and a dropped choice's
read of slot 0, times a zero gate), and a sum over the k choices in a
fixed order, never through an accumulating `index_put` over duplicates.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import dp_layers as dpl
from repro_torch.core.spec import P, subth
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def moe_spec(cfg: ModelConfig, *, stack: tuple[int, ...] = ()) -> dict:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    s = len(stack)
    out = {
        "router": L.linear_spec(d, e, stack=stack, dtype=cfg.dtype),
        # gate+up fused per expert; each expert = one clipping group
        "w_gu": P(stack + (e, d, 2 * f), dtype=cfg.dtype, stack=s + 1),
        "w_down": P(stack + (e, f, d), dtype=cfg.dtype, stack=s + 1),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        out["shared"] = L.swiglu_spec(d, fs, stack=stack, dtype=cfg.dtype)
    return out


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert: tokens · k · capacity_factor / E, rounded up to
    8, at least 8."""
    c = int(tokens * cfg.num_experts_per_tok * cfg.capacity_factor
            / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


def _slot_sources(flat_slot: torch.Tensor, keep: torch.Tensor,
                  rows: int) -> torch.Tensor:
    """(rows,) int64: for each buffer slot, the index j of the kept
    (token, choice) routed there, or nk (a zero row) for an empty slot.
    Dropped choice j writes to position rows + j, cut off: every index of
    the scatter is distinct."""
    nk = keep.numel()
    j = torch.arange(nk, device=keep.device)
    idx = torch.where(keep, flat_slot, rows + j)
    src = torch.full((rows + nk,), nk, dtype=torch.long, device=keep.device)
    return src.scatter_(0, idx, j)[:rows]


def _expert_linear(w, x, exids, c):
    """(E, C, dout): a DP primitive with thresholds, else the plain
    product (serving)."""
    if c is None:
        return torch.bmm(x, w)
    return dpl.dp_expert_linear(w, x, exids, c)


def _route(cfg: ModelConfig, params, x, th):
    """(probs (..., E) f32, top-k experts (..., k), renormalised gates):
    the router over x (B, T, D), the lower index first on a tie."""
    k = cfg.num_experts_per_tok
    logits = L.linear(params["router"], x, None if th is None
                      else th["router"])  # (B, T, E)
    probs = torch.softmax(logits.float(), dim=-1)
    gate_idx = torch.sort(probs, dim=-1, descending=True,
                          stable=True).indices[..., :k]
    gate_vals = torch.gather(probs, -1, gate_idx)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, -1, keepdim=True), min=1e-9)  # renormalize
    return probs, gate_idx, gate_vals


def _aux_loss(cfg: ModelConfig, probs, gate_idx):
    """Switch-style load-balance loss per example, (B,): probs (B, T, E),
    gate_idx (B, T, k)."""
    e = cfg.num_experts
    frac_prob = torch.mean(probs, dim=1)  # (B, E)
    top1 = F.one_hot(gate_idx[..., 0], e).float()
    frac_tok = torch.mean(top1, dim=1)  # (B, E)
    return cfg.router_aux_coef * e * torch.sum(frac_prob * frac_tok, dim=-1)


def _shared(cfg: ModelConfig, params, x, th):
    sh = None if th is None else subth(th, "shared")
    return L.swiglu(params["shared"], x, sh,
                    f=cfg.moe_d_ff * cfg.num_shared_experts)


def moe_block(cfg: ModelConfig, params, x, th=None):
    """x: (B, T, D) -> (y (B, T, D), aux_loss (B,)).

    th keys: 'router' (B,), 'w_gu' and 'w_down' ((E, B) per expert), and
    'shared/*' when shared experts are configured; None serves (the plain
    forward, as under +inf thresholds)."""
    b, t, d = x.shape
    e, k, f = cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_d_ff
    n = b * t
    cap = capacity(cfg, n)

    def th_of(name):
        return None if th is None else th[name]

    probs, gate_idx, gate_vals = _route(cfg, params, x, th)
    gate_idx, gate_vals = gate_idx.reshape(n, k), gate_vals.reshape(n, k)

    # ---- slot of each (token, choice) within its expert's buffer: the
    # count of earlier choices of the same expert (a scan along the nk
    # choices, laid out as the inner dim) ----
    exp_flat = gate_idx.reshape(-1)  # (n k,)
    onehot_t = F.one_hot(exp_flat, e).T.contiguous()  # (E, n k)
    pos_in_expert = torch.cumsum(onehot_t, dim=1) - onehot_t
    slot_flat = torch.gather(pos_in_expert, 0, exp_flat[None])[0]
    keep = slot_flat < cap

    # ---- dispatch into (E, cap, d), and each slot's example id ----
    src = _slot_sources(exp_flat * cap + slot_flat, keep, e * cap)
    x_rep = x.reshape(n, 1, d).expand(n, k, d).reshape(n * k, d)
    buf = torch.cat([x_rep, x_rep.new_zeros((1, d))]).index_select(
        0, src).reshape(e, cap, d)
    ex_rep = torch.arange(b, device=x.device).repeat_interleave(t * k)
    exid_buf = torch.cat([ex_rep, ex_rep.new_full((1,), -1)])[src].reshape(
        e, cap)

    # ---- expert computation (each expert its own DP group) ----
    h = _expert_linear(params["w_gu"], buf, exid_buf, th_of("w_gu"))
    gate_h, up_h = h[..., :f], h[..., f:]
    act = F.silu(gate_h.float()).to(h.dtype) * up_h
    out_buf = _expert_linear(params["w_down"], act, exid_buf,
                             th_of("w_down"))  # (E, cap, d)

    # ---- combine: gather back and weight by the gates (a dropped choice
    # reads slot 0 of its expert, times 0) ----
    gathered = out_buf.reshape(e * cap, d).index_select(
        0, exp_flat * cap + torch.where(keep, slot_flat, 0))
    gathered = gathered * (keep[:, None] * gate_vals.reshape(-1)[:, None]
                           ).to(gathered.dtype)
    y = torch.sum(gathered.reshape(n, k, d), dim=1)
    y = y.reshape(b, t, d).to(x.dtype)

    if cfg.num_shared_experts:
        y = y + _shared(cfg, params, x, th)
    return y, _aux_loss(cfg, probs, gate_idx.reshape(b, t, k))


def capacity_per_example(cfg: ModelConfig, tokens_per_example: int) -> int:
    """Slots per (example, expert) of the grouped dispatch: T · k ·
    capacity_factor / E, rounded up to 4, at least 4."""
    c = int(tokens_per_example * cfg.num_experts_per_tok
            * cfg.capacity_factor / cfg.num_experts)
    return max(4, -(-c // 4) * 4)


def _expert_linear_grouped(w, x, c):
    """(B, E, C, dout): a DP primitive with thresholds, else the plain
    product (serving)."""
    if c is None:
        return torch.einsum("becd,edf->becf", x, w)
    return dpl.dp_expert_linear_grouped(w, x, c)


def moe_block_grouped(cfg: ModelConfig, params, x, th=None):
    """Grouped dispatch: x (B, T, D) -> (y (B, T, D), aux_loss (B,)).

    The routing of `moe_block`, with the capacity enforced per (example,
    expert) and buffers (B, E, cap, D); th as `moe_block`'s (the experts'
    (E, B) thresholds), None serves."""
    b, t, d = x.shape
    e, k, f = cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_d_ff
    cap = capacity_per_example(cfg, t)

    def th_of(name):
        return None if th is None else th[name]

    probs, gate_idx, gate_vals = _route(cfg, params, x, th)  # (B, T, *)

    # ---- slot of each (token, choice) within its (example, expert)
    # bucket: the count of the example's earlier choices of that expert ----
    exp_flat = gate_idx.reshape(b, t * k)
    onehot = F.one_hot(exp_flat, e).transpose(1, 2)  # (B, E, T k)
    pos_in_expert = torch.cumsum(onehot, dim=2) - onehot
    slot = torch.gather(pos_in_expert, 1, exp_flat[:, None])[:, 0]
    keep = slot < cap  # (B, T k)

    # ---- dispatch into (B, E, cap, d) through one flat index over the
    # examples' buffers ----
    base = (torch.arange(b, device=x.device) * (e * cap))[:, None]
    src = _slot_sources((base + exp_flat * cap + slot).reshape(-1),
                        keep.reshape(-1), b * e * cap)
    x_rep = x.reshape(b * t, 1, d).expand(b * t, k, d).reshape(b * t * k, d)
    buf = torch.cat([x_rep, x_rep.new_zeros((1, d))]).index_select(
        0, src).reshape(b, e, cap, d)

    h = _expert_linear_grouped(params["w_gu"], buf, th_of("w_gu"))
    act = F.silu(h[..., :f].float()).to(h.dtype) * h[..., f:]
    out_buf = _expert_linear_grouped(params["w_down"], act,
                                     th_of("w_down"))  # (B, E, cap, d)

    # ---- combine (a dropped choice reads slot 0 of its bucket, times 0) --
    gathered = out_buf.reshape(b * e * cap, d).index_select(
        0, (base + exp_flat * cap + torch.where(keep, slot, 0)).reshape(-1))
    gathered = gathered * (keep.reshape(-1, 1) * gate_vals.reshape(-1, 1)
                           ).to(gathered.dtype)
    y = torch.sum(gathered.reshape(b, t, k, d), dim=2).to(x.dtype)

    if cfg.num_shared_experts:
        y = y + _shared(cfg, params, x, th)
    return y, _aux_loss(cfg, probs, gate_idx)


def moe_fn(cfg: ModelConfig):
    """The block of the config's dispatch, as the reference picks it."""
    return moe_block_grouped if cfg.moe_dispatch == "grouped" else moe_block
