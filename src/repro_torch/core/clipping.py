"""Clipping-mode drivers: the counterpart of `repro.core.clipping` for the
modes of the training slice.

Every model exposes  loss_fn(params, batch, thresholds) -> (B,)
per-example losses, where `thresholds` is the GroupLayout dict of encoded
per-example threshold vectors consumed by the DP primitives:

  non_private : thresholds +inf, no norms requested; one backward pass;
                standard summed grads.
  per_layer   : the paper's headline (Sec. 3.1). ONE backward pass, one
                `torch.autograd.grad` over the parameter leaves AND the
                threshold leaves: each layer's backward clips with its own
                C_k as the cotangent reaches it, and the norms² come back
                as the thresholds' gradients.

`ghost_flat`, `per_group` and `naive_flat` (ROADMAP A.3) and the BK
execution (A.4) are not ported yet; sharded execution is A.13.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.spec import GroupLayout, tree_leaves

MODES = ("non_private", "per_layer")
_NOT_PORTED = {
    "ghost_flat": "A.3 (and A.4 for its BK execution)",
    "per_group": "A.3 (and A.4 for its BK execution)",
    "naive_flat": "A.3",
    "ghost_flat_twopass": "A.3",
    "per_group_twopass": "A.3",
}

LossFn = Callable[[Any, Any, dict], torch.Tensor]  # -> (B,)


class ClipResult(NamedTuple):
    grads: Any  # tree like params: clipped summed grads (param dtype)
    norms_sq: torch.Tensor  # (K, B) per-group per-example squared norms
    loss: torch.Tensor  # scalar mean per-example loss (pre-clipping)


def check_mode(mode: str) -> None:
    if mode in _NOT_PORTED:
        raise NotImplementedError(
            f"clipping mode {mode!r} is not ported yet: ROADMAP.md item "
            f"{_NOT_PORTED[mode]}")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")


def _rebuild(paths, values) -> dict:
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def dp_clipped_gradients(loss_fn: LossFn, params: Any, batch: Any,
                         layout: GroupLayout, *, mode: str, batch_size: int,
                         thresholds: torch.Tensor | None = None
                         ) -> ClipResult:
    """Clipped summed gradients + norms under `mode`.

    params: the reference-layout tree of leaves with `requires_grad`;
    thresholds: (K,) float32 for per_layer. The norms of non_private are
    zeros (it never computes them)."""
    check_mode(mode)
    paths, leaves = zip(*tree_leaves(params))
    dev = leaves[0].device
    if mode == "non_private":
        th = layout.pack_value(float("inf"), batch_size, device=dev)
        val = torch.sum(loss_fn(params, batch, th))
        grads = torch.autograd.grad(val, leaves)
        norms = torch.zeros((layout.num_groups, batch_size),
                            dtype=torch.float32, device=dev)
        return ClipResult(_rebuild(paths, grads), norms,
                          val.detach() / batch_size)
    if thresholds is None:
        raise ValueError("per_layer mode needs thresholds (K,)")
    th = {k: v.requires_grad_() for k, v in
          layout.pack(thresholds.detach(), batch_size).items()}
    names = list(th)
    val = torch.sum(loss_fn(params, batch, th))
    out = torch.autograd.grad(val, list(leaves) + [th[k] for k in names])
    grads, norm_leaves = out[:len(leaves)], out[len(leaves):]
    norms = layout.unpack(dict(zip(names, norm_leaves)))
    return ClipResult(_rebuild(paths, grads), norms,
                      val.detach() / batch_size)
