"""Move parameter trees and decode caches into the port through numpy.

A tree from the JAX package, with its leaves converted to numpy and keyed
by spec path, becomes the port's parameters on `device`: for training in
the same stacked layout, for serving with the stacked `dense_blocks/*`
(and `moe_blocks/*`) leaves split along the stack axis into the per-layer
blocks (`models.transformer.unstack_blocks`). `cache_from_numpy` does the
same for a paged decode cache, so both packages can start from one pool
state. bfloat16 leaves (numpy's `ml_dtypes` bfloat16) cross bit for bit.

A blocked (per-shard) model crosses like any other: blocks split only the
clipping groups, so its weights keep their (L, din, dout) shape, and its
(K,) thresholds and (K, B) norms² follow `GroupLayout`'s order, which is
the reference's. So does an MoE model: its expert leaves
(`moe_blocks/moe/w_gu`, `w_down`) keep their (L, E, din, dout) shape, one
clipping group per (layer, expert). An MLA model's attention leaves
(`kv_a`, `kv_norm`, `kv_b`, `q_a`, `q_norm`, `q_b`, `o`) and the unstacked
`mtp` subtree cross by path like any other; its decode cache holds one
`<stack>_latpool` per layer stack in place of the k/v pools. A QKV bias
(qwen1.5-32b) crosses as `.../attn/qkv/b`, and a contiguous decode cache
(`<stack>_k` / `_v`, or MLA's `_ckv` / `_krope`, and `pos`) crosses as a
paged one does. Whisper's encoder-decoder crosses the same way: its
`enc_blocks` and `dec_blocks` stacks (the cross-attention's
`dec_blocks/cross/{qkv,kv,o}` and `cross_norm` among them) split per
layer for serving, its `enc_norm` as any leaf, and its decode cache's
`dec_k` / `dec_v` / `cross_k` / `cross_v` and `pos` by key.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import spec as S
from repro_torch.models.transformer import unstack_blocks


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(tree, device, requires_grad=False):
    if isinstance(tree, dict):
        return {k: _tree(v, device, requires_grad) for k, v in tree.items()}
    return tensor_from_numpy(tree, device).requires_grad_(requires_grad)


def params_from_numpy(tree: dict, device: str | torch.device) -> Any:
    """Reference-shaped numpy parameter tree -> the port's serving
    parameters (per-layer blocks)."""
    return unstack_blocks(_tree(tree, torch.device(device)))


def train_params_from_numpy(tree: dict, device: str | torch.device) -> Any:
    """Reference-shaped numpy parameter tree -> the port's training
    parameters: the same stacked layout, every leaf requiring grad."""
    return _tree(tree, torch.device(device), requires_grad=True)


def cache_from_numpy(cache: dict, device: str | torch.device) -> dict:
    """Numpy decode cache in the reference's layout (paged: `pos`, `pt`,
    and `*_kpool` / `*_vpool` or `*_latpool` per layer stack; contiguous:
    `pos` and `*_k` / `*_v` or `*_ckv` / `*_krope`) -> the port's cache on
    `device`."""
    return _tree(cache, torch.device(device))


def numpy_params(spec: dict, seed: int) -> dict:
    """A float32 numpy parameter tree drawn from `spec`'s distributions
    with numpy's generator: the same parameters for any device or
    package."""
    rng = np.random.default_rng(seed)
    out: dict = {}
    for path, p in S._walk(spec):
        if p.init == "zeros":
            a = np.zeros(p.shape, np.float32)
        elif p.init == "ones":
            a = np.ones(p.shape, np.float32)
        elif p.init in ("normal", "embed"):
            if p.init == "embed":
                std = p.scale if p.scale is not None else 0.02
            else:
                fan_in = (p.shape[p.fan_in_axis] if len(p.shape) >= 2
                          else max(p.shape[-1], 1))
                std = (p.scale if p.scale is not None
                       else 1.0 / np.sqrt(fan_in))
            a = (std * rng.standard_normal(p.shape)).astype(np.float32)
        elif p.init == "uniform":
            r = p.scale if p.scale is not None else 0.02
            a = rng.uniform(-r, r, p.shape).astype(np.float32)
        else:
            raise ValueError(f"numpy_params: init {p.init!r} not supported")
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = a
    return out
