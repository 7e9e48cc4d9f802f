"""The port's `naive_flat` clipping (the materialising oracle) against
the JAX package's `jax.jacrev` oracle, on the CPU in f32.

* `dp_clipped_gradients(mode="naive_flat")` on tiny, qwen3-4b-reduced,
  granite-moe-3b-a800m-reduced (the MoE dispatch couples the examples of
  the one forward) and tiny with qwen-style blocked projections
  (dp_blocks = 4): loss, (K, B) norms² (stacked rows, and the blocked
  rows after the stack) and every clipped leaf;
* inside the port: naive_flat's norms against ghost_flat's (the port of
  `tests/test_bk.py:223`), naive_flat ≡ ghost_flat by both executions
  (`tests/test_dp_layers.py:89`), at the reference tests' own tolerance
  (rtol 2e-3, atol 1e-6);
* the kernel calls: one `clip_reduce` per linear and example (the
  primitives' no-norm backward, factor 1), no norm kernel;
* `trainable_key` (DP-LoRA): naive_flat over tiny's adapters against the
  reference's jacrev oracle of the subtree; the sharded driver refuses
  naive_flat with it as without (a single-device oracle in both
  packages).

Tolerances against the reference: float32, the same math summed in
another order (`assert_trees_close`: rtol 1e-5, atol 1e-5 of the leaf's
largest magnitude; norms rtol 1e-5, atol 1e-9; loss rtol 1e-6).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.clipping import dp_clipped_gradients as jax_clip
from repro.kernels import backend as jax_backend
from repro.models.transformer import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.clipping import dp_clipped_gradients
from repro_torch.kernels import backend
from repro_torch.kernels import clip_reduce as CR
from repro_torch.kernels import fused_clip as FC
from repro_torch.kernels import ghost_norm as GN
from repro_torch.models.transformer import build_model
from test_torch_train import B, _batch, _j, _leaves, _t, assert_trees_close

# (arch, reduced, config change); the per-example total norms of these
# inputs straddle C = 30, so some examples are clipped and some not
CONFIGS = {"tiny": ("tiny", False, {}),
           "qwen3-4b-reduced": ("qwen3-4b", True, {}),
           "granite-reduced": ("granite-moe-3b-a800m", True, {}),
           "tiny-blocked": ("tiny", False, {"dp_blocks": 4})}
C = 30.0


def _models(arch, reduced, change):
    return (build_model(dataclasses.replace(
                get_config(arch, reduced=reduced), **change), device="cpu"),
            jax_build_model(dataclasses.replace(
                jax_get_config(arch, reduced=reduced), **change)))


def _naive(m, tree, batch, c=C, **kw):
    return dp_clipped_gradients(
        m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"), _t(batch),
        m.layout, mode="naive_flat", batch_size=B, flat_threshold=c, **kw)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_naive_flat_matches_reference(name):
    m, jm = _models(*CONFIGS[name])
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size)
    with jax_backend.scoped("xla"):
        want = jax.jit(functools.partial(
            jax_clip, jm.loss_fn, layout=jm.layout, mode="naive_flat",
            batch_size=B, flat_threshold=C))(_j(tree), _j(batch))
    got = _naive(m, tree, batch)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-6)
    assert got.norms_sq.shape == (m.layout.num_groups, B)
    np.testing.assert_allclose(got.norms_sq.numpy(), np.asarray(want.norms_sq),
                               rtol=1e-5, atol=1e-9)
    assert_trees_close(got.grads, want.grads)
    for _, g in _leaves(got.grads):
        assert g.dtype == torch.float32
    total = got.norms_sq.sum(0).numpy()
    assert (total > C * C).any() and (total < C * C).any()
    if m.cfg.dp_blocks > 1:  # one row per (layer, column block)
        grp = m.layout.group("dense_blocks/attn/qkv")
        assert grp.stack_shape == (m.cfg.num_layers, 4)


@pytest.mark.parametrize("name", ["tiny", "tiny-blocked"])
def test_naive_flat_reports_per_group_norms(name):
    """The port of `tests/test_bk.py:223`: naive_flat's (K, B) norms are
    the ghost norms of the other modes (ghost_flat by two passes here;
    BK over a blocked layout is held to the reference's BK in
    `tests/test_torch_blocked.py`)."""
    m, _ = _models(*CONFIGS[name])
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size)
    naive = _naive(m, tree, batch, c=0.5)
    ghost = dp_clipped_gradients(
        m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"), _t(batch),
        m.layout, mode="ghost_flat", batch_size=B, flat_threshold=0.5,
        execution="twopass")
    assert naive.norms_sq.shape == (m.layout.num_groups, B)
    np.testing.assert_allclose(naive.norms_sq.numpy(), ghost.norms_sq.numpy(),
                               rtol=2e-3, atol=1e-6)


@pytest.mark.parametrize("execution", ["bk", "twopass"])
def test_ghost_flat_equals_naive_flat(execution):
    """The port of `tests/test_dp_layers.py:89`, on qwen3-4b-reduced with
    every example clipped (C = 0.05)."""
    m, _ = _models(*CONFIGS["qwen3-4b-reduced"])
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size)
    naive = _naive(m, tree, batch, c=0.05)
    ghost = dp_clipped_gradients(
        m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"), _t(batch),
        m.layout, mode="ghost_flat", batch_size=B, flat_threshold=0.05,
        execution=execution)
    np.testing.assert_allclose(float(naive.loss), float(ghost.loss),
                               rtol=1e-6)
    for (name, a), (_, b) in zip(_leaves(ghost.grads), _leaves(naive.grads)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=1e-6, err_msg=name)


def test_naive_flat_kernel_calls(monkeypatch):
    """One clip_reduce per linear and example (each example's backward
    runs the no-norm path with factor 1), no norm kernel, no fused call:
    on qwen3-4b at B = 8 that is 145 x 8 = 1,160 a step."""
    calls = dict.fromkeys(("ghost_norm", "clip_reduce", "fused_norm_clip"),
                          0)
    for mod, name in ((GN, "ghost_norm"), (CR, "clip_reduce"),
                      (FC, "fused_norm_clip")):
        def counting(*a, _name=name, _fn=getattr(mod, name), **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counting)
    m, _ = _models(*CONFIGS["qwen3-4b-reduced"])
    tree = bridge.numpy_params(m.spec, seed=0)
    with backend.scoped("kernels"):
        res = _naive(m, tree, _batch(m.cfg.vocab_size))
    linears = 4 * m.cfg.num_layers + 1
    assert calls == {"ghost_norm": 0, "clip_reduce": linears * B,
                     "fused_norm_clip": 0}
    assert np.isfinite(float(res.loss))


def test_naive_flat_trains_lora_and_the_sharded_driver_refuses_it():
    """naive_flat trains the adapters alone on one device (the reference's
    jacrev over the subtree); the sharded driver refuses it with
    `trainable_key` as without, naive_flat being a single-device oracle
    in both packages."""
    from repro_torch.core.clipping import sharded_clipped_gradients
    from repro_torch.launch.mesh import Mesh
    m, jm = _models("tiny", False, {"lora_rank": 4})
    tree = bridge.numpy_params(m.spec, seed=0)
    rng = np.random.default_rng(1)
    for pair in tree["lora"]["dense_blocks"].values():
        pair["b"] = (0.05 * rng.standard_normal(pair["b"].shape)).astype(
            np.float32)
    batch = _batch(m.cfg.vocab_size)
    with jax_backend.scoped("xla"):
        want = jax.jit(functools.partial(
            jax_clip, jm.loss_fn, layout=jm.layout, mode="naive_flat",
            batch_size=B, flat_threshold=0.5, trainable_key="lora"))(
            _j(tree), _j(batch))
    got = _naive(m, tree, batch, c=0.5, trainable_key="lora")
    assert set(got.grads) == {"lora"}
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-6)
    np.testing.assert_allclose(got.norms_sq.numpy(), np.asarray(want.norms_sq),
                               rtol=1e-5, atol=1e-9)
    assert_trees_close(got.grads, want.grads)
    with pytest.raises(ValueError, match="naive_flat is a single-device "
                                         "oracle"):
        sharded_clipped_gradients(
            m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"),
            _t(batch), m.layout, mode="naive_flat", batch_size=B,
            data_size=1, trainable_key="lora",
            mesh=Mesh({"data": 1, "model": 1}, device="cpu",
                      backend="gloo"))
