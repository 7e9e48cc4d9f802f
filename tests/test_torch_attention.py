"""The port's `attend` on its double-blocked online-softmax branch (T * S
above 2048²) against the JAX package's, on the CPU.

Both packages are forced onto the blocked branch by monkeypatching
`_SINGLE_SHOT_MAX` (and small `_QB` / `_KB`) in the test; nothing in the
reference changes. Cases: ragged T and S (padded to whole blocks), causal
and not, a sliding window whose early KV blocks are fully masked for the
later query blocks, f32 and bf16, T != S with offset positions.

* the forward against the reference's (f32: rtol 1e-5, atol 1e-6; bf16:
  one bf16 rounding step, rtol = atol = 2⁻⁷, since both round the same f32
  result);
* the gradient of q, k and v against `jax.vjp` of the reference (f32,
  rtol 1e-4, atol 1e-5: the backward sums over every block);
* the port's blocked branch against its single-shot branch, at the
  reference test's tolerance (`tests/test_models.py:19-31`: rtol 2e-4,
  atol 2e-5);
* the whole slice at long context: `per_layer` clipped gradients of
  qwen3-4b-reduced with both packages on the blocked branch (the
  tolerances of `test_torch_train.py`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.clipping import dp_clipped_gradients as jax_clip
from repro.kernels import backend as jax_backend
from repro.models import attention as JA
from repro_torch import bridge
from repro_torch.core.clipping import dp_clipped_gradients
from repro_torch.models import attention as A
from test_torch_train import _batch, _j, _models, _t, assert_trees_close

# b, t, s, h, kv, hd, causal, window, qb, kb, query position offset
CASES = {
    "causal_ragged": (2, 300, 300, 4, 2, 16, True, None, 64, 128, 0),
    "window_masked_blocks": (2, 300, 300, 4, 2, 16, True, 40, 64, 128, 0),
    "full_ragged_t_ne_s": (1, 70, 200, 2, 1, 8, False, None, 32, 64, 0),
    "causal_offset_queries": (2, 45, 150, 4, 4, 8, True, 90, 16, 64, 105),
}


def _inputs(case, dtype, seed=0):
    b, t, s, h, kv, hd, causal, window, _, _, off = CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((b, t, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    if dtype == "bfloat16":  # values a bf16 holds exactly
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                   for x in (q, k, v))
    qpos = np.broadcast_to(off + np.arange(t, dtype=np.int32), (b, t)).copy()
    kpos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return q, k, v, qpos, kpos, dict(causal=causal, window=window)


def _force_blocked(monkeypatch, case):
    qb, kb = CASES[case][8:10]
    for mod in (A, JA):
        monkeypatch.setattr(mod, "_SINGLE_SHOT_MAX", 0)
        monkeypatch.setattr(mod, "_QB", qb)
        monkeypatch.setattr(mod, "_KB", kb)


def _port(q, k, v, qpos, kpos, dtype, requires_grad=False, **kw):
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(dt).requires_grad_(requires_grad)
               for x in (q, k, v))
    return (q, k, v), A.attend(q, k, v, torch.from_numpy(qpos),
                               torch.from_numpy(kpos), **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_blocked_attend_matches_reference(case, dtype, monkeypatch):
    _force_blocked(monkeypatch, case)
    q, k, v, qpos, kpos, kw = _inputs(case, dtype)
    jdt = getattr(jnp, dtype)
    want = np.asarray(JA.attend(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                jnp.asarray(qpos), jnp.asarray(kpos), **kw)
                      .astype(jnp.float32))
    _, got = _port(q, k, v, qpos, kpos, dtype, **kw)
    assert got.dtype == getattr(torch, dtype)
    tol = 2.0 ** -7 if dtype == "bfloat16" else None
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=tol or 1e-5, atol=tol or 1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_blocked_attend_gradient_matches_reference_vjp(case, monkeypatch):
    _force_blocked(monkeypatch, case)
    q, k, v, qpos, kpos, kw = _inputs(case, "float32")
    ct = np.random.default_rng(1).standard_normal(
        q.shape[:3] + (v.shape[-1],)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: JA.attend(a, b, c, jnp.asarray(qpos),
                                               jnp.asarray(kpos), **kw),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(ct))
    leaves, out = _port(q, k, v, qpos, kpos, "float32", requires_grad=True,
                        **kw)
    got = torch.autograd.grad(out, leaves, grad_outputs=torch.from_numpy(ct))
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_blocked_matches_single_shot(case, monkeypatch):
    """The port of `tests/test_models.py:19-31` over every case."""
    q, k, v, qpos, kpos, kw = _inputs(case, "float32")
    _, single = _port(q, k, v, qpos, kpos, "float32", **kw)
    _force_blocked(monkeypatch, case)
    _, blocked = _port(q, k, v, qpos, kpos, "float32", **kw)
    np.testing.assert_allclose(blocked.numpy(), single.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_long_context_clipped_gradients_match_reference(monkeypatch):
    """per_layer through every layer's blocked attention (T = 40 in query
    blocks of 16 and KV blocks of 32, so T pads to 48 and 64)."""
    for mod in (A, JA):
        monkeypatch.setattr(mod, "_SINGLE_SHOT_MAX", 0)
        monkeypatch.setattr(mod, "_QB", 16)
        monkeypatch.setattr(mod, "_KB", 32)
    m, jm = _models("qwen3-4b", reduced=True)
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size, b=2, t=40, seed=4)
    thr = np.random.default_rng(2).uniform(
        0.05, 2.0, m.layout.num_groups).astype(np.float32)
    with jax_backend.scoped("xla"):
        want = jax.jit(functools.partial(
            jax_clip, jm.loss_fn, layout=jm.layout, mode="per_layer",
            batch_size=2))(_j(tree), _j(batch), thresholds=jnp.asarray(thr))
    got = dp_clipped_gradients(
        m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"), _t(batch),
        m.layout, mode="per_layer", batch_size=2,
        thresholds=torch.from_numpy(thr))
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-6)
    np.testing.assert_allclose(got.norms_sq.numpy(), np.asarray(want.norms_sq),
                               rtol=1e-5, atol=1e-9)
    assert_trees_close(got.grads, want.grads)
