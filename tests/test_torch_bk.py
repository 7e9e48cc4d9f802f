"""The port's book-keeping (BK) execution and the flat and group clipping
modes against the JAX package, on the CPU in f32.

* `scale_contract_ref` against the reference's Pallas kernel (interpret
  mode) and its plain version; `Backend.scale_contract` of both engines;
* `capture_clipped` (loss, (K, B) norms², every residual sink) on tiny and
  qwen3-4b-reduced against the reference's with the xla backend;
* `dp_clipped_gradients` for ghost_flat and per_group in both executions
  against the reference, and bk against twopass inside the port;
* the two twopass fallbacks and their warning; remat on and off;
* the engine's route counts under each execution;
* `group_shard_assignment` and `build_plan` against the reference.

Tolerances: float32, the same math summed in another order: rtol 1e-5
and an atol of 1e-5 of the largest magnitude (the helpers of
`test_torch_train`); the kernel comparisons use the reference test's own
rtol 2e-5, atol 1e-4 (`tests/test_bk.py`).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import bk as JBK
from repro.core import dp_sgd as JDP
from repro.core.clipping import dp_clipped_gradients as jax_clip
from repro.core.spec import _walk as jax_walk
from repro.kernels import backend as jax_backend
from repro.kernels.bk import scale_contract as jax_scale_contract
from repro.kernels.ref import scale_contract_ref as jax_scale_contract_ref
from repro.launch import sharding as JSH
from repro.models.transformer import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import bk, dp_layers, dp_sgd
from repro_torch.core.clipping import dp_clipped_gradients
from repro_torch.core.spec import GroupLayout, P, _walk
from repro_torch.kernels import backend
from repro_torch.kernels import bk as K
from repro_torch.launch import sharding
from repro_torch.models.transformer import build_model
from test_torch_train import B, _batch, _j, _leaves, _t, assert_trees_close

KERNEL_SHAPES = [(2, 4, 300, 65, 130), (1, 3, 17, 8, 5),
                 (3, 2, 256, 130, 64)]  # tests/test_bk.py:154-156


def _asf(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_scale_contract_ref_matches_reference_kernel(shape, stacked):
    s, b, t, di, do = shape
    rng = np.random.default_rng(di)
    a, g = _asf(rng, s, b, t, di), _asf(rng, s, b, t, do)
    f = rng.uniform(size=(s, b)).astype(np.float32)
    if not stacked:  # the 3-D form
        a, g, f = a[0], g[0], f[0]
    got = K.scale_contract_ref(*(torch.from_numpy(x) for x in (a, g, f)))
    for want in (jax_scale_contract(a, g, f, interpret=True),
                 jax_scale_contract_ref(a, g, f)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("engine", ["plain", "kernels"])
def test_backend_scale_contract_on_cpu(engine):
    rng = np.random.default_rng(7)
    a, g = (torch.from_numpy(_asf(rng, 2, 3, 40, d)) for d in (20, 9))
    f = torch.from_numpy(rng.uniform(size=(2, 3)).astype(np.float32))
    before = K.launches
    with backend.scoped(engine):
        got = backend.active().scale_contract(a, g, f)
        got3 = backend.active().scale_contract(a[0], g[0], f[0])
    assert K.launches == before  # CPU tensors: the plain version
    want = K.scale_contract_ref(a, g, f)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-4)
    torch.testing.assert_close(got3, want[0], rtol=2e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# Capture and the clipping modes against the reference.
# ---------------------------------------------------------------------------

ARCHS = [("tiny", False), ("qwen3-4b", True)]


def _setup(arch, reduced, seed=0):
    m = build_model(get_config(arch, reduced=reduced), device="cpu")
    jm = jax_build_model(jax_get_config(arch, reduced=reduced))
    tree = bridge.numpy_params(m.spec, seed=seed)
    return m, jm, tree, _batch(m.cfg.vocab_size)


@pytest.mark.parametrize("arch,reduced", ARCHS)
def test_capture_matches_reference(arch, reduced):
    m, jm, tree, batch = _setup(arch, reduced)
    with jax_backend.scoped("xla"):
        jval, jnorms, jres, jrec = JBK.capture_clipped(
            jm.loss_fn, _j(tree), _j(batch), jm.layout, B)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no fallback
        val, norms, res, rec = bk.capture_clipped(
            m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"),
            _t(batch), m.layout, B)
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-6)
    np.testing.assert_allclose(norms.numpy(), np.asarray(jnorms), rtol=1e-5,
                               atol=1e-9)
    assert set(rec) == set(jrec) == set(res) == set(jres)
    for name in rec:
        assert rec[name].kind == jrec[name].kind and rec[name].count == 1
        assert set(res[name]) == set(jres[name])
        for k, v in res[name].items():
            w = np.asarray(jres[name][k], np.float32)
            assert tuple(v.shape) == w.shape, (name, k)
            np.testing.assert_allclose(
                v.float().numpy(), w, rtol=1e-5,
                atol=1e-5 * max(float(np.abs(w).max()), 1e-30),
                err_msg=f"{name}/{k}")


def _assignment(layout, n=2):
    return tuple(i % n for i in range(layout.num_groups))


def _clip_kwargs(mode, layout, rng):
    if mode.startswith("ghost_flat"):
        return {"flat_threshold": np.float32(rng.uniform(0.2, 1.0))}
    return {"group_assignment": np.asarray(_assignment(layout), np.int32),
            "group_thresholds": rng.uniform(0.1, 1.0, 2).astype(np.float32)}


@pytest.mark.parametrize("mode", ["ghost_flat", "per_group"])
@pytest.mark.parametrize("arch,reduced", ARCHS)
def test_clipped_gradients_match_reference_in_both_executions(arch, reduced,
                                                              mode):
    m, jm, tree, batch = _setup(arch, reduced)
    kw = _clip_kwargs(mode, m.layout, np.random.default_rng(3))
    with jax_backend.scoped("xla"):
        want = jax_clip(jm.loss_fn, _j(tree), _j(batch), jm.layout,
                        mode=mode, batch_size=B, execution="bk",
                        **{k: jnp.asarray(v) for k, v in kw.items()})
    tkw = {k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()}
    got = {}
    for execution in ("bk", "twopass"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got[execution] = dp_clipped_gradients(
                m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"),
                _t(batch), m.layout, mode=mode, batch_size=B,
                execution=execution, **tkw)
        r = got[execution]
        np.testing.assert_allclose(float(r.loss), float(want.loss),
                                   rtol=1e-6)
        np.testing.assert_allclose(r.norms_sq.numpy(),
                                   np.asarray(want.norms_sq), rtol=1e-5,
                                   atol=1e-9)
        assert_trees_close(r.grads, want.grads)
    # bk == twopass inside the port (the same sums in another order)
    torch.testing.assert_close(got["bk"].norms_sq, got["twopass"].norms_sq,
                               rtol=1e-6, atol=0)
    for (name, x), (_, y) in zip(_leaves(got["bk"].grads),
                                 _leaves(got["twopass"].grads)):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-7, msg=name)


def test_twopass_mode_names_force_twopass(monkeypatch):
    m, _, tree, batch = _setup("tiny", False)

    def no_capture(*a, **k):
        raise AssertionError("a *_twopass mode ran the BK capture")

    monkeypatch.setattr(bk, "capture_clipped", no_capture)
    kw = _clip_kwargs("per_group", m.layout, np.random.default_rng(0))
    r = dp_clipped_gradients(
        m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"), _t(batch),
        m.layout, mode="per_group_twopass", batch_size=B, execution="bk",
        **{k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()})
    assert r.norms_sq.shape == (m.layout.num_groups, B)


def test_remat_gives_the_same_route_and_gradients():
    """Under activation checkpointing the forward runs again in backward;
    the recorder must not count a group twice (no fallback) and the sinks
    must be written once."""
    cfg = get_config("qwen3-4b", reduced=True)
    tree = bridge.numpy_params(build_model(cfg, device="cpu").spec, seed=0)
    out = {}
    for remat in (True, False):
        m = build_model(dataclasses.replace(cfg, remat=remat), device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            out[remat] = dp_clipped_gradients(
                m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"),
                _t(_batch(cfg.vocab_size)), m.layout, mode="ghost_flat",
                batch_size=B, flat_threshold=0.5)
    torch.testing.assert_close(out[True].norms_sq, out[False].norms_sq,
                               rtol=1e-6, atol=0)
    for (name, a), (_, b) in zip(_leaves(out[True].grads),
                                 _leaves(out[False].grads)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=name)


# ---------------------------------------------------------------------------
# Fallbacks and the capture scope.
# ---------------------------------------------------------------------------


def _toy(mult=1.0):
    """A two-linear model: x -> lin1 -> lin2 -> sum of squares."""
    spec = {"lin1": {"w": P((5, 4), sensitivity_mult=mult)},
            "lin2": {"w": P((4, 3)), "b": P((3,), init="zeros")}}
    rng = np.random.default_rng(5)
    params = {"lin1": {"w": torch.from_numpy(_asf(rng, 5, 4))},
              "lin2": {"w": torch.from_numpy(_asf(rng, 4, 3)),
                       "b": torch.from_numpy(_asf(rng, 3))}}
    for leaf in (params["lin1"]["w"], params["lin2"]["w"],
                 params["lin2"]["b"]):
        leaf.requires_grad_()
    x = torch.from_numpy(_asf(rng, 3, 6, 5))
    return spec, GroupLayout(spec), params, x


def _toy_loss(params, x, th, twice=False):
    h = dp_layers.dp_linear(params["lin1"]["w"], None, x, th["lin1"])
    if twice:  # the same group consumed at a second call site
        h = h + dp_layers.dp_linear(params["lin1"]["w"], None, x, th["lin1"])
    y = dp_layers.dp_linear(params["lin2"]["w"], params["lin2"]["b"], h,
                            th["lin2"])
    return torch.sum(y * y, dim=(1, 2))


@pytest.mark.parametrize("case", ["reused_group", "sensitivity_mult"])
def test_fallback_to_twopass_warns_and_matches_it(case):
    spec, layout, params, x = _toy(2.0 if case == "sensitivity_mult" else 1)
    twice = case == "reused_group"

    def loss(p, batch, th):
        return _toy_loss(p, batch, th, twice)

    kw = dict(mode="ghost_flat", batch_size=3, flat_threshold=0.7)
    with pytest.warns(UserWarning, match="falling back to the twopass"):
        got = dp_clipped_gradients(loss, params, x, layout, execution="bk",
                                   **kw)
    want = dp_clipped_gradients(loss, params, x, layout, execution="twopass",
                                **kw)
    torch.testing.assert_close(got.norms_sq, want.norms_sq)
    for (name, a), (_, b) in zip(_leaves(got.grads), _leaves(want.grads)):
        torch.testing.assert_close(a, b, msg=name)


def test_toy_bias_and_unused_group_match_reference():
    """A linear's bias rides its weight's group; a group the loss never
    consumes gets zero norms and zero gradients, as in the reference."""
    from repro.core import dp_layers as JDL
    from repro.core.spec import GroupLayout as JGroupLayout
    from repro.core.spec import P as JP
    spec, layout, params, x = _toy()
    spec["unused"] = {"w": P((2, 2))}
    layout = GroupLayout(spec)
    params["unused"] = {"w": torch.ones(2, 2, requires_grad=True)}
    jspec = {"lin1": {"w": JP((5, 4))},
             "lin2": {"w": JP((4, 3)), "b": JP((3,), init="zeros")},
             "unused": {"w": JP((2, 2))}}

    def jloss(p, xx, th):
        h = JDL.dp_linear(p["lin1"]["w"], None, xx, th["lin1"])
        y = JDL.dp_linear(p["lin2"]["w"], p["lin2"]["b"], h, th["lin2"])
        return jnp.sum(y * y, axis=(1, 2))

    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.detach().numpy()),
                                params)
    with jax_backend.scoped("xla"):
        want = jax_clip(jloss, jp, jnp.asarray(x.numpy()),
                        JGroupLayout(jspec), mode="ghost_flat", batch_size=3,
                        flat_threshold=0.7)
    for execution in ("bk", "twopass"):
        got = dp_clipped_gradients(_toy_loss, params, x, layout,
                                   mode="ghost_flat", batch_size=3,
                                   flat_threshold=0.7, execution=execution)
        np.testing.assert_allclose(got.norms_sq.numpy(),
                                   np.asarray(want.norms_sq), rtol=1e-5)
        assert_trees_close(got.grads, want.grads)
        assert not got.grads["unused"]["w"].any()


def test_channel_outside_the_capture_scope_is_refused():
    spec, layout, params, x = _toy()
    ch = bk.build_channels(layout, 3)
    with pytest.raises(RuntimeError, match="capture_residuals"):
        y = _toy_loss(params, x, ch).sum()
        torch.autograd.grad(y, [c.c for c in ch.values()])


# ---------------------------------------------------------------------------
# Route counts on the engine.
# ---------------------------------------------------------------------------


def _spy(monkeypatch):
    log = []
    for name in ("linear_norms_sq", "clipped_sum_linear", "scale_contract"):
        orig = getattr(backend.KernelsBackend, name)

        def wrapped(self, *a, _orig=orig, _name=name, **k):
            log.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(backend.KernelsBackend, name, wrapped)
    return log


@pytest.mark.parametrize("execution", ["bk", "twopass"])
def test_engine_route_counts(execution, monkeypatch):
    """BK: one norm per linear, no clipped_sum_linear, one scale_contract
    per linear weight leaf. twopass: pass 1 reads every norm and
    contracts nothing; pass 2 contracts every linear and reads no norm."""
    m, _, tree, batch = _setup("qwen3-4b", True)
    log = _spy(monkeypatch)
    linears = 4 * m.cfg.num_layers + 1
    with backend.scoped("kernels"):
        dp_clipped_gradients(
            m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"),
            _t(batch), m.layout, mode="ghost_flat", batch_size=B,
            flat_threshold=0.5, execution=execution)
    if execution == "bk":
        assert log == ["linear_norms_sq"] * linears + ["scale_contract"] * 5
    else:
        assert log == (["linear_norms_sq"] * linears
                       + ["clipped_sum_linear"] * linears)


# ---------------------------------------------------------------------------
# Ownership and the plan against the reference.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model_size", [2, 3, 4])
@pytest.mark.parametrize("arch,reduced", ARCHS + [("qwen3-4b", False)])
def test_group_shard_assignment_matches_reference(arch, reduced,
                                                  model_size):
    # full qwen3-4b: both layouts come from the spec, nothing is allocated
    m = build_model(get_config(arch, reduced=reduced), device="cpu")
    jm = jax_build_model(jax_get_config(arch, reduced=reduced))
    got = sharding.group_shard_assignment(m.layout, model_size)
    assert got == JSH.group_shard_assignment(jm.layout, model_size)
    assert len(got) == m.layout.num_groups and set(got) <= set(
        range(model_size))
    jspecs = {"/".join(p): n for p, n in jax_walk(jm.spec)}
    for path, p in _walk(m.spec):
        name = "/".join(path)
        assert sharding._spec_for(name, p, model_size) == tuple(
            JSH._spec_for(name, jspecs[name], model_size)), name


@pytest.mark.parametrize("mode", ["ghost_flat", "per_group",
                                  "per_group_twopass"])
@pytest.mark.parametrize("adaptive", [True, False])
def test_build_plan_matches_reference(mode, adaptive):
    m = build_model(get_config("qwen3-4b", reduced=True), device="cpu")
    jm = jax_build_model(jax_get_config("qwen3-4b", reduced=True))
    assign = sharding.group_shard_assignment(m.layout, 3)
    kw = dict(mode=mode, epsilon=3.0, sampling_rate=0.02, steps=50,
              adaptive=adaptive, group_assignment=assign,
              num_supergroups=4 if mode == "per_group" else None)
    got = dp_sgd.build_plan(dp_sgd.DPConfig(**kw), m.layout)
    want = JDP.build_plan(JDP.DPConfig(**kw), jm.layout)
    assert got.num_noise_groups == want.num_noise_groups
    assert (got.sigma, got.sigma_b, got.sigma_new) == (
        want.sigma, want.sigma_b, want.sigma_new)
    np.testing.assert_array_equal(got.group_dims, want.group_dims)
    np.testing.assert_array_equal(got.sens_mults, want.sens_mults)
    with pytest.raises(ValueError, match="group_assignment"):
        dp_sgd.build_plan(dp_sgd.DPConfig(mode="per_group"), m.layout)
