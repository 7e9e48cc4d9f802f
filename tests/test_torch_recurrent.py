"""The port's recurrent and hybrid families against the JAX package, on
the CPU in f32 (rwkv6-7b-reduced: 2 RWKV-6 layers; zamba2-7b-reduced: 4
Mamba2 layers and one shared attention block at 2 sites).

* the blocks (`mamba2_block`, `time_mix` in both formulations,
  `channel_mix`) and the decode steps against the reference's;
* `_ssd_chunked` against the reference at chunks 8 and 32; at chunk 256
  and T = 256 (zamba2's own chunk) against a float64 recurrence, with the
  reference's gradients non-finite there and the port's finite (the
  masked exponent, ROADMAP C);
* `_wkv_scan` against the reference; `_wkv_chunked` against the
  reference's at its own test's decays, and against the scan at the
  decays `w_base`'s init gives, chunk 128, where the reference's misses
  (the exact sub-block form, ROADMAP C);
* `dp_broadcast` / `dp_shift`: norms² and clipped sums against the
  reference's primitives, and their BK recipes against twopass and the
  reference's BK;
* both models: the layouts (reduced and full size), per_layer /
  non_private / ghost_flat clipped gradients, two noised per_layer steps
  with the reference's draws, rwkv6's BK against twopass and the
  reference, zamba2's BK fallback (the shared block's sensitivity_mult >
  1: a warning, then twopass), the kernel calls a step and the train
  CLI;
* on a Hopper card (`-m cuda`; skipped elsewhere): ghost_norm and
  clip_reduce at the new linear shapes against their plain versions.

Tolerances: rtol 1e-5 / atol 1e-6 of the largest magnitude (at least
1e-6) for the blocks and decode steps (f32, another summation order);
the chunked forms against a sequential evaluation within 1e-4 of the
largest output magnitude; clipped
gradients rtol 1e-5 and an atol of 1e-5 of the leaf's largest magnitude
(1e-4 after a full step), as `test_torch_train`.
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_config as jax_get_config
from repro.core import bk as JBK
from repro.core import dp_layers as JDPL
from repro.core import dp_sgd as JSGD
from repro.core.clipping import dp_clipped_gradients as jax_clip
from repro.core.spec import GroupLayout as JLayout
from repro.core.spec import P as JP
from repro.kernels import backend as jax_backend
from repro.models import mamba2 as JM2
from repro.models import rwkv6 as JR6
from repro.models.transformer import build_model as jax_build_model
from repro_torch import bridge, optim
from repro_torch.configs import get_config
from repro_torch.core import dp_layers as DPL
from repro_torch.core import dp_sgd
from repro_torch.core import quantile as Q
from repro_torch.core.clipping import dp_clipped_gradients
from repro_torch.core.spec import GroupLayout, P
from repro_torch.kernels import clip_reduce as CR
from repro_torch.kernels import ghost_norm as GN
from repro_torch.launch import train
from repro_torch.models import mamba2 as M2
from repro_torch.models import rwkv6 as R6
from repro_torch.models.transformer import build_model
from test_torch_moe import _reference_draws
from test_torch_train import (B, _batch, _count_calls, _j, _leaves, _t,
                              assert_trees_close)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small torch ops (the
    recurrences step a token at a time): beside the other test workers,
    a thread per core makes them spin several times slower. Every
    comparison here is between runs under the same setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T = torch.from_numpy
ARCHS = ["rwkv6-7b", "zamba2-7b"]
FALLBACK = "falling back to the twopass"
BLOCK_TOL = dict(rtol=1e-5, atol=1e-6)


def _models(arch, reduced=True):
    return (build_model(get_config(arch, reduced=reduced), device="cpu"),
            jax_build_model(jax_get_config(arch, reduced=reduced)))


def _layer0(tree):
    """Layer 0's slice of a stacked numpy subtree."""
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


def _inf(names, b):
    return {k: jnp.full((b,), jnp.inf) for k in names}


def _x(d, b=2, t=11, seed=3, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        (b, t, d))).astype(np.float32)


def _close(got, want, **tol):
    """BLOCK_TOL unless given: rtol 1e-5, atol 1e-6 of the reference's
    largest magnitude (at least 1e-6)."""
    want = np.asarray(want)
    if not tol:
        tol = dict(rtol=BLOCK_TOL["rtol"], atol=BLOCK_TOL["atol"] * max(
            1.0, float(np.abs(want).max())))
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        want, **tol)


# ---------------------------------------------------------------------------
# Blocks and decode steps.
# ---------------------------------------------------------------------------


def test_mamba2_block_and_decode_match_reference():
    """zamba2-reduced's layer 0 (T = 11 in 32-step chunks), then two
    decode steps from its state; the plain forward against the
    reference's at +inf thresholds."""
    m, _ = _models("zamba2-7b")
    cfg, jcfg = m.cfg, jax_get_config("zamba2-7b", reduced=True)
    p = _layer0(bridge.numpy_params(m.spec, seed=0)["backbone"]["m"])
    tp = bridge.params_from_numpy(p, "cpu")
    names = ["in_proj", "conv_w", "dt_bias", "a_log", "d_skip", "norm",
             "out_proj"]
    x = _x(cfg.d_model)
    want = jax.jit(functools.partial(JM2.mamba2_block, jcfg))(
        _j(p), jnp.asarray(x), _inf(names, 2))
    _close(M2.mamba2_block(cfg, tp, T(x)), want)
    d_in, nh, n, hp = M2.dims(cfg)
    rng = np.random.default_rng(5)
    conv = rng.standard_normal((2, cfg.ssm_conv_kernel - 1,
                                d_in + 2 * n)).astype(np.float32)
    ssm = rng.standard_normal((2, nh, hp, n)).astype(np.float32)
    jconv, jssm, tconv, tssm = conv, ssm, T(conv), T(ssm)
    jdecode = jax.jit(functools.partial(JM2.mamba2_decode, jcfg))
    for step in range(2):
        xt = _x(cfg.d_model, t=1, seed=10 + step)
        jy, jconv, jssm = jdecode(_j(p), jnp.asarray(xt), _inf(names, 2),
                                  jconv, jssm)
        ty, tconv, tssm = M2.mamba2_decode(cfg, tp, T(xt), tconv, tssm)
        for got, want in ((ty, jy), (tconv, jconv), (tssm, jssm)):
            _close(got, want)


@pytest.mark.parametrize("formulation", ["scan", "chunked"])
def test_rwkv6_time_and_channel_mix_match_reference(formulation):
    """rwkv6-reduced's layer 0 from a non-zero state and token shift, in
    the scan form and the chunked one (chunk 4 over T = 11, a ragged last
    chunk), at decays the reference's chunked form takes exactly; then a
    decode step of each mix."""
    m, _ = _models("rwkv6-7b")
    cfg, jcfg = m.cfg, jax_get_config("rwkv6-7b", reduced=True)
    tree = _layer0(bridge.numpy_params(m.spec, seed=0)["blocks"])
    d, nh, hd = R6.dims(cfg)
    rng = np.random.default_rng(6)
    x = _x(d, scale=0.5)
    xp = _x(d, t=1, seed=8, scale=0.5)
    st = (0.1 * rng.standard_normal((2, nh, hd, hd))).astype(np.float32)
    tm_names = ["mix", "r", "k", "v", "g", "o", "w_base", "w_lora_a",
                "w_lora_b", "u", "ln"]
    jo, jxp, jst = JR6.time_mix(jcfg, _j(tree["tm"]), jnp.asarray(x),
                                _inf(tm_names, 2), x_prev=jnp.asarray(xp),
                                state=jnp.asarray(st),
                                formulation=formulation, chunk=4)
    to, txp, tst = R6.time_mix(cfg, bridge.params_from_numpy(
        tree["tm"], "cpu"), T(x), x_prev=T(xp), state=T(st),
        formulation=formulation, chunk=4)
    for got, want in ((to, jo), (txp, jxp), (tst, jst)):
        _close(got, want, rtol=1e-5, atol=1e-5)
    jc, jcp = JR6.channel_mix(jcfg, _j(tree["cm"]), jnp.asarray(x),
                              _inf(["mix", "k", "v", "r"], 2),
                              x_prev=jnp.asarray(xp))
    tc, tcp = R6.channel_mix(cfg, bridge.params_from_numpy(tree["cm"],
                                                           "cpu"),
                             T(x), x_prev=T(xp))
    _close(tc, jc)
    _close(tcp, jcp)
    x1 = x[:, :1]
    jo, jxp, jst = JR6.time_mix_decode(
        jcfg, _j(tree["tm"]), jnp.asarray(x1), _inf(tm_names, 2),
        x_prev=jnp.asarray(xp), state=jnp.asarray(st))
    to, txp, tst = R6.time_mix_decode(
        cfg, bridge.params_from_numpy(tree["tm"], "cpu"), T(x1),
        x_prev=T(xp), state=T(st))
    for got, want in ((to, jo), (txp, jxp), (tst, jst)):
        _close(got, want)
    jc, _ = JR6.channel_mix_decode(jcfg, _j(tree["cm"]), jnp.asarray(x1),
                                   _inf(["mix", "k", "v", "r"], 2),
                                   x_prev=jnp.asarray(xp))
    tc, _ = R6.channel_mix_decode(cfg, bridge.params_from_numpy(
        tree["cm"], "cpu"), T(x1), x_prev=T(xp))
    _close(tc, jc)


# ---------------------------------------------------------------------------
# The chunked SSD.
# ---------------------------------------------------------------------------


def _ssd_inputs(t, h=2, p=8, n=4, seed=0):
    """dt = softplus(N(0, 1) + 0.25), a = -exp(U(-0.5, 0.5)) (a_log's
    init), as zamba2's layers start."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((1, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((1, t, h)) + 0.25)).astype(
        np.float32)
    a = -np.exp(rng.uniform(-0.5, 0.5, (1, h))).astype(np.float32)
    bm = rng.standard_normal((1, t, n)).astype(np.float32)
    cm = rng.standard_normal((1, t, n)).astype(np.float32)
    return xh, dt, a, bm, cm


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_chunked_matches_reference(chunk):
    """T = 45: a ragged last chunk at both sizes."""
    xh, dt, a, bm, cm = _ssd_inputs(45)
    jy, js = JM2._ssd_chunked(*map(jnp.asarray, (xh, dt, a, bm, cm)), chunk)
    ty, ts = M2._ssd_chunked(*map(T, (xh, dt, a, bm, cm)), chunk)
    _close(ty, jy, rtol=1e-5, atol=1e-5)
    _close(ts, js, rtol=1e-5, atol=1e-5)


def test_ssd_chunk_256_grads_finite_where_the_reference_is_not():
    """zamba2's chunk of 256 at T = 256: the reference's exp over the whole
    (q, q) matrix overflows above the diagonal and its gradients with
    respect to dt and a are non-finite; the port masks the exponent
    first: its output matches a float64 recurrence within 1e-4 of the
    largest |y| and its gradients are finite."""
    xh, dt, a, bm, cm = _ssd_inputs(256)

    def jloss(dt_, a_):
        y, _ = JM2._ssd_chunked(jnp.asarray(xh), dt_, a_, jnp.asarray(bm),
                                jnp.asarray(cm), 256)
        return jnp.sum(y)

    jgd, jga = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(dt),
                                               jnp.asarray(a))
    assert not np.isfinite(np.asarray(jgd)).all()
    assert not np.isfinite(np.asarray(jga)).all()
    tdt, ta = T(dt).requires_grad_(), T(a).requires_grad_()
    y, s_t = M2._ssd_chunked(T(xh), tdt, ta, T(bm), T(cm), 256)
    y.sum().backward()
    assert torch.isfinite(tdt.grad).all() and torch.isfinite(ta.grad).all()
    s = np.zeros((1, 2, 8, 4))
    ys = []
    for i in range(256):  # the recurrence, float64
        s = (s * np.exp(a * dt[:, i])[:, :, None, None]
             + np.einsum("bhp,bn,bh->bhpn", xh[:, i], bm[:, i], dt[:, i]))
        ys.append(np.einsum("bhpn,bn->bhp", s, cm[:, i]))
    ys = np.stack(ys, 1)
    tol = 1e-4 * np.abs(ys).max()
    assert np.abs(y.detach().numpy() - ys).max() <= tol
    assert np.abs(s_t.detach().numpy() - s).max() <= 1e-4 * np.abs(s).max()


# ---------------------------------------------------------------------------
# WKV.
# ---------------------------------------------------------------------------


def _wkv_inputs(t, w_kind, b=2, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    r, k = (0.5 * rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, t, h, d)).astype(np.float32)
    if w_kind == "init":  # log(-log w) ~ U(-1, 1): w_base's init range
        w = np.exp(-np.exp(rng.uniform(-1, 1, (b, t, h, d))))
    else:  # the reference's own test: w in [0.6, 1]
        w = rng.uniform(0.6, 1.0, (b, t, h, d))
    u = rng.uniform(-0.5, 0.5, (b, h, d)).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((b, h, d, d))).astype(np.float32)
    return r, k, v, w.astype(np.float32), u, s0


def test_wkv_scan_matches_reference():
    args = _wkv_inputs(37, "init")
    jo, js = JR6._wkv_scan(*map(jnp.asarray, args))
    to, ts = R6._wkv_scan(*map(T, args))
    _close(to, jo)
    _close(ts, js)


@pytest.mark.parametrize("chunk", [8])
def test_wkv_chunked_matches_reference_at_its_test_decays(chunk):
    """T = 45 (ragged), w in [0.6, 1] as the reference's own test draws
    them: there the reference's clamped form is exact too."""
    args = _wkv_inputs(45, "mild")
    jo, js = JR6._wkv_chunked(*map(jnp.asarray, args), chunk)
    to, ts = R6._wkv_chunked(*map(T, args), chunk)
    _close(to, jo, rtol=1e-5, atol=1e-5)
    _close(ts, js, rtol=1e-5, atol=1e-5)


def test_wkv_chunked_exact_at_init_decays_where_the_reference_misses():
    """T = 256 at the reference's default chunk 128, at the init decays:
    the port's chunked form is within 1e-4 of its scan (and of the
    largest |o| times 1e-5); the reference's misses its own scan by more
    than a tenth of the largest |o|."""
    args = _wkv_inputs(256, "init")
    so, ss = R6._wkv_scan(*map(T, args))
    co, cs = R6._wkv_chunked(*map(T, args), 128)
    big = float(so.abs().max())
    assert float((co - so).abs().max()) <= min(1e-4, 1e-5 * big)
    assert float((cs - ss).abs().max()) <= 1e-4
    jo, _ = JR6._wkv_chunked(*map(jnp.asarray, args), 128)
    assert np.abs(np.asarray(jo) - so.numpy()).max() > 0.1 * big
    # finite gradients through the chunked form
    r = T(args[0]).requires_grad_()
    w = T(args[3]).requires_grad_()
    o, _ = R6._wkv_chunked(r, *map(T, args[1:3]), w, *map(T, args[4:]), 128)
    o.sum().backward()
    assert torch.isfinite(r.grad).all() and torch.isfinite(w.grad).all()


# ---------------------------------------------------------------------------
# dp_broadcast and dp_shift.
# ---------------------------------------------------------------------------


def _prim_inputs(seed=1, b=4, t=5, d=6):
    rng = np.random.default_rng(seed)
    return dict(p=rng.standard_normal((3, d)).astype(np.float32),
                bias=rng.standard_normal((d,)).astype(np.float32),
                x=rng.standard_normal((b, t, d)).astype(np.float32),
                w1=rng.standard_normal((b, 3, d)).astype(np.float32),
                w2=rng.standard_normal((b, t, d)).astype(np.float32))


@pytest.mark.parametrize("which", ["broadcast", "shift"])
def test_dp_broadcast_and_dp_shift_match_reference(which):
    """Norms² (the thresholds' cotangent) and the clipped sums, with
    thresholds at 0.5-1.5 of each example's norm (some clip, some not),
    at +inf and as a direct scale."""
    v = _prim_inputs()
    b = v["x"].shape[0]

    def jf(par, c):
        if which == "broadcast":
            return jnp.sum(JDPL.dp_broadcast(par, c) * v["w1"])
        return jnp.sum(JDPL.dp_shift(par, jnp.asarray(v["x"]), c) * v["w2"])

    par = v["p"] if which == "broadcast" else v["bias"]
    n_inf = jax.grad(jf, argnums=1)(jnp.asarray(par),
                                    jnp.full((b,), jnp.inf))
    rng = np.random.default_rng(2)
    for c in (np.sqrt(np.asarray(n_inf)) * rng.uniform(0.5, 1.5, b),
              np.full((b,), np.inf), -np.full((b,), 0.3)):
        c = c.astype(np.float32)
        jgp, jgc = jax.grad(jf, argnums=(0, 1))(jnp.asarray(par),
                                                jnp.asarray(c))
        tp, tc = T(par).requires_grad_(), T(c).requires_grad_()
        if which == "broadcast":
            y = torch.sum(DPL.dp_broadcast(tp, tc) * T(v["w1"]))
        else:
            y = torch.sum(DPL.dp_shift(tp, T(v["x"]), tc) * T(v["w2"]))
        gp, gc = torch.autograd.grad(y, [tp, tc])
        _close(gp, jgp, rtol=1e-5, atol=1e-6)
        _close(gc, jgc, rtol=1e-5, atol=1e-6)


def _prim_spec(P_):
    return {"shift": {"b": P_((6,), init="zeros")},
            "vec": P_((3, 6), init="zeros")}


def _prim_loss(dpl, xp, v):
    def loss(params, batch, th):
        y = dpl.dp_shift(params["shift"]["b"], batch["x"], th["shift"])
        z = dpl.dp_broadcast(params["vec"], th["vec"])
        return (xp.sum(y * v["w2"], (1, 2))
                + xp.sum(z * v["w1"], (1, 2)))
    return loss


@pytest.mark.parametrize("mode", ["ghost_flat", "per_group"])
def test_shift_and_broadcast_bk_recipes_match_twopass_and_reference(mode):
    """A loss of one dp_shift and one dp_broadcast group: BK (the `shift`
    and `broadcast` recipes and their epilogue) equals twopass in the
    port and the reference's BK."""
    v = _prim_inputs()
    b = v["x"].shape[0]
    tree = {"shift": {"b": v["bias"]}, "vec": v["p"]}
    layout = GroupLayout(_prim_spec(P))
    jlayout = JLayout(_prim_spec(JP))
    assert [g.name for g in layout.groups] == ["shift", "vec"]
    kw = ({"flat_threshold": np.float32(1.5)} if mode == "ghost_flat" else
          {"group_assignment": np.array([0, 1], np.int32),
           "group_thresholds": np.array([1.0, 2.0], np.float32)})
    tv = {k: T(a) for k, a in v.items()}
    batch = {"x": v["x"]}
    with jax_backend.scoped("xla"):
        want = jax_clip(_prim_loss(JDPL, jnp, v), _j(tree), _j(batch),
                        jlayout, mode=mode, batch_size=b, execution="bk",
                        **{k: jnp.asarray(a) for k, a in kw.items()})
    out = {}
    for ex in ("bk", "twopass"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # BK must not fall back
            out[ex] = dp_clipped_gradients(
                _prim_loss(DPL, torch, tv),
                bridge.train_params_from_numpy(tree, "cpu"), _t(batch),
                layout, mode=mode, batch_size=b, execution=ex,
                **{k: torch.as_tensor(a) for k, a in kw.items()})
    for ex in ("bk", "twopass"):
        np.testing.assert_allclose(out[ex].norms_sq.numpy(),
                                   np.asarray(want.norms_sq), rtol=1e-5)
        assert_trees_close(out[ex].grads, want.grads)


# ---------------------------------------------------------------------------
# The models.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_layouts_match_reference(arch, reduced):
    """Built from the spec alone (the full models cost no allocation):
    groups, stack shapes, dims, offsets and sensitivity multipliers one
    for one; zamba2's shared block at the number of its sites."""
    m, jm = _models(arch, reduced)
    assert [(g.name, g.stack_shape, g.dim, g.offset, g.sensitivity_mult)
            for g in m.layout.groups] == [
        (g.name, g.stack_shape, g.dim, g.offset, g.sensitivity_mult)
        for g in jm.layout.groups]
    assert m.num_params == jm.num_params
    if arch == "zamba2-7b":
        sites = -(-m.cfg.num_layers // m.cfg.shared_every)
        assert m.layout.group("shared/attn/qkv").sensitivity_mult == sites
        assert m.layout.group("shared/attn_norm").sensitivity_mult == 1
    assert m.init_paged_cache is None


@pytest.mark.parametrize("arch,mode", [
    ("rwkv6-7b", "per_layer"), ("zamba2-7b", "per_layer"),
    ("zamba2-7b", "ghost_flat_twopass")])
def test_recurrent_clipped_gradients_match_reference(arch, mode):
    """Loss, (K, B) norms² and every clipped gradient leaf, the
    dp_broadcast vectors and zamba2's shared block (clipped per site)
    among them."""
    m, jm = _models(arch)
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size)
    rng = np.random.default_rng(2)
    kw, jkw = dict(mode=mode, batch_size=B), {}
    if mode == "per_layer":
        thr = rng.uniform(0.05, 2.0, m.layout.num_groups).astype(np.float32)
        kw["thresholds"], jkw["thresholds"] = T(thr), jnp.asarray(thr)
    elif mode == "ghost_flat_twopass":
        kw["flat_threshold"] = jkw["flat_threshold"] = np.float32(0.5)
    with jax_backend.scoped("xla"):
        want = jax.jit(functools.partial(
            jax_clip, jm.loss_fn, layout=jm.layout, mode=mode,
            batch_size=B))(_j(tree), _j(batch), **jkw)
    got = dp_clipped_gradients(
        m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"), _t(batch),
        m.layout, **kw)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-6)
    np.testing.assert_allclose(got.norms_sq.numpy(), np.asarray(want.norms_sq),
                               rtol=1e-5, atol=1e-9)
    assert_trees_close(got.grads, want.grads)


def _jax_ssd_masked(xh, dt, a, B_, C_, chunk):
    """The reference's `_ssd_chunked` with the port's one change: the
    log-decay differences masked to -inf before `exp`."""
    b, t, h, p = xh.shape
    n = B_.shape[-1]
    q = min(chunk, t)
    nc = -(-t // q)

    def r(x):
        x = jnp.pad(x, ((0, 0), (0, nc * q - t)) + ((0, 0),) * (x.ndim - 2))
        return x.reshape((b, nc, q) + x.shape[2:])

    adt, xdt = r(a[:, None, :] * dt), r(xh * dt[..., None])
    bc, cc = r(B_).astype(jnp.float32), r(C_).astype(jnp.float32)
    cum = jnp.cumsum(adt, axis=2)
    total = cum[:, :, -1]
    mask = jnp.tril(jnp.ones((q, q), bool))[None, None, :, :, None]
    ldiff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    lmat = jnp.exp(jnp.where(mask, ldiff, -jnp.inf))
    y = jnp.einsum("bcqk,bcqkh,bckhp->bcqhp",
                   jnp.einsum("bcqn,bckn->bcqk", cc, bc), lmat, xdt)
    states = jnp.einsum("bckn,bckh,bckhp->bchpn", bc,
                        jnp.exp(total[:, :, None, :] - cum), xdt)
    s = jnp.zeros((b, h, p, n), jnp.float32)
    for c in range(nc):
        y = y.at[:, c].add(jnp.einsum("bqn,bqh,bhpn->bqhp", cc[:, c],
                                      jnp.exp(cum[:, c]), s))
        s = s * jnp.exp(total[:, c])[:, :, None, None] + states[:, c]
    return y.reshape(b, nc * q, h, p)[:, :t].astype(xh.dtype), s


def test_two_recurrent_per_layer_steps_match_reference_with_its_draws(
        monkeypatch):
    """zamba2 (Mamba2 layers, the shared block, the broadcast vectors):
    noise per group and the quantile update; the reference runs its xla
    engine. The first step's update moves the decays into the
    reference's SSD overflow (ROADMAP C; the reference's second step then
    has a non-finite gradient norm where the port's is finite), so the
    reference runs here with its SSD masked as the port's
    (`_jax_ssd_masked`), which changes nothing where it is finite."""
    monkeypatch.setattr(JM2, "_ssd_chunked", _jax_ssd_masked)
    m, jm = _models("zamba2-7b")
    tree = bridge.numpy_params(m.spec, seed=0)
    kw = dict(mode="per_layer", sigma=0.7, sampling_rate=0.05, steps=10,
              init_threshold=0.5, noise_strategy="weighted")
    j_init, j_step, j_plan = JSGD.make_dp_train_step(
        jm.loss_fn, jm.spec, jm.layout, joptim.sgd(0.05, momentum=0.9),
        JSGD.DPConfig(backend="xla", **kw), batch_size=4)
    p_init, p_step, p_plan = dp_sgd.make_dp_train_step(
        m.loss_fn, m.spec, m.layout, optim.sgd(0.05, momentum=0.9),
        dp_sgd.DPConfig(backend="kernels", **kw), batch_size=4)
    assert (p_plan.sigma, p_plan.sigma_b, p_plan.sigma_new) == (
        j_plan.sigma, j_plan.sigma_b, j_plan.sigma_new)
    ng = m.layout.num_groups
    key = jax.random.PRNGKey(7)
    cur = {}
    monkeypatch.setattr(dp_sgd, "standard_normal",
                        lambda path, shape, rows, gen: T(cur["z"][path][rows]))
    monkeypatch.setattr(Q, "count_noise", lambda shape, gen: T(cur["zq"]))
    jp, (jo, jd) = _j(tree), j_init(_j(tree))
    pp = bridge.train_params_from_numpy(tree, "cpu")
    po, pd = p_init(pp)
    step = jax.jit(j_step)
    with jax_backend.scoped("xla"):
        for s in range(2):
            cur["z"], cur["zq"] = _reference_draws(jm.spec, ng, key, s)
            batch = _batch(m.cfg.vocab_size, b=4, seed=30 + s)
            jp, jo, jd, jmet = step(jp, jo, jd, _j(batch), key)
            pp, po, pd, pmet = p_step(pp, po, pd, _t(batch), 0)
            np.testing.assert_allclose([float(x) for x in pmet],
                                       [float(x) for x in jmet], rtol=1e-5)
    assert 0.0 < float(pmet.clip_fraction) < 1.0
    np.testing.assert_allclose(pd.qstate.thresholds.numpy(),
                               np.asarray(jd.qstate.thresholds), rtol=1e-5)
    assert_trees_close(pp, jp, atol_frac=1e-4)


def _group_kw(m, mode):
    if mode == "ghost_flat":
        return {"flat_threshold": np.float32(0.5)}
    rng = np.random.default_rng(4)
    return {"group_assignment": np.asarray(
                [i % 2 for i in range(m.layout.num_groups)], np.int32),
            "group_thresholds": rng.uniform(0.1, 1.0, 2).astype(np.float32)}


@pytest.mark.parametrize("mode", ["ghost_flat"])
def test_rwkv6_bk_matches_twopass_and_reference(mode):
    """One backward and the epilogue (the linears' scale_contract, the
    broadcast vectors' and norms' per-example sinks), with no fallback:
    equal to the port's twopass and to the reference's BK."""
    m, jm = _models("rwkv6-7b")
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size)
    kw = _group_kw(m, mode)
    assert JBK.probe_recipes(jm.loss_fn, _j(tree), _j(batch), jm.layout,
                             B) is not None
    with jax_backend.scoped("xla"):
        want = jax.jit(functools.partial(
            jax_clip, jm.loss_fn, layout=jm.layout, mode=mode, batch_size=B,
            execution="bk"))(_j(tree), _j(batch),
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    out = {}
    for ex in ("bk", "twopass"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            out[ex] = dp_clipped_gradients(
                m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"),
                _t(batch), m.layout, mode=mode, batch_size=B, execution=ex,
                **{k: T(np.asarray(v)) for k, v in kw.items()})
    for ex in ("bk", "twopass"):
        np.testing.assert_allclose(float(out[ex].loss), float(want.loss),
                                   rtol=1e-6)
        np.testing.assert_allclose(out[ex].norms_sq.numpy(),
                                   np.asarray(want.norms_sq), rtol=1e-5,
                                   atol=1e-9)
        assert_trees_close(out[ex].grads, want.grads)


def test_zamba2_bk_falls_back_to_twopass():
    """The shared block's groups carry sensitivity_mult = the site count:
    the port warns and runs twopass, as the reference falls back, and
    gives twopass's result bit for bit (`test_recurrent_clipped_
    gradients_match_reference` holds zamba2's twopass to the
    reference's)."""
    m, _ = _models("zamba2-7b")
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size)
    kw = _group_kw(m, "ghost_flat")
    want = dp_clipped_gradients(
        m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"), _t(batch),
        m.layout, mode="ghost_flat", batch_size=B, execution="twopass",
        **{k: T(np.asarray(v)) for k, v in kw.items()})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = dp_clipped_gradients(
            m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"),
            _t(batch), m.layout, mode="ghost_flat", batch_size=B,
            execution="bk", **{k: T(np.asarray(v)) for k, v in kw.items()})
    msgs = [str(w.message) for w in caught if FALLBACK in str(w.message)]
    assert len(msgs) == 1 and "sensitivity_mult > 1" in msgs[0]
    assert torch.equal(got.norms_sq, want.norms_sq)
    for (name, g), (_, w) in zip(_leaves(got.grads), _leaves(want.grads)):
        assert torch.equal(g, w), name


def _linears(cfg):
    """The DP linears one step runs: rwkv6 7 + 3 a layer; zamba2 2 a
    Mamba2 layer and 4 a shared-block site; and the head."""
    if cfg.shared_attention:
        sites = -(-cfg.num_layers // cfg.shared_every)
        return 2 * cfg.num_layers + 4 * sites + 1
    return 10 * cfg.num_layers + 1


@pytest.mark.parametrize("arch,mode,execution", [
    ("rwkv6-7b", "per_layer", "bk"), ("rwkv6-7b", "ghost_flat", "bk"),
    ("zamba2-7b", "per_layer", "bk"), ("zamba2-7b", "ghost_flat", "bk")])
def test_kernel_calls_per_step(arch, mode, execution, monkeypatch):
    """per_layer on the composed route (the fused rule patched off, as at
    full width): one ghost_norm and one clip_reduce per linear call; BK on
    rwkv6: one ghost_norm per linear and one scale_contract per stacked
    linear leaf (10) and the head; zamba2's BK falls back to twopass."""
    from repro_torch.kernels import fused_clip as FC
    calls = _count_calls(monkeypatch, scale_contract=True)
    monkeypatch.setattr(FC, "fits", lambda din, dout: False)
    args = train.build_train_parser().parse_args(
        ["--arch", arch, "--reduced", "--clipping", mode, "--execution",
         execution, "--steps", "2", "--batch", "2", "--seq", "8", "--docs",
         "4", "--device", "cpu"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trainer = train.Trainer(args)
        met = trainer.step()
    n = _linears(trainer.cfg)
    bk = mode == "ghost_flat" and arch == "rwkv6-7b"
    assert calls == {"ghost_norm": n, "clip_reduce": 0 if bk else n,
                     "scale_contract": 11 if bk else 0,
                     "fused_norm_clip": 0}
    assert np.isfinite(float(met.loss)) and np.isfinite(float(met.grad_norm))


@pytest.mark.parametrize("arch,clipping,execution", [
    ("rwkv6-7b", "per_layer", "bk"), ("rwkv6-7b", "ghost_flat", "bk"),
    ("zamba2-7b", "non_private", "bk"), ("zamba2-7b", "ghost_flat", "bk")])
def test_train_cli_recurrent_on_cpu(arch, clipping, execution, capsys):
    """The CLI's header and step lines; zamba2's BK warns and falls back
    (the header says so)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert train.main(["--arch", arch, "--reduced", "--clipping",
                           clipping, "--execution", execution, "--steps",
                           "2", "--batch", "2", "--seq", "8", "--docs", "8",
                           "--log-every", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced" in out
    falls = arch == "zamba2-7b" and clipping == "ghost_flat"
    assert ("bk_falls_back=twopass(shared block" in out) == falls
    assert any(FALLBACK in str(w.message) for w in caught) == falls
    losses = [float(ln.split()[3]) for ln in out.splitlines()
              if ln.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_rwkv_formulation_is_checked_and_both_train():
    m = build_model(get_config("rwkv6-7b", reduced=True), device="cpu",
                    rwkv_formulation="chunked")
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size)
    th = m.layout.pack_value(float("inf"), B)
    want = build_model(get_config("rwkv6-7b", reduced=True),
                       device="cpu").loss_fn(
        bridge.train_params_from_numpy(tree, "cpu"), _t(batch), th)
    got = m.loss_fn(bridge.train_params_from_numpy(tree, "cpu"), _t(batch),
                    th)
    _close(got, want.detach().numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="rwkv_formulation"):
        build_model(get_config("rwkv6-7b", reduced=True), device="cpu",
                    rwkv_formulation="parallel")


# ---------------------------------------------------------------------------
# On the card: the kernels at the new linear shapes.
# ---------------------------------------------------------------------------


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0)[0] != 9:
        pytest.skip("needs compute capability 9.x (Hopper)")


# B, T, din, dout: zamba2's in_proj (14,576 = 2 x 7,168 + 2 x 64 + 112
# wide, not a multiple of 64), rwkv6's decay LoRA both ways and its
# channel mix both ways, at T = 64 (the full step's 256 on the card in
# chip_smoke.py phase 19)
RECURRENT_SHAPES = [(2, 64, 3584, 14576), (2, 64, 4096, 64),
                    (2, 64, 64, 4096), (2, 64, 4096, 14336),
                    (2, 64, 14336, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RECURRENT_SHAPES)
def test_kernels_at_recurrent_shapes_on_card(shape):
    """bf16 inputs, as the models train: rtol 1e-4 and an atol of 1e-4
    of the largest magnitude of the plain result."""
    _on_card()
    b, t, din, dout = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((b, t, din), generator=gen, device="cuda").bfloat16()
    g = torch.randn((b, t, dout), generator=gen, device="cuda").bfloat16()
    f = torch.rand((b,), generator=gen, device="cuda")
    n = GN.ghost_norm(a, g)
    s = CR.clip_reduce(a, g, f)
    torch.cuda.synchronize()
    for got, want in ((n, GN.ghost_norm_ref(a, g)),
                      (s, CR.clip_reduce_ref(a, g, f))):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))
