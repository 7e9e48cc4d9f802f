"""The port's per-shard (per-device) clipping against the JAX package, on
the CPU in f32.

* `ghost_norm_blocked_ref` against the reference's Pallas kernel in
  interpret mode (bt = dk = 32, as `tests/test_kernels.py`) and against
  `repro.kernels.ref.ghost_norm_blocked_ref`: both block axes, ragged T,
  M in {2, 4}, f32 and bf16 inputs, and the reference's ValueErrors;
* `linear_norms_sq_blocked`, `fold_block_factors` and
  `clipped_sum_linear_blocked` against `repro.core.ghost`, and both
  engines' blocked ops;
* `clip_reduce_ref` with (B, M) block factors against the reference's
  fold followed by its Pallas `clip_reduce` (interpret mode) and against
  `repro.core.ghost.clipped_sum_linear_blocked`: both axes, M in
  {1, 4, 16}, ragged T; the kernels engine's blocked sum is one
  `clip_reduce` call with the (B, M) factors and no fold;
* `dp_linear_blocked` (output, input cotangent, clipped weight and bias
  gradients, the (B, M) norms² as the threshold's gradient) against
  `jax.vjp` of the reference primitive, both axes, with and without bias,
  under both engines; the norms-only and no-norms branches; a BK channel
  outside the capture scope refused, bad block axes refused;
* book-keeping over a blocked layout (the reference's `linear_blocked`
  recipe): `ghost_flat` and `per_group` by BK against the reference's BK
  on tiny with dp_blocks 2 and 4, and on a two-layer stacked net with a
  bias blocked along 'out' and 'in' (M 2 and 4), f32: norms² and every
  clipped gradient leaf; the calls from the layout (ghost_norm_blocked
  once a blocked linear in the capture, clip_reduce once a stack slice of
  each blocked leaf) and no twopass fallback;
* the blocked `GroupLayout` and `group_shard_assignment` against the
  reference's on tiny, qwen3-4b-reduced and the full qwen3-4b;
* the noise of blocked leaves per (layer, column block), against the
  reference's `add_noise_to_grads` on the same draws;
* two full noised `per_shard` steps (per_layer over the blocked layout) on
  tiny with M = 4 and the reference's draws substituted, against the
  reference's step on the same blocked config with its xla engine.

Tolerances: the plain kernel at the reference kernel test's rtol 1e-4
(sums of squares, no cancellation); the ghost ops and the primitive in
f32, the same math summed in another order: rtol 1e-5 and an atol of 1e-5
of the largest magnitude; full steps as `tests/test_torch_train.py`
(rtol 1e-5 on the metrics, atol 1e-4 of each leaf's largest magnitude).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_config as jax_get_config
from repro.core import dp_layers as JDP
from repro.core import dp_sgd as JSGD
from repro.core import ghost as JG
from repro.core import spec as JS
from repro.kernels import backend as jax_backend
from repro.kernels import ref as JREF
from repro.kernels.clip_reduce import clip_reduce as jax_clip_reduce
from repro.kernels.ghost_norm import ghost_norm_blocked as jax_blocked
from repro.launch import sharding as JSH
from repro.models import layers as JL
from repro.models.transformer import build_model as jax_build_model
from repro_torch import bridge, optim
from repro_torch.configs import get_config
from repro_torch.core import bk, dp_sgd
from repro_torch.core import dp_layers as DP
from repro_torch.core import ghost as G
from repro_torch.core import quantile as Q
from repro_torch.core import spec as S
from repro_torch.core.clipping import dp_clipped_gradients
from repro_torch.kernels import backend
from repro_torch.kernels import clip_reduce as CR
from repro_torch.kernels import ghost_norm as GN
from repro_torch.launch import sharding
from repro_torch.models import layers as L
from repro_torch.models.transformer import build_model
from repro_torch.optim import optimizers
from test_torch_train import _batch, _j, _leaves, _t, assert_trees_close

T = torch.from_numpy


def close(got, want, rtol=1e-5, atol_frac=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(want, np.float32)
    atol = atol_frac * max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _ag(b, t, din, dout, seed=0):
    rng = np.random.default_rng(seed + 13 * t + din + dout)
    return (rng.standard_normal((b, t, din)).astype(np.float32),
            (0.1 * rng.standard_normal((b, t, dout))).astype(np.float32))


def _blocked(arch, m, reduced=False):
    """The port's and the reference's model of `arch` with dp_blocks = m."""
    cfg = dataclasses.replace(get_config(arch, reduced=reduced), dp_blocks=m)
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=reduced),
                               dp_blocks=m)
    return build_model(cfg, device="cpu"), jax_build_model(jcfg)


# ---------------------------------------------------------------------------
# The kernel's plain version.
# ---------------------------------------------------------------------------

# B, T, din, dout, M, axis: ragged T against the 32-row tiles (one, two
# and three tiles), blocks narrower and wider than a 32-column chunk
BLOCKED_CASES = [(2, 37, 24, 40, 4, "out"), (2, 37, 40, 24, 2, "in"),
                 (3, 70, 48, 40, 4, "out"), (1, 9, 16, 64, 2, "out"),
                 (2, 33, 64, 20, 4, "in")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BLOCKED_CASES)
def test_ghost_norm_blocked_ref_matches_pallas_kernel_and_ref(case, dtype):
    """bf16 inputs are read as f32 on both sides (the TPU kernel casts each
    block), so the same values go in and the f32 tolerance holds."""
    b, t, din, dout, m, axis = case
    a, g = _ag(b, t, din, dout)
    ta, tg = T(a), T(g)
    ja, jg = jnp.asarray(a), jnp.asarray(g)
    if dtype == "bfloat16":
        ta, tg = ta.bfloat16(), tg.bfloat16()
        ja = jnp.asarray(ta.float().numpy()).astype(jnp.bfloat16)
        jg = jnp.asarray(tg.float().numpy()).astype(jnp.bfloat16)
    got = GN.ghost_norm_blocked_ref(ta, tg, m, axis)
    assert got.dtype == torch.float32 and got.shape == (b, m)
    assert torch.equal(GN.ghost_norm_blocked(ta, tg, m, block_axis=axis),
                       got)  # the wrapper on a CPU tensor
    for want in (jax_blocked(ja, jg, m, block_axis=axis, bt=32, dk=32,
                             interpret=True),
                 JREF.ghost_norm_blocked_ref(ja, jg, m, block_axis=axis)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    # the blocks partition the layer: their norms² sum to its norm²
    np.testing.assert_allclose(got.sum(-1).numpy(),
                               GN.ghost_norm_ref(ta, tg).numpy(), rtol=1e-4)


BAD_BLOCKED = [((2, 8, 6, 10), 4, "out", "dout=10 not divisible"),
               ((2, 8, 6, 10), 4, "in", "din=6 not divisible"),
               ((2, 8, 6, 10), 2, "rows", "block_axis must be")]


@pytest.mark.parametrize("shape,m,axis,msg", BAD_BLOCKED)
def test_blocked_norms_raise_the_reference_errors(shape, m, axis, msg):
    a, g = _ag(*shape)
    with pytest.raises(ValueError, match=msg):
        jax_blocked(jnp.asarray(a), jnp.asarray(g), m, block_axis=axis)
    with pytest.raises(ValueError, match=msg):
        JG.linear_norms_sq_blocked(jnp.asarray(a), jnp.asarray(g), m,
                                   block_axis=axis)
    with pytest.raises(ValueError, match=msg):
        GN.ghost_norm_blocked(T(a), T(g), m, block_axis=axis)
    with pytest.raises(ValueError, match=msg):
        G.linear_norms_sq_blocked(T(a), T(g), m, block_axis=axis)


# ---------------------------------------------------------------------------
# core/ghost.py and the engines against repro.core.ghost.
# ---------------------------------------------------------------------------

GHOST_CASES = [(3, 10, 6, 8, 2, "out"), (2, 1, 8, 6, 4, "in"),
               (4, 17, 12, 20, 4, "out"), (2, 5, 12, 9, 3, "in")]


@pytest.mark.parametrize("case", GHOST_CASES)
def test_blocked_ghost_ops_match_reference(case):
    b, t, din, dout, m, axis = case
    a, g = _ag(b, t, din, dout, seed=1)
    f = np.random.default_rng(2).uniform(0, 1, (b, m)).astype(np.float32)
    ja, jg, jf = jnp.asarray(a), jnp.asarray(g), jnp.asarray(f)
    close(G.linear_norms_sq_blocked(T(a), T(g), m, block_axis=axis),
          JG.linear_norms_sq_blocked(ja, jg, m, block_axis=axis))
    fa, fg = G.fold_block_factors(T(a), T(g), T(f), axis)
    ra, rg = JG.fold_block_factors(ja, jg, jf, axis)
    assert fa.dtype == fg.dtype == torch.float32
    close(fa, ra)
    close(fg, rg)
    close(G.clipped_sum_linear_blocked(T(a), T(g), T(f), block_axis=axis),
          JG.clipped_sum_linear_blocked(ja, jg, jf, block_axis=axis))
    # 2-D inputs are rank-one examples, as in linear_norms_sq
    close(G.linear_norms_sq_blocked(T(a[:, 0]), T(g[:, 0]), m,
                                    block_axis=axis),
          JG.linear_norms_sq_blocked(ja[:, 0], jg[:, 0], m, block_axis=axis))


@pytest.mark.parametrize("engine", ["plain", "kernels"])
@pytest.mark.parametrize("case", GHOST_CASES[:2])
def test_engine_blocked_ops_on_cpu(engine, case):
    """Both engines give the reference's blocked ops; the kernels engine's
    wrappers run their plain versions on CPU tensors and count nothing."""
    from repro_torch.kernels import launch_counts
    b, t, din, dout, m, axis = case
    a, g = _ag(b, t, din, dout, seed=3)
    f = np.random.default_rng(4).uniform(0, 1, (b, m)).astype(np.float32)
    ja, jg, jf = jnp.asarray(a), jnp.asarray(g), jnp.asarray(f)
    before = launch_counts()
    with backend.scoped(engine):
        eng = backend.active()
        n = eng.linear_norms_sq_blocked(T(a), T(g), m, block_axis=axis)
        s = eng.clipped_sum_linear_blocked(T(a), T(g), T(f), block_axis=axis)
    assert launch_counts() == before
    close(n, JG.linear_norms_sq_blocked(ja, jg, m, block_axis=axis))
    close(s, JG.clipped_sum_linear_blocked(ja, jg, jf, block_axis=axis))


# B, T, din, dout, M, axis: both axes, M = 16 / 4 / 1, ragged T, T = 1
BLOCK_FACTOR_CASES = [(3, 10, 12, 32, 16, "out"), (2, 7, 48, 20, 16, "in"),
                      (3, 37, 20, 24, 4, "out"), (2, 5, 16, 12, 4, "in"),
                      (2, 9, 8, 6, 1, "out"), (2, 1, 6, 10, 1, "in")]


@pytest.mark.parametrize("case", BLOCK_FACTOR_CASES)
def test_clip_reduce_ref_block_factors_match_reference(case):
    """clip_reduce_ref with (B, M) factors is the reference's pallas
    engine (fold, then the Pallas clip_reduce with unit factors, interpret
    mode) and its plain path; f32, the same math summed in another order:
    rtol 1e-5, atol 1e-5 of the largest magnitude."""
    b, t, din, dout, m, axis = case
    a, g = _ag(b, t, din, dout, seed=11)
    f = np.random.default_rng(12).uniform(0, 1, (b, m)).astype(np.float32)
    ja, jg, jf = jnp.asarray(a), jnp.asarray(g), jnp.asarray(f)
    got = CR.clip_reduce_ref(T(a), T(g), T(f), axis)
    assert got.dtype == torch.float32 and got.shape == (din, dout)
    assert torch.equal(CR.clip_reduce(T(a), T(g), T(f), axis), got)
    fa, fg = JG.fold_block_factors(ja, jg, jf, axis)
    close(got, jax_clip_reduce(fa, fg, jnp.ones((b,), jnp.float32),
                               interpret=True))
    close(got, JG.clipped_sum_linear_blocked(ja, jg, jf, block_axis=axis))
    if m == 1:  # one block: the per-example factor
        close(got, CR.clip_reduce_ref(T(a), T(g), T(f[:, 0])))


def test_kernels_engine_blocked_sum_is_one_clip_reduce(monkeypatch):
    """The kernels engine hands the bf16 operands and the (B, M) factors
    to clip_reduce as they are: one call, no fold before it (the plain
    version folds inside clip_reduce_ref, which stays unpatched)."""
    calls, real = [], CR.clip_reduce

    def recording(a, g, factors, block_axis="out"):
        calls.append((a.dtype, g.dtype, tuple(factors.shape), block_axis))
        return real(a, g, factors, block_axis)

    def no_fold(*a, **k):
        raise AssertionError("the engine folded the factors")

    monkeypatch.setattr(CR, "clip_reduce", recording)
    monkeypatch.setattr(G, "fold_block_factors", no_fold)
    a, g = _ag(3, 10, 12, 32, seed=13)
    f = np.random.default_rng(14).uniform(0, 1, (3, 4)).astype(np.float32)
    ta, tg = T(a).bfloat16(), T(g).bfloat16()
    for axis in ("out", "in"):
        with backend.scoped("kernels"):
            got = backend.active().clipped_sum_linear_blocked(
                ta, tg, T(f), block_axis=axis)
        fa, fg = JG.fold_block_factors(
            jnp.asarray(ta.float().numpy()), jnp.asarray(tg.float().numpy()),
            jnp.asarray(f), axis)
        close(got, jnp.einsum("bti,bto->io", fa, fg))
    assert calls == [(torch.bfloat16, torch.bfloat16, (3, 4), "out"),
                     (torch.bfloat16, torch.bfloat16, (3, 4), "in")]


# ---------------------------------------------------------------------------
# dp_linear_blocked against the reference primitive.
# ---------------------------------------------------------------------------

# (B, M) thresholds: clip, pass (+inf) and direct scale in every column
C_BLOCKED = np.array([[3.0, np.inf], [-0.5, 12.0], [20.0, 5.0],
                      [np.inf, -1.5]], np.float32)


@pytest.mark.parametrize("engine", ["plain", "kernels"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("axis", ["out", "in"])
def test_dp_linear_blocked_matches_reference_vjp(engine, bias, axis):
    rng = np.random.default_rng(5)
    w = (0.3 * rng.standard_normal((6, 8))).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32) if bias else None
    x = rng.standard_normal((4, 5, 6)).astype(np.float32)
    gy = rng.standard_normal((4, 5, 8)).astype(np.float32)
    c = C_BLOCKED
    y_j, vjp = jax.vjp(
        lambda w_, b_, x_, c_: JDP.dp_linear_blocked(w_, b_, x_, c_, axis),
        jnp.asarray(w), None if b is None else jnp.asarray(b),
        jnp.asarray(x), jnp.asarray(c))
    dw_j, db_j, dx_j, dc_j = vjp(jnp.asarray(gy))
    tw, tx, tc = (T(v).requires_grad_() for v in (w, x, c))
    tb = T(b).requires_grad_() if bias else None
    with backend.scoped(engine):
        y = DP.dp_linear_blocked(tw, tb, tx, tc, axis)
    close(y, y_j)
    ins = [tw, tx, tc] + ([tb] if bias else [])
    got = torch.autograd.grad(y, ins, grad_outputs=T(gy))
    assert got[2].shape == (4, 2)
    close(got[0], dw_j)
    close(got[1], dx_j)
    close(got[2], dc_j)
    if bias:
        close(got[3], db_j)
    # some blocks clipped, some not: every branch of the factor ran
    n, clip = got[2].numpy(), np.isfinite(c) & (c > 0)
    assert (n[clip] > c[clip] ** 2).any() and (n[clip] < c[clip] ** 2).any()


def test_dp_linear_blocked_norms_only_and_direct_scale(monkeypatch):
    """Norms only (no weight gradient asked for): no contraction runs.
    Thresholds without grad: no norm op runs; +inf gives the unclipped
    sum and a finite C poisons the gradient (NaN)."""
    rng = np.random.default_rng(8)
    w = T(rng.standard_normal((6, 8)).astype(np.float32))
    x = T(rng.standard_normal((4, 5, 6)).astype(np.float32))
    c = T(C_BLOCKED).requires_grad_()

    def boom(*a, **k):
        raise AssertionError("a contraction ran")

    for engine in ("plain", "kernels"):
        with monkeypatch.context() as mp:
            mp.setattr(G, "clipped_sum_linear_blocked", boom)
            mp.setattr(GN, "ghost_norm", boom)
            with backend.scoped(engine):
                y = DP.dp_linear_blocked(w, None, x, c, "out")
            (n,) = torch.autograd.grad(y.sum(), [c])
        close(n, JG.linear_norms_sq_blocked(
            jnp.asarray(x.numpy()), jnp.ones((4, 5, 8)), 2))

    def no_norms(*a, **k):
        raise AssertionError("a norm op ran")

    monkeypatch.setattr(GN, "ghost_norm_blocked", no_norms)
    monkeypatch.setattr(G, "linear_norms_sq_blocked", no_norms)
    wg = w.clone().requires_grad_()
    for engine in ("plain", "kernels"):
        with backend.scoped(engine):
            y = DP.dp_linear_blocked(wg, None, x,
                                     torch.full((4, 2), float("inf")), "out")
        (dw,) = torch.autograd.grad(y.sum(), [wg])
        close(dw, torch.einsum("bti,bto->io", x, torch.ones(4, 5, 8)))
        with backend.scoped(engine):
            y = DP.dp_linear_blocked(wg, None, x, torch.full((4, 2), 0.5),
                                     "out")
        (dw,) = torch.autograd.grad(y.sum(), [wg])
        assert torch.isnan(dw).all()


def test_dp_linear_blocked_refuses_bk_and_bad_axes():
    """A BK channel whose forward ran outside the capture scope is refused
    (a capture pass returns no parameter gradients), as are bad block
    axes; BK over a blocked layout itself now runs (the tests below)."""
    w = torch.ones((6, 8), requires_grad=True)
    x = torch.ones((2, 3, 6))
    ch = bk.BkChannel(torch.ones(2, 4, requires_grad=True), "g")
    y = DP.dp_linear_blocked(w, None, x, ch)
    with pytest.raises(RuntimeError, match="outside backend.scoped"):
        torch.autograd.grad(y.sum(), [ch.c])
    with pytest.raises(ValueError, match="block_axis"):
        DP.dp_linear_blocked(w, None, x, torch.ones(2, 4), "rows")
    with pytest.raises(ValueError, match="block_axis"):
        DP.dp_linear_blocked(w, None, x, ch, "rows")


def test_linear_blocked_transposes_layout_thresholds():
    """The layout's (M, B) threshold row reaches the primitive as (B, M),
    and its gradient (the norms²) comes back as (M, B)."""
    rng = np.random.default_rng(9)
    p = {"w": T(rng.standard_normal((6, 8)).astype(np.float32))}
    x = T(rng.standard_normal((3, 5, 6)).astype(np.float32))
    th = torch.full((4, 3), float("inf"), requires_grad=True)
    (n,) = torch.autograd.grad(L.linear_blocked(p, x, th).sum(), [th])
    want = JG.linear_norms_sq_blocked(jnp.asarray(x.numpy()),
                                      jnp.ones((3, 5, 8)), 4)
    close(n.T, want)


# ---------------------------------------------------------------------------
# Layout, shard ownership, noise.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,reduced,m", [("tiny", False, 4),
                                            ("qwen3-4b", True, 4),
                                            ("qwen3-4b", False, 16)])
def test_blocked_layout_matches_reference(arch, reduced, m):
    """Built from the spec alone: the full qwen3-4b costs no allocation."""
    pm, jm = _blocked(arch, m, reduced)
    lay, ref = pm.layout, jm.layout
    assert [(g.name, g.stack_shape, g.dim, g.offset, g.sensitivity_mult)
            for g in lay.groups] == [
        (g.name, g.stack_shape, g.dim, g.offset, g.sensitivity_mult)
        for g in ref.groups]
    np.testing.assert_array_equal(lay.dims, ref.dims)
    assert lay.flat_names() == ref.flat_names()
    for ms in sorted({m, 2}):
        assert sharding.group_shard_assignment(lay, ms) == tuple(
            int(v) for v in JSH.group_shard_assignment(ref, ms))
    if arch == "qwen3-4b" and not reduced:
        # 291 groups, plus 15 more blocks of qkv and o in each of 36 layers
        assert lay.num_groups == 291 + 36 * 2 * 15 == 1371
        assert lay.group("dense_blocks/attn/qkv").stack_shape == (36, 16)
        assert lay.group("dense_blocks/attn/qkv").dim == 2560 * 384
        assert lay.group("dense_blocks/attn/o").dim == 4096 * 160


def test_blocked_layout_packing_round_trip():
    pm, jm = _blocked("tiny", 4)
    lay, ref = pm.layout, jm.layout
    rng = np.random.default_rng(10)
    k, b = lay.num_groups, 3
    flat = rng.uniform(0.1, 2.0, k).astype(np.float32)
    rows = rng.uniform(0.1, 2.0, (k, b)).astype(np.float32)
    for got, want in ((lay.pack(T(flat), b), ref.pack(jnp.asarray(flat), b)),
                      (lay.pack_rows(T(rows)),
                       ref.pack_rows(jnp.asarray(rows)))):
        assert set(got) == set(want)
        for name in got:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))
    packed = lay.pack_rows(T(rows))
    assert packed["dense_blocks/attn/qkv"].shape == (2, 4, b)
    np.testing.assert_array_equal(lay.unpack(packed).numpy(), rows)


def test_blocked_bias_shares_its_weight_groups():
    """A biased blocked linear: the bias splits into the same M blocks and
    joins its weight's groups, as `repro.models.layers.linear_spec`."""
    spec = {"lin": L.linear_spec(6, 8, bias=True, stack=(3,), blocks=4)}
    jspec = {"lin": JL.linear_spec(6, 8, bias=True, stack=(3,), blocks=4)}
    lay, ref = S.GroupLayout(spec), JS.GroupLayout(jspec)
    assert [(g.name, g.stack_shape, g.dim, g.offset) for g in lay.groups] \
        == [(g.name, g.stack_shape, g.dim, g.offset) for g in ref.groups] \
        == [("lin", (3, 4), 6 * 2 + 2, 0)]
    with pytest.raises(ValueError, match="stack shape mismatch"):
        S.GroupLayout({"lin": {"w": S.P((6, 8), blocks=4),
                               "b": S.P((8,))}})


def _zeros(spec):
    out = {}
    for path, p in S._walk(spec):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.zeros(p.shape)
    return out


@pytest.mark.parametrize("slice_elems", [1 << 26, 64])
def test_blocked_noise_std_per_layer_and_column_block(slice_elems,
                                                      monkeypatch):
    """On zero grads with the reference's own draws substituted, every leaf
    equals the reference's noise: a blocked leaf takes the std of its
    (layer, column block), whether it is drawn whole or in slices along
    the stack axis. Taking the std per stack row instead (the first L of
    the L M stds) fails here."""
    pm, jm = _blocked("tiny", 4)
    lay = pm.layout
    stds = np.linspace(0.5, 3.0, lay.num_groups).astype(np.float32)
    key = jax.random.PRNGKey(3)
    z = {"/".join(path): np.array(jax.random.normal(
        jax.random.fold_in(key, JS.stable_hash("/".join(path))), p.shape,
        jnp.float32)) for path, p in JS._walk(jm.spec)}
    monkeypatch.setattr(optimizers, "_SLICE_ELEMS", slice_elems)
    monkeypatch.setattr(dp_sgd, "standard_normal",
                        lambda path, shape, rows, gen: T(z[path][rows]))
    got = dp_sgd.add_noise_to_grads(pm.spec, lay, _zeros(pm.spec), T(stds),
                                    seed=0, step=0)
    want = JSGD.add_noise_to_grads(
        jm.spec, jm.layout, jax.tree_util.tree_map(
            lambda t: jnp.zeros(t.shape), _zeros(pm.spec)),
        jnp.asarray(stds), key)
    assert_trees_close(got, want, atol_frac=0, rtol=1e-6)
    # the rule itself: column block m of layer l has std[offset + l M + m]
    w = got["dense_blocks"]["attn"]["qkv"]["w"]  # (2, 64, 128), M = 4
    zw = z["dense_blocks/attn/qkv/w"]
    grp = lay.group("dense_blocks/attn/qkv")
    for layer in range(2):
        for m in range(4):
            cols = slice(32 * m, 32 * (m + 1))
            np.testing.assert_allclose(
                w[layer, :, cols].numpy(),
                zw[layer, :, cols] * stds[grp.offset + 4 * layer + m],
                rtol=1e-6)


# ---------------------------------------------------------------------------
# Full noised steps.
# ---------------------------------------------------------------------------


def _reference_draws(spec, num_groups, key, step):
    """The reference step's noise: per leaf, normal(fold_in(k_noise,
    stable_hash(path))); for the counts, normal(k_q, (K,))."""
    k_noise, k_q = jax.random.split(jax.random.fold_in(key, step))
    z = {"/".join(path): np.array(jax.random.normal(
        jax.random.fold_in(k_noise, JS.stable_hash("/".join(path))),
        p.shape, jnp.float32)) for path, p in JS._walk(spec)}
    return z, np.array(jax.random.normal(k_q, (num_groups,), jnp.float32))


@pytest.mark.parametrize("engine,rescale", [("kernels", None),
                                            ("plain", 2.0)])
def test_two_per_shard_steps_match_reference_with_its_draws(engine, rescale,
                                                             monkeypatch):
    """per_shard is per_layer over the blocked layout (tiny, M = 4: 27
    groups); the reference runs its xla engine. rescale: the Appendix A.1
    global threshold rescale."""
    pm, jm = _blocked("tiny", 4)
    assert pm.layout.num_groups == 27
    tree = bridge.numpy_params(pm.spec, seed=0)
    kw = dict(mode="per_layer", sigma=0.7, sampling_rate=0.05, steps=10,
              init_threshold=0.5, noise_strategy="weighted",
              threshold_rescale=rescale)
    j_init, j_step, j_plan = JSGD.make_dp_train_step(
        jm.loss_fn, jm.spec, jm.layout, joptim.sgd(0.05, momentum=0.9),
        JSGD.DPConfig(backend="xla", **kw), batch_size=4)
    p_init, p_step, p_plan = dp_sgd.make_dp_train_step(
        pm.loss_fn, pm.spec, pm.layout, optim.sgd(0.05, momentum=0.9),
        dp_sgd.DPConfig(backend=engine, **kw), batch_size=4)
    assert (p_plan.sigma, p_plan.sigma_b, p_plan.sigma_new) == (
        j_plan.sigma, j_plan.sigma_b, j_plan.sigma_new)
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
            cur["z"], cur["zq"] = _reference_draws(jm.spec, 27, key, s)
            batch = _batch(pm.cfg.vocab_size, b=4, seed=20 + s)
            jp, jo, jd, jmet = step(jp, jo, jd, _j(batch), key)
            pp, po, pd, pmet = p_step(pp, po, pd, _t(batch), 0)
            np.testing.assert_allclose([float(x) for x in pmet],
                                       [float(x) for x in jmet], rtol=1e-5)
    assert 0.0 < float(pmet.clip_fraction) < 1.0
    np.testing.assert_allclose(pd.qstate.thresholds.numpy(),
                               np.asarray(jd.qstate.thresholds), rtol=1e-5)
    assert_trees_close(pp, jp, atol_frac=1e-4)
    assert_trees_close(po.momentum, jo.momentum, atol_frac=1e-4)


def test_per_shard_clipped_gradients_match_reference():
    """One per_layer clip over the blocked layout of qwen3-4b-reduced
    (M = 4): loss, (K, B) norms² and every clipped gradient leaf."""
    import functools
    from repro.core.clipping import dp_clipped_gradients as jax_clip
    pm, jm = _blocked("qwen3-4b", 4, reduced=True)
    tree = bridge.numpy_params(pm.spec, seed=0)
    batch = _batch(pm.cfg.vocab_size)
    thr = np.random.default_rng(2).uniform(
        0.05, 2.0, pm.layout.num_groups).astype(np.float32)
    with jax_backend.scoped("xla"):
        want = jax.jit(functools.partial(
            jax_clip, jm.loss_fn, layout=jm.layout, mode="per_layer",
            batch_size=3))(_j(tree), _j(batch), thresholds=jnp.asarray(thr))
    got = dp_clipped_gradients(
        pm.loss_fn, bridge.train_params_from_numpy(tree, "cpu"), _t(batch),
        pm.layout, mode="per_layer", batch_size=3, thresholds=T(thr))
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-6)
    np.testing.assert_allclose(got.norms_sq.numpy(), np.asarray(want.norms_sq),
                               rtol=1e-5, atol=1e-9)
    assert_trees_close(got.grads, want.grads)
    n = got.norms_sq.numpy()
    assert (n > thr[:, None] ** 2).any() and (n < thr[:, None] ** 2).any()



# ---------------------------------------------------------------------------
# Book-keeping over blocked layouts (the reference's linear_blocked recipe).
# ---------------------------------------------------------------------------


def _jax_bk(loss_fn, tree, batch, layout, mode, kw):
    import functools
    from repro.core.clipping import dp_clipped_gradients as jax_clip
    with jax_backend.scoped("xla"):
        return jax.jit(functools.partial(
            jax_clip, loss_fn, layout=layout, mode=mode,
            batch_size=batch_size_of(batch), execution="bk"))(
                _j(tree), _j(batch),
                **{k: jnp.asarray(v) for k, v in kw.items()})


def batch_size_of(batch):
    return next(iter(batch.values())).shape[0]


def _mode_kw(mode, k, rng):
    """The flat threshold, or per_group's assignment of the K groups to
    two supergroups and their thresholds."""
    if mode == "ghost_flat":
        return {"flat_threshold": np.float32(0.05)}
    return {"group_assignment": (np.arange(k) % 2).astype(np.int32),
            "group_thresholds": rng.uniform(0.02, 0.1, 2).astype(np.float32)}


def _port_bk(loss_fn, params, batch, layout, mode, kw, engine="plain"):
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a twopass fallback fails the test
        with backend.scoped(engine):
            return dp_clipped_gradients(
                loss_fn, params, batch, layout, mode=mode,
                batch_size=batch_size_of(batch), execution="bk",
                **{k: torch.as_tensor(v) if isinstance(v, np.ndarray) else
                   float(v) for k, v in kw.items()})


def _held(got, want):
    """f32: norms² and every leaf within 1e-5 of the largest magnitude."""
    close(got.norms_sq, want.norms_sq)
    assert_trees_close(got.grads, want.grads)
    n = got.norms_sq.sum(0).numpy()
    assert np.isfinite(n).all() and (n > 0).all()


@pytest.mark.parametrize("m", [2, 4])
def test_bk_over_blocked_tiny_matches_reference_bk(m):
    pm, jm = _blocked("tiny", m)
    tree = bridge.numpy_params(pm.spec, seed=0)
    batch = _batch(pm.cfg.vocab_size)
    params = bridge.train_params_from_numpy(tree, "cpu")
    rng = np.random.default_rng(m)
    for mode in ("ghost_flat", "per_group"):
        kw = _mode_kw(mode, pm.layout.num_groups, rng)
        _held(_port_bk(pm.loss_fn, params, _t(batch), pm.layout, mode, kw),
              _jax_bk(jm.loss_fn, tree, batch, jm.layout, mode, kw))


def _net_spec(pkg_layers, m, d=8):
    """Two stacked d -> d linears with a bias, blocked into M groups."""
    return {"lin": pkg_layers.linear_spec(d, d, bias=True, stack=(2,),
                                          blocks=m)}


def _port_net(axis):
    def loss_fn(params, batch, th):
        x, lin = batch["x"], params["lin"]
        for w, b, c in zip(lin["w"].unbind(0), lin["b"].unbind(0),
                           th["lin"].unbind(0)):
            x = torch.tanh(DP.dp_linear_blocked(w, b, x, c.T, axis))
        return 0.5 * torch.sum(x.float() ** 2, dim=(1, 2))
    return loss_fn


def _jax_net(axis):
    def loss_fn(params, batch, th):
        def body(x, xs):
            w, b, c = xs
            return jnp.tanh(JDP.dp_linear_blocked(w, b, x, c.T, axis)), None

        lin = params["lin"]
        x, _ = jax.lax.scan(body, batch["x"], (lin["w"], lin["b"], th["lin"]))
        return 0.5 * jnp.sum(x.astype(jnp.float32) ** 2, axis=(1, 2))
    return loss_fn


@pytest.mark.parametrize("m,axis", [(2, "out"), (4, "out"), (2, "in"),
                                    (4, "in")])
def test_bk_over_blocked_net_matches_reference_bk(m, axis):
    """A bias along 'out' clips with its column blocks, along 'in' whole
    with block 0; the layers are a stack of two (two epilogue slices)."""
    layout = S.GroupLayout(_net_spec(L, m))
    jlayout = JS.GroupLayout(_net_spec(JL, m))
    rng = np.random.default_rng(10 * m + len(axis))
    tree = {"lin": {"w": (0.6 * rng.standard_normal((2, 8, 8))
                          ).astype(np.float32),
                    "b": (0.3 * rng.standard_normal((2, 8))
                          ).astype(np.float32)}}
    batch = {"x": rng.standard_normal((3, 5, 8)).astype(np.float32)}
    params = bridge.train_params_from_numpy(tree, "cpu")
    for mode in ("ghost_flat", "per_group"):
        kw = _mode_kw(mode, layout.num_groups, rng)
        got = _port_bk(_port_net(axis), params, _t(batch), layout, mode, kw)
        want = _jax_bk(_jax_net(axis), tree, batch, jlayout, mode, kw)
        _held(got, want)
        assert got.norms_sq.shape == (2 * m, 3)


def test_bk_over_blocked_layout_calls_from_the_layout(monkeypatch):
    """Under the kernels engine: the capture's norms by
    ghost_norm_blocked once a blocked linear, the epilogue's blocked
    leaves by clip_reduce with (B, M) factors once a stack slice (the
    other linears: ghost_norm, and one scale_contract a stacked leaf),
    equal to the plain engine's."""
    pm, _ = _blocked("qwen3-4b", 4, reduced=True)
    tree = bridge.numpy_params(pm.spec, seed=0)
    batch = _t(_batch(pm.cfg.vocab_size))
    params = bridge.train_params_from_numpy(tree, "cpu")
    from repro_torch.kernels import bk as KBK
    calls = dict.fromkeys(["blocked", "clip_reduce", "ghost_norm",
                           "scale_contract"], 0)

    def count(name, mod, attr):
        real = getattr(mod, attr)

        def wrapped(*a, **k):
            calls[name] += 1
            if name == "clip_reduce":
                assert a[2].shape == (a[0].shape[0], 4)  # (B, M) factors
            return real(*a, **k)
        monkeypatch.setattr(mod, attr, wrapped)

    count("blocked", GN, "ghost_norm_blocked")
    count("ghost_norm", GN, "ghost_norm")
    count("clip_reduce", CR, "clip_reduce")
    count("scale_contract", KBK, "scale_contract")
    kw = {"flat_threshold": np.float32(0.05)}
    got = _port_bk(pm.loss_fn, params, batch, pm.layout, "ghost_flat", kw,
                   engine="kernels")
    n = pm.cfg.num_layers
    # qkv and o blocked in each layer; gate_up, down and the head not
    assert calls == {"blocked": 2 * n, "clip_reduce": 2 * n,
                     "ghost_norm": 2 * n + 1, "scale_contract": 3}
    want = _port_bk(pm.loss_fn, params, batch, pm.layout, "ghost_flat", kw)
    close(got.norms_sq, want.norms_sq.numpy())
    assert_trees_close(got.grads, want.grads)
