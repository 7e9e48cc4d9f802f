"""The port's ghost ops, kernels' plain versions, DP primitives and group
layout against the JAX package, on the CPU in float32.

* `ghost_norm_ref` / `clip_reduce_ref` against the reference's Pallas
  kernels run in interpret mode (small tiles, so padding and several tiles
  are exercised) and against `repro.kernels.ref`, over ragged T, T = 1 and
  din != dout;
* every `core/ghost.py` function and path against `repro.core.ghost`,
  including embedding collisions and the three threshold encodings;
* `DPLinear`, `DPEmbed` and `DPScale` forward and backward (param grad,
  input cotangent, norms² as the threshold's gradient) against `jax.vjp`
  of the reference primitives, under both port backends;
* `GroupLayout` (names, offsets, dims, packing) for tiny, qwen3-4b-reduced
  and the full qwen3-4b, built from the spec without allocating.

The wrappers' dispatch and checks, and the kernels on the card, are in
`tests/test_torch_clip_kernels.py` (no JAX needed there).

Tolerances: float32, the same math summed in another order. Norms² and
sums are compared with rtol 1e-5 and an atol of 1e-5 of the largest
magnitude in the reference result, since a sum of many terms of both
signs can cancel to near zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import dp_layers as JDP
from repro.core import ghost as JG
from repro.kernels import ref as JREF
from repro.kernels.clip_reduce import clip_reduce as jax_clip_reduce
from repro.kernels.ghost_norm import ghost_norm as jax_ghost_norm
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.core import dp_layers as DP
from repro_torch.core import ghost as G
from repro_torch.core import spec as S
from repro_torch.kernels import backend
from repro_torch.kernels import clip_reduce as CR
from repro_torch.kernels import ghost_norm as GN
from repro_torch.models.transformer import decoder_spec


def close(got, want, rtol=1e-5, atol_frac=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    atol = atol_frac * max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _ag(b, t, din, dout, seed=0):
    rng = np.random.default_rng(seed + 7 * t + din)
    return (rng.standard_normal((b, t, din)).astype(np.float32),
            rng.standard_normal((b, t, dout)).astype(np.float32))


T = torch.from_numpy
FACTORS = np.array([0.0, 1e-3, 0.5, 1.0, 0.25], np.float32)

# B, T, din, dout: ragged T against the 8-row test tiles, T = 1,
# din != dout both ways, features narrower and wider than a tile
KERNEL_SHAPES = [(2, 5, 7, 9), (3, 1, 16, 8), (2, 37, 20, 45),
                 (4, 16, 33, 12), (1, 9, 64, 3)]


@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_ghost_norm_ref_matches_pallas_kernel_and_ref(shape):
    a, g = _ag(*shape)
    got = GN.ghost_norm_ref(T(a), T(g))
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    close(got, jax_ghost_norm(jnp.asarray(a), jnp.asarray(g), bt=8, dk=16,
                              interpret=True))
    close(got, JREF.ghost_norm_ref(jnp.asarray(a), jnp.asarray(g)))


@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_clip_reduce_ref_matches_pallas_kernel_and_ref(shape):
    a, g = _ag(*shape, seed=1)
    f = FACTORS[: shape[0]]
    got = CR.clip_reduce_ref(T(a), T(g), T(f))
    assert got.dtype == torch.float32 and got.shape == shape[2:]
    close(got, jax_clip_reduce(jnp.asarray(a), jnp.asarray(g), jnp.asarray(f),
                               bi=16, bj=16, bt=8, interpret=True))
    close(got, JREF.clip_reduce_ref(jnp.asarray(a), jnp.asarray(g),
                                    jnp.asarray(f)))


def test_plain_versions_take_bf16_inputs_in_f32():
    """bf16 inputs are read as f32, as the TPU kernels cast each block:
    both sides see the same bf16 values, so f32 tolerances hold."""
    a, g = _ag(2, 11, 24, 40)
    ab, gb = T(a).bfloat16(), T(g).bfloat16()
    ja = jnp.asarray(ab.float().numpy()).astype(jnp.bfloat16)
    jg = jnp.asarray(gb.float().numpy()).astype(jnp.bfloat16)
    close(GN.ghost_norm_ref(ab, gb), JREF.ghost_norm_ref(ja, jg))
    f = FACTORS[:2]
    close(CR.clip_reduce_ref(ab, gb, T(f)),
          JREF.clip_reduce_ref(ja, jg, jnp.asarray(f)))


# ---------------------------------------------------------------------------
# core/ghost.py against repro.core.ghost.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["gram", "gram_chunked", "outer", None])
@pytest.mark.parametrize("shape", [(3, 10, 6, 5), (2, 1, 9, 4),
                                   (2, 13, 40, 50)])
def test_linear_norms_sq_paths(path, shape):
    a, g = _ag(*shape, seed=2)
    kw = dict(force_path=path, gram_chunk=4, outer_max_elems=1000)
    close(G.linear_norms_sq(T(a), T(g), **kw),
          JG.linear_norms_sq(jnp.asarray(a), jnp.asarray(g), **kw))


def test_linear_norms_sq_2d_inputs_are_rank_one():
    a, g = _ag(3, 1, 6, 5)
    close(G.linear_norms_sq(T(a[:, 0]), T(g[:, 0])),
          JG.linear_norms_sq(jnp.asarray(a[:, 0]), jnp.asarray(g[:, 0])))


@pytest.mark.parametrize("args", [(5, 8, 9), (40, 4, 4), (3, 100, 100),
                                  (2000, 2, 2)])
def test_path_costs(args):
    assert G.gram_path_cost(*args) == JG.gram_path_cost(*args)
    assert G.outer_path_cost(*args) == JG.outer_path_cost(*args)


def test_clip_factor_three_encodings():
    c = np.array([0.5, np.inf, -0.25, 2.0, 1e-3, np.inf], np.float32)
    n = np.array([4.0, 9.0, 16.0, 0.25, 0.0, 0.0], np.float32)
    got = G.clip_factor(T(c), T(n))
    close(got, JG.clip_factor(jnp.asarray(c), jnp.asarray(n)), atol_frac=0)
    # without norms: +inf -> 1, c < 0 -> |c|, a finite C > 0 -> NaN
    wn = G.factor_without_norms(T(c)).numpy()
    np.testing.assert_array_equal(wn[[1, 2, 5]], [1.0, 0.25, 1.0])
    assert np.isnan(wn[[0, 3, 4]]).all()


def test_bias_scale_vector_norms_and_sums():
    rng = np.random.default_rng(3)
    g = rng.standard_normal((3, 7, 5)).astype(np.float32)
    xh = rng.standard_normal((3, 7, 5)).astype(np.float32)
    f = FACTORS[:3]
    jg, jx, jf = jnp.asarray(g), jnp.asarray(xh), jnp.asarray(f)
    close(G.bias_norms_sq(T(g)), JG.bias_norms_sq(jg))
    close(G.scale_norms_sq(T(xh), T(g)), JG.scale_norms_sq(jx, jg))
    close(G.vector_norms_sq(T(g)), JG.vector_norms_sq(jg))
    close(G.clipped_sum_bias(T(g), T(f)), JG.clipped_sum_bias(jg, jf))
    close(G.clipped_sum_scale(T(xh), T(g), T(f)),
          JG.clipped_sum_scale(jx, jg, jf))
    a, g2 = _ag(3, 6, 4, 5)
    close(G.clipped_sum_linear(T(a), T(g2), T(f)),
          JG.clipped_sum_linear(jnp.asarray(a), jnp.asarray(g2), jf))


@pytest.mark.parametrize("chunk", [4, 1024])
def test_embed_norms_and_sum_are_collision_exact(chunk):
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 6, (3, 11)).astype(np.int32)  # many repeats
    ids[0, :] = 2  # one example of a single repeated token
    g = rng.standard_normal((3, 11, 8)).astype(np.float32)
    f = FACTORS[:3]
    got = G.embed_norms_sq(T(ids), T(g), gram_chunk=chunk)
    close(got, JG.embed_norms_sq(jnp.asarray(ids), jnp.asarray(g),
                                 gram_chunk=chunk))
    # collision-exact: the norm of the materialized per-example table grad
    for b in range(3):
        table = np.zeros((6, 8), np.float64)
        np.add.at(table, ids[b], g[b])
        np.testing.assert_allclose(float(got[b]), np.sum(table ** 2),
                                   rtol=1e-5)
    close(G.clipped_sum_embed(T(ids), T(g), T(f), 6),
          JG.clipped_sum_embed(jnp.asarray(ids), jnp.asarray(g),
                               jnp.asarray(f), 6))


# ids, rows, segments: a single id, every id distinct, a padding-heavy
# batch (id 0 repeated, as the padded rows of a Poisson batch), runs longer
# than a power of two, empty segments, an empty input
SEGMENT_CASES = [(1, 1, 3), (64, 64, 64), (2048, 40, 3000),
                 (333, 5, 300), (17, 257, 16), (0, 4, 2)]


@pytest.mark.parametrize("n,num,d", SEGMENT_CASES)
def test_segment_sum_matches_reference(n, num, d):
    """The port's fixed-order segment sum (sort, segmented scan) against
    `jax.ops.segment_sum` and `.at[].add`, with repeated ids; equal in f32
    up to the order of summation."""
    rng = np.random.default_rng(n + num)
    ids = rng.integers(0, num, n).astype(np.int32)
    if n > 100:
        ids[: n // 2] = 0
    v = rng.standard_normal((n, d)).astype(np.float32)
    got = G.segment_sum(T(v), T(ids), num)
    want = jax.ops.segment_sum(jnp.asarray(v), jnp.asarray(ids), num)
    assert got.shape == (num, d) and got.dtype == torch.float32
    if n:
        close(got, want)
        close(got, jnp.zeros((num, d)).at[jnp.asarray(ids)].add(v))
    else:
        assert not got.any()
    # a stable sort and fixed passes: two calls give the same bits
    assert torch.equal(got, G.segment_sum(T(v), T(ids), num))


def test_supergroup_norms_and_embed_sum_match_reference():
    """Both former `index_add_` sites against the reference's forms:
    per_group's supergroup norms² (`jax.ops.segment_sum` of the (K, B)
    group norms²) and the embedding's clipped sum, with repeated ids."""
    from repro_torch.core.clipping import supergroup_norms
    rng = np.random.default_rng(11)
    norms = rng.uniform(0, 3, (15, 6)).astype(np.float32)
    assign = rng.integers(0, 4, 15).astype(np.int32)
    assign[:3] = 3
    close(supergroup_norms(T(norms), T(assign), 5),
          jax.ops.segment_sum(jnp.asarray(norms), jnp.asarray(assign), 5))
    ids = np.zeros((4, 64), np.int32)  # padding rows: one id throughout
    ids[:2] = rng.integers(0, 9, (2, 64))
    g = rng.standard_normal((4, 64, 16)).astype(np.float32)
    f = FACTORS[:4]
    close(G.clipped_sum_embed(T(ids), T(g), T(f), 9),
          JG.clipped_sum_embed(jnp.asarray(ids), jnp.asarray(g),
                               jnp.asarray(f), 9))


# ---------------------------------------------------------------------------
# DP primitives against jax.vjp of the reference.
# ---------------------------------------------------------------------------

C_MIX = np.array([0.3, np.inf, -0.5, 2.0], np.float32)  # clip/pass/scale


def _grads(out, inputs, gy):
    return torch.autograd.grad(out, inputs, grad_outputs=gy)


@pytest.mark.parametrize("engine", ["plain", "kernels"])
@pytest.mark.parametrize("bias", [False, True])
def test_dp_linear_matches_reference_vjp(engine, bias):
    rng = np.random.default_rng(5)
    w = (0.3 * rng.standard_normal((6, 9))).astype(np.float32)
    b = rng.standard_normal((9,)).astype(np.float32) if bias else None
    x = rng.standard_normal((4, 5, 6)).astype(np.float32)
    gy = rng.standard_normal((4, 5, 9)).astype(np.float32)
    y_j, vjp = jax.vjp(JDP.dp_linear, jnp.asarray(w),
                       None if b is None else jnp.asarray(b),
                       jnp.asarray(x), jnp.asarray(C_MIX))
    dw_j, db_j, dx_j, dc_j = vjp(jnp.asarray(gy))
    tw, tx, tc = (T(v).requires_grad_() for v in (w, x, C_MIX))
    tb = T(b).requires_grad_() if bias else None
    with backend.scoped(engine):
        y = DP.dp_linear(tw, tb, tx, tc)
    close(y, y_j)
    ins = [tw, tx, tc] + ([tb] if bias else [])
    got = _grads(y, ins, T(gy))
    close(got[0], dw_j)
    close(got[1], dx_j)
    close(got[2], dc_j)
    if bias:
        close(got[3], db_j)


@pytest.mark.parametrize("engine", ["plain", "kernels"])
def test_dp_embed_matches_reference_vjp(engine):
    rng = np.random.default_rng(6)
    table = rng.standard_normal((11, 4)).astype(np.float32)
    ids = rng.integers(0, 11, (4, 7)).astype(np.int32)
    ids[1, 2:5] = ids[1, 0]  # collisions
    gy = rng.standard_normal((4, 7, 4)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda t, c: JDP.dp_embed(t, jnp.asarray(ids), c),
                       jnp.asarray(table), jnp.asarray(C_MIX))
    dt_j, dc_j = vjp(jnp.asarray(gy))
    tt, tc = T(table).requires_grad_(), T(C_MIX).requires_grad_()
    with backend.scoped(engine):
        y = DP.dp_embed(tt, T(ids), tc)
    close(y, y_j)
    dt, dc = _grads(y, [tt, tc], T(gy))
    close(dt, dt_j)
    close(dc, dc_j)


@pytest.mark.parametrize("engine", ["plain", "kernels"])
def test_dp_scale_matches_reference_vjp(engine):
    rng = np.random.default_rng(7)
    s = rng.standard_normal((5,)).astype(np.float32)
    xh = rng.standard_normal((4, 6, 5)).astype(np.float32)
    gy = rng.standard_normal((4, 6, 5)).astype(np.float32)
    y_j, vjp = jax.vjp(JDP.dp_scale, jnp.asarray(s), jnp.asarray(xh),
                       jnp.asarray(C_MIX))
    ds_j, dx_j, dc_j = vjp(jnp.asarray(gy))
    ts, tx, tc = (T(v).requires_grad_() for v in (s, xh, C_MIX))
    with backend.scoped(engine):
        y = DP.dp_scale(ts, tx, tc)
    close(y, y_j)
    ds, dx, dc = _grads(y, [ts, tx, tc], T(gy))
    close(ds, ds_j)
    close(dx, dx_j)
    close(dc, dc_j)


def test_threshold_without_grad_skips_norms(monkeypatch):
    """+inf thresholds that do not require grad: no norm op runs and the
    weight gradient is the unclipped sum; a finite C poisons it (NaN)."""
    def boom(*a, **k):
        raise AssertionError("a norm op ran")

    monkeypatch.setattr(GN, "ghost_norm", boom)
    monkeypatch.setattr(G, "linear_norms_sq", boom)
    rng = np.random.default_rng(8)
    w = T(rng.standard_normal((6, 9)).astype(np.float32)).requires_grad_()
    x = T(rng.standard_normal((4, 5, 6)).astype(np.float32))
    for engine in ("plain", "kernels"):
        with backend.scoped(engine):
            y = DP.dp_linear(w, None, x, torch.full((4,), float("inf")))
        (dw,) = torch.autograd.grad(y.sum(), [w])
        close(dw, torch.einsum("bti,bto->io", x, torch.ones(4, 5, 9)))
        with backend.scoped(engine):
            y = DP.dp_linear(w, None, x, torch.full((4,), 0.5))
        (dw,) = torch.autograd.grad(y.sum(), [w])
        assert torch.isnan(dw).all()


def test_engine_scope_is_read_in_forward():
    """The backward uses the engine of the forward's scope, even when it
    runs after the scope closed (as on autograd's CUDA device thread)."""
    w = torch.ones((3, 2), requires_grad=True)
    c = torch.full((2,), 0.5, requires_grad=True)
    with backend.scoped("kernels"):
        y = DP.dp_linear(w, None, torch.ones((2, 4, 3)), c)
    assert backend.active().name == "plain"
    before = GN.launches
    torch.autograd.grad(y.sum(), [w, c])
    assert GN.launches == before  # CPU tensors: the plain version, no launch
    with pytest.raises(ValueError, match="unknown ghost backend"):
        backend.make_engine("pallas")


# ---------------------------------------------------------------------------
# GroupLayout.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,reduced", [("tiny", False),
                                          ("qwen3-4b", True),
                                          ("qwen3-4b", False)])
def test_group_layout_matches_reference(arch, reduced):
    """Built from the spec alone: the full qwen3-4b costs no allocation."""
    lay = S.GroupLayout(decoder_spec(get_config(arch, reduced=reduced)))
    ref = jax_build_model(jax_get_config(arch, reduced=reduced)).layout
    assert lay.num_groups == ref.num_groups
    assert [(g.name, g.stack_shape, g.dim, g.offset, g.sensitivity_mult)
            for g in lay.groups] == [
        (g.name, g.stack_shape, g.dim, g.offset, g.sensitivity_mult)
        for g in ref.groups]
    np.testing.assert_array_equal(lay.dims, ref.dims)
    np.testing.assert_array_equal(lay.sens_mults, ref.sens_mults)
    assert lay.flat_names() == ref.flat_names()
    if arch == "qwen3-4b" and not reduced:
        assert lay.num_groups == 8 * 36 + 3
        assert lay.group("dense_blocks/mlp/gate_up").dim == 2560 * 19456


def test_group_layout_packing_matches_reference():
    cfg = get_config("qwen3-4b", reduced=True)
    lay = S.GroupLayout(decoder_spec(cfg))
    ref = jax_build_model(jax_get_config("qwen3-4b", reduced=True)).layout
    rng = np.random.default_rng(9)
    k, b = lay.num_groups, 3
    flat = rng.uniform(0.1, 2.0, k).astype(np.float32)
    rows = rng.uniform(0.1, 2.0, (k, b)).astype(np.float32)
    for got, want in ((lay.pack(T(flat), b), ref.pack(jnp.asarray(flat), b)),
                      (lay.pack_rows(T(rows)), ref.pack_rows(jnp.asarray(rows))),
                      (lay.pack_value(0.7, b), ref.pack_value(0.7, b))):
        assert set(got) == set(want)
        for name in got:
            assert got[name].is_contiguous()
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))
    packed = lay.pack_rows(T(rows))
    np.testing.assert_array_equal(lay.unpack(packed).numpy(), rows)
    assert S.subth(packed, "dense_blocks/attn").keys() == {
        "qkv", "o", "q_norm", "k_norm"}
