"""The ghost_norm, ghost_norm_blocked, clip_reduce and scale_contract
wrappers, and their kernels on the card.

* On a CPU tensor each wrapper is its plain version and counts no launch;
  on another non-CUDA device it raises.
* The input checks refuse what the kernels do not take (dtype, rank,
  mismatched S, B or T, mixed devices, non-contiguous inputs, factors
  that are not float32 of the batch shape, block factors whose M does
  not match or divide the blocked axis, a bad block axis), and accept
  every main-path shape of qwen3-4b and granite-moe-3b-a800m.
* On a Hopper card (`-m cuda`; skipped elsewhere): each kernel against its
  plain version over ragged T, T = 1, din != dout, f32 and bf16, granite's
  router (1536 -> 40, the split over examples) and an odd dout past 4,096
  (plain loads instead of TMA), scale_contract over S in {1, 3} and its
  3-D form, clip_reduce with (B, M) block factors on both axes (M = 1 / 4
  / 16, o's 160-wide blocks), ghost_norm_blocked over both block axes and
  M in {1, 2, 4, 16} (blocks of 24 columns: a multiple of 8, not of 16),
  the ghost norms at T = 1024 (one chunk of the shared operand, five
  chains); two calls of each contraction and of each ghost norm bitwise
  equal; the ghost norms' C entry points size the workspace as
  `ghost_norm.plan`.

Only torch and numpy: these tests run where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.ghost import blocked_operands
from repro_torch.kernels import bk as SC
from repro_torch.kernels import clip_reduce as CR
from repro_torch.kernels import ghost_norm as GN

T = torch.from_numpy
FACTORS = np.array([0.0, 1e-3, 0.5, 1.0, 0.25], np.float32)
# B, T, din, dout: ragged T against the 32-row tiles, T = 1, din != dout
# both ways, features narrower and wider than a tile
KERNEL_SHAPES = [(2, 5, 7, 9), (3, 1, 16, 8), (2, 37, 20, 45),
                 (4, 16, 33, 12), (1, 9, 64, 3)]


def _ag(b, t, din, dout, seed=0):
    rng = np.random.default_rng(seed + 7 * t + din)
    return (rng.standard_normal((b, t, din)).astype(np.float32),
            rng.standard_normal((b, t, dout)).astype(np.float32))


def test_wrappers_on_cpu_are_the_plain_versions_and_count_nothing():
    a, g = (T(v) for v in _ag(3, 6, 5, 7))
    f = T(FACTORS[:3])
    before = (GN.launches, CR.launches)
    assert torch.equal(GN.ghost_norm(a, g), GN.ghost_norm_ref(a, g))
    assert torch.equal(CR.clip_reduce(a, g, f), CR.clip_reduce_ref(a, g, f))
    assert (GN.launches, CR.launches) == before


def test_ghost_norm_blocked_on_cpu_is_its_plain_version():
    """On CPU tensors: the plain version, no launch counted; M = 1 is the
    whole layer's norm; the blocks of either axis partition it."""
    a, g = (T(v) for v in _ag(3, 6, 8, 12))
    before = (GN.launches, GN.blocked_launches)
    for m, axis in ((1, "out"), (4, "out"), (2, "in"), (4, "in")):
        got = GN.ghost_norm_blocked(a, g, m, block_axis=axis)
        assert torch.equal(got, GN.ghost_norm_blocked_ref(a, g, m, axis))
        assert got.shape == (3, m)
        torch.testing.assert_close(got.sum(-1), GN.ghost_norm_ref(a, g),
                                   rtol=1e-5, atol=1e-5)
    assert (GN.launches, GN.blocked_launches) == before
    with pytest.raises(ValueError, match="no kernel"):
        GN.ghost_norm_blocked(a.to("meta"), g.to("meta"), 2)
    with pytest.raises(ValueError, match="num_blocks must be >= 1"):
        GN.ghost_norm_blocked(a, g, 0)


def test_blocked_operands_follow_the_axis():
    a, g = (T(v) for v in _ag(2, 4, 6, 8))
    s, x = blocked_operands(a, g, 4, "out")
    assert s is a and x is g
    s, x = blocked_operands(a, g, 3, "in")
    assert s is g and x is a


def _sag(s, b, t, din, dout, seed=0):
    rng = np.random.default_rng(seed + 11 * t + din)
    return (T(rng.standard_normal((s, b, t, din)).astype(np.float32)),
            T(rng.standard_normal((s, b, t, dout)).astype(np.float32)),
            T(np.resize(FACTORS, (s, b)).astype(np.float32)))


def test_scale_contract_on_cpu_is_its_plain_version_and_counts_nothing():
    a, g, f = _sag(3, 2, 5, 6, 4)
    before = SC.launches
    assert torch.equal(SC.scale_contract(a, g, f),
                       SC.scale_contract_ref(a, g, f))
    assert torch.equal(SC.scale_contract(a[1], g[1], f[1]),
                       CR.clip_reduce_ref(a[1], g[1], f[1]))
    assert SC.launches == before
    # slice s is clip_reduce of slice s
    want = torch.stack([CR.clip_reduce_ref(a[s], g[s], f[s])
                        for s in range(3)])
    torch.testing.assert_close(SC.scale_contract_ref(a, g, f), want,
                               rtol=1e-6, atol=1e-6)


def test_wrappers_refuse_other_devices():
    a, g = (T(v).to("meta") for v in _ag(3, 6, 5, 7))
    with pytest.raises(ValueError, match="no kernel"):
        GN.ghost_norm(a, g)
    with pytest.raises(ValueError, match="no kernel"):
        CR.clip_reduce(a, g, torch.ones(3, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        SC.scale_contract(a[None], g[None], torch.ones(1, 3, device="meta"))


def _valid():
    a, g = (T(v) for v in _ag(3, 6, 5, 7))
    return [a, g, T(FACTORS[:3].copy())]


BAD_INPUTS = {
    "float16": lambda a: [a[0].half(), a[1].half(), a[2]],
    "mixed_dtype": lambda a: [a[0].bfloat16(), a[1], a[2]],
    "non_contiguous": lambda a: [a[0].transpose(0, 1).contiguous()
                                 .transpose(0, 1), a[1], a[2]],
    "batch_mismatch": lambda a: [a[0][:2], a[1], a[2]],
    "seq_mismatch": lambda a: [a[0][:, :4], a[1], a[2]],
    "rank_2": lambda a: [a[0][:, 0], a[1][:, 0], a[2]],
    "mixed_devices": lambda a: [a[0], a[1].to("meta"), a[2]],
}
BAD_FACTORS = {
    "factors_bf16": lambda a: a[:2] + [a[2].bfloat16()],
    "factors_shape": lambda a: a[:2] + [a[2][:2]],
    "factors_device": lambda a: a[:2] + [a[2].to("meta")],
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_ghost_norm_checks_raise(case):
    args = BAD_INPUTS[case](_valid())
    with pytest.raises(ValueError, match="ghost_norm"):
        GN._check(args[0], args[1])


@pytest.mark.parametrize("case", sorted({**BAD_INPUTS, **BAD_FACTORS}))
def test_clip_reduce_checks_raise(case):
    args = {**BAD_INPUTS, **BAD_FACTORS}[case](_valid())
    with pytest.raises(ValueError, match="clip_reduce"):
        CR._check(*args)


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_ghost_norm_blocked_checks_raise(case):
    args = BAD_INPUTS[case](_valid())
    with pytest.raises(ValueError, match="ghost_norm_blocked"):
        GN._check(args[0], args[1], "ghost_norm_blocked")


def _valid4():
    return list(_sag(2, 3, 6, 5, 7))


SC_BAD = {
    "float16": lambda a: [a[0].half(), a[1].half(), a[2]],
    "mixed_dtype": lambda a: [a[0].bfloat16(), a[1], a[2]],
    "non_contiguous": lambda a: [a[0].transpose(1, 2).contiguous()
                                 .transpose(1, 2), a[1], a[2]],
    "stack_mismatch": lambda a: [a[0][:1], a[1], a[2]],
    "batch_mismatch": lambda a: [a[0][:, :2], a[1], a[2]],
    "seq_mismatch": lambda a: [a[0][:, :, :4], a[1], a[2]],
    "rank_mismatch": lambda a: [a[0][0], a[1], a[2]],
    "rank_2": lambda a: [a[0][0, :, 0], a[1][0, :, 0], a[2][0]],
    "mixed_devices": lambda a: [a[0], a[1].to("meta"), a[2]],
    "factors_bf16": lambda a: a[:2] + [a[2].bfloat16()],
    "factors_shape": lambda a: a[:2] + [a[2][0]],
    "factors_device": lambda a: a[:2] + [a[2].to("meta")],
    "factors_non_contiguous": lambda a: a[:2] + [a[2].T.contiguous().T],
}


@pytest.mark.parametrize("case", sorted(SC_BAD))
def test_scale_contract_checks_raise(case):
    args = SC_BAD[case](_valid4())
    with pytest.raises(ValueError, match="scale_contract"):
        SC._check(*args)


def test_checks_accept_the_main_path_shapes():
    # qwen3-4b, B = 8, T = 256: the head's (2560 -> 151,936) is the widest
    a = torch.empty((8, 256, 2560), dtype=torch.bfloat16)
    g = torch.empty((8, 256, 151_936), dtype=torch.bfloat16)
    GN._check(a, g)
    CR._check(a, g, torch.ones(8))
    SC._check(a, g, torch.ones(8))  # the head's epilogue, 3-D form
    # the stacked gate_up of the BK epilogue: (36, 8, 256, 2560 -> 19,456)
    a4 = torch.empty((36, 8, 256, 2560), dtype=torch.bfloat16)
    g4 = torch.empty((36, 8, 256, 19_456), dtype=torch.bfloat16)
    SC._check(a4, g4, torch.ones(36, 8))
    # bf16: 3 tiles of 128 rows per example, S's 40 boxes in 5 chunks and
    # g's 96 in 5 (8 x 3 x 5 = 120 blocks a phase on 132 SMs); f32: 36
    # pairs of 32-row tiles per example
    assert GN.plan(8, 256, 2560, 6144) == (3, 5, 5, 2_359_416, 288)
    # per_shard (M = 16): qkv (2560 -> 6144) and o (4096 -> 2560) blocks
    for din, dout in ((2560, 6144), (4096, 2560)):
        a = torch.empty((8, 256, din), dtype=torch.bfloat16)
        g = torch.empty((8, 256, dout), dtype=torch.bfloat16)
        GN._check(a, g, "ghost_norm_blocked")
        s, x = blocked_operands(a, g, 16, "out")
        assert x.shape[-1] // 16 in (384, 160)


BAD_BLOCK_FACTORS = {
    # (B, M) factors: a wrong batch, an M that does not divide the axis
    # (dout = 7, din = 5), a bad axis
    "blocks_batch": (lambda a: a[:2] + [torch.ones(2, 7)], "out",
                     "must be"),
    "blocks_divide_out": (lambda a: a[:2] + [torch.ones(3, 2)], "out",
                          "must divide the out axis"),
    "blocks_divide_in": (lambda a: a[:2] + [torch.ones(3, 2)], "in",
                         "must divide the in axis"),
    "blocks_rank_3": (lambda a: a[:2] + [torch.ones(3, 7, 1)], "out",
                      "must be"),
    "blocks_axis": (lambda a: a[:2] + [torch.ones(3, 7)], "rows",
                    "block_axis must be"),
    "blocks_bf16": (lambda a: a[:2] + [torch.ones(3, 7).bfloat16()], "out",
                    "float32"),
}


@pytest.mark.parametrize("case", sorted(BAD_BLOCK_FACTORS))
def test_clip_reduce_refuses_bad_block_factors(case):
    make, axis, msg = BAD_BLOCK_FACTORS[case]
    args = make(_valid())
    with pytest.raises(ValueError, match=msg):
        CR._check(*args, axis)


# (B, T, din, dout) of every linear a step clips (B = 8, T = 256) and its
# (B, M) block factors: qwen3-4b's qkv, o, gate_up, down and head (qkv and
# o blocked by M = 16 under per_shard), granite-moe-3b-a800m's qkv, o,
# router (1536 -> 40) and head (1536 -> 49,155, odd)
MAIN_LINEARS = [(2560, 6144, 16), (4096, 2560, 16), (2560, 19_456, 1),
                (9728, 2560, 1), (2560, 151_936, 1), (1536, 2560, 16),
                (1536, 1536, 16), (1536, 40, 1), (1536, 49_155, 1)]


@pytest.mark.parametrize("din,dout,m", MAIN_LINEARS)
def test_clip_reduce_checks_accept_every_main_path_linear(din, dout, m):
    a = torch.empty((8, 256, din), dtype=torch.bfloat16)
    g = torch.empty((8, 256, dout), dtype=torch.bfloat16)
    CR._check(a, g, torch.ones(8))
    SC._check(a, g, torch.ones(8))
    for axis in ("out", "in"):
        CR._check(a, g, torch.ones(8, m), axis)
        CR._check(a.float(), g.float(), torch.ones(8, m), axis)


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0)[0] != 9:
        pytest.skip("needs compute capability 9.x (Hopper)")


# + granite's router (1536 -> 40: 12 tiles, split over the examples), an
# odd dout past 4,096 (g's rows unaligned: plain loads, not TMA) and T =
# 1024 (the ghost norm's one-chunk plan, five chains of 512 features)
CARD_SHAPES = KERNEL_SHAPES + [(8, 256, 256, 384), (2, 100, 130, 260),
                               (8, 256, 1536, 40), (2, 70, 192, 4097),
                               (4, 1024, 2304, 2560)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_match_plain_versions_on_card(shape, dtype):
    """Identical inputs on the card; only the f32 summation order differs:
    rtol 1e-4, atol 1e-4 of the largest magnitude of the plain result."""
    _on_card()
    a, g = (T(v).to("cuda", getattr(torch, dtype)) for v in _ag(*shape))
    f = T(np.resize(FACTORS, shape[0])).cuda()
    before = (GN.launches, CR.launches)
    n = GN.ghost_norm(a, g)
    s = CR.clip_reduce(a, g, f)
    torch.cuda.synchronize()
    assert (GN.launches, CR.launches) == (before[0] + 1, before[1] + 1)
    for got, want in ((n, GN.ghost_norm_ref(a, g)),
                      (s, CR.clip_reduce_ref(a, g, f))):
        atol = 1e-4 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)


# S, B, T, din, dout: S = 1 and 3, ragged T, T = 1, din != dout both ways
SC_CARD_SHAPES = [(1, 2, 5, 7, 9), (3, 3, 1, 16, 8), (3, 2, 37, 20, 45),
                  (1, 8, 256, 256, 384), (3, 2, 100, 130, 260),
                  (2, 8, 256, 1536, 40), (2, 2, 70, 192, 4097)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SC_CARD_SHAPES)
def test_scale_contract_matches_plain_version_on_card(shape, dtype):
    """Identical inputs on the card, the stacked form and the 3-D form of
    slice 0; only the f32 summation order differs: rtol 1e-4, atol 1e-4
    of the largest magnitude of the plain result."""
    _on_card()
    a, g, f = (x.cuda() for x in _sag(*shape))
    a, g = a.to(getattr(torch, dtype)), g.to(getattr(torch, dtype))
    before = SC.launches
    got, got3 = SC.scale_contract(a, g, f), SC.scale_contract(a[0], g[0],
                                                              f[0])
    torch.cuda.synchronize()
    assert SC.launches == before + 2
    want = SC.scale_contract_ref(a, g, f)
    for x, w in ((got, want), (got3, want[0])):
        atol = 1e-4 * float(w.abs().max())
        torch.testing.assert_close(x, w, rtol=1e-4, atol=atol)


# B, T, din, dout, M, axis: ragged T, T = 1, both axes, blocks narrower
# and wider than a 32-column chunk, M = 1, the o shape of per_shard and
# 24-column blocks (TMA's 4-D map with 48-byte strides, two k16 steps)
BLOCKED_CARD_CASES = [(2, 37, 24, 40, 4, "out"), (3, 1, 16, 8, 2, "in"),
                      (2, 70, 48, 40, 4, "out"), (1, 9, 64, 20, 4, "in"),
                      (2, 33, 20, 45, 1, "out"), (8, 256, 512, 160, 16, "out"),
                      (4, 64, 256, 384, 16, "out")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BLOCKED_CARD_CASES)
def test_ghost_norm_blocked_matches_plain_version_on_card(case, dtype):
    """Identical inputs on the card; only the f32 summation order differs:
    rtol 1e-4, atol 1e-4 of the largest magnitude of the plain result."""
    _on_card()
    b, t, din, dout, m, axis = case
    a, g = (T(v).to("cuda", getattr(torch, dtype))
            for v in _ag(b, t, din, dout))
    before = GN.blocked_launches
    got = GN.ghost_norm_blocked(a, g, m, block_axis=axis)
    torch.cuda.synchronize()
    assert GN.blocked_launches == before + 1
    want = GN.ghost_norm_blocked_ref(a, g, m, axis)
    atol = 1e-4 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)


# B, T, din, dout, M, axis: (B, M) block factors along dout and din, M = 1
# / 4 / 16, o's blocks of per_shard (160 wide, not a multiple of the
# 128-wide tile), ragged T and a block axis of odd width
BLOCK_FACTOR_CASES = [(3, 37, 64, 2560, 16, "out"), (3, 37, 2560, 64, 16,
                                                     "in"),
                      (2, 64, 320, 160, 4, "out"), (2, 64, 160, 96, 4, "in"),
                      (4, 33, 96, 130, 1, "out"), (2, 9, 45, 40, 1, "in"),
                      (2, 5, 135, 24, 3, "in")]


def _block_factors(b, m, seed=0):
    rng = np.random.default_rng(seed + b * 31 + m)
    f = rng.choice(np.array([0.0, 1e-3, 0.5, 1.0, 0.25], np.float32),
                   size=(b, m))
    return T(f.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BLOCK_FACTOR_CASES)
def test_clip_reduce_block_factors_match_plain_version_on_card(case, dtype):
    """(B, M) factors in the kernel's f32 epilogue against the plain
    version's f32 fold + einsum; rtol 1e-4, atol 1e-4 of the largest
    magnitude of the plain result."""
    _on_card()
    b, t, din, dout, m, axis = case
    a, g = (T(v).to("cuda", getattr(torch, dtype))
            for v in _ag(b, t, din, dout))
    f = _block_factors(b, m).cuda()
    before = CR.launches
    got = CR.clip_reduce(a, g, f, axis)
    torch.cuda.synchronize()
    assert CR.launches == before + 1
    want = CR.clip_reduce_ref(a, g, f, axis)
    atol = 1e-4 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 256, 1536, 40), (8, 256, 512, 640),
                                   (2, 70, 192, 4097)])
def test_contractions_are_bitwise_repeatable_on_card(shape):
    """No atomics: two calls give the same bits, with the split over
    examples (the router), without it, and with plain loads."""
    _on_card()
    a, g = (T(v).to("cuda", torch.bfloat16) for v in _ag(*shape))
    f = T(np.resize(FACTORS, shape[0])).cuda()
    assert torch.equal(CR.clip_reduce(a, g, f), CR.clip_reduce(a, g, f))
    fb = _block_factors(shape[0], 4).cuda() if shape[-1] % 4 == 0 else None
    if fb is not None:
        assert torch.equal(CR.clip_reduce(a, g, fb), CR.clip_reduce(a, g, fb))
    a4, g4, f4 = a[None].expand(2, *a.shape).contiguous(), \
        g[None].expand(2, *g.shape).contiguous(), f[None].repeat(2, 1)
    first = SC.scale_contract(a4, g4, f4)
    assert torch.equal(first, SC.scale_contract(a4, g4, f4))
    # slice s sums in clip_reduce's order
    assert torch.equal(first[1], CR.clip_reduce(a, g, f))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 256, 2560, 6144), (2, 70, 192, 4097),
                                   (4, 1024, 2304, 2560), (3, 37, 20, 45)])
def test_ghost_norms_are_bitwise_repeatable_on_card(shape):
    """No atomics and a plan from the shapes alone: two calls give the same
    bits, by TMA and by plain loads (odd widths), with several chunks and
    with one, and whatever the inputs' alignment."""
    _on_card()
    a, g = (T(v).to("cuda", torch.bfloat16) for v in _ag(*shape))
    assert torch.equal(GN.ghost_norm(a, g), GN.ghost_norm(a, g))
    # an offset of one element: plain loads instead of TMA, the same plan
    a1 = torch.empty(a.numel() + 1, dtype=a.dtype, device="cuda")[1:]
    a1 = a1.view(a.shape).copy_(a)
    assert torch.equal(GN.ghost_norm(a1, g), GN.ghost_norm(a, g))
    for m, axis in ((4, "out"), (2, "in")):
        if (g if axis == "out" else a).shape[-1] % m:
            continue
        assert torch.equal(GN.ghost_norm_blocked(a, g, m, block_axis=axis),
                           GN.ghost_norm_blocked(a, g, m, block_axis=axis))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [1, 0])
def test_gram_workspace_entry_points_match_the_plan(bf16):
    """The C entry points compute the plan's workspace, at the main-path
    shapes, T = 1, T = 1024 and T = 2048."""
    import ctypes

    from repro_torch.kernels import _build
    _on_card()
    gn = _build.load("ghost_norm").ghost_norm_workspace
    gb = _build.load("ghost_norm_blocked").ghost_norm_blocked_workspace
    gn.restype = gb.restype = ctypes.c_longlong
    for b, t, din, dout, m in [(8, 256, 2560, 6144, 16), (8, 256, 4096, 2560,
                                                          16),
                               (8, 256, 2560, 151_936, 1), (8, 256, 1536,
                                                            49_155, 1),
                               (3, 1, 16, 8, 2), (4, 1024, 2304, 2560, 1),
                               (8, 2048, 2560, 6144, 16)]:
        ds, dx = min(din, dout), max(din, dout)  # ghost_norm's (S, X)
        p = GN.plan(b, t, ds, dx)
        assert gn(b, t, ds, dx, bf16) == (p.workspace if bf16
                                          else p.f32_workspace)
        p = GN.plan(b, t, din, dout, m)
        assert gb(b, t, din, dout, m, bf16) == (p.workspace if bf16
                                                else p.f32_workspace)
