"""The plan of the ghost norms' tensor-core path (`kernels/ghost_norm.py:
plan`, as `csrc/gram_mma.cuh:make_plan` computes it), on the CPU, where no
kernel runs.

* The chunks cover every feature of S and of each column block of X
  exactly once, in order, start on 64-feature boxes (where TMA loads
  them) and never cross a block boundary; the plan depends on the shapes
  alone.
* The workspace stays below the inputs' bf16 bytes at the ten main-path
  shapes (qwen3-4b's five linears and two blocked ones, granite's three)
  at T = 256 and at T = 2048.
* A plain-torch emulation of the kernels' three phases (S's 128 x 128
  tiles over the plan's chunks and 512-feature chains, summed in chunk
  order; X's tiles chunk by chunk multiplied into them, doubled off the
  diagonal; the partials summed in order) against `ghost_norm_ref` /
  `ghost_norm_blocked_ref` in f32 (rtol 1e-5, atol 1e-5 of the largest
  magnitude: the same sums in another order), and against the JAX
  package's Pallas kernels in interpret mode on numpy-seeded inputs (rtol
  1e-4, atol 1e-4 of the largest magnitude, as `tests/test_kernels.py`):
  ragged T, T = 1, both block axes, M in {1, 4, 16}.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.ghost_norm import ghost_norm as jax_ghost_norm
from repro.kernels.ghost_norm import ghost_norm_blocked as jax_blocked
from repro_torch.core.ghost import blocked_operands
from repro_torch.kernels import ghost_norm as GN

CHAIN = GN.CHAIN * GN.ATOM  # features of one tensor-core chain

# (din, dout, M) at B = 8: qwen3-4b's qkv, o, gate_up, down and head,
# granite-moe-3b-a800m's qkv, o and head, per_shard's blocked qkv and o
MAIN_SHAPES = [(2560, 6144, 1), (4096, 2560, 1), (2560, 19_456, 1),
               (9728, 2560, 1), (2560, 151_936, 1), (1536, 2560, 1),
               (1536, 1536, 1), (1536, 49_155, 1), (2560, 6144, 16),
               (4096, 2560, 16)]
# (B, T, ds, dx, M): small and main-path plans, the one-chunk branch
# (B tiles >= 132) and a chunk longer than one chain
PLAN_SHAPES = [(3, 37, 20, 45, 1), (2, 1, 7, 130, 1), (8, 256, 2560, 6144, 1),
               (8, 256, 2560, 151_936, 1), (8, 256, 1536, 49_155, 1),
               (8, 256, 2560, 6144, 16), (8, 256, 4096, 2560, 16),
               (4, 64, 256, 384, 16), (2, 100, 130, 96, 2),
               (8, 2048, 2560, 6144, 1), (4, 1024, 2304, 2560, 1)]


def _inputs(b, t, din, dout, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, din)).astype(np.float32),
            rng.standard_normal((b, t, dout)).astype(np.float32))


def _covers(bounds, width):
    """The ranges are whole boxes, in order, and cover [0, width) once."""
    assert bounds[0][0] == 0 and bounds[-1][1] == width
    for (lo, hi), (nlo, _) in zip(bounds, bounds[1:]):
        assert hi == nlo
    assert all(lo < hi and lo % GN.ATOM == 0 for lo, hi in bounds)


@pytest.mark.parametrize("b,t,ds,dx,m", PLAN_SHAPES)
def test_plan_chunks_cover_each_feature_once(b, t, ds, dx, m):
    p = GN.plan(b, t, ds, dx, m)
    nt = -(-t // GN.ROWS)
    assert p.tiles == nt * (nt + 1) // 2
    _covers(GN.chunk_bounds(ds, p.shared_chunks), ds)
    w = dx // m
    seen = []
    for blk in range(m):  # no chunk crosses a block boundary
        bounds = GN.chunk_bounds(w, p.blocked_chunks)
        _covers(bounds, w)
        seen += [(blk * w + lo, blk * w + hi) for lo, hi in bounds]
    assert sum(hi - lo for lo, hi in seen) == dx
    assert [lo for lo, _ in seen] == sorted(lo for lo, _ in seen)
    # one wave where the grid allows: the first phase's blocks fit on 132
    # SMs unless B tiles alone exceed them (then one chunk)
    jobs = b * p.tiles
    assert jobs * p.shared_chunks <= max(GN.WAVE, jobs)
    assert jobs * m * p.blocked_chunks <= max(GN.WAVE, jobs * m)
    # shapes alone decide: no dtype, device or pointer enters the plan
    assert list(inspect.signature(GN.plan).parameters) == ["b", "t", "ds",
                                                           "dx", "m"]
    assert GN.plan(b, t, ds, dx, m) == p


def test_plan_one_chunk_branch_and_f32_pairs():
    # T = 1024 at B = 4: 36 tiles x 4 = 144 blocks, one chunk of S
    assert GN.plan(4, 1024, 2304, 2560)[:3] == (36, 1, 1)
    # the f32 path: pairs of 32-row tiles, per (b, m)
    assert GN.plan(8, 256, 2560, 6144, 16).f32_workspace == 8 * 16 * 36


@pytest.mark.parametrize("t", [256, 2048])
@pytest.mark.parametrize("din,dout,m", MAIN_SHAPES)
def test_workspace_below_the_inputs(din, dout, m, t):
    b = 8
    ds, dx = (min(din, dout), max(din, dout)) if m == 1 else (din, dout)
    p = GN.plan(b, t, ds, dx, m)
    inputs = 2 * b * t * (din + dout)  # bf16 bytes of a and g
    assert 4 * p.workspace < inputs
    assert 4 * p.f32_workspace < inputs


def _tile_gram(v, i, j, lo, hi):
    """One block's 128 x 128 tile of v's gram over features [lo, hi), in
    chains of at most CHAIN features added in f32."""
    r = GN.ROWS
    acc = torch.zeros((r, r), dtype=torch.float32)
    for c0 in range(lo, hi, CHAIN):
        c1 = min(hi, c0 + CHAIN)
        acc = acc + v[i * r:(i + 1) * r, c0:c1] @ v[j * r:(j + 1) * r,
                                                     c0:c1].T
    return acc


def emulate(s, x, m):
    """(B, M) <S_b S_bᵀ, X_b^m X_b^mᵀ> by the kernels' three phases, in
    plain f32 torch, in their order of sums."""
    b, t, ds = s.shape
    dx = x.shape[-1]
    w = dx // m
    p = GN.plan(b, t, ds, dx, m)
    nt = -(-t // GN.ROWS)
    pad = (0, 0, 0, nt * GN.ROWS - t)  # rows past T are zeros
    s32, x32 = F.pad(s.float(), pad), F.pad(x.float(), pad)
    pairs = [(i, j) for i in range(nt) for j in range(i, nt)]
    out = torch.zeros((b, m), dtype=torch.float32)
    for bb in range(b):
        gs = []  # phase 1: the partial tiles of each chunk, in chunk order
        for i, j in pairs:
            parts = [_tile_gram(s32[bb], i, j, lo, hi)
                     for lo, hi in GN.chunk_bounds(ds, p.shared_chunks)]
            tile = parts[0]
            for part in parts[1:]:
                tile = tile + part
            gs.append(tile)
        for mm in range(m):
            xm = x32[bb, :, mm * w:(mm + 1) * w]
            total = torch.zeros((), dtype=torch.float32)
            for k, (i, j) in enumerate(pairs):  # phase 2, then phase 3
                for lo, hi in GN.chunk_bounds(w, p.blocked_chunks):
                    gx = _tile_gram(xm, i, j, lo, hi)
                    total = total + (1.0 if i == j else 2.0) * (gs[k]
                                                                * gx).sum()
            out[bb, mm] = total
    return out


def _close(got, want, rtol):
    atol = rtol * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# B, T, din, dout: ragged T over two and three 128-row tiles, T = 1, din
# < dout and din > dout (S is the narrower), chunks of S and X over
# several boxes, a partial last box
GN_SHAPES = [(2, 150, 200, 72), (3, 1, 24, 130), (1, 300, 96, 100),
             (2, 37, 20, 45)]
# B, T, din, dout, M, axis
BLOCKED_SHAPES = [(2, 150, 96, 64, 4, "out"), (2, 150, 64, 96, 4, "in"),
                  (1, 1, 40, 64, 16, "out"), (2, 37, 48, 20, 1, "in"),
                  (1, 140, 256, 384, 16, "out")]


@pytest.mark.parametrize("shape", GN_SHAPES)
def test_emulated_phases_match_ghost_norm_ref(shape):
    a, g = (torch.from_numpy(v) for v in _inputs(*shape, seed=1))
    got = emulate(*GN.shared_operands(a, g), 1)[:, 0]
    _close(got.numpy(), GN.ghost_norm_ref(a, g).numpy(), 1e-5)


@pytest.mark.parametrize("shape", BLOCKED_SHAPES)
def test_emulated_phases_match_ghost_norm_blocked_ref(shape):
    b, t, din, dout, m, axis = shape
    a, g = (torch.from_numpy(v) for v in _inputs(b, t, din, dout, seed=2))
    got = emulate(*blocked_operands(a, g, m, axis), m)
    _close(got.numpy(), GN.ghost_norm_blocked_ref(a, g, m, axis).numpy(),
           1e-5)


@pytest.mark.parametrize("b,chunks", [(1, 3), (4, 1)])
def test_emulated_phases_chains_and_one_chunk_branch(b, chunks):
    """T = 1024, S 2,200 wide and X 2,304: 36 tiles. At B = 1 three
    chunks of each (12, 12 and 11 boxes of S, two chains each); at B = 4
    one chunk (the branch of B tiles >= 132) of five chains each."""
    a, g = (torch.from_numpy(v) for v in _inputs(b, 1024, 2200, 2304, 3))
    assert GN.plan(b, 1024, 2200, 2304)[:3] == (36, chunks, chunks)
    _close(emulate(a, g, 1)[:, 0].numpy(), GN.ghost_norm_ref(a, g).numpy(),
           1e-5)


@pytest.mark.parametrize("shape", GN_SHAPES)
def test_emulated_phases_match_the_pallas_kernel(shape):
    a, g = _inputs(*shape, seed=5)
    want = np.asarray(jax_ghost_norm(jnp.asarray(a), jnp.asarray(g), bt=32,
                                     dk=32, interpret=True))
    ta, tg = torch.from_numpy(a), torch.from_numpy(g)
    _close(emulate(*GN.shared_operands(ta, tg), 1)[:, 0].numpy(), want, 1e-4)


@pytest.mark.parametrize("shape", BLOCKED_SHAPES)
def test_emulated_blocked_phases_match_the_pallas_kernel(shape):
    b, t, din, dout, m, axis = shape
    a, g = _inputs(b, t, din, dout, seed=6)
    want = np.asarray(jax_blocked(jnp.asarray(a), jnp.asarray(g), m,
                                  block_axis=axis, bt=32, dk=32,
                                  interpret=True))
    ta, tg = torch.from_numpy(a), torch.from_numpy(g)
    _close(emulate(*blocked_operands(ta, tg, m, axis), m).numpy(), want,
           1e-4)
