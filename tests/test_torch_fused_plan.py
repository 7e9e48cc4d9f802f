"""The plan of the fused norm + clip kernel (`kernels/fused_clip.py:plan`,
as `csrc/fused_norm_clip.cu:make_plan` computes it), on the CPU, where no
kernel runs.

* The plan's blocks cover every (example, output tile) exactly once,
  each block its examples in order, every tile of an example in the same
  round (its norm is complete at that round's barrier).
* The grid fits co-residency at 132 SMs (H100 SXM) and at 114 (H100
  PCIe), over the layers the route rule passes and the main path's.
* The scratch does not grow with B (B = 8, 1024, 16,384 at 1024 x 1024
  and at 1536 -> 40).
* The plan depends on the shapes and the SM count alone.
* A plain-torch emulation of the kernel's rounds (per-tile A_bᵀ G_b, its
  sum of squares, the partials summed in tile order, the factors, the
  splits' tiles summed in split order) against `fused_norm_clip_ref` (f32,
  the same sums in another order: rtol 1e-5, atol 1e-5 of the largest
  magnitude), and against the JAX package's Pallas kernel in interpret
  mode on numpy-seeded inputs (rtol 1e-4, atol 1e-4 of the largest
  magnitude, as `tests/test_kernels.py`) over the cases and the four
  encodings of c of `tests/test_torch_fused_clip.py`.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.fused_clip import fused_norm_clip as jax_fused
from repro_torch.core.ghost import clip_factor
from repro_torch.kernels import fused_clip as FC

from test_torch_fused_clip import CASES, ENCODINGS, _inputs, close

SMS = (132, 114)
# B, T, din, dout: the router of granite-moe-3b-a800m (also at B = 64), the
# route rule's limit (also at B = 1024: 1,024 rounds), 16,384 examples,
# small ragged shapes, one tile
PLAN_SHAPES = [(8, 256, 1536, 40), (64, 256, 1536, 40), (1024, 8, 1024, 1024),
               (8, 256, 1024, 1024), (16384, 1, 64, 40), (3, 37, 20, 45),
               (1, 1, 64, 4096), (5, 300, 200, 130), (1, 1, 1, 1)]
# widths around the route rule's edges (`fits`)
WIDTHS = (1, 8, 40, 64, 129, 200, 640, 1000, 1024, 1536, 1792, 2800, 3500,
          3800, 5300, 5900, 6100)


def example_ranges(b, splits):
    """[lo, hi) of each split's examples, as the kernel computes them."""
    return [(s * b // splits, (s + 1) * b // splits) for s in range(splits)]


def schedule(p, b):
    """block -> rounds -> examples (one, or none in a shorter split's
    last round), as the kernel walks them."""
    ranges = example_ranges(b, p.splits)
    out = []
    for block in range(p.grid):
        lo, hi = ranges[block // p.tiles]
        out.append([[lo + r] if lo + r < hi else [] for r in range(p.rounds)])
    return out


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_covers_every_example_and_tile_once(shape, sms):
    b, t, din, dout = shape
    for dtype in (torch.bfloat16, torch.float32):
        p = FC.plan(b, t, din, dout, dtype, sms)
        assert p.tiles == p.tiles_m * p.tiles_n and p.grid == p.tiles * \
            p.splits
        assert (p.tiles_m - 1) * FC.TILE_M < din <= p.tiles_m * FC.TILE_M
        assert (p.tiles_n - 1) * FC.TILE_N < dout <= p.tiles_n * FC.TILE_N
        assert (p.chunks - 1) * p.rows < t <= p.chunks * p.rows
        assert 1 <= p.splits <= b
        seen, round_of = [], {}
        for block, rounds in enumerate(schedule(p, b)):
            tile = block % p.tiles
            walk = [e for r in rounds for e in r]
            assert walk == sorted(walk)
            for r, examples in enumerate(rounds):
                for e in examples:
                    seen.append((e, tile))
                    # every tile of an example in one round
                    assert round_of.setdefault(e, r) == r
        assert sorted(seen) == [(e, tile) for e in range(b)
                                for tile in range(p.tiles)]
        # the largest split needs every round
        assert max(hi - lo for lo, hi in example_ranges(b, p.splits)) \
            == p.rounds


def test_example_ranges_partition_the_batch_evenly():
    for b in (1, 7, 8, 1024, 16384):
        for s in (1, 3, 8, 132):
            if s > b:
                continue
            r = example_ranges(b, s)
            assert r[0][0] == 0 and r[-1][1] == b
            assert all(hi == nlo for (_, hi), (nlo, _) in zip(r, r[1:]))
            assert max(h - lo for lo, h in r) - min(h - lo for lo, h in r) \
                <= 1


@pytest.mark.parametrize("sms", SMS)
def test_grid_fits_co_residency(sms):
    """Every layer the route rule passes, at B = 1 to 16,384, fits the card
    at OCC blocks a SM; a layer far past the rule does not."""
    shapes = [(din, dout) for din in WIDTHS for dout in WIDTHS
              if FC.fits(din, dout)]
    shapes += [(1536, 40), (1024, 1024)]
    assert len(shapes) > 100
    for din, dout in shapes:
        for b in (1, 8, 1024, 16384):
            p = FC.plan(b, 256, din, dout, torch.bfloat16, sms)
            assert FC.plan_fits(p, sms), (din, dout, b)
            assert p.grid <= FC.OCC * sms and p.tiles <= FC.MAX_TILES
            # the splits fill the card, up to one example each
            assert p.splits == b or p.grid > FC.OCC * sms - p.tiles
    big = FC.plan(8, 256, 8192, 8192, torch.bfloat16, sms)
    assert not FC.fits(8192, 8192) and not FC.plan_fits(big, sms)


@pytest.mark.parametrize("din,dout", [(1024, 1024), (1536, 40)])
def test_scratch_does_not_grow_with_b(din, dout):
    for sms in SMS:
        p = {b: FC.plan(b, 8, din, dout, torch.bfloat16, sms)
             for b in (8, 1024, 16384)}
        assert p[1024].scratch == p[16384].scratch
        splits = max(1, FC.OCC * sms // p[8].tiles)  # the most it takes
        bound = (splits * din * dout if splits > 1 else 0) \
            + 2 * splits * p[8].tiles
        assert all(q.scratch <= bound for q in p.values())
    # two splits at the limit: 8 MB beside dW's 4 MB, where the first
    # kernel took B din dout floats (4.3 GB at B = 1024)
    limit = FC.plan(1024, 8, 1024, 1024, torch.bfloat16, 132)
    assert limit.splits == 2
    assert limit.scratch == 2 * 1024 * 1024 + 2 * 2 * 128


def test_plan_depends_on_shapes_and_sm_count_alone():
    assert list(inspect.signature(FC.plan).parameters) == [
        "b", "t", "din", "dout", "dtype", "sm_count"]
    args = (8, 256, 1536, 40, torch.bfloat16)
    assert FC.plan(*args, 132) == FC.plan(*args, 132)
    assert FC.plan(*args, 132) == (12, 1, 12, 8, 1, 64, 4, 96, 491_712)
    assert FC.plan(*args, 12).splits == 2
    assert FC.plan(8, 256, 1536, 40, torch.float32, 132).chunks == 8


def emulate(a, g, c, extra, p):
    """The kernel's arithmetic in plain torch, f32: per round, each split's
    next example's per-tile A_bᵀ G_b and their sums of squares; after the
    round's barrier n_b as the partials summed in tile order, f_b, and
    acc += f_b tmp per (split, tile); the splits' tiles summed in order."""
    b, _, din = a.shape
    dout = g.shape[-1]
    mp, np_ = p.tiles_m * FC.TILE_M, p.tiles_n * FC.TILE_N
    a32 = F.pad(a.float(), (0, mp - din))
    g32 = F.pad(g.float(), (0, np_ - dout))
    acc = torch.zeros(p.splits, mp, np_)
    n = torch.empty(b)

    def tiles_of(x):  # (tiles, 128, 64) in tile order
        return x.reshape(p.tiles_m, FC.TILE_M, p.tiles_n, FC.TILE_N) \
            .transpose(1, 2).reshape(p.tiles, FC.TILE_M, FC.TILE_N)

    ranges = example_ranges(b, p.splits)
    for r in range(p.rounds):
        tmp, partial = {}, {}
        for s, (lo, hi) in enumerate(ranges):
            e = lo + r
            if e < hi:
                tmp[e] = (s, tiles_of(a32[e].T @ g32[e]))
                partial[e] = (tmp[e][1] ** 2).sum((1, 2))
        for e, (s, tl) in tmp.items():  # past the round's barrier
            total = torch.zeros(())
            for x in partial[e]:  # tile order
                total = total + x
            n[e] = total
            f = clip_factor(c[e], total if extra is None else total + extra[e])
            view = acc[s].reshape(p.tiles_m, FC.TILE_M, p.tiles_n, FC.TILE_N)
            view += f * tl.reshape(p.tiles_m, p.tiles_n, FC.TILE_M,
                                   FC.TILE_N).transpose(1, 2)
    dw = acc[0]
    for s in range(1, p.splits):  # split order
        dw = dw + acc[s]
    return n, dw[:din, :dout]


# SM counts that give one example a split, a few, and one split (1 tile)
EMU_SMS = (132, 3, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sms", EMU_SMS)
@pytest.mark.parametrize("enc", sorted(ENCODINGS))
@pytest.mark.parametrize("case", CASES + [(9, 5, 130, 70)])
def test_emulated_rounds_match_the_plain_version(case, enc, sms, dtype):
    a, g, c, extra = (torch.from_numpy(v) for v in _inputs(*case, enc))
    if dtype == "bfloat16":
        a, g = a.bfloat16(), g.bfloat16()
    p = FC.plan(*case, a.dtype, sms)
    for e in (None, extra):
        got = emulate(a, g, c, e, p)
        want = FC.fused_norm_clip_ref(a, g, c, e)
        close(got[0], want[0].numpy(), rtol=1e-5, atol_frac=1e-5)
        close(got[1], want[1].numpy(), rtol=1e-5, atol_frac=1e-5)


@pytest.mark.parametrize("enc", sorted(ENCODINGS))
@pytest.mark.parametrize("case", CASES)
def test_emulated_rounds_match_the_pallas_kernel(case, enc):
    a, g, c, extra = _inputs(*case, enc)
    p = FC.plan(*case, torch.float32, 1)  # splits and rounds
    for e in (None, extra):
        got = emulate(torch.from_numpy(a), torch.from_numpy(g),
                      torch.from_numpy(c),
                      None if e is None else torch.from_numpy(e), p)
        want = jax_fused(jnp.asarray(a), jnp.asarray(g), jnp.asarray(c),
                         None if e is None else jnp.asarray(e), bt=32,
                         interpret=True)
        for x, w in zip(got, want):
            close(x, np.asarray(w), rtol=1e-4, atol_frac=1e-4)
