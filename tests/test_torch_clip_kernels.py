"""The ghost_norm and clip_reduce wrappers, and their kernels on the card.

* On a CPU tensor each wrapper is its plain version and counts no launch;
  on another non-CUDA device it raises.
* The input checks refuse what the kernels do not take (dtype, rank,
  mismatched B or T, mixed devices, non-contiguous inputs, factors that
  are not float32 (B,)), and accept the main path's widest shapes.
* On a Hopper card (`-m cuda`; skipped elsewhere): each kernel against its
  plain version over ragged T, T = 1, din != dout, f32 and bf16.

Only torch and numpy: these tests run where JAX is not installed.
"""
import numpy as np
import pytest
import torch

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


def test_wrappers_refuse_other_devices():
    a, g = (T(v).to("meta") for v in _ag(3, 6, 5, 7))
    with pytest.raises(ValueError, match="no kernel"):
        GN.ghost_norm(a, g)
    with pytest.raises(ValueError, match="no kernel"):
        CR.clip_reduce(a, g, torch.ones(3, device="meta"))


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


def test_checks_accept_the_main_path_shapes():
    # qwen3-4b, B = 8, T = 256: the head's (2560 -> 151,936) is the widest
    a = torch.empty((8, 256, 2560), dtype=torch.bfloat16)
    g = torch.empty((8, 256, 151_936), dtype=torch.bfloat16)
    GN._check(a, g)
    CR._check(a, g, torch.ones(8))
    assert GN.num_pairs(256) == 36  # 8 * 36 = 288 blocks on 132 SMs


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0)[0] != 9:
        pytest.skip("needs compute capability 9.x (Hopper)")


CARD_SHAPES = KERNEL_SHAPES + [(8, 256, 256, 384), (2, 100, 130, 260)]


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
