"""The port's paged decode attention against the JAX package.

* `paged_attn_ref` (plain PyTorch) against the reference's plain version
  `repro.kernels.ref.paged_attn_ref` and against the Pallas TPU kernel run
  in interpret mode, on numpy-seeded inputs: ragged page tables, partially
  filled last pages, trash-mapped entries and dv < dvp on an aliased pool.
* The wrapper's dispatch (CPU -> plain version, no launch counted) and its
  input checks.
* The CUDA kernel against the plain version, on a Hopper card only.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attn as K


def _jax():
    """The JAX package's paged attention (imported inside the tests, so
    the card-only case also runs where JAX is not installed)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import backend
    from repro.kernels.ref import paged_attn_ref
    return jnp, backend, paged_attn_ref


# b, kv, g, dq, dv, live pool pages, page_len, table pages
SHAPES = [
    (3, 2, 2, 16, None, 7, 8, 3),
    (2, 1, 4, 24, 16, 5, 4, 4),     # aliased pool, value read truncated
    (1, 2, 1, 8, None, 3, 16, 2),
    (4, 1, 1, 4, None, 9, 2, 5),
    (3, 2, 2, 64, None, 9, 16, 4),  # qwen3-4b-reduced head dim
]


def _inputs(b, kv, g, dq, dv, n, page_len, p_tab, seed=0):
    """q, pools with a trash page at index n, a ragged page table whose
    entries past each row's last valid page point at the trash page, and
    positions covering one token, a partial last page and a full table."""
    rng = np.random.default_rng(seed + 31 * dq + b)
    q = rng.standard_normal((b, kv, g, dq)).astype(np.float32)
    kpool = rng.standard_normal((n + 1, page_len, kv, dq)).astype(np.float32)
    vpool = (kpool if dv is not None else
             rng.standard_normal((n + 1, page_len, kv, dq)).astype(np.float32))
    pos = rng.integers(0, p_tab * page_len, size=b).astype(np.int32)
    pos[0] = 0
    pos[-1] = p_tab * page_len - 1
    if b > 2:
        pos[1] = page_len + page_len // 2  # partially filled second page
    pt = rng.integers(0, n, size=(b, p_tab)).astype(np.int32)
    for i in range(b):
        pt[i, pos[i] // page_len + 1:] = n  # trash-mapped tail
    return q, kpool, vpool, pt, pos


def _torch(q, kpool, vpool, pt, pos, dtype=torch.float32):
    tq = torch.from_numpy(q).to(dtype)
    tk = torch.from_numpy(kpool).to(dtype)
    tv = tk if vpool is kpool else torch.from_numpy(vpool).to(dtype)
    return tq, tk, tv, torch.from_numpy(pt), torch.from_numpy(pos)


@pytest.mark.parametrize("shape", SHAPES)
def test_ref_matches_jax_ref(shape):
    """f32: rtol 1e-5, atol 1e-6 (the same math, summed in another
    order)."""
    jnp, _, jax_paged_attn_ref = _jax()
    q, kpool, vpool, pt, pos = _inputs(*shape)
    dq, dv = shape[3], shape[4]
    scale = 1.0 / np.sqrt(dq)
    want = jax_paged_attn_ref(jnp.asarray(q), jnp.asarray(kpool),
                              jnp.asarray(vpool), jnp.asarray(pt),
                              jnp.asarray(pos), scale=scale, dv=dv)
    got = K.paged_attn_ref(*_torch(q, kpool, vpool, pt, pos), scale=scale,
                           dv=dv)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_ref_matches_pallas_kernel_interpret(shape):
    """Against the TPU kernel in interpret mode: atol 1e-5, rtol 1e-5
    (online softmax over pages, and the kernel scales after the f32
    cast)."""
    jnp, backend, _ = _jax()
    q, kpool, vpool, pt, pos = _inputs(*shape)
    dq, dv = shape[3], shape[4]
    scale = 1.0 / np.sqrt(dq)
    pls = backend.make_engine("pallas", interpret=True)
    want = pls.paged_attn(jnp.asarray(q), jnp.asarray(kpool),
                          jnp.asarray(vpool), jnp.asarray(pt),
                          jnp.asarray(pos), scale=scale, dv=dv)
    got = K.paged_attn_ref(*_torch(q, kpool, vpool, pt, pos), scale=scale,
                           dv=dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_ref_matches_jax_ref_bf16():
    """bf16 inputs: atol 2e-3, rtol 2e-3. Both round `q * scale` to bf16
    before the f32 cast; a one-ulp difference in that rounding between
    XLA and torch moves an output by about 1e-3 at most."""
    jnp, _, jax_paged_attn_ref = _jax()
    shape = SHAPES[-1]
    q, kpool, vpool, pt, pos = _inputs(*shape)
    scale = 1.0 / np.sqrt(shape[3])
    bf = jnp.bfloat16
    want = jax_paged_attn_ref(jnp.asarray(q, bf), jnp.asarray(kpool, bf),
                              jnp.asarray(vpool, bf), jnp.asarray(pt),
                              jnp.asarray(pos), scale=scale)
    got = K.paged_attn_ref(*_torch(q, kpool, vpool, pt, pos, torch.bfloat16),
                           scale=scale)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=2e-3, atol=2e-3)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    q, kpool, vpool, pt, pos = _inputs(*SHAPES[1])
    args = _torch(q, kpool, vpool, pt, pos)
    before = K.launches
    got = K.paged_attn(*args, scale=0.25, dv=16)
    want = K.paged_attn_ref(*args, scale=0.25, dv=16)
    assert torch.equal(got, want)
    assert K.launches == before


def test_wrapper_refuses_other_devices():
    q, kpool, vpool, pt, pos = _inputs(*SHAPES[0])
    args = [t.to("meta") for t in _torch(q, kpool, vpool, pt, pos)]
    with pytest.raises(ValueError, match="no kernel"):
        K.paged_attn(*args, scale=0.25)


def _valid_args():
    q, kpool, vpool, pt, pos = _inputs(*SHAPES[0])
    return list(_torch(q, kpool, vpool, pt, pos))


def _mla_latents(a):
    # MLA's 576-wide latents (kv_lora_rank 512 + rope 64), vpool = kpool
    pool = torch.zeros((4, 8, 1, 576))
    return [torch.zeros((2, 1, 16, 576)), pool, pool, a[3][:2], a[4][:2]]


BAD_INPUTS = {
    "mla_576_wide": (_mla_latents, None),
    "dv_over_dvp": (lambda a: a, 17),
    "pt_int64": (lambda a: a[:3] + [a[3].long(), a[4]], None),
    "pos_int64": (lambda a: a[:4] + [a[4].long()], None),
    "mixed_dtype": (lambda a: [a[0].bfloat16()] + a[1:], None),
    "float16": (lambda a: [t.half() if t.is_floating_point() else t
                           for t in a], None),
    "non_contiguous_pool": (
        lambda a: [a[0], a[1].transpose(0, 1).contiguous().transpose(0, 1),
                   a[2], a[3], a[4]], None),
    "kv_mismatch": (lambda a: [a[0][:, :1].contiguous()] + a[1:], None),
    "batch_mismatch": (lambda a: a[:3] + [a[3][:1], a[4]], None),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_wrapper_checks_raise(case):
    make, dv = BAD_INPUTS[case]
    args = make(_valid_args())
    dv = args[2].shape[-1] if dv is None else dv
    with pytest.raises(ValueError, match="paged_attn"):
        K._check(*args, dv)


def test_wrapper_checks_accept_the_main_path_shapes():
    # qwen3-4b: 8 slots, 8 KV heads of 4 query heads, head_dim 128,
    # 136 pages + trash of 16 tokens, 17 table pages
    q = torch.zeros((8, 8, 4, 128), dtype=torch.bfloat16)
    pool = torch.zeros((137, 16, 8, 128), dtype=torch.bfloat16)
    pt = torch.zeros((8, 17), dtype=torch.int32)
    pos = torch.zeros((8,), dtype=torch.int32)
    K._check(q, pool, pool, pt, pos, 128)
    assert K.smem_bytes(4, 128, 128, 17) <= K.MAX_SMEM


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_ref_on_card(shape, dtype):
    """The CUDA kernel against the plain version on the card: atol 1e-4,
    rtol 1e-4 (identical inputs; only the f32 summation order differs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0)[0] != 9:
        pytest.skip("needs compute capability 9.x (Hopper)")
    q, kpool, vpool, pt, pos = _inputs(*shape)
    args = [t.cuda() for t in _torch(q, kpool, vpool, pt, pos,
                                     getattr(torch, dtype))]
    if vpool is kpool:
        args[2] = args[1]
    dv = shape[4]
    scale = 1.0 / np.sqrt(shape[3])
    before = K.launches
    got = K.paged_attn(*args, scale=scale, dv=dv)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    want = K.paged_attn_ref(*args, scale=scale, dv=dv)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
