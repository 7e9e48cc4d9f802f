"""The port's paged decode attention against the JAX package.

* `paged_attn_ref` (plain PyTorch) against the reference's plain version
  `repro.kernels.ref.paged_attn_ref` and against the Pallas TPU kernel run
  in interpret mode, on numpy-seeded inputs: ragged page tables, partially
  filled last pages, trash-mapped entries and dv < dvp on an aliased pool;
  and at MLA's latent widths (dq = 576, dv = 512 on an aliased pool), f32
  throughout and an f32 query over a bf16 pool.
* The wrapper's dispatch (CPU -> plain version, no launch counted) and its
  input checks.
* The CUDA kernel against the plain version, on a Hopper card only: the
  shapes above, MLA's widths, mixed dtypes, contexts of 8 or more splits,
  G off the head group, rows whose bytes are not a multiple of 16; two
  calls bitwise equal; a CUDA-graph replay that follows a new `pos`.
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


def _torch(q, kpool, vpool, pt, pos, dtype=torch.float32, pool_dtype=None):
    pool_dtype = dtype if pool_dtype is None else pool_dtype
    tq = torch.from_numpy(q).to(dtype)
    tk = torch.from_numpy(kpool).to(pool_dtype)
    tv = tk if vpool is kpool else torch.from_numpy(vpool).to(pool_dtype)
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


# MLA's latent decode at small G: KV = 1, dq = kv_lora_rank + rope = 576,
# the value read cut to dv = 512 on the aliased latent pool
MLA_SHAPE = (2, 1, 4, 576, 512, 5, 4, 3)
MLA_DTYPES = {"f32": (torch.float32, torch.float32),
              "f32_q_bf16_pool": (torch.float32, torch.bfloat16)}


def _mla_case(pools):
    """The torch arguments, the same as JAX arrays (one aliased pool each
    side), the JAX backend module and plain version."""
    jnp, backend, jax_ref = _jax()
    q, kpool, vpool, pt, pos = _inputs(*MLA_SHAPE)
    qd, pd = MLA_DTYPES[pools]
    pool = jnp.asarray(kpool, jnp.bfloat16 if pd == torch.bfloat16
                       else jnp.float32)
    jargs = (jnp.asarray(q), pool, pool, jnp.asarray(pt), jnp.asarray(pos))
    return _torch(q, kpool, vpool, pt, pos, qd, pd), jargs, backend, jax_ref


@pytest.mark.parametrize("pools", sorted(MLA_DTYPES))
def test_ref_matches_jax_ref_at_mla_widths(pools):
    """f32 q over an f32 or bf16 latent pool, both sides widening the same
    pool values: rtol 1e-5, atol 1e-5 (576-long f32 dot products summed in
    another order)."""
    args, jargs, _, jax_ref = _mla_case(pools)
    scale = 1.0 / np.sqrt(192)  # deepseek-v3: qk_nope 128 + rope 64
    want = jax_ref(*jargs, scale=scale, dv=512)
    got = K.paged_attn_ref(*args, scale=scale, dv=512)
    assert got.shape == (2, 1, 4, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("pools", sorted(MLA_DTYPES))
def test_ref_matches_pallas_kernel_interpret_at_mla_widths(pools):
    """Against the TPU kernel in interpret mode at MLA's widths: rtol 1e-5,
    atol 1e-5, as the other interpret-mode cases."""
    args, jargs, backend, _ = _mla_case(pools)
    scale = 1.0 / np.sqrt(192)
    pls = backend.make_engine("pallas", interpret=True)
    want = pls.paged_attn(*jargs, scale=scale, dv=512)
    got = K.paged_attn_ref(*args, scale=scale, dv=512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


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


def _mla_latents(a, width=576):
    # MLA's latents (kv_lora_rank 512 + rope 64), vpool = kpool
    pool = torch.zeros((4, 8, 1, width))
    return [torch.zeros((2, 1, 16, width)), pool, pool, a[3][:2], a[4][:2]]


BAD_INPUTS = {
    # 576-wide latents are taken, but a value read past 512 is not
    "mla_576_wide": (_mla_latents, 576),
    "dq_over_576": (lambda a: _mla_latents(a, 640), 512),
    "dv_over_dvp": (lambda a: a, 17),
    "pt_int64": (lambda a: a[:3] + [a[3].long(), a[4]], None),
    "pos_int64": (lambda a: a[:4] + [a[4].long()], None),
    # q may differ from the pools, but kpool and vpool share one dtype
    "mixed_dtype": (lambda a: a[:2] + [a[2].bfloat16()] + a[3:], None),
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
    pl = K.plan(8, 8, 4, 128, 128, 17, 16, torch.bfloat16)
    # separate K and V pools: two 256-byte rows a staged row
    assert pl.smem == K.smem_bytes(1, pl.stages, 128, 128, 2, False,
                                   pl.rows)
    assert pl.smem <= K.MAX_SMEM


def test_wrapper_checks_accept_mla_latent_widths():
    # deepseek-v3's decode: KV = 1, G = 128, dq = 576, dv = 512 on the
    # aliased bf16 latent pool (latpool.unsqueeze(2)), an f32 query
    q = torch.zeros((8, 1, 128, 576))
    lat = torch.zeros((257, 16, 1, 576), dtype=torch.bfloat16)
    pt = torch.zeros((8, 256), dtype=torch.int32)
    pos = torch.zeros((8,), dtype=torch.int32)
    K._check(q, lat, lat, pt, pos, 512)
    assert K._is_alias(lat, lat) and not K._is_alias(lat, lat.clone())
    pl = K.plan(8, 1, 128, 576, 512, 256, 16, torch.bfloat16, True)
    assert pl.heads_per_warp == 2 and pl.groups == 16
    assert pl.smem == K.smem_bytes(2, pl.stages, 576, 512, 2, True,
                                   pl.rows)
    assert pl.smem <= K.MAX_SMEM


def test_wrapper_checks_accept_f32_q_over_bf16_pools():
    q = torch.zeros((8, 8, 4, 128))
    pool = torch.zeros((137, 16, 8, 128), dtype=torch.bfloat16)
    pt = torch.zeros((8, 17), dtype=torch.int32)
    pos = torch.zeros((8,), dtype=torch.int32)
    K._check(q, pool, pool.clone(), pt, pos, 128)


@pytest.mark.parametrize("dq, dv, dtype, offset, want", [
    (128, 128, torch.bfloat16, 0, 16),  # the main path
    (576, 512, torch.bfloat16, 0, 16),  # MLA
    (4, 4, torch.bfloat16, 0, 8),       # 8-byte rows
    (6, 6, torch.float32, 0, 8),        # 24-byte rows
    (5, 5, torch.bfloat16, 0, 2),       # odd bf16 width: plain loads
    (16, 16, torch.float32, 1, 4),      # a pool 4 bytes off alignment
])
def test_copy_width_follows_rows_and_addresses(dq, dv, dtype, offset, want):
    base = torch.zeros(8 * 4 * dq + offset, dtype=dtype)
    pool = base[offset:].view(8, 4, 1, dq)
    assert K._vec(pool, pool, dq, dv) == want


def _need_hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0)[0] != 9:
        pytest.skip("needs compute capability 9.x (Hopper)")


def _card_args(shape, dtype, pool_dtype=None, seed=0):
    q, kpool, vpool, pt, pos = _inputs(*shape, seed=seed)
    args = [t.cuda() for t in _torch(q, kpool, vpool, pt, pos, dtype,
                                     pool_dtype)]
    if vpool is kpool:
        args[2] = args[1]
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_ref_on_card(shape, dtype):
    """The CUDA kernel against the plain version on the card: atol 1e-4,
    rtol 1e-4 (identical inputs; only the f32 summation order differs)."""
    _need_hopper()
    args = _card_args(shape, getattr(torch, dtype))
    dv = shape[4]
    scale = 1.0 / np.sqrt(shape[3])
    before = K.launches
    got = K.paged_attn(*args, scale=scale, dv=dv)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    want = K.paged_attn_ref(*args, scale=scale, dv=dv)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# b, kv, g, dq, dv, live pool pages, page_len, table pages; q / pool dtype
CARD_SHAPES = {
    "mla": ((2, 1, 128, 576, 512, 40, 16, 24), "float32", "bfloat16"),
    "mla_f32": ((2, 1, 128, 576, 512, 40, 16, 24), "float32", "float32"),
    "mla_g20": ((3, 1, 20, 576, 512, 9, 64, 3), "bfloat16", "bfloat16"),
    "long_16_splits": ((1, 2, 4, 128, None, 300, 16, 64), "bfloat16",
                       "bfloat16"),
    "long_f32_q": ((2, 1, 4, 128, None, 200, 16, 40), "float32", "bfloat16"),
    "g6": ((3, 2, 6, 64, None, 9, 16, 4), "bfloat16", "bfloat16"),
    "g12_aliased": ((2, 1, 12, 128, 64, 9, 16, 5), "float32", "float32"),
    "rows_8_bytes": ((3, 2, 2, 4, None, 7, 8, 3), "bfloat16", "bfloat16"),
    "rows_24_bytes": ((3, 2, 3, 12, None, 7, 8, 3), "bfloat16", "float32"),
    "rows_10_bytes": ((3, 1, 4, 5, None, 7, 8, 3), "float32", "bfloat16"),
    "rows_6_bytes_aliased": ((2, 2, 2, 3, 2, 7, 4, 5), "bfloat16",
                             "bfloat16"),
    "d16": ((3, 2, 4, 16, None, 9, 16, 4), "bfloat16", "bfloat16"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_SHAPES))
def test_kernel_new_shapes_on_card(case):
    """MLA's widths (G = 128 and G = 20, off the 16-head group), mixed
    q / pool dtypes, a context of 16 splits, G = 6 / 12, rows of 8, 24, 10
    and 6 bytes (8- and 4-byte copies, plain 2-byte loads): atol 1e-4,
    rtol 1e-4 against the plain version; two calls bitwise equal."""
    _need_hopper()
    shape, qd, pd = CARD_SHAPES[case]
    args = _card_args(shape, getattr(torch, qd), getattr(torch, pd))
    dv = shape[4]
    scale = 1.0 / np.sqrt(shape[3])
    got = K.paged_attn(*args, scale=scale, dv=dv)
    again = K.paged_attn(*args, scale=scale, dv=dv)
    want = K.paged_attn_ref(*args, scale=scale, dv=dv)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, again)
    if case == "long_16_splits":
        b, kv, g, dq = shape[:4]
        assert K.plan(b, kv, g, dq, dq, shape[7], shape[6],
                      torch.bfloat16).splits >= 8


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mla", "long_16_splits"])
def test_kernel_graph_replay_reads_pos_on_the_device(case):
    """A call captured in a CUDA graph and replayed after pos and the
    table changed in place gives the eager call's bits on the new inputs:
    the host read neither."""
    _need_hopper()
    shape, qd, pd = CARD_SHAPES[case]
    args = _card_args(shape, getattr(torch, qd), getattr(torch, pd))
    new = _card_args(shape, getattr(torch, qd), getattr(torch, pd), seed=5)
    kw = dict(scale=1.0 / np.sqrt(shape[3]), dv=shape[4])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.paged_attn(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.paged_attn(*args, **kw)
    args[3].copy_(new[3])
    args[4].copy_(new[4])
    graph.replay()
    want = K.paged_attn(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
