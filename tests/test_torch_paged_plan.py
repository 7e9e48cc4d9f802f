"""How the port's paged attention splits its work, on the CPU.

* `plan` (shapes only): every logical row of [0, P * L) lies in exactly
  one split, in order; the head groups cover G; shared memory fits a
  block; the main path fills the card; it takes no tensor.
* `_split_combine`, a plain-torch mirror of the kernel's arithmetic
  (csrc/paged_attn.cu): each split's online softmax over chunks of the
  rows a warp scores at once, empty partials past pos, and the ordered
  combine. Held to `paged_attn_ref` and to the JAX package's plain
  version, including splits wholly past pos and a single valid row.
"""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attn as K

# b, kv, g, dq, dv, p_tab, page_len, pool dtype, aliased pool
PLAN_SHAPES = {
    "main_path": (8, 8, 4, 128, 128, 17, 16, torch.bfloat16, False),
    "main_long": (8, 8, 4, 128, 128, 256, 16, torch.bfloat16, False),
    "mla_b8_l16": (8, 1, 128, 576, 512, 256, 16, torch.bfloat16, True),
    "mla_b2_l64": (2, 1, 128, 576, 512, 64, 64, torch.bfloat16, True),
    "mla_f32_p17": (8, 1, 128, 576, 512, 17, 16, torch.float32, True),
    "mla_separate_f32": (1, 1, 128, 576, 512, 256, 64, torch.float32, False),
    "g20_short": (3, 1, 20, 576, 512, 3, 64, torch.bfloat16, True),
    "one_page": (1, 1, 1, 4, 4, 1, 2, torch.float32, False),
}


@pytest.mark.parametrize("case", sorted(PLAN_SHAPES))
def test_plan_covers_rows_and_heads(case):
    b, kv, g, dq, dv, p_tab, page_len, dtype, alias = PLAN_SHAPES[case]
    pl = K.plan(b, kv, g, dq, dv, p_tab, page_len, dtype, alias)
    ctx = p_tab * page_len
    assert pl.rows % page_len == 0 and pl.rows >= 1
    bounds = [(s * pl.rows, min((s + 1) * pl.rows, ctx))
              for s in range(pl.splits)]
    rows = [j for lo, hi in bounds for j in range(lo, hi)]
    assert rows == list(range(ctx))  # each row once, in order
    assert all(lo < hi for lo, hi in bounds)  # no split is empty by shape
    assert pl.heads_per_warp == (1 if g <= K.WARPS else 2)
    assert pl.heads_per_block <= K.WARPS * pl.heads_per_warp
    heads = [h for grp in range(pl.groups)
             for h in range(grp * pl.heads_per_block,
                            min((grp + 1) * pl.heads_per_block, g))]
    assert heads == list(range(g))
    assert 2 <= pl.stages <= K.MAX_STAGES
    esize = 2 if dtype == torch.bfloat16 else 4
    assert pl.smem == K.smem_bytes(pl.heads_per_warp, pl.stages, dq, dv,
                                   esize, alias, pl.rows)
    assert pl.smem <= K.MAX_SMEM


@pytest.mark.parametrize("case", ["main_path", "main_long", "mla_b8_l16",
                                  "mla_b2_l64"])
def test_plan_fills_the_card(case):
    b, kv, g, dq, dv, p_tab, page_len, dtype, alias = PLAN_SHAPES[case]
    pl = K.plan(b, kv, g, dq, dv, p_tab, page_len, dtype, alias)
    assert pl.splits * pl.groups * b * kv >= K.SMS
    if case == "main_path":  # 64 (b, kv) pairs x 5 splits of 64 rows
        assert (pl.rows, pl.splits, pl.heads_per_block) == (64, 5, 4)


def test_plan_takes_shapes_only():
    """The split depends on shapes alone (never on pos, which the host
    never reads): plan's parameters are ints, a dtype and a flag, and the
    wrapper hands it shapes."""
    params = inspect.signature(K.plan).parameters
    assert list(params) == ["b", "kv", "g", "dq", "dv", "p_tab", "page_len",
                            "dtype", "alias"]
    src = inspect.getsource(K.paged_attn)
    assert "pos" not in src.split("plan(")[1].split(")")[0]
    for name in (".item(", ".cpu(", ".tolist(", ".numpy("):
        assert name not in src


# ---------------------------------------------------------------------------
# The kernel's split-and-combine arithmetic in plain torch.
# ---------------------------------------------------------------------------

def _split_combine(q, kpool, vpool, pt, pos, *, scale, dv, pl):
    """out (B, KV, G, dv) f32 as csrc/paged_attn.cu computes it: q * scale
    rounded to q's type; per (b, split) the rows [s * rows, min((s + 1) *
    rows, pos + 1)) in chunks of the 16 rows a warp scores at once, an online
    softmax (m, l, acc) over the chunks, an empty partial (acc 0, m =
    -inf, l = 0) past pos; then out = sum_s e_s acc_s / max(sum_s e_s l_s,
    1e-30), e_s = exp(m_s - max m), the splits in index order."""
    b, kv, g, dq = q.shape
    page_len, p_tab = kpool.shape[1], pt.shape[1]
    ctx = p_tab * page_len
    rs = K.ROWS_SCORED
    qs = (q * scale).float()
    j = torch.arange(ctx)
    out = torch.empty((b, kv, g, dv))
    for bi in range(b):
        page = pt[bi].long()[j // page_len]
        k = kpool[page, j % page_len].float()          # (ctx, KV, dq)
        v = vpool[page, j % page_len][..., :dv].float()
        n_valid = min(int(pos[bi]) + 1, ctx)
        parts = []
        for s in range(pl.splits):
            r0, r1 = s * pl.rows, min((s + 1) * pl.rows, n_valid)
            m = torch.full((kv, g), -torch.inf)
            l_ = torch.zeros((kv, g))
            acc = torch.zeros((kv, g, dv))
            for c0 in range(r0, r1, rs):
                c1 = min(c0 + rs, r1)
                sc = torch.einsum("kgd,rkd->kgr", qs[bi], k[c0:c1])
                mn = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp(m - mn)
                p = torch.exp(sc - mn[..., None])
                l_ = l_ * alpha + p.sum(-1)
                acc = (acc * alpha[..., None]
                       + torch.einsum("kgr,rkd->kgd", p, v[c0:c1]))
                m = mn
            parts.append((m, l_, acc))
        mx = torch.stack([p[0] for p in parts]).amax(0)
        num = torch.zeros((kv, g, dv))
        den = torch.zeros((kv, g))
        for m, l_, acc in parts:
            e = torch.where(m == -torch.inf, torch.zeros(()),
                            torch.exp(m - mx))
            num = num + e[..., None] * acc
            den = den + e * l_
        out[bi] = num / den.clamp_min(1e-30)[..., None]
    return out


def _jax_ref():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ref import paged_attn_ref
    return jnp, paged_attn_ref


# b, kv, g, dq, dv (None: a separate value pool), n, page_len, p_tab, pos
MIRROR_CASES = {
    # five splits of 64 rows; pos = 0 (one valid row, four empty splits),
    # a split boundary crossed mid-page, the full table
    "gqa_five_splits": ((3, 2, 4, 16, None, 30, 8, 40), [0, 70, 319]),
    # heads 2 to a warp, 8 to a block: G = 20 in three groups
    "mla_like_g20": ((2, 1, 20, 40, 32, 30, 16, 24), [383, 129]),
    # G = 6: two heads a warp; a single valid row in every batch row
    "g6_single_rows": ((2, 2, 6, 24, None, 12, 4, 40), [0, 0]),
    # one split: the context is shorter than MIN_ROWS
    "one_split": ((2, 1, 4, 8, None, 6, 4, 5), [19, 3]),
}


def _mirror_inputs(shape, pos, seed=0):
    b, kv, g, dq, dv, n, page_len, p_tab = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, dq)).astype(np.float32)
    kp = rng.standard_normal((n + 1, page_len, kv, dq)).astype(np.float32)
    vp = (kp if dv is not None else
          rng.standard_normal((n + 1, page_len, kv, dq)).astype(np.float32))
    pt = rng.integers(0, n, size=(b, p_tab)).astype(np.int32)
    pos = np.asarray(pos, np.int32)
    for i in range(b):
        pt[i, pos[i] // page_len + 1:] = n  # trash-mapped tail
    return q, kp, vp, pt, pos


@pytest.mark.parametrize("case", sorted(MIRROR_CASES))
def test_split_combine_matches_plain_versions(case):
    """The mirror against `paged_attn_ref` and the JAX package's plain
    version, f32: rtol 1e-5, atol 1e-6 (the same math, the softmax
    rescaled per chunk and per split)."""
    shape, pos = MIRROR_CASES[case]
    b, kv, g, dq, dv, n, page_len, p_tab = shape
    q, kp, vp, pt, pos = _mirror_inputs(shape, pos)
    tk = torch.from_numpy(kp)
    tv = tk if vp is kp else torch.from_numpy(vp)
    args = (torch.from_numpy(q), tk, tv, torch.from_numpy(pt),
            torch.from_numpy(pos))
    scale = 1.0 / np.sqrt(dq)
    dvv = dq if dv is None else dv
    pl = K.plan(b, kv, g, dq, dvv, p_tab, page_len, torch.float32,
                vp is kp)
    if case == "gqa_five_splits":
        assert pl.splits == 5
    got = _split_combine(*args, scale=scale, dv=dvv, pl=pl)
    want = K.paged_attn_ref(*args, scale=scale, dv=dv)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    jnp, jax_ref = _jax_ref()
    jv = jnp.asarray(kp) if vp is kp else jnp.asarray(vp)
    jwant = jax_ref(jnp.asarray(q), jnp.asarray(kp), jv, jnp.asarray(pt),
                    jnp.asarray(pos), scale=scale, dv=dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-5,
                               atol=1e-6)


def test_split_combine_bf16_query_rounding():
    """bf16 q over an f32 pool: the mirror rounds q * scale to bf16 as the
    plain version does; rtol 1e-5, atol 1e-6."""
    shape, pos = MIRROR_CASES["gqa_five_splits"]
    b, kv, g, dq, dv, n, page_len, p_tab = shape
    q, kp, vp, pt, pos = _mirror_inputs(shape, pos, seed=1)
    args = (torch.from_numpy(q).bfloat16(), torch.from_numpy(kp),
            torch.from_numpy(vp), torch.from_numpy(pt), torch.from_numpy(pos))
    pl = K.plan(b, kv, g, dq, dq, p_tab, page_len, torch.float32)
    got = _split_combine(*args, scale=0.25, dv=dq, pl=pl)
    want = K.paged_attn_ref(*args, scale=0.25)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
