"""The port's contiguous serving plane against the JAX package, on the CPU
in f32.

Parameters and cache states cross through the numpy bridge; the same
numpy-seeded inputs go through both packages:

* `gqa_decode` on a full cache and on a ring (a slot before the write
  slot, so `slot - s` is negative, a ring shorter than the window) and
  MLA's absorbed `mla_decode`, with `active` masks, one retired row past
  the end: outputs and written rows within 1e-5, inactive rows
  bit-identical;
* `init_cache` and `cache_slot_axes`: the reference's keys, shapes and
  axes;
* one contiguous `serve_step` from an identical cache state on tiny,
  qwen3-4b, granite-moe-3b-a800m and deepseek-v3-671b reduced, and
  `prefill_step` (a sliding window shorter than the prompt among them);
* `greedy_decode` fused and loop against the reference's tokens: ragged,
  equal length, a ring that wraps (qwen3-4b reduced `swa`, cache_len 10),
  the empty-prompt error and gen = 0; fused bitwise equal to loop;
* `DecodeEngine(paging="off")` against the reference engine (a ring
  window among them), and the paged plane against the contiguous one
  inside the port (the reference's paged-vs-contiguous scenario);
* the serve CLI's `--mode batch --prefill fused|loop` and `--paging off`
  against the reference CLI's tokens for the same flags and parameters.

Tie rule: where two token streams first differ, the port's f32 logits at
that step must have a top-2 gap under 1e-4 (an argmax tie decided by
summation order); otherwise the test fails.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.spec import init_params as jax_init_params
from repro.launch import serve as jax_serve
from repro.launch.engine import DecodeEngine as JaxEngine
from repro.launch.inputs import synthetic_requests
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.models.transformer import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.transformer import build_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small torch ops: beside
    the other test workers, a thread per core makes them spin ~8x slower.
    Every comparison here is between runs under the same setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ["tiny", "qwen3-4b-reduced", "granite-moe-3b-a800m-reduced",
         "deepseek-v3-671b-reduced"]
TIE_GAP = 1e-4
REDUCED = "-reduced"


def _both(name, seed=0, variant=None, **overrides):
    """(port model, port params, jax model, jax params): the reference's
    parameters bridged into the port; `overrides` replace config fields
    in both packages."""
    arch, reduced = ((name[:-len(REDUCED)], True) if name.endswith(REDUCED)
                     else (name, False))
    jcfg = jax_get_config(arch, reduced=reduced, variant=variant)
    jm = jax_build_model(dataclasses.replace(jcfg, **overrides))
    jp = jax_init_params(jm.spec, jax.random.PRNGKey(seed))
    cfg = get_config(arch, reduced=reduced, variant=variant)
    model = build_model(dataclasses.replace(cfg, **overrides), device="cpu")
    params = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      "cpu")
    return model, params, jm, jp


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inf_th(tree, b):
    """+inf thresholds for every sub-module of one block's subtree."""
    return {k: jnp.full((b,), jnp.inf) for k in tree}


def _logits_after(model, params, seq, cache_len):
    """(V,) f32 logits after feeding `seq` one token at a time through a
    fresh single-row contiguous cache of `cache_len`."""
    cache = model.init_cache(1, cache_len)
    for tok in seq:
        logits, cache = model.serve_step(params, cache, {
            "token": torch.tensor([[int(tok)]], dtype=torch.int32)})
    return logits[0].float()


def _assert_tokens_match(model, params, prompt, got, want, cache_len):
    """Token for token, or a tie at the first divergence (module doc)."""
    got, want = list(got), list(want)
    assert len(got) == len(want)
    if got == want:
        return
    i = next(k for k, (a, b) in enumerate(zip(got, want)) if a != b)
    logits = _logits_after(model, params, list(prompt) + got[:i], cache_len)
    top2 = torch.topk(logits, 2).values
    gap = float(top2[0] - top2[1])
    assert gap < TIE_GAP, (f"tokens diverge at {i} with top-2 gap {gap}: "
                           f"{got} vs {want}")


# ---------------------------------------------------------------------------
# The decode functions.
# ---------------------------------------------------------------------------

# window, cache_len, pos, active: a full cache with a retired row past the
# end; a ring whose write slot follows unwritten slots and precedes older
# ones (slot - s < 0); a ring shorter than the window
GQA_CASES = {
    "full": (None, 16, [0, 5, 15, 16], [True, True, True, False]),
    "ring": (8, 20, [3, 8, 13, 21], [True, False, True, True]),
    "ring_short": (8, 6, [2, 6, 11, 7], [True, True, True, True]),
}


@pytest.mark.parametrize("case", sorted(GQA_CASES))
def test_gqa_decode_matches_reference(case):
    window, cache_len, pos, active = GQA_CASES[case]
    model, params, jm, jp = _both("qwen3-4b-reduced", sliding_window=window)
    cfg = model.cfg
    b = len(pos)
    cap = min(window, cache_len) if window else cache_len
    rng = np.random.default_rng(3)
    shape = (b, cap, cfg.num_kv_heads, cfg.resolved_head_dim)
    ck, cv = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    pos, active = np.asarray(pos, np.int32), np.asarray(active)
    jattn = jax.tree_util.tree_map(lambda a: a[0], jp["dense_blocks"]["attn"])
    want, wk, wv = jax.jit(lambda *args, **kw: JA.gqa_decode(
        jm.cfg, *args, window=window, **kw))(
        jattn, jnp.asarray(x), _inf_th(jattn, b), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(pos), active=jnp.asarray(active))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = A.gqa_decode(cfg, params["dense_blocks"][0]["attn"],
                       torch.from_numpy(x), tk, tv, torch.from_numpy(pos),
                       window=window, active=torch.from_numpy(active))
    np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active],
                               rtol=1e-5, atol=1e-5)
    for t, w, old in ((tk, wk, ck), (tv, wv, cv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
        # an inactive row keeps its bits; an active one changed one slot
        assert np.array_equal(t.numpy()[~active], old[~active])
        changed = (t.numpy() != old).any(axis=(2, 3))
        assert (changed.sum(axis=1) == active).all()


def test_ring_key_positions_with_a_negative_slot_difference():
    """torch's % on tensors is floor modulo, as jnp's: a slot before the
    write slot keeps a recent position, a slot after it the oldest."""
    pos = torch.tensor([13], dtype=torch.int32)
    cap = 8
    slot = pos % cap  # 5
    ar = torch.arange(cap)[None]
    kpos = pos[:, None] - ((slot[:, None] - ar) % cap)
    want = 13 - ((5 - np.arange(8)) % 8)
    assert kpos.tolist()[0] == want.tolist() == [8, 9, 10, 11, 12, 13, 6, 7]
    assert A._FUTURE_POS >= A.INVALID_POS and A._UNWRITTEN_POS >= \
        A.INVALID_POS


def test_mla_decode_matches_reference():
    model, params, jm, jp = _both("deepseek-v3-671b-reduced")
    cfg = model.cfg
    pos = np.array([0, 7, 15, 16], np.int32)
    active = np.array([True, True, False, False])
    b, s = pos.size, 16
    rng = np.random.default_rng(4)
    ckv = rng.standard_normal((b, s, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((b, s, cfg.qk_rope_head_dim)).astype(np.float32)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    jattn = jax.tree_util.tree_map(lambda a: a[0], jp["dense_blocks"]["attn"])
    want, wc, wr = jax.jit(lambda *args, **kw: JA.mla_decode(
        jm.cfg, *args, **kw))(
        jattn, jnp.asarray(x), _inf_th(jattn, b), jnp.asarray(ckv),
        jnp.asarray(kr), jnp.asarray(pos), active=jnp.asarray(active))
    tc, tr = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    got = A.mla_decode(cfg, params["dense_blocks"][0]["attn"],
                       torch.from_numpy(x), tc, tr, torch.from_numpy(pos),
                       active=torch.from_numpy(active))
    np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active],
                               rtol=1e-5, atol=1e-5)
    for t, w, old in ((tc, wc, ckv), (tr, wr, kr)):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
        assert np.array_equal(t.numpy()[~active], old[~active])


def test_masked_state_freezes_inactive_rows():
    new, old = torch.ones(3, 2, 4), torch.zeros(3, 2, 4)
    act = torch.tensor([True, False, True])
    out = A.masked_state(act, new, old)
    want = JA.masked_state(jnp.asarray(act.numpy()), jnp.ones((3, 2, 4)),
                           jnp.zeros((3, 2, 4)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert A.masked_state(None, new, old) is new


# ---------------------------------------------------------------------------
# Caches, serve_step, prefill_step.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,window,cache_len", [
    ("tiny", None, 24), ("qwen3-4b-reduced", 8, 24),
    ("qwen3-4b-reduced", 8, 5), ("granite-moe-3b-a800m-reduced", None, 24),
    ("deepseek-v3-671b-reduced", None, 24)])
def test_init_cache_and_slot_axes_match_reference(name, window, cache_len):
    model, _, jm, _ = _both(name, sliding_window=window)
    want = _np(jm.init_cache(3, cache_len))
    got = model.init_cache(3, cache_len)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert {k: str(v.dtype).split(".")[-1] for k, v in got.items()} == \
        {k: str(v.dtype) for k, v in want.items()}
    assert all(not v.any() for v in got.values())
    assert T.cache_slot_axes(got) == JT.cache_slot_axes(want)
    if window is not None:
        with pytest.raises(ValueError, match="ring-window"):
            model.init_paged_cache(3, 32, num_pages=6, page_len=8)


def _contiguous_state(jm, slots, cache_len, seed):
    """A numpy contiguous cache with random contents, ragged positions and
    one retired slot whose pos sits at the end of its capacity."""
    rng = np.random.default_rng(seed)
    cache = _np(jm.init_cache(slots, cache_len))
    for k in cache:
        if k != "pos":
            cache[k] = rng.standard_normal(cache[k].shape).astype(np.float32)
    pos = rng.integers(0, cache_len - 1, size=slots).astype(np.int32)
    pos[-1] = cache_len
    cache["pos"] = pos
    return cache


@pytest.mark.parametrize("name", ARCHS + ["qwen3-4b-reduced-swa"])
def test_contiguous_serve_step_matches_reference(name):
    window = 8 if name.endswith("-swa") else None
    name = name.removesuffix("-swa")
    model, params, jm, jp = _both(name, sliding_window=window)
    slots, cache_len = 4, 24
    cache_np = _contiguous_state(jm, slots, cache_len, 5)
    active = np.array([True, True, False, False])
    token = np.random.default_rng(9).integers(
        0, model.cfg.vocab_size, size=(slots, 1)).astype(np.int32)
    want_logits, want_cache = jm.serve_step(
        jp, jax.tree_util.tree_map(jnp.asarray, cache_np),
        {"token": jnp.asarray(token), "active": jnp.asarray(active)})
    cache = bridge.cache_from_numpy(cache_np, "cpu")
    logits, new_cache = model.serve_step(
        params, cache, {"token": torch.from_numpy(token),
                        "active": torch.from_numpy(active)})
    np.testing.assert_allclose(logits.numpy()[active],
                               np.asarray(want_logits)[active], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(new_cache["pos"].numpy(),
                                  np.asarray(want_cache["pos"]))
    for k in cache_np:
        if k == "pos":
            continue
        got = new_cache[k].numpy()
        np.testing.assert_allclose(got, np.asarray(want_cache[k]), rtol=1e-4,
                                   atol=1e-4)
        assert np.array_equal(got[:, ~active], cache_np[k][:, ~active])
        assert not np.array_equal(got, cache_np[k])


@pytest.mark.parametrize("name", ARCHS + ["qwen3-4b-reduced-swa"])
def test_prefill_step_matches_reference(name):
    window = 5 if name.endswith("-swa") else None
    name = name.removesuffix("-swa")
    model, params, jm, jp = _both(name, sliding_window=window)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, model.cfg.vocab_size, (2, 12)).astype(np.int32)
    want = jm.prefill_step(jp, {"tokens": jnp.asarray(tokens)})
    got = model.prefill_step(params, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, model.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    if window is not None:  # the window is in effect
        full = build_model(dataclasses.replace(model.cfg,
                                               sliding_window=None),
                           device="cpu")
        assert not torch.allclose(
            full.prefill_step(params, {"tokens": torch.from_numpy(tokens)}),
            got, atol=1e-3)


# ---------------------------------------------------------------------------
# greedy_decode.
# ---------------------------------------------------------------------------

# name, variant, request lengths (None: equal length 7), gen, cache_len
GREEDY = {
    "ragged": ("qwen3-4b-reduced", None, (3, 9, 5), 6, 32),
    "equal_length": ("tiny", None, None, 5, 24),
    "mla_ragged": ("deepseek-v3-671b-reduced", None, (2, 6), 5, 16),
    # the ring: prompt + gen runs past cache_len = 10, so it wraps
    "ring_wrap": ("qwen3-4b-reduced", "swa", (4, 8, 6), 8, 10),
}


@pytest.mark.parametrize("case", sorted(GREEDY))
def test_greedy_decode_matches_reference(case):
    name, variant, lens, gen, cache_len = GREEDY[case]
    model, params, jm, jp = _both(name, variant=variant)
    rng = np.random.default_rng(6)
    vocab = model.cfg.vocab_size
    if lens is None:
        prompts = rng.integers(0, vocab, (3, 7)).astype(np.int32)
        lengths = None
    else:
        prompts = np.zeros((len(lens), max(lens)), np.int32)
        for i, n in enumerate(lens):
            prompts[i, :n] = rng.integers(0, vocab, n)
        lengths = np.asarray(lens, np.int32)
    want = np.asarray(jax_serve.greedy_decode(
        jm, jp, jnp.asarray(prompts), gen, cache_len, prefill="loop",
        lengths=None if lengths is None else jnp.asarray(lengths)))
    kw = {} if lengths is None else {"lengths": torch.from_numpy(lengths)}
    fused = serve.greedy_decode(model, params, torch.from_numpy(prompts),
                                gen, cache_len, prefill="fused", **kw)
    loop = serve.greedy_decode(model, params, torch.from_numpy(prompts),
                               gen, cache_len, prefill="loop", **kw)
    assert fused.dtype == torch.int32 and fused.shape == (len(prompts), gen)
    assert torch.equal(fused, loop)
    for i, row in enumerate(prompts):
        n = row.size if lengths is None else lengths[i]
        _assert_tokens_match(model, params, row[:n], fused[i].tolist(),
                             want[i].tolist(), cache_len)
    if variant == "swa":
        assert model.cfg.sliding_window == 4096
        assert max(lens) + gen > cache_len


def test_greedy_decode_ragged_rows_decode_as_alone():
    """A ragged batch decodes each prompt as it would alone, unpadded."""
    model, params, _, _ = _both("tiny")
    rng = np.random.default_rng(8)
    reqs = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
            for n in (2, 7, 4)]
    prompts, lengths = serve.pad_ragged_prompts(reqs)
    batch = serve.greedy_decode(model, params, torch.from_numpy(prompts), 6,
                                24, lengths=torch.from_numpy(lengths))
    for i, r in enumerate(reqs):
        alone = serve.greedy_decode(model, params, torch.from_numpy(r[None]),
                                    6, 24)
        assert torch.equal(batch[i], alone[0])


def test_greedy_decode_empty_prompt_and_zero_gen():
    model, params, _, _ = _both("tiny")
    with pytest.raises(ValueError, match="empty prompt"):
        serve.greedy_decode(model, params, torch.zeros((2, 0), dtype=torch.int32),
                            4, 16)
    prompts = torch.tensor([[3, 4, 5], [6, 7, 8]], dtype=torch.int32)
    for prefill in ("fused", "loop"):
        out = serve.greedy_decode(model, params, prompts, 0, 16,
                                  prefill=prefill)
        assert out.shape == (2, 0) and out.dtype == torch.int32
    with pytest.raises(ValueError, match="prefill"):
        serve.greedy_decode(model, params, prompts, 2, 16, prefill="scan")


# ---------------------------------------------------------------------------
# The engine on the contiguous plane.
# ---------------------------------------------------------------------------


def _mid_flight(eng, reqs, gens):
    """The reference's paged-vs-contiguous scenario: two requests, three
    pool steps, then the rest admitted mid-flight into recycled slots."""
    rids = [eng.submit(r, max_new_tokens=g)
            for r, g in zip(reqs[:2], gens[:2])]
    for _ in range(3):
        eng.step()
    rids += [eng.submit(r, max_new_tokens=g)
             for r, g in zip(reqs[2:], gens[2:])]
    done = eng.run()
    return [done[rid].tokens for rid in rids]


# name, sliding window, cache_len
ENGINE = {"tiny": ("tiny", None, 64),
          "qwen3-4b-reduced": ("qwen3-4b-reduced", None, 64),
          "deepseek-v3-671b-reduced": ("deepseek-v3-671b-reduced", None, 64),
          # a ring of 8 slots, requests past cache_len = 12
          "qwen3-4b-reduced-ring": ("qwen3-4b-reduced", 8, 12)}


@pytest.mark.parametrize("case", sorted(ENGINE))
def test_contiguous_engine_matches_reference_engine(case):
    name, window, cache_len = ENGINE[case]
    model, params, jm, jp = _both(name, sliding_window=window)
    reqs = synthetic_requests(model.cfg.vocab_size, 5, min_len=1,
                              max_len=20 if window is None else 9, seed=5)
    gens = [8, 8, 12, 8, 8]
    kw = dict(num_slots=2, cache_len=cache_len, prefill_chunk=4,
              paging="off" if window is None else "auto")
    jeng, eng = JaxEngine(jm, jp, **kw), DecodeEngine(model, params, **kw)
    assert not eng.paged and not jeng.paged
    want, got = _mid_flight(jeng, reqs, gens), _mid_flight(eng, reqs, gens)
    for r, g, w in zip(reqs, got, want):
        _assert_tokens_match(model, params, r, g, w, cache_len)
    for k in ("prefill_dispatches", "decode_dispatches", "tokens_out",
              "requests_done", "prefill_pad_chunks_saved", "live_slot_steps",
              "peak_live_slots"):
        assert eng.stats[k] == jeng.stats[k], k
    assert eng.cache_bytes() == jeng.cache_bytes()
    if window is not None:
        assert max(len(r) + g for r, g in zip(reqs, gens)) > cache_len


@pytest.mark.parametrize("name", ["tiny", "deepseek-v3-671b-reduced"])
def test_paged_engine_matches_contiguous_engine(name):
    """At matching logical capacity the paged plane gives the contiguous
    plane's tokens, with mid-flight admission into recycled slots, and
    both give each request's tokens alone through `greedy_decode`'s loop.

    GQA is held bitwise: the paged plain version and `attend` score the
    same keys in f32 in the same order, and a masked key weighs exactly 0.
    MLA is held up to argmax ties: the paged decode hands `paged_attn` the
    query with the scale folded in and one concatenated latent (the
    kernel's contract), the contiguous one sums two f32 einsums and scales
    after, as the reference's `mla_decode`, so the two round differently
    (the reference's plain paged route copies the contiguous order)."""
    model, params, _, _ = _both(name)
    reqs = synthetic_requests(model.cfg.vocab_size, 5, min_len=1, max_len=20,
                              seed=5)
    gens = [8, 8, 12, 8, 8]
    runs = {}
    for paging in ("on", "off"):
        eng = DecodeEngine(model, params, num_slots=2, cache_len=64,
                           prefill_chunk=4, paging=paging, page_len=16)
        assert eng.paged == (paging == "on")
        runs[paging] = _mid_flight(eng, reqs, gens)
    for i, (r, g, paged, contig) in enumerate(zip(reqs, gens, runs["on"],
                                                  runs["off"])):
        if model.cfg.attention_kind == "gqa":
            assert paged == contig
        else:
            _assert_tokens_match(model, params, r, paged, contig, 64)
        if i < 2:  # alone, unpadded (the MoE model's two are the costly)
            assert contig == serve.greedy_decode(
                model, params, torch.from_numpy(r[None]), g, 64,
                prefill="loop")[0].tolist()


def test_sliding_window_config_serves_through_the_ring():
    """`auto` keeps a sliding-window config on the contiguous plane: a
    ring of min(window, cache_len) slots; its requests may run past
    cache_len, a full-attention engine's may not."""
    model, params, _, _ = _both("qwen3-4b-reduced", variant="swa")
    eng = DecodeEngine(model, params, num_slots=2, cache_len=12, page_len=4)
    assert not eng.paged and eng.num_pages is None
    assert eng.cache["dense_blocks_k"].shape[2] == 12
    eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=10)
    assert len(eng.run()[0].tokens) == 10
    full = DecodeEngine(*_both("qwen3-4b-reduced")[:2], num_slots=2,
                        cache_len=12, paging="off")
    with pytest.raises(ValueError, match="cache_len"):
        full.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=10)


def test_contiguous_engine_recycles_slots_to_zero():
    """The reset zeroes a recycled slot's rows of every per-slot cache and
    leaves the other slots' bits; pos restarts at 0."""
    model, params, _, _ = _both("tiny")
    eng = DecodeEngine(model, params, num_slots=2, cache_len=32,
                       paging="off")
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
    eng.submit(np.arange(1, 12, dtype=np.int32), max_new_tokens=9)
    for _ in range(4):
        eng.step()
    assert not eng._live[0] and eng._live[1]
    before = {k: v.clone() for k, v in eng.cache.items()}
    mask = np.array([True, False])
    eng._reset(mask)
    for k, v in eng.cache.items():
        if k == "pos":
            assert eng.cache["pos"].tolist() == [0, before["pos"][1]]
        else:
            assert not v[:, 0].any() and torch.equal(v[:, 1],
                                                     before[k][:, 1])


def test_paged_engine_reset_leaves_the_pools():
    """On the paged plane the reset moves only `pos`: the pools and the
    table pass through bit for bit (recycled pages are never read)."""
    model, params, _, _ = _both("tiny")
    eng = DecodeEngine(model, params, num_slots=2, cache_len=32,
                       page_len=8, paging="on")
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
    eng.submit(np.arange(1, 12, dtype=np.int32), max_new_tokens=9)
    for _ in range(4):
        eng.step()
    before = {k: v.clone() for k, v in eng.cache.items()}
    eng._start[0] = 8
    eng._reset(np.array([True, False]))
    assert eng.cache["pos"].tolist() == [8, before["pos"][1]]
    for k, v in eng.cache.items():
        if k != "pos":
            assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("paging", ["on", "off"])
def test_engine_on_token_sees_every_token_and_its_row(paging):
    """The engine's `on_token` callback gets every emitted token, in
    order, with the logits row it is the argmax of; serving with it gives
    the tokens of serving without it."""
    model, params, _, _ = _both("qwen3-4b-reduced")
    reqs = serve.build_requests(model.cfg.vocab_size, 5, min_len=4,
                                max_len=12, shared_prefix=8, seed=0)
    seen = {}

    def on_token(rid, tok, row):
        assert row.shape == (model.cfg.vocab_size,)
        assert int(torch.argmax(row.float())) == tok
        seen.setdefault(rid, []).append(tok)

    kw = dict(gen=6, num_slots=2, cache_len=32, paging=paging, page_len=8)
    eng, done = serve.serve_requests(model, params, reqs, on_token=on_token,
                                     **kw)
    _, plain = serve.serve_requests(model, params, reqs, **kw)
    assert eng.paged == (paging == "on")
    assert seen == {rid: c.tokens for rid, c in done.items()}
    assert {r: c.tokens for r, c in done.items()} == {
        r: c.tokens for r, c in plain.items()}


# ---------------------------------------------------------------------------
# The serve CLI against the reference CLI.
# ---------------------------------------------------------------------------

CLI = {"batch_fused": ("qwen3-4b", ["--mode", "batch", "--prefill", "fused"]),
       "batch_loop": ("qwen3-4b", ["--mode", "batch", "--prefill", "loop"]),
       "paging_off": ("qwen3-4b", ["--paging", "off"]),
       "mla_paging_off": ("deepseek-v3-671b", ["--paging", "off"])}


def _grid(out):
    """The printed token grid's rows (the lines after the header)."""
    lines = out.strip().splitlines()
    head = next(i for i, ln in enumerate(lines) if ln.startswith("# arch="))
    return lines[head + 1:]


@pytest.mark.parametrize("case", sorted(CLI))
def test_serve_cli_tokens_match_reference_cli(case, capsys, monkeypatch):
    """The port's CLI prints the reference CLI's tokens for the same flags
    and parameters (the reference's draw from --seed, bridged)."""
    arch, flags = CLI[case]
    argv = ["--arch", arch, "--reduced", "--batch", "4", "--prompt-len",
            "12", "--min-prompt-len", "4", "--gen", "6"] + flags
    jm = jax_build_model(jax_get_config(arch, reduced=True))
    jp = _np(jax_init_params(jm.spec, jax.random.PRNGKey(0)))
    monkeypatch.setattr(sys, "argv", ["serve"] + argv
                        + ["--cache", "off", "--autotune", "off"])
    assert jax_serve.main() == 0
    want = capsys.readouterr().out
    monkeypatch.setattr(serve, "serve_params",
                        lambda model, seed, device:
                        bridge.params_from_numpy(jp, device))
    assert serve.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert _grid(got) == _grid(want)
    mode = "batch" if "batch" in flags else "engine"
    assert f"mode={mode}" in got
    if mode == "engine":
        assert "paged=no" in got and "paged=no" in want
    else:
        assert f"prefill={flags[-1]}" in got
