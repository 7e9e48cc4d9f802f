"""The port's serving slice against the JAX package, on the CPU in f32.

Dense GQA (tiny, qwen3-4b), MoE GQA (granite-moe-3b-a800m) and MLA + MoE
(deepseek-v3-671b) models, reduced.

Parameters and pool states cross through the numpy bridge; the same
numpy-seeded inputs go through both packages:

* the bridge round trip and the spec (paths, shapes, inits);
* the layers (rmsnorm, swiglu, RoPE) and one `serve_step` from an
  identical pool state, comparing logits and written pool rows (k/v
  pools, or MLA's latent pool, of every layer stack), and an MoE step
  whose expert choices overflow their capacity with inactive rows in the
  batch;
* `DecodeEngine` token for token against the reference engine, with
  ragged prompts, mid-flight admission, a shared prefix and a starved
  pool that forces evict -> spill -> readmit, under the tie rule below;
* the copied `launch.pages` units, on both copies;
* the serve CLI with `--device cpu`.

Tie rule: where the two engines' tokens first differ, the port's f32
logits at that step must have a top-2 gap under 1e-4 (an argmax tie
decided by summation order); otherwise the test fails.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.spec import _walk as jax_walk
from repro.core.spec import init_params as jax_init_params
from repro.launch import pages as jax_pages
from repro.launch.engine import DecodeEngine as JaxEngine
from repro.models import layers as JL
from repro.models.transformer import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import spec as S
from repro_torch.launch import pages as torch_pages
from repro_torch.launch import serve
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.transformer import STACKED, build_model

ARCHS = ["tiny", "qwen3-4b-reduced", "granite-moe-3b-a800m-reduced",
         "deepseek-v3-671b-reduced"]
MOE_ARCHS = ARCHS[2:]
TIE_GAP = 1e-4
REDUCED = "-reduced"


def _arch(name):
    if name.endswith(REDUCED):
        return name[:-len(REDUCED)], True
    return name, False


def _both(name, seed=0, **overrides):
    """(port cfg, port model, port params, jax model, jax params) with the
    reference's parameters bridged into the port; `overrides` replace
    config fields in both packages."""
    arch, reduced = _arch(name)
    jm = jax_build_model(dataclasses.replace(
        jax_get_config(arch, reduced=reduced), **overrides))
    jp = jax_init_params(jm.spec, jax.random.PRNGKey(seed))
    cfg = dataclasses.replace(get_config(arch, reduced=reduced), **overrides)
    model = build_model(cfg, device="cpu")
    params = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      "cpu")
    return cfg, model, params, jm, jp


# ---------------------------------------------------------------------------
# Spec and bridge.
# ---------------------------------------------------------------------------


FULL = {"qwen3-4b": 4_411_424_256, "granite-moe-3b-a800m": 3_374_295_552,
        "deepseek-v3-671b": 671_712_655_360}  # the reference's counts


@pytest.mark.parametrize("name", ARCHS + sorted(FULL))
def test_spec_matches_reference(name):
    """Same paths, shapes, inits and stack dims as the reference spec (the
    full specs are built without allocating anything)."""
    arch, reduced = _arch(name)
    jm_spec = jax_build_model(jax_get_config(arch, reduced=reduced)).spec
    model = build_model(get_config(arch, reduced=reduced), device="cpu")
    want = {"/".join(p): (v.shape, v.init, v.stack)
            for p, v in jax_walk(jm_spec)}
    got = {"/".join(p): (v.shape, v.init, v.stack)
           for p, v in S._walk(model.spec)}
    assert got == want
    if name in FULL:
        assert model.num_params == FULL[name]
        assert model.cfg.dtype == torch.bfloat16


@pytest.mark.parametrize("name", ARCHS + sorted(FULL))
def test_group_layout_matches_reference(name):
    """The clipping groups of every spec (MLA's attention groups and the
    unstacked `mtp` ones included) in the reference's order, with its
    stack shapes, sizes and offsets."""
    arch, reduced = _arch(name)
    jlayout = jax_build_model(jax_get_config(arch, reduced=reduced)).layout
    layout = build_model(get_config(arch, reduced=reduced),
                         device="cpu").layout
    assert ([(g.name, g.stack_shape, g.dim, g.offset) for g in layout.groups]
            == [(g.name, tuple(g.stack_shape), g.dim, g.offset)
                for g in jlayout.groups])
    assert layout.num_groups == jlayout.num_groups


@pytest.mark.parametrize("name", ARCHS)
def test_bridge_round_trip(name):
    cfg, model, params, jm, jp = _both(name)
    assert sum(len(params[k]) for k in STACKED if k in params) == \
        cfg.num_layers
    for path, _ in jax_walk(jm.spec):
        arr = np.asarray(_get(jp, path))
        if path[0] in STACKED:
            assert len(params[path[0]]) == arr.shape[0]
            for layer, block in enumerate(params[path[0]]):
                got = _get(block, path[1:])
                np.testing.assert_array_equal(got.numpy(), arr[layer])
        else:
            np.testing.assert_array_equal(_get(params, path).numpy(), arr)
    assert ("mtp" in params) == bool(cfg.mtp_depth)


def _get(tree, path):
    for name in path:
        tree = tree[name]
    return tree


def test_bridge_bfloat16_is_bit_exact():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 97), jnp.bfloat16))
    t = bridge.tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))


def test_init_params_distributions():
    model = build_model(get_config("qwen3-4b", reduced=True), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    blk = params["dense_blocks"][0]
    assert torch.equal(blk["attn_norm"]["s"], torch.ones(256))
    w = blk["mlp"]["gate_up"]["w"]  # fan-in 256: std 1/16
    assert abs(w.std().item() - 1 / 16) < 2e-3 and abs(w.mean().item()) < 2e-3
    e = params["embed"]["w"]  # embed init: std 0.02
    assert abs(e.std().item() - 0.02) < 1e-3
    # the per-layer blocks are views of one stacked allocation
    w1 = params["dense_blocks"][1]["mlp"]["gate_up"]["w"]
    assert w1.untyped_storage().data_ptr() == w.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# Layers and one serve_step.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    """f32: atol 1e-5; bf16: one bf16 ulp (2 ** -7 relative) — both mirror
    the same rounding points, so bf16 differs only where an f32 value
    rounds the other way."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    w1 = (0.2 * rng.standard_normal((16, 24))).astype(np.float32)
    w2 = (0.2 * rng.standard_normal((12, 16))).astype(np.float32)
    pos = rng.integers(0, 1000, size=(2, 3)).astype(np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2 ** -7, atol=2 ** -7))

    def t(a):
        return torch.from_numpy(a).to(tdt)

    def j(a):
        return jnp.asarray(a, jdt)

    def cmp(got, want):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)

    inf = jnp.inf
    cmp(L.rmsnorm({"s": t(s)}, t(x)), JL.rmsnorm({"s": j(s)}, j(x), inf))
    cmp(L.apply_rope(t(x), torch.from_numpy(pos), 1e6),
        JL.apply_rope(j(x), jnp.asarray(pos), 1e6))
    mlp_t = {"gate_up": {"w": t(w1)}, "down": {"w": t(w2)}}
    mlp_j = {"gate_up": {"w": j(w1)}, "down": {"w": j(w2)}}
    cmp(L.swiglu(mlp_t, t(x), f=12),
        JL.swiglu(mlp_j, j(x), {"gate_up": inf, "down": inf}, f=12))


def _pool_keys(cache):
    return [k for k in cache if k.endswith("pool")]


def _pool_state(jm, cfg, slots, cache_len, num_pages, page_len, seed):
    """A numpy paged cache with random pool contents, ragged positions, a
    ragged table with trash-mapped tails, and one retired slot whose pos
    sits at the end of its capacity."""
    rng = np.random.default_rng(seed)
    cache = jax.tree_util.tree_map(
        np.asarray, jm.init_paged_cache(slots, cache_len,
                                        num_pages=num_pages,
                                        page_len=page_len))
    for k in _pool_keys(cache):
        cache[k] = rng.standard_normal(cache[k].shape).astype(np.float32)
    p_tab = cache["pt"].shape[1]
    pos = rng.integers(0, cache_len - 1, size=slots).astype(np.int32)
    pos[-1] = cache_len  # retired slot: past the last page
    perm = rng.permutation(num_pages)
    pt = np.full((slots, p_tab), num_pages, np.int32)
    for i in range(slots):
        used = min(pos[i] // page_len + 1, p_tab)
        pt[i, :used] = perm[i * p_tab: i * p_tab + used]
    cache["pos"], cache["pt"] = pos, pt
    return cache


def _check_serve_step(model, params, jm, jp, active):
    """One decode step of both packages from an identical pool state:
    logits and every pool row atol 1e-4 (f32; XLA and torch sum in other
    orders); the pools hold the same keys."""
    cfg = model.cfg
    slots, cache_len, page_len = active.size, 32, 8
    num_pages = slots * cache_len // page_len
    cache_np = _pool_state(jm, cfg, slots, cache_len, num_pages, page_len, 5)
    rng = np.random.default_rng(9)
    token = rng.integers(0, cfg.vocab_size, size=(slots, 1)).astype(np.int32)

    jcache = jax.tree_util.tree_map(jnp.asarray, cache_np)
    want_logits, want_cache = jm.serve_step(
        jp, jcache, {"token": jnp.asarray(token),
                     "active": jnp.asarray(active)})
    cache = bridge.cache_from_numpy(cache_np, "cpu")
    assert sorted(model.init_paged_cache(
        slots, cache_len, num_pages=num_pages, page_len=page_len)) == \
        sorted(cache_np)
    logits, new_cache = model.serve_step(
        params, cache, {"token": torch.from_numpy(token),
                        "active": torch.from_numpy(active)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(new_cache["pos"].numpy(),
                                  np.asarray(want_cache["pos"]))
    for k in _pool_keys(cache_np):
        got, want = new_cache[k].numpy(), np.asarray(want_cache[k])
        # only the active rows' live pages and the trash page changed
        np.testing.assert_allclose(got[:, :-1], want[:, :-1], rtol=1e-4,
                                   atol=1e-4)
        assert not np.array_equal(got[:, :-1], cache_np[k][:, :-1])


@pytest.mark.parametrize("name", ARCHS)
def test_serve_step_matches_reference(name):
    cfg, model, params, jm, jp = _both(name)
    _check_serve_step(model, params, jm, jp,
                      np.array([True, True, False, False]))


# test-local capacity factor: 16 rows choose k = 2 of E = 4 experts, 32
# choices for the capacity floor of 8 slots an expert
OVERFLOW_CAPACITY_FACTOR = 0.25


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_serve_step_capacity_overflow(name, monkeypatch):
    """A decode step whose expert choices overflow their capacity, with 7
    of its 16 rows inactive: the inactive rows are routed with the rest
    and take expert slots, as in the reference, so both packages drop the
    same choices and agree in logits and pools."""
    cfg, model, params, jm, jp = _both(
        name, capacity_factor=OVERFLOW_CAPACITY_FACTOR)
    real, loads = MOE.moe_block, []

    def recording(cfg_, p, x, th=None):
        n = x.shape[0] * x.shape[1]
        probs = torch.softmax((x.reshape(n, -1) @ p["router"]["w"]).float(),
                              dim=-1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True
                         ).indices[:, :cfg_.num_experts_per_tok]
        loads.append((int(torch.bincount(top.reshape(-1)).max()),
                       MOE.capacity(cfg_, n)))
        return real(cfg_, p, x, th)

    monkeypatch.setattr(MOE, "moe_block", recording)
    active = np.ones(16, bool)
    active[[1, 4, 5, 8, 11, 12, 15]] = False
    _check_serve_step(model, params, jm, jp, active)
    assert loads and any(most > cap for most, cap in loads), loads


# ---------------------------------------------------------------------------
# DecodeEngine token for token.
# ---------------------------------------------------------------------------


def _assert_tokens_match(model, params, prompt, got, want, page_len):
    """Token for token, or a tie at the first divergence (module doc)."""
    if got == want:
        return
    i = next(k for k, (a, b) in enumerate(zip(got, want)) if a != b)
    logits = serve.last_logits(model, params, list(prompt) + list(got[:i]),
                               page_len)
    top2 = torch.topk(logits, 2).values
    gap = float(top2[0] - top2[1])
    assert gap < TIE_GAP, (f"tokens diverge at {i} with top-2 gap {gap}: "
                           f"{got} vs {want}")


def _scenario(eng, sys_p, rng, vocab):
    """Ragged prompts, a shared prefix, mid-flight admission, then a
    request that needs the whole pool (spilling the registered prefixes)
    and one that hits the spilled prefix (readmission)."""
    def req(n):
        return np.concatenate([sys_p, rng.integers(1, vocab, n)
                               ]).astype(np.int32)

    reqs = [(req(5), 10)]
    eng.submit(*reqs[0])
    for _ in range(3):  # admitted, prefix registered, mid-decode
        eng.step()
    for r in [(req(9), 6), (rng.integers(1, vocab, 13).astype(np.int32), 8),
              (req(2), 5)]:
        reqs.append(r)
        eng.submit(*r)
    eng.run()
    big = (rng.integers(1, vocab, 40).astype(np.int32), 24)  # 8 pages
    reqs.append(big)
    eng.submit(*big)
    eng.run()
    reqs.append((req(6), 7))
    eng.submit(*reqs[-1])
    done = eng.run()
    return reqs, done


@pytest.mark.parametrize("name", ARCHS)
def test_engine_matches_reference_engine(name):
    cfg, model, params, jm, jp = _both(name)
    kw = dict(num_slots=2, cache_len=64, page_len=8, num_pages=8)
    sys_p = np.random.default_rng(11).integers(1, cfg.vocab_size, 20)
    results = []
    for eng in (JaxEngine(jm, jp, **kw), DecodeEngine(model, params, **kw)):
        rng = np.random.default_rng(4)
        reqs, done = _scenario(eng, sys_p.astype(np.int32), rng,
                               cfg.vocab_size)
        results.append((eng, reqs, done))
    (jeng, reqs, want), (eng, reqs_t, got) = results
    for (r, g), (rt, gt) in zip(reqs, reqs_t):
        np.testing.assert_array_equal(r, rt)
    assert sorted(got) == sorted(want) == list(range(len(reqs)))
    for rid, (prompt, gen) in enumerate(reqs):
        assert len(got[rid].tokens) == gen
        _assert_tokens_match(model, params, prompt, got[rid].tokens,
                             want[rid].tokens, 8)
    for k in ("prefill_dispatches", "decode_dispatches", "prefix_hits",
              "shared_pages", "evicted_pages", "readmitted_pages",
              "admission_deferrals", "peak_pages_in_use"):
        assert eng.stats[k] == jeng.stats[k], k
    assert eng.stats["prefix_hits"] >= 2
    assert eng.stats["evicted_pages"] >= 2
    assert eng.stats["readmitted_pages"] >= 2
    assert eng.stats["serve_steps"] == (
        eng.stats["prefill_dispatches"] * 8 + eng.stats["decode_dispatches"])


@pytest.mark.parametrize("name", ARCHS)
def test_engine_cache_bytes_counts_every_pool(name):
    """`cache_bytes` counts every layer stack's pools (GQA's k and v, or
    MLA's latent pool of kv_lora_rank + rope per token), the table and
    pos: the bytes of the reference's paged cache for the same engine."""
    cfg, model, params, jm, _ = _both(name)
    eng = DecodeEngine(model, params, num_slots=2, cache_len=32, page_len=8,
                       num_pages=6)
    jcache = jm.init_paged_cache(2, 32, num_pages=6, page_len=8)
    assert eng.cache_bytes() == sum(v.nbytes for v in jcache.values())
    if cfg.attention_kind == "mla":
        row = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    else:
        row = 2 * cfg.num_kv_heads * cfg.resolved_head_dim
    assert eng.cache_bytes() == 4 * (cfg.num_layers * 7 * 8 * row + 2 * 4
                                     + 2)


@pytest.mark.parametrize("kw", [
    dict(host_spill=False),                      # evicted prefixes dropped
    dict(prefill_chunk=4, prefill_skew_chunks=0),  # skew cap splits batches
    dict(eos="first"),                           # EOS retirement
], ids=["no_spill", "skew_cap", "eos"])
def test_engine_options_match_reference_engine(kw):
    """The engine options against the reference engine on tiny: the same
    tokens, finish reasons and bookkeeping."""
    cfg, model, params, jm, jp = _both("tiny")
    kw = dict(kw)
    eos = kw.pop("eos", None)
    rng = np.random.default_rng(6)
    sys_p = rng.integers(1, cfg.vocab_size, 17).astype(np.int32)
    reqs = [(np.concatenate([sys_p, rng.integers(1, cfg.vocab_size, n)])
             .astype(np.int32), g) for n, g in ((3, 9), (11, 5), (30, 12))]
    reqs.insert(2, (rng.integers(1, cfg.vocab_size, 40).astype(np.int32), 20))
    if eos is not None:
        # the first token the port emits for the first request becomes EOS
        probe = DecodeEngine(model, params, num_slots=1, cache_len=64,
                             page_len=8)
        probe.submit(*reqs[0])
        kw["eos_id"] = probe.run()[0].tokens[0]
    runs = []
    for cls, m, p in ((JaxEngine, jm, jp), (DecodeEngine, model, params)):
        eng = cls(m, p, num_slots=2, cache_len=64, page_len=8, num_pages=8,
                  **kw)
        for r in reqs:
            eng.submit(*r)
        runs.append((eng, eng.run()))
    (jeng, want), (eng, got) = runs
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason, rid
    for k in jeng.stats:
        if k in eng.stats:
            assert eng.stats[k] == jeng.stats[k], k
    if eos is not None:
        assert got[0].finish_reason == "eos" and got[0].tokens == [
            kw["eos_id"]]
    if "host_spill" in kw:
        assert eng.stats["evicted_pages"] > 0
        assert eng.stats["readmitted_pages"] == 0
    if "prefill_skew_chunks" in kw:
        assert eng.stats["prefill_pad_chunks_saved"] > 0


def test_engine_refuses_unported_planes():
    """What the reference refuses: paging='on' on a sliding-window config
    (its ring keeps the contiguous plane), and a cache_len that is not a
    multiple of page_len under 'on'; 'auto' falls back to contiguous in
    both cases."""
    cfg, model, params, _, _ = _both("tiny", sliding_window=8)
    with pytest.raises(ValueError, match="ring-window"):
        DecodeEngine(model, params, num_slots=2, cache_len=64, paging="on")
    assert not DecodeEngine(model, params, num_slots=2, cache_len=64).paged
    cfg, model, params, _, _ = _both("tiny")
    with pytest.raises(ValueError, match="divisible"):
        DecodeEngine(model, params, num_slots=2, cache_len=60, page_len=16,
                     paging="on")
    assert not DecodeEngine(model, params, num_slots=2, cache_len=60,
                            page_len=16).paged


# ---------------------------------------------------------------------------
# The copied launch.pages, unit by unit on both copies.
# ---------------------------------------------------------------------------

PAGES = pytest.mark.parametrize("pg", [jax_pages, torch_pages],
                                ids=["reference", "port"])


@PAGES
def test_pages_needed(pg):
    assert [pg.pages_needed(n, 16) for n in (0, 1, 16, 17)] == [0, 1, 1, 2]


@PAGES
def test_pool_alloc_refcount_free(pg):
    pool = pg.PagePool(4, 16)
    a = pool.alloc(3)
    assert len(a) == 3 and pool.num_free == 1 and pool.num_used == 3
    assert pool.alloc(2) is None and pool.num_free == 1
    pool.incref([a[0]])
    assert pool.decref([a[0]]) == []
    assert pool.decref(a) == a and pool.num_free == 4
    with pytest.raises(ValueError):
        pool.decref([a[0]])
    with pytest.raises(ValueError):
        pool.incref([a[0]])


@PAGES
def test_pool_lifo_reuse(pg):
    pool = pg.PagePool(4, 8)
    a = pool.alloc(2)
    pool.decref(a)
    assert pool.alloc(2) == a[::-1]


@PAGES
def test_prefix_probe_longest_and_tail_token_rule(pg):
    pool = pg.PagePool(8, 4)
    store = pg.PrefixStore(pool)
    toks = np.arange(100, 112, dtype=np.int32)
    pages = pool.alloc(3)
    assert store.register(toks, pages)
    probe = store.probe(np.concatenate([toks, [7, 8]]))
    assert probe[1] == 3 and probe[2] == "device"
    assert store.probe(toks[:9])[1] == 2
    assert store.probe(toks)[1] == 2
    assert store.probe(toks[:4]) is None
    rc = [pool.refcount(p) for p in pages]
    assert not store.register(toks, pages)
    assert [pool.refcount(p) for p in pages] == rc


@PAGES
def test_prefix_evict_spill_readmit_key_movement(pg):
    pool = pg.PagePool(8, 4)
    store = pg.PrefixStore(pool)
    t1 = np.arange(0, 8, dtype=np.int32)
    t2 = np.arange(50, 58, dtype=np.int32)
    p1, p2 = pool.alloc(2), pool.alloc(2)
    store.register(t1, p1)
    store.register(t2, p2)
    pool.decref(p1), pool.decref(p2)
    store.probe(np.concatenate([t1, [9]]))
    entry = store.evict_lru()
    assert entry.tokens.tolist() == t2.tolist()
    assert sorted(store.spill(entry, {"k": np.zeros((1, 2, 4, 3))})) == \
        sorted(p2)
    assert entry.tier == "host" and entry.n_pages == 2
    assert store.probe(np.concatenate([t2, [9]]))[2] == "host"
    store.readmit(entry, pool.alloc(2))
    assert store.probe(np.concatenate([t2, [9]]))[2] == "device"
    assert store.num_host_entries == 0 and store.num_device_entries == 2


@PAGES
def test_prefix_evictable_pages_counts_registry_only_refs(pg):
    pool = pg.PagePool(8, 4)
    store = pg.PrefixStore(pool)
    pages = pool.alloc(2)
    store.register(np.arange(0, 8, dtype=np.int32), pages)
    pool.decref(pages)
    pool.incref([pages[0]])
    assert store.evictable_pages() == 1


# ---------------------------------------------------------------------------
# The serve CLI.
# ---------------------------------------------------------------------------


# the reference CLI's bookkeeping for the same flags (`python -m
# repro.launch.serve ... --paging on`): same request set, same engine
CLI_STATS = {
    "default_pool": "dispatches=15d+8p paged=yes pages=14x8 peak_pages=13 "
                    "prefix_hits=3 shared=6 evicted=0 readmitted=0 ",
    "starved_pool": "dispatches=16d+12p paged=yes pages=8x8 peak_pages=8 "
                    "prefix_hits=4 shared=8 evicted=2 readmitted=3 ",
}


@pytest.mark.parametrize("pool", sorted(CLI_STATS))
def test_serve_cli_cpu(capsys, pool):
    extra = ["--num-pages", "8"] if pool == "starved_pool" else []
    assert serve.main(["--arch", "tiny", "--batch", "5", "--slots", "2",
                       "--prompt-len", "20", "--min-prompt-len", "4",
                       "--gen", "6", "--page-len", "8", "--shared-prefix",
                       "16", "--device", "cpu"] + extra) == 0
    out = capsys.readouterr().out
    assert "arch=tiny device=cpu mode=engine batch=5" in out
    assert CLI_STATS[pool] in out
    rows = [ln for ln in out.splitlines() if ln.lstrip().startswith("[")]
    assert len(rows) == 5 and "-1" not in out.split("\n", 1)[1]


def test_serve_cli_requests_match_reference():
    """The CLI's request set is the reference CLI's for the same flags."""
    reqs = serve.build_requests(257, 4, min_len=4, max_len=20,
                                shared_prefix=16, seed=0)
    from repro.launch.inputs import synthetic_requests
    want = synthetic_requests(257, 4, min_len=4, max_len=20, seed=1)
    for r, w in zip(reqs, want):
        np.testing.assert_array_equal(r[16:], w)
        np.testing.assert_array_equal(r[:16], reqs[0][:16])


@pytest.mark.parametrize("argv", [["--autotune", "off"], ["--cache", "off"],
                                  ["--backend", "xla"], ["--cache-dir", "x"],
                                  ["--arch", "rwkv6-7b"]])
def test_serve_cli_refuses_unported_flags(argv):
    with pytest.raises(SystemExit):
        serve.build_serve_parser().parse_args(argv)


def test_unported_arch_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP.md item A.8"):
        get_config("zamba2-7b")
