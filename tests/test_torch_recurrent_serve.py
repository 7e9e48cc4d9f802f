"""Serving the recurrent and hybrid families: the port against the JAX
package on the CPU in f32, with one numpy parameter tree crossed by the
bridge (rwkv6-7b-reduced; zamba2-7b-reduced, whose shared attention
block keeps a sliding-window ring).

* `serve_step` from a non-zero cache with one row inactive, and
  `prefill_step`: logits and every cache tensor against the reference's;
  the inactive row's state bit for bit as it was;
* `init_cache` (keys, shapes, dtypes) and `cache_slot_axes` against the
  reference's; `init_paged_cache` is None and the engine keeps the
  contiguous plane under `auto`, and `paging='on'` raises;
* the counterparts of the reference's engine and batch-mode cases
  (`test_engine_recurrent_and_ring_cache_families`,
  `test_ragged_batch_matches_per_request_unpadded[rwkv6-7b]`,
  `test_ragged_batch_windowed_ring_cache`): every token equal to each
  request decoded alone by the loop oracle, in the port and in the
  reference, through recycled slots and a wrapping ring;
* the serve CLI on the CPU: engine and both batch modes give one token
  grid, on the contiguous plane; `--paging on` raises the reference's
  error.

Tolerances: logits and caches rtol 1e-5 and an atol of 1e-5 of the
largest magnitude (f32, another summation order); tokens exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.engine import DecodeEngine as JaxEngine
from repro.launch.inputs import pad_ragged_prompts, synthetic_requests
from repro.launch.serve import greedy_decode as jax_greedy
from repro.models.transformer import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models.transformer import build_model, cache_slot_axes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small torch ops (the
    recurrences step a token at a time): beside the other test workers,
    a thread per core makes them spin several times slower. Every
    comparison here is between runs under the same setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T = torch.from_numpy
ARCHS = ["rwkv6-7b", "zamba2-7b"]


def _pair(arch):
    m = build_model(get_config(arch, reduced=True), device="cpu")
    jm = jax_build_model(jax_get_config(arch, reduced=True))
    tree = bridge.numpy_params(m.spec, seed=0)
    return m, bridge.params_from_numpy(tree, "cpu"), jm, jax.tree_util.\
        tree_map(jnp.asarray, tree)


def _oracle(m, params, prompt, gen, cache_len):
    return serve.greedy_decode(m, params, T(np.asarray(prompt))[None], gen,
                               cache_len, prefill="loop")[0].tolist()


def _jax_oracle(jm, jparams, prompt, gen, cache_len):
    return np.asarray(jax_greedy(jm, jparams, jnp.asarray(prompt)[None], gen,
                                 cache_len, prefill="loop"))[0].tolist()


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.float().numpy(), want, rtol=1e-5,
        atol=1e-5 * max(float(np.abs(want).max()), 1e-30))


# ---------------------------------------------------------------------------
# serve_step, prefill_step and the caches.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_and_prefill_match_reference(arch):
    m, params, jm, jparams = _pair(arch)
    b, cache_len = 3, 12
    rng = np.random.default_rng(1)
    want_cache = jm.init_cache(b, cache_len)
    cache_np = {}
    for k, v in want_cache.items():
        if k == "pos":
            cache_np[k] = np.array([5, 2, 9], np.int32)
        else:
            cache_np[k] = (0.3 * rng.standard_normal(v.shape)).astype(
                np.float32)
    cache = bridge.cache_from_numpy(cache_np, "cpu")
    frozen = {k: v[:, 1].clone() for k, v in cache.items() if k != "pos"}
    token = np.array([[4], [7], [9]], np.int32)
    active = np.array([True, False, True])
    jl, jc = jm.serve_step(jparams, {k: jnp.asarray(v) for k, v in
                                     cache_np.items()},
                           {"token": jnp.asarray(token),
                            "active": jnp.asarray(active)})
    tl, tc = m.serve_step(params, cache, {"token": T(token),
                                          "active": T(active)})
    _close(tl[[0, 2]], np.asarray(jl)[[0, 2]])
    assert set(tc) == set(jc)
    for k in tc:
        if k == "pos":
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
            continue
        _close(tc[k], jc[k])
        assert torch.equal(tc[k][:, 1], frozen[k]), k  # the inactive row
    tokens = rng.integers(0, m.cfg.vocab_size, (2, 9)).astype(np.int32)
    _close(m.prefill_step(params, {"tokens": T(tokens)}),
           jm.prefill_step(jparams, {"tokens": jnp.asarray(tokens)}))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_slot_axes_families(arch):
    """Every contiguous-cache tensor's declared slot axis is the slot
    axis, and the cache is the reference's key for key."""
    m, _, jm, _ = _pair(arch)
    cache = m.init_cache(3, 16)
    want = jm.init_cache(3, 16)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in cache.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    axes = cache_slot_axes(cache)
    assert axes == jm.cache_slot_axes(want) and axes["pos"] == 0
    for k, v in cache.items():
        assert axes[k] is not None and v.shape[axes[k]] == 3, (arch, k)


def test_paged_cache_unsupported_families():
    m, params, _, _ = _pair("rwkv6-7b")
    assert m.init_paged_cache is None
    eng = DecodeEngine(m, params, num_slots=2, cache_len=32)
    assert not eng.paged  # auto keeps the contiguous plane
    with pytest.raises(ValueError, match="paging"):
        DecodeEngine(m, params, num_slots=2, cache_len=32, paging="on")
    z, zparams, _, _ = _pair("zamba2-7b")
    assert z.init_paged_cache is None
    assert not DecodeEngine(z, zparams, num_slots=2, cache_len=32).paged


# ---------------------------------------------------------------------------
# The engine and batch mode.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,cache_len", [("rwkv6-7b", 32),
                                            ("zamba2-7b", 12)])
def test_engine_recurrent_and_ring_cache_families(arch, cache_len):
    """Per-slot write/retire masking holds for recurrent state (RWKV-6)
    and for zamba2's Mamba2 state and its shared block's ring, which
    wraps (cache_len 12 < prompt + 8): 3 requests through 2 slots, so
    one is admitted into a recycled slot. The engine's tokens equal each
    request alone through the port's loop oracle and the reference's."""
    m, params, jm, jparams = _pair(arch)
    reqs = synthetic_requests(m.cfg.vocab_size, 3, min_len=2, max_len=7,
                              seed=1)
    eng = DecodeEngine(m, params, num_slots=2, cache_len=cache_len,
                       prefill_chunk=4)
    assert not eng.paged
    rids = [eng.submit(r, max_new_tokens=8) for r in reqs]
    done = eng.run()
    jeng = JaxEngine(jm, jparams, num_slots=2, cache_len=cache_len,
                     prefill_chunk=4)
    jrids = [jeng.submit(r, max_new_tokens=8) for r in reqs]
    jdone = jeng.run()
    for rid, jrid, r in zip(rids, jrids, reqs):
        want = _jax_oracle(jm, jparams, r, 8, cache_len)
        assert done[rid].tokens == _oracle(m, params, r, 8, cache_len) \
            == want == jdone[jrid].tokens, (arch, rid)


@pytest.mark.parametrize("arch,cache_len", [("rwkv6-7b", 32),
                                            ("zamba2-7b", 10)])
def test_ragged_batch_matches_per_request_unpadded(arch, cache_len):
    """Right-padded ragged prompts decode as each prompt alone, by the
    fused prefill and by the loop; zamba2's ring (cap = min(window, 10))
    wraps. Both equal the reference's fused batch."""
    m, params, jm, jparams = _pair(arch)
    reqs = synthetic_requests(m.cfg.vocab_size, 3, min_len=2, max_len=7,
                              seed=2)
    prompts, lengths = pad_ragged_prompts(reqs)
    assert len(set(lengths)) > 1
    got = {p: serve.greedy_decode(m, params, T(prompts), 6, cache_len,
                                  prefill=p, lengths=T(lengths)).numpy()
           for p in ("fused", "loop")}
    want = np.asarray(jax_greedy(jm, jparams, jnp.asarray(prompts), 6,
                                 cache_len, prefill="fused",
                                 lengths=jnp.asarray(lengths)))
    for i, r in enumerate(reqs):
        alone = _oracle(m, params, r, 6, cache_len)
        assert got["fused"][i].tolist() == got["loop"][i].tolist() == \
            alone == want[i].tolist()


# ---------------------------------------------------------------------------
# The serve CLI.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_recurrent_on_cpu(arch, capsys):
    """`--paging auto` lands on the contiguous plane (`paged=no`); the
    engine and both batch modes print one token grid; `--paging on`
    raises the reference's error."""
    base = ["--arch", arch, "--reduced", "--batch", "3", "--prompt-len",
            "10", "--min-prompt-len", "4", "--gen", "5", "--slots", "2",
            "--device", "cpu", "--cache", "off"]
    grids = []
    for extra in ([], ["--mode", "batch", "--prefill", "fused"],
                  ["--mode", "batch", "--prefill", "loop"]):
        assert serve.main(base + extra) == 0
        out = capsys.readouterr().out
        if not extra:
            assert "paged=no" in out
        grids.append(out.split("\n[")[-1])
    assert grids[0] == grids[1] == grids[2]
    with pytest.raises(ValueError,
                       match="ring-window / recurrent caches bypass paging"):
        serve.main(base + ["--paging", "on"])
