"""Whisper's encoder-decoder in the port against the JAX package, on the
CPU in f32 (whisper-medium-reduced: 2 encoder and 2 decoder layers,
d_model 128, 4 heads, 32 frames, a 4,096-position decode table), one
numpy parameter tree crossed by the bridge.

* `sinusoidal_positions` and the decode table `serve_step` builds once
  per device, against the reference's;
* the layout (reduced and full size: 1.01 B parameters, 388 groups) and
  the decode cache (`init_cache`, `cache_slot_axes`);
* `encode`, the per-example losses, the per_layer and BK ghost_flat
  clipped gradients (every encoder leaf takes its gradient through all
  the decoder layers' `cross/kv`; BK must not fall back), and a noised
  per_layer step and a noised ghost_flat step by BK on the reference's
  draws;
* `prefill_cross` then `serve_step` (logits, caches and greedy tokens),
  from a bridged non-zero cache with an inactive row, and
  `prefill_step`;
* the engine on the contiguous plane (`paging="on"` refused) against the
  reference's engine, both from the zero cross cache;
* the kernel calls of a step against `chip_smoke.py:expected_launches`;
  the train CLI's refusal (no frame source) and the serve CLI.

Tolerances: the table rtol 1e-5 / atol 1e-5; values (encoder output,
losses, logits, caches) rtol 1e-4 and an atol of 1e-4 of the largest
magnitude; clipped gradients rtol 1e-5 and an atol of 1e-5 of a leaf's
largest magnitude (1e-4 after a noised step); tokens exactly.
"""
import functools
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_config as jax_get_config
from repro.core import dp_sgd as JSGD
from repro.core.clipping import dp_clipped_gradients as jax_clip
from repro.kernels import backend as jax_backend
from repro.launch.engine import DecodeEngine as JaxEngine
from repro.launch.inputs import synthetic_requests
from repro.models import layers as JL
from repro.models.transformer import build_model as jax_build_model
from repro_torch import bridge, optim
from repro_torch.configs import get_config
from repro_torch.core import dp_sgd
from repro_torch.core import quantile as Q
from repro_torch.core.clipping import dp_clipped_gradients
from repro_torch.launch import serve, train
from repro_torch.launch.engine import DecodeEngine
from repro_torch.launch.inputs import concrete_train_batch
from repro_torch.models import layers as L
from repro_torch.models.transformer import build_model, cache_slot_axes
from test_torch_moe import _reference_draws
from test_torch_train import _count_calls, _j, _t, assert_trees_close

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as C  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small torch ops: beside
    the other test workers, a thread per core makes them spin several
    times slower. Every comparison here is between runs under the same
    setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T = torch.from_numpy
ARCH = "whisper-medium"
B, T_LEN = 3, 8


@functools.lru_cache(maxsize=None)
def _pair():
    """The two models and one numpy tree (built once a module)."""
    m = build_model(get_config(ARCH, reduced=True), device="cpu")
    jm = jax_build_model(jax_get_config(ARCH, reduced=True))
    return m, jm, bridge.numpy_params(m.spec, seed=0)


def _frames(cfg, b=B, seed=2):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)


def _batch(cfg, b=B, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, T_LEN)).astype(np.int32)
    targets = np.roll(tokens, -1, 1)
    targets[:, -1] = -1
    targets[-1, 5:] = -1  # a ragged example
    return {"frames": _frames(cfg, b, seed + 1), "tokens": tokens,
            "targets": targets}


def _close(got, want, rtol=1e-4, atol=1e-4):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.detach().float().numpy(), want, rtol=rtol,
        atol=atol * max(float(np.abs(want).max()), 1e-30))


# ---------------------------------------------------------------------------
# The positions, the layout and the cache.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq_len,d", [(32, 128), (4096, 128), (1500, 1024),
                                       (65536, 128)])
def test_sinusoidal_positions_match_reference(seq_len, d):
    """The reduced decode table, the full encoder's 1,500 x 1,024, and
    whisper-medium's 65,536 positions (at a narrower width): the angles
    are the reference's, the sines and cosines within a few f32 steps."""
    np.testing.assert_allclose(L.sinusoidal_positions(seq_len, d).numpy(),
                               np.asarray(JL.sinusoidal_positions(seq_len,
                                                                  d)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("reduced", [True, False])
def test_layout_and_cache_match_reference(reduced):
    """Groups one for one (the full model from its spec alone), and the
    decode cache's keys, shapes, dtypes and slot axes."""
    m = build_model(get_config(ARCH, reduced=reduced), device="cpu")
    jm = jax_build_model(jax_get_config(ARCH, reduced=reduced))
    assert [(g.name, g.stack_shape, g.dim, g.offset, g.sensitivity_mult)
            for g in m.layout.groups] == [
        (g.name, tuple(g.stack_shape), g.dim, g.offset, g.sensitivity_mult)
        for g in jm.layout.groups]
    assert m.num_params == jm.num_params
    assert m.init_paged_cache is None and m.trainable_key is None
    if not reduced:
        assert (m.num_params, m.layout.num_groups) == (1_012_314_112, 388)
        return
    cache, want = m.init_cache(3, 16), jm.init_cache(3, 16)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in cache.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    axes = cache_slot_axes(cache)
    assert axes == jm.cache_slot_axes(want) and axes["pos"] == 0
    for k, v in cache.items():
        assert v.shape[axes[k]] == 3, k


def test_lora_rank_is_refused():
    import dataclasses
    with pytest.raises(ValueError, match="DP-LoRA"):
        build_model(dataclasses.replace(get_config(ARCH, reduced=True),
                                        lora_rank=4), device="cpu")


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------


def test_encode_and_losses_match_reference():
    m, jm, tree = _pair()
    batch = _batch(m.cfg)
    params = bridge.train_params_from_numpy(tree, "cpu")
    th = m.layout.pack_value(float("inf"), B)
    jth = jm.layout.pack_value(jnp.inf, B)
    _close(m.encode(params, T(batch["frames"]), th),
           jm.encode(_j(tree), jnp.asarray(batch["frames"]), jth))
    _close(m.encode(params, T(batch["frames"])),
           jm.encode(_j(tree), jnp.asarray(batch["frames"]), jth))
    _close(m.loss_fn(params, _t(batch), th),
           jax.jit(jm.loss_fn)(_j(tree), _j(batch), jth))


@pytest.mark.parametrize("mode", ["ghost_flat"])
def test_clipped_gradients_match_reference(mode):
    """Loss, (K, B) norms² and every clipped gradient leaf before the
    noise, ghost_flat by BK (no fallback: each layer's `cross/kv` is its
    own group, consumed once); per_layer's are held by the noised step's
    first moments."""
    m, jm, tree = _pair()
    batch = _batch(m.cfg)
    kw = ({"thresholds": np.random.default_rng(2).uniform(
        0.05, 2.0, m.layout.num_groups).astype(np.float32)}
          if mode == "per_layer" else {"flat_threshold": np.float32(0.5)})
    with jax_backend.scoped("xla"):
        want = jax.jit(functools.partial(
            jax_clip, jm.loss_fn, layout=jm.layout, mode=mode, batch_size=B,
            execution="bk"))(
            _j(tree), _j(batch), **{k: jnp.asarray(v) for k, v in kw.items()})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = dp_clipped_gradients(
            m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"),
            _t(batch), m.layout, mode=mode, batch_size=B, execution="bk",
            **{k: T(np.asarray(v)) for k, v in kw.items()})
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-6)
    np.testing.assert_allclose(got.norms_sq.numpy(),
                               np.asarray(want.norms_sq), rtol=1e-5,
                               atol=1e-9)
    assert_trees_close(got.grads, want.grads)


@pytest.mark.parametrize("mode", ["per_layer", "ghost_flat"])
def test_noised_step_matches_reference_with_its_draws(mode, monkeypatch):
    """One noised Adam step (ghost_flat by BK in both packages): the
    metrics, thresholds, parameters and first moments."""
    m, jm, tree = _pair()
    batch = _batch(m.cfg, seed=5)
    kw = dict(mode=mode, sigma=0.7, sampling_rate=0.05, steps=10,
              init_threshold=0.5, noise_strategy="weighted")
    j_init, j_step, j_plan = JSGD.make_dp_train_step(
        jm.loss_fn, jm.spec, jm.layout, joptim.adam(1e-2),
        JSGD.DPConfig(backend="xla", **kw), batch_size=B)
    p_init, p_step, _ = dp_sgd.make_dp_train_step(
        m.loss_fn, m.spec, m.layout, optim.adam(1e-2),
        dp_sgd.DPConfig(backend="kernels", **kw), batch_size=B)
    key = jax.random.PRNGKey(7)
    z, zq = _reference_draws(jm.spec, max(j_plan.num_noise_groups, 1), key,
                             0)
    monkeypatch.setattr(dp_sgd, "standard_normal",
                        lambda path, shape, rows, gen: T(z[path][rows]))
    monkeypatch.setattr(Q, "count_noise", lambda shape, gen: T(zq))
    jp = _j(tree)
    jo, jd = j_init(jp)
    with jax_backend.scoped("xla"):
        jp, jo, jd, jmet = jax.jit(j_step)(jp, jo, jd, _j(batch), key)
    pp = bridge.train_params_from_numpy(tree, "cpu")
    po, pd = p_init(pp)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pp, po, pd, pmet = p_step(pp, po, pd, _t(batch), 0)
    np.testing.assert_allclose([float(x) for x in pmet],
                               [float(x) for x in jmet], rtol=1e-4)
    np.testing.assert_allclose(pd.qstate.thresholds.numpy(),
                               np.asarray(jd.qstate.thresholds), rtol=1e-5)
    assert_trees_close(pp, jp, atol_frac=1e-4)
    assert_trees_close(po.mu, jo.mu, atol_frac=1e-4)


@pytest.mark.parametrize("label,mode", [("per_layer", "per_layer"),
                                        ("ghost_flat_bk", "ghost_flat"),
                                        ("non_private", "non_private")])
def test_kernel_calls_per_step_follow_expected_launches(label, mode,
                                                        monkeypatch):
    """One Trainer step with the frames added to its batch: the wrappers'
    calls are `chip_smoke.py:expected_launches` of the layout (4 linears
    an encoder layer, 7 a decoder layer, the head), the gate phase 20
    holds the card's launch counters to."""
    calls = _count_calls(monkeypatch, scale_contract=True)
    args = train.build_train_parser().parse_args(
        ["--arch", ARCH, "--reduced", "--clipping", mode, "--steps", "2",
         "--batch", "2", "--seq", "8", "--docs", "4", "--device", "cpu"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        trainer = train.Trainer(args)
        text = trainer.next_batch
        gen = torch.Generator().manual_seed(3)

        def with_frames():
            batch = text()
            batch["frames"] = concrete_train_batch(
                trainer.cfg, batch["tokens"].shape[0], 1, gen)["frames"]
            return batch

        trainer.next_batch = with_frames
        met = trainer.step()
    want = C.expected_launches(label, trainer.cfg, batch=2)
    assert calls == {k: want[k] for k in calls}
    linears = 4 * trainer.cfg.encoder_layers + 7 * trainer.cfg.num_layers + 1
    assert {"per_layer": want["fused_norm_clip"] + want["ghost_norm"],
            "ghost_flat_bk": want["ghost_norm"],
            "non_private": want["clip_reduce"]}[label] == linears
    # BK's epilogue: one scale_contract a stacked linear leaf and the head
    assert want["scale_contract"] == (12 if label == "ghost_flat_bk" else 0)
    assert np.isfinite(float(met.loss)) and np.isfinite(float(met.grad_norm))


def test_train_cli_refuses_whisper_before_any_step(capsys):
    with pytest.raises(SystemExit, match="no frame source"):
        train.main(["--arch", ARCH, "--reduced", "--steps", "1",
                    "--device", "cpu", "--cache", "off"])
    assert "step" not in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------


def test_prefill_cross_then_serve_step_match_reference():
    """The cross caches of `prefill_cross`, then 5 greedy steps (the
    logits, every cache tensor and the tokens), then `prefill_step`."""
    m, jm, tree = _pair()
    params, jparams = bridge.params_from_numpy(tree, "cpu"), _j(tree)
    frames = _frames(m.cfg, 2, seed=9)
    cache = m.prefill_cross(params, T(frames), 2, 16)
    jcache = jm.prefill_cross(jparams, jnp.asarray(frames), 2, 16)
    for k in ("cross_k", "cross_v"):
        _close(cache[k], jcache[k])
    tok = np.array([[3], [7]], np.int32)
    jtok, ptok = jnp.asarray(tok), T(tok)
    jstep = jax.jit(jm.serve_step)
    for _ in range(5):
        logits, cache = m.serve_step(params, cache, {"token": ptok})
        jlogits, jcache = jstep(jparams, jcache, {"token": jtok})
        _close(logits, jlogits)
        ptok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        assert ptok.numpy().tolist() == np.asarray(jtok).tolist()
    for k in cache:
        _close(cache[k], jcache[k])
    batch = {"frames": frames, "tokens": np.array([[1, 5, 9, 2],
                                                   [4, 4, 0, 8]], np.int32)}
    _close(m.prefill_step(params, _t(batch)),
           jm.prefill_step(jparams, _j(batch)))


def test_serve_step_from_a_bridged_cache_keeps_inactive_rows():
    """A non-zero numpy cache crossed by the bridge, positions past the
    table's end on one row (the clamp to max_seq_len - 1): logits and
    caches as the reference's, the inactive row's bits unchanged; the
    table is built once per device and equals the reference's rows."""
    m, jm, tree = _pair()
    params, jparams = bridge.params_from_numpy(tree, "cpu"), _j(tree)
    rng = np.random.default_rng(4)
    want = jm.init_cache(3, 12)
    cache_np = {k: (np.array([5, 2, m.cfg.max_seq_len + 3], np.int32)
                    if k == "pos" else (0.3 * rng.standard_normal(
                        v.shape)).astype(np.float32))
                for k, v in want.items()}
    cache_np["pos"][2] = 11  # inside the self-attention cache
    cache = bridge.cache_from_numpy(cache_np, "cpu")
    frozen = {k: v[:, 1].clone() for k, v in cache.items() if k != "pos"}
    batch = {"token": np.array([[4], [7], [9]], np.int32),
             "active": np.array([True, False, True])}
    jl, jc = jm.serve_step(jparams, _j(cache_np), _j(batch))
    tl, tc = m.serve_step(params, cache, _t(batch))
    _close(tl[[0, 2]], np.asarray(jl)[[0, 2]])
    for k in tc:
        if k == "pos":
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
            continue
        _close(tc[k], jc[k])
        assert torch.equal(tc[k][:, 1], frozen[k]), k
    pos = np.array([[0], [m.cfg.max_seq_len + 7]], np.int32)
    cache2 = m.init_cache(2, 4)
    cache2["pos"] = T(pos[:, 0].copy())
    jc2 = {k: jnp.asarray(v.numpy()) for k, v in cache2.items()}
    tok = np.array([[1], [1]], np.int32)
    tl2, _ = m.serve_step(params, cache2, {"token": T(tok)})
    jl2, _ = jm.serve_step(jparams, jc2, {"token": jnp.asarray(tok)})
    _close(tl2, jl2)


def test_engine_on_the_contiguous_plane_matches_reference():
    """3 requests through 2 slots (one admitted into a recycled slot), from
    the zero cross cache as the reference's serve CLI serves: tokens equal
    the reference engine's and each request alone by the loop oracle;
    `paging='on'` is refused."""
    m, jm, tree = _pair()
    params, jparams = bridge.params_from_numpy(tree, "cpu"), _j(tree)
    reqs = synthetic_requests(m.cfg.vocab_size, 3, min_len=3, max_len=9,
                              seed=1)
    eng = DecodeEngine(m, params, num_slots=2, cache_len=32,
                       prefill_chunk=4)
    assert not eng.paged
    rids = [eng.submit(r, max_new_tokens=6) for r in reqs]
    done = eng.run()
    jeng = JaxEngine(jm, jparams, num_slots=2, cache_len=32, prefill_chunk=4)
    jrids = [jeng.submit(r, max_new_tokens=6) for r in reqs]
    jdone = jeng.run()
    for rid, jrid, r in zip(rids, jrids, reqs):
        alone = serve.greedy_decode(m, params, T(np.asarray(r))[None], 6,
                                    32, prefill="loop")[0].tolist()
        assert done[rid].tokens == jdone[jrid].tokens == alone
    with pytest.raises(ValueError, match="paging"):
        DecodeEngine(m, params, num_slots=2, cache_len=32, paging="on")


def test_serve_cli_serves_whisper_on_the_contiguous_plane(capsys):
    base = ["--arch", ARCH, "--reduced", "--batch", "3", "--prompt-len",
            "10", "--min-prompt-len", "4", "--gen", "5", "--slots", "2",
            "--device", "cpu", "--cache", "off"]
    grids = []
    for extra in ([], ["--mode", "batch"]):
        assert serve.main(base + extra) == 0
        out = capsys.readouterr().out
        assert f"arch={ARCH}-reduced" in out
        if not extra:
            assert "paged=no" in out
        grids.append(out.split("\n[")[-1])
    assert grids[0] == grids[1]
