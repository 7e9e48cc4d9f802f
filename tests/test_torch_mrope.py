"""Qwen2-VL's M-RoPE decoder in the port against the JAX package, on the
CPU in f32 (qwen2-vl-72b-reduced: 2 layers, d_model 256, 4 heads over 2
KV heads of 64, sections (8, 12, 12)), one numpy parameter tree crossed
by the bridge.

* `apply_m_rope` with three distinct streams against the reference's,
  and with equal streams bit for bit the port's `apply_rope`;
* the layout (reduced and full size: 72.7 B parameters, 483 groups);
* per-example losses with stub patch embeddings and distinct position
  streams in Qwen2-VL's layout (a 2 x 3 grid of patches: t constant, h
  the row, w the column; the text continuing from one past the largest),
  with (B, 3, T) `positions3` and no patches, and text alone; the
  per_layer and BK ghost_flat clipped gradients with the patches;
* a noised per_layer step and a DP-LoRA step (rank 4, per_layer and
  ghost_flat by BK) with the patches, on the reference's noise draws;
* `prefill_step` with the patches; the paged engine's tokens against the
  reference's engine and the loop oracle;
* the kernel calls of a step against `chip_smoke.py:expected_launches`;
  the train CLI on text-only batches and the serve CLI on the paged
  plane.

Tolerances: rtol 1e-5 and an atol of 1e-6 of the largest magnitude for
M-RoPE; losses and logits 1e-4; clipped gradients rtol 1e-5 and an atol
of 1e-5 of a leaf's largest magnitude (1e-4 after a noised step); tokens
exactly.
"""
import dataclasses
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
from repro_torch.core.spec import tree_leaves
from repro_torch.kernels import fused_clip as FC
from repro_torch.launch import serve, train
from repro_torch.launch.engine import DecodeEngine
from repro_torch.launch.inputs import mrope_grid_positions
from repro_torch.models import layers as L
from repro_torch.models.transformer import build_model
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
ARCH = "qwen2-vl-72b"
B, T_TEXT, GRID = 3, 8, (2, 3)
FALLBACK = "falling back to the twopass"


@functools.lru_cache(maxsize=None)
def _models(lora_rank=0):
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              lora_rank=lora_rank)
    jcfg = dataclasses.replace(jax_get_config(ARCH, reduced=True),
                               lora_rank=lora_rank)
    return build_model(cfg, device="cpu"), jax_build_model(jcfg)


def _tree(m, seed=0):
    """A numpy tree; an adapter's b drawn non-zero (a fresh b is zero)."""
    tree = bridge.numpy_params(m.spec, seed=seed)
    rng = np.random.default_rng(seed + 50)
    for path, leaf in tree_leaves(tree.get("lora", {})):
        if path[-1] == "b":
            node = tree["lora"]
            for k in path[:-1]:
                node = node[k]
            node["b"] = (0.05 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
    return tree


def _batch(vocab, d, kind="vision", b=B, seed=1):
    """Tokens and targets (-1 at each end, a ragged example), and by
    `kind`: 'vision' the grid's patch embeddings with `positions3_full`
    in Qwen2-VL's layout, 'positions3' distinct (B, 3, T) streams alone,
    'text' nothing more."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, T_TEXT)).astype(np.int32)
    targets = np.roll(tokens, -1, 1)
    targets[:, -1] = -1
    targets[-1, 5:] = -1
    batch = {"tokens": tokens, "targets": targets}
    tv = GRID[0] * GRID[1]
    if kind == "vision":
        batch["vision_embeds"] = (0.5 * rng.standard_normal(
            (b, tv, d))).astype(np.float32)
        batch["positions3_full"] = mrope_grid_positions(
            b, GRID, T_TEXT).numpy()
    elif kind == "positions3":
        # a text stream, then (h, w) streams of their own
        p = np.arange(T_TEXT, dtype=np.int32)
        batch["positions3"] = np.stack(
            [p, p // 3, (5 * p) % 7])[None].repeat(b, 0).astype(np.int32)
    return batch


def _close(got, want, rtol=1e-4, atol=1e-4):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.detach().float().numpy(), want, rtol=rtol,
        atol=atol * max(float(np.abs(want).max()), 1e-30))


# ---------------------------------------------------------------------------
# M-RoPE.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd,sections", [(64, (8, 12, 12)), (16, (4, 2, 2)),
                                         (128, (16, 24, 24))])
def test_apply_m_rope_matches_reference_and_equal_streams_are_rope(
        hd, sections):
    """Distinct streams (Qwen2-VL's grid, then text): the reference's
    rotation; equal streams: the port's `apply_rope` bit for bit, and a
    wrong section split would differ there only where streams differ."""
    rng = np.random.default_rng(hd)
    b, t, h = 2, 13, 3
    x = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    pos3 = mrope_grid_positions(b, (3, 2), t - 6).movedim(1, 0)
    want = JL.apply_m_rope(jnp.asarray(x), jnp.asarray(pos3.numpy()), 1e6,
                           sections)
    got = L.apply_m_rope(T(x), pos3, 1e6, sections)
    _close(got, want, rtol=1e-5, atol=1e-6)
    assert not torch.allclose(got, L.apply_rope(T(x), pos3[0], 1e6))
    swapped = (sections[0], sections[2], sections[1])
    if swapped != sections:
        assert not torch.allclose(got, L.apply_m_rope(T(x), pos3, 1e6,
                                                      swapped))
    p1 = pos3[2]
    assert torch.equal(L.apply_m_rope(T(x), p1.expand(3, b, t), 1e6,
                                      sections),
                       L.apply_rope(T(x), p1, 1e6))
    with pytest.raises(ValueError, match="sum to"):
        L.apply_m_rope(T(x), pos3, 1e6, (1, 1, 1))


@pytest.mark.parametrize("reduced", [True, False])
def test_layout_matches_reference(reduced):
    """Built from the spec alone (the full model allocates nothing)."""
    m = build_model(get_config(ARCH, reduced=reduced), device="cpu")
    jm = jax_build_model(jax_get_config(ARCH, reduced=reduced))
    assert [(g.name, g.stack_shape, g.dim, g.offset, g.sensitivity_mult)
            for g in m.layout.groups] == [
        (g.name, tuple(g.stack_shape), g.dim, g.offset, g.sensitivity_mult)
        for g in jm.layout.groups]
    assert m.num_params == jm.num_params
    if not reduced:
        assert (m.num_params, m.layout.num_groups) == (72_705_384_448, 483)
    assert m.init_paged_cache is not None


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["vision", "positions3", "text"])
def test_losses_match_reference(kind):
    m, jm = _models()
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size, m.cfg.d_model, kind)
    th = m.layout.pack_value(float("inf"), B)
    got = m.loss_fn(bridge.train_params_from_numpy(tree, "cpu"), _t(batch),
                    th)
    want = jm.loss_fn(_j(tree), _j(batch), jm.layout.pack_value(jnp.inf, B))
    _close(got, want)


@pytest.mark.parametrize("mode,execution", [("per_layer", "bk"),
                                            ("ghost_flat", "bk")])
def test_clipped_gradients_with_patches_match_reference(mode, execution):
    """Loss, (K, B) norms² and every clipped gradient leaf; BK (one
    backward, the epilogue) does not fall back."""
    m, jm = _models()
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size, m.cfg.d_model)
    kw = ({"thresholds": np.random.default_rng(2).uniform(
        0.05, 2.0, m.layout.num_groups).astype(np.float32)}
          if mode == "per_layer" else {"flat_threshold": np.float32(0.5)})
    with jax_backend.scoped("xla"):
        want = jax.jit(functools.partial(
            jax_clip, jm.loss_fn, layout=jm.layout, mode=mode, batch_size=B,
            execution=execution))(
            _j(tree), _j(batch), **{k: jnp.asarray(v) for k, v in kw.items()})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = dp_clipped_gradients(
            m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"),
            _t(batch), m.layout, mode=mode, batch_size=B,
            execution=execution, **{k: T(np.asarray(v)) for k, v in
                                    kw.items()})
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-6)
    np.testing.assert_allclose(got.norms_sq.numpy(),
                               np.asarray(want.norms_sq), rtol=1e-5,
                               atol=1e-9)
    assert_trees_close(got.grads, want.grads)


def _noise_from(monkeypatch, cur):
    monkeypatch.setattr(dp_sgd, "standard_normal",
                        lambda path, shape, rows, gen: T(cur["z"][path][rows]))
    monkeypatch.setattr(Q, "count_noise", lambda shape, gen: T(cur["zq"]))


def test_noised_per_layer_step_matches_reference_with_its_draws(
        monkeypatch):
    """One noised Adam step with the patches and distinct streams: the
    metrics, thresholds, parameters and first moments."""
    m, jm = _models()
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size, m.cfg.d_model, seed=4)
    kw = dict(mode="per_layer", sigma=0.7, sampling_rate=0.05, steps=10,
              init_threshold=0.5, noise_strategy="weighted")
    j_init, j_step, j_plan = JSGD.make_dp_train_step(
        jm.loss_fn, jm.spec, jm.layout, joptim.adam(1e-2),
        JSGD.DPConfig(backend="xla", **kw), batch_size=B)
    p_init, p_step, _ = dp_sgd.make_dp_train_step(
        m.loss_fn, m.spec, m.layout, optim.adam(1e-2),
        dp_sgd.DPConfig(backend="kernels", **kw), batch_size=B)
    key = jax.random.PRNGKey(7)
    cur = {}
    _noise_from(monkeypatch, cur)
    cur["z"], cur["zq"] = _reference_draws(jm.spec, m.layout.num_groups,
                                           key, 0)
    jp = _j(tree)
    jo, jd = j_init(jp)
    with jax_backend.scoped("xla"):
        jp, jo, jd, jmet = jax.jit(j_step)(jp, jo, jd, _j(batch), key)
    pp = bridge.train_params_from_numpy(tree, "cpu")
    po, pd = p_init(pp)
    pp, po, pd, pmet = p_step(pp, po, pd, _t(batch), 0)
    np.testing.assert_allclose([float(x) for x in pmet],
                               [float(x) for x in jmet], rtol=1e-4)
    assert 0.0 < float(pmet.clip_fraction) < 1.0
    np.testing.assert_allclose(pd.qstate.thresholds.numpy(),
                               np.asarray(jd.qstate.thresholds), rtol=1e-5)
    assert_trees_close(pp, jp, atol_frac=1e-4)
    assert_trees_close(po.mu, jo.mu, atol_frac=1e-4)


@pytest.mark.parametrize("mode", ["per_layer", "ghost_flat"])
def test_dp_lora_step_under_mrope_matches_reference_with_its_draws(
        mode, monkeypatch):
    """Rank-4 adapters on qkv and o (one group a pair), the base frozen,
    M-RoPE with the patches: one noised Adam step (ghost_flat by BK in
    both packages, no fallback); the base bit for bit unchanged."""
    m, jm = _models(lora_rank=4)
    tree = _tree(m)
    batch = _batch(m.cfg.vocab_size, m.cfg.d_model, seed=6)
    kw = dict(mode=mode, sigma=0.7, sampling_rate=0.05, steps=10,
              init_threshold=0.5)
    j_init, j_step, j_plan = JSGD.make_dp_train_step(
        jm.loss_fn, jm.dp_spec, jm.layout, joptim.adam(1e-2),
        JSGD.DPConfig(backend="xla", **kw), batch_size=B,
        trainable_key="lora")
    p_init, p_step, _ = dp_sgd.make_dp_train_step(
        m.loss_fn, m.dp_spec, m.layout, optim.adam(1e-2),
        dp_sgd.DPConfig(backend="kernels", **kw), batch_size=B,
        trainable_key="lora")
    key = jax.random.PRNGKey(9)
    cur = {}
    _noise_from(monkeypatch, cur)
    cur["z"], cur["zq"] = _reference_draws(
        jm.dp_spec, max(j_plan.num_noise_groups, 1), key, 0)
    jp = _j(tree)
    jo, jd = j_init(jp)
    with jax_backend.scoped("xla"):
        jp, jo, jd, jmet = jax.jit(j_step)(jp, jo, jd, _j(batch), key)
    pp = bridge.train_params_from_numpy(tree, "cpu")
    for _, leaf in tree_leaves({k: v for k, v in pp.items() if k != "lora"}):
        leaf.requires_grad_(False)
    po, pd = p_init(pp)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pp, po, pd, pmet = p_step(pp, po, pd, _t(batch), 0)
    np.testing.assert_allclose([float(x) for x in pmet],
                               [float(x) for x in jmet], rtol=1e-4)
    assert_trees_close(pp["lora"], jp["lora"], atol_frac=1e-4)
    for name, leaf in tree_leaves({k: v for k, v in pp.items()
                                   if k != "lora"}):
        want = dict(tree_leaves({k: v for k, v in tree.items()
                                 if k != "lora"}))[name]
        np.testing.assert_array_equal(leaf.numpy(), want, err_msg=name)


@pytest.mark.parametrize("label,mode,execution", [
    ("per_layer", "per_layer", "bk"), ("ghost_flat_bk", "ghost_flat", "bk"),
    ("non_private", "non_private", "bk")])
def test_kernel_calls_per_step_follow_expected_launches(
        label, mode, execution, monkeypatch):
    """The wrappers' calls of one Trainer step (the patches added to its
    batch) are `chip_smoke.py:expected_launches` of the layout: the
    gate phase 20 holds the card's launch counters to."""
    calls = _count_calls(monkeypatch, scale_contract=True)
    args = train.build_train_parser().parse_args(
        ["--arch", ARCH, "--reduced", "--clipping", mode, "--execution",
         execution, "--steps", "2", "--batch", "2", "--seq", "8", "--docs",
         "4", "--device", "cpu"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        trainer = train.Trainer(args)
        text = trainer.next_batch

        def with_patches():
            batch = text()
            b, t = batch["tokens"].shape
            gen = torch.Generator().manual_seed(3)
            batch["vision_embeds"] = torch.randn(
                (b, 6, trainer.cfg.d_model), generator=gen)
            batch["positions3_full"] = mrope_grid_positions(b, GRID, t)
            return batch

        trainer.next_batch = with_patches
        met = trainer.step()
    want = C.expected_launches(label, trainer.cfg, batch=2)
    assert calls == {k: want[k] for k in calls}
    assert want["ghost_norm_blocked"] == 0
    assert np.isfinite(float(met.loss)) and np.isfinite(float(met.grad_norm))


def test_train_cli_trains_text_only_batches(capsys):
    assert train.main(["--arch", ARCH, "--reduced", "--clipping",
                       "per_layer", "--steps", "2", "--batch", "2", "--seq",
                       "8", "--docs", "8", "--log-every", "1", "--device",
                       "cpu", "--cache", "off"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH}-reduced" in out
    losses = [float(ln.split()[3]) for ln in out.splitlines()
              if ln.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all()


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------


def test_prefill_step_with_patches_matches_reference():
    m, jm = _models()
    tree = bridge.numpy_params(m.spec, seed=0)
    params = bridge.params_from_numpy(tree, "cpu")
    for kind in ("vision", "text"):
        batch = _batch(m.cfg.vocab_size, m.cfg.d_model, kind, seed=8)
        batch.pop("targets")
        _close(m.prefill_step(params, _t(batch)),
               jm.prefill_step(_j(tree), _j(batch)))


def test_paged_engine_tokens_match_reference():
    """Decoding is the dense one on 1-D RoPE: 3 requests through 2 slots
    of the paged plane, one admitted into a recycled slot; the tokens
    equal the reference engine's and each request alone by the loop."""
    m, jm = _models()
    tree = bridge.numpy_params(m.spec, seed=0)
    params, jparams = bridge.params_from_numpy(tree, "cpu"), _j(tree)
    reqs = synthetic_requests(m.cfg.vocab_size, 3, min_len=3, max_len=9,
                              seed=1)
    eng = DecodeEngine(m, params, num_slots=2, cache_len=32,
                       prefill_chunk=4)
    assert eng.paged
    rids = [eng.submit(r, max_new_tokens=6) for r in reqs]
    done = eng.run()
    jeng = JaxEngine(jm, jparams, num_slots=2, cache_len=32, prefill_chunk=4)
    jrids = [jeng.submit(r, max_new_tokens=6) for r in reqs]
    jdone = jeng.run()
    for rid, jrid, r in zip(rids, jrids, reqs):
        alone = serve.greedy_decode(m, params, T(np.asarray(r))[None], 6,
                                    32, prefill="loop")[0].tolist()
        assert done[rid].tokens == jdone[jrid].tokens == alone


def test_serve_cli_serves_on_the_paged_plane(capsys):
    assert serve.main(["--arch", ARCH, "--reduced", "--batch", "3",
                       "--prompt-len", "10", "--min-prompt-len", "4",
                       "--gen", "5", "--slots", "2", "--device", "cpu",
                       "--cache", "off"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH}-reduced" in out and "paged=yes" in out
