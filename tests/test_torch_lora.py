"""The port's DP-LoRA training against the JAX package, on the CPU in f32.

* `dp_lora_linear`: the forward, dx, dA, dB and the pair's norms² against
  the reference's `custom_vjp` (clip, +inf and a direct scale), the pair
  one clipping group (its norm² is ||dA_i||² + ||dB_i||² of the
  per-example gradients);
* BK's `lora` recipe: equal to twopass (no fallback, MTP included),
  ghost_flat and per_group;
* a whole DP-LoRA step (`make_dp_train_step(trainable_key="lora")`):
  per_layer, ghost_flat by BK and per_group by twopass on
  qwen3-4b-reduced and deepseek-v3-reduced (MLA's kv_b and o, MoE, MTP)
  against the reference's step fed the reference's noise draws (its
  ghost_flat by BK too); the base bit for bit unchanged, the adapters
  moved;
* the kernel calls of a step, derived from the layout: 2 `ghost_norm` and
  2 `clip_reduce` per adapter pair under per_layer, 2 `ghost_norm` per
  pair and one `scale_contract` per stacked adapter leaf under BK, no
  `fused_norm_clip`, and nothing for a frozen linear;
* the serving helpers `stacked_lora_delta`, `stacked_adapter_zeros`,
  `stacked_slot_update` against the reference's;
* the train CLI's `--lora-rank`, the service's adapter publish after each
  checkpoint (none without adapters), and the sharded driver on a mesh
  of one rank, bitwise the single-device driver.

Tolerances: f32, the same math in another summation order: 1e-5 (atol
1e-5 of a leaf's largest magnitude); 1e-4 after a noised step.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_config as jax_get_config
from repro.core import dp_sgd as JDP
from repro.core import lora as JL
from repro.models.transformer import build_model as jax_build_model
from repro_torch import bridge, optim
from repro_torch.configs import get_config
from repro_torch.core import dp_sgd, lora
from repro_torch.core import quantile as Q
from repro_torch.core.clipping import (dp_clipped_gradients,
                                       sharded_clipped_gradients)
from repro_torch.core.spec import tree_leaves
from repro_torch.kernels import backend
from repro_torch.kernels import bk as SC
from repro_torch.kernels import clip_reduce as CR
from repro_torch.kernels import fused_clip as FC
from repro_torch.kernels import ghost_norm as GN
from repro_torch.launch import service, train
from repro_torch.models.transformer import build_model

from test_torch_moe import _reference_draws
from test_torch_train import _batch, _j, _leaves, _t, assert_trees_close

B = 3
ARCHS = [("qwen3-4b", True), ("deepseek-v3-671b", True)]


def _lora_models(arch, reduced, rank=4):
    cfg = dataclasses.replace(get_config(arch, reduced=reduced),
                              lora_rank=rank)
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=reduced),
                               lora_rank=rank)
    return build_model(cfg, device="cpu"), jax_build_model(jcfg)


def _tree(m, seed=0):
    """A numpy parameter tree with non-zero adapter b's (a fresh adapter's
    b is zero, so dA would be zero too)."""
    tree = bridge.numpy_params(m.spec, seed=seed)
    rng = np.random.default_rng(seed + 50)

    def fill(node):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "b":
                node[k] = (0.05 * rng.standard_normal(v.shape)).astype(
                    np.float32)

    fill(tree["lora"])
    return tree


@functools.lru_cache(maxsize=None)
def _models_cached(arch, reduced):
    return _lora_models(arch, reduced)


# ---------------------------------------------------------------------------
# The primitive.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [0.5, float("inf"), -0.7])
def test_dp_lora_linear_matches_reference_vjp(c):
    rng = np.random.default_rng(3)
    din, dout, r, alpha = 10, 6, 3, 8.0
    w = (0.3 * rng.standard_normal((din, dout))).astype(np.float32)
    a = (0.2 * rng.standard_normal((din, r))).astype(np.float32)
    bm = (0.2 * rng.standard_normal((r, dout))).astype(np.float32)
    x = rng.standard_normal((4, 7, din)).astype(np.float32)
    gy = rng.standard_normal((4, 7, dout)).astype(np.float32)
    cvec = np.full((4,), c, np.float32)

    jy, vjp = jax.vjp(lambda a_, b_, x_, c_: JL.dp_lora_linear(
        a_, b_, jnp.asarray(w), x_, c_, alpha), jnp.asarray(a),
        jnp.asarray(bm), jnp.asarray(x), jnp.asarray(cvec))
    jda, jdb, jdx, jn = vjp(jnp.asarray(gy))

    ta, tb, tx, tc = (torch.tensor(v, requires_grad=True)
                      for v in (a, bm, x, cvec))
    with backend.scoped("kernels"):
        y = lora.dp_lora_linear(ta, tb, torch.from_numpy(w), tx, tc, alpha)
        da, db, dx, n = torch.autograd.grad(y, (ta, tb, tx, tc),
                                            torch.from_numpy(gy))
    for got, want in ((y, jy), (dx, jdx), (da, jda), (db, jdb), (n, jn)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)

    # the pair is one group: its norm² is the per-example gradients'
    def single(a_, b_, xi, gi):
        return torch.sum((xi @ torch.from_numpy(w) + (xi @ a_) @ b_
                          * (alpha / r)) * gi)

    pa, pb = [], []
    for i in range(4):
        a_, b_ = (torch.tensor(v, requires_grad=True) for v in (a, bm))
        ga, gb = torch.autograd.grad(single(a_, b_, torch.from_numpy(x[i]),
                                            torch.from_numpy(gy[i])),
                                     (a_, b_))
        pa.append(ga)
        pb.append(gb)
    want_n = torch.stack([(ga ** 2).sum() + (gb ** 2).sum()
                          for ga, gb in zip(pa, pb)])
    np.testing.assert_allclose(n.numpy(), want_n.numpy(), rtol=1e-5)
    if c == 0.5:
        f = torch.clamp(0.5 / torch.sqrt(want_n + 1e-12), max=1.0)
        np.testing.assert_allclose(
            da.numpy(), sum(fi * g for fi, g in zip(f, pa)).numpy(),
            rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Clipped gradients and BK.
# ---------------------------------------------------------------------------


def _clip_kw(mode, m):
    if mode == "per_layer":
        thr = np.random.default_rng(2).uniform(
            0.05, 2.0, m.layout.num_groups).astype(np.float32)
        return {"thresholds": thr}
    if mode == "ghost_flat":
        return {"flat_threshold": 0.5}
    assign = np.arange(m.layout.num_groups) % 2
    return {"group_assignment": assign,
            "group_thresholds": np.array([0.3, 0.7], np.float32)}


@pytest.mark.parametrize("mode", ["ghost_flat", "per_group"])
def test_bk_lora_equals_twopass(mode, recwarn):
    """BK applies to the adapters' layout (no fallback, deepseek-v3's MTP
    included: its reused embed and head are frozen) and equals twopass;
    BK against the reference: `test_lora_steps_match_reference_...`."""
    m, _ = _models_cached("deepseek-v3-671b", True)
    tree = _tree(m)
    batch = _batch(m.cfg.vocab_size)
    kw = {k: torch.as_tensor(v) for k, v in _clip_kw(mode, m).items()}
    got = {}
    for ex in ("bk", "twopass"):
        params = bridge.train_params_from_numpy(tree, "cpu")
        with backend.scoped("kernels"):
            got[ex] = dp_clipped_gradients(
                m.loss_fn, params, _t(batch), m.layout, mode=mode,
                batch_size=B, trainable_key="lora", execution=ex, **kw)
    assert not [w for w in recwarn if "falling back" in str(w.message)]
    assert set(got["bk"].grads) == {"lora"}
    np.testing.assert_allclose(got["bk"].norms_sq.numpy(),
                               got["twopass"].norms_sq.numpy(), rtol=1e-6)
    assert_trees_close(got["bk"].grads, _np(got["twopass"].grads))


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else v.detach().numpy()
            for k, v in tree.items()}


def _count_calls(monkeypatch):
    calls = {"ghost_norm": 0, "clip_reduce": 0, "fused_norm_clip": 0,
             "scale_contract": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for mod, name in ((GN, "ghost_norm"), (CR, "clip_reduce"),
                      (FC, "fused_norm_clip"), (SC, "scale_contract")):
        monkeypatch.setattr(mod, name, counting(name, getattr(mod, name)))
    return calls


@pytest.mark.parametrize("mode,execution", [("per_layer", "bk"),
                                            ("ghost_flat", "bk"),
                                            ("non_private", "bk")])
def test_kernel_calls_of_a_lora_step_follow_the_layout(mode, execution,
                                                       monkeypatch):
    """Per adapter pair (a group's stack element): 2 ghost_norm, and 2
    clip_reduce (per_layer) or 1 scale_contract per stacked leaf (BK);
    non_private 2 clip_reduce and no norm; no frozen linear calls any."""
    m, _ = _models_cached("deepseek-v3-671b", True)
    tree = _tree(m)
    pairs = m.layout.num_groups
    leaves = len(list(_leaves(m.dp_spec)))
    calls = _count_calls(monkeypatch)
    params = bridge.train_params_from_numpy(tree, "cpu")
    kw = {k: torch.as_tensor(v) for k, v in _clip_kw(mode, m).items()
          } if mode != "non_private" else {}
    with backend.scoped("kernels"):
        res = dp_clipped_gradients(m.loss_fn, params, _t(_batch(
            m.cfg.vocab_size)), m.layout, mode=mode, batch_size=B,
            trainable_key="lora", execution=execution, **kw)
    want = {"per_layer": dict(ghost_norm=2 * pairs, clip_reduce=2 * pairs,
                              scale_contract=0),
            "ghost_flat": dict(ghost_norm=2 * pairs, clip_reduce=0,
                               scale_contract=leaves),
            "non_private": dict(ghost_norm=0, clip_reduce=2 * pairs,
                                scale_contract=0)}[mode]
    assert calls == dict(want, fused_norm_clip=0)
    assert np.isfinite(float(res.loss))


# ---------------------------------------------------------------------------
# Whole steps with the reference's draws.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,reduced", ARCHS)
def test_lora_steps_match_reference_with_its_draws(arch, reduced,
                                                   monkeypatch):
    """per_layer, ghost_flat by BK and per_group by twopass, one noised
    Adam step each from the same state; the base bit for bit unchanged."""
    m, jm = _models_cached(arch, reduced)
    tree = _tree(m)
    batch = _batch(m.cfg.vocab_size, b=4, seed=10)
    key = jax.random.PRNGKey(7)
    cur = {}
    monkeypatch.setattr(dp_sgd, "standard_normal",
                        lambda path, shape, rows, gen: torch.from_numpy(
                            cur["z"][path][rows]))
    monkeypatch.setattr(Q, "count_noise", lambda shape, gen:
                        torch.from_numpy(cur["zq"]))
    assign = tuple(int(i) for i in np.arange(m.layout.num_groups) % 2)
    # the reference runs per_group by BK, which its own tests hold to its
    # twopass (tests/test_bk.py:112), at a third less compile time
    for mode, ref_mode in (("per_layer", "per_layer"),
                           ("ghost_flat", "ghost_flat"),
                           ("per_group_twopass", "per_group")):
        kw = dict(sigma=0.7, sampling_rate=0.05, steps=10,
                  init_threshold=0.5)
        if mode.startswith("per_group"):
            kw.update(group_assignment=assign, num_supergroups=2)
        j_init, j_step, j_plan = JDP.make_dp_train_step(
            jm.loss_fn, jm.dp_spec, jm.layout, joptim.adam(1e-2),
            JDP.DPConfig(mode=ref_mode, backend="xla", **kw), batch_size=4,
            trainable_key="lora")
        kw["mode"] = mode
        p_init, p_step, p_plan = dp_sgd.make_dp_train_step(
            m.loss_fn, m.dp_spec, m.layout, optim.adam(1e-2),
            dp_sgd.DPConfig(backend="kernels", **kw), batch_size=4,
            trainable_key="lora")
        cur["z"], cur["zq"] = _reference_draws(
            jm.dp_spec, max(j_plan.num_noise_groups, 1), key, 0)
        jp = _j(tree)
        jo, jd = j_init(jp)
        jp, jo, jd, jmet = jax.jit(j_step)(jp, jo, jd, _j(batch), key)
        pp = bridge.train_params_from_numpy(tree, "cpu")
        for _, leaf in tree_leaves({k: v for k, v in pp.items()
                                    if k != "lora"}):
            leaf.requires_grad_(False)
        po, pd = p_init(pp)
        pp, po, pd, pmet = p_step(pp, po, pd, _t(batch), 0)
        np.testing.assert_allclose([float(x) for x in pmet],
                                   [float(x) for x in jmet], rtol=1e-4,
                                   err_msg=mode)
        np.testing.assert_allclose(pd.qstate.thresholds.numpy(),
                                   np.asarray(jd.qstate.thresholds),
                                   rtol=1e-5)
        assert_trees_close(pp["lora"], jp["lora"], atol_frac=1e-4)
        assert_trees_close(po.mu, jo.mu, atol_frac=1e-4)
        for name, leaf in _leaves({k: v for k, v in pp.items()
                                   if k != "lora"}):
            want = dict(_leaves(tree))[name]
            np.testing.assert_array_equal(leaf.numpy(), want, err_msg=name)
        moved = [not np.array_equal(leaf.detach().numpy(),
                                    dict(_leaves(tree["lora"]))[name])
                 for name, leaf in _leaves(pp["lora"])]
        assert all(moved), mode


# ---------------------------------------------------------------------------
# The serving helpers.
# ---------------------------------------------------------------------------


def test_stacked_helpers_match_reference():
    rng = np.random.default_rng(4)
    t_, n, din, r, dout, b = 3, 2, 12, 4, 10, 5
    a = rng.standard_normal((t_, din, r)).astype(np.float32)
    bb = rng.standard_normal((t_, r, dout)).astype(np.float32)
    x = rng.standard_normal((b, 1, din)).astype(np.float32)
    tenant = np.array([2, 0, 1, 2, 0], np.int32)
    want = JL.stacked_lora_delta(jnp.asarray(x), jnp.asarray(a),
                                 jnp.asarray(bb), jnp.asarray(tenant), 16.0)
    got = lora.stacked_lora_delta(torch.from_numpy(x), torch.from_numpy(a),
                                  torch.from_numpy(bb),
                                  torch.from_numpy(tenant), 16.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # a row's delta depends only on its own tenant's pair
    one = lora.stacked_lora_delta(torch.from_numpy(x[:1]),
                                  torch.from_numpy(a), torch.from_numpy(bb),
                                  torch.from_numpy(tenant[:1]), 16.0)
    assert torch.equal(one[0], got[0])

    spec = lora.lora_spec(din, dout, r, stack=(n,))
    jspec = JL.lora_spec(din, dout, r, stack=(n,))
    buf = lora.stacked_adapter_zeros(spec, t_)
    jbuf = JL.stacked_adapter_zeros(jspec, t_)
    assert {k: tuple(v.shape) for k, v in buf.items()} == {
        k: tuple(v.shape) for k, v in jbuf.items()}
    ad = {"a": rng.standard_normal((n, din, r)).astype(np.float32),
          "b": rng.standard_normal((n, r, dout)).astype(np.float32)}
    ptr = buf["a"].data_ptr()
    lora.stacked_slot_update(buf, 1, {k: torch.from_numpy(v)
                                      for k, v in ad.items()})
    jbuf = JL.stacked_slot_update(jbuf, 1, {k: jnp.asarray(v)
                                            for k, v in ad.items()})
    for k in buf:
        np.testing.assert_array_equal(buf[k].numpy(), np.asarray(jbuf[k]))
    assert buf["a"].data_ptr() == ptr  # written in place
    lora.stacked_slot_update(buf, 1, None)
    jbuf = JL.stacked_slot_update(jbuf, 1, None)
    for k in buf:
        np.testing.assert_array_equal(buf[k].numpy(), np.asarray(jbuf[k]))
    with pytest.raises(ValueError, match="does not match"):
        lora.stacked_slot_update(buf, 0, {"a": torch.zeros(1), "b": None})


# ---------------------------------------------------------------------------
# The CLIs.
# ---------------------------------------------------------------------------

CLI = ["--arch", "tiny", "--lora-rank", "4", "--steps", "2", "--batch", "4",
       "--seq", "16", "--docs", "16", "--log-every", "1", "--device", "cpu"]


def test_train_cli_lora_rank_runs_two_steps(capsys):
    assert train.main(CLI) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# arch=tiny") and "lora_rank=4" in out[0]
    assert "groups=4 " in out[0]  # qkv and o of tiny's 2 layers
    steps = [ln for ln in out if ln.startswith("step")]
    assert len(steps) == 2
    assert all(np.isfinite(float(ln.split()[3])) for ln in steps)


@pytest.mark.parametrize("lora_rank", [4, 0])
def test_service_publishes_adapters_after_each_checkpoint(lora_rank,
                                                          tmp_path):
    argv = ["--service-dir", str(tmp_path), "--arch", "tiny", "--steps",
            "4", "--batch", "4", "--seq", "16", "--docs", "16",
            "--checkpoint-every", "2", "--device", "cpu", "--lora-rank",
            str(lora_rank)]
    svc = service.TrainService(service.build_service_parser().parse_args(
        argv), sleep=lambda _: None)
    svc.run()
    from repro_torch.checkpoint.store import (all_steps, load_manifest,
                                              manifest_crcs, tree_crcs)
    assert all_steps(str(tmp_path / "ckpt")) == [4, 2]
    pub = str(tmp_path / "publish")
    if not lora_rank:
        assert all_steps(pub) == []
        return
    assert all_steps(pub) == [4, 2]
    meta = load_manifest(pub, 4)["meta"]
    assert meta["source_step"] == 4
    assert abs(meta["epsilon"] - svc.epsilon()) < 1e-12
    assert manifest_crcs(pub, 4) == tree_crcs({"lora": svc.params["lora"]})


def test_sharded_driver_trains_lora_on_one_rank_bitwise():
    """The sharded driver trains the adapters: on a mesh of one rank (its
    collectives the identity) per_layer is bitwise the single-device
    driver, and its one `grad_psum` a leaf covers the adapters alone
    (four ranks: `test_torch_sharded_lora.py`)."""
    from repro_torch.launch.mesh import Mesh
    m, _ = _models_cached("qwen3-4b", True)
    params = bridge.train_params_from_numpy(_tree(m), "cpu")
    batch = _t(_batch(m.cfg.vocab_size))
    th = torch.full((m.layout.num_groups,), 0.3)
    mesh = Mesh({"data": 1, "model": 1}, device="cpu", backend="gloo")
    with backend.scoped("kernels"):
        got = sharded_clipped_gradients(
            m.loss_fn, params, batch, m.layout, mode="per_layer",
            batch_size=B, data_size=1, mesh=mesh, thresholds=th,
            trainable_key="lora")
        want = dp_clipped_gradients(m.loss_fn, params, batch, m.layout,
                                    mode="per_layer", batch_size=B,
                                    thresholds=th, trainable_key="lora")
    assert torch.equal(got.norms_sq, want.norms_sq)
    assert torch.equal(got.loss, want.loss)
    pairs = list(zip(tree_leaves(got.grads), tree_leaves(want.grads)))
    assert [p for (p, _), _ in pairs] == [p for _, (p, _) in pairs]
    assert all(torch.equal(g, w) for (_, g), (_, w) in pairs)
    assert {p[0] for (p, _), _ in pairs} == {"lora"}
    assert [c.site for c in mesh.log].count("grad_psum") == len(pairs)
