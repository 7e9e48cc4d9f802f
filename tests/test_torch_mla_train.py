"""The port's MLA training with DeepSeek's MTP loss against the JAX
package, on the CPU in f32 (deepseek-v3-671b-reduced: MLA with a q LoRA,
one dense layer, one MoE layer with a shared expert, MTP depth 1).

* `mla_attention` under thresholds, with and without the q LoRA: output,
  every parameter's clipped gradient, the input cotangent and the norms²
  (the thresholds' cotangent) against `jax.vjp` of the reference's;
* the whole loss with MTP: per-example losses; per_layer, ghost_flat
  (twopass) and non_private clipped gradients; two noised per_layer
  steps with the reference's draws substituted;
* BK: MTP runs `embed` and `head` twice a step, so both packages fall
  back to twopass (the port with a warning) and agree with the
  reference's twopass;
* the `GroupLayout`, reduced and full size, group for group;
* the train CLI with `--arch deepseek-v3-671b --reduced` under each
  clipping mode, its header naming the BK fallback;
* the reference's handling of MTP's reused groups, measured in both
  packages (ROADMAP C): each example's clipped head gradient under
  per_layer, and its whole clipped gradient under ghost_flat, as a
  multiple of the threshold C.

Tolerances: f32 atol = rtol = 1e-4 for the attention alone (of the
largest magnitude for gradients; `tests/test_torch_mla.py`'s), rtol 1e-5
and an atol of 1e-5 of the largest magnitude for the whole loss's clipped
gradients (`test_torch_train`), 1e-4 of it after a full step.
"""
import dataclasses
import functools
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
from repro.models import attention as JA
from repro.models.transformer import build_model as jax_build_model
from repro_torch import bridge, optim
from repro_torch.configs import get_config
from repro_torch.core import dp_sgd
from repro_torch.core import quantile as Q
from repro_torch.core.clipping import dp_clipped_gradients
from repro_torch.launch import train
from repro_torch.models import attention as A
from repro_torch.models.transformer import build_model
from test_torch_mla import Q_LORA, _cfgs, _params, _x
from test_torch_moe import _reference_draws
from test_torch_train import B, _batch, _j, _leaves, _t, assert_trees_close

T = torch.from_numpy
ARCH = "deepseek-v3-671b"
INF = np.inf
FALLBACK = "falling back to the twopass"


def _models(reduced=True):
    return (build_model(get_config(ARCH, reduced=reduced), device="cpu"),
            jax_build_model(jax_get_config(ARCH, reduced=reduced)))


# ---------------------------------------------------------------------------
# mla_attention under thresholds.
# ---------------------------------------------------------------------------


@Q_LORA
def test_mla_attention_under_thresholds_matches_reference(q_lora):
    """Each projection a dp_linear and each norm a dp_scale: with
    thresholds drawn around the norms, some examples are clipped."""
    cfg, jcfg = _cfgs(q_lora)
    tparams, jparams, layout = _params(cfg, jcfg)
    b, t = 3, 7
    x = _x(cfg, b, t)
    rng = np.random.default_rng(4)
    pos = np.sort(rng.integers(0, 50, size=(b, t)), axis=1).astype(np.int32)
    wy = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)

    def jloss(p, x_, th_):
        y = JA.mla_attention(jcfg, p, x_, th_, jnp.asarray(pos))
        return jnp.sum(y * wy), y

    # thresholds at 0.5-1.5 of each example's unclipped norm
    n_inf = jax.grad(lambda th_: jloss(jparams, jnp.asarray(x), th_)[0])(
        {g.name: jnp.full((b,), jnp.inf) for g in layout.groups})
    th = {k: (np.sqrt(np.asarray(v)) * rng.uniform(0.5, 1.5, b)).astype(
        np.float32) for k, v in n_inf.items()}
    assert set(th) == ({"q_a", "q_norm", "q_b"} if q_lora else {"q"}) | {
        "kv_a", "kv_norm", "kv_b", "o"}

    (_, y_j), (gp_j, gx_j, gth_j) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(jparams, jnp.asarray(x),
                                                _j(th))
    tp = jax.tree_util.tree_map(lambda v: v.requires_grad_(), tparams)
    tx = T(x).requires_grad_()
    tth = {k: T(v).requires_grad_() for k, v in th.items()}
    y = A.mla_attention(cfg, tp, tx, T(pos), tth)
    names = [n for n, _ in _leaves(tp)]
    got = torch.autograd.grad(torch.sum(y * T(wy)),
                              [v for _, v in _leaves(tp)] + [tx]
                              + [tth[k] for k in sorted(tth)])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=1e-4, atol=1e-4)
    want = [v for _, v in _leaves(gp_j)] + [gx_j] + [gth_j[k]
                                                     for k in sorted(tth)]
    for name, g, w in zip(names + ["x"] + sorted(tth), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()),
            err_msg=name)
    n = np.stack([gth_j[k] for k in sorted(th)])
    thr = np.stack([th[k] for k in sorted(th)])
    assert (n > thr ** 2).any() and (n < thr ** 2).any()


# ---------------------------------------------------------------------------
# The loss with MTP.
# ---------------------------------------------------------------------------


def test_mla_mtp_per_example_losses_match_reference():
    m, jm = _models()
    assert m.cfg.mtp_depth == 1 and "mtp" in m.spec
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size)
    want = jm.loss_fn(_j(tree), _j(batch), jm.layout.pack_value(jnp.inf, B))
    got = m.loss_fn(bridge.train_params_from_numpy(tree, "cpu"), _t(batch),
                    m.layout.pack_value(float("inf"), B))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5)
    # the MTP term is there: without it the losses differ
    no_mtp = build_model(dataclasses.replace(m.cfg, mtp_depth=0),
                         device="cpu")
    params = bridge.train_params_from_numpy(
        {k: v for k, v in tree.items() if k != "mtp"}, "cpu")
    plain = no_mtp.loss_fn(params, _t(batch),
                           no_mtp.layout.pack_value(float("inf"), B))
    assert not np.allclose(plain.detach().numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["per_layer", "ghost_flat_twopass",
                                  "non_private"])
def test_mla_mtp_clipped_gradients_match_reference(mode):
    """loss (cross-entropy + 0.3 MTP + the aux loss), (K, B) norms² and
    every clipped gradient leaf, mtp/* and the twice-used embed and head
    among them."""
    m, jm = _models()
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size)
    rng = np.random.default_rng(2)
    kw, jkw = dict(mode=mode, batch_size=B), {}
    if mode == "per_layer":
        thr = rng.uniform(0.05, 2.0, m.layout.num_groups).astype(np.float32)
        kw["thresholds"], jkw["thresholds"] = T(thr), jnp.asarray(thr)
    elif mode == "ghost_flat_twopass":
        kw["flat_threshold"] = jkw["flat_threshold"] = np.float32(0.5)
    with jax_backend.scoped("xla"):
        want = jax.jit(functools.partial(
            jax_clip, jm.loss_fn, layout=jm.layout, mode=mode,
            batch_size=B))(_j(tree), _j(batch), **jkw)
    got = dp_clipped_gradients(
        m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"), _t(batch),
        m.layout, **kw)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-6)
    np.testing.assert_allclose(got.norms_sq.numpy(), np.asarray(want.norms_sq),
                               rtol=1e-5, atol=1e-9)
    assert_trees_close(got.grads, want.grads)
    assert set(got.grads["mtp"]) == {"proj", "block", "norm"}


def test_two_mla_per_layer_steps_match_reference_with_its_draws(monkeypatch):
    """Noise per group and the quantile update over the 47 groups of the
    reduced config; the reference runs its xla engine."""
    m, jm = _models()
    tree = bridge.numpy_params(m.spec, seed=0)
    kw = dict(mode="per_layer", sigma=0.7, sampling_rate=0.05, steps=10,
              init_threshold=0.5, noise_strategy="weighted")
    j_init, j_step, j_plan = JSGD.make_dp_train_step(
        jm.loss_fn, jm.spec, jm.layout, joptim.sgd(0.05, momentum=0.9),
        JSGD.DPConfig(backend="xla", **kw), batch_size=4)
    p_init, p_step, p_plan = dp_sgd.make_dp_train_step(
        m.loss_fn, m.spec, m.layout, optim.sgd(0.05, momentum=0.9),
        dp_sgd.DPConfig(backend="kernels", **kw), batch_size=4)
    assert (p_plan.sigma, p_plan.sigma_b, p_plan.sigma_new) == (
        j_plan.sigma, j_plan.sigma_b, j_plan.sigma_new)
    ng = m.layout.num_groups
    assert ng == jm.layout.num_groups == 47
    key = jax.random.PRNGKey(7)
    cur = {}
    monkeypatch.setattr(dp_sgd, "standard_normal",
                        lambda path, shape, rows, gen: T(cur["z"][path][rows]))
    monkeypatch.setattr(Q, "count_noise", lambda shape, gen: T(cur["zq"]))
    jp, (jo, jd) = _j(tree), j_init(_j(tree))
    pp = bridge.train_params_from_numpy(tree, "cpu")
    po, pd = p_init(pp)
    step = jax.jit(j_step)
    with jax_backend.scoped("xla"):
        for s in range(2):
            cur["z"], cur["zq"] = _reference_draws(jm.spec, ng, key, s)
            batch = _batch(m.cfg.vocab_size, b=4, seed=30 + s)
            jp, jo, jd, jmet = step(jp, jo, jd, _j(batch), key)
            pp, po, pd, pmet = p_step(pp, po, pd, _t(batch), 0)
            np.testing.assert_allclose([float(x) for x in pmet],
                                       [float(x) for x in jmet], rtol=1e-5)
    assert 0.0 < float(pmet.clip_fraction) < 1.0
    np.testing.assert_allclose(pd.qstate.thresholds.numpy(),
                               np.asarray(jd.qstate.thresholds), rtol=1e-5)
    assert_trees_close(pp, jp, atol_frac=1e-4)
    assert_trees_close(po.momentum, jo.momentum, atol_frac=1e-4)


@pytest.mark.parametrize("mode", ["ghost_flat", "per_group"])
def test_bk_on_mtp_falls_back_and_matches_reference_twopass(mode):
    """MTP consumes embed and head twice: the reference's probe returns
    None (twopass, silently), the port warns and runs twopass; both equal
    the reference's twopass."""
    from repro.core import bk as JBK
    m, jm = _models()
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size)
    assert JBK.probe_recipes(jm.loss_fn, _j(tree), _j(batch), jm.layout,
                             B) is None
    rng = np.random.default_rng(4)
    if mode == "ghost_flat":
        kw = {"flat_threshold": np.float32(0.5)}
    else:
        kw = {"group_assignment": np.asarray(
                  [i % 2 for i in range(m.layout.num_groups)], np.int32),
              "group_thresholds": rng.uniform(0.1, 1.0, 2).astype(
                  np.float32)}
    with jax_backend.scoped("xla"):
        want = jax.jit(functools.partial(
            jax_clip, jm.loss_fn, layout=jm.layout, mode=mode, batch_size=B,
            execution="twopass"))(_j(tree), _j(batch),
                                  **{k: jnp.asarray(v) for k, v in kw.items()})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = dp_clipped_gradients(
            m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"),
            _t(batch), m.layout, mode=mode, batch_size=B, execution="bk",
            **{k: T(np.asarray(v)) for k, v in kw.items()})
    msgs = [str(w.message) for w in caught if FALLBACK in str(w.message)]
    assert len(msgs) == 1 and "'embed'" in msgs[0] and "'head'" in msgs[0]
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-6)
    np.testing.assert_allclose(got.norms_sq.numpy(), np.asarray(want.norms_sq),
                               rtol=1e-5, atol=1e-9)
    assert_trees_close(got.grads, want.grads)


@pytest.mark.parametrize("reduced", [True, False])
def test_mla_layout_matches_reference(reduced):
    """Built from the spec alone: the full model costs no allocation. The
    mtp subtree's groups (mtp/proj, mtp/block/*, mtp/norm) cross one for
    one, so thresholds, norms and noise draws do."""
    m, jm = _models(reduced)
    assert [(g.name, g.stack_shape, g.dim, g.offset, g.sensitivity_mult)
            for g in m.layout.groups] == [
        (g.name, g.stack_shape, g.dim, g.offset, g.sensitivity_mult)
        for g in jm.layout.groups]
    assert m.layout.flat_names() == jm.layout.flat_names()
    names = {g.name for g in m.layout.groups}
    assert {"mtp/proj", "mtp/norm", "mtp/block/attn/q_a",
            "mtp/block/attn/kv_b", "mtp/block/mlp/down"} <= names
    assert m.reused_groups == ("embed", "head")


# ---------------------------------------------------------------------------
# The train CLI.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clipping", [
    "per_layer", "non_private", "ghost_flat", "per_group", "naive_flat",
    "ghost_flat_twopass", "per_group_twopass"])
def test_train_cli_deepseek_on_cpu(clipping, capsys):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert train.main(["--arch", ARCH, "--reduced", "--clipping",
                           clipping, "--steps", "2", "--batch", "2",
                           "--seq", "8", "--docs", "8", "--log-every", "1",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "arch=deepseek-v3-671b-reduced" in out and "groups=47" in out
    bk_mode = clipping in ("ghost_flat", "per_group")
    assert ("bk_falls_back=twopass(groups embed,head run twice)" in out) \
        == bk_mode
    assert any(FALLBACK in str(w.message) for w in caught) == bk_mode
    losses = [float(ln.split()[3]) for ln in out.splitlines()
              if ln.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all()


# ---------------------------------------------------------------------------
# MTP's reused groups (a finding about the reference, kept by the port).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["per_layer", "ghost_flat"])
def test_mtp_reused_groups_clip_bound_in_both_packages(mode):
    """MTP calls `embed` and `head` a second time under the same (B,)
    threshold with sensitivity_mult 1. Example by example (a batch of
    one, so the clipped gradient is that example's):

    * per_layer clips each call to C on its own, so the head's summed
      gradient may reach 2C: here 1.406-1.438 C (the two calls' head
      gradients nearly orthogonal);
    * ghost_flat (twopass) clips by the summed norms² n1 + n2, not
      ||g1 + g2||², so the whole gradient may reach sqrt(2) C: here the
      cross terms are small, 0.99995-1.00028 C.

    C = 1e-3 clips every call. The port equals the reference."""
    m, jm = _models()
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size)
    c = 1e-3
    ratios = []
    for i in range(B):
        one = {k: v[i:i + 1] for k, v in batch.items()}
        if mode == "per_layer":
            kw = {"thresholds": np.full(m.layout.num_groups, c, np.float32)}
        else:
            kw = {"flat_threshold": np.float32(c), "execution": "twopass"}
        with jax_backend.scoped("xla"):
            want = jax_clip(jm.loss_fn, _j(tree), _j(one), layout=jm.layout,
                            mode=mode, batch_size=1,
                            **{k: jnp.asarray(v) if k != "execution" else v
                               for k, v in kw.items()})
        got = dp_clipped_gradients(
            m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"), _t(one),
            m.layout, mode=mode, batch_size=1,
            **{k: T(np.asarray(v)) if k != "execution" else v
               for k, v in kw.items()})
        if mode == "per_layer":
            pair = (float(torch.linalg.norm(got.grads["head"]["w"].double())),
                    float(np.linalg.norm(np.asarray(want.grads["head"]["w"],
                                                    np.float64))))
        else:
            pair = (float(np.sqrt(sum(float(torch.sum(v.double() ** 2))
                                      for _, v in _leaves(got.grads)))),
                    float(np.sqrt(sum(float(np.sum(np.asarray(
                        v, np.float64) ** 2)) for _, v in
                        _leaves(want.grads)))))
        ratios.append((pair[0] / c, pair[1] / c))
    got_r, want_r = np.array(ratios).T
    np.testing.assert_allclose(got_r, want_r, rtol=1e-4)
    bound = 2.0 if mode == "per_layer" else np.sqrt(2.0)
    assert 1.0 < got_r.max() <= bound, got_r
    if mode == "per_layer":
        assert got_r.min() > 1.0  # every example's head passes C


@pytest.mark.parametrize("mode,rule_on", [("per_layer", True),
                                          ("per_layer", False),
                                          ("non_private", True)])
def test_kernel_calls_per_step(mode, rule_on, monkeypatch):
    """Per layer the MLA projections (q_a, q_b, kv_a, kv_b, o), the dense
    layer's gate_up and down, the MoE layer's router and shared expert;
    MTP's projection and block; the head twice: 25 linears on the reduced
    config, all within the fit rule: fused once each under per_layer, or
    ghost_norm and clip_reduce once each on the composed route (the rule
    patched off); non_private calls clip_reduce alone."""
    from repro_torch.kernels import fused_clip as FC
    from test_torch_moe import _count_calls
    calls = _count_calls(monkeypatch)
    if not rule_on:
        monkeypatch.setattr(FC, "fits", lambda din, dout: False)
    trainer = train.Trainer(train.build_train_parser().parse_args(
        ["--arch", ARCH, "--reduced", "--clipping", mode, "--steps", "2",
         "--batch", "2", "--seq", "8", "--docs", "4", "--device", "cpu"]))
    met = trainer.step()
    linears = 5 * 2 + 2 + 3 + (1 + 5 + 2) + 2
    fused = mode == "per_layer" and rule_on
    assert calls == {
        "fused_norm_clip": linears if fused else 0,
        "ghost_norm": linears if mode == "per_layer" and not fused else 0,
        "clip_reduce": 0 if fused else linears}
    assert np.isfinite(float(met.loss)) and np.isfinite(float(met.grad_norm))
