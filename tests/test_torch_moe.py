"""The port's MoE training path (granite-moe-3b-a800m, flat dispatch)
against the JAX package, on the CPU in f32.

* `dp_expert_linear`: output, input cotangent, clipped expert gradients
  and the (E, B) norms² against `jax.vjp` of the reference primitive
  (`tests/test_dp_layers.py`'s case, with empty slots and an empty
  expert), under the four threshold encodings; the norms-only and
  no-norms branches;
* `moe_block`'s output and per-example aux loss, and their gradients,
  on granite-moe-3b-a800m-reduced, with a tied router (every expert
  equally likely: the lower index first, as `jax.lax.top_k`) and a
  capacity that drops tokens;
* the MoE `GroupLayout` (2,723 groups at full size) and the noise of the
  expert leaves per (layer, expert) against the reference's;
* the whole `loss_fn` through `dp_clipped_gradients` (per_layer and
  non_private) and ghost_flat by two passes;
* two full noised `per_layer` steps with the reference's draws
  substituted, against the reference's step;
* the train CLI on the CPU, its kernel calls per step under both routes;
  BK on the MoE config against twopass; grouped dispatch and MLA build,
  serve and train (their parity tests: `tests/test_torch_moe_grouped.py`,
  `tests/test_torch_mla_train.py`).

Tolerances: f32, the same math summed in another order: rtol 1e-5 and an
atol of 1e-5 of the largest magnitude (1e-4 after a full step, as
`tests/test_torch_train.py`).
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
from repro.core import dp_layers as JDP
from repro.core import dp_sgd as JSGD
from repro.core import spec as JS
from repro.core.clipping import dp_clipped_gradients as jax_clip
from repro.kernels import backend as jax_backend
from repro.models import moe as JMOE
from repro.models.transformer import build_model as jax_build_model
from repro_torch import bridge, optim
from repro_torch.configs import get_config
from repro_torch.core import dp_layers as DP
from repro_torch.core import dp_sgd
from repro_torch.core import quantile as Q
from repro_torch.core import spec as S
from repro_torch.core.clipping import dp_clipped_gradients
from repro_torch.kernels import backend
from repro_torch.kernels import clip_reduce as CR
from repro_torch.kernels import fused_clip as FC
from repro_torch.kernels import ghost_norm as GN
from repro_torch.launch import serve, train
from repro_torch.models import moe as MOE
from repro_torch.models.transformer import build_model
from repro_torch.optim import optimizers
from test_torch_train import _batch, _j, _leaves, _t, assert_trees_close

T = torch.from_numpy
ARCH = "granite-moe-3b-a800m"
INF = np.inf


def close(got, want, rtol=1e-5, atol_frac=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(want, np.float32)
    atol = atol_frac * max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _models(reduced=True, **change):
    """The port's and the reference's model of the config, with `change`
    applied to both."""
    return (build_model(dataclasses.replace(
                get_config(ARCH, reduced=reduced), **change), device="cpu"),
            jax_build_model(dataclasses.replace(
                jax_get_config(ARCH, reduced=reduced), **change)))


# ---------------------------------------------------------------------------
# dp_expert_linear.
# ---------------------------------------------------------------------------

E, C, DIN, DOUT, BSZ = 3, 8, 5, 4, 4


def _expert_inputs(seed=7):
    rng = np.random.default_rng(seed)
    w = (0.3 * rng.standard_normal((E, DIN, DOUT))).astype(np.float32)
    exids = rng.integers(-1, BSZ, (E, C)).astype(np.int32)
    exids[2] = -1  # an expert that received no token
    x = rng.standard_normal((E, C, DIN)).astype(np.float32)
    x *= (exids >= 0)[..., None]  # empty slots carry zeros
    gy = rng.standard_normal((E, C, DOUT)).astype(np.float32)
    return w, x, exids, gy


ENCODINGS = {"clip": [0.4, 0.05], "inf": [INF], "scale": [-0.7],
             "mixed": [0.4, INF, -0.7, 0.05]}


@pytest.mark.parametrize("enc", sorted(ENCODINGS))
def test_dp_expert_linear_matches_reference_vjp(enc):
    w, x, exids, gy = _expert_inputs()
    c = np.resize(np.asarray(ENCODINGS[enc], np.float32),
                  (E, BSZ)).astype(np.float32)
    y_j, vjp = jax.vjp(
        lambda w_, x_, c_: JDP.dp_expert_linear(w_, x_, jnp.asarray(exids),
                                                c_),
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(c))
    dw_j, dx_j, dc_j = vjp(jnp.asarray(gy))
    tw, tx, tc = (T(v).requires_grad_() for v in (w, x, c))
    y = DP.dp_expert_linear(tw, tx, T(exids), tc)
    close(y, y_j)
    dw, dx, dc = torch.autograd.grad(y, [tw, tx, tc], T(gy))
    close(dw, dw_j)
    close(dx, dx_j)
    close(dc, dc_j)
    assert float(dc[2].abs().max()) == 0.0  # the empty expert
    if enc == "clip":  # some examples clipped, some not
        n = dc.numpy()
        assert (n > c ** 2).any() and (n[:2] < c[:2] ** 2).any()


def test_dp_expert_linear_norms_only_and_no_norms_branches():
    """A norms-only pass (the weight's gradient not asked for) returns the
    same norms and no weight gradient; +inf thresholds without grad give
    the unclipped sum; a finite threshold without grad poisons it (NaN)."""
    w, x, exids, gy = _expert_inputs()
    c = np.full((E, BSZ), 0.4, np.float32)
    tw, tc = T(w).requires_grad_(), T(c).requires_grad_()
    y = DP.dp_expert_linear(tw, T(x), T(exids), tc)
    dw, n = torch.autograd.grad(y, [tw, tc], T(gy))
    y = DP.dp_expert_linear(T(w), T(x), T(exids), tc)
    (n_only,) = torch.autograd.grad(y, [tc], T(gy))
    assert torch.equal(n_only, n)
    y = DP.dp_expert_linear(tw, T(x), T(exids), torch.full((E, BSZ), INF))
    (dw_inf,) = torch.autograd.grad(y, [tw], T(gy))
    close(dw_inf, np.einsum("ecd,ecf->edf", x, gy))
    y = DP.dp_expert_linear(tw, T(x), T(exids), T(c))
    (dw_nan,) = torch.autograd.grad(y, [tw], T(gy))
    assert torch.isnan(dw_nan[:2]).all()


def test_bk_on_moe_matches_twopass():
    """The expert layers take a BK channel: on the MoE config ghost_flat
    and per_group by BK equal their twopass, with no fallback warning, and
    a train CLI step by BK runs (the reference's BK and twopass:
    `tests/test_torch_moe_grouped.py`)."""
    from repro_torch.core import bk
    w, x, exids, _ = _expert_inputs()
    ch = bk.BkChannel(torch.full((E, BSZ), INF), "moe_blocks/moe/w_gu")
    with bk._recording() as rec:
        DP.dp_expert_linear(T(w), T(x), T(exids), ch)
    assert rec["moe_blocks/moe/w_gu"].kind == "expert"
    m, _ = _models()
    params = bridge.train_params_from_numpy(
        bridge.numpy_params(m.spec, seed=0), "cpu")
    batch = _t(_batch(m.cfg.vocab_size))
    for mode, kw in (("ghost_flat", {"flat_threshold": torch.tensor(0.5)}),
                     ("per_group", {"group_assignment": torch.zeros(
                         m.layout.num_groups, dtype=torch.long),
                         "group_thresholds": torch.ones(1)})):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = dp_clipped_gradients(m.loss_fn, params, batch, m.layout,
                                       mode=mode, batch_size=3,
                                       execution="bk", **kw)
        want = dp_clipped_gradients(m.loss_fn, params, batch, m.layout,
                                    mode=mode, batch_size=3,
                                    execution="twopass", **kw)
        assert_trees_close(got.grads, jax.tree_util.tree_map(
            lambda t: t.detach().numpy(), want.grads))
    trainer = train.Trainer(train.build_train_parser().parse_args(
        ["--arch", ARCH, "--reduced", "--clipping", "ghost_flat",
         "--execution", "bk", "--batch", "2", "--seq", "8", "--docs", "4",
         "--device", "cpu"]))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        met = trainer.step()
    assert np.isfinite(float(met.loss))


# ---------------------------------------------------------------------------
# moe_block.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "tied_router", "dropping"])
def test_moe_block_matches_reference(case):
    """Layer 0's MoE block of the reduced config (4 experts, top-2):
    output, aux loss, and the gradients of a loss of both with respect to
    the input, the router and the experts (thresholds +inf), and the
    norms². tied_router: a zero router, so every expert ties and the
    lower indices win; dropping: capacity factor 0.25, so tokens overflow
    the 8-slot buffers and are dropped."""
    m, jm = _models()
    cfg, jcfg = m.cfg, jax_get_config(ARCH, reduced=True)
    if case == "dropping":
        cfg = dataclasses.replace(cfg, capacity_factor=0.25)
        jcfg = dataclasses.replace(jcfg, capacity_factor=0.25)
        assert MOE.capacity(cfg, 3 * 12) == 8 < 3 * 12 * 2 // 4
    tree = bridge.numpy_params(m.spec, seed=0)["moe_blocks"]["moe"]
    tree = {k: {kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
            else v[0] for k, v in tree.items()}
    if case == "tied_router":
        tree["router"]["w"] = np.zeros_like(tree["router"]["w"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 12, cfg.d_model)).astype(np.float32)
    wy = rng.standard_normal((3, 12, cfg.d_model)).astype(np.float32)
    th = {"router": np.full((3,), INF, np.float32),
          "w_gu": np.full((4, 3), 0.3, np.float32),
          "w_down": np.full((4, 3), INF, np.float32)}

    def jloss(p, x_, th_):
        y, aux = JMOE.moe_block(jcfg, p, x_, th_)
        return jnp.sum(y * wy) + jnp.sum(aux), (y, aux)

    (_, (y_j, aux_j)), grads_j = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        _j(tree), jnp.asarray(x), _j(th))
    p = bridge.train_params_from_numpy(tree, "cpu")
    tx = T(x).requires_grad_()
    tth = {k: T(v).requires_grad_() for k, v in th.items()}
    y, aux = MOE.moe_block(cfg, p, tx, tth)
    close(y, y_j)
    close(aux, aux_j)
    leaves = [p["router"]["w"], p["w_gu"], p["w_down"], tx, tth["w_gu"],
              tth["w_down"]]
    got = torch.autograd.grad(torch.sum(y * T(wy)) + torch.sum(aux), leaves)
    want = [grads_j[0]["router"]["w"], grads_j[0]["w_gu"],
            grads_j[0]["w_down"], grads_j[1], grads_j[2]["w_gu"],
            grads_j[2]["w_down"]]
    for name, g, w in zip(["router", "w_gu", "w_down", "x", "n_gu",
                           "n_down"], got, want):
        close(g, w, atol_frac=1e-5 if name != "x" else 1e-4)


def test_top_k_ties_take_the_lower_index(monkeypatch):
    """A zero router ties all 6 experts: the top-3 are experts 0-2 for
    every token, as `jax.lax.top_k` picks them."""
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              num_experts=6, num_experts_per_tok=3)
    p = {"router": {"w": torch.zeros((cfg.d_model, 6))},
         "w_gu": torch.zeros((6, cfg.d_model, 2 * cfg.moe_d_ff)),
         "w_down": torch.zeros((6, cfg.moe_d_ff, cfg.d_model))}
    th = {"router": torch.full((2,), INF), "w_gu": torch.full((6, 2), INF),
          "w_down": torch.full((6, 2), INF)}
    seen = []
    real = DP.dp_expert_linear

    def spy(w, x, exids, c):
        seen.append(exids)
        return real(w, x, exids, c)

    monkeypatch.setattr(DP, "dp_expert_linear", spy)
    MOE.moe_block(cfg, p, torch.ones((2, 4, cfg.d_model)), th)
    assert MOE.capacity(cfg, 8) == 8
    filled = (seen[0] >= 0).sum(dim=1).tolist()
    assert filled == [8, 8, 8, 0, 0, 0]  # experts 0-2 take all 8 tokens


# ---------------------------------------------------------------------------
# Layout and noise.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [True, False])
def test_moe_layout_matches_reference(reduced):
    """Built from the spec alone: the full model costs no allocation."""
    m, jm = _models(reduced)
    lay, ref = m.layout, jm.layout
    assert [(g.name, g.stack_shape, g.dim, g.offset, g.sensitivity_mult)
            for g in lay.groups] == [
        (g.name, g.stack_shape, g.dim, g.offset, g.sensitivity_mult)
        for g in ref.groups]
    assert lay.flat_names() == ref.flat_names()
    assert m.num_params == sum(int(np.prod(p.shape))
                               for _, p in JS._walk(jm.spec))
    if not reduced:
        # embed, final_norm, head + 32 x (attn_norm, qkv, o, mlp_norm,
        # router, 40 w_gu, 40 w_down)
        assert lay.num_groups == 3 + 32 * (5 + 80) == 2723
        assert lay.group("moe_blocks/moe/w_gu").stack_shape == (32, 40)
        assert lay.group("moe_blocks/moe/w_gu").dim == 1536 * 1024
        assert m.num_params == 3_374_295_552


def _zeros(spec):
    out = {}
    for path, p in S._walk(spec):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.zeros(p.shape)
    return out


@pytest.mark.parametrize("slice_elems", [1 << 26, 64])
def test_expert_noise_std_per_layer_and_expert(slice_elems, monkeypatch):
    """On zero grads with the reference's own draws substituted, every leaf
    equals the reference's noise: expert e of layer l takes the std of
    group (l, e), whether its leaf is drawn whole or in slices."""
    m, jm = _models()
    lay = m.layout
    stds = np.linspace(0.5, 3.0, lay.num_groups).astype(np.float32)
    key = jax.random.PRNGKey(3)
    z = {"/".join(path): np.array(jax.random.normal(
        jax.random.fold_in(key, JS.stable_hash("/".join(path))), p.shape,
        jnp.float32)) for path, p in JS._walk(jm.spec)}
    monkeypatch.setattr(optimizers, "_SLICE_ELEMS", slice_elems)
    monkeypatch.setattr(dp_sgd, "standard_normal",
                        lambda path, shape, rows, gen: T(z[path][rows]))
    got = dp_sgd.add_noise_to_grads(m.spec, lay, _zeros(m.spec), T(stds),
                                    seed=0, step=0)
    want = JSGD.add_noise_to_grads(
        jm.spec, jm.layout, jax.tree_util.tree_map(
            lambda t: jnp.zeros(t.shape), _zeros(m.spec)),
        jnp.asarray(stds), key)
    assert_trees_close(got, want, atol_frac=0, rtol=1e-6)
    grp = lay.group("moe_blocks/moe/w_down")
    w = got["moe_blocks"]["moe"]["w_down"]  # (2, 4, 128, 192)
    for layer in range(2):
        for e in range(4):
            np.testing.assert_allclose(
                w[layer, e].numpy(),
                z["moe_blocks/moe/w_down"][layer, e]
                * stds[grp.offset + 4 * layer + e], rtol=1e-6)


# ---------------------------------------------------------------------------
# The whole loss and full steps.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine,mode,change", [
    ("kernels", "per_layer", {}), ("plain", "per_layer", {}),
    ("kernels", "non_private", {}),
    ("kernels", "per_layer", {"first_k_dense": 1, "num_shared_experts": 1})])
def test_clipped_gradients_match_reference(engine, mode, change):
    """loss_fn (cross-entropy + the aux losses) through one clip: loss,
    (K, B) norms² and every clipped gradient leaf. The kernels engine
    takes the fused route at every linear of the reduced config. The last
    case runs a dense first layer (`dense_blocks`, then `moe_blocks`, as
    the reference orders them) and a shared expert."""
    m, jm = _models(**change)
    if change:
        assert set(m.spec) >= {"dense_blocks", "moe_blocks"}
        assert "shared" in m.spec["moe_blocks"]["moe"]
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size)
    thr = np.random.default_rng(2).uniform(
        0.05, 2.0, m.layout.num_groups).astype(np.float32)
    kw = dict(mode=mode, batch_size=3)
    with jax_backend.scoped("xla"):
        want = jax.jit(functools.partial(jax_clip, jm.loss_fn,
                                         layout=jm.layout, **kw))(
            _j(tree), _j(batch), **({"thresholds": jnp.asarray(thr)}
                                    if mode == "per_layer" else {}))
    if mode == "per_layer":
        kw["thresholds"] = T(thr)
    with backend.scoped(engine):
        got = dp_clipped_gradients(
            m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"),
            _t(batch), m.layout, **kw)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-6)
    np.testing.assert_allclose(got.norms_sq.numpy(), np.asarray(want.norms_sq),
                               rtol=1e-5, atol=1e-9)
    assert_trees_close(got.grads, want.grads)
    if mode == "per_layer":
        n = got.norms_sq.numpy()
        assert (n > thr[:, None] ** 2).any() and (n < thr[:, None] ** 2).any()


def test_ghost_flat_twopass_matches_reference():
    m, jm = _models()
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size)
    kw = dict(mode="ghost_flat", batch_size=3, execution="twopass",
              flat_threshold=0.5)
    with jax_backend.scoped("xla"):
        want = jax.jit(functools.partial(jax_clip, jm.loss_fn,
                                         layout=jm.layout, **kw))(
            _j(tree), _j(batch))
    with backend.scoped("kernels"):
        got = dp_clipped_gradients(
            m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"),
            _t(batch), m.layout, **kw)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-6)
    np.testing.assert_allclose(got.norms_sq.numpy(), np.asarray(want.norms_sq),
                               rtol=1e-5, atol=1e-9)
    assert_trees_close(got.grads, want.grads)


def _reference_draws(spec, num_groups, key, step):
    k_noise, k_q = jax.random.split(jax.random.fold_in(key, step))
    z = {"/".join(path): np.array(jax.random.normal(
        jax.random.fold_in(k_noise, JS.stable_hash("/".join(path))),
        p.shape, jnp.float32)) for path, p in JS._walk(spec)}
    return z, np.array(jax.random.normal(k_q, (num_groups,), jnp.float32))


def test_two_per_layer_steps_match_reference_with_its_draws(monkeypatch):
    """Noise per (layer, expert) group and the quantile update over the 29
    groups of the reduced config; the reference runs its xla engine."""
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
    assert m.layout.num_groups == 29
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
            cur["z"], cur["zq"] = _reference_draws(jm.spec, 29, key, s)
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


# ---------------------------------------------------------------------------
# The train CLI, its kernel calls, the grouped and MLA variants.
# ---------------------------------------------------------------------------


def _count_calls(monkeypatch):
    calls = dict.fromkeys(("fused_norm_clip", "ghost_norm", "clip_reduce"), 0)
    for mod, name in ((FC, "fused_norm_clip"), (GN, "ghost_norm"),
                      (CR, "clip_reduce")):
        def counting(*a, _name=name, _fn=getattr(mod, name), **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counting)
    return calls


@pytest.mark.parametrize("mode,rule_on", [("per_layer", True),
                                          ("per_layer", False),
                                          ("non_private", True)])
def test_kernel_calls_per_step(mode, rule_on, monkeypatch):
    """3 linears per block (qkv, o, the router) + the head, all within the
    fit rule at this size: fused once each under per_layer, or ghost_norm
    and clip_reduce once each on the composed route (the rule patched
    off); non_private calls clip_reduce alone. The experts run no
    kernel."""
    calls = _count_calls(monkeypatch)
    if not rule_on:
        monkeypatch.setattr(FC, "fits", lambda din, dout: False)
    args = train.build_train_parser().parse_args(
        ["--arch", ARCH, "--reduced", "--clipping", mode, "--steps", "2",
         "--batch", "2", "--seq", "8", "--docs", "4", "--device", "cpu"])
    trainer = train.Trainer(args)
    met = trainer.step()
    linears = 3 * trainer.cfg.num_layers + 1
    fused = mode == "per_layer" and rule_on
    assert calls == {
        "fused_norm_clip": linears if fused else 0,
        "ghost_norm": linears if mode == "per_layer" and not fused else 0,
        "clip_reduce": 0 if fused else linears}
    assert np.isfinite(float(met.loss)) and np.isfinite(float(met.grad_norm))


@pytest.mark.parametrize("clipping", ["per_layer", "ghost_flat_twopass",
                                      "non_private"])
def test_train_cli_on_cpu(clipping, capsys):
    assert train.main(["--arch", ARCH, "--reduced", "--clipping", clipping,
                       "--steps", "2", "--batch", "2", "--seq", "8",
                       "--docs", "8", "--log-every", "1", "--device",
                       "cpu"]) == 0
    out = capsys.readouterr().out
    assert "arch=granite-moe-3b-a800m-reduced" in out and "groups=29" in out
    losses = [float(ln.split()[3]) for ln in out.splitlines()
              if ln.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_moe_serve_cli_runs_on_the_cpu():
    """MoE serving is ported: the serve CLI runs granite."""
    assert serve.main(["--arch", ARCH, "--reduced", "--batch", "1", "--gen",
                       "1", "--device", "cpu"]) == 0


def test_grouped_and_mla_models_serve_and_train():
    """A grouped-dispatch MoE model builds and serves; an MLA model's loss
    runs and the train CLI trains deepseek-v3 (the reference's numbers:
    `tests/test_torch_moe_grouped.py`, `tests/test_torch_mla_train.py`)."""
    grouped = dataclasses.replace(get_config(ARCH, reduced=True),
                                  moe_dispatch="grouped")
    gm = build_model(grouped, device="cpu")
    params = gm.init_params(torch.Generator().manual_seed(0))
    cache = gm.init_paged_cache(2, 16, num_pages=4, page_len=8)
    logits, _ = gm.serve_step(params, cache, {
        "token": torch.zeros((2, 1), dtype=torch.int32)})
    assert logits.shape == (2, grouped.vocab_size)
    assert torch.isfinite(logits).all()
    mla = build_model(get_config("deepseek-v3-671b", reduced=True),
                      device="cpu")
    tparams = mla.init_train_params(torch.Generator().manual_seed(0))
    losses = mla.loss_fn(tparams, _t(_batch(mla.cfg.vocab_size)),
                         mla.layout.pack_value(INF, 3))
    assert losses.shape == (3,) and torch.isfinite(losses).all()
    assert train.main(["--arch", "deepseek-v3-671b", "--reduced", "--steps",
                       "1", "--batch", "2", "--seq", "8", "--docs", "4",
                       "--device", "cpu"]) == 0


@pytest.mark.parametrize("change", [{"attention_kind": "mla"},
                                    {"moe_dispatch": "grouped"}],
                         ids=["mla", "grouped"])
def test_moe_variants_train_as_the_reference(change):
    """Granite with MLA attention, or with grouped dispatch: the loss of
    one numpy parameter tree equals the reference's."""
    m, jm = _models(**change)
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size)
    want = jm.loss_fn(_j(tree), _j(batch), jm.layout.pack_value(jnp.inf, 3))
    got = m.loss_fn(bridge.train_params_from_numpy(tree, "cpu"), _t(batch),
                    m.layout.pack_value(INF, 3))
    close(got, want)
