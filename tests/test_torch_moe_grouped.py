"""The port's grouped MoE dispatch and the BK execution of the expert
layers against the JAX package, on the CPU in f32
(granite-moe-3b-a800m-reduced).

* `capacity_per_example` over several token counts;
* `dp_expert_linear_grouped`: output, input cotangent, clipped expert
  gradients and the (E, B) norms² against `jax.vjp` of the reference
  primitive, at shapes that force each of its gram and outer branches,
  under the four threshold encodings; the norms-only and no-norms
  branches; the reference's per-example oracle
  (`tests/test_models.py::test_grouped_expert_dp_norms_oracle`);
* the BK branch of both expert primitives: the norms² and the sinks;
* `moe_block_grouped`'s output, aux loss and their gradients (random,
  tied router, dropping), and a grouped decode step against the
  reference's `serve_step`;
* the grouped `GroupLayout`, the whole loss through per_layer and
  non_private, and BK capture against the reference's capture;
* ghost_flat and per_group by BK on flat and grouped dispatch against the
  reference's BK and its twopass, with no fallback warning;
* the train CLI with `--execution bk`, and the kernel calls of a BK step
  and of a grouped step.

Tolerances: f32, the same math summed in another order: rtol 1e-5 and an
atol of 1e-5 of the largest magnitude (`test_torch_moe.close`; 1e-4 of it
for the input cotangent through the dispatch, as there); the decode step
atol = rtol = 1e-4 (`test_torch_serve`).
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import bk as JBK
from repro.core import dp_layers as JDP
from repro.core.clipping import dp_clipped_gradients as jax_clip
from repro.kernels import backend as jax_backend
from repro.models import moe as JMOE
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import bk
from repro_torch.core import dp_layers as DP
from repro_torch.core.clipping import dp_clipped_gradients
from repro_torch.kernels import backend
from repro_torch.launch import train
from repro_torch.models import moe as MOE
from test_torch_moe import ARCH, ENCODINGS, INF, _count_calls, _models, close
from test_torch_serve import _both, _check_serve_step
from test_torch_train import B, _batch, _j, _t, assert_trees_close

T = torch.from_numpy
GROUPED = {"moe_dispatch": "grouped"}
DISPATCH = pytest.mark.parametrize("change", [{}, GROUPED],
                                   ids=["flat", "grouped"])


# ---------------------------------------------------------------------------
# capacity_per_example.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tokens", [1, 5, 12, 64, 256])
def test_capacity_per_example_matches_reference(tokens):
    for reduced in (True, False):
        cfg, jcfg = (get_config(ARCH, reduced=reduced),
                     jax_get_config(ARCH, reduced=reduced))
        assert MOE.capacity_per_example(cfg, tokens) == \
            JMOE.capacity_per_example(jcfg, tokens)
    # granite at T = 256: 256 x 8 x 1.25 / 40 = 64 slots an (example,
    # expert), against the flat dispatch's 512 over B = 8
    assert MOE.capacity_per_example(get_config(ARCH), 256) == 64


# ---------------------------------------------------------------------------
# dp_expert_linear_grouped.
# ---------------------------------------------------------------------------

# (E, C, din, dout): the reference takes the outer form where C din dout <
# C² (din + dout) and din dout <= 2^22, else the gram form
BRANCHES = {"gram": (3, 2, 16, 12), "outer": (3, 8, 5, 4)}
BSZ = 4


def _use_outer(e, cap, din, dout):
    return cap * din * dout < cap * cap * (din + dout) \
        and din * dout <= 1 << 22


def _grouped_inputs(branch, seed=5):
    e, cap, din, dout = BRANCHES[branch]
    rng = np.random.default_rng(seed)
    w = (0.3 * rng.standard_normal((e, din, dout))).astype(np.float32)
    x = rng.standard_normal((BSZ, e, cap, din)).astype(np.float32)
    x[0, 1] = 0.0  # an (example, expert) bucket that received no token
    x[2, :, cap - 1] = 0.0  # empty last slots
    gy = rng.standard_normal((BSZ, e, cap, dout)).astype(np.float32)
    return w, x, gy


@pytest.mark.parametrize("enc", sorted(ENCODINGS))
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_dp_expert_linear_grouped_matches_reference_vjp(branch, enc):
    assert _use_outer(*BRANCHES[branch]) == (branch == "outer")
    w, x, gy = _grouped_inputs(branch)
    e = w.shape[0]
    c = np.resize(np.asarray(ENCODINGS[enc], np.float32),
                  (e, BSZ)).astype(np.float32)
    y_j, vjp = jax.vjp(JDP.dp_expert_linear_grouped, jnp.asarray(w),
                       jnp.asarray(x), jnp.asarray(c))
    dw_j, dx_j, dc_j = vjp(jnp.asarray(gy))
    tw, tx, tc = (T(v).requires_grad_() for v in (w, x, c))
    y = DP.dp_expert_linear_grouped(tw, tx, tc)
    close(y, y_j)
    dw, dx, dc = torch.autograd.grad(y, [tw, tx, tc], T(gy))
    close(dw, dw_j)
    close(dx, dx_j)
    close(dc, dc_j)
    assert float(dc[1, 0]) == 0.0  # the empty bucket
    if enc == "clip":  # some examples clipped, some not
        n = dc.numpy()
        assert (n > c ** 2).any() and (n < c ** 2).any()


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_dp_expert_linear_grouped_norms_only_and_no_norms(branch):
    """A norms-only pass returns the same norms and no weight gradient;
    +inf thresholds without grad give the unclipped sum."""
    w, x, gy = _grouped_inputs(branch)
    e = w.shape[0]
    c = np.full((e, BSZ), 0.4, np.float32)
    tw, tc = T(w).requires_grad_(), T(c).requires_grad_()
    y = DP.dp_expert_linear_grouped(tw, T(x), tc)
    dw, n = torch.autograd.grad(y, [tw, tc], T(gy))
    y = DP.dp_expert_linear_grouped(T(w), T(x), tc)
    (n_only,) = torch.autograd.grad(y, [tc], T(gy))
    assert torch.equal(n_only, n)
    y = DP.dp_expert_linear_grouped(tw, T(x), torch.full((e, BSZ), INF))
    (dw_inf,) = torch.autograd.grad(y, [tw], T(gy))
    close(dw_inf, np.einsum("becd,becf->edf", x, gy))


def test_grouped_expert_norms_per_example_oracle():
    """The reference's oracle: each (expert, example)'s norm and clipped
    gradient from that example's own backward, in both packages."""
    e2, c, din, dout, b = 3, 4, 5, 6, 4
    rng = np.random.default_rng(2)
    w = (0.3 * rng.standard_normal((e2, din, dout))).astype(np.float32)
    xx = rng.standard_normal((b, e2, c, din)).astype(np.float32)
    cth = np.full((e2, b), 0.3, np.float32)
    tw, tc = T(w).requires_grad_(), T(cth).requires_grad_()
    y = DP.dp_expert_linear_grouped(tw, T(xx), tc)
    grads, norms = torch.autograd.grad(torch.sum(y ** 2), [tw, tc])
    jgrads, jnorms = jax.grad(
        lambda w_, c_: jnp.sum(JDP.dp_expert_linear_grouped(
            w_, jnp.asarray(xx), c_) ** 2), argnums=(0, 1))(
        jnp.asarray(w), jnp.asarray(cth))
    want = np.zeros_like(w)
    for e in range(e2):
        for i in range(b):
            we = T(w[e]).requires_grad_()
            (ge,) = torch.autograd.grad(torch.sum((T(xx[i, e]) @ we) ** 2),
                                        [we])
            n_o = float(torch.sum(ge.double() ** 2))
            np.testing.assert_allclose(float(norms[e, i]), n_o, rtol=1e-5)
            want[e] += min(1.0, 0.3 / np.sqrt(n_o + 1e-12)) * ge.numpy()
    close(grads, want)
    close(grads, jgrads)
    close(norms, jnorms)


# ---------------------------------------------------------------------------
# The BK branch of both expert primitives.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["expert", "expert_grouped"])
def test_expert_bk_branch_returns_norms_and_fills_sinks(kind):
    """Under a channel the backward returns the reference's norms² as the
    threshold's gradient, writes the slots' activations and cotangents
    (and the flat dispatch's example ids, empty slots B) into the sinks
    and returns no weight gradient."""
    from test_torch_moe import _expert_inputs
    if kind == "expert":
        w, x, exids, gy = _expert_inputs()
        e = w.shape[0]

        def jfn(w_, x_, c_):
            return JDP.dp_expert_linear(w_, x_, jnp.asarray(exids), c_)

        def tfn(w_, x_, c_):
            return DP.dp_expert_linear(w_, x_, T(exids), c_)
        sinks = {"x": x.shape, "g": gy.shape, "seg": exids.shape}
    else:
        w, x, gy = _grouped_inputs("outer")
        e = w.shape[0]
        jfn, tfn = JDP.dp_expert_linear_grouped, DP.dp_expert_linear_grouped
        sinks = {"x": x.shape, "g": gy.shape}
    c = np.full((e, BSZ), INF, np.float32)
    _, vjp = jax.vjp(jfn, jnp.asarray(w), jnp.asarray(x), jnp.asarray(c))
    n_j = vjp(jnp.asarray(gy))[2]
    ch = bk.BkChannel(T(c).requires_grad_(), "moe_blocks/moe/w_gu")
    ch.sink.update({k: torch.zeros(v, dtype=torch.long if k == "seg"
                                   else torch.float32)
                    for k, v in sinks.items()})
    tw = T(w).requires_grad_()
    with backend.scoped(capture_residuals=True), bk._recording() as rec:
        y = tfn(tw, T(x), ch)
    assert rec[ch.group].kind == kind
    assert {k: tuple(s) for k, (s, _) in rec[ch.group].sinks.items()} == \
        {k: tuple(v) for k, v in sinks.items()}
    dw, n = torch.autograd.grad(y, [tw, ch.c], T(gy), allow_unused=True)
    assert dw is None
    close(n, n_j)
    assert torch.equal(ch.sink["x"], T(x)) and torch.equal(ch.sink["g"],
                                                           T(gy))
    if kind == "expert":
        assert torch.equal(ch.sink["seg"],
                           T(np.where(exids >= 0, exids, BSZ)).long())


# ---------------------------------------------------------------------------
# moe_block_grouped.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "tied_router", "dropping"])
def test_moe_block_grouped_matches_reference(case):
    """Layer 0's MoE block of the reduced config (4 experts, top-2) by
    grouped dispatch: output, aux loss, and the gradients of a loss of
    both with respect to the input, the router and the experts, and the
    norms². tied_router: a zero router (the lower indices win);
    dropping: capacity factor 0.25, so 4 slots an (example, expert) for
    24 choices an example, and overflow is dropped."""
    m, _ = _models(**GROUPED)
    cfg, jcfg = m.cfg, dataclasses.replace(
        jax_get_config(ARCH, reduced=True), **GROUPED)
    if case == "dropping":
        cfg = dataclasses.replace(cfg, capacity_factor=0.25)
        jcfg = dataclasses.replace(jcfg, capacity_factor=0.25)
        assert MOE.capacity_per_example(cfg, 12) == 4 < 12 * 2 // 4
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
        y, aux = JMOE.moe_block_grouped(jcfg, p, x_, th_)
        return jnp.sum(y * wy) + jnp.sum(aux), (y, aux)

    (_, (y_j, aux_j)), grads_j = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        _j(tree), jnp.asarray(x), _j(th))
    p = bridge.train_params_from_numpy(tree, "cpu")
    tx = T(x).requires_grad_()
    tth = {k: T(v).requires_grad_() for k, v in th.items()}
    y, aux = MOE.moe_block_grouped(cfg, p, tx, tth)
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
    # the served block (no thresholds) is the same forward
    with torch.no_grad():
        y_serve, _ = MOE.moe_block_grouped(cfg, p, T(x))
    close(y_serve, y_j)


def test_grouped_decode_step_matches_reference():
    """One paged decode step of grouped granite (every decode branch of
    the reference picks the grouped block): logits and pools."""
    cfg, model, params, jm, jp = _both("granite-moe-3b-a800m-reduced",
                                       **GROUPED)
    assert cfg.moe_dispatch == "grouped"
    seen = []
    real = MOE.moe_block_grouped

    def spy(*a, **k):
        seen.append(1)
        return real(*a, **k)

    MOE.moe_block_grouped = spy
    try:
        _check_serve_step(model, params, jm, jp,
                          np.array([True, True, False, False]))
    finally:
        MOE.moe_block_grouped = real
    assert len(seen) == cfg.num_layers


# ---------------------------------------------------------------------------
# The grouped model: layout, loss, BK.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [True, False])
def test_grouped_layout_matches_reference(reduced):
    m, jm = _models(reduced, **GROUPED)
    assert [(g.name, g.stack_shape, g.dim, g.offset, g.sensitivity_mult)
            for g in m.layout.groups] == [
        (g.name, g.stack_shape, g.dim, g.offset, g.sensitivity_mult)
        for g in jm.layout.groups]
    assert m.layout.flat_names() == jm.layout.flat_names()


@pytest.mark.parametrize("mode", ["per_layer", "non_private"])
def test_grouped_clipped_gradients_match_reference(mode):
    m, jm = _models(**GROUPED)
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size)
    thr = np.random.default_rng(2).uniform(
        0.05, 2.0, m.layout.num_groups).astype(np.float32)
    kw = dict(mode=mode, batch_size=B)
    with jax_backend.scoped("xla"):
        want = jax.jit(functools.partial(jax_clip, jm.loss_fn,
                                         layout=jm.layout, **kw))(
            _j(tree), _j(batch), **({"thresholds": jnp.asarray(thr)}
                                    if mode == "per_layer" else {}))
    if mode == "per_layer":
        kw["thresholds"] = T(thr)
    got = dp_clipped_gradients(
        m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"), _t(batch),
        m.layout, **kw)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-6)
    np.testing.assert_allclose(got.norms_sq.numpy(), np.asarray(want.norms_sq),
                               rtol=1e-5, atol=1e-9)
    assert_trees_close(got.grads, want.grads)


@DISPATCH
def test_moe_capture_matches_reference(change):
    """BK capture on the MoE model: loss, (K, B) norms² and every sink
    (the experts' x, g and the flat dispatch's example ids) against the
    reference's capture; no fallback."""
    m, jm = _models(**change)
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size)
    with jax_backend.scoped("xla"):
        jval, jnorms, jres, jrec = JBK.capture_clipped(
            jm.loss_fn, _j(tree), _j(batch), jm.layout, B)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        val, norms, res, rec = bk.capture_clipped(
            m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"),
            _t(batch), m.layout, B)
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-6)
    np.testing.assert_allclose(norms.numpy(), np.asarray(jnorms), rtol=1e-5,
                               atol=1e-9)
    assert set(rec) == set(jrec) == set(res) == set(jres)
    kind = "expert_grouped" if change else "expert"
    assert rec["moe_blocks/moe/w_gu"].kind == kind
    for name in rec:
        assert rec[name].kind == jrec[name].kind and rec[name].count == 1
        for k, v in res[name].items():
            w = np.asarray(jres[name][k], np.float32)
            assert tuple(v.shape) == w.shape, (name, k)
            np.testing.assert_allclose(
                v.float().numpy(), w, rtol=1e-5,
                atol=1e-5 * max(float(np.abs(w).max()), 1e-30),
                err_msg=f"{name}/{k}")


def _flat_group_kwargs(mode, layout, rng):
    if mode == "ghost_flat":
        return {"flat_threshold": np.float32(rng.uniform(0.2, 1.0))}
    return {"group_assignment": np.asarray(
                [i % 2 for i in range(layout.num_groups)], np.int32),
            "group_thresholds": rng.uniform(0.1, 1.0, 2).astype(np.float32)}


@DISPATCH
@pytest.mark.parametrize("mode", ["ghost_flat", "per_group"])
def test_bk_on_moe_matches_reference_bk_and_twopass(mode, change):
    """ghost_flat and per_group by BK on granite reduced: the port's
    clipped gradients against the reference's BK and the reference's
    twopass, and against the port's own twopass; no fallback warning."""
    m, jm = _models(**change)
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = _batch(m.cfg.vocab_size)
    kw = _flat_group_kwargs(mode, m.layout, np.random.default_rng(4))
    assert JBK.probe_recipes(jm.loss_fn, _j(tree), _j(batch), jm.layout,
                             B) is not None  # the reference runs BK too
    wants = []
    for execution in ("bk", "twopass"):
        with jax_backend.scoped("xla"):
            wants.append(jax.jit(functools.partial(
                jax_clip, jm.loss_fn, layout=jm.layout, mode=mode,
                batch_size=B, execution=execution))(
                _j(tree), _j(batch), **{k: jnp.asarray(v)
                                        for k, v in kw.items()}))
    got = {}
    for execution in ("bk", "twopass"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got[execution] = dp_clipped_gradients(
                m.loss_fn, bridge.train_params_from_numpy(tree, "cpu"),
                _t(batch), m.layout, mode=mode, batch_size=B,
                execution=execution, **{k: T(np.asarray(v))
                                        for k, v in kw.items()})
    for want in wants:
        np.testing.assert_allclose(float(got["bk"].loss), float(want.loss),
                                   rtol=1e-6)
        np.testing.assert_allclose(got["bk"].norms_sq.numpy(),
                                   np.asarray(want.norms_sq), rtol=1e-5,
                                   atol=1e-9)
        assert_trees_close(got["bk"].grads, want.grads)
    assert_trees_close(got["bk"].grads, jax.tree_util.tree_map(
        lambda t: t.detach().numpy(), got["twopass"].grads))


# ---------------------------------------------------------------------------
# The train CLI and the kernel calls.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["ghost_flat", "per_group"])
def test_train_cli_moe_bk_on_cpu(mode, capsys):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert train.main(["--arch", ARCH, "--reduced", "--clipping", mode,
                           "--execution", "bk", "--steps", "2", "--batch",
                           "2", "--seq", "8", "--docs", "8", "--log-every",
                           "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "execution=bk" in out and "bk_falls_back" not in out
    losses = [float(ln.split()[3]) for ln in out.splitlines()
              if ln.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all()


@pytest.mark.parametrize("label", ["ghost_flat_bk", "grouped_per_layer",
                                   "grouped_non_private"])
def test_kernel_calls_per_step_bk_and_grouped(label, monkeypatch):
    """A BK step on flat granite: ghost_norm once per linear (qkv, o, the
    router, the head: the capture asks for norms only, so the router runs
    no fused kernel) and scale_contract once per linear leaf, no
    clip_reduce; a grouped step the kernels of a flat one (the experts
    run none): fused_norm_clip at every linear of the reduced config
    under per_layer, clip_reduce under non_private."""
    from repro_torch.kernels import bk as SC
    calls = _count_calls(monkeypatch)
    calls["scale_contract"] = 0
    real = SC.scale_contract

    def counting(*a, **k):
        calls["scale_contract"] += 1
        return real(*a, **k)

    monkeypatch.setattr(SC, "scale_contract", counting)
    mode = {"ghost_flat_bk": "ghost_flat", "grouped_per_layer": "per_layer",
            "grouped_non_private": "non_private"}[label]
    args = train.build_train_parser().parse_args(
        ["--arch", ARCH, "--reduced", "--clipping", mode, "--execution",
         "bk", "--steps", "2", "--batch", "2", "--seq", "8", "--docs", "4",
         "--device", "cpu"])
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              **({} if label.endswith("bk") else GROUPED))
    trainer = train.Trainer(args, cfg=cfg)
    assert trainer.cfg.moe_dispatch == cfg.moe_dispatch
    met = trainer.step()
    linears = 3 * cfg.num_layers + 1
    want = {"ghost_flat_bk": {"fused_norm_clip": 0, "ghost_norm": linears,
                              "clip_reduce": 0, "scale_contract": 4},
            "grouped_per_layer": {"fused_norm_clip": linears,
                                  "ghost_norm": 0, "clip_reduce": 0,
                                  "scale_contract": 0},
            "grouped_non_private": {"fused_norm_clip": 0, "ghost_norm": 0,
                                    "clip_reduce": linears,
                                    "scale_contract": 0}}[label]
    assert calls == want
    assert np.isfinite(float(met.loss)) and np.isfinite(float(met.grad_norm))
