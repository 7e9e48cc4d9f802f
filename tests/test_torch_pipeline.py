"""Algorithm 2 (`core/pipeline.py`): the pipelined loss on gloo ranks
(one per stage, `launch.mesh.spawn`) against the reference's
single-device `reference_loss` and its per_group driver in one JAX
process (the reference's own pipeline test, `tests/test_pipeline.py`,
cannot run on this machine's jax):

* the losses with +inf thresholds, on every stage, and the gradients of
  their sum (each stage's `blocks` slice from its rank, `embed` from stage
  0, the replicated head);
* per-stage clipping: the port's per_group driver (twopass) over the
  pipelined loss, with the stages as supergroups (embed and head share
  supergroup 0, as in the reference's test), against the reference's
  driver over `reference_loss`: the clipped grads and every group's
  norms² from the rank that owns it;
* the collective log: only the activation / cotangent sends and the
  outputs' broadcast cross the stage axis, none of them norm-sized;
* the port's own `reference_loss` against the reference's.

Tolerances: f32, torch against XLA: rtol 1e-5 and an atol of 1e-5 of the
leaf's largest magnitude (test_torch_train's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as JPL
from repro.core.clipping import dp_clipped_gradients as jax_clip
from repro.core.spec import GroupLayout as JLayout
from repro.kernels import backend as jax_backend
from repro_torch import bridge
from repro_torch.core import pipeline as PL
from repro_torch.core.spec import GroupLayout
import torch_mesh_workers as workers
from test_torch_train import _j, assert_trees_close

CFG = dict(n_stages=2, layers_per_stage=3, d_model=16, d_in=8, n_classes=4)
B = 8


def _flat(tree, prefix=()):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(tree[k])
    return out


@pytest.fixture(scope="module", params=[2, 3], ids=["2_stages",
                                                   "3_stages"])
def run(request, tmp_path_factory):
    cfg = dict(CFG, n_stages=request.param)
    jcfg = JPL.PipelineConfig(**cfg)
    spec = PL.pipeline_spec(PL.PipelineConfig(**cfg))
    jspec = JPL.pipeline_spec(jcfg)
    layout, jlayout = GroupLayout(spec), JLayout(jspec)
    assert [g.name for g in layout.groups] == [g.name for g in
                                               jlayout.groups]
    tree = bridge.numpy_params(spec, seed=0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, cfg["d_in"])).astype(np.float32)
    y = rng.integers(0, cfg["n_classes"], B).astype(np.int32)
    # per-DEVICE supergroups: embed and head -> 0, stage s -> s + 1
    assign = np.zeros(layout.num_groups, np.int64)
    for g in layout.groups:
        if g.name == "stage":
            assign[g.offset: g.offset + g.count] = 1 + np.arange(g.count)
    gth = np.full(int(assign.max()) + 1, 0.05, np.float32)
    got = workers.spawn("pipeline_grads", cfg["n_stages"],
                        store_dir=str(tmp_path_factory.mktemp("pipe")),
                        timeout_s=120, args=(cfg, tree, x, y, assign, gth))
    jp, batch = _j(tree), (jnp.asarray(x), jnp.asarray(y))
    inf = jlayout.pack_value(jnp.inf, B)
    with jax_backend.scoped("xla"):
        losses = JPL.reference_loss(jcfg, jp, batch, inf)
        grads = jax.grad(lambda p: JPL.reference_loss(
            jcfg, p, batch, inf).sum())(jp)
        clip = jax_clip(lambda p, b, t: JPL.reference_loss(jcfg, p, b, t),
                        jp, batch, jlayout, mode="per_group",
                        batch_size=B, execution="twopass",
                        group_assignment=jnp.asarray(assign, jnp.int32),
                        group_thresholds=jnp.asarray(gth))
    return {"got": got, "cfg": cfg, "tree": tree, "x": x, "y": y,
            "layout": layout, "losses": np.asarray(losses),
            "grads": _flat(jax.tree_util.tree_map(np.asarray, grads)),
            "clip_grads": _flat(jax.tree_util.tree_map(np.asarray,
                                                       clip.grads)),
            "clip_norms": np.asarray(clip.norms_sq)}


def _assemble(got, key, n_stages):
    """The global gradient tree from the ranks: each stage's `blocks`
    slice from its rank, embed and head from stage 0."""
    by_stage = {res["stage"]: res[key] for res in got}
    out = dict(by_stage[0])
    for name in ("blocks/w", "blocks/b"):
        out[name] = np.stack([by_stage[s][name][s]
                              for s in range(n_stages)])
    return out


def _close(got, want):
    assert set(got) == set(want)
    for name in got:
        w = np.asarray(want[name], np.float32)
        np.testing.assert_allclose(
            got[name], w, rtol=1e-5,
            atol=1e-5 * max(float(np.abs(w).max()), 1e-30), err_msg=name)


def test_pipelined_losses_match_reference_loss_on_every_stage(run):
    for res in run["got"]:
        np.testing.assert_allclose(res["losses"], run["losses"], rtol=1e-5)


def test_pipelined_grads_match_reference_loss(run):
    _close(_assemble(run["got"], "grads", run["cfg"]["n_stages"]),
           run["grads"])
    for res in run["got"]:  # other stages' slices get no gradient here
        s = res["stage"]
        w = res["grads"]["blocks/w"]
        assert not np.delete(w, s, axis=0).any()


def test_per_stage_clipping_matches_the_per_group_driver(run):
    n = run["cfg"]["n_stages"]
    _close(_assemble(run["got"], "clip_grads", n), run["clip_grads"])
    layout = run["layout"]
    by_stage = {res["stage"]: res["clip_norms"] for res in run["got"]}
    want = run["clip_norms"]
    for g in layout.groups:
        rows = slice(g.offset, g.offset + g.count)
        if g.name == "stage":  # stage s's norms², on stage s alone
            for s in range(n):
                np.testing.assert_allclose(by_stage[s][g.offset + s],
                                           want[g.offset + s], rtol=1e-5)
                others = [by_stage[o][g.offset + s] for o in range(n)
                          if o != s]
                assert not np.any(others)
        else:  # embed and head: stage 0 owns supergroup 0
            np.testing.assert_allclose(by_stage[0][rows], want[rows],
                                       rtol=1e-5)
    # some examples clipped per stage, so the check is not vacuous
    assert (want[layout.group("stage").offset:] > 0.05 ** 2).any()


def test_no_norm_crosses_the_stage_axis(run):
    d, b = run["cfg"]["d_model"], B
    for res in run["got"]:
        for log in (res["log"], res["clip_log"]):
            sites = {c[0] for c in log["log"]}
            assert sites <= {"pipeline_send", "pipeline_out_psum"}, sites
            for site, axes, dtype, numel in log["log"]:
                assert axes == ("pod",)
                # activations of a microbatch, or every microbatch's: never
                # a (B,) or (K, B) norm vector
                assert numel in (b // 2 * d, b * d), (site, numel)
        sends = [c for c in res["log"]["log"] if c[0] == "pipeline_send"]
        assert sends  # the pipeline really communicates


def test_port_reference_loss_matches_the_reference():
    cfg = PL.PipelineConfig(**CFG)
    spec = PL.pipeline_spec(cfg)
    layout = GroupLayout(spec)
    tree = bridge.numpy_params(spec, seed=2)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, CFG["d_in"])).astype(np.float32)
    y = rng.integers(0, CFG["n_classes"], B)
    params = bridge.train_params_from_numpy(tree, "cpu")
    th = layout.pack_value(float("inf"), B)
    got = PL.reference_loss(cfg, params, (torch.from_numpy(x),
                                          torch.from_numpy(y)), th)
    jcfg = JPL.PipelineConfig(**CFG)
    jl = JLayout(JPL.pipeline_spec(jcfg))
    want = JPL.reference_loss(jcfg, _j(tree), (jnp.asarray(x),
                                               jnp.asarray(y)),
                              jl.pack_value(jnp.inf, B))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5)
    g = torch.autograd.grad(got.sum(), [params["blocks"]["w"]])[0]
    jg = jax.grad(lambda p: JPL.reference_loss(
        jcfg, p, (jnp.asarray(x), jnp.asarray(y)),
        jl.pack_value(jnp.inf, B)).sum())(_j(tree))["blocks"]["w"]
    assert_trees_close({"w": g}, {"w": np.asarray(jg)})
