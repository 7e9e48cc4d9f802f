"""The sharded train step, the train CLI's `--mesh` and its checkpoint
resume, on gloo ranks on the CPU (`launch.mesh.spawn`, workers in
`torch_mesh_workers`):

* two full steps of `make_dp_train_step(mesh=...)` on a 2x2 mesh for
  per_layer and non_private, and ghost_flat and per_group (by bk) with
  microbatches = 2, with the reference's noise and
  count-noise draws substituted, against the reference's single-device
  step (the reference's `check_step_parity`, `tests/sharded_checks.py:
  110-134`): metrics, thresholds, parameters and momenta, at
  test_torch_train's full-step tolerances; every rank bitwise equal to
  the others; the collective log of the microbatched steps (one
  `flat_norm_psum` a microbatch);
* `--mesh 2x2 --checkpoint-dir` / `--resume`: the step after a resume is
  bitwise the uninterrupted run's, each rank restores its slices of the
  global leaves rank 0 wrote (`tests/sharded_checks.py:222`'s claim);
* the CLI: rank 0's step lines equal the single-device CLI's, the other
  ranks print nothing, the header names the mesh and the backend; a world
  that is not D * M raises;
* the step's `on_clip` hook: the clip result and counts before the noise.
"""
import io
import contextlib

import jax
import numpy as np
import pytest

from repro import optim as joptim
from repro.core import dp_sgd as JDP
from repro.launch.sharding import group_shard_assignment as jax_assignment
import torch

from repro_torch import bridge, optim
from repro_torch.core import dp_sgd
from repro_torch.core.clipping import dp_clipped_gradients
from repro_torch.core.quantile import clip_counts
from repro_torch.core.spec import _walk, tree_leaves
from repro_torch.launch import train
from repro_torch.launch.sharding import _spec_for
import torch_mesh_workers as workers
from test_torch_train import _batch, _j, _models, _reference_draws

B, T = 8, 12
# C(0) that clips some examples of the first batch and not others
INIT = {"per_layer": 0.5, "ghost_flat": 30.0, "per_group": 20.0,
        "non_private": 1.0}
# every mode; the two with a model-axis contract in 2 microbatches
STEP_CASES = [("per_layer", 1), ("non_private", 1), ("ghost_flat", 2),
              ("per_group", 2)]


def _close(got, want, atol_frac=1e-4, rtol=1e-5):
    assert set(got) == set(want)
    for name in got:
        w = np.asarray(want[name], np.float32)
        np.testing.assert_allclose(
            got[name], w, rtol=rtol,
            atol=atol_frac * max(float(np.abs(w).max()), 1e-30),
            err_msg=name)


def _flat(tree, prefix=()):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = tree[k]
    return out


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    m, jm = _models("tiny")
    tree = bridge.numpy_params(m.spec, seed=0)
    batches = [_batch(m.cfg.vocab_size, b=B, t=T, seed=40 + s)
               for s in range(2)]
    assign = jax_assignment(jm.layout, 2)
    key = jax.random.PRNGKey(7)
    cases, want = {}, {}
    for mode, nmb in STEP_CASES:
        name = f"{mode}_mb{nmb}"
        kw = dict(mode=mode, sigma=0.7, sampling_rate=0.05, steps=10,
                  init_threshold=INIT[mode], noise_strategy="weighted",
                  microbatches=nmb)
        if mode == "per_group":
            kw.update(group_assignment=assign, num_supergroups=2)
        j_init, j_step, j_plan = JDP.make_dp_train_step(
            jm.loss_fn, jm.spec, jm.layout, joptim.sgd(0.05, momentum=0.9),
            JDP.DPConfig(backend="xla", **kw), batch_size=B)
        jp, (jo, jd) = _j(tree), j_init(_j(tree))
        step, draws, mets = jax.jit(j_step), [], []
        for s, batch in enumerate(batches):
            draws.append(_reference_draws(
                jm.spec, max(j_plan.num_noise_groups, 1), key, s))
            jp, jo, jd, met = step(jp, jo, jd, _j(batch), key)
            mets.append([float(x) for x in met])
        want[name] = {"params": _flat(jax.tree_util.tree_map(np.asarray, jp)),
                      "momentum": _flat(jax.tree_util.tree_map(
                          np.asarray, jo.momentum)),
                      "thresholds": np.asarray(jd.qstate.thresholds),
                      "metrics": mets}
        cases[name] = (dict(kw, backend="kernels"), draws)
    got = workers.spawn(
        "train_cases", 4, store_dir=str(tmp_path_factory.mktemp("steps")),
        timeout_s=240,
        args=("tiny", False, tree, batches, {"data": 2, "model": 2}, cases),
        kwargs={"batch_size": B})
    return got, want


@pytest.mark.parametrize("name", [f"{m}_mb{n}" for m, n in STEP_CASES])
def test_two_sharded_steps_match_the_reference_with_its_draws(steps, name):
    got, want = steps
    w = want[name]
    rank0 = got[0][name]
    assert rank0["step"] == 2
    np.testing.assert_allclose(rank0["metrics"], w["metrics"], rtol=1e-5)
    if not name.startswith("non_private"):  # some examples clipped
        assert 0.0 < rank0["metrics"][0][1] < 1.0
    np.testing.assert_allclose(rank0["thresholds"], w["thresholds"],
                               rtol=1e-5)
    _close(rank0["params"], w["params"])
    _close(rank0["opt"]["momentum"], w["momentum"])
    assert not np.array_equal(rank0["params"]["head/w"], _flat(
        bridge.numpy_params(_models("tiny")[0].spec, seed=0))["head/w"])
    # the on_clip hook saw each step's globally reduced counts
    assert len(rank0["hooked"]) == 2
    assert (not np.any(rank0["hooked"])) == name.startswith("non_private")
    for res in got[1:]:  # every rank ends bitwise equal
        mine = res[name]
        np.testing.assert_array_equal(mine["hooked"], rank0["hooked"])
        assert mine["metrics"] == rank0["metrics"]
        np.testing.assert_array_equal(mine["thresholds"],
                                      rank0["thresholds"])
        for leaf, v in mine["params"].items():
            np.testing.assert_array_equal(v, rank0["params"][leaf])
        for leaf, v in mine["opt"]["momentum"].items():
            np.testing.assert_array_equal(v, rank0["opt"]["momentum"][leaf])


@pytest.mark.parametrize("name", ["ghost_flat_mb2", "per_group_mb2"])
def test_microbatched_steps_keep_the_sec4_contract(steps, name):
    got, _ = steps
    nmb = int(name[-1])
    for res in got:
        for log in res[name]["logs"]:
            entries = log["log"]
            flat = [c for c in entries if c[0] == "flat_norm_psum"]
            if name.startswith("ghost_flat"):
                assert flat == [("flat_norm_psum", ("model",), "float32",
                                 B // 2 // nmb)] * nmb
            else:
                assert not flat
                trace = log["trace"]
                # no model-axis collective before either microbatch's
                # factors
                # (a microbatch ends with its loss_psum)
                marks = [i for i, e in enumerate(trace) if e == "factors"]
                ends = [i for i, e in enumerate(trace)
                        if e.startswith("issue loss_psum")]
                assert len(marks) == len(ends) == nmb
                for lo, hi in zip([0] + [i + 1 for i in ends[:-1]], marks):
                    idx = [int(e.split("#")[1]) for e in trace[lo:hi]
                           if e.startswith("issue ")]
                    assert not [i for i in idx if "model" in entries[i][1]]


def test_mesh_checkpoint_resume_is_bitwise(tmp_path):
    argv = ["--arch", "tiny", "--clipping", "ghost_flat", "--steps", "3",
            "--batch", str(B), "--seq", "12", "--docs", "32", "--seed", "3",
            "--device", "cpu", "--mesh", "2x2", "--dist-backend", "gloo"]
    got = workers.spawn("checkpoint_resume", 4,
                        store_dir=str(tmp_path / "run"), timeout_s=240,
                        args=(argv, str(tmp_path / "ckpt")))
    m, _ = _models("tiny")
    for res in got:
        assert res["got"]["start_step"] == 2
        assert res["got"]["line"] == res["want"]["lines"][2]
        for part in ("params", "opt"):
            for leaf, v in res["want"][part].items():
                np.testing.assert_array_equal(res["got"][part][leaf], v,
                                              err_msg=leaf)
        assert res["local_shapes"] == res["placed_shapes"]
    # the files hold global leaves; each rank holds 1/M of a sharded one
    sharded = 0
    for path, p in _walk(m.spec):
        spec = _spec_for("/".join(path), p, 2)
        name = "/".join(path)
        assert tuple(p.shape) in got[0]["file_shapes"]
        if "model" in spec:
            sharded += 1
            dim = spec.index("model")
            assert got[0]["local_shapes"][name][dim] == p.shape[dim] // 2
    assert sharded > 0


@pytest.mark.parametrize("clipping", ["per_group", "per_shard"])
def test_mesh_cli_prints_the_single_device_step_lines(tmp_path, clipping):
    """per_group's supergroups and per_shard's blocks come from the mesh's
    model axis: the single-device run takes --group-count 2."""
    argv = ["--arch", "tiny", "--clipping", clipping, "--steps", "2",
            "--batch", "4", "--seq", "16", "--docs", "16", "--log-every",
            "1", "--seed", "3", "--device", "cpu"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(argv + ["--group-count", "2"])
    single = buf.getvalue().splitlines()
    outs = workers.spawn(
        "train_cli", 4, store_dir=str(tmp_path), timeout_s=240,
        args=(argv + ["--mesh", "2x2", "--dist-backend", "gloo"],))
    lines = outs[0].splitlines()
    steps = [ln for ln in lines if ln.startswith("step")]
    assert steps == [ln for ln in single if ln.startswith("step")]
    assert len(steps) == 2
    assert "mesh=2x2 (data=2xmodel=2) dist_backend=gloo" in lines[0]
    if clipping == "per_shard":
        assert "dp_blocks=2" in lines[0] and "mode=per_layer" in lines[0]
    assert lines[0].startswith(single[0])  # the single-device header + mesh
    assert outs[1:] == ["", "", ""]


def test_mesh_cli_refuses_a_world_that_is_not_d_times_m(monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        train.main(["--arch", "tiny", "--mesh", "2x2", "--device", "cpu",
                    "--dist-backend", "gloo"])
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        train.main(["--arch", "tiny", "--mesh", "1x2", "--device", "cpu"])
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(RuntimeError, match="torchrun"):
        train.main(["--arch", "tiny", "--mesh", "1x2", "--device", "cpu",
                    "--dist-backend", "gloo"])


@pytest.mark.parametrize("mode", ["per_layer", "non_private"])
def test_on_clip_sees_the_clip_result_before_the_noise(mode):
    """The hook gets the step's clipped grads (bitwise the driver's on the
    same parameters, though the step then adds noise to them in place)
    and its counts, once a step."""
    m, _ = _models("tiny")
    tree = bridge.numpy_params(m.spec, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(
        m.cfg.vocab_size, b=B, t=T, seed=40).items()}
    seen = []
    init_fn, step_fn, _ = dp_sgd.make_dp_train_step(
        m.loss_fn, m.spec, m.layout, optim.sgd(0.05),
        dp_sgd.DPConfig(mode=mode, sigma=0.7, sampling_rate=0.05,
                        steps=10, init_threshold=INIT[mode]),
        batch_size=B, on_clip=lambda res, counts: seen.append(
            ({p: g.detach().clone() for p, g in tree_leaves(res.grads)},
             counts.clone())))
    params = bridge.train_params_from_numpy(tree, "cpu")
    opt_state, dp_state = init_fn(params)
    th = dp_state.qstate.thresholds.clone()
    kw = {"thresholds": th} if mode == "per_layer" else {}
    want = dp_clipped_gradients(m.loss_fn, params, batch, m.layout,
                                mode=mode, batch_size=B, **kw)
    step_fn(params, opt_state, dp_state, batch, 0)
    (grads, counts), = seen
    for path, g in tree_leaves(want.grads):
        assert torch.equal(grads[path], g), path
    if mode == "per_layer":
        assert torch.equal(counts, clip_counts(want.norms_sq, th))
        assert 0 < float(counts.sum()) < th.numel() * B
    else:
        assert not counts.any()


def test_gloo_point_to_point_refuses_cuda_tensors():
    """gloo sends and receives only host tensors: the mesh refuses a CUDA
    one under gloo, naming the reason, and lets it through NCCL."""
    from types import SimpleNamespace
    from repro_torch.launch.mesh import Mesh
    cuda = SimpleNamespace(is_cuda=True)
    with pytest.raises(ValueError, match="gloo sends and receives only "
                                         "host tensors"):
        Mesh._check_p2p(SimpleNamespace(backend="gloo"), cuda)
    Mesh._check_p2p(SimpleNamespace(backend="nccl"), cuda)
    Mesh._check_p2p(SimpleNamespace(backend="gloo"),
                    SimpleNamespace(is_cuda=False))
