"""The crash-safe training service on a mesh of ranks (`python -m
repro_torch.launch.service --mesh 2x2 --dist-backend gloo`) and the
host-staged point-to-point transport, on the CPU.

The service runs DP-LoRA (`--lora-rank 4`, per_group by BK: per-device
clipping) on tiny, 4 steps, a checkpoint and an adapter publish every 2,
on a 2x2 gloo mesh under `launch.mesh.spawn` (workers in
`torch_mesh_workers`), two spawns for the whole module:

* the first incarnation, the CLI under its launcher (`python -m
  repro_torch.launch.mesh --nproc 4 repro_torch.launch.service ...`),
  dies at `post-ledger-append:3`: rank 0's `os._exit(86)` ends the
  launch, which exits 86;
* the second spawn resumes it and runs an uninterrupted mesh run of the
  same flags beside it: the resumed run ends on the uninterrupted run's
  crcs on every rank, every rank's parameters are the same bits, and
  rank 0 alone writes the checkpoints and the publishes, whose crcs
  equal their manifests';
* both ledgers equal the single-device service's (this process), record
  for record and in epsilon, and the adapters are those of the
  single-device service up to f32 summation order (rtol 1e-5, atol 1e-4
  of a leaf's largest magnitude, test_torch_sharded_train's step
  tolerance). The single-device service is held to the reference's in
  `test_torch_service.py`.

The staging check runs two pipeline stages over gloo with CUDA tensors
against the CPU's `reference_loss`; it needs a card (`-m cuda`) and skips
here (`test_torch_sharded_train.py` checks the transport's choice
without a card).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint.store import (all_steps, load_checkpoint,
                                          manifest_crcs)
from repro_torch.core import pipeline as PL
from repro_torch.core.accounting import replay_ledger
from repro_torch.core.spec import GroupLayout, meta_params, tree_leaves
from repro_torch.launch import service
import torch_mesh_workers as workers

MESH = ["--mesh", "2x2", "--dist-backend", "gloo"]
ARGV = ["--arch", "tiny", "--lora-rank", "4", "--clipping", "per_group",
        "--steps", "4", "--batch", "8", "--seq", "16", "--docs", "32",
        "--checkpoint-every", "2", "--device", "cpu", "--seed", "3"]
CRASH = ["--fault-at", "post-ledger-append:3"]


def _argv(directory, *extra):
    return ARGV + ["--service-dir", str(directory), *extra]


@pytest.fixture(scope="module")
def svc(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_service")
    crashed, whole, single = root / "crashed", root / "whole", root / "one"
    fault = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mesh", "--nproc", "4",
         "repro_torch.launch.service", *_argv(crashed, *MESH, *CRASH)],
        capture_output=True, text=True, timeout=120)
    ledger_at_crash = (crashed / "ledger.jsonl").read_bytes()
    ckpts_at_crash = all_steps(str(crashed / "ckpt"))
    runs = workers.spawn("service_runs", 4, store_dir=str(root / "s2"),
                         timeout_s=120, args=([_argv(crashed, *MESH),
                                               _argv(whole, *MESH)],))
    one = service.TrainService(service.build_service_parser().parse_args(
        _argv(single)), sleep=lambda _: None)
    one.run()
    return {"fault": fault, "ledger_at_crash": ledger_at_crash,
            "ckpts_at_crash": ckpts_at_crash, "runs": runs, "one": one,
            "dirs": {"crashed": crashed, "whole": whole, "one": single}}


def test_a_fault_ends_the_mesh_launch_with_86(svc):
    assert svc["fault"].returncode == service.EXIT_FAULT == 86
    assert "rank 0 exited 86" in svc["fault"].stderr
    # rank 0 appended and fsynced step 3's record, then died before the
    # step: four records, the step-2 checkpoint
    assert svc["ledger_at_crash"].count(b"\n") == 4
    assert svc["ckpts_at_crash"] == [2]


def test_the_resumed_mesh_run_ends_on_the_uninterrupted_crcs(svc):
    runs = svc["runs"]
    for rank, (resumed, whole) in enumerate(runs):
        assert resumed["start"] == 2 and whole["start"] == 0
        assert resumed["status"]["committed"] == 4
        assert resumed["crcs"] == whole["crcs"], rank
        assert resumed["crcs"] == runs[0][0]["crcs"], rank  # every rank
    d = svc["dirs"]
    assert manifest_crcs(str(d["crashed"] / "ckpt"), 4) == manifest_crcs(
        str(d["whole"] / "ckpt"), 4)


def test_the_mesh_ledger_is_the_single_device_services(svc):
    d, one = svc["dirs"], svc["one"]
    want = (d["one"] / "ledger.jsonl").read_bytes()
    assert want.count(b"\n") == 4
    for name in ("crashed", "whole"):
        assert (d[name] / "ledger.jsonl").read_bytes() == want, name
    records = service.PrivacyLedger(str(d["whole"] / "ledger.jsonl")
                                    ).replay()
    _, eps = replay_ledger(records, delta=1e-5)
    assert abs(eps - one.epsilon()) < 1e-12
    for rank in svc["runs"]:
        assert abs(rank[1]["status"]["epsilon"] - one.epsilon()) < 1e-12


def test_the_mesh_adapters_are_the_single_device_services(svc):
    one = svc["one"]
    template = {"lora": meta_params(one.runtime.model.spec["lora"])}
    got = load_checkpoint(str(svc["dirs"]["whole"] / "publish"), 4,
                          template, verify=True, device="cpu")
    want = dict(tree_leaves(one.params["lora"], ("lora",)))
    paths = dict(tree_leaves(got))
    assert set(paths) == set(want)
    for path, g in paths.items():
        w = want[path].detach()
        assert not torch.equal(g, torch.zeros_like(g)), path
        torch.testing.assert_close(
            g, w, rtol=1e-5, atol=1e-4 * float(w.abs().max()),
            msg=lambda m: f"{path}: {m}")


def test_rank_0_alone_writes_and_each_publish_matches_its_manifest(svc):
    runs = svc["runs"]
    assert runs[0][0]["writes"] == [("ckpt", 4), ("publish", 4)]
    assert runs[0][1]["writes"] == [("ckpt", 2), ("publish", 2),
                                    ("ckpt", 4), ("publish", 4)]
    assert all(not r["writes"] for res in runs[1:] for r in res)
    for name in ("crashed", "whole"):
        pub = str(svc["dirs"][name] / "publish")
        assert all_steps(pub) == [4, 2]
        assert not [f for f in os.listdir(pub) if f.startswith("tmp-")]
        for res in runs:
            assert manifest_crcs(pub, 4) == res[0]["lora_crcs"]


def test_a_checkpoint_directory_not_shared_by_every_rank_raises(tmp_path):
    """Rank 0's marker file is missing on a rank whose directory of the
    same name is another disk (here: another directory): every rank
    raises, before any save, and rank 0 removes its marker."""
    from repro_torch.launch.train import check_shared
    names = []

    class Rank:
        size, axis_names, device = 2, ("data", "model"), "cpu"

        def __init__(self, rank, peer_misses):
            self.rank, self.peer_misses = rank, peer_misses

        def broadcast_object(self, obj):
            if self.rank == 0:
                names.append(obj)
            return names[0]

        def psum(self, t, axes, *, site):
            assert site == "shared_dir_check"
            return t + self.peer_misses

    own, other = tmp_path / "rank0", tmp_path / "rank1"
    with pytest.raises(RuntimeError, match="1 of 2 ranks do not see"):
        check_shared(Rank(0, peer_misses=1), str(own))
    assert os.listdir(own) == []
    other.mkdir()
    with pytest.raises(RuntimeError, match="must be shared by every rank"):
        check_shared(Rank(1, peer_misses=0), str(other))
    names.clear()
    check_shared(Rank(0, peer_misses=0), str(own))  # shared: no error
    assert os.listdir(own) == []


def test_service_parser_takes_mesh_and_dist_backend():
    args = service.build_service_parser().parse_args(
        _argv("x", "--mesh", "2x4", "--dist-backend", "gloo"))
    assert (args.mesh, args.dist_backend) == ("2x4", "gloo")
    assert service.build_service_parser().parse_args(
        _argv("x")).mesh is None


CFG = dict(n_stages=2, layers_per_stage=3, d_model=16, d_in=8, n_classes=4)


@pytest.mark.cuda
def test_two_pipeline_stages_over_gloo_on_the_card(tmp_path):
    """Activations and cotangents sent as CUDA tensors between two gloo
    ranks on the card (staged through the host), against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = PL.PipelineConfig(**CFG)
    spec = PL.pipeline_spec(cfg)
    layout = GroupLayout(spec)
    tree = bridge.numpy_params(spec, seed=0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, CFG["d_in"])).astype(np.float32)
    y = rng.integers(0, CFG["n_classes"], 8).astype(np.int32)
    assign = np.zeros(layout.num_groups, np.int64)
    assign[layout.group("stage").offset:] = 1 + np.arange(2)
    got = workers.spawn("pipeline_grads", 2, store_dir=str(tmp_path),
                        device="cuda", timeout_s=120,
                        args=(CFG, tree, x, y, assign,
                              np.full(3, 0.05, np.float32)))
    params = bridge.train_params_from_numpy(tree, "cpu")
    inf = layout.pack_value(float("inf"), 8)
    want = PL.reference_loss(cfg, params, (torch.from_numpy(x),
                                           torch.from_numpy(y).long()), inf)
    grads = torch.autograd.grad(want.sum(), [params["blocks"]["w"]])[0]
    for res in got:
        assert res["device"].startswith("cuda") and res["drained"]
        np.testing.assert_allclose(res["losses"], want.detach().numpy(),
                                   rtol=1e-5)
        s = res["stage"]
        np.testing.assert_allclose(res["grads"]["blocks/w"][s],
                                   grads[s].numpy(), rtol=1e-5,
                                   atol=1e-5 * float(grads.abs().max()))
        assert {c[0] for c in res["log"]["log"]} == {"pipeline_send",
                                                     "pipeline_out_psum"}
