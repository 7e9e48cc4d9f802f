"""The port's crash-safe training service (`repro_torch.launch.service`) on
the CPU: every test of `tests/test_service.py` on the port's service over
`tiny`, with the same fault matrix and the same bitwise demands (the final
checkpoint's leaves, its manifest meta and the ledger's bytes equal to the
uninterrupted run's); a real `os._exit(86)` through the service CLI; the
train CLI's `--checkpoint-dir` / `--resume`; and the ledger against the JAX
package's: the same records give the same bytes, a ledger written by one
package replays in the other to the same epsilon (1e-12), and the port's
service accepts, and continues, what the reference's service wrote under
the same arguments (q within 1e-12, sigma within 1e-9, as `_restore`
demands).
"""
import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import accounting as JACC
from repro.launch import service as JSVC
from repro_torch.checkpoint import store as S
from repro_torch.core import accounting
from repro_torch.launch import service as svc_mod
from repro_torch.launch import train
from repro_torch.launch.service import (
    BudgetExhausted, FaultInjector, LedgerCorrupt, PrivacyLedger,
    SimulatedCrash, TrainService, build_service_parser, with_retries)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's tests/faults.py settings, on the CPU
TINY_ARGV = [
    "--arch", "tiny", "--steps", "8", "--batch", "8", "--seq", "32",
    "--docs", "64", "--sigma", "0.8", "--checkpoint-every", "3",
    "--log-every", "100", "--device", "cpu",
]


def make_args(service_dir: str, **overrides):
    argv = ["--service-dir", service_dir] + list(TINY_ARGV)
    for k, v in overrides.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return build_service_parser().parse_args(argv)


def run_service(args, runtime, *, fault=None):
    """One incarnation: ("complete", status), ("crashed", point@step) or
    ("budget_exhausted", msg)."""
    svc = TrainService(args, runtime=runtime, fault=fault,
                       sleep=lambda _: None)
    try:
        status = svc.run()
    except SimulatedCrash as e:
        return "crashed", str(e)
    except BudgetExhausted as e:
        return "budget_exhausted", str(e)
    return "complete", status


def state_digest(service_dir: str) -> dict:
    """Bitwise fingerprint of the durable state: the newest verified
    checkpoint's shard bytes, its sampler snapshot and epsilon, the raw
    ledger bytes."""
    ckpt_dir = os.path.join(service_dir, "ckpt")
    step = S.latest_verified_step(ckpt_dir)
    assert step is not None, f"no verified checkpoint under {ckpt_dir}"
    manifest = S.load_manifest(ckpt_dir, step)
    h = hashlib.sha256()
    suffix = S._SHARD_SUFFIX[manifest["codec"]]
    for i in range(manifest["num_shards"]):
        with open(os.path.join(ckpt_dir, f"step_{step:08d}",
                               f"shard_{i:04d}{suffix}"), "rb") as f:
            h.update(f.read())
    with open(os.path.join(service_dir, "ledger.jsonl"), "rb") as f:
        ledger_bytes = f.read()
    return {"step": step, "shards_sha": h.hexdigest(),
            "meta": manifest["meta"],
            "ledger_sha": hashlib.sha256(ledger_bytes).hexdigest(),
            "ledger_records": len([ln for ln in ledger_bytes.splitlines()
                                   if ln])}


def load_final_tree(runtime, service_dir: str):
    found = train.restore_latest(os.path.join(service_dir, "ckpt"),
                                 runtime.model, runtime.init_fn, "cpu")
    assert found is not None
    return found[1]


def assert_trees_bitwise_equal(a, b):
    la, lb = S.tree_flatten(a), S.tree_flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.detach().numpy().tobytes() == y.detach().numpy().tobytes()
        else:
            assert type(x) is type(y) and x == y


def ledger_records(service_dir: str) -> list[dict]:
    return PrivacyLedger(os.path.join(service_dir, "ledger.jsonl")).replay()


def committed_steps(service_dir: str) -> int:
    step = S.latest_verified_step(os.path.join(service_dir, "ckpt"))
    return 0 if step is None else step


@pytest.fixture(scope="module")
def runtime(tmp_path_factory):
    return svc_mod.build_runtime(make_args(str(tmp_path_factory.mktemp("rt"))))


@pytest.fixture(scope="module")
def reference(runtime, tmp_path_factory):
    """Uninterrupted 8-step run: the oracle every faulted run must match."""
    d = str(tmp_path_factory.mktemp("ref"))
    outcome, status = run_service(make_args(d), runtime)
    assert outcome == "complete" and status["committed"] == 8
    return d


# ---------------------------------------------------------------------------
# The fault matrix: kill at each injection point, resume, demand bitwise
# equality with the uninterrupted run.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("point,step", [
    ("pre-ledger-append", 4),    # before the step's spend is durable
    ("post-ledger-append", 4),   # spend durable, update NOT committed
    ("post-ledger-append", 5),   # ditto, off the checkpoint boundary
    ("post-step-commit", 4),     # update done, checkpoint may lag
    ("pre-ckpt-rename", 6),      # mid checkpoint publish (staged, unrenamed)
])
def test_fault_matrix_bitwise_resume(runtime, reference, tmp_path, point,
                                     step):
    d = str(tmp_path)
    args = make_args(d)
    outcome, tag = run_service(
        args, runtime, fault=FaultInjector(point=point, step=step,
                                           mode="raise"))
    assert outcome == "crashed" and tag == f"{point}@{step}"
    outcome, status = run_service(args, runtime)
    assert outcome == "complete" and status["committed"] == 8
    assert state_digest(d) == state_digest(reference)
    assert_trees_bitwise_equal(load_final_tree(runtime, d),
                               load_final_tree(runtime, reference))


def test_ledger_never_undercounts_at_crash(runtime, tmp_path):
    """At the instant of ANY crash, ledger records >= committed steps."""
    for point, step in [("pre-ledger-append", 4), ("post-ledger-append", 4),
                        ("post-step-commit", 4), ("pre-ckpt-rename", 6)]:
        d = str(tmp_path / f"{point}-{step}")
        outcome, _ = run_service(
            make_args(d), runtime,
            fault=FaultInjector(point=point, step=step, mode="raise"))
        assert outcome == "crashed"
        records = ledger_records(d)
        committed = committed_steps(d)
        assert len(records) >= committed
        if point == "post-ledger-append":
            assert len(records) == step + 1 and committed < step + 1


def test_replayed_epsilon_is_monotone(reference):
    recs = ledger_records(reference)
    assert [r["step"] for r in recs] == list(range(8))
    acct = accounting.RdpAccountant()
    eps_seq = []
    for r in recs:
        acct.spend(r["q"], r["sigma"])
        eps_seq.append(acct.epsilon(1e-5))
    assert all(b >= a for a, b in zip(eps_seq, eps_seq[1:]))
    assert eps_seq[0] > 0


def test_budget_exhaustion_refuses_cleanly(runtime, tmp_path):
    """A budget between the 5- and 6-step spend stops the run at exactly 5
    committed steps, checkpointed, and the refusal survives a restart."""
    acct = accounting.RdpAccountant()
    q, sigma = runtime.plan.config.sampling_rate, runtime.plan.sigma
    eps_at = []
    for _ in range(6):
        acct.spend(q, sigma)
        eps_at.append(acct.epsilon(1e-5))
    budget = (eps_at[4] + eps_at[5]) / 2.0
    d = str(tmp_path)
    args = make_args(d, budget_eps=budget)
    outcome, msg = run_service(args, runtime)
    assert outcome == "budget_exhausted", msg
    assert committed_steps(d) == 5
    records = ledger_records(d)
    assert len(records) == 5  # the refused 6th step was never ledgered
    _, eps_spent = accounting.replay_ledger(records, 1e-5)
    assert eps_spent <= budget
    outcome2, _ = run_service(args, runtime)
    assert outcome2 == "budget_exhausted"
    assert committed_steps(d) == 5


def test_resume_after_budget_raise_with_higher_budget(runtime, tmp_path):
    """Raising the budget lets the same ledger continue spending."""
    d = str(tmp_path)
    acct = accounting.RdpAccountant()
    q, sigma = runtime.plan.config.sampling_rate, runtime.plan.sigma
    for _ in range(4):
        acct.spend(q, sigma)
    budget = acct.epsilon(1e-5) + 1e-6
    outcome, _ = run_service(make_args(d, budget_eps=budget), runtime)
    assert outcome == "budget_exhausted"
    committed_before = committed_steps(d)
    outcome2, status = run_service(make_args(d, budget_eps=8.0), runtime)
    assert outcome2 == "complete" and status["committed"] == 8
    assert committed_steps(d) == 8 > committed_before


# ---------------------------------------------------------------------------
# Torn files and graceful degradation.
# ---------------------------------------------------------------------------


def _corrupt_one_byte(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def test_torn_checkpoint_falls_back_and_recovers(runtime, reference,
                                                 tmp_path):
    """A corrupted newest shard is detected (crc), the service falls back to
    the previous verified step and re-trains the gap: the final state still
    equals the oracle's bitwise."""
    d = str(tmp_path)
    args = make_args(d)
    outcome, _ = run_service(args, runtime)
    assert outcome == "complete"
    ckpt = os.path.join(d, "ckpt", "step_00000008")
    shard = next(os.path.join(ckpt, f) for f in sorted(os.listdir(ckpt))
                 if f.startswith("shard_"))
    _corrupt_one_byte(shard)
    assert committed_steps(d) == 6  # fallback target
    outcome2, status = run_service(args, runtime)
    assert outcome2 == "complete" and status["committed"] == 8
    assert state_digest(d) == state_digest(reference)


def _record(step, q=0.01, sigma=1.0):
    return {"step": step, "q": q, "sigma": sigma,
            "orders_crc": svc_mod._ORDERS_CRC}


def test_ledger_torn_tail_is_discarded(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    led = PrivacyLedger(path)
    for i in range(3):
        led.append(_record(i))
    led.close()
    with open(path, "ab") as f:  # a half-written append, as a crash leaves
        f.write(b'{"step":3,"q":0.0')
    out = PrivacyLedger(path).replay()
    assert [r["step"] for r in out] == [0, 1, 2]
    led2 = PrivacyLedger(path)  # the torn tail was truncated away
    led2.append(_record(3))
    led2.close()
    assert [r["step"] for r in PrivacyLedger(path).replay()] == [0, 1, 2, 3]


def test_ledger_midfile_corruption_refuses(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    led = PrivacyLedger(path)
    for i in range(4):
        led.append(_record(i))
    led.close()
    with open(path, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    lines[1] = b'{"step":1,"q":0.999,"sigma":0.0} deadbeef\n'  # bad crc
    with open(path, "wb") as f:
        f.writelines(lines)
    with pytest.raises(LedgerCorrupt):
        PrivacyLedger(path).replay()


@pytest.mark.parametrize("bad", ["gap", "orders"])
def test_ledger_step_gap_or_other_orders_refuses(tmp_path, bad):
    path = str(tmp_path / "ledger.jsonl")
    led = PrivacyLedger(path)
    led.append(_record(0))
    led.append(_record(2) if bad == "gap"
               else dict(_record(1), orders_crc=svc_mod._ORDERS_CRC ^ 1))
    led.close()
    with pytest.raises(LedgerCorrupt):
        PrivacyLedger(path).replay()


def test_retry_backoff_caps_and_gives_up():
    sleeps = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 3:
            raise OSError("transient")
        return "ok"

    out = with_retries(flaky, retries=4, base_delay=0.05, max_delay=0.15,
                       sleep=sleeps.append)
    assert out == "ok" and calls["n"] == 4
    assert sleeps == [0.05, 0.1, 0.15]  # exponential, capped

    with pytest.raises(OSError):
        with_retries(lambda: (_ for _ in ()).throw(OSError("hard")),
                     retries=2, base_delay=0.01, sleep=sleeps.append)


def test_fault_injector_validation():
    with pytest.raises(ValueError):
        FaultInjector(point="no-such-point", step=1)
    inj = FaultInjector.parse("post-ledger-append:7", mode="raise")
    with pytest.raises(SimulatedCrash):
        inj.fire("post-ledger-append", 7)
    inj.fire("post-ledger-append", 6)  # wrong step: no-op
    inj.fire("pre-ledger-append", 7)  # wrong point: no-op
    assert FaultInjector.parse(None).point is None


def test_mechanism_mismatch_refuses(runtime, tmp_path):
    """A ledger spent at a different (q, sigma) must not silently continue
    under this service's mechanism."""
    d = str(tmp_path)
    os.makedirs(d, exist_ok=True)
    led = PrivacyLedger(os.path.join(d, "ledger.jsonl"))
    led.append(_record(0, q=0.5, sigma=2.0))
    led.close()
    with pytest.raises(LedgerCorrupt):
        TrainService(make_args(d), runtime=runtime, sleep=lambda _: None)


# ---------------------------------------------------------------------------
# Processes: the service CLI's real kill, the train CLI's resume.
# ---------------------------------------------------------------------------


def _cli(module, argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", module, *argv], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)


def test_cli_real_kill_exits_86_and_resumes_bitwise(reference, tmp_path):
    d = str(tmp_path)
    argv = ["--service-dir", d, *TINY_ARGV]
    killed = _cli("repro_torch.launch.service",
                  argv + ["--fault-at", "post-ledger-append:5"])
    assert killed.returncode == svc_mod.EXIT_FAULT == 86, killed.stderr
    assert "# FAULT post-ledger-append@5" in killed.stderr
    assert len(ledger_records(d)) == 6 and committed_steps(d) == 3
    resumed = _cli("repro_torch.launch.service", argv)
    assert resumed.returncode == 0, resumed.stderr
    assert "resume_at=3 ledgered=6" in resumed.stdout
    assert "status=complete step=8" in resumed.stdout
    assert state_digest(d) == state_digest(reference)


def test_train_cli_resume_is_bitwise(tmp_path):
    """4 straight steps equal 2 steps, a checkpoint, and a resumed 2."""
    argv = ["--arch", "tiny", "--steps", "4", "--batch", "4", "--seq", "16",
            "--docs", "32", "--log-every", "1", "--seed", "3",
            "--device", "cpu"]
    straight, split = str(tmp_path / "a"), str(tmp_path / "b")
    assert train.main(argv + ["--checkpoint-dir", straight]) == 0
    trainer = train.Trainer(train.build_train_parser().parse_args(argv))
    trainer.step()
    trainer.step()
    S.save_checkpoint(split, 2, trainer.state(),
                      meta={"sampler": trainer.sampler.state()})
    assert train.main(argv + ["--checkpoint-dir", split, "--resume"]) == 0
    assert S.all_steps(split) == [4, 2]
    assert S.manifest_crcs(straight, 4) == S.manifest_crcs(split, 4)
    a, b = (S.load_manifest(x, 4) for x in (straight, split))
    assert a == b
    # a resumed trainer starts where the checkpoint left off
    resumed = train.Trainer(train.build_train_parser().parse_args(
        argv + ["--checkpoint-dir", split, "--resume"]))
    assert resumed.start_step == 4 and resumed.sampler.draws == 4
    with pytest.raises(SystemExit, match="requires --checkpoint-dir"):
        train.Trainer(train.build_train_parser().parse_args(
            argv + ["--resume"]))


# ---------------------------------------------------------------------------
# The ledger against the JAX package's.
# ---------------------------------------------------------------------------


def test_ledger_bytes_and_replay_match_reference(tmp_path):
    assert svc_mod._ORDERS_CRC == JSVC._ORDERS_CRC
    assert svc_mod.FAULT_POINTS == JSVC.FAULT_POINTS
    rng = np.random.default_rng(5)
    mechs = [(float(rng.uniform(1e-3, 0.2)), float(rng.uniform(0.5, 2.0)))
             for _ in range(3)]
    records = [dict(_record(i, *mechs[i % 3])) for i in range(12)]
    paths = {}
    for name, cls in (("port", PrivacyLedger), ("ref", JSVC.PrivacyLedger)):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        led = cls(paths[name])
        for r in records:
            led.append(r)
        led.close()
    with open(paths["port"], "rb") as f, open(paths["ref"], "rb") as g:
        assert f.read() == g.read()
    for written, reader, other in (("ref", PrivacyLedger, JSVC.PrivacyLedger),
                                   ("port", JSVC.PrivacyLedger,
                                    PrivacyLedger)):
        got = reader(paths[written]).replay()
        assert got == other(paths[written]).replay() == records
        eps = accounting.replay_ledger(got, 1e-5)[1]
        assert abs(eps - JACC.replay_ledger(got, 1e-5)[1]) <= 1e-12


def test_port_service_continues_a_reference_service(runtime, tmp_path):
    """The reference's service writes 2 steps (ledger and checkpoints)
    under the same arguments; the port's service accepts its ledger, loads
    its checkpoint bit for bit, and trains on to 4 steps."""
    import jax

    d = str(tmp_path)
    ref_argv = ["--service-dir", d, *TINY_ARGV[:-2], "--steps", "2",
                "--checkpoint-every", "1"]
    jargs = JSVC.build_service_parser().parse_args(ref_argv)
    jsvc = JSVC.TrainService(jargs, sleep=lambda _: None)
    assert jsvc.run()["committed"] == 2
    ref_ledger = open(os.path.join(d, "ledger.jsonl"), "rb").read()
    ref_crcs = S.manifest_crcs(os.path.join(d, "ckpt"), 2)
    assert ref_crcs == [S.leaf_crc32(np.asarray(x)) for x in
                        jax.tree_util.tree_leaves(
                            {"params": jsvc.params,
                             "opt_state": jsvc.opt_state,
                             "dp_state": jsvc.dp_state})]
    svc = TrainService(make_args(d, steps=4), runtime=runtime,
                       sleep=lambda _: None)
    assert abs(svc.q - jsvc.q) <= 1e-12 and abs(svc.sigma - jsvc.sigma) <= 1e-9
    assert svc.committed == 2 and svc.ledgered_steps == 2
    assert abs(svc.epsilon() - jsvc.epsilon()) <= 1e-12
    assert S.tree_crcs(svc.state()) == ref_crcs
    assert svc.run()["committed"] == 4
    with open(os.path.join(d, "ledger.jsonl"), "rb") as f:
        ledger = f.read()
    assert ledger.startswith(ref_ledger)
    assert [r["step"] for r in JSVC.PrivacyLedger(
        os.path.join(d, "ledger.jsonl")).replay()] == [0, 1, 2, 3]
    shutil.rmtree(d)


# ---------------------------------------------------------------------------
# The port's examples on the CPU.
# ---------------------------------------------------------------------------


def _example(name, argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", name), *argv],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)


def test_service_example_walkthrough_on_cpu(tmp_path):
    out = _example("torch_train_service.py",
                   ["--device", "cpu", "--service-dir", str(tmp_path)])
    assert out.returncode == 0, out.stderr
    assert "# FAULT post-ledger-append@5" in out.stderr
    assert "resume_at=3 ledgered=6" in out.stdout
    assert "over 10 ledgered steps (budget 6.0)" in out.stdout
    assert [r["step"] for r in ledger_records(str(tmp_path))] == \
        list(range(10))


def test_e2e_example_checkpoints_on_cpu(tmp_path):
    d = str(tmp_path / "ckpt")
    out = _example("torch_train_e2e.py",
                   ["--device", "cpu", "--steps", "2", "--batch", "4",
                    "--docs", "16", "--log-every", "1",
                    "--checkpoint-dir", d])
    assert out.returncode == 0, out.stderr
    assert "microbatches=2" in out.stdout and "# checkpoint:" in out.stdout
    assert S.all_steps(d) == [2] and S.verify_checkpoint(d, 2)
