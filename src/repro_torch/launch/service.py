"""Crash-safe online DP training service.

The counterpart of `repro.launch.service`: a long-running daemon around the
private training step of `launch.train` with the durability layer that
keeps a crash from over-spending epsilon (a privacy violation) or
over-refusing (wasted compute):

  * **Persistent privacy ledger**: an append-only, per-line-checksummed
    JSONL of (step, q, sigma, orders-crc) records, byte for byte the
    reference's. The record of step i is appended and **fsynced before**
    step i's update runs, so a crash at any point leaves a ledger that
    covers every release that might have happened: it can over-count by
    the in-flight step, never under-count. On startup it replays through
    `core.accounting.RdpAccountant`.
  * **Hard epsilon enforcement**: before a step is admitted, its projected
    epsilon (`RdpAccountant.peek`) is checked against the budget; a step
    that would exceed it is refused and the service stops cleanly with
    `BudgetExhausted` (a final checkpoint written, the status printed).
  * **Crash-safe checkpoints** (`repro_torch.checkpoint`, the reference's
    format): params, optimizer state, the DP state (thresholds, step) and
    the Poisson sampler's state. The noise of a step is a function of
    (seed, step) and the batch of the sampler's state, so a resume
    replays the killed run bitwise: a step that was ledgered but not
    committed at the crash is re-executed, releases the same output the
    ledger already paid for, and is not ledgered twice.
  * **Fault injection**: `--fault-at POINT:STEP` kills the process
    (`os._exit(86)`) at `pre-ledger-append`, `post-ledger-append` (before
    the commit), `pre-ckpt-rename` (mid checkpoint publish) or
    `post-step-commit`; `mode="raise"` runs the same points in-process.
  * **Retry**: transient I/O failures of the batch fetch, the ledger
    append and the checkpoint save retry with capped exponential backoff;
    a torn newest checkpoint falls back to the newest step that verifies.

  * **Adapter publish** (DP-LoRA, `--lora-rank`): after each full
    checkpoint the service writes the adapters alone, the tree
    `{"lora": ...}` with the epsilon spent in its meta, to
    `<service_dir>/publish`, which a serving engine's
    `launch.swap.AdapterWatcher` polls. A run that trains no adapters
    publishes nothing.

Not ported here: the compile cache and autotune table of the startup
(A.11).

Layout under --service-dir:  ledger.jsonl  +  ckpt/step_<N>/...  (+
publish/step_<N>/... under --lora-rank)

  PYTHONPATH=src python -m repro_torch.launch.service --service-dir DIR \\
      --arch qwen3-4b --steps 4 --batch 8 --seq 256 --docs 128

(`--device cpu` with `--arch tiny` or `--reduced` runs without a GPU.)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import zlib
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.core import accounting
from repro_torch.core.quantile import export_state as export_quantile_state
from repro_torch.data import PoissonSampler, make_lm_batch
from repro_torch.launch.train import (build_everything, build_train_parser,
                                      init_state, restore_latest)

# exit code of a deterministically injected fault (distinguishable from a
# real crash); budget exhaustion is a CLEAN exit (0)
EXIT_FAULT = 86

FAULT_POINTS = ("pre-ledger-append", "post-ledger-append",
                "pre-ckpt-rename", "post-step-commit")

# the reference's: a ledger records the order grid it was accounted on
_ORDERS_CRC = zlib.crc32(json.dumps(
    list(accounting.DEFAULT_ORDERS)).encode())


class BudgetExhausted(Exception):
    """The next step's projected epsilon exceeds the budget: clean stop."""


class LedgerCorrupt(ValueError):
    """The ledger cannot be trusted (non-trailing corruption, step gaps,
    or a mechanism/orders mismatch): refuse to train on top of it."""


class SimulatedCrash(RuntimeError):
    """In-process stand-in for `kill -9` (FaultInjector mode='raise')."""


# ---------------------------------------------------------------------------
# Fault injection.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FaultInjector:
    """Deterministically dies at (point, step).

    mode="exit": `os._exit(EXIT_FAULT)`: no atexit handlers, no buffered
    flushes, the closest user space gets to `kill -9`. mode="raise":
    raises SimulatedCrash; the service loop does not catch it, so the state
    on disk is exactly what the kill would have left.
    """

    point: str | None = None
    step: int = -1
    mode: str = "exit"

    def __post_init__(self):
        if self.point is not None and self.point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r}; one of {FAULT_POINTS}")

    @classmethod
    def parse(cls, spec: str | None, mode: str = "exit") -> "FaultInjector":
        """'POINT:STEP' -> injector (None -> never fires)."""
        if not spec:
            return cls()
        point, _, step = spec.rpartition(":")
        return cls(point=point, step=int(step), mode=mode)

    def fire(self, point: str, step: int) -> None:
        if self.point != point or step != self.step:
            return
        if self.mode == "exit":
            sys.stderr.write(f"# FAULT {point}@{step}\n")
            sys.stderr.flush()
            os._exit(EXIT_FAULT)
        raise SimulatedCrash(f"{point}@{step}")


# ---------------------------------------------------------------------------
# Retry / backoff.
# ---------------------------------------------------------------------------


def with_retries(fn: Callable, *, retries: int = 4, base_delay: float = 0.05,
                 max_delay: float = 2.0, exceptions=(OSError,),
                 sleep: Callable[[float], None] = time.sleep,
                 describe: str = "io"):
    """Run fn(); on a transient failure retry with capped exponential
    backoff (base_delay * 2^attempt, capped at max_delay). The last error
    propagates once `retries` re-attempts are spent."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except exceptions as e:
            if attempt == retries:
                raise
            delay = min(max_delay, base_delay * (2.0 ** attempt))
            sys.stderr.write(
                f"# retry {describe}: attempt {attempt + 1}/{retries} "
                f"failed ({e!r}); backing off {delay:.2f}s\n")
            sleep(delay)


# ---------------------------------------------------------------------------
# The persistent privacy ledger.
# ---------------------------------------------------------------------------


class PrivacyLedger:
    """Append-only checksummed JSONL of per-step privacy spends.

    Line format: ``<compact-json> <crc32-of-json-hex>\\n``. `replay()`
    verifies every line; a torn *trailing* line (the append a crash
    interrupted) is discarded and truncated away: safe, because the
    ledger-before-commit invariant means the step it described never ran.
    Corruption anywhere else raises LedgerCorrupt.
    """

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def replay(self) -> list[dict]:
        if not os.path.exists(self.path):
            return []
        with open(self.path, "rb") as f:
            blob = f.read()
        records, offset = [], 0
        for raw in blob.split(b"\n"):
            if not raw:
                offset += 1  # the newline itself
                continue
            rec = self._parse_line(raw)
            if rec is None:
                if offset + len(raw) >= len(blob):  # torn trailing line
                    with open(self.path, "r+b") as f:
                        f.truncate(offset)
                        f.flush()
                        os.fsync(f.fileno())
                    break
                raise LedgerCorrupt(
                    f"{self.path}: corrupt record at byte {offset} (not the "
                    f"trailing line: the ledger cannot be trusted)")
            records.append(rec)
            offset += len(raw) + 1
        for i, rec in enumerate(records):
            if rec.get("step") != i:
                raise LedgerCorrupt(
                    f"{self.path}: record {i} is for step {rec.get('step')}"
                    f": ledger steps must be 0..n-1 with no gaps")
            if rec.get("orders_crc") != _ORDERS_CRC:
                raise LedgerCorrupt(
                    f"{self.path}: record {i} was accounted on a different "
                    f"RDP order grid")
        return records

    @staticmethod
    def _parse_line(raw: bytes) -> dict | None:
        payload, sep, crc = raw.rpartition(b" ")
        if not sep:
            return None
        try:
            if int(crc, 16) != zlib.crc32(payload):
                return None
            rec = json.loads(payload)
        except ValueError:
            return None
        return rec if isinstance(rec, dict) else None

    def append(self, record: dict) -> None:
        """Durably append one record: write + flush + fsync before
        returning; the caller commits the step only after this returns."""
        payload = json.dumps(record, sort_keys=True,
                             separators=(",", ":")).encode()
        line = payload + b" " + f"{zlib.crc32(payload):08x}".encode() + b"\n"
        if self._fh is None:
            self._fh = open(self.path, "ab")
        self._fh.write(line)
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# ---------------------------------------------------------------------------
# The service.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServiceRuntime:
    """What stays the same across service incarnations: the model, the
    packed corpus and the private step (state-free). The tests and the
    smoke run share one runtime across crash/resume cycles."""

    cfg: object
    model: object
    rows: np.ndarray
    init_fn: Callable
    step: Callable
    plan: object
    batch: int
    seed: int
    device: torch.device

    def make_sampler(self) -> PoissonSampler:
        return PoissonSampler(num_examples=self.rows.shape[0],
                              rate=self.batch / self.rows.shape[0],
                              max_batch=self.batch, seed=1)


def build_runtime(args, *, cfg=None) -> ServiceRuntime:
    """The service's model, data and step from its arguments; `cfg`
    replaces the config of `--arch` (a depth cut), as in
    `launch.train.build_everything`."""
    # sigma is calibrated for the --calib-steps horizon (default --steps);
    # running past it is what the budget gate is for
    build_args = argparse.Namespace(**vars(args))
    build_args.steps = getattr(args, "calib_steps", None) or args.steps
    cfg, model, rows, _sampler, init_fn, step_fn, plan = build_everything(
        build_args, cfg=cfg)
    return ServiceRuntime(cfg=cfg, model=model, rows=rows, init_fn=init_fn,
                          step=step_fn, plan=plan, batch=args.batch,
                          seed=args.seed, device=torch.device(args.device))


class TrainService:
    """One incarnation of the daemon over a --service-dir.

    Construction replays the ledger and loads the newest verified
    checkpoint (or initializes fresh state); `run()` trains until
    `target_steps` are committed or the budget is exhausted (raising
    BudgetExhausted after a final checkpoint).
    """

    def __init__(self, args, *, runtime: ServiceRuntime | None = None,
                 fault: FaultInjector | None = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.args = args
        self.fault = fault or FaultInjector.parse(
            getattr(args, "fault_at", None))
        self.sleep = sleep
        self.runtime = runtime or build_runtime(args)
        self.target_steps = args.steps
        self.delta = args.delta
        self.budget_eps = getattr(args, "budget_eps", None) or args.epsilon
        if self.budget_eps is None:
            raise ValueError("service needs a budget: --budget-eps (or "
                             "--epsilon for sigma calibration)")
        self.ckpt_every = max(1, getattr(args, "checkpoint_every", 10))

        os.makedirs(args.service_dir, exist_ok=True)
        self.ckpt_dir = os.path.join(args.service_dir, "ckpt")
        # adapter-only publishes for the serving side (launch.swap),
        # written only when the run trains adapters
        self.publish_dir = os.path.join(args.service_dir, "publish")
        self.ledger = PrivacyLedger(
            os.path.join(args.service_dir, "ledger.jsonl"))

        rt = self.runtime
        self.q = float(rt.plan.config.sampling_rate)
        self.sigma = float(rt.plan.sigma)
        self.sampler = rt.make_sampler()
        self.step_seed = rt.seed + 1
        self._restore()

    # -- startup: ledger replay + checkpoint restore -----------------------

    def _restore(self) -> None:
        records = with_retries(self.ledger.replay, sleep=self.sleep,
                               describe="ledger replay")
        self.acct = accounting.RdpAccountant()
        for rec in records:
            if (abs(rec["q"] - self.q) > 1e-12
                    or abs(rec["sigma"] - self.sigma) > 1e-9):
                raise LedgerCorrupt(
                    f"ledger step {rec['step']} was spent at "
                    f"(q={rec['q']}, sigma={rec['sigma']}) but this service "
                    f"is configured for (q={self.q}, sigma={self.sigma}): "
                    f"refusing to mix mechanisms in one ledger")
            self.acct.spend(rec["q"], rec["sigma"])
        self.ledgered_steps = len(records)

        rt = self.runtime
        found = with_retries(
            lambda: restore_latest(self.ckpt_dir, rt.model, rt.init_fn,
                                   rt.device),
            sleep=self.sleep, describe="checkpoint load")
        if found is None:
            self.committed = 0
            state = init_state(rt.model, rt.init_fn, rt.seed, rt.device)
        else:
            self.committed, state, manifest = found
            meta = manifest.get("meta") or {}
            if "sampler" in meta:
                self.sampler.restore(meta["sampler"])
            if self.sampler.draws != self.committed:
                raise LedgerCorrupt(
                    f"checkpoint step {self.committed} carries a sampler at "
                    f"draw {self.sampler.draws}: sample stream and commit "
                    f"log disagree")
        self.params = state["params"]
        self.opt_state, self.dp_state = state["opt_state"], state["dp_state"]
        # the privacy invariant: every committed step MUST be ledgered (the
        # converse, ledgered but uncommitted, is the safe crash gap that
        # deterministic re-execution closes)
        if self.ledgered_steps < self.committed:
            raise LedgerCorrupt(
                f"ledger covers {self.ledgered_steps} steps but "
                f"{self.committed} steps are committed: the ledger "
                f"under-counts; refusing to continue")

    # -- the step loop -----------------------------------------------------

    def epsilon(self) -> float:
        return self.acct.epsilon(self.delta)

    def _fetch_batch(self) -> dict[str, torch.Tensor]:
        def fetch():
            idx = self.sampler.next_indices()
            return make_lm_batch(self.runtime.rows, idx, self.runtime.batch)
        batch = with_retries(fetch, sleep=self.sleep, describe="batch fetch")
        return {k: torch.from_numpy(v).to(self.runtime.device)
                for k, v in batch.items()}

    def _admit(self, step: int) -> None:
        """The budget gate + the ledger-before-commit append for `step`."""
        if step < self.ledgered_steps:
            # Re-executing a step that was ledgered but not committed when
            # the previous incarnation died. The resume is bitwise
            # deterministic (same params, same sampler stream, noise from
            # (seed, step)), so this re-release is the SAME mechanism
            # output the ledger already paid for: spending it again would
            # double-count.
            return
        projected = self.acct.peek(self.q, self.sigma, self.delta)
        if projected > self.budget_eps + 1e-9:
            raise BudgetExhausted(
                f"step {step} projects epsilon {projected:.4f} > budget "
                f"{self.budget_eps} (delta={self.delta}); spent so far: "
                f"{self.epsilon():.4f} over {self.acct.steps} steps")
        self.fault.fire("pre-ledger-append", step)
        record = {"step": step, "q": self.q, "sigma": self.sigma,
                  "orders_crc": _ORDERS_CRC}
        with_retries(lambda: self.ledger.append(record), sleep=self.sleep,
                     describe="ledger append")
        self.acct.spend(self.q, self.sigma)
        self.ledgered_steps += 1
        self.fault.fire("post-ledger-append", step)

    def state(self) -> dict:
        """The checkpointed tree (the reference's keys)."""
        return {"params": self.params, "opt_state": self.opt_state,
                "dp_state": self.dp_state}

    def _checkpoint(self) -> str:
        step = self.committed
        meta = {
            "sampler": self.sampler.state(),
            "ledger_records": self.ledgered_steps,
            "epsilon": self.epsilon(),
            "quantile": export_quantile_state(self.dp_state.qstate),
            "mechanism": {"q": self.q, "sigma": self.sigma,
                          "delta": self.delta},
        }

        def hook(stage):  # the mid-publish kill of the fault matrix
            if stage == "pre-rename":
                self.fault.fire("pre-ckpt-rename", step)

        path = with_retries(
            lambda: save_checkpoint(self.ckpt_dir, step, self.state(),
                                    meta=meta, fault_hook=hook),
            sleep=self.sleep, describe="checkpoint save")
        self._publish_adapter(step)
        return path

    def _publish_adapter(self, step: int) -> None:
        """The adapter-only publish for live serving (`launch.swap` polls
        `<service_dir>/publish`). It follows the full checkpoint, so a
        publish never refers to training state that could be lost; the
        tree is `{"lora": ...}`, the watcher's template, with the epsilon
        spent in its meta. Nothing on a run that trains no adapters."""
        if (self.runtime.model.trainable_key != "lora"
                or "lora" not in self.params):
            return
        meta = {"epsilon": self.epsilon(), "delta": self.delta,
                "source_step": step}
        with_retries(
            lambda: save_checkpoint(self.publish_dir, step,
                                    {"lora": self.params["lora"]},
                                    meta=meta),
            sleep=self.sleep, describe="adapter publish")

    def run(self) -> dict:
        """Train until target_steps are committed or the budget runs out.

        Returns a status dict; raises BudgetExhausted (after writing a
        final checkpoint) when the gate refuses the next step: callers
        treat that as a CLEAN shutdown. SimulatedCrash / os._exit from the
        fault injector propagate uncaught, by design.
        """
        log_every = max(1, getattr(self.args, "log_every", 10))
        while self.committed < self.target_steps:
            step = self.committed
            try:
                self._admit(step)
            except BudgetExhausted:
                self._checkpoint()  # make the refusal cheap to resume from
                self.ledger.close()
                raise
            batch = self._fetch_batch()
            self.params, self.opt_state, self.dp_state, met = \
                self.runtime.step(self.params, self.opt_state, self.dp_state,
                                  batch, self.step_seed)
            loss = float(met.loss)  # waits: the update is now materialized
            self.committed += 1
            self.fault.fire("post-step-commit", step)
            if step % log_every == 0 or self.committed == self.target_steps:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"eps {self.epsilon():.4f}/{self.budget_eps} "
                      f"thr {float(met.mean_threshold):.4f}", flush=True)
            if (self.committed % self.ckpt_every == 0
                    or self.committed == self.target_steps):
                self._checkpoint()
        self.ledger.close()
        return {"status": "complete", "committed": self.committed,
                "epsilon": self.epsilon(), "budget_eps": self.budget_eps}


# ---------------------------------------------------------------------------
# CLI.
# ---------------------------------------------------------------------------


def build_service_parser() -> argparse.ArgumentParser:
    ap = build_train_parser(
        mesh=False, description="crash-safe online DP training service")
    ap.add_argument("--service-dir", required=True,
                    help="durable state root: ledger.jsonl + ckpt/ (+ "
                         "publish/ under --lora-rank)")
    ap.add_argument("--budget-eps", type=float, default=None,
                    help="hard epsilon budget enforced by the admission "
                         "gate (default: --epsilon)")
    ap.add_argument("--calib-steps", type=int, default=None,
                    help="horizon used to calibrate sigma from --epsilon "
                         "(default: --steps); set it below --steps to "
                         "drive the run into budget exhaustion")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--fault-at", default=None, metavar="POINT:STEP",
                    help=f"die (os._exit {EXIT_FAULT}) at an injection "
                         f"point; POINT one of {', '.join(FAULT_POINTS)}")
    return ap


def main(argv=None) -> int:
    args = build_service_parser().parse_args(argv)
    svc = TrainService(args)
    print(f"# service dir={args.service_dir} arch={svc.runtime.cfg.name} "
          f"mode={svc.runtime.plan.config.mode} q={svc.q:.5f} "
          f"sigma={svc.sigma:.4f} budget_eps={svc.budget_eps} "
          f"resume_at={svc.committed} ledgered={svc.ledgered_steps} "
          f"eps_spent={svc.epsilon():.4f}", flush=True)
    try:
        status = svc.run()
    except BudgetExhausted as e:
        print(f"# service: status=budget_exhausted step={svc.committed} "
              f"epsilon={svc.epsilon():.4f} budget={svc.budget_eps}")
        print(f"# {e}")
        return 0
    print(f"# service: status={status['status']} step={status['committed']} "
          f"epsilon={status['epsilon']:.4f} budget={status['budget_eps']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
