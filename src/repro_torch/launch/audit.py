"""Static DP-safety audit CLI: the clipping x execution x mesh matrix.

The counterpart of `repro.launch.audit`. For every config in the matrix
this CLI builds the port's REAL train step (`make_dp_train_step`,
tiny arch), runs it once on meta tensors and reads it with both static
passes in that one run: `repro_torch.analysis.taint` (the dataflow from
the batch to each parameter's update) and `repro_torch.analysis.rules`
over the traced step (`analysis.graph.analyze_step`: backward passes,
the mesh's collective log, in-place state, data-dependent shapes). The
findings go to `<repo>/.cache/audit/AUDIT.json` or `--out`, stamped with
`kernels.autotune.topology_stamp`, never under `benchmarks/`. Any ERROR
finding exits non-zero: the audit is a CI gate, not a report.

The matrix pins the `plain` engine, as the reference pins
`backend="xla"` and as the dry run does: a hand-written kernel writes its
output through ctypes, outside the dispatcher, so a taint mode cannot see
the factor it applies; the kernels are held to their plain versions on
the card (`chip_smoke.py`). The sharded half runs in this process, as
rank 0 of a fake process group of a 2x4 world (`launch.dryrun.fake_mesh`),
where the reference needs 8 XLA devices.

`--selftest` proves the auditor has teeth: each seeded violation (drop
the clip's marker, double or drop the noise add, reuse a key, write the
state to fresh tensors) must be flagged by exactly its expected rule.

`--device` is the device the audit is run for: cuda (the default) raises
without a CUDA device, cpu does not (the tests pass it); the trace
itself runs on meta tensors either way.

Usage:
  python -m repro_torch.launch.audit --matrix
  python -m repro_torch.launch.audit --mode ghost_flat --execution twopass \\
      --sharded
  python -m repro_torch.launch.audit --selftest --matrix --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import torch
from torch.utils._pytree import tree_map

from repro_torch import optim
from repro_torch.analysis import graph, taint
from repro_torch.analysis.findings import ERROR, WARNING, Finding, errors
from repro_torch.analysis.rules import (RULES, StepExpectation, TracedStep,
                                        rule_shape_stability,
                                        run_trace_rules)
from repro_torch.configs import get_config
from repro_torch.core.clipping import base_mode
from repro_torch.core.dp_sgd import DPConfig, make_dp_train_step
from repro_torch.core.spec import abstract_params
from repro_torch.kernels import _build
from repro_torch.kernels import backend as ghost_backend
from repro_torch.launch import dryrun
from repro_torch.launch.inputs import train_batch_specs
from repro_torch.launch.sharding import group_shard_assignment
from repro_torch.models.config import InputShape
from repro_torch.models.transformer import build_model

AUDIT_PATH = os.path.join(_build.repo_cache_root(), "audit", "AUDIT.json")

# (mode, execution, sharded): the reference's matrix
MATRIX: tuple = tuple(
    (mode, execution, sharded)
    for mode in ("ghost_flat", "per_group")
    for execution in ("bk", "twopass")
    for sharded in (False, True)
) + (
    ("per_layer", "bk", False),
    ("per_layer", "bk", True),
    ("naive_flat", "bk", False),
)

_SHARDED_MESH = (2, 4)  # (data, model): rank 0 of a fake 8-rank group
ENGINE = "plain"


@dataclasses.dataclass
class Case:
    """One config's step: `step_fn(*args)`, what it claims (`expect`),
    its mesh (None unsharded), its loss evaluations (`loss_calls[0]`),
    microbatches and trainable subtree."""

    step_fn: object
    args: tuple
    mesh: object
    expect: StepExpectation
    loss_calls: list
    microbatches: int
    trainable_key: str | None
    private: bool


def build_case(mode: str, execution: str, sharded: bool, *,
               arch: str = "tiny", batch: int = 8, seq: int = 16,
               microbatches: int = 2, mesh=None) -> Case:
    """The step of one config on meta tensors, the reference's settings
    (sigma 1, rate 1e-3 over 100 steps, adaptive, adam 1e-4, the
    `plain` engine). Sharded: `mesh` is the fake 2x4 mesh
    (`dryrun.fake_mesh`) whose rank 0 runs the step; unsharded per_group
    takes the supergroups 4 model shards would own."""
    cfg = get_config(arch)
    if sharded and mesh is None:
        raise ValueError("a sharded case runs on a mesh (dryrun.fake_mesh)")
    model = build_model(cfg, device="meta")
    assign = nsuper = None
    if mode == "per_group" and not sharded:
        # mirror the per-DEVICE partition the sharded engine would derive
        nsuper = _SHARDED_MESH[1]
        assign = group_shard_assignment(model.layout, nsuper)
    dpc = DPConfig(mode=mode, sigma=1.0, sampling_rate=1e-3, steps=100,
                   adaptive=True, microbatches=microbatches,
                   execution=execution, backend=ENGINE,
                   group_assignment=assign, num_supergroups=nsuper)
    calls = [0]

    def loss_fn(params, batch_, th):
        calls[0] += 1
        eng = ghost_backend.active()
        if eng.name != ENGINE:
            raise RuntimeError(f"the audit traces the {ENGINE!r} engine; "
                               f"the step resolved {eng.name!r}")
        return model.loss_fn(params, batch_, th)

    init_fn, step_fn, _plan = make_dp_train_step(
        loss_fn, model.dp_spec, model.layout, optim.adam(1e-4), dpc,
        batch_size=batch, trainable_key=model.trainable_key, mesh=mesh)
    params = abstract_params(model.spec, "meta")
    dryrun._requires_grad(model, params)
    opt_state, dp_state = init_fn(params)
    batch_abs = train_batch_specs(cfg, InputShape("audit", seq, batch,
                                                  "train"), "meta")
    args = (params, opt_state, dp_state, batch_abs, 0)
    expect = StepExpectation(
        mode=base_mode(mode), execution=execution, sharded=sharded,
        layer_trip=dryrun._layer_trip(cfg),
        donated_leaves=len(state_leaves((params, opt_state))))
    return Case(step_fn, args, mesh, expect, calls, microbatches,
                model.trainable_key, dpc.private)


def state_leaves(tree, prefix: tuple = ()) -> list:
    """(name, tensor) of the tensor leaves of a state tree (dicts, named
    tuples, tuples), in a fixed order: params, then opt_state's fields."""
    if isinstance(tree, torch.Tensor):
        return [(".".join(prefix), tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in state_leaves(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or range(len(tree))
        return [x for k, v in zip(names, tree)
                for x in state_leaves(v, prefix + (str(k),))]
    return []


def written_in_place(before, after) -> tuple:
    """((leaf, whether `after`'s leaf is `before`'s storage), ...) over
    the tensor leaves of (params, opt_state)."""
    old, new = state_leaves(before), state_leaves(after)
    out = []
    for i, (name, t) in enumerate(old):
        same = (i < len(new) and new[i][1].untyped_storage()._cdata
                == t.untyped_storage()._cdata)
        out.append((name, same))
    return tuple(out)


@contextlib.contextmanager
def _fresh_state():
    """The update writes fresh tensors: params and opt_state are copied
    before the optimizer runs, so the step returns new storages (the
    port's counterpart of a step jitted without donation)."""
    from repro_torch.core import dp_sgd
    orig = dp_sgd._apply_update

    def copy(tree):
        return tree_map(lambda t: t.detach().clone()
                        if isinstance(t, torch.Tensor) else t, tree)

    def fresh(cfg, optimizer, trainable_key, batch_size, params, opt_state,
              *rest):
        return orig(cfg, optimizer, trainable_key, batch_size, copy(params),
                    copy(opt_state), *rest)

    dp_sgd._apply_update = fresh
    try:
        yield
    finally:
        dp_sgd._apply_update = orig


def trace_case(case: Case, *, jaxpr_only: bool = False) -> dict:
    """Run `case`'s step once under the taint mode inside
    `graph.analyze_step` and read both passes: {findings, leaves (the
    audited trainable leaves), ops (the aten ops the taint mode saw),
    totals, traced (the `TracedStep` the rules read)}; `jaxpr_only`
    keeps the taint pass's findings only."""
    run = lambda *a: taint.trace_step(  # noqa: E731
        case.step_fn, a, private=case.private,
        trainable_key=case.trainable_key)
    try:
        totals, res = graph.analyze_step(run, *case.args, mesh=case.mesh,
                                         device="cpu")
    except Exception as e:  # noqa: BLE001 - a data-dependent shape
        partial = getattr(e, "partial_totals", None)
        if partial is None or not partial.dynamic_shapes:
            raise
        traced = TracedStep(partial)
        found = rule_shape_stability(traced, case.expect)
        found.append(Finding(
            "HLO-SHAPE-STABLE", WARNING,
            f"the trace stopped at a data-dependent shape: "
            f"{type(e).__name__}", "step"))
        return {"findings": found, "leaves": [], "ops": 0,
                "totals": partial, "traced": traced}
    findings = list(res.findings)
    traced = TracedStep(totals, loss_calls=case.loss_calls[0],
                        microbatches=case.microbatches,
                        state=written_in_place(case.args[:2], res.out[:2]))
    if not jaxpr_only:
        findings.extend(run_trace_rules(traced, case.expect, case.mesh))
    return {"findings": findings, "leaves": res.leaves, "ops": res.ops,
            "totals": totals, "traced": traced}


def audit_config(mode: str, execution: str, sharded: bool, *,
                 arch: str = "tiny", donate: bool = True,
                 jaxpr_only: bool = False) -> dict:
    """Run both passes on one config; returns the AUDIT.json record.
    `donate=False` makes the update write fresh tensors (`_fresh_state`);
    `jaxpr_only` keeps the taint pass's findings only."""
    t0 = time.time()
    with contextlib.ExitStack() as scope:
        mesh = None
        if sharded:
            d, m = _SHARDED_MESH
            mesh = scope.enter_context(dryrun.fake_mesh(
                {"data": d, "model": m}, "meta"))
        scope.enter_context(ghost_backend.scoped(ENGINE))
        if not donate:
            scope.enter_context(_fresh_state())
        case = build_case(mode, execution, sharded, arch=arch, mesh=mesh)
        found = trace_case(case, jaxpr_only=jaxpr_only)
    findings: list[Finding] = found["findings"]
    errs = errors(findings)
    return {
        "mode": mode, "execution": execution, "sharded": sharded,
        "arch": arch,
        "status": "error" if errs else "ok",
        "num_errors": len(errs),
        "findings": [f.to_dict() for f in findings],
        "audited_leaves": found["leaves"],
        "ops": found["ops"],
        "op_calls": found["totals"].op_calls,
        "elapsed_s": round(time.time() - t0, 2),
    }


# ---------------------------------------------------------------------------
# Seeded violations: the auditor's own mutation tests (also used by
# tests/test_torch_audit.py). Each mutation breaks ONE invariant in the
# real engine and must be flagged by exactly its expected rule.
# ---------------------------------------------------------------------------

# mutation -> the single rule that must flag it
MUTATIONS = {
    "drop_clip": "JAXPR-CLIP-PATH",        # factor computed unmarked/raw
    "double_noise": "JAXPR-NOISE-ONCE",    # noise added twice per leaf
    "drop_noise": "JAXPR-NOISE-ONCE",      # noise skipped entirely
    "reuse_key": "JAXPR-KEY-LINEAGE",      # every leaf seeded alike
    "strip_donation": "HLO-DONATION",      # the update writes fresh tensors
}


@contextlib.contextmanager
def seeded_violation(name: str):
    """Monkeypatch the engine into one specific DP bug (restored on exit).

    `strip_donation` makes the update write fresh tensors (as
    `audit_config(donate=False)` does: the reference's bug lives in the
    jit call, the port's in the step, so both ways reach it)."""
    from repro_torch.core import clipping, dp_sgd
    if name == "drop_clip":
        # the factor math inlined WITHOUT the dp_clip_factor marker: the
        # numerics still clip, but nothing proves it
        orig = clipping.flat_clip_factors
        clipping.flat_clip_factors = lambda total, c: torch.clamp(
            torch.as_tensor(c, dtype=torch.float32, device=total.device)
            / torch.sqrt(total.float() + 1e-12), max=1.0)
        try:
            yield
        finally:
            clipping.flat_clip_factors = orig
    elif name == "double_noise":
        orig = dp_sgd.add_noise_to_grads

        def twice(spec, layout, grads, stds, seed, step):
            once = orig(spec, layout, grads, stds, seed, step)
            return orig(spec, layout, once, stds, seed, step)

        dp_sgd.add_noise_to_grads = twice
        try:
            yield
        finally:
            dp_sgd.add_noise_to_grads = orig
    elif name == "drop_noise":
        orig = dp_sgd.add_noise_to_grads
        dp_sgd.add_noise_to_grads = \
            lambda spec, layout, grads, stds, seed, step: grads
        try:
            yield
        finally:
            dp_sgd.add_noise_to_grads = orig
    elif name == "reuse_key":
        # every leaf's generator gets the SAME seed parts
        orig = dp_sgd.stable_hash
        dp_sgd.stable_hash = lambda s: 0
        try:
            yield
        finally:
            dp_sgd.stable_hash = orig
    elif name == "strip_donation":
        with _fresh_state():
            yield
    else:
        raise ValueError(f"unknown mutation {name!r}; "
                         f"known: {sorted(MUTATIONS)}")


def run_selftest(arch: str = "tiny") -> list[str]:
    """Each seeded violation must raise exactly its expected rule (and the
    unmutated tree must stay green). Returns a list of failure strings."""
    failures = []
    base = audit_config("ghost_flat", "bk", False, arch=arch,
                        jaxpr_only=True)
    if base["status"] != "ok":
        failures.append(f"green config not green: {base['findings']}")
    for name, want_rule in MUTATIONS.items():
        donate = name != "strip_donation"
        jaxpr_only = name != "strip_donation"
        with seeded_violation(name):
            rec = audit_config("ghost_flat", "bk", False, arch=arch,
                               donate=donate, jaxpr_only=jaxpr_only)
        got = {f["rule"] for f in rec["findings"]
               if f["severity"] == ERROR}
        if got != {want_rule}:
            failures.append(
                f"mutation {name}: expected exactly {{{want_rule}}}, "
                f"got {sorted(got)}")
        else:
            print(f"[selftest ok] {name:16s} -> {want_rule}", flush=True)
    return failures


# ---------------------------------------------------------------------------
# The matrix and the CLI.
# ---------------------------------------------------------------------------


def run_matrix(*, arch: str = "tiny", out_path: str | None = None,
               configs=MATRIX) -> dict:
    from repro_torch.kernels.autotune import topology_stamp
    records = []
    for mode, execution, sharded in configs:
        rec = audit_config(mode, execution, sharded, arch=arch)
        records.append(rec)
        tag = f"{mode}/{execution}/{'sharded' if sharded else 'unsharded'}"
        print(f"[{rec['status']:5s}] {tag:35s} "
              f"{rec['num_errors']} error(s), "
              f"{len(rec['findings'])} finding(s), "
              f"{len(rec['audited_leaves'])} leaves, "
              f"{rec['elapsed_s']}s", flush=True)
        for f in rec["findings"]:
            if f["severity"] == ERROR:
                print(f"    {f['rule']} @ {f['location']}: {f['message']}",
                      flush=True)
    report = {
        "generated_by": "repro_torch.launch.audit",
        "arch": arch,
        "engine": ENGINE,
        "topology": topology_stamp(),
        "rules": {rid: {"severity": sev, "invariant": inv}
                  for rid, (sev, inv) in RULES.items()},
        "num_errors": sum(r["num_errors"] for r in records),
        "configs": records,
    }
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as fh:
            json.dump(report, fh, indent=1)
        print(f"wrote {out_path}", flush=True)
    return report


def build_audit_parser() -> argparse.ArgumentParser:
    """The reference's CLI surface, plus `--device`."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.audit",
                                 description=__doc__)
    ap.add_argument("--matrix", action="store_true",
                    help="run the full clipping x execution x mesh matrix "
                         "(the default when no single config is given)")
    ap.add_argument("--mode", default=None,
                    help="audit one mode (ghost_flat|per_group|per_layer|"
                         "naive_flat)")
    ap.add_argument("--execution", default="bk", choices=["bk", "twopass"])
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--arch", default="tiny")
    ap.add_argument("--selftest", action="store_true",
                    help="seeded-violation suite: each mutation must trip "
                         "exactly its expected rule")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device the audit is run for (cuda unless "
                         "asked; the trace runs on meta tensors)")
    ap.add_argument("--out", default=AUDIT_PATH,
                    help=f"AUDIT.json path (default: {AUDIT_PATH})")
    return ap


def main(argv=None) -> int:
    args = build_audit_parser().parse_args(argv)
    dryrun.check_device(args.device)

    rc = 0
    if args.selftest:
        failures = run_selftest(arch=args.arch)
        for f in failures:
            print(f"[selftest FAIL] {f}", flush=True)
        rc |= 1 if failures else 0
        if not args.matrix and args.mode is None:
            return rc

    configs = MATRIX
    if args.mode is not None:
        configs = ((args.mode, args.execution, args.sharded),)
    report = run_matrix(arch=args.arch, out_path=args.out, configs=configs)
    if report["num_errors"]:
        print(f"AUDIT FAILED: {report['num_errors']} ERROR finding(s)",
              flush=True)
        rc |= 1
    else:
        print(f"audit green: {len(report['configs'])} config(s), "
              f"0 ERROR findings", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
