"""Trace rules engine: named, severity-tagged checks over a traced step.

The counterpart of `repro.analysis.rules`, with the reference's rule
catalog (its ids and severities, and its invariants less their
bug-history notes, so the two packages' records compare). Torch has no HLO: the rules read the step the dry run
traces (`analysis.graph.analyze_step`: its `Totals`) and the mesh's
collective log, through a `TracedStep`, and `run_trace_rules` takes the
place of `run_hlo_rules`:

  HLO-COLL-LEAK     the mesh's log (`graph.classify_collectives` +
                    `filter_model_norm_rows`), the reference's whitelist
                    and WARNING;
  HLO-BWD-COUNT     `graph.backward_passes` of the DP linears' calls;
  HLO-DONATION      torch has no donation: the port's counterpart is that
                    the step writes its state IN PLACE, so every params
                    and opt_state tensor leaf of its result must be its
                    input's storage (dp_state is left out: the quantile
                    update returns new thresholds, ROADMAP C);
  HLO-SHAPE-STABLE  the ops the trace's `StepMeter` recorded as having a
                    value-dependent output shape (recorded before they
                    run, so a meta trace reports them instead of
                    crashing).

Each rule takes the traced step plus a `StepExpectation` describing what
the config CLAIMS and returns findings; the engine never asserts:
`repro_torch.launch.audit` (and the dry run's `--audit`) decide that any
ERROR finding fails the run.
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis.findings import ERROR, INFO, WARNING, Finding
from repro_torch.analysis.graph import (Totals, backward_passes,
                                        classify_collectives,
                                        filter_model_norm_rows)

# rule id -> (severity when violated, invariant): the reference's catalog,
# its ids, severities and invariants (less their bug-history notes)
RULES = {
    "JAXPR-CLIP-PATH": (
        ERROR,
        "every batch-derived dataflow path into a trainable parameter's "
        "update passes a dp_clip_factor multiply (per-example clipping is "
        "structurally unskippable)"),
    "JAXPR-NOISE-ONCE": (
        ERROR,
        "exactly one Gaussian noise draw joins each trainable leaf's "
        "summed clipped gradient before the optimizer consumes it"),
    "JAXPR-KEY-LINEAGE": (
        ERROR,
        "every noise key is folded from a static per-leaf hash and no two "
        "leaves fold to the same key signature"),
    "HLO-COLL-LEAK": (
        ERROR,
        "no model-axis collective carries per-example norm data, except "
        "ghost_flat's single whitelisted flat_norm_psum (paper Sec. 4 "
        "communication contract)"),
    "HLO-BWD-COUNT": (
        ERROR,
        "the compiled step traverses the layer stack backward exactly once "
        "under execution=bk (twice under the twopass reference)"),
    "HLO-DONATION": (
        ERROR,
        "every params/opt_state/dp_state leaf is input_output_aliased in "
        "the entry computation — donation actually took"),
    "HLO-SHAPE-STABLE": (
        ERROR,
        "no instruction carries a bounded-dynamic (data-dependent) shape; "
        "compiled programs are traffic-independent"),
}


@dataclasses.dataclass(frozen=True)
class StepExpectation:
    """What the config under audit claims about its traced step."""

    mode: str                 # base clipping mode (no _twopass suffix)
    execution: str = "bk"     # bk | twopass
    sharded: bool = False
    layer_trip: int | None = None     # depth of the layer stack
    donated_leaves: int | None = None  # tensor leaves of (params, opt)
    model_axis: str = "model"
    # model-axis norm collectives whose site contains one of these
    # substrings are the mode's documented, intentional traffic
    norm_whitelist: tuple = ("flat_norm_psum",)


@dataclasses.dataclass(frozen=True)
class TracedStep:
    """What the rules read of one traced step: its `Totals`, the loss
    evaluations and microbatches `backward_passes` divides by, and each
    params / opt_state tensor leaf of the result with whether the step
    wrote it in place (its input's storage)."""

    totals: Totals
    loss_calls: int = 1
    microbatches: int = 1
    state: tuple = ()  # ((leaf name, written in place), ...)


def _expected_backward(expect: StepExpectation) -> int | None:
    if expect.mode in ("ghost_flat", "per_group"):
        return 2 if expect.execution == "twopass" else 1
    if expect.mode in ("per_layer", "non_private"):
        return 1
    return None  # naive_flat: one backward per example, no expectation


def rule_collective_leak(step: TracedStep, expect: StepExpectation,
                         mesh=None) -> list[Finding]:
    if not expect.sharded or mesh is None:
        return []
    rows = classify_collectives(mesh)
    norm_rows = filter_model_norm_rows(rows, model_axis=expect.model_axis)
    allowed = (expect.norm_whitelist if expect.mode == "ghost_flat" else ())
    findings = []
    whitelisted = 0
    for r in norm_rows:
        if any(w in r["site"] for w in allowed):
            whitelisted += 1
            continue
        findings.append(Finding(
            "HLO-COLL-LEAK", ERROR,
            f"{r['kind']} over axes {'+'.join(r['axes'])} carries "
            f"per-example norm data ({int(r['count'])}x, "
            f"{int(r['bytes'])} bytes) outside the whitelist",
            r["site"]))
    if expect.mode == "ghost_flat" and whitelisted == 0:
        findings.append(Finding(
            "HLO-COLL-LEAK", WARNING,
            "ghost_flat traced WITHOUT its flat_norm_psum model-axis "
            "collective — program does not match the claimed structure",
            "flat_norm_psum"))
    if not findings:
        findings.append(Finding(
            "HLO-COLL-LEAK", INFO,
            f"{len(norm_rows)} model-axis norm collective site(s), all "
            f"whitelisted" if norm_rows else
            "zero model-axis norm collectives", "collectives"))
    return findings


def rule_backward_count(step: TracedStep, expect: StepExpectation
                        ) -> list[Finding]:
    if expect.layer_trip is None or expect.layer_trip < 2:
        return []
    want = _expected_backward(expect)
    got = backward_passes(step.totals.linear_calls, step.loss_calls,
                          step.microbatches)
    if want is None:
        return [Finding("HLO-BWD-COUNT", INFO,
                        f"measured {got} backward traversals "
                        f"(no expectation for mode={expect.mode})",
                        "layer stack")]
    if got != want:
        return [Finding(
            "HLO-BWD-COUNT", ERROR,
            f"{got} backward layer-stack traversals traced, expected "
            f"{want} for mode={expect.mode} execution={expect.execution}",
            "layer stack")]
    return [Finding("HLO-BWD-COUNT", INFO,
                    f"{got} backward traversal(s), as claimed by "
                    f"execution={expect.execution}", "layer stack")]


def rule_donation(step: TracedStep, expect: StepExpectation
                  ) -> list[Finding]:
    if expect.donated_leaves is None:
        return []
    kept = [name for name, in_place in step.state if in_place]
    want = expect.donated_leaves
    if len(kept) >= want:
        return [Finding("HLO-DONATION", INFO,
                        f"{len(kept)} state leaves written in place "
                        f"(>= {want} params / opt_state leaves)", "state")]
    missing = [name for name, in_place in step.state if not in_place][:8]
    return [Finding(
        "HLO-DONATION", ERROR,
        f"only {len(kept)}/{want} state leaves are written in place; the "
        f"step returned fresh tensors (first missing leaves: {missing})",
        "state")]


def rule_shape_stability(step: TracedStep, expect: StepExpectation
                         ) -> list[Finding]:
    dyn = step.totals.dynamic_shapes
    if not dyn:
        return [Finding("HLO-SHAPE-STABLE", INFO,
                        "no data-dependent shapes", "step")]
    return [Finding("HLO-SHAPE-STABLE", ERROR,
                    f"data-dependent output shape of {op} on {shapes}", op)
            for op, shapes in dyn[:8]]


def run_trace_rules(step: TracedStep, expect: StepExpectation, mesh=None
                    ) -> list[Finding]:
    """All trace rules over one traced step (the reference's
    `run_hlo_rules`). INFO findings record the positive evidence; ERROR
    findings are the CI failures."""
    out: list[Finding] = []
    out.extend(rule_collective_leak(step, expect, mesh))
    out.extend(rule_backward_count(step, expect))
    out.extend(rule_donation(step, expect))
    out.extend(rule_shape_stability(step, expect))
    return out
