"""The port's static DP-safety audit (`repro_torch.launch.audit`,
`repro_torch.analysis.{findings,taint,rules}`) against the JAX package's
(`repro.launch.audit`), on the CPU at `tiny`, one torch thread:

* the matrix's six unsharded configs are green in both packages, over the
  same trainable leaf names (the reference's taint pass alone,
  `jaxpr_only=True`; the port's both passes);
* each seeded violation gives the same one-rule ERROR set in both
  packages: `double_noise` says "2 noise draws" in both, `reuse_key`
  names the same leaves, `drop_clip` / `drop_noise` flag the same leaves;
* one reference compile of ghost_flat twopass counts 2 backward passes,
  as the port's trace does, and the execution lie (bk claimed) trips only
  HLO-BWD-COUNT in the port;
* the sharded half over the fake 2x4 group, held to the paper's Sec. 4
  contract from the mesh's collective log;
* the reference's hermetic collective-leak cases (`tests/test_audit.py`)
  over a synthetic mesh log, finding for finding against the reference's
  rule on its synthetic HLO;
* the taint walk's rules op by op, the draws of a leaf drawn slice by
  slice, the data-dependent shapes, the dry run's `--audit`;
* the rule catalog and the mutations are the reference's, the findings
  helpers behave as its, and the CLI defaults to `cuda` and raises
  without it.
"""
import dataclasses

import jax
import pytest
import torch

from repro.analysis import findings as jfindings
from repro.analysis import rules as jrules
from repro.analysis.hlo import backward_passes as jax_backward_passes
from repro.analysis.jaxpr_taint import _leaf_name as jax_leaf_name
from repro.launch import audit as ref_audit
from repro_torch.analysis import graph, rules, taint
from repro_torch.analysis.findings import (ERROR, INFO, SEVERITIES, WARNING,
                                           Finding, errors, worst_severity)
from repro_torch.core import scopes
from repro_torch.launch import audit, dryrun
from repro_torch.launch.mesh import Collective

UNSHARDED = [c for c in audit.MATRIX if not c[2]]
SHARDED = [c for c in audit.MATRIX if c[2]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the traced steps are many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _error_rules(rec: dict) -> list[str]:
    return sorted({f["rule"] for f in rec["findings"]
                   if f["severity"] == ERROR})


def _error_locations(rec: dict, rule: str) -> set[str]:
    return {f["location"] for f in rec["findings"]
            if f["severity"] == ERROR and f["rule"] == rule}


def _ref_leaves(mode, execution) -> set[str]:
    _, args, _, _ = ref_audit.build_case(mode, execution, False)
    flat, _ = jax.tree_util.tree_flatten_with_path(args[0])
    return {jax_leaf_name(path) for path, _ in flat}


# ---------------------------------------------------------------------------
# Green configs: the unmutated engines pass, over the same leaves.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,execution,sharded", UNSHARDED)
def test_green_configs_match_the_reference(mode, execution, sharded):
    want = ref_audit.audit_config(mode, execution, sharded, jaxpr_only=True)
    got = audit.audit_config(mode, execution, sharded)
    assert want["status"] == "ok", want["findings"]
    assert got["status"] == "ok", got["findings"]
    assert set(got["audited_leaves"]) == _ref_leaves(mode, execution)
    rules_seen = {f["rule"] for f in got["findings"]}
    # the positive evidence is recorded, not silently skipped
    assert {"HLO-BWD-COUNT", "HLO-DONATION",
            "HLO-SHAPE-STABLE"} <= rules_seen


# ---------------------------------------------------------------------------
# The teeth: every seeded violation trips exactly its rule, in both.
# ---------------------------------------------------------------------------


def _mutated(pkg, name):
    donate = name != "strip_donation"
    jaxpr_only = name != "strip_donation"
    with pkg.seeded_violation(name):
        return pkg.audit_config("ghost_flat", "bk", False, donate=donate,
                                jaxpr_only=jaxpr_only)


@pytest.mark.parametrize("name", sorted(audit.MUTATIONS))
def test_mutation_trips_the_reference_rule(name):
    want = _mutated(ref_audit, name)
    got = _mutated(audit, name)
    assert got["status"] == "error"
    assert _error_rules(got) == _error_rules(want) == [audit.MUTATIONS[name]]
    rule = audit.MUTATIONS[name]
    if name in ("drop_clip", "double_noise", "drop_noise"):
        assert _error_locations(got, rule) == _error_locations(want, rule)
    if name == "double_noise":
        for rec in (want, got):
            assert any("2 noise draws" in f["message"]
                       for f in rec["findings"])
    if name == "drop_noise":
        assert all("0 noise draws" in f["message"] for f in got["findings"]
                   if f["severity"] == ERROR)
    if name == "reuse_key":
        for rec in (want, got):
            errs = [f for f in rec["findings"] if f["severity"] == ERROR]
            # each finding names a PAIR of distinct leaves
            assert errs and all(" ~ " in f["location"]
                                and " and " in f["message"] for f in errs)

        def named(rec):
            return {leaf for loc in _error_locations(rec, rule)
                    for leaf in loc.split(" ~ ")}
        assert named(got) == named(want) == _ref_leaves("ghost_flat", "bk")


def test_selftest_and_matrix_through_the_cli(tmp_path):
    out = tmp_path / "audit" / "AUDIT.json"
    code = audit.main(["--selftest", "--matrix", "--device", "cpu",
                       "--out", str(out)])
    assert code == 0
    import json
    report = json.loads(out.read_text())
    assert report["generated_by"] == "repro_torch.launch.audit"
    assert report["engine"] == "plain" and report["num_errors"] == 0
    assert [(c["mode"], c["execution"], c["sharded"])
            for c in report["configs"]] == list(audit.MATRIX)
    assert all(c["status"] == "ok" for c in report["configs"])
    assert set(report["rules"]) == set(jrules.RULES)
    assert report["topology"]["kernel_sources"]
    assert "benchmarks" not in audit.AUDIT_PATH.split("/")[-3:]
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# Backward count: one reference compile; the execution lie.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_twopass_backward():
    step_fn, args, _, expect = ref_audit.build_case("ghost_flat", "twopass",
                                                    False)
    hlo = (jax.jit(step_fn, donate_argnums=(0, 1, 2))
           .lower(*args).compile().as_text())
    return jax_backward_passes(hlo, expect.layer_trip)


def test_backward_count_and_the_execution_lie(ref_twopass_backward):
    with audit.ghost_backend.scoped("plain"):
        case = audit.build_case("ghost_flat", "twopass", False)
        found = audit.trace_case(case)
    traced = found["traced"]
    got = graph.backward_passes(traced.totals.linear_calls,
                                traced.loss_calls, traced.microbatches)
    assert got == ref_twopass_backward == 2
    assert not errors(rules.run_trace_rules(traced, case.expect))
    lied = dataclasses.replace(case.expect, execution="bk")
    errs = errors(rules.run_trace_rules(traced, lied))
    assert [f.rule for f in errs] == ["HLO-BWD-COUNT"]
    assert "2 backward" in errs[0].message


# ---------------------------------------------------------------------------
# The sharded half: the Sec. 4 contract from the collective log.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,execution,sharded", SHARDED)
def test_sharded_half_keeps_the_sec4_contract(mode, execution, sharded):
    d, m = audit._SHARDED_MESH
    with dryrun.fake_mesh({"data": d, "model": m}, "meta") as mesh, \
            audit.ghost_backend.scoped("plain"):
        case = audit.build_case(mode, execution, sharded, mesh=mesh)
        found = audit.trace_case(case)
        norm_rows = graph.filter_model_norm_rows(
            graph.classify_collectives(mesh))
    assert not errors(found["findings"]), found["findings"]
    assert mesh.shape == {"data": 2, "model": 4}
    leak = [f for f in found["findings"] if f.rule == "HLO-COLL-LEAK"]
    if mode == "ghost_flat":
        # exactly the one whitelisted (B_local,) norm all-reduce a microbatch
        assert {r["site"] for r in norm_rows} == {"flat_norm_psum"}
        assert norm_rows[0]["count"] == case.microbatches
        assert [f.severity for f in leak] == [INFO]
        assert "whitelisted" in leak[0].message
    else:  # per-device clipping: no model-axis norm traffic at all
        assert norm_rows == []
        assert [f.message for f in leak] == [
            "zero model-axis norm collectives"]
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# Collective-leak rule, hermetic: a synthetic log against the reference's
# rule on its synthetic HLO (tests/test_audit.py's cases).
# ---------------------------------------------------------------------------


class _LogMesh:
    """Just enough mesh surface for `classify_collectives`: one logged
    all-reduce of (8,) f32 over `axes`."""

    shape = {"data": 2, "model": 4}

    def __init__(self, site, axes):
        self.log = [Collective(site, axes, "float32", 8)]
        self.kinds = ["all-reduce"]


class _StubDev:
    def __init__(self, i):
        self.id = i


class _StubMesh:
    axis_names = ("data", "model")

    def __init__(self):
        import numpy as np
        self.devices = np.array([[_StubDev(d * 4 + m) for m in range(4)]
                                 for d in range(2)], dtype=object)


def _synth_hlo(site: str, groups="{{0,1,2,3},{4,5,6,7}}") -> str:
    return f"""HloModule synth

%add (a: f32[], b: f32[]) -> f32[] {{
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %r = f32[] add(%a, %b)
}}

ENTRY %main (p0: f32[8]) -> f32[8] {{
  %p0 = f32[8] parameter(0)
  ROOT %ar = f32[8] all-reduce(%p0), replica_groups={groups}, to_apply=%add, metadata={{op_name="jit(step_fn)/{site}/all-reduce"}}
}}
"""


LEAK_CASES = [  # (mode, site, axes): as tests/test_audit.py's four cases
    ("per_layer", "per_example_norm_psum", ("model",)),
    ("ghost_flat", "flat_norm_psum", ("model",)),
    ("ghost_flat", "per_example_norm_psum", ("model",)),
    ("per_layer", "per_example_norm_psum", ("data",)),
]


@pytest.mark.parametrize("mode,site,axes", LEAK_CASES)
def test_collective_leak_cases_match_the_reference(mode, site, axes):
    got = rules.rule_collective_leak(
        rules.TracedStep(graph.Totals()),
        rules.StepExpectation(mode=mode, sharded=True), _LogMesh(site, axes))
    groups = ("{{0,1,2,3},{4,5,6,7}}" if axes == ("model",)
              else "{{0,4},{1,5},{2,6},{3,7}}")
    want = jrules.rule_collective_leak(
        _synth_hlo(site, groups),
        jrules.StepExpectation(mode=mode, sharded=True), _StubMesh())
    # the reference locates a leak by its HLO op_name ('<site>/all-reduce')
    assert [(f.rule, f.severity, f.location) for f in got] == [
        (f.rule, f.severity, f.location.split("/")[0]) for f in want]
    if mode == "per_layer" and axes == ("model",):
        assert len(errors(got)) == 1 and "model" in got[0].message
    if mode == "ghost_flat" and site == "flat_norm_psum":
        assert any(f.severity == INFO and "whitelisted" in f.message
                   for f in got)
    if mode == "ghost_flat" and site != "flat_norm_psum":
        assert any(f.severity == WARNING and "flat_norm_psum" in f.message
                   for f in got)
    assert not rules.rule_collective_leak(
        rules.TracedStep(graph.Totals()),
        rules.StepExpectation(mode=mode, sharded=False),
        _LogMesh(site, axes))


# ---------------------------------------------------------------------------
# The taint walk, op by op.
# ---------------------------------------------------------------------------


def _walk(fn, *inputs, raw=()):
    """Taints of fn(*inputs)'s result; `raw`: indices of raw inputs."""
    mode = taint.TaintMode()
    for i in raw:
        mode.write(inputs[i], taint.RAW)
    with mode:
        out = fn(*inputs)
    return mode.read(out)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_taint_walk_absorbs_only_multiplicatively():
    a, f = _meta(4, 3), _meta(4, 1)

    def factor(x):
        with scopes.named_scope(scopes.CLIP_SCOPE):
            return torch.clamp(x * 2.0, max=1.0)

    clipped = _walk(lambda x, n: x * factor(n), a, f, raw=(0, 1))
    assert (clipped.raw, clipped.clipped) == (False, True)
    added = _walk(lambda x, n: x + factor(n), a, f, raw=(0, 1))
    assert added.raw
    bmm = _walk(lambda x, n: torch.einsum("bi,bj->ij", x, x * factor(n)),
                a, f, raw=(0, 1))
    assert not bmm.raw and bmm.clipped
    addmm = _walk(lambda b, x, n: torch.addmm(b, x.T, x * factor(n)),
                  _meta(3, 3), a, f, raw=(0, 1, 2))
    assert addmm.raw  # the additive operand stays raw
    assert not _walk(lambda x: x * 3.0, a).raw


def test_taint_walk_routes_indices():
    ids = _meta(6, dtype=torch.long)
    table, rows = _meta(5, 3), _meta(6, 3)

    def factor(x):
        with scopes.named_scope(scopes.CLIP_SCOPE):
            return x * 1.0

    # a gather of clean weights by raw ids is batch data
    assert _walk(lambda t, i: t[i], table, ids, raw=(1,)).raw
    # clipped rows scattered or selected by raw ids stay clipped
    scatter = _walk(lambda r, i, n: torch.zeros(5, 3, device="meta")
                    .index_add_(0, i, r * factor(n)), rows, ids, rows,
                    raw=(0, 1, 2))
    assert not scatter.raw and scatter.clipped
    from repro_torch.core.ghost import segment_sum
    seg = _walk(lambda r, i, n: segment_sum(r * factor(n), i, 5), rows, ids,
                rows, raw=(0, 1, 2))
    assert not seg.raw and seg.clipped
    where = _walk(lambda r, i: torch.where(i[:, None] > 0, r, 0.0), rows,
                  ids, raw=(1,))
    assert where.raw  # a raw condition over clean values is raw


def test_a_leaf_drawn_slice_by_slice_is_one_draw(monkeypatch):
    from repro_torch.optim import optimizers
    monkeypatch.setattr(optimizers, "_SLICE_ELEMS", 64)
    with audit.ghost_backend.scoped("plain"):
        case = audit.build_case("ghost_flat", "bk", False)
        res = taint.trace_step(case.step_fn, case.args)
    assert res.findings == []
    by_leaf = {}
    for site in res.draws.values():
        by_leaf.setdefault(site.leaf, []).append(site.rows)
    assert set(by_leaf) == set(res.leaves)
    assert max(len(r) for r in by_leaf.values()) > 1  # sliced leaves
    with audit.ghost_backend.scoped("plain"):
        case = audit.build_case("ghost_flat", "bk", False)
        assert taint.audit_train_step(case.step_fn, case.args) == []


def test_data_dependent_shapes_are_recorded_before_they_run():
    x = _meta(8)
    with pytest.raises(Exception) as info:
        graph.analyze_step(lambda t: torch.nonzero(t), x)
    dyn = info.value.partial_totals.dynamic_shapes
    assert [op for op, _ in dyn] == ["nonzero.default"]
    fs = rules.rule_shape_stability(
        rules.TracedStep(info.value.partial_totals),
        rules.StepExpectation(mode="per_layer"))
    assert [(f.rule, f.severity, f.location) for f in fs] == [
        ("HLO-SHAPE-STABLE", ERROR, "nonzero.default")]
    totals, _ = graph.analyze_step(
        lambda t: (t.repeat_interleave(2), t[torch.zeros(8, dtype=torch.long,
                                                         device="meta")]), x)
    assert totals.dynamic_shapes == []
    assert graph.dynamic_shape(torch.ops.aten.index.Tensor,
                               (x, [_meta(8, dtype=torch.bool)]))


def test_a_data_dependent_shape_in_the_step_is_a_finding(monkeypatch):
    from repro_torch.core import dp_sgd
    counts = dp_sgd.clip_counts
    monkeypatch.setattr(dp_sgd, "clip_counts", lambda n, t: counts(
        n, t) + torch.nonzero(n).shape[0])
    rec = audit.audit_config("per_layer", "bk", False)
    assert _error_rules(rec) == ["HLO-SHAPE-STABLE"]
    assert [f["location"] for f in rec["findings"]
            if f["severity"] == ERROR] == ["nonzero.default"]
    assert any(f["severity"] == WARNING for f in rec["findings"])


def test_dryrun_audit_runs_the_trace_rules(tmp_path):
    r = dryrun.run_one("tiny", "train_4k", "debug", debug=True, save=False,
                       device="cpu", sharded=True, audit=True,
                       clipping="ghost_flat")
    assert r["status"] == "ok", r.get("traceback")
    assert r["audit"]["num_errors"] == 0
    assert {f["rule"] for f in r["audit"]["findings"]} == {
        "HLO-COLL-LEAK", "HLO-BWD-COUNT", "HLO-SHAPE-STABLE"}
    # the state the step writes in place, params and opt_state alone
    mem = r["memory"]
    assert 0 < mem["alias_bytes"] <= mem["output_bytes"]
    plain = dryrun.run_one("tiny", "train_4k", "debug", debug=True,
                           save=False, device="cpu")
    assert plain["audit"] is None
    code = dryrun.main(["--arch", "tiny", "--shape", "train_4k", "--mesh",
                        "debug", "--device", "cpu", "--out",
                        str(tmp_path), "--audit", "--sharded"])
    assert code == 0


# ---------------------------------------------------------------------------
# Catalog, mutations, findings helpers, the device default.
# ---------------------------------------------------------------------------


def test_rule_catalog_and_mutations_are_the_references():
    assert {k: sev for k, (sev, _) in rules.RULES.items()} == {
        k: sev for k, (sev, _) in jrules.RULES.items()}
    for rid, (_, invariant) in rules.RULES.items():
        # the reference's text, less a trailing note on its bug history
        assert jrules.RULES[rid][1].startswith(invariant), rid
    assert set(rules.RULES) == {
        "JAXPR-CLIP-PATH", "JAXPR-NOISE-ONCE", "JAXPR-KEY-LINEAGE",
        "HLO-COLL-LEAK", "HLO-BWD-COUNT", "HLO-DONATION",
        "HLO-SHAPE-STABLE"}
    for rid, (sev, invariant) in rules.RULES.items():
        assert sev in SEVERITIES and invariant
    assert audit.MUTATIONS == ref_audit.MUTATIONS
    assert audit.MATRIX == ref_audit.MATRIX
    assert audit._SHARDED_MESH == ref_audit._SHARDED_MESH
    for case in (dict(mode="ghost_flat", execution="twopass"),
                 dict(mode="per_layer"), dict(mode="naive_flat")):
        assert rules._expected_backward(rules.StepExpectation(**case)) == \
            jrules._expected_backward(jrules.StepExpectation(**case))


def test_findings_helpers_behave_as_the_references():
    for mod in (jfindings, None):
        F = Finding if mod is None else mod.Finding
        f1 = F("HLO-BWD-COUNT", INFO, "fine")
        f2 = F("HLO-DONATION", ERROR, "bad", "entry")
        errs = errors if mod is None else mod.errors
        worst = worst_severity if mod is None else mod.worst_severity
        assert errs([f1, f2]) == [f2]
        assert worst([f1]) == INFO and worst([f1, f2]) == ERROR
        assert worst([]) is None
        assert f2.to_dict() == {"rule": "HLO-DONATION", "severity": ERROR,
                                "message": "bad", "location": "entry"}
        assert str(f2) == "[ERROR] HLO-DONATION @ entry: bad"
        with pytest.raises(ValueError):
            F("X", "FATAL", "no")
    assert SEVERITIES == jfindings.SEVERITIES


def test_cli_defaults_to_cuda_and_raises_without_it():
    assert audit.build_audit_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        audit.main(["--mode", "per_layer"])
