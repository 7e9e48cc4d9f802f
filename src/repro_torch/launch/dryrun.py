"""Multi-pod dry run: the counterpart of `repro.launch.dryrun`.

For each (arch x shape x mesh) combination this driver builds the port's
REAL step (the full adaptive per-layer DP-SGD train step: clipping,
quantile update, noise, optimizer; or the one-token serve step, or the
prefill) and runs it once, eagerly, on shape-only inputs: meta tensors,
so nothing is allocated and a 671 B-parameter model costs no memory. A
train step is rank 0's part of the port's one mesh step
(`core.dp_sgd._make_sharded_step`, the weights gathered from their model
shards at entry and sliced back at exit, as the train CLI's `Trainer`
runs it) on the reference's production mesh, (data 16, model 16) or (pod
2, data 16, model 16), or the debug 2x2, over a fake process group of
that world (`backend="fake"`): no other rank exists.
`analysis.graph.analyze_step` reads the step as it runs:

  * memory: per-device argument and output bytes from the dry run's
    placements (`launch.sharding`; exact arithmetic), the donated
    state's bytes (alias), and `peak_bytes`, the traced step's peak of
    live bytes, rounded as `--device`'s allocator rounds (the port's
    stand-in for XLA's temp bytes);
  * flops (FlopCounterMode's formulas, matmul-like ops only) and bytes
    (every aten op's operands and results: an unfused upper bound);
  * collective bytes by kind, from the mesh's collective log;
  * the backward passes of a train step, counted (`backward_passes`),
    and the ghost-op engine's calls per op, with the kernel launches the
    `kernels` engine would make for them.

The trace pins the `plain` engine, as the reference pins `backend="xla"`:
a hand-written kernel cannot run on shape-only tensors. The random draws
are shape-only too (`shape_only_draws`). There is no compile:
`compile_s`, `xla_cost_analysis` and `hlo_bytes` are None, and `trace_s`
(the traced run) stands beside `lower_s` (building the step and its
inputs). A serve step is the port's one-device step over the whole batch
(the port has no sharded serving), so its collectives are empty.

Meta tensors, not `FakeTensorMode`: the step's code has no device branch
outside the kernels, and a fake tensor's every op runs through Python,
which made a full-depth trace several times slower.

Results go to `--out` (default `<repo>/.cache/dryrun/`), one JSON file a
combination, never under `benchmarks/`.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k \\
      --mesh single
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k \\
      --mesh debug --device cpu
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-existing]

`--device` is the device the step is sized for: cuda (the default; it
raises without a CUDA device) rounds the peak to the caching allocator's
512-byte blocks, cpu does not (the tests pass it). `--audit` runs the
static DP-safety trace rules (`analysis.rules.run_trace_rules`: the
collective leak with `--sharded`, the backward count, shape stability;
not the donation rule, which `launch.audit` checks) on each train
combination's trace, as the reference runs its HLO rules; any ERROR
fails the run. The reference's `--cache` / `--cache-dir` have no
counterpart (the dry run builds nothing).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch import optim
from repro_torch.analysis import graph
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.dp_sgd import DPConfig, make_dp_train_step
from repro_torch.core.spec import abstract_params, tree_leaves
from repro_torch.kernels import _build
from repro_torch.kernels import backend as ghost_backend
from repro_torch.launch import inputs as I
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import (batch_shardings, cache_shardings,
                                         gather_tree, opt_state_shardings,
                                         params_shardings, placed_bytes,
                                         replicated, shard_tree)
from repro_torch.models.config import INPUT_SHAPES, InputShape
from repro_torch.models.transformer import build_model, unstack_blocks

RESULTS_DIR = os.path.join(_build.repo_cache_root(), "dryrun")

# Large archs take the paper's DP-LoRA path for the train shape, as in the
# reference (a frozen base: optimizer state and grads for the adapters only)
LORA_TRAIN_ARCHS = {"deepseek-v3-671b": 32, "qwen2-vl-72b": 32}

# long_500k policy, as the reference's: native sub-quadratic, MLA-latent,
# or the sliding-window variant; pure full-attention archs skip
LONG_OK = {"zamba2-7b": None, "rwkv6-7b": None, "deepseek-v3-671b": None,
           "qwen3-4b": "swa", "minicpm-2b": "swa"}

COLLECTIVES = graph.COLLECTIVES

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16},
          "debug": {"data": 2, "model": 2}}


def _shape_for(shape_name: str, debug: bool) -> InputShape:
    if not debug:
        return INPUT_SHAPES[shape_name]
    kind = INPUT_SHAPES[shape_name].kind
    return InputShape("debug_" + shape_name, 64 if kind == "train" else 128,
                      8, kind)


def check_device(device: str) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (pass --device cpu to trace on the "
                           "CPU)")


@contextlib.contextmanager
def fake_mesh(shape: dict[str, int], device):
    """A `Mesh` of `shape` seen from rank 0 over a fake process group of
    its world (its collectives do nothing and no other rank exists),
    destroyed on exit; a mesh of one rank needs no group."""
    size = math.prod(shape.values())
    if size == 1:
        yield Mesh(shape, device=device, backend="none")
        return
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised: the dry "
                           "run makes its own fake one")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield Mesh(shape, device=device, backend="fake")
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass
class StepTrace:
    """A step and its shape-only inputs.

    fn(*args) runs the step; `accounted` are the arguments the placements
    are read against (the global trees: a train step's `args` hold the
    rank's model shards of the weights), `placements` the dry run's
    placement of each, `donated` the arguments the step updates in place
    and returns first (a train step's params and opt_state: the quantile
    update returns new thresholds, ROADMAP C); `extra(out)` the rest of
    the result (metrics, logits), placed replicated. `alias_bytes` counts
    the leaves of the donated arguments that the result holds in their
    own storage, as the audit's HLO-DONATION rule reads them
    (`launch.audit.written_in_place`)."""

    fn: Callable
    args: tuple
    accounted: tuple
    placements: tuple
    donated: tuple[int, ...]
    extra: Callable[[Any], Any]
    mesh: Any
    microbatches: int | None = None
    loss_calls: list = dataclasses.field(default_factory=lambda: [0])

    def memory(self, out, peak_bytes: int | None) -> dict:
        args = [placed_bytes(a, p)
                for a, p in zip(self.accounted, self.placements)]
        alias = sum(_aliased_bytes(self.accounted[i], self.placements[i],
                                   self.args[i], out[j])
                    for j, i in enumerate(self.donated))
        rest = self.extra(out)
        return {"argument_bytes": sum(args),
                "output_bytes": sum(args[i] for i in self.donated)
                + placed_bytes(rest, replicated(rest, self.mesh)),
                "alias_bytes": alias,
                "peak_bytes": peak_bytes,
                # what the port's step holds on entry: the mesh step keeps
                # the optimizer state and the global batch whole
                "held_argument_bytes": sum(
                    t.numel() * t.element_size()
                    for t in graph.leaf_tensors(self.args))}


def _aliased_bytes(tree, placements, before, after) -> int:
    """`placed_bytes` of the tensor leaves of `tree` whose leaf in the
    step's result `after` is the argument's leaf `before` (one storage):
    what the step wrote in place."""
    if isinstance(tree, dict):
        return sum(_aliased_bytes(tree[k], placements[k], before[k],
                                  after[k]) for k in tree)
    if isinstance(tree, tuple):
        return sum(_aliased_bytes(*x)
                   for x in zip(tree, placements, before, after))
    if not (isinstance(tree, torch.Tensor)
            and isinstance(after, torch.Tensor)):
        return 0
    same = (after.untyped_storage()._cdata
            == before.untyped_storage()._cdata)
    return placed_bytes(tree, placements) if same else 0


@contextlib.contextmanager
def shape_only_draws():
    """The step's random draws made shape-only, on the meta device: the
    noise's and the count release's (`dp_sgd.standard_normal`,
    `quantile.count_noise`, the points a test substitutes the
    reference's draws at) and their generators (`dp_sgd.generator`),
    which the meta device has none of."""
    from repro_torch.core import dp_sgd, quantile

    def draw(shape, *_):
        return torch.empty(tuple(shape), dtype=torch.float32, device="meta")

    saved = (dp_sgd.generator, dp_sgd.standard_normal, quantile.count_noise)
    dp_sgd.generator = lambda device, *parts: None
    dp_sgd.standard_normal = lambda path, shape, rows, gen: draw(shape)
    quantile.count_noise = draw
    try:
        yield
    finally:
        dp_sgd.generator, dp_sgd.standard_normal, quantile.count_noise = \
            saved


def train_config(arch: str, shape_name: str, mesh, *, clipping: str,
                 debug: bool = False, moe_dispatch: str | None = None):
    """(cfg, mode) of a train combination: the reference's variant, LoRA
    rank (outside debug) and per_shard resolution (`dp_blocks` = the
    mesh's model axis, run as per_layer)."""
    variant = LONG_OK.get(arch) if shape_name == "long_500k" else None
    cfg = get_config(arch, reduced=debug, variant=variant)
    lora_rank = LORA_TRAIN_ARCHS.get(arch, 0)
    if lora_rank and not debug:
        cfg = dataclasses.replace(cfg, lora_rank=lora_rank)
    if clipping == "per_shard":
        cfg = dataclasses.replace(cfg, dp_blocks=int(mesh.shape["model"]))
        clipping = "per_layer"
    if moe_dispatch is not None:
        cfg = dataclasses.replace(cfg, moe_dispatch=moe_dispatch)
    return cfg, clipping


def build_train_step(cfg, mesh, *, clipping: str = "per_layer",
                     execution: str = "bk", microbatches: int = 8,
                     batch_size: int, rwkv_formulation: str = "chunked",
                     backend: str = "plain", loss_calls: list | None = None,
                     on_clip=None):
    """(model, init_fn, step_fn) of the dry run's train step on `mesh`:
    the adaptive DP-SGD step (sigma 1, rate 1e-3 over 1,000 steps, C(0) =
    1, adam 1e-4) as rank 0 runs it (`make_dp_train_step(mesh=...)`),
    its engine `backend`. `loss_calls[0]` counts the loss evaluations;
    `on_clip` sees each step's clip result (`make_dp_train_step`)."""
    model = build_model(cfg, rwkv_formulation=rwkv_formulation,
                        device=mesh.device)
    calls = [0] if loss_calls is None else loss_calls

    def loss_fn(params, batch, th):
        calls[0] += 1
        return model.loss_fn(params, batch, th)

    dpc = DPConfig(mode=clipping, sigma=1.0, sampling_rate=1e-3,
                   steps=1000, adaptive=True, init_threshold=1.0,
                   microbatches=microbatches, execution=execution,
                   backend=backend)
    init_fn, step_fn, _ = make_dp_train_step(
        loss_fn, model.dp_spec, model.layout, optim.adam(1e-4), dpc,
        batch_size=batch_size, trainable_key=model.trainable_key,
        mesh=mesh, on_clip=on_clip)
    return model, init_fn, step_fn


def _requires_grad(model, params) -> None:
    key = model.trainable_key
    for _, leaf in tree_leaves(params if key is None else params[key]):
        leaf.requires_grad_()


def build_train_trace(arch: str, shape_name: str, mesh, *,
                      clipping: str = "per_layer", execution: str = "bk",
                      microbatches: int = 8,
                      rwkv_formulation: str = "chunked",
                      debug: bool = False,
                      moe_dispatch: str | None = None,
                      cfg=None, shape: InputShape | None = None):
    """(StepTrace, model, cfg) of the train step (the reference's
    `build_train_lowering`): the inputs are shape-only tensors on the
    mesh's device (meta in the dry run). `cfg` / `shape`
    replace the combination's config and input shape."""
    shape = shape or _shape_for(shape_name, debug)
    if cfg is None:
        cfg, clipping = train_config(arch, shape_name, mesh,
                                     clipping=clipping, debug=debug,
                                     moe_dispatch=moe_dispatch)
    dev = mesh.device
    loss_calls = [0]
    model, init_fn, step_fn = build_train_step(
        cfg, mesh, clipping=clipping, execution=execution,
        microbatches=microbatches, batch_size=shape.global_batch,
        rwkv_formulation=rwkv_formulation, loss_calls=loss_calls)
    params_abs = abstract_params(model.spec, dev)
    _requires_grad(model, params_abs)
    opt_abs, dp_abs = init_fn(params_abs)
    batch_abs = I.train_batch_specs(cfg, shape, dev)
    pshard = params_shardings(model.spec, mesh)
    oshard = opt_state_shardings(
        opt_abs, pshard if model.trainable_key is None
        else pshard[model.trainable_key], mesh)
    dshard = replicated(dp_abs, mesh)
    bshard = batch_shardings(batch_abs, mesh)
    stored = mesh.shape["model"] > 1  # weights stored model-sharded
    params_in = shard_tree(params_abs, pshard) if stored else params_abs

    def step(params, opt_state, dp_state, batch, seed):
        if stored:
            params = gather_tree(params, pshard)
        params, opt_state, dp_state, met = step_fn(
            params, opt_state, dp_state, batch, seed)
        if stored:
            params = shard_tree(params, pshard)
        return params, opt_state, dp_state, met

    trace = StepTrace(
        fn=step, args=(params_in, opt_abs, dp_abs, batch_abs, 0),
        accounted=(params_abs, opt_abs, dp_abs, batch_abs, 0),
        placements=(pshard, oshard, dshard, bshard, None),
        donated=(0, 1), extra=lambda out: tuple(out[2:4]), mesh=mesh,
        microbatches=microbatches, loss_calls=loss_calls)
    return trace, model, cfg


def build_serve_trace(arch: str, shape_name: str, mesh, *,
                      debug: bool = False, cfg=None,
                      shape: InputShape | None = None):
    """(StepTrace, model, cfg) of the serve step (the reference's
    `build_serve_lowering`): `prefill_step` for a prefill shape, else one
    `serve_step` on `abstract_cache`. Weight-FSDP (`serving=True`) only
    where the model axis alone leaves more than 12 GiB of weights a
    device, and only for decode, as the reference decides. The inputs are
    shape-only tensors on the mesh's device (meta in the dry run)."""
    shape = shape or _shape_for(shape_name, debug)
    if cfg is None:
        variant = LONG_OK.get(arch) if shape_name == "long_500k" else None
        cfg = get_config(arch, reduced=debug, variant=variant)
    dev = mesh.device
    model = build_model(cfg, device=dev)
    params_abs = abstract_params(model.spec, dev)
    param_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_leaves(params_abs))
    per_dev = param_bytes / mesh.shape["model"]
    serving_fsdp = per_dev > 12 * 2**30 and shape.kind == "decode"
    pshard = params_shardings(model.spec, mesh, serving=serving_fsdp)
    serve_params = unstack_blocks(params_abs)
    if shape.kind == "prefill":
        batch_abs = I.train_batch_specs(cfg, shape, dev)
        batch_abs.pop("targets")
        trace = StepTrace(
            fn=model.prefill_step, args=(serve_params, batch_abs),
            accounted=(params_abs, batch_abs),
            placements=(pshard, batch_shardings(batch_abs, mesh)),
            donated=(), extra=lambda out: out, mesh=mesh)
        return trace, model, cfg
    cache_abs = model.abstract_cache(shape.global_batch, shape.seq_len)
    batch_abs = I.serve_batch_specs(cfg, shape, dev)

    def serve(params, cache, batch):
        logits, new_cache = model.serve_step(params, cache, batch)
        return new_cache, logits

    trace = StepTrace(
        fn=serve, args=(serve_params, cache_abs, batch_abs),
        accounted=(params_abs, cache_abs, batch_abs),
        placements=(pshard, cache_shardings(cache_abs, mesh),
                    batch_shardings(batch_abs, mesh)),
        donated=(1,), extra=lambda out: out[1], mesh=mesh)
    return trace, model, cfg


def _layer_trip(cfg) -> int:
    """Depth of the model's dominant homogeneous layer run (the reference
    reads its scan's `known_trip_count`)."""
    n = cfg.num_layers
    runs = [n]
    if getattr(cfg, "num_experts", 0) and getattr(cfg, "first_k_dense", 0):
        runs = [cfg.first_k_dense, n - cfg.first_k_dense]
    if getattr(cfg, "encoder_layers", 0):
        runs.append(cfg.encoder_layers)
    return max(r for r in runs)


def analyze(trace: StepTrace, *, kind: str, trip: int,
            sharded: bool = False, device: str = "cuda",
            expect=None) -> dict:
    """Run `trace` once under `analysis.graph.analyze_step` (in the
    `plain` engine and `shape_only_draws`) and read the result's
    analysis keys; `device`: the allocator the peak models. `expect`
    (an `analysis.rules.StepExpectation`): also run the trace rules on a
    train step (the `audit` key, else None)."""
    t0 = time.time()
    totals, out = graph.analyze_step(trace.fn, *trace.args, mesh=trace.mesh,
                                     device=device)
    t_trace = time.time() - t0
    t0 = time.time()
    bw_passes = None
    if kind == "train" and trip >= 2:
        bw_passes = graph.backward_passes(totals.linear_calls,
                                          trace.loss_calls[0],
                                          trace.microbatches)
    audit = None
    if expect is not None and kind == "train":
        from repro_torch.analysis.findings import errors
        from repro_torch.analysis.rules import TracedStep, run_trace_rules
        fs = run_trace_rules(
            TracedStep(totals, loss_calls=trace.loss_calls[0],
                       microbatches=trace.microbatches),
            expect, trace.mesh if sharded else None)
        audit = {"findings": [f.to_dict() for f in fs],
                 "num_errors": len(errors(fs))}
    axis_coll = None
    if sharded and kind == "train":
        rows = graph.classify_collectives(trace.mesh)
        axis_coll = {
            "by_axis": graph.summarize_axis_rows(rows),
            "model_axis_norm_count": sum(
                r["count"] for r in graph.filter_model_norm_rows(rows))}
    return {
        "backward_passes": bw_passes,
        "collectives_by_axis": axis_coll,
        "audit": audit,
        "trace_s": round(t_trace, 2),
        "analyze_s": round(time.time() - t0, 2),
        "memory": trace.memory(out, totals.peak_bytes),
        "flops": totals.flops,
        "bytes_accessed": totals.bytes,
        "bytes_kind": graph.BYTES_KIND,
        "transcendentals": totals.transcendentals,
        "collectives": totals.collectives,
        "op_calls": totals.op_calls,
        "kernel_launches": graph.kernel_launches(totals.op_calls),
        "linear_calls": totals.linear_calls,
        "loss_calls": trace.loss_calls[0] if kind == "train" else None,
    }


def _suffix(clipping: str, execution: str, sharded: bool, tag: str = ""
            ) -> str:
    suffix = "" if clipping == "per_layer" else f"__{clipping}"
    if execution != "bk":
        suffix += f"__{execution}"
    if sharded:
        suffix += "__sharded"
    if tag:
        suffix += f"__{tag}"
    return suffix


def _save(result: dict, out_dir: str, name: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(result, f, indent=1)


def run_one(arch: str, shape_name: str, mesh_kind: str, *,
            clipping: str = "per_layer", execution: str = "bk",
            save: bool = True, rwkv_formulation: str = "chunked",
            microbatches: int | None = None, debug: bool = False,
            moe_dispatch: str | None = None, sharded: bool = False,
            tag: str = "", device: str = "cuda",
            out_dir: str | None = None, audit: bool = False) -> dict:
    """Trace one combination and return its result (status ok, skipped
    or error, as the reference's); with `save`, also write it under
    `out_dir` (default RESULTS_DIR). `audit`: run the trace rules on a
    train step (`analyze(expect=)`; donation is not counted here, as the
    reference's dry run leaves it to `launch.audit`). The fake process
    group, the fake mode and the engine scope end before it returns."""
    check_device(device)
    out_dir = out_dir or RESULTS_DIR
    shape = _shape_for(shape_name, debug)
    if shape_name == "long_500k" and arch not in LONG_OK:
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                  "status": "skipped",
                  "reason": "full-attention arch; long_500k requires "
                            "sub-quadratic attention (DESIGN.md)"}
        if save:
            _save(result, out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
        return result
    kind = shape.kind  # train | prefill | decode
    t0 = time.time()
    try:
        with contextlib.ExitStack() as scope:
            t_mesh = time.time()
            mesh = scope.enter_context(fake_mesh(MESHES[mesh_kind], "meta"))
            t_mesh = time.time() - t_mesh
            scope.enter_context(ghost_backend.scoped("plain"))
            scope.enter_context(shape_only_draws())
            if kind == "train":
                mb = microbatches if microbatches is not None else (
                    2 if debug else 8)
                trace, model, cfg = build_train_trace(
                    arch, shape_name, mesh, clipping=clipping,
                    execution=execution, microbatches=mb,
                    rwkv_formulation=rwkv_formulation, debug=debug,
                    moe_dispatch=moe_dispatch)
            else:
                trace, model, cfg = build_serve_trace(arch, shape_name, mesh,
                                                      debug=debug)
            t_lower = time.time() - t0
            expect = None
            if audit and kind == "train":
                from repro_torch.analysis.rules import StepExpectation
                from repro_torch.core.clipping import base_mode
                expect = StepExpectation(
                    mode=("per_layer" if clipping == "per_shard"
                          else base_mode(clipping)),
                    execution=("twopass" if clipping.endswith("_twopass")
                               else execution),
                    sharded=sharded, layer_trip=_layer_trip(cfg),
                    donated_leaves=None)
            found = analyze(trace, kind=kind, trip=_layer_trip(cfg),
                            sharded=sharded, device=device, expect=expect)
        result = {
            "arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "kind": kind, "clipping": clipping if kind == "train" else None,
            "execution": execution if kind == "train" else None,
            "sharded": sharded if kind == "train" else None,
            "backward_passes": found.pop("backward_passes"),
            "collectives_by_axis": found.pop("collectives_by_axis"),
            "audit": found.pop("audit"),
            "status": "ok",
            "num_params": model.num_params,
            "num_groups": model.layout.num_groups,
            "lower_s": round(t_lower, 2), "compile_s": None,
            "mesh_s": round(t_mesh, 3),
            **found,
            "xla_cost_analysis": None,
            "devices": math.prod(MESHES[mesh_kind].values()),
            "hlo_bytes": None,
            "device": str(torch.device(device)),
        }
    except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                  "kind": kind, "status": "error",
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
    if tag:
        result["tag"] = tag
    if save:
        _save(result, out_dir, f"{arch}__{shape_name}__{mesh_kind}"
              f"{_suffix(clipping, execution, sharded, tag)}.json")
    return result


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both", "debug"],
                    default="single")
    ap.add_argument("--clipping", default="per_layer")
    ap.add_argument("--execution", default="bk", choices=["bk", "twopass"],
                    help="flat/group clipping execution: bk (one backward "
                         "+ the book-keeping epilogue) or twopass")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--sharded", action="store_true",
                    help="add the per-mesh-axis collective breakdown "
                         "(collectives_by_axis) to each train result")
    ap.add_argument("--audit", action="store_true",
                    help="run the static DP-safety trace rules "
                         "(repro_torch.analysis.rules) on each traced "
                         "train step; any ERROR finding fails the run")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device the step is sized for (cuda unless "
                         "asked): its allocator's rounding of the peak")
    ap.add_argument("--out", default=None,
                    help=f"results directory (default {RESULTS_DIR})")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (args.all or args.arch):
        raise SystemExit("give --arch (and --shape) or --all")
    check_device(args.device)
    out_dir = args.out or RESULTS_DIR
    debug = args.mesh == "debug"
    # the reference's sweep: its ARCH_IDS, which have no `tiny`
    archs = [args.arch] if args.arch else [a for a in ARCH_IDS
                                           if a != "tiny"]
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = 0
    for a in archs:
        for s in shapes:
            for mk in meshes:
                fn = os.path.join(out_dir, f"{a}__{s}__{mk}" + _suffix(
                    args.clipping, args.execution, args.sharded) + ".json")
                if args.skip_existing and os.path.exists(fn):
                    with open(fn) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[skip-existing] {a} {s} {mk}: "
                              f"{prev['status']}")
                        continue
                r = run_one(a, s, mk, clipping=args.clipping,
                            execution=args.execution,
                            microbatches=args.microbatches, save=True,
                            debug=debug, sharded=args.sharded,
                            device=args.device, out_dir=out_dir,
                            audit=args.audit)
                if r["status"] == "ok" and (r.get("audit") or {}).get(
                        "num_errors"):
                    failures += 1
                    bad = [f for f in r["audit"]["findings"]
                           if f["severity"] == "ERROR"]
                    print(f"[FAIL] {a:22s} {s:12s} {mk:6s} audit: "
                          + "; ".join(f"{f['rule']}: {f['message']}"
                                      for f in bad), flush=True)
                elif r["status"] == "ok":
                    gb = (r["memory"]["peak_bytes"] or 0) / 2**30
                    print(f"[ok]   {a:22s} {s:12s} {mk:6s} "
                          f"flops={r['flops']:.3e} peak={gb:.2f}GiB "
                          f"coll={r['collectives']['total_bytes']/2**30:.2f}"
                          f"GiB bwd={r['backward_passes']} "
                          f"(lower {r['lower_s']}s trace {r['trace_s']}s)",
                          flush=True)
                elif r["status"] == "skipped":
                    print(f"[skip] {a:22s} {s:12s} {mk:6s} {r['reason']}",
                          flush=True)
                else:
                    failures += 1
                    print(f"[FAIL] {a:22s} {s:12s} {mk:6s} {r['error']}",
                          flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
