"""Rank workers for the sharded execution's tests, run by
`repro_torch.launch.mesh.spawn` with this directory in `extra_paths` (a
spawned rank imports its function by name). The module imports no JAX,
so a rank starts quickly.

Each worker joins the process group that `spawn` set up, builds its mesh,
runs one part of the sharded path on its rank and returns plain data
(numpy arrays, lists, strings): the clip drivers case by case
(`clip_cases`), full steps (`train_steps`), DP-LoRA's clip cases and
steps (`lora_mesh`), the quantile update with `counts_axes`
(`quantile_update`), a checkpoint and resume through the train CLI's
`Trainer` (`checkpoint_resume`), the train CLI itself (`train_cli`), the
service (`service_cli`, `service_runs`) and Algorithm 2's pipeline
(`pipeline_grads`, on the CPU or a card). The tests hold the results
against the reference's single-device drivers, and every rank against
the others.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import os

import numpy as np
import torch

from repro_torch import bridge, optim
from repro_torch.checkpoint import load_manifest, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import dp_sgd
from repro_torch.core import pipeline as PL
from repro_torch.core import quantile as Q
from repro_torch.core.clipping import dp_clipped_gradients
from repro_torch.core.clipping import sharded_clipped_gradients as scg
from repro_torch.core.spec import P, GroupLayout, tree_leaves
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train
from repro_torch.launch.sharding import (gather_tree, group_shard_assignment,
                                         params_shardings, replicated,
                                         shard_tree)
from repro_torch.models.transformer import build_model

HERE = os.path.dirname(os.path.abspath(__file__))


def spawn(name: str, world: int, **kw) -> list:
    """`mesh.spawn` of this module's worker `name` on `world` ranks."""
    return mesh_lib.spawn(f"torch_mesh_workers:{name}", world,
                          extra_paths=(HERE,), **kw)


def to_numpy(tree):
    """A tree of tensors as float32 (or integer) numpy arrays by path."""
    out = {}
    for path, t in tree_leaves(tree):
        t = t.detach().cpu()
        out["/".join(path)] = (t.float() if t.is_floating_point()
                               else t).numpy()
    return out


def collectives(mesh) -> dict:
    """The rank's collective log and trace, as plain data."""
    return {"log": [tuple(c) for c in mesh.log], "trace": list(mesh.trace)}


def _model(arch, reduced, device, lora_rank=0):
    cfg = get_config(arch, reduced=reduced)
    if lora_rank:
        cfg = dataclasses.replace(cfg, lora_rank=lora_rank)
    return build_model(cfg, device=device)


def _local(batch, mesh, batch_size):
    """This rank's data shard of a global numpy batch, as tensors."""
    d_size = mesh.axis_size(mesh_lib.data_axes(mesh))
    b_local = batch_size // d_size
    lo = mesh.data_index() * b_local
    return {k: torch.from_numpy(np.asarray(v)[lo: lo + b_local]).to(
        mesh.device) for k, v in batch.items()}, b_local, d_size


def clip_cases(arch: str, reduced: bool, tree: dict, batch: dict,
               mesh_shape: dict, cases: dict) -> dict:
    """`sharded_clipped_gradients` for each case (`_clip_cases_on`); the
    mesh's coordinates and groups; and each parameter leaf's placement
    with a shard / gather round trip."""
    mesh = mesh_lib.make_debug_mesh(**mesh_shape)
    model = _model(arch, reduced, mesh.device)
    params = bridge.train_params_from_numpy(tree, mesh.device)
    out = {"coords": dict(mesh.coords), "data_index": mesh.data_index(),
           "groups": {",".join(k): v[1] for k, v in mesh._groups.items()},
           **_clip_cases_on(mesh, model, params, batch, cases)}
    placements = params_shardings(model.spec, mesh)
    mesh.reset_log()
    back = gather_tree(shard_tree(params, placements), placements)
    out["placements"] = {"/".join(p): pl.spec
                         for p, pl in _placement_leaves(placements)}
    out["round_trip"] = all(
        torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(params),
                                                    tree_leaves(back)))
    out["replicated"] = [pl.spec for _, pl in _placement_leaves(
        replicated(params, mesh))]
    out["gather_log"] = collectives(mesh)
    return out


def _clip_cases_on(mesh, model, params, batch: dict, cases: dict, *,
                   by_shard: bool = False) -> dict:
    """`sharded_clipped_gradients` for each case (name -> (mode,
    execution, kwargs with numpy thresholds)), on the rank's batch shard,
    training `model.trainable_key` (every leaf, or DP-LoRA's adapters):
    grads (global), norms² (local), counts, loss and the collective log
    of each, and on rank 0 the single-device driver's grads on the whole
    batch, or with `by_shard` summed over the data shards' batches (an
    MoE's capacity couples the examples a forward dispatches)."""
    bsz = next(iter(batch.values())).shape[0]
    local, b_local, d_size = _local(batch, mesh, bsz)
    assign = torch.as_tensor(group_shard_assignment(
        model.layout, mesh.shape["model"]), device=mesh.device)
    step = b_local if by_shard else bsz
    wholes = [{k: torch.from_numpy(np.asarray(v)[lo: lo + step]).to(
        mesh.device) for k, v in batch.items()}
        for lo in range(0, bsz, step)]
    out = {}
    for name, (mode, execution, kw) in cases.items():
        mesh.reset_log()
        kw = {k: (torch.as_tensor(v, device=mesh.device)
                  if isinstance(v, np.ndarray) else v)
              for k, v in kw.items()}
        res = scg(model.loss_fn, params, local, model.layout, mode=mode,
                  batch_size=b_local, data_size=d_size, mesh=mesh,
                  shard_assignment=assign, execution=execution,
                  trainable_key=model.trainable_key, **kw)
        out[name] = {"grads": to_numpy(res.grads),
                     "norms": res.norms_sq.detach().cpu().numpy(),
                     "counts": res.counts.detach().cpu().numpy(),
                     "loss": float(res.loss), **collectives(mesh)}
        if mesh.rank == 0:  # the port's single-device driver on the batch
            if mode == "per_group":
                kw["group_assignment"] = assign
            total: dict = {}
            for part in wholes:
                one = dp_clipped_gradients(
                    model.loss_fn, params, part, model.layout, mode=mode,
                    batch_size=step, execution=execution,
                    trainable_key=model.trainable_key, **kw)
                for k, g in to_numpy(one.grads).items():
                    total[k] = total.get(k, 0) + g
            out[name]["single_device"] = total
    return out


def _placement_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _placement_leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@contextlib.contextmanager
def substituted_draws(cur: dict):
    """Noise and count-noise draws from `cur["z"]` (path -> array) and
    `cur["zq"]`, in place of the port's generators (the reference's
    draws, handed in by a test)."""
    real_sn, real_cn = dp_sgd.standard_normal, Q.count_noise
    dp_sgd.standard_normal = (lambda path, shape, rows, gen: torch.from_numpy(
        np.ascontiguousarray(cur["z"][path][rows])).to(gen.device))
    Q.count_noise = (lambda shape, gen: torch.from_numpy(
        np.asarray(cur["zq"], np.float32)).to(gen.device))
    try:
        yield
    finally:
        dp_sgd.standard_normal, Q.count_noise = real_sn, real_cn


def _optimizer(spec):
    name, kw = spec
    return getattr(optim, name)(**kw)


def train_cases(arch: str, reduced: bool, tree: dict, batches: list,
                mesh_shape: dict, cases: dict, **kw) -> dict:
    """`train_steps` for each case (name -> (dp_kw, draws)) on one mesh."""
    mesh = mesh_lib.make_debug_mesh(**mesh_shape)
    return {name: train_steps(arch, reduced, tree, batches, mesh, dp_kw,
                              draws=draws, **kw)
            for name, (dp_kw, draws) in cases.items()}


def train_steps(arch: str, reduced: bool, tree: dict, batches: list,
                mesh, dp_kw: dict, *, batch_size: int,
                optimizer=("sgd", {"lr": 0.05, "momentum": 0.9}),
                draws: list | None = None, seed: int = 0,
                lora_rank: int = 0) -> dict:
    """`make_dp_train_step(mesh=mesh)` (mesh None: the single-device
    step, on the CPU) for len(batches) steps from the numpy parameters
    `tree`, training the adapters alone under `lora_rank`: the
    parameters, thresholds, metrics, optimizer state, each step's
    collective log and the counts its `on_clip` hook saw. `draws[s]` =
    (z, zq): the reference's noise for step s, substituted for the
    port's."""
    dev = "cpu" if mesh is None else mesh.device
    model = _model(arch, reduced, dev, lora_rank)
    dpc = dp_sgd.DPConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in dp_kw.items()})
    hooked = []  # the on_clip hook's counts, a step
    init_fn, step_fn, plan = dp_sgd.make_dp_train_step(
        model.loss_fn, model.dp_spec, model.layout, _optimizer(optimizer),
        dpc, batch_size=batch_size, mesh=mesh,
        trainable_key=model.trainable_key,
        on_clip=lambda res, counts: hooked.append(counts.cpu().numpy()))
    params = bridge.train_params_from_numpy(tree, dev)
    opt_state, dp_state = init_fn(params)
    cur: dict = {}
    mets, logs = [], []
    ctx = substituted_draws(cur) if draws else contextlib.nullcontext()
    with ctx:
        for s, b in enumerate(batches):
            if draws:
                cur["z"], cur["zq"] = draws[s]
            if mesh is not None:
                mesh.reset_log()
            batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
                     for k, v in b.items()}
            params, opt_state, dp_state, met = step_fn(
                params, opt_state, dp_state, batch, seed)
            mets.append([float(x) for x in met])
            if mesh is not None:
                logs.append(collectives(mesh))
    opt = {f: to_numpy(getattr(opt_state, f)) for f in opt_state._fields
           if isinstance(getattr(opt_state, f), dict)}
    return {"params": to_numpy(params), "opt": opt,
            "thresholds": dp_state.qstate.thresholds.cpu().numpy(),
            "step": dp_state.step, "metrics": mets, "logs": logs,
            "num_noise_groups": plan.num_noise_groups, "hooked": hooked,
            "sigma_new": plan.sigma_new}


def quantile_update(norms: np.ndarray, thresholds: np.ndarray,
                    batch_size: int, mesh_shape: dict, zq: np.ndarray,
                    sigma_b: float) -> dict:
    """One geometric update from this rank's columns of the global (K, B)
    norms², its counts all-reduced by `update_thresholds(counts_axes=)`,
    with the count noise `zq` substituted."""
    mesh = mesh_lib.make_debug_mesh(**mesh_shape)
    d_size = mesh.axis_size(mesh_lib.data_axes(mesh))
    b_local = batch_size // d_size
    lo = mesh.data_index() * b_local
    state = Q.init_quantile_state(thresholds, sigma_b=sigma_b)
    local = torch.from_numpy(norms[:, lo: lo + b_local])
    with substituted_draws({"zq": zq}):
        new = Q.update_thresholds(state, Q.clip_counts(
            local, state.thresholds), batch_size, torch.Generator(),
            counts_axes=mesh_lib.data_axes(mesh), mesh=mesh)
    return {"thresholds": new.thresholds.numpy(), **collectives(mesh)}


def refusals(arch: str, mesh_shape: dict) -> dict:
    """The sharded factory's and drivers' refusals: name -> message."""
    mesh = mesh_lib.make_debug_mesh(**mesh_shape)
    model = _model(arch, False, mesh.device)
    out = {}

    def catch(name, fn):
        try:
            fn()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"

    def build(**kw):
        dp_sgd.make_dp_train_step(
            model.loss_fn, model.spec, model.layout, optim.sgd(0.1),
            dp_sgd.DPConfig(sigma=1.0, **kw), batch_size=8, mesh=mesh)

    wrong = [0] * model.layout.num_groups
    catch("foreign_assignment", lambda: build(
        mode="per_group", group_assignment=tuple(wrong),
        num_supergroups=mesh.shape["model"]))
    catch("naive_flat", lambda: build(mode="naive_flat"))
    catch("microbatches", lambda: build(mode="per_layer", microbatches=3))
    catch("data_plane", lambda: dp_sgd.make_dp_train_step(
        model.loss_fn, model.spec, model.layout, optim.sgd(0.1),
        dp_sgd.DPConfig(sigma=1.0), batch_size=7, mesh=mesh))
    kw = dict(batch_size=2, data_size=2, mesh=mesh)
    catch("per_layer_thresholds", lambda: scg(
        model.loss_fn, {"x": torch.zeros(1)}, {}, model.layout,
        mode="per_layer", **kw))
    catch("shard_assignment", lambda: scg(
        model.loss_fn, {"x": torch.zeros(1)}, {}, model.layout,
        mode="ghost_flat", **kw))
    catch("group_thresholds", lambda: scg(
        model.loss_fn, {"x": torch.zeros(1)}, {}, model.layout,
        mode="per_group", shard_assignment=torch.zeros(1), **kw))
    catch("production_mesh", mesh_lib.make_production_mesh)
    catch("naive_flat_driver", lambda: scg(
        model.loss_fn, {"x": torch.zeros(1)}, {}, model.layout,
        mode="naive_flat", **kw))
    return out


def checkpoint_resume(argv: list, directory: str) -> dict:
    """The train CLI's `--mesh` resume path through its `Trainer`: two
    steps, a checkpoint of the gathered state (rank 0 writes it), a third
    step; then a new Trainer with `--resume` restores each rank's slices
    and runs the third step again. Returns both third steps' global
    parameters, optimizer and DP states and step lines, the restored
    slices' shapes against the placements', and the checkpoint's leaf
    shapes."""
    args = train.build_train_parser().parse_args(argv + [
        "--checkpoint-dir", directory])
    mesh = train.setup_mesh(args)
    first = train.Trainer(args, mesh=mesh)
    lines = [train.step_line(i, first.step()) for i in range(2)]
    state = first.state()
    if first.is_main:
        save_checkpoint(directory, 2, state,
                        meta={"sampler": first.sampler.state()})
    mesh.barrier()
    del state
    lines.append(train.step_line(2, first.step()))
    want = {"params": to_numpy(first.global_params()),
            "opt": to_numpy(first.opt_state.mu), "lines": lines}
    args.resume = True
    again = train.Trainer(args, mesh=mesh)
    local_shapes = {"/".join(p): tuple(t.shape)
                    for p, t in tree_leaves(again.params)}
    placed = {"/".join(p): tuple(pl.shard(torch.empty(
        tuple(node), device="meta")).shape)
        for (p, pl), node in zip(_placement_leaves(again.placements),
                                 _spec_shapes(again.model.spec))}
    line = train.step_line(2, again.step())
    got = {"params": to_numpy(again.global_params()),
           "opt": to_numpy(again.opt_state.mu), "line": line,
           "start_step": again.start_step}
    manifest = load_manifest(directory, 2)
    return {"want": want, "got": got, "local_shapes": local_shapes,
            "placed_shapes": placed,
            "file_shapes": [tuple(m["shape"]) for m in manifest["leaves"]]}


def _spec_shapes(spec):
    if isinstance(spec, P):
        yield spec.shape
        return
    for v in spec.values():
        yield from _spec_shapes(v)


def train_cli(argv: list) -> str:
    """What `python -m repro_torch.launch.train ARGV` prints on this
    rank."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(argv)
    return buf.getvalue()


def lora_mesh(clips: list, step: dict, single_dp_kw: dict,
              mesh_shape: dict) -> dict:
    """DP-LoRA on one mesh: for each (name, arch, reduced, lora_rank,
    tree, batch, cases) of `clips`, the sharded clip cases
    (`_clip_cases_on`, the adapters trained; an MoE config's oracle by
    data shard); then the noised steps of
    `step` (`train_steps`' keywords) on the mesh and, on rank 0, the
    single-device step with the same draws under `single_dp_kw`
    ("step_single")."""
    mesh = mesh_lib.make_debug_mesh(**mesh_shape)
    out = {}
    for name, arch, reduced, rank, tree, batch, cases in clips:
        model = _model(arch, reduced, mesh.device, rank)
        params = bridge.train_params_from_numpy(tree, mesh.device)
        out[name] = _clip_cases_on(mesh, model, params, batch, cases,
                                   by_shard=bool(model.cfg.num_experts))
    out["step"] = train_steps(mesh=mesh, **step)
    if mesh.rank == 0:
        out["step_single"] = train_steps(mesh=None, **dict(
            step, dp_kw=single_dp_kw))
    return out


def service_runs(runs: list) -> list:
    """Service incarnations (`launch.service`) on one mesh and one
    runtime, as `service.run` builds them: per argv of `runs`, the
    restored step, the status, this rank's global parameter crcs (the
    adapters' apart) and the checkpoint writes it made, (directory name,
    step) each. `--fault-at` ends the launch (exit 86 on rank 0)."""
    from repro_torch.checkpoint.store import tree_crcs
    from repro_torch.launch import service
    mesh = runtime = None
    writes: list = []
    real = service.save_checkpoint

    def counting(directory, step, tree, **kw):
        writes.append((os.path.basename(directory), step))
        return real(directory, step, tree, **kw)

    service.save_checkpoint = counting
    out = []
    try:
        for argv in runs:
            args = service.build_service_parser().parse_args(argv)
            if mesh is None:
                mesh = train.setup_mesh(args)
                runtime = service.build_runtime(args, mesh=mesh)
            writes.clear()
            svc = service.TrainService(args, runtime=runtime)
            start = svc.committed
            with contextlib.redirect_stdout(io.StringIO()):
                status = svc.run()
            params = svc.global_params()
            out.append({"start": start, "status": status,
                        "crcs": tree_crcs(params),
                        "lora_crcs": tree_crcs({"lora": params["lora"]}),
                        "writes": list(writes)})
    finally:
        service.save_checkpoint = real
    return out


def pipeline_grads(cfg_kw: dict, tree: dict, x: np.ndarray, y: np.ndarray,
                   assign: np.ndarray, group_thresholds: np.ndarray) -> dict:
    """Algorithm 2 on S ranks (the `pod` axis): the pipelined loss with
    +inf thresholds, its parameter gradients, and the per_group driver
    (twopass) over it with the stages as supergroups; this rank's
    results and collective log. On a card under gloo the sends and
    receives are staged through the host; "drained" says every send was
    waited."""
    cfg = PL.PipelineConfig(**cfg_kw)
    mesh = mesh_lib.make_debug_mesh(1, 1, pod=cfg.n_stages)
    spec = PL.pipeline_spec(cfg)
    layout = GroupLayout(spec)
    loss_fn = PL.make_pipeline_loss(cfg, mesh)
    dev = mesh.device
    params = bridge.train_params_from_numpy(tree, dev)
    batch = (torch.from_numpy(x).to(dev), torch.from_numpy(y).long().to(dev))
    bsz = x.shape[0]
    inf = layout.pack_value(float("inf"), bsz, device=dev)
    losses = loss_fn(params, batch, inf)
    leaves = [t for _, t in tree_leaves(params)]
    grads = torch.autograd.grad(losses.sum(), leaves, allow_unused=True)
    loss_fn.drain()
    grads = {"/".join(p): (torch.zeros_like(t) if g is None else g).cpu()
             .numpy() for (p, t), g in zip(tree_leaves(params), grads)}
    fwd_log = collectives(mesh)
    drained = mesh.sends_drained()
    mesh.reset_log()
    res = dp_clipped_gradients(
        loss_fn, params, batch, layout, mode="per_group", batch_size=bsz,
        execution="twopass", group_assignment=torch.from_numpy(assign).to(
            dev), group_thresholds=torch.from_numpy(group_thresholds).to(dev))
    loss_fn.drain()
    clip_log = collectives(mesh)
    drained = drained and mesh.sends_drained()
    return {"stage": mesh.axis_index("pod"), "device": str(dev),
            "losses": losses.detach().cpu().numpy(), "grads": grads,
            "clip_grads": to_numpy(res.grads),
            "clip_norms": res.norms_sq.cpu().numpy(), "log": fwd_log,
            "clip_log": clip_log,
            "drained": drained}
