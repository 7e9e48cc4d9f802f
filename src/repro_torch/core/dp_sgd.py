"""DP optimization: Algorithm 1 (adaptive group-wise DP-SGD), single device.

The counterpart of the single-device part of `repro.core.dp_sgd`. It wires
together the clipping driver (core.clipping), the private quantile
tracker (core.quantile), noise allocation (core.noise), RDP accounting
with the Prop 3.1 budget split (core.accounting) and a first-order
optimizer (repro_torch.optim). All accounting happens once, in Python
floats, when the step is built (`build_plan`).

Randomness: the step of index s with seed `seed` draws the noise of each
parameter leaf from its own `torch.Generator`, seeded from (seed, s,
stable_hash(leaf path)), after the same static crc32 collision check as
the reference, and the count noise from a generator seeded from
(seed, s). Torch's Philox is not JAX's threefry, so the draws differ from
the reference's; `standard_normal` is the one place they are made, and a
test substitutes the reference's draws there.

Per-shard clipping is `per_layer` over a blocked layout (`ModelConfig
.dp_blocks`). Microbatches (`DPConfig.microbatches`) accumulate the
clipped sums exactly (per-example clipping commutes with the split); the
noise is drawn once per step.

Sharded execution (`make_dp_train_step(mesh=...)`, `_make_sharded_step`)
runs the step on every rank of a `launch.mesh.Mesh`: the batch split over
the data plane, the clipping bookkeeping over the model axis
(`core.clipping.sharded_clipped_gradients`), and the quantile update, the
noise and the optimizer replicated: every rank draws from identically
seeded generators, so every rank ends the step with the same bits.

DP-LoRA (`trainable_key="lora"`): only `params["lora"]` trains. The
noise, the clip counts, the quantile update and the optimizer (its state
covers the adapters only) act on that subtree, and the base stays bit for
bit as it was. Under a mesh the same holds on every rank: the sharded
driver all-reduces the adapters' gradients alone, and every rank ends the
step with the same adapter bits.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import accounting
from repro_torch.core import noise as noise_lib
from repro_torch.core.clipping import (ClipResult, LossFn,
                                       ShardedClipResult, _rebuild,
                                       base_mode, check_mode,
                                       dp_clipped_gradients,
                                       sharded_clipped_gradients,
                                       supergroup_norms)
from repro_torch.core.quantile import (QuantileState, clip_counts,
                                       init_quantile_state,
                                       update_thresholds)
from repro_torch.core.scopes import NOISE_SCOPE, named_scope
from repro_torch.core.spec import (GroupLayout, SpecTree, _walk, stable_hash,
                                   tree_leaves)
from repro_torch.kernels import backend as ghost_backend
from repro_torch.launch.mesh import data_axes
from repro_torch.launch.sharding import group_shard_assignment
from repro_torch.optim.optimizers import slices


@dataclasses.dataclass(frozen=True)
class DPConfig:
    """Configuration of the private learning run (the reference's fields
    that the single-device step reads).

    * `mode` (`--clipping`): `per_layer`, `ghost_flat`, `per_group`,
      `naive_flat`, `non_private`, or `ghost_flat_twopass` /
      `per_group_twopass`.
      `execution` (`--execution`): how the flat and group modes compute
      the clipped sums, `bk` (one backward + the BK epilogue) or
      `twopass`; a `*_twopass` mode name forces twopass. Accounting does
      not depend on it.
    * Privacy budget: `epsilon` (target, calibrated over `steps` steps at
      Poisson `sampling_rate` = B/N and `delta`), or `sigma` directly.
    * Thresholds: `adaptive` tracks the `target_quantile` of per-example
      norms with rate `quantile_lr`, spending `quantile_budget_fraction`
      of the budget on the clip counts (Prop 3.1); `init_threshold` is
      C(0), or the fixed C when not adaptive. `threshold_rescale` is the
      Appendix A.1 global rescale.
    * `noise_strategy`: global | equal_budget | weighted (Sec. 3.3).
    * per_group: `group_assignment` maps each layout group to a
      supergroup; `num_supergroups` pads the count (else max + 1).
    * `backend` (`--backend`): the ghost-op engine, `kernels`, `plain` or
      `auto` (`repro_torch.kernels.backend`), scoped around the step;
      `autotune` (`--autotune`): whether `auto` consults the installed
      autotune table (else its static model).
    * `microbatches` (`--microbatches`): the batch is clipped in this many
      equal parts (Algorithm 2's structure); the clipped sums accumulate
      in f32 and the norms and loss are those of the whole batch, while
      the noise is added once per step.

    The reference's `batch_axes` (its pjit batch layout) has no
    counterpart: under a mesh each rank slices its own data shard.
    """

    mode: str = "per_layer"
    execution: str = "bk"  # bk | twopass, for ghost_flat / per_group
    epsilon: float | None = 8.0
    delta: float = 1e-5
    sampling_rate: float = 0.01  # rho = B / N (Poisson subsampling)
    steps: int = 1000  # T, for accounting
    sigma: float | None = None  # noise multiplier (skips calibration)
    adaptive: bool = True
    init_threshold: float = 1.0
    target_quantile: float = 0.5
    quantile_lr: float = 0.3
    quantile_budget_fraction: float = 0.01
    noise_strategy: str = "global"
    threshold_rescale: float | None = None
    group_assignment: tuple[int, ...] | None = None  # group -> supergroup
    num_supergroups: int | None = None
    backend: str = "kernels"
    autotune: bool = True
    microbatches: int = 1

    @property
    def private(self) -> bool:
        return self.mode != "non_private"


class DPState(NamedTuple):
    qstate: QuantileState  # K adaptive thresholds
    step: int


class StepMetrics(NamedTuple):
    """Device scalars: reading one waits for the step."""

    loss: torch.Tensor
    clip_fraction: torch.Tensor  # mean over groups of the fraction clipped
    mean_threshold: torch.Tensor
    grad_norm: torch.Tensor  # norm of the (noised, averaged) update


@dataclasses.dataclass(frozen=True)
class DPPlan:
    """Everything precomputed at build time (Python floats, accounting)."""

    config: DPConfig
    num_noise_groups: int  # K per_layer, 1 flat, G per_group, 0 non_private
    sigma: float  # total-budget noise multiplier (no quantile split)
    sigma_b: float  # clip-count noise multiplier (0 if not adaptive)
    sigma_new: float  # gradient noise multiplier after the Prop 3.1 split
    group_dims: np.ndarray  # (num_noise_groups,) parameter counts
    sens_mults: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float32))


def build_plan(cfg: DPConfig, layout: GroupLayout) -> DPPlan:
    check_mode(cfg.mode)
    if not cfg.private:
        return DPPlan(cfg, 0, 0.0, 0.0, 0.0, np.zeros(0, np.int64))
    mults = layout.sens_mults
    mode = base_mode(cfg.mode)  # accounting is execution-independent
    if mode in ("ghost_flat", "naive_flat"):
        num_groups = 1
        dims = np.array([int(layout.dims.sum())], np.int64)
        mults = np.ones(1, np.float32)
    elif mode == "per_group":
        if cfg.group_assignment is None:
            raise ValueError("per_group mode requires group_assignment")
        assign = np.asarray(cfg.group_assignment)
        if assign.shape != (layout.num_groups,):
            raise ValueError(
                f"group_assignment must have shape ({layout.num_groups},)")
        num_groups = (cfg.num_supergroups if cfg.num_supergroups
                      else int(assign.max()) + 1)
        if num_groups <= int(assign.max()):
            raise ValueError("num_supergroups smaller than assignment range")
        dims = np.zeros(num_groups, np.int64)
        np.add.at(dims, assign, layout.dims)
        mults = np.ones(num_groups, np.float32)
        np.maximum.at(mults, assign, layout.sens_mults)
    else:  # per_layer
        num_groups = layout.num_groups
        dims = layout.dims
    if cfg.sigma is not None:
        sigma = float(cfg.sigma)
    else:
        if cfg.epsilon is None:
            raise ValueError("need epsilon or sigma")
        sigma = accounting.calibrate_sigma(
            target_eps=cfg.epsilon, sampling_rate=cfg.sampling_rate,
            steps=cfg.steps, delta=cfg.delta)
    if cfg.adaptive:
        sigma_b = accounting.sigma_b_for_fraction(
            sigma, num_groups, cfg.quantile_budget_fraction)
        sigma_new = accounting.split_noise_multiplier(
            sigma, sigma_b, num_groups).sigma_new
    else:
        sigma_b, sigma_new = 0.0, sigma
    return DPPlan(cfg, num_groups, sigma, sigma_b, sigma_new, dims, mults)


def init_dp_state(plan: DPPlan, device: str | torch.device = "cpu"
                  ) -> DPState:
    cfg = plan.config
    k = max(plan.num_noise_groups, 1)
    qstate = init_quantile_state(
        np.full((k,), cfg.init_threshold, np.float32),
        target_quantile=cfg.target_quantile, lr=cfg.quantile_lr,
        sigma_b=plan.sigma_b if cfg.adaptive else 0.0, device=device)
    return DPState(qstate=qstate, step=0)


# ---------------------------------------------------------------------------
# Randomness and noise application.
# ---------------------------------------------------------------------------


def _seed(*parts) -> int:
    """A 63-bit generator seed from integers, the same in every process."""
    digest = hashlib.sha256(repr(parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(device, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(_seed(*parts))


def standard_normal(path: str, shape: tuple[int, ...], rows: slice,
                    gen: torch.Generator) -> torch.Tensor:
    """float32 N(0, 1) draws for rows `rows` of leaf `path` (the leaf's
    whole shape when it is not sliced), taken in order from the leaf's
    own generator `gen`. The one place noise is drawn: a test replaces it
    to feed in the reference's draws."""
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def _noise_leaf(layout, grads, stds, seed, step, path, p) -> None:
    """One leaf of `add_noise_to_grads`, in place."""
    g = grads
    for k in path:
        g = g[k]
    grp = layout.group_of_leaf(path)
    name = "/".join(path)
    std = stds[grp.offset: grp.offset + grp.count].reshape(
        grp.stack_shape)
    gen = generator(g.device, seed, step, stable_hash(name))
    start = 0
    for part in slices(g):
        rows = slice(start, start + (part.shape[0] if g.dim() else 1))
        z = standard_normal(name, tuple(part.shape), rows, gen)
        s = std[rows] if p.stack else std  # per-layer std: stack axis
        if p.blocks > 1:  # per column block of the last axis
            m = p.blocks
            s = s.reshape(s.shape[:-1] + (1,) * (part.dim() - p.stack
                                                 - 1) + (m, 1))
            z = (z.reshape(part.shape[:-1] + (m, -1)) * s).reshape(
                part.shape)
        else:
            z = z * s.reshape(s.shape + (1,) * (part.dim() - s.dim()))
        part.copy_((part.float() + z).to(part.dtype))
        start = rows.stop


def add_noise_to_grads(spec: SpecTree, layout: GroupLayout, grads: Any,
                       stds: torch.Tensor, seed: int, step: int) -> Any:
    """grads + N(0, std_k²) IN PLACE, with the std of each leaf's group
    (per stack element for stacked leaves, so per (layer, expert) for an
    expert leaf's two stack dims, per (stack element, column block) for
    blocked ones); stds: (K,) per layout group. Each leaf
    draws from its own generator, (seed, step, stable_hash(path)); a large
    leaf is drawn and added slice by slice along its first axis. A blocked
    leaf draws what an unblocked leaf of its shape draws. Returns
    `grads`."""
    for path, p in _walk(spec):
        # dp_noise_add:<leaf> marks this leaf's draw and add for the static
        # audit (`analysis.taint`); '.'-joined, as the reference names it
        with named_scope(NOISE_SCOPE + ".".join(path)):
            _noise_leaf(layout, grads, stds, seed, step, path, p)
    return grads


def _layout_stds(plan: DPPlan, layout: GroupLayout, thresholds: torch.Tensor,
                 assign: torch.Tensor | None) -> torch.Tensor:
    """Per-layout-group noise stds: per_layer has one noise group per
    layout group; the flat mode's one std covers every layout group; a
    supergroup's std is broadcast to its members (`assign`, (K,))."""
    cfg = plan.config
    dev = thresholds.device
    dims = torch.as_tensor(plan.group_dims, dtype=torch.float32, device=dev)
    mults = torch.as_tensor(plan.sens_mults, dtype=torch.float32, device=dev)
    stds = noise_lib.group_noise_stds(cfg.noise_strategy, thresholds * mults,
                                      dims, plan.sigma_new)
    mode = base_mode(cfg.mode)
    if mode in ("ghost_flat", "naive_flat"):
        return stds.expand(layout.num_groups)
    if mode == "per_group":
        return stds[assign]
    return stds


def _effective_thresholds(cfg: DPConfig, plan: DPPlan, dp_state: DPState):
    """Tracked thresholds, with the Appendix-A.1 global rescale applied."""
    thresholds = dp_state.qstate.thresholds
    if cfg.threshold_rescale is not None and plan.num_noise_groups > 1:
        thresholds = (cfg.threshold_rescale * thresholds
                      / torch.sqrt(torch.sum(thresholds ** 2) + 1e-20))
    return thresholds


def _grad_norm(grads) -> torch.Tensor:
    total = None
    for _, g in tree_leaves(grads):
        for part in slices(g):
            s = torch.sum(torch.square(part.float()))
            total = s if total is None else total + s
    return torch.sqrt(total)


def _apply_update(cfg: DPConfig, optimizer, trainable_key, batch_size,
                  params, opt_state, dp_state, noised, counts, thresholds,
                  loss, count_gen):
    """Post-clipping tail: gradient averaging, the optimizer update (in
    place on `params`, or on `params[trainable_key]`), the private
    quantile update, metrics. `noised` is the (noised) SUMMED clipped
    gradient, averaged here in place."""
    if trainable_key is not None:
        noised = noised[trainable_key]
    for _, g in tree_leaves(noised):
        g.div_(batch_size)
    new_opt_state = optimizer.update(
        noised, opt_state,
        params if trainable_key is None else params[trainable_key])
    qstate = dp_state.qstate
    if cfg.private and cfg.adaptive:
        qstate = update_thresholds(qstate, counts, batch_size, count_gen)
    metrics = StepMetrics(
        loss=loss,
        clip_fraction=1.0 - torch.mean(counts) / batch_size,
        mean_threshold=torch.mean(thresholds),
        grad_norm=_grad_norm(noised))
    return params, new_opt_state, DPState(qstate, dp_state.step + 1), metrics


def clipped_microbatches(clip_one: Callable, batch: dict, batch_size: int,
                         microbatches: int) -> ClipResult:
    """Exact accumulation over microbatches: `clip_one(batch_mb,
    mb_size)` -> ClipResult clips each of `microbatches` consecutive
    equal slices of the batch's (B, ...) tensors (`make_dp_train_step`
    refuses a batch_size that `microbatches` does not divide). Each
    slice's clipped sums (in the parameters' dtype) are added into an f32
    accumulator, cast to the parameters' dtype once at the end; the norms
    come back as (K, B) in example order; the loss is the mean of the
    slices'."""
    mb = batch_size // microbatches
    if microbatches == 1:
        return clip_one(batch, mb)
    acc: list = []  # (path, f32 sum, dtype) per leaf
    loss, norms = 0.0, []
    for i in range(microbatches):
        res = clip_one({k: v[i * mb:(i + 1) * mb] for k, v in batch.items()},
                       mb)
        if not acc:
            acc = [(path, torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), g.dtype)
                   for path, g in tree_leaves(res.grads)]
        for (_, a, _), (_, g) in zip(acc, tree_leaves(res.grads)):
            a.add_(g)
        loss = loss + res.loss
        norms.append(res.norms_sq)
        del res
    paths, leaves = [], []
    while acc:  # release each f32 sum once cast
        path, a, dtype = acc.pop(0)
        paths.append(path)
        leaves.append(a.to(dtype))
        del a
    return ClipResult(_rebuild(paths, leaves), torch.stack(norms, dim=1)
                      .reshape(norms[0].shape[0], batch_size),
                      loss / microbatches)


def make_dp_train_step(loss_fn: LossFn, spec: SpecTree, layout: GroupLayout,
                       optimizer: Any, cfg: DPConfig, *, batch_size: int,
                       trainable_key: str | None = None, mesh: Any = None,
                       on_clip: Callable | None = None
                       ) -> tuple[Callable, Callable, DPPlan]:
    """Build the private training step. Returns (init_fn, step_fn, plan).

    init_fn(params) -> (opt_state, dp_state)
    step_fn(params, opt_state, dp_state, batch, seed)
        -> (params, opt_state, dp_state, StepMetrics)

    params is the reference-layout tree of leaves with `requires_grad`;
    step_fn updates it IN PLACE and returns it. Accounting (sigma
    calibration, the Prop 3.1 split) happens here, once. Refuses a spec
    whose leaf paths crc32-collide into one noise stream.

    trainable_key: train `params[trainable_key]` only (DP-LoRA's
    `"lora"`, with the model's `dp_spec` as `spec`): the rest of the tree
    is frozen, carried through untouched, and spends no privacy budget;
    the optimizer state covers the subtree only.

    mesh: a `launch.mesh.Mesh`. The step is then this rank's part of the
    sharded step (`_make_sharded_step`): `batch` is still the GLOBAL
    batch of `batch_size` examples, of which the rank clips its data
    shard, and params must be replicated (the launcher gathers them).
    on_clip: called as `on_clip(result, counts)` with each step's clip
    result (its clipped grads, global under a mesh; the norms², the
    rank's columns under a mesh; the loss) and the clip counts, before
    the noise is added."""
    if cfg.private:
        noise_lib.check_leaf_key_collisions(
            ["/".join(p) for p, _ in _walk(spec)])
    if mesh is not None:
        return _make_sharded_step(loss_fn, spec, layout, optimizer, cfg,
                                  batch_size=batch_size, mesh=mesh,
                                  trainable_key=trainable_key,
                                  on_clip=on_clip)
    plan = build_plan(cfg, layout)

    def init_fn(params):
        tp = params if trainable_key is None else params[trainable_key]
        dev = next(t for _, t in tree_leaves(tp)).device
        return optimizer.init(tp), init_dp_state(plan, dev)

    mode = base_mode(cfg.mode)
    execution = "twopass" if cfg.mode.endswith("_twopass") else cfg.execution
    assign_np = (np.asarray(cfg.group_assignment, np.int64)
                 if mode == "per_group" else None)
    if batch_size % cfg.microbatches:
        raise ValueError("batch_size must divide by microbatches")

    def clip(params, batch, thresholds, assign):
        kw = dict(mode=mode)
        if mode == "per_layer":
            kw["thresholds"] = thresholds
        elif mode in ("ghost_flat", "naive_flat"):
            kw.update(flat_threshold=thresholds[0], execution=execution)
        elif mode == "per_group":
            kw.update(group_assignment=assign, group_thresholds=thresholds,
                      execution=execution)
        return clipped_microbatches(
            lambda mb, n: dp_clipped_gradients(loss_fn, params, mb, layout,
                                               batch_size=n,
                                               trainable_key=trainable_key,
                                               **kw),
            batch, batch_size, cfg.microbatches)

    def step_fn(params, opt_state, dp_state, batch, seed: int):
        with ghost_backend.scoped(cfg.backend, autotune=cfg.autotune):
            thresholds = _effective_thresholds(cfg, plan, dp_state)
            assign = (None if assign_np is None else
                      torch.as_tensor(assign_np, device=thresholds.device))
            res = clip(params, batch, thresholds, assign)
            if mode == "non_private":
                counts = torch.zeros_like(thresholds)
            else:
                if mode == "per_layer":
                    norms = res.norms_sq
                elif mode in ("ghost_flat", "naive_flat"):
                    norms = torch.sum(res.norms_sq, dim=0)[None]
                else:  # per_group
                    norms = supergroup_norms(res.norms_sq, assign,
                                             plan.num_noise_groups)
                counts = clip_counts(norms, thresholds)
            if on_clip is not None:
                on_clip(res, counts)
            noised = res.grads if mode == "non_private" else (
                add_noise_to_grads(
                    spec, layout, res.grads,
                    _layout_stds(plan, layout, thresholds, assign), seed,
                    dp_state.step))
            count_gen = generator(thresholds.device, seed, dp_state.step)
            return _apply_update(cfg, optimizer, trainable_key, batch_size,
                                 params, opt_state, dp_state, noised, counts,
                                 thresholds, res.loss, count_gen)

    return init_fn, step_fn, plan


# ---------------------------------------------------------------------------
# The sharded train-step factory.
# ---------------------------------------------------------------------------


def _make_sharded_step(loss_fn, spec, layout, optimizer, cfg: DPConfig, *,
                       batch_size: int, mesh, trainable_key=None,
                       on_clip=None):
    """`make_dp_train_step` on one rank of a (data[, pod], model) mesh.

    See `core.clipping.sharded_clipped_gradients` for the per-mode
    communication contract. The quantile update, the noise draw and the
    optimizer run replicated (every rank's generators are seeded alike),
    so every rank ends the step with the same parameters and state."""
    dax = data_axes(mesh)
    d_size = mesh.axis_size(dax) if dax else 1
    m_size = mesh.shape["model"]
    if batch_size % d_size:
        raise ValueError(f"global batch {batch_size} must divide across the "
                         f"{d_size}-way data plane")
    b_local = batch_size // d_size
    nmb = cfg.microbatches
    if b_local % nmb:
        raise ValueError("per-shard batch must divide by microbatches")

    mode = base_mode(cfg.mode)
    execution = "twopass" if cfg.mode.endswith("_twopass") else cfg.execution
    if mode not in ("non_private", "per_layer", "ghost_flat", "per_group"):
        raise ValueError(
            f"sharded execution supports non_private/per_layer/ghost_flat/"
            f"per_group, not {mode!r} (naive_flat is a single-device oracle)")
    own_assign = group_shard_assignment(layout, m_size)
    if mode == "per_group":
        if (cfg.group_assignment is not None
                and tuple(cfg.group_assignment) != own_assign):
            raise ValueError(
                "sharded per_group IS per-device clipping: group_assignment "
                "must equal the model-axis shard ownership (leave it unset "
                "to derive it via launch.sharding.group_shard_assignment)")
        cfg = dataclasses.replace(cfg, group_assignment=own_assign,
                                  num_supergroups=m_size)
    plan = build_plan(cfg, layout)
    assign_np = np.asarray(own_assign, np.int64)
    lo = mesh.data_index() * b_local

    def init_fn(params):
        tp = params if trainable_key is None else params[trainable_key]
        dev = next(t for _, t in tree_leaves(tp)).device
        return optimizer.init(tp), init_dp_state(plan, dev)

    def one(params, batch_mb, thresholds, bsz, assign):
        kw = dict(mode=mode, batch_size=bsz, data_size=d_size, mesh=mesh,
                  data_axes=dax, model_axis="model",
                  trainable_key=trainable_key)
        if mode == "per_layer":
            kw["thresholds"] = thresholds
        elif mode == "ghost_flat":
            kw.update(flat_threshold=thresholds[0], shard_assignment=assign,
                      execution=execution)
        elif mode == "per_group":
            kw.update(group_thresholds=thresholds, shard_assignment=assign,
                      execution=execution)
        return sharded_clipped_gradients(loss_fn, params, batch_mb, layout,
                                         **kw)

    def clip(params, batch, thresholds, assign):
        # the per-microbatch grads and counts come back already globally
        # reduced, so plain f32 accumulation stays exact
        counts = []

        def clip_one(batch_mb, n):
            res = one(params, batch_mb, thresholds, n, assign)
            counts.append(res.counts)
            return ClipResult(res.grads, res.norms_sq, res.loss)

        res = clipped_microbatches(clip_one, batch, b_local, nmb)
        return ShardedClipResult(*res, sum(counts))

    def step_fn(params, opt_state, dp_state, batch, seed: int):
        with ghost_backend.scoped(cfg.backend, autotune=cfg.autotune):
            thresholds = _effective_thresholds(cfg, plan, dp_state)
            assign = torch.as_tensor(assign_np, device=thresholds.device)
            local = {k: v[lo: lo + b_local] for k, v in batch.items()}
            res = clip(params, local, thresholds, assign)
            # the counts come back globally reduced by the clip driver
            counts = (torch.zeros_like(thresholds) if mode == "non_private"
                      else res.counts)
            if on_clip is not None:
                on_clip(res, counts)
            noised = res.grads if mode == "non_private" else (
                add_noise_to_grads(
                    spec, layout, res.grads,
                    _layout_stds(plan, layout, thresholds, assign), seed,
                    dp_state.step))
            count_gen = generator(thresholds.device, seed, dp_state.step)
            return _apply_update(cfg, optimizer, trainable_key, batch_size,
                                 params, opt_state, dp_state, noised, counts,
                                 thresholds, res.loss, count_gen)

    return init_fn, step_fn, plan
