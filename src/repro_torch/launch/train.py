"""Training CLI: DP-SGD with adaptive group-wise clipping (Algorithm 1).

The counterpart of `repro.launch.train`. The parser has only the flags
the port runs; a flag of the reference that is not ported fails in
argparse.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --clipping per_layer --epsilon 8 --steps 4 --batch 8 --seq 256 \\
      --docs 64 --optimizer adam

Add `--device cpu` (and `--reduced`, or `--arch tiny`) to run without a
GPU. `--backend kernels` (the default) runs the linear layers' norms and
clipped sums through the hand-written kernels (their plain versions on
the CPU); `--backend plain` through the plain PyTorch paths; `--backend
auto` per op and shape through the candidate the autotune table measured
fastest on this card (`kernels.autotune`; `python -m
repro_torch.kernels.autotune --sweep` writes it), else as `kernels` does
(`--autotune off` ignores the table). The default stays `kernels`, where
the reference's is `auto`: a measured table may route a bucket to the
plain path, and `auto` without one is `kernels`.

The startup caches (`setup_caches`): `--cache on` (the default) sweeps the
kernels' build cache under `<cache-dir>/compile` (`launch.compile_cache`:
a corrupt library is deleted and rebuilt at its next use; a warm start
runs no nvcc) and builds there; `--autotune on` installs the measured
table of this card and build under `<cache-dir>/autotune`. `--cache-dir`
defaults to `<repo>/.cache` (or `$REPRO_CACHE_DIR`). After the first step
a `# startup` line gives the seconds from the CLI's start and the nvcc
runs of this process (the serve CLI prints it too, to the end of
serving).

`--clipping ghost_flat` (flat clipping) and `--clipping per_group` run by
book-keeping (`--execution bk`, the default: one backward pass and the
`scale_contract` epilogue) or by two backward passes (`--execution
twopass`, or the mode names `ghost_flat_twopass` / `per_group_twopass`).
per_group's supergroups are what `--group-count` virtual model shards
would own (`launch.sharding.group_shard_assignment`). `--clipping
naive_flat` is the materialising oracle (per-example gradients, then one
flat factor each): O(B x params) memory.

`--microbatches N` clips the batch in N equal parts and accumulates the
clipped sums exactly in f32 (the noise is drawn once per step); it is how
a DP-scale batch, or naive_flat's per-example gradients, fit one card.
The header prints `microbatches=N`.

`--clipping per_shard` is per-device clipping on one card, resolved as the
reference's dry run resolves it: the qkv and o projections split into M =
`--group-count` column blocks (`ModelConfig.dp_blocks`), each block its
own clipping group, and the step runs `per_layer` over the finer (layer x
block) groups. The header prints `dp_blocks=M` and `mode=per_layer`.

`--checkpoint-dir DIR` saves params, optimizer state, the DP state
(thresholds, step) and the Poisson sampler's state once at the end, in
the reference's format (`repro_torch.checkpoint`); `--resume` first
restores them from the newest checkpoint there that verifies, so the run
continues the same sample stream and noise. Sigma and the learning rate
schedule are horizons of `--steps`: resume with the same flags. For the
crash-safe service with a persistent privacy ledger, see
`repro_torch.launch.service`.

`--mesh DxM` runs the sharded step (`core.dp_sgd._make_sharded_step`)
on a (data = D, model = M) mesh of D * M ranks, launched by torchrun,
the repo's launcher or `launch.mesh.spawn`:

  python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.train --mesh 2x2 --dist-backend gloo ...
  python -m repro_torch.launch.mesh --nproc 4 \\
      repro_torch.launch.train --mesh 2x2 --dist-backend gloo ...

Each rank clips its data shard of the global `--batch`; the model axis
distributes the clipping bookkeeping (shard-local norms, per-device
factors, the BK epilogue's interleaved gradient all-reduces). Rank r
computes on cuda:(local rank % cards), or the CPU with `--device cpu`.
`--dist-backend nccl` (the default) takes one rank per card and refuses
more ranks than cards; `gloo` lets ranks share a card (its collectives
go through the host). per_group's supergroups are the mesh's model
shards' ownership, per_shard's blocks its M shards (`dp_blocks = M`).
The weights are STORED model-sharded between steps
(`launch.sharding.params_shardings`) and gathered at each step's entry;
a checkpoint holds the global leaves (rank 0 writes them, the other ranks
wait for its published directory, however long the save takes; the first
save checks that every rank shares the directory) and a resume restores
each rank's slice. Rank 0 alone prints; the header names
the mesh and the backend. The step lines equal the single-device run's
up to f32 summation order. `--lora-rank` runs under `--mesh` too: every
rank clips the adapters alone, only their gradients are all-reduced, and
the frozen base is stored and gathered as the other weights are.

`--arch qwen1.5-32b` trains QKV biases (one group with the qkv weight),
`--arch minicpm-2b` and `--arch deepseek-67b` the other dense configs;
`--variant swa` gives every GQA layer a 4,096-token sliding window.
`--arch granite-moe-3b-a800m` trains the MoE family (one clipping group
per expert and layer), its flat and group modes by either execution.
`--arch deepseek-v3-671b` trains MLA with DeepSeek's MTP loss; MTP runs
`embed` and `head` twice a step, so BK falls back to two passes (with a
warning, and the header says so). `--arch rwkv6-7b` trains RWKV-6 (the
WKV recurrence step by step, as the reference's default) and `--arch
zamba2-7b` Zamba2's Mamba2 backbone with its one shared attention block,
every mode and execution; the shared block's groups carry
sensitivity_mult = its sites, so zamba2's BK falls back to two passes
the same way (header: `bk_falls_back=twopass(shared block at N
sites)`). `--arch qwen2-vl-72b` trains the M-RoPE decoder on text-only
batches, as the reference's CLI does (its three position streams are the
1-D positions broadcast, where M-RoPE is RoPE). `--arch whisper-medium`
is refused before any step: the CLI has no frame source for the
encoder's `batch['frames']` (the reference's fails at its first step
with KeyError: 'frames'); the Trainer trains it when a caller supplies
the frames (`Trainer.next_batch`). Grouped dispatch (`moe_dispatch =
"grouped"`) has no flag, as in the reference: `build_everything` and
`Trainer` take a `cfg` to run in place of the `--arch` one.

`--lora-rank R` is DP-LoRA (the paper's large-model recipe): rank-R
adapters on the attention projections train as one clipping group each
(qkv and o; MLA's kv_b and o), the base frozen. The step trains
`params["lora"]` only (`trainable_key`): its noise, counts, quantile
update and Adam state cover the adapters, and the base stays bit for bit
as it was. The header prints `lora_rank=R`; every mode runs, BK included
(an MTP config's reused embed and head are frozen, so BK applies).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from repro_torch import optim
from repro_torch.checkpoint import load_latest_checkpoint, save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.accounting import compute_epsilon
from repro_torch.core.dp_sgd import DPConfig, make_dp_train_step
from repro_torch.core.spec import meta_params, tree_leaves
from repro_torch.data import (PoissonSampler, SyntheticLM, make_lm_batch,
                              pack_documents)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.sharding import (gather_tree, group_shard_assignment,
                                         params_shardings, shard_tree)
from repro_torch.models.transformer import build_model, shared_sites

# the modes BK executes (the others have no flat factor to wait for)
BK_MODES = ("ghost_flat", "per_group")
CLIPPING = ["per_layer", "ghost_flat", "per_group", "naive_flat",
            "non_private", "ghost_flat_twopass", "per_group_twopass",
            "per_shard"]


def build_train_parser(**kwargs) -> argparse.ArgumentParser:
    """The training CLI's flags, shared with the service
    (`launch.service` adds its ledger, budget and fault flags)."""
    ap = argparse.ArgumentParser(**kwargs)
    ap.add_argument("--arch", default="tiny", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--variant", default=None, choices=["base", "swa"],
                    help="swa: the config's sliding-window flavour (a "
                         "4,096-token window in every GQA layer)")
    ap.add_argument("--clipping", default="per_layer", choices=CLIPPING)
    ap.add_argument("--execution", default="bk", choices=["bk", "twopass"],
                    help="flat/group clipping execution: bk runs ONE "
                         "backward and contracts cached ghost residuals in "
                         "an epilogue (core.bk); twopass runs two")
    ap.add_argument("--epsilon", type=float, default=8.0)
    ap.add_argument("--delta", type=float, default=1e-5)
    ap.add_argument("--sigma", type=float, default=None)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--docs", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adam",
                    choices=["adam", "adamw", "sgd"])
    ap.add_argument("--microbatches", type=int, default=1,
                    help="clip the batch in this many equal parts, "
                         "accumulating the clipped sums exactly")
    ap.add_argument("--lora-rank", type=int, default=0,
                    help="DP-LoRA: train rank-R adapters on the attention "
                         "projections, the base frozen (0: a full "
                         "fine-tune)")
    ap.add_argument("--fixed-thresholds", action="store_true")
    ap.add_argument("--init-threshold", type=float, default=1.0)
    ap.add_argument("--quantile", type=float, default=0.5)
    ap.add_argument("--quantile-budget", type=float, default=0.01)
    ap.add_argument("--noise-strategy", default="global",
                    choices=["global", "equal_budget", "weighted"])
    ap.add_argument("--group-count", type=int, default=2,
                    help="per_group clipping: number of virtual model "
                         "shards whose ownership defines the supergroups "
                         "(launch.sharding.group_shard_assignment); "
                         "per_shard: the number M of column blocks of the "
                         "qkv and o projections")
    ap.add_argument("--backend", default="kernels",
                    choices=["kernels", "plain", "auto"],
                    help="ghost-op engine (repro_torch.kernels.backend): "
                         "the hand-written kernels, the plain PyTorch "
                         "paths, or auto: per op and shape the measured "
                         "autotune table's choice, else the kernels")
    ap.add_argument("--autotune", default="on", choices=["on", "off"],
                    help="on: install the measured autotune table of this "
                         "card and build (repro_torch.kernels.autotune; "
                         "pre-warm with `python -m repro_torch.kernels."
                         "autotune --sweep`), which --backend auto "
                         "consults; off: auto follows the static model")
    ap.add_argument("--cache", default="on", choices=["on", "off"],
                    help="on: sweep the kernels' build cache "
                         "(repro_torch.launch.compile_cache) and build "
                         "there, so a warm start runs no nvcc; off: build "
                         "in the default directory, unchecked")
    ap.add_argument("--cache-dir", default=None,
                    help="cache root for the autotune table AND the "
                         "kernels' builds (default <repo>/.cache or "
                         "$REPRO_CACHE_DIR)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest VERIFIED checkpoint in "
                         "--checkpoint-dir (params, optimizer and DP state "
                         "and the Poisson sampler's state, so the run "
                         "continues the exact sample stream; torn "
                         "checkpoints are skipped)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains (cuda unless asked)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="run the sharded step on a (data=D, model=M) "
                         "mesh of D*M ranks (torchrun or "
                         "launch.mesh.spawn): batch over data, the "
                         "clipping bookkeeping over model, weights "
                         "STORED model-sharded between steps")
    ap.add_argument("--dist-backend", default="nccl",
                    choices=["nccl", "gloo"],
                    help="torch.distributed backend under --mesh: nccl "
                         "takes one rank per card; gloo lets ranks "
                         "share a card or run on the CPU")
    return ap


def setup_caches(args) -> None:
    """Enable the kernels' build cache and install the autotune table per
    the shared --cache / --autotune / --cache-dir flags (train, service
    and serve all start here). Best-effort: cache trouble never kills a
    worker; it degrades to a cold build and the static model."""
    from repro_torch.kernels import autotune
    from repro_torch.launch import compile_cache
    if args.cache != "off":
        compile_cache.enable(args.cache_dir)
    if args.autotune != "off":
        autotune.install_default(args.cache_dir)


def record_cache_program(args, *, entry: str, arch: str) -> None:
    """Stamp this entry point's semantic program key into the cache index
    (which programs a warmed cache covers)."""
    from repro_torch.launch import compile_cache
    if args.cache == "off":
        return
    compile_cache.record_program({
        "entry": entry, "arch": arch,
        "mesh": getattr(args, "mesh", None) or "none",
        "backend": args.backend,
        "execution": getattr(args, "execution", "bk"),
        "clipping": getattr(args, "clipping", None) or "none",
        "torch_version": torch.__version__,
    }, root=args.cache_dir)


def startup_line(args, seconds: float, until: str = "the first step"
                 ) -> str:
    """The `# startup` line: seconds from the CLI's start `until` a point
    of its run, nvcc runs of this process, and the build cache's
    directory and sweep."""
    from repro_torch.kernels import _build
    from repro_torch.launch import compile_cache
    cache = ("off" if args.cache == "off" else
             f"{compile_cache.enabled_dir()} {compile_cache.last_sweep()}")
    return (f"# startup {seconds:.3f}s to {until}: "
            f"nvcc_runs={_build.NVCC_RUNS} compile_cache={cache}")


def setup_mesh(args):
    """The rank's mesh under `--mesh` (joining the process group of
    torchrun's environment or of `launch.mesh.spawn`), else None."""
    if not getattr(args, "mesh", None):
        return None
    return mesh_lib.init_distributed(
        mesh_lib.parse_mesh(args.mesh), backend=args.dist_backend,
        device=args.device)


def build_everything(args: argparse.Namespace, *, cfg=None, mesh=None,
                     on_clip=None):
    """The config, model, packed corpus, Poisson sampler and private step
    of the CLI's arguments: (cfg, model, rows, sampler, init_fn, step_fn,
    plan), as the reference's `build_everything`. `cfg` replaces the
    config of `--arch` / `--reduced` / `--variant` (a depth cut, grouped
    dispatch). `per_shard` resolves to per_layer over M column blocks
    (`cfg.dp_blocks`): `--group-count`, or the mesh's model axis. With a
    `mesh` the step is the rank's sharded step and per_group takes its
    supergroups from the mesh, and `on_clip` sees each step's clip
    result (`make_dp_train_step`). Shared with the service."""
    if cfg is None:
        cfg = get_config(args.arch, reduced=args.reduced,
                         variant=args.variant)
    if getattr(args, "lora_rank", 0):
        cfg = dataclasses.replace(cfg, lora_rank=args.lora_rank)
    mode = args.clipping
    if mode == "per_shard":
        # per-device clipping: blocked groups aligned with M (virtual or
        # mesh) column shards, run as per_layer over (layer x block) groups
        blocks = (mesh.shape["model"] if mesh is not None
                  else args.group_count)
        cfg = dataclasses.replace(cfg, dp_blocks=blocks)
        mode = "per_layer"
    model = build_model(cfg, device=args.device if mesh is None
                        else mesh.device)
    src = SyntheticLM(vocab_size=cfg.vocab_size, num_docs=args.docs,
                      doc_len=args.seq * 2, seed=0)
    rows = pack_documents(src.documents(), args.seq)
    rate = args.batch / rows.shape[0]
    sampler = PoissonSampler(num_examples=rows.shape[0], rate=rate,
                             max_batch=args.batch, seed=1)
    assign = nsuper = None
    if mode.startswith("per_group") and mesh is None:
        # with a mesh the sharded factory derives it from the mesh
        nsuper = args.group_count
        assign = group_shard_assignment(model.layout, nsuper)
    dpc = DPConfig(
        mode=mode, execution=args.execution,
        group_assignment=assign, num_supergroups=nsuper,
        epsilon=args.epsilon if args.sigma is None else None,
        sigma=args.sigma, delta=args.delta, sampling_rate=rate,
        steps=args.steps, adaptive=not args.fixed_thresholds,
        init_threshold=args.init_threshold,
        target_quantile=args.quantile,
        quantile_budget_fraction=args.quantile_budget,
        noise_strategy=args.noise_strategy, backend=args.backend,
        autotune=args.autotune != "off", microbatches=args.microbatches)
    sched = optim.linear_decay(args.lr, args.steps,
                               warmup_steps=args.steps // 20)
    if args.optimizer == "adam":
        opt = optim.adam(sched)
    elif args.optimizer == "adamw":
        opt = optim.adamw(sched)
    else:
        opt = optim.sgd(sched, momentum=0.9)
    init_fn, step_fn, plan = make_dp_train_step(
        model.loss_fn, model.dp_spec, model.layout, opt, dpc,
        batch_size=args.batch, trainable_key=model.trainable_key, mesh=mesh,
        on_clip=on_clip)
    return cfg, model, rows, sampler, init_fn, step_fn, plan


def trainable(model, params):
    """The leaves of `params` that train (every leaf, or DP-LoRA's
    `params["lora"]`): the ones that require grad."""
    key = model.trainable_key
    return tree_leaves(params if key is None else params[key])


def init_state(model, init_fn, seed: int, device) -> dict:
    """Fresh training state: random parameters from `seed` on `device`
    (every trainable leaf requiring grad), their optimizer and DP
    states."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init_train_params(gen)
    for _, leaf in trainable(model, params):
        leaf.requires_grad_()
    opt_state, dp_state = init_fn(params)
    return {"params": params, "opt_state": opt_state, "dp_state": dp_state}


def restore_latest(directory: str, model, init_fn, device, placements=None):
    """(step, state, manifest) of the newest checkpoint under `directory`
    that verifies, restored onto `device` (parameters requiring grad), or
    None. The template is the state's shapes on the meta device, so a
    restore allocates the state once. `placements` (a mesh's
    `params_shardings`): each rank keeps its slices of the parameters."""
    params = meta_params(model.spec)
    for _, leaf in trainable(model, params):
        leaf.requires_grad_()
    opt_state, dp_state = init_fn(params)
    template = {"params": params, "opt_state": opt_state,
                "dp_state": dp_state}
    return load_latest_checkpoint(
        directory, template, device=device,
        shardings=None if placements is None else {"params": placements})


def published(directory: str, step: int) -> int | None:
    """The identity (the directory's inode) of the published checkpoint
    of `step` under `directory`, or None: a save publishes a new
    directory by one rename, so a new identity means a complete save."""
    try:
        return os.stat(os.path.join(directory, f"step_{step:08d}")).st_ino
    except FileNotFoundError:
        return None


def check_shared(mesh, directory: str) -> None:
    """Raise on every rank of `mesh` unless each sees `directory` as rank
    0 does: rank 0 writes a marker file there, every rank looks for it,
    and a psum of the misses (site `shared_dir_check`) tells them all. A
    directory on node-local disks fails here, where the ranks' poll for
    rank 0's save could never end."""
    name = None
    if mesh.rank == 0:
        os.makedirs(directory, exist_ok=True)
        name = f".shared-{os.getpid()}-{time.time_ns()}"
        with open(os.path.join(directory, name), "w"):
            pass
    marker = os.path.join(directory, mesh.broadcast_object(name))
    missing = torch.tensor([0.0 if os.path.exists(marker) else 1.0],
                           device=mesh.device)
    missing = int(mesh.psum(missing, mesh.axis_names,
                            site="shared_dir_check").item())
    if mesh.rank == 0:
        os.remove(marker)
    if missing:
        raise RuntimeError(
            f"{missing} of {mesh.size} ranks do not see rank 0's files "
            f"under {directory}: a checkpoint directory on a mesh must be "
            f"shared by every rank")


def checkpoint_on_rank0(mesh, directory: str, step: int, state_fn,
                        write):
    """`write(state_fn())` on rank 0 of `mesh` (or without one), which
    saves the checkpoint of `step` under `directory`; returns its result
    there, None elsewhere. `state_fn` runs on every rank (under a mesh it
    gathers, a collective). The other ranks then poll for the newly
    published directory, which a collective could not wait on past the
    process group's timeout, and all meet at a barrier: the checkpoint
    exists before any rank goes on, however long the save takes. The
    first save into a directory checks that every rank shares it
    (`check_shared`), as the poll and a resume need; if rank 0 dies, the
    launcher ends the rest."""
    if mesh is not None and mesh.size > 1 and \
            directory not in mesh.shared_dirs:
        check_shared(mesh, directory)
        mesh.shared_dirs.add(directory)
    before = published(directory, step)
    if mesh is not None:
        mesh.barrier()  # every rank has read `before`
    state = state_fn()
    out = write(state) if mesh is None or mesh.rank == 0 else None
    del state
    if mesh is not None and mesh.size > 1:
        if mesh.rank != 0:
            while published(directory, step) in (None, before):
                time.sleep(0.05)
        mesh.barrier()
    return out


class Trainer:
    """One training run, built from the CLI's arguments: the model, its
    parameters (random, from --seed, on --device, or with --resume the
    newest verified checkpoint's), the data stream, the DP plan and the
    step. `step()` runs one optimizer step; `start_step` is the first step
    to run. `cfg` replaces the config of `--arch` (`build_everything`).

    With a `mesh` (`setup_mesh`) it is one rank's run: `params` holds the
    rank's model-sharded slices between steps (`placements`), gathered
    into the global leaves at each step's entry, and `state()` gathers
    them for a checkpoint. `on_clip(result, counts)` sees each step's clip
    result and counts (`make_dp_train_step`)."""

    def __init__(self, args: argparse.Namespace, *, cfg=None, mesh=None,
                 on_clip=None):
        self.args = args
        self.mesh = mesh
        (self.cfg, self.model, self.rows, self.sampler, init_fn,
         self.step_fn, self.plan) = build_everything(args, cfg=cfg,
                                                     mesh=mesh,
                                                     on_clip=on_clip)
        self.device = (torch.device(args.device) if mesh is None
                       else mesh.device)
        self.placements = (None if mesh is None
                           else params_shardings(self.model.spec, mesh))
        self.start_step = 0
        found = None
        if args.resume:
            if not args.checkpoint_dir:
                raise SystemExit("--resume requires --checkpoint-dir")
            found = restore_latest(args.checkpoint_dir, self.model, init_fn,
                                   self.device, self.placements)
        if found is None:
            state = init_state(self.model, init_fn, args.seed, self.device)
            if mesh is not None:  # stored model-sharded between steps
                state["params"] = shard_tree(state["params"],
                                             self.placements)
        else:
            self.start_step, state, manifest = found
            meta = manifest.get("meta") or {}
            if "sampler" in meta:
                self.sampler.restore(meta["sampler"])
        self.params = state["params"]
        self.opt_state, self.dp_state = state["opt_state"], state["dp_state"]
        self.step_seed = args.seed + 1

    def state(self) -> dict:
        """The checkpointed tree (the reference's keys), with the global
        parameters (gathered from every rank under a mesh)."""
        return {"params": self.global_params(), "opt_state": self.opt_state,
                "dp_state": self.dp_state}

    def global_params(self):
        if self.mesh is None:
            return self.params
        return gather_tree(self.params, self.placements)

    @property
    def is_main(self) -> bool:
        """The rank that prints and writes (every run without a mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def next_batch(self) -> dict[str, torch.Tensor]:
        idx = self.sampler.next_indices()
        batch = make_lm_batch(self.rows, idx, self.args.batch)
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def step(self):
        """One step on the next Poisson batch; returns its StepMetrics
        (device scalars)."""
        params = self.global_params()  # the entry all-gather under a mesh
        (params, self.opt_state, self.dp_state, met) = self.step_fn(
            params, self.opt_state, self.dp_state, self.next_batch(),
            self.step_seed)
        self.params = (params if self.mesh is None
                       else shard_tree(params, self.placements))
        return met

    @property
    def execution(self) -> str:
        """How the flat and group modes run (a `*_twopass` mode forces
        twopass)."""
        mode = self.plan.config.mode
        return ("twopass" if mode.endswith("_twopass")
                else self.plan.config.execution)

    def header(self) -> str:
        p = self.plan
        tail = (f" moe_dispatch={self.cfg.moe_dispatch}"
                if self.cfg.num_experts else "")
        if self.cfg.lora_rank:
            tail += f" lora_rank={self.cfg.lora_rank}"
        if (self.execution == "bk" and p.config.mode in BK_MODES
                and self.model.reused_groups):
            tail += (f" bk_falls_back=twopass(groups "
                     f"{','.join(self.model.reused_groups)} run twice)")
        if (self.execution == "bk" and p.config.mode in BK_MODES
                and self.cfg.shared_attention):
            tail += (f" bk_falls_back=twopass(shared block at "
                     f"{shared_sites(self.cfg)} sites)")
        if self.mesh is not None:
            tail += (f" mesh={self.args.mesh} ({self.mesh.describe()}) "
                     f"dist_backend={self.mesh.backend}")
        return (f"# arch={self.cfg.name} params={self.model.num_params:,} "
                f"groups={self.model.layout.num_groups} "
                f"mode={p.config.mode} backend={p.config.backend} "
                f"device={self.args.device} execution={self.execution} "
                f"microbatches={p.config.microbatches} "
                f"sigma={p.sigma:.3f} "
                f"sigma_new={p.sigma_new:.3f} sigma_b={p.sigma_b:.3f} "
                f"dp_blocks={self.cfg.dp_blocks}{tail}")


def step_line(i: int, met) -> str:
    return (f"step {i:5d} loss {float(met.loss):.4f} "
            f"clip_frac {float(met.clip_fraction):.3f} "
            f"thr {float(met.mean_threshold):.4f} "
            f"gnorm {float(met.grad_norm):.4f}")


def main(argv=None) -> int:
    started = time.perf_counter()
    args = build_train_parser().parse_args(argv)
    refuse_frameless(args.arch)
    setup_caches(args)
    mesh = setup_mesh(args)
    try:
        return run(args, mesh, started=started)
    finally:
        if mesh is not None:
            mesh_lib.shutdown()


def refuse_frameless(arch: str) -> None:
    """Exit naming the missing input where `arch` is an encoder-decoder:
    the CLI's batches carry tokens alone, and the encoder needs frames."""
    cfg = get_config(arch)
    if cfg.arch_type == "audio":
        raise SystemExit(
            f"{arch}: the train CLI has no frame source for the encoder's "
            f"batch['frames'] (B, {cfg.encoder_seq_len}, {cfg.d_model}); "
            f"train it through Trainer with the frames in each batch")


def run(args, mesh=None, *, started: float | None = None) -> int:
    """The CLI's run on this rank (every line printed by the main one);
    `started`: the perf_counter of the CLI's start (default: now)."""
    started = time.perf_counter() if started is None else started
    trainer = Trainer(args, mesh=mesh)
    say = print if trainer.is_main else (lambda *a, **k: None)
    if trainer.is_main:
        record_cache_program(args, entry="train", arch=trainer.cfg.name)
    if args.resume and trainer.start_step:
        say(f"# resumed from step {trainer.start_step}")
    say(trainer.header(), flush=True)
    t_start = time.time()
    ran = 0
    for i in range(trainer.start_step, args.steps):
        met = trainer.step()
        ran += 1
        if i % args.log_every == 0 or i == args.steps - 1:
            say(step_line(i, met), flush=True)
        if ran == 1:
            if trainer.device.type == "cuda":
                torch.cuda.synchronize(trainer.device)
            say(startup_line(args, time.perf_counter() - started),
                flush=True)
    wall = time.time() - t_start
    plan = trainer.plan
    if plan.config.private and ran:
        eps = compute_epsilon(sigma=plan.sigma,
                              sampling_rate=plan.config.sampling_rate,
                              steps=args.steps, delta=args.delta)
        say(f"# spent epsilon={eps:.3f} (delta={args.delta}) "
            f"in {args.steps} steps, {wall:.1f}s "
            f"({wall / ran * 1e3:.1f} ms/step)")
    if args.checkpoint_dir:
        path = checkpoint_on_rank0(
            mesh, args.checkpoint_dir, args.steps, trainer.state,
            lambda state: save_checkpoint(
                args.checkpoint_dir, args.steps, state,
                meta={"sampler": trainer.sampler.state()}))
        say(f"# checkpoint: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
