"""Training CLI: DP-SGD with adaptive group-wise clipping (Algorithm 1).

The counterpart of `repro.launch.train` for one device. The parser has
only the flags the port runs; a flag of the reference that is not ported
yet (mesh, LoRA, the compile cache) fails in argparse.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --clipping per_layer --epsilon 8 --steps 4 --batch 8 --seq 256 \\
      --docs 64 --optimizer adam

Add `--device cpu` (and `--reduced`, or `--arch tiny`) to run without a
GPU. `--backend kernels` (the default) runs the linear layers' norms and
clipped sums through the hand-written kernels (their plain versions on
the CPU); `--backend plain` through the plain PyTorch paths.

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

`--arch granite-moe-3b-a800m` trains the MoE family (flat dispatch, one
clipping group per expert and layer). Its flat and group modes run by two
passes only: `--execution bk` raises in the first step, since the
book-keeping of the expert layers is ROADMAP A.7.
"""
from __future__ import annotations

import argparse
import dataclasses
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
from repro_torch.launch.sharding import group_shard_assignment
from repro_torch.models.transformer import build_model

CLIPPING = ["per_layer", "ghost_flat", "per_group", "naive_flat",
            "non_private", "ghost_flat_twopass", "per_group_twopass",
            "per_shard"]


def build_train_parser(**kwargs) -> argparse.ArgumentParser:
    """The training CLI's flags, shared with the service
    (`launch.service` adds its ledger, budget and fault flags)."""
    ap = argparse.ArgumentParser(**kwargs)
    ap.add_argument("--arch", default="tiny", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
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
                    choices=["kernels", "plain"],
                    help="ghost-op engine (repro_torch.kernels.backend): "
                         "the hand-written kernels, or the plain PyTorch "
                         "paths")
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
    return ap


def build_everything(args: argparse.Namespace):
    """The config, model, packed corpus, Poisson sampler and private step
    of the CLI's arguments: (cfg, model, rows, sampler, init_fn, step_fn,
    plan), as the reference's `build_everything` without its mesh.
    `per_shard` resolves to per_layer over `--group-count` column blocks
    (`cfg.dp_blocks`). Shared with the service."""
    cfg = get_config(args.arch, reduced=args.reduced)
    mode = args.clipping
    if mode == "per_shard":
        # per-device clipping: blocked groups aligned with M virtual
        # column shards, run as per_layer over (layer x block) groups
        cfg = dataclasses.replace(cfg, dp_blocks=args.group_count)
        mode = "per_layer"
    model = build_model(cfg, device=args.device)
    src = SyntheticLM(vocab_size=cfg.vocab_size, num_docs=args.docs,
                      doc_len=args.seq * 2, seed=0)
    rows = pack_documents(src.documents(), args.seq)
    rate = args.batch / rows.shape[0]
    sampler = PoissonSampler(num_examples=rows.shape[0], rate=rate,
                             max_batch=args.batch, seed=1)
    assign = nsuper = None
    if mode.startswith("per_group"):
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
        microbatches=args.microbatches)
    sched = optim.linear_decay(args.lr, args.steps,
                               warmup_steps=args.steps // 20)
    if args.optimizer == "adam":
        opt = optim.adam(sched)
    elif args.optimizer == "adamw":
        opt = optim.adamw(sched)
    else:
        opt = optim.sgd(sched, momentum=0.9)
    init_fn, step_fn, plan = make_dp_train_step(
        model.loss_fn, model.spec, model.layout, opt, dpc,
        batch_size=args.batch)
    return cfg, model, rows, sampler, init_fn, step_fn, plan


def init_state(model, init_fn, seed: int, device) -> dict:
    """Fresh training state: random parameters from `seed` on `device`
    (every leaf requiring grad), their optimizer and DP states."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init_train_params(gen)
    for _, leaf in tree_leaves(params):
        leaf.requires_grad_()
    opt_state, dp_state = init_fn(params)
    return {"params": params, "opt_state": opt_state, "dp_state": dp_state}


def restore_latest(directory: str, model, init_fn, device):
    """(step, state, manifest) of the newest checkpoint under `directory`
    that verifies, restored onto `device` (parameters requiring grad), or
    None. The template is the state's shapes on the meta device, so a
    restore allocates the state once."""
    params = meta_params(model.spec)
    for _, leaf in tree_leaves(params):
        leaf.requires_grad_()
    opt_state, dp_state = init_fn(params)
    template = {"params": params, "opt_state": opt_state,
                "dp_state": dp_state}
    return load_latest_checkpoint(directory, template, device=device)


class Trainer:
    """One training run, built from the CLI's arguments: the model, its
    parameters (random, from --seed, on --device, or with --resume the
    newest verified checkpoint's), the data stream, the DP plan and the
    step. `step()` runs one optimizer step; `start_step` is the first step
    to run."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        (self.cfg, self.model, self.rows, self.sampler, init_fn,
         self.step_fn, self.plan) = build_everything(args)
        self.device = torch.device(args.device)
        self.start_step = 0
        found = None
        if args.resume:
            if not args.checkpoint_dir:
                raise SystemExit("--resume requires --checkpoint-dir")
            found = restore_latest(args.checkpoint_dir, self.model, init_fn,
                                   self.device)
        if found is None:
            state = init_state(self.model, init_fn, args.seed, self.device)
        else:
            self.start_step, state, manifest = found
            meta = manifest.get("meta") or {}
            if "sampler" in meta:
                self.sampler.restore(meta["sampler"])
        self.params = state["params"]
        self.opt_state, self.dp_state = state["opt_state"], state["dp_state"]
        self.step_seed = args.seed + 1

    def state(self) -> dict:
        """The checkpointed tree (the reference's keys)."""
        return {"params": self.params, "opt_state": self.opt_state,
                "dp_state": self.dp_state}

    def next_batch(self) -> dict[str, torch.Tensor]:
        idx = self.sampler.next_indices()
        batch = make_lm_batch(self.rows, idx, self.args.batch)
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def step(self):
        """One step on the next Poisson batch; returns its StepMetrics
        (device scalars)."""
        (self.params, self.opt_state, self.dp_state, met) = self.step_fn(
            self.params, self.opt_state, self.dp_state, self.next_batch(),
            self.step_seed)
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
        return (f"# arch={self.cfg.name} params={self.model.num_params:,} "
                f"groups={self.model.layout.num_groups} "
                f"mode={p.config.mode} backend={p.config.backend} "
                f"device={self.args.device} execution={self.execution} "
                f"microbatches={p.config.microbatches} "
                f"sigma={p.sigma:.3f} "
                f"sigma_new={p.sigma_new:.3f} sigma_b={p.sigma_b:.3f} "
                f"dp_blocks={self.cfg.dp_blocks}")


def step_line(i: int, met) -> str:
    return (f"step {i:5d} loss {float(met.loss):.4f} "
            f"clip_frac {float(met.clip_fraction):.3f} "
            f"thr {float(met.mean_threshold):.4f} "
            f"gnorm {float(met.grad_norm):.4f}")


def main(argv=None) -> int:
    args = build_train_parser().parse_args(argv)
    trainer = Trainer(args)
    if args.resume and trainer.start_step:
        print(f"# resumed from step {trainer.start_step}")
    print(trainer.header(), flush=True)
    t_start = time.time()
    ran = 0
    for i in range(trainer.start_step, args.steps):
        met = trainer.step()
        ran += 1
        if i % args.log_every == 0 or i == args.steps - 1:
            print(step_line(i, met), flush=True)
    wall = time.time() - t_start
    plan = trainer.plan
    if plan.config.private and ran:
        eps = compute_epsilon(sigma=plan.sigma,
                              sampling_rate=plan.config.sampling_rate,
                              steps=args.steps, delta=args.delta)
        print(f"# spent epsilon={eps:.3f} (delta={args.delta}) "
              f"in {args.steps} steps, {wall:.1f}s "
              f"({wall / ran * 1e3:.1f} ms/step)")
    if args.checkpoint_dir:
        path = save_checkpoint(args.checkpoint_dir, args.steps,
                               trainer.state(),
                               meta={"sampler": trainer.sampler.state()})
        print(f"# checkpoint: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
