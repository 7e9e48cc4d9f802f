"""Multi-tenant DP-LoRA serving with the PyTorch port, end to end in one
process, the counterpart of `examples/multi_tenant_serve.py`:

  1. fine-tune TWO adapters through the crash-safe training service at
     different privacy budgets (epsilon 2 and epsilon 8); each run
     publishes adapter-only checkpoints to its <service_dir>/publish;
  2. serve both tenants CONCURRENTLY from one engine: one frozen base
     model, one tenant-stacked adapter buffer, each request routed
     through its own tenant's adapter inside one pooled dispatch;
  3. train tenant B further and hot-swap its new publish into the LIVE
     engine mid-traffic: requests already decoding finish on the old
     version, new ones take the new version, and the installed weights
     are verified bit for bit (crc32) against the published checkpoint.
     The adapter buffer never moves and serve_step never sees a new
     input shape (the script asserts it).

    PYTHONPATH=src python examples/torch_multi_tenant_serve.py  # the GPU
    PYTHONPATH=src python examples/torch_multi_tenant_serve.py --device cpu
"""
import argparse
import os
import shutil
import tempfile

import numpy as np

from repro_torch.launch.engine import DecodeEngine
from repro_torch.launch.inputs import synthetic_requests
from repro_torch.launch.service import TrainService, build_service_parser
from repro_torch.launch.swap import AdapterWatcher
from repro_torch.models.transformer import unstack_blocks

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
ap.add_argument("--work-dir", default=None,
                help="where the two services write (default: a fresh "
                     "temporary directory, removed at the end)")
args = ap.parse_args()

ARGV = ["--arch", "tiny", "--lora-rank", "4", "--batch", "8", "--seq", "32",
        "--docs", "64", "--checkpoint-every", "4", "--log-every", "100",
        "--device", args.device]


def service(dirname, *, epsilon, steps, seed, calib_steps=None,
            runtime=None):
    argv = ARGV + ["--service-dir", dirname, "--epsilon", str(epsilon),
                   "--steps", str(steps), "--seed", str(seed)]
    if calib_steps is not None:
        # sigma sized for the whole horizon, so the run can be continued
        # later without blowing the budget
        argv += ["--calib-steps", str(calib_steps)]
    return TrainService(build_service_parser().parse_args(argv),
                        runtime=runtime, sleep=lambda _: None)


root = args.work_dir or tempfile.mkdtemp(prefix="mt-serve-")
dir_a, dir_b = os.path.join(root, "tenant-a"), os.path.join(root, "tenant-b")
try:
    # -- 1. two private fine-tunes at different budgets, publishing ------
    svc_a = service(dir_a, epsilon=2.0, steps=8, seed=0)
    svc_a.run()
    print(f"tenant A trained: epsilon {svc_a.epsilon():.2f} / 2.0")
    svc_b = service(dir_b, epsilon=8.0, steps=8, seed=1, calib_steps=12)
    svc_b.run()
    print(f"tenant B trained: epsilon {svc_b.epsilon():.2f} / 8.0")

    # -- 2. one engine, both tenants; the serving model is the training
    #       model (the same lora_rank), its frozen base split per layer --
    model = svc_a.runtime.model
    base = unstack_blocks({k: v for k, v in svc_a.params.items()
                           if k != "lora"})
    eng = DecodeEngine(model, base, num_slots=4, cache_len=64,
                       prefill_chunk=8, max_tenants=3)
    ten_a = eng.add_tenant(name="tenant-a")
    ten_b = eng.add_tenant(name="tenant-b")
    watch_a = AdapterWatcher(eng, ten_a, os.path.join(dir_a, "publish"))
    watch_b = AdapterWatcher(eng, ten_b, os.path.join(dir_b, "publish"))
    for w, t in ((watch_a, "A"), (watch_b, "B")):
        got = w.poll()
        print(f"tenant {t}: installed published step {got.step} "
              f"(read back equal to its manifest's crcs)")

    reqs = synthetic_requests(model.cfg.vocab_size, 8, min_len=4,
                              max_len=12, seed=7)
    rids = {eng.submit(r, max_new_tokens=8,
                       tenant=(ten_a if i % 2 == 0 else ten_b)): i
            for i, r in enumerate(reqs[:4])}
    done = eng.run()
    print(f"served {len(done)} requests across 2 tenants in "
          f"{eng.stats['decode_dispatches']} pooled decode dispatches")

    # -- 3. train tenant B further, then hot-swap mid-traffic ------------
    svc_b2 = service(dir_b, epsilon=8.0, steps=12, seed=1, calib_steps=12,
                     runtime=svc_b.runtime)  # resumes from its checkpoint
    svc_b2.run()
    print(f"tenant B continued: epsilon {svc_b2.epsilon():.2f} / 8.0")
    for i, r in enumerate(reqs[4:]):
        rids[eng.submit(r, max_new_tokens=8,
                        tenant=(ten_a if i % 2 == 0 else ten_b))] = 4 + i
    eng.run(max_steps=2)  # the old version's decode under way
    swap = watch_b.poll()
    print(f"hot swap: tenant B -> step {swap.step} v{swap.version} "
          f"(read back equal to its manifest's crcs); in-flight requests "
          f"drain on the old version")
    eng.run()

    # one adapter storage in every serve_step, swaps and onboarding
    # included: every write went into the buffer allocated at the start
    assert len(eng.adapter_storages) == 1, "the adapter buffer moved"
    sa, sb = eng.tenant_stats(ten_a), eng.tenant_stats(ten_b)
    print(f"tenant A: v{sa['version']} done={sa['requests_done']} "
          f"tokens={sa['tokens_out']}")
    print(f"tenant B: v{sb['version']} done={sb['requests_done']} "
          f"tokens={sb['tokens_out']} swaps={sb['swaps']}")
    print(f"engine: admits={eng.stats['tenants_admitted']} "
          f"swaps={eng.stats['adapter_swaps']} "
          f"adapter_storages={len(eng.adapter_storages)}")
    toks = np.full((len(reqs), 8), -1, np.int32)
    for rid, i in rids.items():
        c = eng.completions()[rid]
        toks[i, :len(c.tokens)] = c.tokens
    print(toks)
finally:
    if args.work_dir is None:
        shutil.rmtree(root, ignore_errors=True)
