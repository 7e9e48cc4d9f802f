"""What gloo's collectives of CUDA tensors cost on one card: four gloo
ranks sharing cuda:0 (as `chip_smoke.py` phase 16 runs them) time, each
call between two synchronisations, the first and later calls of an
all-gather of 389 MB a rank (half of qwen3-4b's embedding, bf16), an
all-reduce of 778 MB, the same all-gather of host tensors, a 389 MB
device-to-host copy, a bf16 matmul and a kernel's first call. Prints
one JSON object: the launch's seconds and each rank's times.

    PYTHONPATH=src python scripts/torch_gloo_rates.py
"""
import json
import os
import sys
import tempfile
import time

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
sys.path.insert(0, SRC)

MB = 1024 * 1024


def rank_times() -> dict:
    """This rank's seconds per call, `name#i` for the i-th call."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ghost_norm as GN
    dev = torch.device("cuda", 0)
    out = {}

    def timed(name, fn, reps=2):
        for i in range(reps):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            out[f"{name}#{i}"] = time.perf_counter() - t0

    x = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)
    timed("matmul", lambda: x @ x)
    part = torch.zeros(389 * MB // 2, dtype=torch.bfloat16, device=dev)
    parts = [torch.empty_like(part) for _ in range(dist.get_world_size())]
    timed("all_gather_389MB", lambda: dist.all_gather(parts, part), 3)
    whole = torch.zeros(778 * MB // 2, dtype=torch.bfloat16, device=dev)
    timed("all_reduce_778MB", lambda: dist.all_reduce(whole), 3)
    host = part.cpu()
    host_parts = [torch.empty_like(host) for _ in parts]
    timed("all_gather_389MB_host", lambda: dist.all_gather(host_parts,
                                                           host))
    timed("d2h_389MB", lambda: part.cpu())
    a = torch.randn(4, 256, 2560, device=dev, dtype=torch.bfloat16)
    timed("ghost_norm", lambda: GN.ghost_norm(a, a))
    return out


def main() -> int:
    import torch
    from repro_torch.launch import mesh
    if not torch.cuda.is_available():
        print("torch_gloo_rates: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ranks = mesh.spawn("torch_gloo_rates:rank_times", 4,
                           backend="gloo", device="cuda", store_dir=d,
                           timeout_s=600, extra_paths=(os.path.dirname(
                               os.path.abspath(__file__)),))
    print(json.dumps({"gpu": torch.cuda.get_device_name(0),
                      "launch_s": time.perf_counter() - t0,
                      "ranks": ranks}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
