"""Sharded DP training on a (data, model) mesh of ranks with the PyTorch
port: the train CLI's `--mesh DxM` on D * M ranks started by
`repro_torch.launch.mesh.spawn`, next to the single-device run of the
same flags. Per-device clipping (`--clipping per_group`, the default
here) keeps every norm on its model shard; the step lines of the two runs
agree up to f32 summation order.

    PYTHONPATH=src python examples/torch_train_mesh.py --device cpu
    PYTHONPATH=src python examples/torch_train_mesh.py   # the GPU(s)

On the card the ranks use NCCL when there is a card per rank, else gloo
with every rank on cuda:0 (the backend is printed). The same run under
torchrun: `python -m torch.distributed.run --nproc-per-node 4 -m
repro_torch.launch.train --mesh 2x2 --dist-backend gloo ...`. Other flags
of `repro_torch.launch.train` pass through.
"""
import argparse
import contextlib
import io
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.launch import mesh, train  # noqa: E402


def rank_output(argv: list) -> str:
    """What the train CLI prints on this rank (run by `mesh.spawn`)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(argv)
    return buf.getvalue()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args, rest = ap.parse_known_args()
    shape = mesh.parse_mesh(args.mesh)
    world = shape["data"] * shape["model"]
    if args.device == "cpu":
        backend = "gloo"
    else:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available (pass --device cpu)")
        cards = torch.cuda.device_count()
        backend = "nccl" if cards >= world else "gloo"
        print(f"# {world} ranks on {cards} card(s): dist_backend={backend}")
    argv = ["--arch", "tiny", "--clipping", "per_group", "--steps", "3",
            "--batch", "8", "--seq", "16", "--docs", "32", "--log-every",
            "1", "--seed", "3", *rest, "--device", args.device]
    single = [ln for ln in rank_output(
        argv + ["--group-count", str(shape["model"])]).splitlines()
        if ln.startswith("step")]
    with tempfile.TemporaryDirectory() as work:
        outs = mesh.spawn("torch_train_mesh:rank_output", world,
                          backend=backend, device=args.device,
                          store_dir=work, timeout_s=600,
                          extra_paths=(os.path.dirname(
                              os.path.abspath(__file__)),),
                          args=(argv + ["--mesh", args.mesh,
                                        "--dist-backend", backend],))
    print(outs[0], end="")
    sharded = [ln for ln in outs[0].splitlines() if ln.startswith("step")]
    print(f"# single device: {len(single)} step lines, "
          f"{sum(a == b for a, b in zip(single, sharded))} identical")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
