"""End-to-end driver of the PyTorch port, the counterpart of
`examples/train_e2e.py`: train a language model for a few hundred DP steps
with adaptive per-layer clipping, checkpoint it, and report the privacy
budget spent.

    PYTHONPATH=src python examples/torch_train_e2e.py           # the GPU
    PYTHONPATH=src python examples/torch_train_e2e.py --device cpu --steps 20

The defaults train qwen3-4b's reduced config for 200 steps in 2
microbatches and save the final state under `build/torch_e2e_ckpt`
(`--checkpoint-dir`); add `--resume` to continue from the newest verified
checkpoint there (with the same --steps: sigma and the learning rate
schedule are horizons of it). Every flag of `repro_torch.launch.train`
passes through, and the user's win.
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.launch.train import main  # noqa: E402

if __name__ == "__main__":
    defaults = ["--arch", "qwen3-4b", "--reduced", "--steps", "200",
                "--batch", "16", "--seq", "64", "--microbatches", "2",
                "--checkpoint-dir", os.path.join(REPO, "build",
                                                 "torch_e2e_ckpt"),
                "--log-every", "20"]
    raise SystemExit(main(defaults + sys.argv[1:]))
