"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel module keeps an integer `launches` that its wrapper bumps on
every kernel call (and nowhere else), so a run can show that it went
through the kernels."""
from __future__ import annotations

from repro_torch.kernels import bk as _bk
from repro_torch.kernels import clip_reduce as _clip_reduce
from repro_torch.kernels import ghost_norm as _ghost_norm
from repro_torch.kernels import paged_attn as _paged_attn

KERNELS = {"paged_attn": _paged_attn, "ghost_norm": _ghost_norm,
           "clip_reduce": _clip_reduce, "scale_contract": _bk}


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
