"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel's wrapper bumps an integer counter of its module on every
kernel call (and nowhere else), so a run can show that it went through
the kernels: `launches`, and `blocked_launches` for `ghost_norm_blocked`,
which shares `ghost_norm`'s module."""
from __future__ import annotations

from repro_torch.kernels import bk as _bk
from repro_torch.kernels import clip_reduce as _clip_reduce
from repro_torch.kernels import fused_clip as _fused_clip
from repro_torch.kernels import ghost_norm as _ghost_norm
from repro_torch.kernels import paged_attn as _paged_attn

# kernel name -> (wrapper module, name of its launch counter there)
KERNELS = {"paged_attn": (_paged_attn, "launches"),
           "ghost_norm": (_ghost_norm, "launches"),
           "ghost_norm_blocked": (_ghost_norm, "blocked_launches"),
           "clip_reduce": (_clip_reduce, "launches"),
           "fused_norm_clip": (_fused_clip, "launches"),
           "scale_contract": (_bk, "launches")}


def launch_counts() -> dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)
