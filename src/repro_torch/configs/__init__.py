"""Architecture registry of the port.

It lists only the architectures the port can run. Every other
architecture of `repro.configs.ARCH_IDS` raises NotImplementedError that
names the ROADMAP.md item porting it.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = ["deepseek-v3-671b", "granite-moe-3b-a800m", "qwen3-4b", "tiny"]

# architectures the reference serves that the port does not yet, with the
# ROADMAP.md Queue A item that brings each one
NOT_PORTED = {
    "deepseek-67b": "A.6 (remaining dense configs)",
    "qwen1.5-32b": "A.6 (remaining dense configs)",
    "minicpm-2b": "A.6 (remaining dense configs)",
    "zamba2-7b": "A.8 (recurrent and hybrid families)",
    "rwkv6-7b": "A.8 (recurrent and hybrid families)",
    "whisper-medium": "A.9 (encoder-decoder and M-RoPE families)",
    "qwen2-vl-72b": "A.9 (encoder-decoder and M-RoPE families)",
}


def get_config(arch_id: str, *, reduced: bool = False) -> ModelConfig:
    """The full config of `arch_id`, or its reduced CPU-sized variant."""
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: ROADMAP.md item "
            f"{NOT_PORTED[arch_id]}")
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; ported: {ARCH_IDS}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    return mod.REDUCED if reduced else mod.CONFIG


__all__ = ["ARCH_IDS", "NOT_PORTED", "ModelConfig", "get_config"]
