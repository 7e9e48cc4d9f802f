"""Architecture registry of the port.

It lists only the architectures the port can run. Every other
architecture of `repro.configs.ARCH_IDS` raises NotImplementedError that
names the ROADMAP.md item porting it.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = ["deepseek-67b", "deepseek-v3-671b", "granite-moe-3b-a800m",
            "minicpm-2b", "qwen1.5-32b", "qwen3-4b", "tiny"]

# architectures the reference serves that the port does not yet, with the
# ROADMAP.md Queue A item that brings each one
NOT_PORTED = {
    "zamba2-7b": "A.8 (recurrent and hybrid families)",
    "rwkv6-7b": "A.8 (recurrent and hybrid families)",
    "whisper-medium": "A.9 (encoder-decoder and M-RoPE families)",
    "qwen2-vl-72b": "A.9 (encoder-decoder and M-RoPE families)",
}


def get_config(arch_id: str, *, reduced: bool = False,
               variant: str | None = None) -> ModelConfig:
    """The full config of `arch_id`, or its reduced CPU-sized variant.
    variant='swa' selects the sliding-window flavour (a 4,096-token
    window), as in the reference; None or 'base' the config itself."""
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: ROADMAP.md item "
            f"{NOT_PORTED[arch_id]}")
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; ported: {ARCH_IDS}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    cfg = mod.REDUCED if reduced else mod.CONFIG
    if variant == "swa":
        cfg = dataclasses.replace(cfg, sliding_window=4096,
                                  name=cfg.name + "-swa")
    elif variant not in (None, "base"):
        raise ValueError(f"unknown variant {variant!r}")
    return cfg


def list_archs() -> list[str]:
    return list(ARCH_IDS)


__all__ = ["ARCH_IDS", "NOT_PORTED", "ModelConfig", "get_config",
           "list_archs"]
