"""Architecture registry of the port: every architecture of the
reference's `repro.configs.ARCH_IDS`, and `tiny`; the workload shapes
`INPUT_SHAPES` re-exported, as the reference does."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig

ARCH_IDS = ["deepseek-67b", "deepseek-v3-671b", "granite-moe-3b-a800m",
            "minicpm-2b", "qwen1.5-32b", "qwen2-vl-72b", "qwen3-4b",
            "rwkv6-7b", "tiny", "whisper-medium", "zamba2-7b"]


def get_config(arch_id: str, *, reduced: bool = False,
               variant: str | None = None) -> ModelConfig:
    """The full config of `arch_id`, or its reduced CPU-sized variant.
    variant='swa' selects the sliding-window flavour (a 4,096-token
    window), as in the reference; None or 'base' the config itself."""
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


__all__ = ["ARCH_IDS", "INPUT_SHAPES", "InputShape", "ModelConfig",
           "get_config", "list_archs"]
