"""Architecture registry: ``--arch <id>`` -> config (port of
``repro/models/registry.py``). The dense, ssm, hybrid and moe families
are ported; archs of the other families (encdec, vlm) raise."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

ARCH_IDS = (
    "smollm-135m",
    "starcoder2-7b",
    "starcoder2-15b",
    "yi-34b",
    "mamba2-780m",
    "zamba2-2.7b",
    "deepseek-v2-236b",
    "grok-1-314b",
    "whisper-large-v3",
    "llava-next-34b",
)

PORTED = ("smollm-135m", "starcoder2-7b", "starcoder2-15b", "yi-34b",
          "mamba2-780m", "zamba2-2.7b", "deepseek-v2-236b", "grok-1-314b")


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r} (use one of {ARCH_IDS})")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{arch} is not ported yet (ported: {', '.join(PORTED)})")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG
