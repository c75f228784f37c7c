"""Architecture registry: ``--arch <id>`` -> config (port of
``repro/models/registry.py``). Every arch of the reference's registry
is ported: the dense, ssm, hybrid, moe, encdec (whisper) and vlm (llava)
families."""
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


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r} (use one of {ARCH_IDS})")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG
