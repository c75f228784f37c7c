"""Architecture registry: ``--arch <id>`` -> config, and the shape cells
(port of ``repro/models/registry.py``). Every arch of the reference's
registry is ported: the dense, ssm, hybrid, moe, encdec (whisper) and vlm
(llava) families. The reference's ``input_specs`` (``jax.ShapeDtypeStruct``
for its dry run) has no counterpart here."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

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


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str       # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r} (use one of {ARCH_IDS})")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def cell_supported(cfg: ArchConfig, shape: ShapeCell) -> Optional[str]:
    """None if the (arch, shape) cell runs; otherwise the skip reason."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (DESIGN.md §5)"
        )
    return None


def all_cells(smoke: bool = False):
    """Yield (arch, shape_cell, skip_reason)."""
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=smoke)
        for shape in SHAPES.values():
            yield arch, shape, cell_supported(cfg, shape)
