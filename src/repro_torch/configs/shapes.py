"""Assigned input shapes.

``train_4k`` lowers ``train_step``; ``prefill_32k`` lowers ``prefill``;
``decode_*``/``long_*`` lower ``serve_step`` (one new token against a KV
cache of ``seq_len``).  ``long_500k`` is only valid for sub-quadratic
architectures (see DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> ShapeSpec:
    if name not in SHAPES:
        raise KeyError(f"unknown shape '{name}'; known: {sorted(SHAPES)}")
    return SHAPES[name]


def cell_is_applicable(cfg, shape: ShapeSpec) -> bool:
    """Whether (arch, shape) is a runnable dry-run cell."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False
    return True
