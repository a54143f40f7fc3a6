"""Three-term roofline of a step on the H100.

The port of ``repro.roofline.analysis``:

    compute term    = per-device FLOPs            / 989 TFLOP/s (bf16)
    memory term     = per-device HBM bytes        / 3.35 TB/s
    collective term = per-device collective bytes / 50 GB/s (the link)

with the H100's datasheet peaks (``roofline/hw.py``) in place of the TPU
v5e's. The per-device statistics come from ``roofline/op_stats.py`` (a
step run on local shards) in place of the optimized HLO, so
``roofline_from_stats`` stands in for ``analyze_compiled``; a collective
contributes its result's bytes, the reference's convention.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.roofline import hw


@dataclasses.dataclass
class Roofline:
    flops: float                 # per device
    hbm_bytes: float             # per device
    coll_bytes: float            # per device
    coll_by_kind: Dict[str, float]
    model_flops: float           # analytic 6ND / 2ND (global)
    chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / hw.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / hw.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / hw.LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / (chips * counted FLOPs): remat and redundancy."""
        tot = self.flops * self.chips
        return self.model_flops / tot if tot else 0.0

    @property
    def roofline_frac(self) -> float:
        """Useful compute time over the largest of the three terms: the
        fraction of the compute roofline reachable with perfect
        overlap."""
        t_useful = (self.model_flops / self.chips) / hw.PEAK_FLOPS_BF16
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / t_bound if t_bound else 0.0

    def as_dict(self) -> Dict:
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "coll_by_kind": self.coll_by_kind,
            "model_flops": self.model_flops,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
        }


def roofline_from_stats(stats, model_flops: float, chips: int) -> Roofline:
    """A ``Roofline`` from ``op_stats.OpStats`` of one device's step."""
    return Roofline(flops=stats.flops, hbm_bytes=stats.bytes,
                    coll_bytes=stats.coll_total,
                    coll_by_kind=dict(stats.coll),
                    model_flops=model_flops, chips=chips)


def model_flops_for(cfg, shape) -> float:
    """Analytic useful flops: 6·N·D train, 2·N·D prefill, 2·N_active·B
    decode."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch
