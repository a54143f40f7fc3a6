"""SOCCER experiment presets mirroring the paper's Section 8 setup.

The PyTorch port's own copy of ``repro.configs.soccer_paper`` (the port
imports nothing of the JAX package): the same fields, validation and
presets, so a test can build both packages' parameters from one spec.

The paper's synthetic benchmark draws ten million points from a
k-spherical-Gaussian mixture in R^15 with Zipf(γ=1.5) cluster weights and
σ=0.001. ``PAPER_TABLE2`` keeps every ratio (ε, δ, k, zipf γ, σ) from the
paper at a scaled-down default n; ``chip_smoke.py`` runs its rows at the
paper's n = 10,000,000.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


_CHOICES = {
    "blackbox": ("kmeans", "minibatch"),
    "sharded_threshold": ("bisect", "topk"),
    "sharded_seeding": ("d2", "kmeanspar"),
    "uplink_mode": ("points", "coreset"),
}


@dataclasses.dataclass(frozen=True)
class SoccerParams:
    """Algorithm parameters (paper's notation). Validated on construction
    — a typo like ``blackbox="minbatch"`` raises instead of silently
    falling through to the default black box."""
    k: int
    epsilon: float = 0.1
    delta: float = 0.1
    n_machines: int = 8
    max_rounds: int = 0          # 0 -> ceil(1/epsilon) (worst case + final)
    lloyd_iters: int = 25        # black-box A: Lloyd iterations
    blackbox: str = "kmeans"     # kmeans | minibatch
    minibatch_size: int = 1024
    sharded_coordinator: bool = False  # beyond-paper optimization
    sharded_threshold: str = "bisect"  # bisect | topk threshold estimator
    sharded_seeding: str = "d2"        # d2 | kmeanspar seeding
    outlier_frac: float = 0.0          # robust finalize (paper §9)
    straggler_rate: float = 0.0        # fraction of machines missing the
                                       # per-round sampling deadline (ft)
    uplink_mode: str = "points"        # points | coreset: "coreset"
                                       # compresses each machine's sample
                                       # to a sensitivity coreset before
                                       # the upload (repro.coresets) —
                                       # uplink size decouples from eta
    coreset_size: int = 0              # total coreset rows per upload
                                       # (0 -> max(4*k_plus, eta//4))
    coreset_bicriteria: int = 0        # machine-side bicriteria centers
                                       # (0 -> min(k, per-machine rows))
    seed: int = 0

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"SoccerParams.k must be >= 1, got {self.k}")
        for name in ("epsilon", "delta"):
            v = getattr(self, name)
            if not 0.0 < v < 1.0:
                raise ValueError(
                    f"SoccerParams.{name} must be in (0, 1), got {v}")
        for name, allowed in _CHOICES.items():
            v = getattr(self, name)
            if v not in allowed:
                raise ValueError(
                    f"SoccerParams.{name} must be one of "
                    f"{' | '.join(allowed)}, got {v!r}")
        for name in ("outlier_frac", "straggler_rate"):
            v = getattr(self, name)
            if not 0.0 <= v < 1.0:
                raise ValueError(
                    f"SoccerParams.{name} must be in [0, 1), got {v}")
        if self.uplink_mode == "coreset" and self.sharded_coordinator:
            raise ValueError(
                "SoccerParams: uplink_mode='coreset' compresses the gather "
                "uplink, but the sharded coordinator never gathers — use "
                "one or the other")
        for name, lo in (("n_machines", 1), ("max_rounds", 0),
                         ("lloyd_iters", 1), ("minibatch_size", 1),
                         ("coreset_size", 0), ("coreset_bicriteria", 0)):
            v = getattr(self, name)
            if v < lo:
                raise ValueError(
                    f"SoccerParams.{name} must be >= {lo}, got {v}")


@dataclasses.dataclass(frozen=True)
class GaussianMixtureSpec:
    """Paper §8 synthetic data: k-Gaussian mixture, Zipf weights."""
    n: int = 200_000
    dim: int = 15
    k: int = 25
    sigma: float = 0.001
    zipf_gamma: float = 1.5
    seed: int = 17


# Presets mirroring paper Table 2 rows (scaled n; same ε/δ/k).
PAPER_TABLE2: Tuple[Tuple[GaussianMixtureSpec, SoccerParams], ...] = (
    (GaussianMixtureSpec(k=25), SoccerParams(k=25, epsilon=0.05)),
    (GaussianMixtureSpec(k=100), SoccerParams(k=100, epsilon=0.05)),
)

# Paper Table 3: tiny coordinator (ε=0.01) -> multiple rounds.
PAPER_TABLE3: Tuple[Tuple[GaussianMixtureSpec, SoccerParams], ...] = (
    (GaussianMixtureSpec(k=25), SoccerParams(k=25, epsilon=0.01)),
)
