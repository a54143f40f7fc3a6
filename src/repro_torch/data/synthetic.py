"""Synthetic datasets mirroring the paper's §8 experiments.

The PyTorch port's own numpy copy of the generators its main path needs
from ``repro.data.synthetic``: the same seed gives bit-identical arrays
in both packages. k-spherical-Gaussian mixtures in R^dim with Zipf(γ)
component weights (the paper: dim=15, σ=0.001, γ=1.5, means uniform in
the unit cube), ``drifting_mixture``, the time-evolving stream the
streaming path is measured on, ``contaminate``, the gross outliers the
robust tier is measured on, and the scenario lab's two instances:
``kmeans_parallel_hard_instance`` (Theorem 7.2's duplicated locations)
and ``heavy_tailed_mixture`` (Student-t tails).
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np

from repro_torch.configs.soccer_paper import GaussianMixtureSpec


def gaussian_mixture(spec: GaussianMixtureSpec
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (x (n, dim) f32, labels (n,) i32, means (k, dim) f32)."""
    rng = np.random.default_rng(spec.seed)
    means = rng.uniform(0.0, 1.0, size=(spec.k, spec.dim)).astype(np.float32)
    weights = np.arange(1, spec.k + 1, dtype=np.float64) ** (-spec.zipf_gamma)
    weights /= weights.sum()
    labels = rng.choice(spec.k, size=spec.n, p=weights).astype(np.int32)
    x = means[labels] + rng.normal(
        0.0, spec.sigma, size=(spec.n, spec.dim)).astype(np.float32)
    return x.astype(np.float32), labels, means


def shard_points(x: np.ndarray, m: int, seed: int = 0,
                 shuffle: bool = True, return_weights: bool = False):
    """Partition (n, d) -> (m, ceil(n/m), d); no point is ever dropped.

    When ``m`` does not divide ``n``, the last ``m*p - n`` slots are
    padded with duplicates of randomly chosen points (and a warning is
    issued). Callers that need exact mass pass ``return_weights=True``
    and get ``(parts, w)`` where the duplicate padding rows carry
    weight 0.
    """
    n = x.shape[0]
    p = -(-n // m)
    pad = m * p - n
    rng = np.random.default_rng(seed)
    idx = np.arange(n)
    if shuffle:
        rng.shuffle(idx)
    if pad:
        warnings.warn(
            f"shard_points: n={n} not divisible by m={m}; padding the last "
            f"shard with {pad} duplicate point(s) (weight 0 when "
            f"return_weights=True)", stacklevel=2)
        idx = np.concatenate([idx, rng.choice(idx, size=pad, replace=False)])
    parts = x[idx].reshape(m, p, x.shape[1])
    if not return_weights:
        return parts
    w = np.ones((m * p,), np.float32)
    if pad:
        w[n:] = 0.0
    return parts, w.reshape(m, p)


def kmeans_parallel_hard_instance(k: int, z: int, dim: int = 2,
                                  spread: float = 100.0, seed: int = 3,
                                  sigma: float = 0.0,
                                  heavy_factor: Optional[int] = None
                                  ) -> np.ndarray:
    """Theorem 7.2 / Bachem et al. hard instance, duplicated z times.

    k distinct, far-apart locations; location 1 carries ``heavy_factor·z``
    copies (paper: heavy_factor = k-1, so one location holds half the
    mass) and each of the others z copies. k-means‖'s per-round selection
    probability l·d²/φ is diluted by the duplicate mass, so it misses a
    constant fraction of the light locations every round and needs ~k-1
    rounds; SOCCER's uniform P1 w.h.p. contains every distinct location,
    so OPT(P1)≈0 and one round removes everything.

    ``sigma > 0`` jitters every copy (as a fraction of ``spread``) so
    clustering costs are strictly positive and cost *ratios* stay
    well-defined; the round-count gap is unchanged.
    """
    rng = np.random.default_rng(seed)
    locs = rng.normal(0.0, spread, size=(k, dim)).astype(np.float32)
    reps = np.full((k,), z, np.int64)
    reps[0] = (k - 1 if heavy_factor is None else heavy_factor) * z
    x = np.repeat(locs, reps, axis=0)
    if sigma > 0.0:
        x = x + rng.normal(0.0, sigma * spread,
                           size=x.shape).astype(np.float32)
    return x.astype(np.float32)


def heavy_tailed_mixture(n: int, k: int = 10, dim: int = 12,
                         df: float = 2.0, scale_spread: float = 1.5,
                         seed: int = 5
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Student-t mixture with per-cluster log-uniform scales (KDD-like).

    ``df`` ~ 2 gives infinite-variance tails: a constant fraction of the
    mass sits far from every mean, which is exactly the regime where the
    paper's Table-3 rows need multiple SOCCER rounds (each round's
    threshold peels the dense core, the tail survives to the next).

    Returns (x, labels, means) like ``gaussian_mixture``.
    """
    rng = np.random.default_rng(seed)
    means = rng.uniform(0.0, 1000.0, size=(k, dim)).astype(np.float32)
    scales = 10.0 ** rng.uniform(-scale_spread, scale_spread, size=(k, 1))
    weights = np.arange(1, k + 1, dtype=np.float64) ** (-1.5)
    weights /= weights.sum()
    labels = rng.choice(k, size=n, p=weights).astype(np.int32)
    noise = rng.standard_t(df, size=(n, dim)) * scales[labels]
    return ((means[labels] + noise).astype(np.float32), labels, means)


def drifting_mixture(steps: int, n_per_step: int, k: int = 8, dim: int = 8,
                     drift: float = 0.0, sigma: float = 0.02,
                     birth_step: Optional[int] = None,
                     death_step: Optional[int] = None, seed: int = 11
                     ) -> Tuple[list, np.ndarray]:
    """Time-evolving mixture: one batch per step, means random-walking.

    The streaming scenarios' generator. Component means start uniform in
    the unit cube and take an independent Gaussian step of RMS length
    ``drift`` per unit-cube-diagonal between batches (``drift=0`` is the
    stationary control). ``birth_step`` holds one component at zero
    weight until that step (cluster birth — new mass appears where no
    center has been); ``death_step`` zeroes one component's weight from
    that step on (its mass redistributes over the survivors). Weights
    are Zipf(1.5) like the paper's §8 mixture.

    Returns (batches, means_hist): ``steps`` arrays of shape
    ``(n_per_step, dim)`` float32 and the ``(steps, k, dim)`` mean
    trajectory for diagnostics.
    """
    rng = np.random.default_rng(seed)
    means = rng.uniform(0.0, 1.0, size=(k, dim))
    step_sigma = drift / np.sqrt(dim)   # per-axis, so E||step|| ~= drift
    base_w = np.arange(1, k + 1, dtype=np.float64) ** (-1.5)
    batches, hist = [], []
    for s in range(steps):
        weights = base_w.copy()
        if birth_step is not None and s < birth_step:
            weights[k - 1] = 0.0
        if death_step is not None and s >= death_step:
            weights[0 if k == 1 else 1] = 0.0
        weights /= weights.sum()
        labels = rng.choice(k, size=n_per_step, p=weights)
        x = means[labels] + rng.normal(0.0, sigma, size=(n_per_step, dim))
        batches.append(x.astype(np.float32))
        hist.append(means.astype(np.float32).copy())
        means = means + rng.normal(0.0, step_sigma, size=(k, dim))
    return batches, np.stack(hist)


def contaminate(x: np.ndarray, frac: float = 0.01, scale: float = 50.0,
                seed: int = 7, geometry: str = "isotropic",
                n_clumps: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """Inject gross outliers: returns (x_contaminated, inlier_mask).

    ``round(frac * n)`` outliers (at least one) at ``scale`` times the
    data's RMS radius: drawn independently around the data mean
    (``"isotropic"``), or gathered into ``n_clumps`` tight far clumps
    (``"clustered"``), which look like small genuine clusters. They are
    appended and the whole array is shuffled; ``inlier_mask`` marks the
    original points.
    """
    if geometry not in ("isotropic", "clustered"):
        raise ValueError(f"contaminate geometry must be 'isotropic' or "
                         f"'clustered', got {geometry!r}")
    rng = np.random.default_rng(seed)
    n, d = x.shape
    n_out = max(int(round(frac * n)), 1)
    radius = float(np.sqrt(np.mean(np.sum(
        (x - x.mean(axis=0)) ** 2, axis=1))))
    r = scale * max(radius, 1e-6)
    if geometry == "isotropic":
        outliers = x.mean(axis=0) + rng.normal(0.0, r, size=(n_out, d))
    else:
        clumps = x.mean(axis=0) + rng.normal(
            0.0, r, size=(min(n_clumps, n_out), d))
        assign = rng.integers(0, clumps.shape[0], size=n_out)
        # clump spread ~ the inlier RMS radius
        outliers = clumps[assign] + rng.normal(
            0.0, max(radius, 1e-6), size=(n_out, d))
    x_all = np.concatenate([x, outliers.astype(np.float32)])
    mask = np.concatenate([np.ones((n,), bool), np.zeros((n_out,), bool)])
    order = rng.permutation(n + n_out)
    return x_all[order], mask[order]
