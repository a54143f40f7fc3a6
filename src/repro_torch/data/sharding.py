"""Shard-placement policies: how flat ``(n, d)`` data lands on machines.

The PyTorch port's own numpy copy of ``repro.data.sharding``: the same
seed gives bit-identical shards in both packages.

The paper's experiments (and every test before the scenario lab) assume
uniformly shuffled, perfectly balanced shards. Real ingestion pipelines
violate both: data arrives sorted (non-IID shards — each machine sees a
biased slice of the distribution) and partitions are skewed (imbalanced
shards — a few machines hold most of the data). SOCCER's sampling layer
is built for exactly this (largest-remainder apportionment + HT weights),
so the scenario lab exercises it through ``fit(..., shard_policy=...)``.

Every policy maps ``(x, w, m)`` to the facade's internal sharded triple
``((m, p, d) points, (m, p) weights, (m, p) alive)``; slots beyond a
machine's quota are dead padding (weight 0, alive False), never data.

Policies:

* ``"shuffle"``     — uniform random permutation, balanced shards (the
                      historical ``fit(shuffle=True)`` behavior).
* ``"contiguous"``  — keep input order, balanced shards (historical
                      ``shuffle=False``).
* ``"sorted"``      — sort by the first principal direction, then split
                      contiguously: maximally non-IID shards (machine j
                      holds one slab of the distribution).
* ``"imbalanced"``  — shuffled data, Zipf-skewed shard *sizes* (machine
                      0 holds the lion's share; every machine keeps >= 1
                      point).
* a callable        — ``policy(x, w, m, rng) -> (parts, w_parts, alive)``
                      for scenarios beyond the built-ins.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np

ShardPolicy = Union[str, Callable]

_BUILTIN = ("shuffle", "contiguous", "sorted", "imbalanced")

# Zipf exponent for "imbalanced": machine j gets mass ~ (j+1)^-IMBALANCE.
IMBALANCE_GAMMA = 1.2


def _principal_order(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Indices sorting x along its first principal direction (power iter)."""
    xc = x - x.mean(axis=0, keepdims=True)
    v = rng.normal(size=(x.shape[1],))
    v /= max(np.linalg.norm(v), 1e-12)
    for _ in range(12):
        v = xc.T @ (xc @ v)
        v /= max(np.linalg.norm(v), 1e-12)
    return np.argsort(xc @ v, kind="stable")


def _zipf_sizes(n: int, m: int) -> np.ndarray:
    """Zipf-skewed shard sizes: sum == n, every machine >= 1 point."""
    mass = np.arange(1, m + 1, dtype=np.float64) ** (-IMBALANCE_GAMMA)
    mass /= mass.sum()
    sizes = np.maximum(np.floor(mass * n).astype(np.int64), 1)
    # hand the remainder (or deficit) to the largest machines first
    while sizes.sum() < n:
        sizes[np.argmax(mass - sizes / n)] += 1
    while sizes.sum() > n:
        j = np.argmax(sizes)
        sizes[j] -= 1
    return sizes


def _pack(x: np.ndarray, w: np.ndarray, order: np.ndarray,
          sizes: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lay out ``x[order]`` onto shards of the given sizes, dead-padded."""
    m = len(sizes)
    d = x.shape[1]
    p = int(sizes.max())
    parts = np.zeros((m, p, d), np.float32)
    ws = np.zeros((m, p), np.float32)
    alive = np.zeros((m, p), bool)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    for j, (o, c) in enumerate(zip(offs, sizes)):
        sel = order[o:o + c]
        parts[j, :c] = x[sel]
        ws[j, :c] = w[sel]
        alive[j, :c] = True
    return parts, ws, alive


def make_shards(x: np.ndarray, w: Optional[np.ndarray], m: int,
                policy: ShardPolicy = "shuffle", seed: int = 0
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Apply a shard policy: (n, d) -> ((m, p, d), (m, p) w, (m, p) alive).

    ``w`` defaults to all-ones; padding slots always come back with
    weight 0 and ``alive=False`` so no policy can invent data mass.
    """
    x = np.asarray(x, np.float32)
    n, _ = x.shape
    if n < m:
        raise ValueError(f"cannot place n={n} points on m={m} machines")
    w = np.ones((n,), np.float32) if w is None else np.asarray(w, np.float32)
    rng = np.random.default_rng(seed)
    if callable(policy):
        return policy(x, w, m, rng)
    if policy not in _BUILTIN:
        raise ValueError(
            f"unknown shard_policy {policy!r}: expected one of "
            f"{', '.join(_BUILTIN)} or a callable")

    balanced = np.full((m,), n // m, np.int64)
    balanced[: n % m] += 1
    if policy == "shuffle":
        order = np.arange(n)
        rng.shuffle(order)  # same draw as the legacy facade: divisible-n
        return _pack(x, w, order, balanced)   # layouts stay bit-identical
    if policy == "contiguous":
        return _pack(x, w, np.arange(n), balanced)
    if policy == "sorted":
        return _pack(x, w, _principal_order(x, rng), balanced)
    # imbalanced: shuffled points, Zipf-skewed shard sizes
    return _pack(x, w, rng.permutation(n), _zipf_sizes(n, m))
