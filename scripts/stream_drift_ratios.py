"""The drift trigger's view of ``chip_smoke.py``'s stream, in either
package: each update's refined per-weight tree cost over its reference,
then the same trigger against a ladder of sudden jumps.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/stream_drift_ratios.py \
        [--package torch|jax] [--n 24000] [--device cpu|cuda] [--tol 2.0]

The stream is ``chip_smoke.py``'s ``STREAM`` (``drifting_mixture`` of 9
batches, k = 25, d = 15, drift 0.04, σ = 0.02, a birth at step 5, seed
53) with ``--n`` points a batch (1,250,000 in the smoke): a SOCCER
bootstrap on batch 0 (ε = 0.05, δ = 0.1, m = 8), then ``fit_update``
(refine_iters = 4, drift_tol = ``--tol``) on each later batch. An update
re-clusters iff its ratio exceeds ``--tol``. The ladder then starts from
a copy of the state after the last update, once a rung: the last batch
with every component jumped by J times one ordinary drift step
(``jumped_batch``, J in ``JUMPS``). ``--package jax`` runs the JAX
package (on the CPU), ``torch`` the port on ``--device``. Prints one
line an update and a rung, and the wall seconds.
"""
from __future__ import annotations

import argparse
import copy
import os
import sys
import time

import numpy as np

STREAM = dict(steps=9, k=25, dim=15, drift=0.04, sigma=0.02, birth_step=5,
              seed=53)
# multiples of one drift step in the jump ladder; J = 1 is the stream's
# own next step
JUMPS = (1.0, 2.0, 4.0, 8.0)
JUMP_SEED = 7


def jumped_batch(batch: np.ndarray, means: np.ndarray, scale: float,
                 drift: float, seed: int = JUMP_SEED) -> np.ndarray:
    """``batch`` after a sudden jump: every component mean moves at once
    by ``scale`` times one drift step (one Gaussian draw of RMS length
    ``drift`` a component, fixed by ``seed``, as ``drifting_mixture``
    draws its steps), and each point moves with its component, found as
    its nearest mean in ``means`` (the means the batch was drawn from)."""
    rng = np.random.default_rng(seed)
    k, d = means.shape
    step = rng.normal(0.0, drift / np.sqrt(d), size=(k, d))
    x = np.asarray(batch, np.float32)
    mu = np.asarray(means, np.float32)
    d2 = (mu * mu).sum(1) - 2.0 * (x @ mu.T)
    return (x + (scale * step).astype(np.float32)[d2.argmin(1)]).astype(
        np.float32)


def main() -> None:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "src"))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    ap.add_argument("--n", type=int, default=24_000)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--tol", type=float, default=2.0)
    args = ap.parse_args()
    if args.package == "jax":
        from repro.api import fit, fit_update
        from repro.data.synthetic import drifting_mixture
        from repro.streaming.update import DRIFT_EVENTS
        kw = dict(backend="virtual")
        up_kw = {}
    else:
        import torch
        torch.set_num_threads(4)
        from repro_torch.api import fit, fit_update
        from repro_torch.data.synthetic import drifting_mixture
        from repro_torch.streaming.update import DRIFT_EVENTS
        kw = up_kw = dict(device=args.device)
    batches, means = drifting_mixture(n_per_step=args.n, **STREAM)
    t0 = time.perf_counter()
    res = fit(batches[0], 25, m=8, seed=0, epsilon=0.05, delta=0.1, **kw)
    ratios = []
    for i, xb in enumerate(batches[1:], start=1):
        ref = (res.extra["stream"].ref_cost if "stream" in res.extra
               else float("nan"))
        res = fit_update(res, xb, m=8, refine_iters=4, drift_tol=args.tol,
                         **up_kw)
        e = res.extra
        ratios.append(e["cost_per_weight"] / ref)
        print(f"{args.package} update {i}: reclustered={e['reclustered']} "
              f"cost/weight={e['cost_per_weight']:.6g} reference={ref:.6g} "
              f"ratio={ratios[-1]:.4f}", flush=True)
    print(f"{args.package} n={args.n} ratios "
          f"{[round(r, 4) for r in ratios[1:]]}", flush=True)
    for jmp in JUMPS:
        xj = jumped_batch(batches[-1], means[-1], jmp, STREAM["drift"])
        out = fit_update(copy.deepcopy(res), xj, m=8, refine_iters=4,
                         drift_tol=args.tol, **up_kw)
        ev = DRIFT_EVENTS.read()["events"][-1]
        print(f"{args.package} jump {jmp:g} x drift: reclustered="
              f"{out.extra['reclustered']} ratio at the trigger "
              f"{ev['cost_per_weight'] / ev['ref_cost']:.4f}", flush=True)
    print(f"{args.package} n={args.n}: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
