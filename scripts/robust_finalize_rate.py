"""How often SOCCER's trimmed finalize lands within 3x of the mixture
means' cost, over a range of seeds, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/robust_finalize_rate.py \
        [--package torch|jax] [--src DIR] [--seeds LO HI]

The configuration is ``tests/test_torch_kzmeans.py::
test_outlier_robust_finalize``'s and ``tests/test_ft.py:192``'s: 12,000
points of a 6-component mixture in R^10 (σ = 0.001, seed 6) with 120
gross outliers (scale 300, seed 3) on 8 machines, k = 6, ε = 0.1,
outlier_frac = 0.02 and η >= n, so the run is the finalize alone. The
finalize's k-means++ seedings decide the outcome, so the rate is a
property of the algorithm, and two random streams give two samples of it.
``--package torch`` fits with the port loaded from ``--src`` (default:
this checkout's ``src``), ``jax`` with the JAX package. Prints one line a
seed, then the count.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main() -> None:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    ap.add_argument("--src", default=os.path.join(root, "src"))
    ap.add_argument("--seeds", type=int, nargs=2, default=(0, 32))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    from repro.configs.soccer_paper import GaussianMixtureSpec
    from repro.data.synthetic import gaussian_mixture, shard_points

    x, _, means = gaussian_mixture(GaussianMixtureSpec(
        n=12_000, dim=10, k=6, sigma=0.001, seed=6))
    rng = np.random.default_rng(3)
    outliers = rng.normal(0, 300.0, size=(120, x.shape[1])).astype(
        np.float32)
    x_all = np.concatenate([x, outliers])
    rng.shuffle(x_all)
    parts = shard_points(x_all, 8)

    if args.package == "torch":
        import torch
        torch.set_num_threads(1)
        from repro_torch.configs.soccer_paper import SoccerParams
        from repro_torch.core.metrics import centralized_cost
        from repro_torch.core.soccer import run_soccer

        def cost(c):
            return float(centralized_cost(
                torch.from_numpy(np.asarray(x)),
                torch.as_tensor(np.asarray(c, np.float32))))

        def finalize(seed):
            return run_soccer(parts, SoccerParams(
                k=6, epsilon=0.1, seed=seed, outlier_frac=0.02),
                eta_override=x_all.shape[0], device="cpu").centers
    else:
        import jax.numpy as jnp
        from repro.configs.soccer_paper import SoccerParams
        from repro.core.metrics import centralized_cost
        from repro.core.soccer import run_soccer

        def cost(c):
            return float(centralized_cost(jnp.asarray(x), jnp.asarray(c)))

        def finalize(seed):
            return run_soccer(parts, SoccerParams(
                k=6, epsilon=0.1, seed=seed, outlier_frac=0.02),
                eta_override=x_all.shape[0]).centers

    ref = cost(means)
    near = 0
    lo, hi = args.seeds
    for seed in range(lo, hi):
        ok = cost(finalize(seed)) <= 3.0 * ref
        near += ok
        print(seed, ok, flush=True)
    print(f"{args.package} ({args.src}): {near} of {hi - lo} seeds within "
          f"3x of the means' cost")


if __name__ == "__main__":
    main()
