"""Which float sums on the card change from run to run, and do the fits?

    python3 scripts/determinism_probe.py [--src DIR] [--fits]

On one CUDA card, for float32 vectors of 20,000 to 10 M entries, prints
how many of 50 repeats of ``torch.cumsum`` and of a float ``index_add_``
(into 1,025 bins) differ in any bit from the first call, the same for
``repro_torch.kernels.exact.exact_cumsum`` when the tree at ``--src``
(default: this checkout's ``src``) has it, and whether
``torch.use_deterministic_algorithms(True)`` makes ``torch.cumsum`` on
the card raise. With ``--fits`` it then fits ``coreset_kmeans`` (16,384
rows) on the paper's 10 M-point mixture and ``kzmeans`` (outlier_frac
0.02, 1,640,000 rows) on it with 2% gross outliers, three times each at
seed 0, and prints whether the repeats gave the first fit's centers bit
for bit. Pass the root of another tree's ``src`` (e.g. a ``git archive``
of a parent commit under ``build/``) to probe that tree.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

SIZES = (20_000, 200_000, 1_250_000, 10_000_000)
REPEATS = 50


def differs(fn, first: torch.Tensor) -> int:
    return sum(int(not torch.equal(fn(), first)) for _ in range(REPEATS))


def main() -> None:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(root, "src"))
    ap.add_argument("--fits", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("determinism_probe.py needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.src))
    try:
        from repro_torch.kernels.exact import exact_cumsum as exact
    except ImportError:                  # a tree without the exact sums
        exact = None

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}; src {args.src}",
          flush=True)
    g = torch.Generator("cuda").manual_seed(0)
    for n in SIZES:
        v = torch.rand(n, generator=g, device="cuda")
        a = torch.randint(0, 1025, (n,), generator=g, device="cuda")

        def cumsum():
            return torch.cumsum(v, 0)

        def index_add():
            return torch.zeros(1025, device="cuda").index_add_(0, a, v)
        line = (f"n={n}: torch.cumsum differs in {differs(cumsum, cumsum())}"
                f"/{REPEATS} repeats, float index_add_ in "
                f"{differs(index_add, index_add())}/{REPEATS}")
        if exact is not None:
            line += (f", exact_cumsum in "
                     f"{differs(lambda: exact(v), exact(v))}/{REPEATS}")
        print(line, flush=True)
    torch.use_deterministic_algorithms(True)
    try:
        torch.cumsum(v, 0)
        print("use_deterministic_algorithms(True): torch.cumsum on the card "
              "did not raise", flush=True)
    except RuntimeError as e:
        print(f"use_deterministic_algorithms(True): torch.cumsum raised: "
              f"{str(e).splitlines()[0]}", flush=True)
    finally:
        torch.use_deterministic_algorithms(False)

    if not args.fits:
        return
    from repro_torch import api
    from repro_torch.configs.soccer_paper import GaussianMixtureSpec
    from repro_torch.data.synthetic import contaminate, gaussian_mixture
    x, _, _ = gaussian_mixture(GaussianMixtureSpec(
        n=10_000_000, dim=15, k=25, sigma=0.001, zipf_gamma=1.5, seed=17))
    xc, _ = contaminate(x, frac=0.02, scale=50.0, seed=7)
    for algo, data, kw in (
            ("coreset_kmeans", x, dict(coreset_size=16_384)),
            ("kzmeans", xc, dict(outlier_frac=0.02, coreset_size=1_640_000))):
        fits = [api.fit(data, 25, algo=algo, m=8, seed=0, **kw).centers
                for _ in range(3)]
        same = [bool(np.array_equal(fits[0], f)) for f in fits[1:]]
        print(f"{algo} n={data.shape[0]}: repeats give the first fit's "
              f"centers bit for bit: {same}", flush=True)


if __name__ == "__main__":
    main()
