"""Quickstart on the PyTorch port: distributed k-means through the
unified API, on the card.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Add ``--trace`` to run the same fit with trace="full" and print the
per-round telemetry report.
"""
import argparse

import torch

from repro_torch.api import fit
from repro_torch.configs.soccer_paper import GaussianMixtureSpec
from repro_torch.core.metrics import centralized_cost
from repro_torch.data.synthetic import gaussian_mixture


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args(argv)

    # 100k points from a 25-Gaussian mixture (the paper's synthetic setup)
    spec = GaussianMixtureSpec(n=100_000, dim=15, k=25, sigma=0.001)
    x, _, means = gaussian_mixture(spec)

    # partition across 8 "machines" and run SOCCER
    result = fit(x, k=25, algo="soccer", backend="auto", m=8, epsilon=0.1,
                 trace="full" if args.trace else None, device=args.device)

    const = result.extra["const"]
    cost = result.cost(x, device=args.device)
    opt = float(centralized_cost(torch.as_tensor(x, device=args.device),
                                 torch.as_tensor(means, device=args.device)))
    print(f"backend:            {result.backend}")
    print(f"rounds used:        {result.rounds} "
          f"(worst case {const.max_rounds})")
    print(f"centers selected:   {result.centers.shape[0]} "
          f"(k_plus={const.k_plus})")
    print(f"points uploaded:    {result.uplink_points_total} "
          f"({result.uplink_bytes_total/1e6:.1f} MB; "
          f"coordinator capacity eta={const.eta})")
    print(f"k-means cost:       {cost:.4f}  (optimal ~{opt:.4f}, "
          f"ratio {cost/opt:.2f}x)")
    if args.trace:
        from repro_torch.obs.report import format_summary
        print()
        print(format_summary(result.extra["trace"]))


if __name__ == "__main__":
    main()
