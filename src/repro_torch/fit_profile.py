"""Where a fit's time goes on the card.

    python -m repro_torch.fit_profile [--algo soccer] [--k 25] [--n 10000000]

Draws the paper's §8 mixture (d = 15, σ = 0.001, Zipf γ = 1.5, m = 8
machines; Table 2 rows 1 and 2 are k = 25 and 100) and fits it with
``--algo``: SOCCER at ε = 0.05, δ = 0.1 (the paper's setting), k-means‖
at its defaults (5 rounds, l = 2k), EIM11 at ε = 0.1, δ = 0.1,
coreset_kmeans with a 16,384-row budget, or kzmeans at outlier_frac =
0.02 with a 1,640,000-row budget on the mixture contaminated by 2% gross
outliers (``data.synthetic.contaminate``, scale 50, seed 7). It runs one
warm-up fit, then for one more fit prints:

* the host wall of the fit, and of its host-side shard placement alone
  (``data.sharding.make_shards``, the same call the facade makes);
* ``torch.profiler``'s device time per kernel or copy, summed over the
  fit, with launch counts, and the device's busy and idle share of the
  wall (busy = the sum of device-side event times).

The last line is one JSON object with the same numbers. Needs a CUDA
card; the kernels are built from source at first use.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import api
from repro_torch.configs.soccer_paper import GaussianMixtureSpec
from repro_torch.data.sharding import make_shards
from repro_torch.data.synthetic import contaminate, gaussian_mixture
from repro_torch.device import resolve_device


def _device_us(evt) -> float:
    """Device microseconds of a device-side event (a kernel or a copy),
    0 for the host-side operators that launched them, whose device time
    would count the same kernels twice."""
    if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


# each algorithm's knobs in a profiled fit
ALGO_PARAMS = {"soccer": dict(epsilon=0.05, delta=0.1),
               "kmeans_parallel": {},
               "eim11": dict(epsilon=0.1, delta=0.1),
               "coreset_kmeans": dict(coreset_size=16_384),
               "kzmeans": dict(outlier_frac=0.02, coreset_size=1_640_000)}
# algorithms profiled on contaminated data -> the outlier fraction
CONTAMINATION = {"kzmeans": 0.02}


def profile_fit(k: int, n: int, m: int = 8, top: int = 15,
                algo: str = "soccer") -> dict:
    resolve_device("cuda")
    x, _, _ = gaussian_mixture(GaussianMixtureSpec(n=n, dim=15, k=k,
                                                   sigma=0.001, seed=17))
    if algo in CONTAMINATION:
        x, _ = contaminate(x, frac=CONTAMINATION[algo], scale=50.0, seed=7)
    kw = dict(algo=algo, m=m, seed=0, **ALGO_PARAMS[algo])
    api.fit(x, k, **kw)                                      # warm-up
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    make_shards(x, None, m, policy="shuffle", seed=0)
    shard_s = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = api.fit(x, k, **kw)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    out = {"algo": algo, "k": k, "n": x.shape[0], "m": m,
           "rounds": res.rounds,
           "device": torch.cuda.get_device_name(0), "wall_s": wall_s,
           "host_shard_s": shard_s,
           "device_busy_s": busy_us / 1e6 if busy_us else None,
           "device_idle_share": (1.0 - busy_us / 1e6 / wall_s)
           if busy_us else None,
           "top": [{"name": name[:90], "device_ms": us / 1e3, "calls": cnt}
                   for name, us, cnt in rows[:top]]}
    print(f"fit {algo} k={k} n={x.shape[0]}: wall {wall_s:.3f} s, host shard placement "
          f"{shard_s:.3f} s, device busy "
          + (f"{busy_us / 1e6:.3f} s (idle share "
             f"{out['device_idle_share']:.3f})" if busy_us
             else "not measured (the profiler saw no device time)"))
    for r in out["top"]:
        print(f"  {r['device_ms']:10.3f} ms  {r['calls']:6d}x  {r['name']}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, action="append",
                    help="clusters (repeatable; default 25 and 100)")
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--algo", choices=sorted(ALGO_PARAMS), default="soccer")
    args = ap.parse_args()
    results = [profile_fit(k, args.n, algo=args.algo)
               for k in (args.k or [25, 100])]
    print(json.dumps({"profiles": results}))


if __name__ == "__main__":
    main()
