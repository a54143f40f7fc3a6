"""Where a fit's time goes on the card.

    python -m repro_torch.fit_profile [--algo soccer] [--k 25] [--n 10000000]

Draws the paper's §8 mixture (d = 15, σ = 0.001, Zipf γ = 1.5, m = 8
machines; Table 2 rows 1 and 2 are k = 25 and 100) and fits it with
``--algo``, one of ``PROFILES``: SOCCER at ε = 0.05, δ = 0.1 (the paper's
setting; ``soccer_sharded`` with the sharded coordinator,
``soccer_minibatch`` with the mini-batch black box, ``soccer_int8`` on
the int8 codes uplink), k-means‖ at its defaults (5 rounds, l = 2k),
EIM11 at ε = 0.1, δ = 0.1, the centralized ``lloyd`` and ``minibatch``,
coreset_kmeans with a 16,384-row budget, or kzmeans at outlier_frac =
0.02 with a 1,640,000-row budget on the mixture contaminated by 2% gross
outliers (``data.synthetic.contaminate``, scale 50, seed 7). It runs one
warm-up fit, then for one more fit prints:

* the host wall of the fit, and of its host-side shard placement alone
  (``data.sharding.make_shards``, the same call the facade makes);
* ``torch.profiler``'s device time per kernel or copy, summed over the
  fit, with launch counts, and the device's busy and idle share of the
  wall (busy = the union of the device-side events' time ranges: a
  seeding step launched as a programmatic dependent of the one before
  starts, and waits, while that one runs, so the sum of event times
  would count the overlap twice; ``span_ms`` gives the union for one
  group of kernels).

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


def _union_us(ranges) -> float:
    """Length of the union of (start, end) ranges, in their unit."""
    total, lo, hi = 0.0, None, None
    for start, end in sorted(ranges):
        if hi is None or start > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    return total + (hi - lo if hi is not None else 0.0)


def span_ms(prof: dict, *names: str) -> float:
    """Device milliseconds of a profiled fit spent in the kernels whose
    names contain one of ``names``: the union of their time ranges."""
    return _union_us((start, end) for name, start, end in prof["_device"]
                     if any(n in name for n in names)) / 1e3


_PAPER = dict(epsilon=0.05, delta=0.1)
# each profile -> (its registered algorithm, the knobs of a profiled fit)
PROFILES = {"soccer": ("soccer", _PAPER),
            "soccer_sharded": ("soccer", dict(_PAPER,
                                              sharded_coordinator=True)),
            "soccer_minibatch": ("soccer", dict(_PAPER,
                                                blackbox="minibatch")),
            "soccer_int8": ("soccer", dict(_PAPER, uplink_dtype="int8")),
            "kmeans_parallel": ("kmeans_parallel", {}),
            "eim11": ("eim11", dict(epsilon=0.1, delta=0.1)),
            "lloyd": ("lloyd", {}),
            "minibatch": ("minibatch", {}),
            "coreset_kmeans": ("coreset_kmeans",
                               dict(coreset_size=16_384)),
            "kzmeans": ("kzmeans", dict(outlier_frac=0.02,
                                        coreset_size=1_640_000))}
# profiles fitted on contaminated data -> the outlier fraction
CONTAMINATION = {"kzmeans": 0.02}


def profile_fit(k: int, n: int, m: int = 8, top: int = 15,
                algo: str = "soccer") -> dict:
    resolve_device("cuda")
    x, _, _ = gaussian_mixture(GaussianMixtureSpec(n=n, dim=15, k=k,
                                                   sigma=0.001, seed=17))
    if algo in CONTAMINATION:
        x, _ = contaminate(x, frac=CONTAMINATION[algo], scale=50.0, seed=7)
    name, knobs = PROFILES[algo]
    kw = dict(algo=name, m=m, seed=0, **knobs)
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
    device = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]
    busy_us = _union_us((start, end) for _, start, end in device)
    out = {"algo": algo, "k": k, "n": x.shape[0], "m": m,
           "rounds": res.rounds,
           "device": torch.cuda.get_device_name(0), "wall_s": wall_s,
           "host_shard_s": shard_s,
           "device_busy_s": busy_us / 1e6 if busy_us else None,
           "device_idle_share": (1.0 - busy_us / 1e6 / wall_s)
           if busy_us else None,
           "top": [{"name": name[:90], "device_ms": us / 1e3, "calls": cnt}
                   for name, us, cnt in rows[:top]],
           "_device": device}
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
    ap.add_argument("--algo", choices=sorted(PROFILES), default="soccer")
    args = ap.parse_args()
    results = [profile_fit(k, args.n, algo=args.algo)
               for k in (args.k or [25, 100])]
    print(json.dumps({"profiles": [
        {key: v for key, v in r.items() if key != "_device"}
        for r in results]}))


if __name__ == "__main__":
    main()
