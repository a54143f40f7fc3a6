"""Time ``min_dist`` and the Lloyd step at d > 16 on one CUDA card, and
check their bits against the register-blocked walk.

    python3 scripts/time_tiled_walk.py [--src DIR] [--reps 5] [--check]

Loads ``repro_torch.kernels.ops`` from ``DIR`` (default: this checkout's
``src``), so the same script times two trees in one call (the parent's
and the change's, in turns: parent, change, change, parent). At each
shape of SHAPES (float32 points and unit weights drawn from a seed,
every center valid) it prints the device ms a call of ``min_dist``, of
the Lloyd step (``fused_assign_reduce``), of their plain versions
(``kernels/ref.py``, on the card) and of ``torch.cdist`` on the same
points and centers (a yardstick only), each kernel beside its bound, and
the Lloyd step's device µs by kernel (``torch.profiler``), where the
profiler sees device time.

With ``--check`` it first holds, in float32, bfloat16 and float16, with
and without a center mask and with no valid center, at CHECK_SHAPES:
``min_dist``'s (d2, argmin) and the Lloyd step's ``assign_out`` against
``sensitivity_scores`` at w = 1 (its scores are 1·d2, exact, and its
argmin is the register-blocked walk's), bit for bit, and the Lloyd
step's sums and counts against ``ref.fixed_point_reduce_ref`` over that
argmin, bit for bit.

The last line is one JSON object with the numbers and the card's name
and power limit. Timing: ``cuda_timing.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from cuda_timing import device_split, timed_ms

# (n, k, d): kimi-k2's embedding-table fit (its coordinator's η rows
# against k_plus centers, PERF.md §4), qwen2-1.5b's, and chip_smoke.py's
# WIDTH_SHAPES at d = 37 and 513
SHAPES = ((43_106, 78, 7_168), (42_460, 78, 1_536), (20_000, 300, 37),
          (20_000, 190, 513))
# (n, k, d): ragged n, more centers than a center tile, odd d
CHECK_SHAPES = ((1_001, 78, 7_168), (3_001, 300, 37), (2_000, 190, 513),
                (129, 81, 17), (500, 5, 1_536))
PEAK_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BYTES = 3.35e12        # HBM3


def bound_ms(nbytes: float, flops: float):
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def check(ops, ref) -> int:
    """The bit checks of --check; returns the number of cases held."""
    from repro_torch.kernels.fused_lloyd import fused_assign_reduce_cuda
    held = 0
    for n, k, d in CHECK_SHAPES:
        g = torch.Generator("cuda").manual_seed(n + k + d)
        x32 = torch.randn((n, d), generator=g, device="cuda")
        c = torch.randn((k, d), generator=g, device="cuda")
        w = torch.rand(n, generator=g, device="cuda")
        w[: n // 5] = 0.0
        cv = torch.rand(k, generator=g, device="cuda") > 0.3
        cv[-1] = True
        none = torch.zeros(k, dtype=torch.bool, device="cuda")
        ones = torch.ones(n, device="cuda")
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            x = x32.to(dt)
            for mask in (None, cv, none):
                d2, idx = ops.min_dist(x, c, mask)
                sc, asg, _, _ = ops.sensitivity_scores(x, ones, c, mask)
                own = torch.empty_like(idx)
                s, cnt, _ = fused_assign_reduce_cuda(x, w, c, mask,
                                                     assign_out=own)
                s_e, cnt_e = ref.fixed_point_reduce_ref(x, w, asg, k)
                what = f"n={n} k={k} d={d} {dt} mask={mask is not None}"
                ok = (torch.equal(d2, sc) and torch.equal(idx, asg)
                      and torch.equal(own, asg) and torch.equal(s, s_e)
                      and torch.equal(cnt, cnt_e))
                if not ok:
                    sys.exit(f"check failed at {what}: d2 "
                             f"{torch.equal(d2, sc)} argmin "
                             f"{torch.equal(idx, asg)} assign_out "
                             f"{torch.equal(own, asg)} sums "
                             f"{torch.equal(s, s_e)} counts "
                             f"{torch.equal(cnt, cnt_e)}")
                held += 1
    torch.cuda.synchronize()
    return held


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--src", default=os.path.join(root, "src"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_tiled_walk.py needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import ops, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi} src: {args.src}", flush=True)
    if args.check:
        print(f"check: {check(ops, ref)} cases bit for bit against "
              f"sensitivity_scores and fixed_point_reduce_ref", flush=True)
    out = []
    for n, k, d in SHAPES:
        g = torch.Generator("cuda").manual_seed(n + k + d)
        x = torch.randn((n, d), generator=g, device="cuda")
        c = torch.randn((k, d), generator=g, device="cuda")
        w = torch.ones(n, device="cuda")
        ops.min_dist(x, c)
        md = timed_ms(lambda: ops.min_dist(x, c), args.reps)
        fl = timed_ms(lambda: ops.fused_assign_reduce(x, w, c), args.reps)
        cd = timed_ms(lambda: torch.cdist(x, c), args.reps)
        md_p = timed_ms(lambda: ref.min_dist_ref(x, c), args.reps)
        fl_p = timed_ms(lambda: ref.fused_assign_reduce_ref(x, w, c),
                        args.reps)
        md_b = bound_ms(n * d * 4 + k * d * 4 + n * 8, 2.0 * n * k * d)
        fl_b = bound_ms(n * d * 4 + n * 4 + k * d * 4 + (k * d + k + 1) * 4,
                        2.0 * n * k * d + 2.0 * n * d)
        split = device_split(lambda: ops.fused_assign_reduce(x, w, c))
        print(f"n={n} k={k} d={d} f32: min_dist {md:.4f} ms (bound "
              f"{md_b[0]:.4f} {md_b[1]}, {100 * md_b[0] / md:.1f}%), Lloyd "
              f"{fl:.4f} ms (bound {fl_b[0]:.4f} {fl_b[1]}, "
              f"{100 * fl_b[0] / fl:.1f}%), plain {md_p:.4f} / "
              f"{fl_p:.4f} ms, torch.cdist {cd:.4f} ms; Lloyd "
              "split: " + (", ".join(f"{nm} {us:.2f} us"
                                     for nm, us in split.items())
                           or "not measured"), flush=True)
        out.append(dict(n=n, k=k, d=d, min_dist_ms=md, lloyd_ms=fl,
                        min_dist_plain_ms=md_p, lloyd_plain_ms=fl_p,
                        cdist_ms=cd, min_dist_bound_ms=md_b[0],
                        lloyd_bound_ms=fl_b[0], lloyd_split_us=split))
        del x, c, w
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "src": args.src, "calls": out}))


if __name__ == "__main__":
    main()
