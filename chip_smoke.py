"""Smoke test of the PyTorch port of SOCCER and its baselines on one
NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. It

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc/``
   (one nvcc per source, all at once);
3. holds each kernel against its plain PyTorch version on the card at the
   shapes SOCCER's main path gives it (paper Table 2 rows 1 and 2, n = 10 M
   points, d = 15, m = 8 machines), in float32, bfloat16 and float16, with
   invalid centers and zero weights, and times kernel, plain version and
   the closest PyTorch call (``torch.cdist``, which computes the whole
   distance matrix rather than the same function); then holds them
   against their plain versions off the main path's shape too: d = 37
   and d = 513 (the any-width kernel variant, several center tiles) and
   k = 1024 at d = 15 (two tiles). ``remove_below``'s mask equals
   ``alive & (min_dist's d2 > v)`` and its counts the mask's row sums,
   bit for bit, at every shape, dtype and mask (the two share the
   register-blocked walk), and with no valid center ``min_dist`` gives
   +inf and index 0 and ``remove_below`` removes nothing;
4. holds the one Lloyd kernel (``fused_assign_reduce``, every k) at the
   baselines' weighing shapes — 1.25 M points x 831 centers (k-means‖ at
   k = 25; the TPU's resident regime), 1.25 M x 3,081 (k-means‖ at
   k = 100; its single-walk regime) and 65,536 x 173,256 (EIM11's
   clustering; its two-walk regime), at k = 1025 and 2100, and at
   SOCCER's coordinator shapes and 1.25 M points x 4, 25, 831 and 1024
   centers, and at 20,000 x 4,096 (min_dist's center axis split into 8
   slices) — in the three dtypes, with invalid centers and zero weights:
   its argmin equals min_dist's and its sums and counts equal the plain
   fixed-point emulation (``ref.fixed_point_reduce_ref``) over that
   argmin bit for bit, its cost is within FUSED_RTOL of a float64 sum,
   a repeat call gives the same bits, and the sums hold against the
   plain version with a slack for each center from the near-tie points it
   may gain or lose; holds min_dist against its plain version at those
   shapes (float32 only at 173,256 centers); and times every shape for
   both kernels beside their bounds, with min_dist's share of its bound
   and whether it is no slower than the Lloyd kernel, and prints the
   recorded times of the kernels they replaced beside them; it prints
   ``nvcc -Xptxas -v``'s registers and spills of the kernels on the
   register-blocked walk (the Lloyd kernel, min_dist, remove_below,
   sensitivity_scores) and of lloyd_reduce, from the build's own log;
5. holds the robust and coreset tier's kernels against their plain
   versions at that tier's shapes, in the three dtypes, with invalid
   centers and zero weights, with a same-bits repeat, and times them:
   ``lloyd_reduce`` at 1,640,000 x 15 (kzmeans' gathered rows) with k = 25
   (warp accumulators) and k = 1025 (global accumulators), its sums and
   counts equal to ``ref.fixed_point_reduce_ref`` and to the Lloyd
   kernel's given that kernel's own argmin, bit for bit, and its bound
   pass's device time on a line of its own; ``sensitivity_scores`` at
   1,275,000 x 15 against 25 centers (one machine's shard) and 1,111
   (SOCCER k = 1000's width), its argmin and scores min_dist's and its
   masses ``exact_index_add``'s over that argmin, bit for bit, and at
   1,111 beside the min_dist + PyTorch route it replaced;
   ``truncated_cost`` over (8, 1,275,000, 15) against 25 centers with v
   at the median d2 (timed beside the recorded time of its one-point-a-
   thread kernel), over (8, 125,000, 15) against 1,111 centers and over
   (8, 12,501, 15) against 1,111 (the center axis split; machine bases
   off 16 bytes), each side's sums equal to float64 sums over min_dist's
   own d2, a repeat giving the same bits and zero weights no side, and
   with no valid center every point in the tail; and ``remove_below``
   over (8, 125,000, 15) against 1,111 centers (SOCCER's k_plus at
   k = 1000, beyond the resident limit), beside min_dist and
   truncated_cost on the same points;
6. holds the k-means++ seeding kernel (update_min_dist's kernel with its
   Gumbel-max draw on) at SOCCER k = 1000's coordinator shape (991,418 x
   15, 1,111 steps) and at 17,353 x 15 (103 steps), in the three dtypes,
   with zero weights: step by step from a shared state its d2 equals
   ``ops.update_min_dist``'s bit for bit and the plain step's within
   d2_tol, its draw is the argmax of torch's keys from its own d2 and
   agrees with the plain step's draw or lies within the keys' tolerance
   of it (both keys printed); the C loop's draws equal the chained steps
   and repeat bit for bit; with every point on one center the draws
   fall back to the weights as the plain loop's do; and times a whole
   seeding (device ms and host us) and one step beside its bound and the
   parent's Python loop on the draw-off kernel;
7. runs one SOCCER round (once more with the coreset uplink and
   outlier_frac), kzmeans' trimmed Lloyd steps, and k-means‖'s seeding
   rounds with CUDA's sync debug mode set to "error", so a device->host
   synchronization inside a round fails the run;
8. runs ``repro_torch.api.fit`` on five instances — SOCCER and k-means‖ on
   both Table 2 rows at n = 10 M, EIM11 at n = 1 M, k = 25 (a cut of n:
   EIM11's removal sweeps every point against a clustering that grows by
   14,438 rows a round) — checks the paper's bounds and the reference
   tests' claims, and that every kernel of each path was launched; then
   times min_dist at the EIM11 fit's two largest sweeps (its last round's
   second sample and all 1 M points against that round's clustering,
   from the fit's own s and rounds) beside its bound and the Lloyd
   kernel; fits SOCCER, k-means‖ and EIM11 twice each at one seed on
   1 M points and requires the same centers and cost bit for bit;
9. runs the coreset and robust tier at n = 10 M: ``coreset_kmeans`` and
   SOCCER with ``uplink_mode="coreset"`` on Table 2 row 1's mixture; on
   that mixture with 2% gross outliers (10.2 M points), ``kzmeans`` with
   and without ``outlier_frac=0.02`` at a 1,640,000-row budget and SOCCER
   with and without ``outlier_frac=0.02``; and SOCCER at k = 1000
   (k_plus = 1,111), each against the reference tests' claims and with
   every kernel of its path launched; coreset_kmeans and the robust
   kzmeans fit are fitted a second time at full size and must give the
   same centers and cost bit for bit;
10. runs ``repro_torch.fit_profile`` on EIM11 at n = 1 M and SOCCER at
   k = 1000 and prints the device time of min_dist and remove_below in
   them beside the times recorded before the walk moved, and the
   seeding's device time and the fit wall at k = 1000 beside the parent
   loop's recorded ones;
11. holds the kernels at the shapes the knobs' paths give them: the
   sharded coordinator's flattened (8·cap_sharded, 15) buffers (k = 25:
   the seeding, the Lloyd step and min_dist, with 7/8 of the slots of
   weight 0; k = 1000: the seeding's 1,111 steps and the Lloyd step over
   all 7,931,344 slots, the plain version over 991,418-row chunks), the
   mini-batch step's (1,024, 15) batch against 103 and 25 centers, and
   the centralized fits' gathered 10 M rows (the k = 25 seeding over all
   of them, the Lloyd step against its centers); runs one sharded round,
   one straggler round, one int8-codes round and one mini-batch black
   box with CUDA's sync debug mode set to "error";
12. fits on Table 2 row 1's data (n = 10 M, k = 25): SOCCER with
   ``sharded_coordinator=True`` (bisect and D² seeding, twice for the
   same bits; topk and k-means‖ seeding), ``blackbox="minibatch"``
   (twice), ``uplink_dtype`` bfloat16, float16, int8 (codes) and int8 on
   the values wire, ``FailurePlan(fail_at={0: (2, 5), 1: (3,)})`` and
   ``FailurePlan(straggler_rate=0.3)``; ``fit(algo="lloyd")`` and
   ``fit(algo="minibatch")`` (one gather of all 10 M rows); k-means‖,
   coreset_kmeans, SOCCER's coreset uplink and kzmeans on the int8 codes
   wire; EIM11 at 1 M on bfloat16; and
   the sharded coordinator at k = 1000 — each against the reference
   tests' claims (sharded cost <= 1.5x the gather fit's + 0.1x the
   means'; codes = values bit for bit at 1/4 the payload, measured =
   modeled bytes; stragglers lose no data; failures cost <= 4x max(the
   plain fit's, the means'); the mini-batch black box and the
   centralized minibatch fit within tests/test_kmeans.py:71's bound),
   with every kernel of its path
   launched; then ``fit_profile``'s wall, device busy time and idle
   share of the sharded, mini-batch, int8, lloyd and minibatch fits.

Every kernel time is printed with the host's own microseconds a call
beside the device's (``timed_ms``).

It prints one JSON line of per-kernel numbers before the last line
(``launches`` sums the fits, ``launches_per_fit`` gives each), and
``{"ok": true, "device": {...}}`` last. Any failed check exits non-zero
before that line. Without CUDA it exits non-zero at once.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from cuda_timing import Ms, device_split, timed_ms  # noqa: E402
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
N_POINTS, DIM, MACHINES = 10_000_000, 15, 8
TABLE2 = ((25, 0.05), (100, 0.05))    # (k, epsilon), delta = 0.1
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
SOURCES = {"min_dist": "src/repro_torch/kernels/csrc/min_dist.cu",
           "remove_below": "src/repro_torch/kernels/csrc/fused_lloyd.cu",
           "update_min_dist": "src/repro_torch/kernels/csrc/fused_lloyd.cu",
           "fused_assign_reduce":
               "src/repro_torch/kernels/csrc/fused_assign.cu",
           "lloyd_reduce": "src/repro_torch/kernels/csrc/lloyd.cu",
           "sensitivity_scores":
               "src/repro_torch/kernels/csrc/sensitivity.cu",
           "truncated_cost": "src/repro_torch/kernels/csrc/truncated.cu"}
REPLACES = {"min_dist": "src/repro/kernels/min_dist.py:61",
            "remove_below": "src/repro/kernels/fused_lloyd.py:279",
            "update_min_dist": "src/repro/kernels/fused_lloyd.py:352",
            "fused_assign_reduce": "src/repro/kernels/fused_lloyd.py:138",
            "lloyd_reduce": "src/repro/kernels/lloyd.py:44",
            "sensitivity_scores": "src/repro/kernels/sensitivity.py:72",
            "truncated_cost": "src/repro/kernels/truncated.py:69"}
# remove_below's kernel also replaces the chunked-center TPU kernel
REMOVE_CHUNKED_REPLACES = "src/repro/kernels/fused_lloyd.py:757"
# The three TPU kernels the one Lloyd kernel replaces, by the regime each
# shape reaches on the TPU: resident centers up to 1024, beyond it center
# chunks whose (kp, d) accumulators fit the 6 MiB budget or do not
# (repro/kernels/ops.py's _MAX_PALLAS_K; repro/kernels/fused_lloyd.py:68,
# :586; kp is k rounded up to the reference's center chunk, 1024 at
# d <= 128: repro/kernels/tuning.py:71).
CHUNK_ACC_BUDGET = 6 * 2 ** 20
CHUNK_K = 1024
TPU_RESIDENT_K = 1024
REGIME_REPLACES = {"resident": "src/repro/kernels/fused_lloyd.py:138",
                   "single_walk": "src/repro/kernels/fused_lloyd.py:562",
                   "two_walk": "src/repro/kernels/fused_lloyd.py:673"}
# (n, d, k) of the weighing checks: k-means‖ row 1's weighing (one
# machine's 1.25 M points, 1 + 5·166 rows), row 2's at k = 100 (1 + 5·616
# rows), EIM11's clustering at n = 1 M (12·14,438 rows) on a point subset,
# the conformance grid's k beyond 1024, and a shape where min_dist splits
# the center axis into 8 slices (n <= 20,000, k >= 4,096).
LLOYD_SHAPES = ((1_250_000, DIM, 831), (1_250_000, DIM, 3_081),
                (65_536, DIM, 173_256), (20_000, DIM, 1025), (20_000, 33, 2100),
                (20_000, DIM, 4_096))
# (n, k) at d = 15 also held and timed with every launch shape: SOCCER's
# coordinator calls at both Table 2 rows, k-means‖ row 1's weighing, 1024
# centers at that n, and few centers at that n (where atomics meet on few
# rows).
DISPATCH_SHAPES = ((17_353, 103), (80_585, 190), (1_250_000, 831),
                   (1_250_000, 1024), (1_250_000, 4), (1_250_000, 25))
# Float32 times, ms, of the two Lloyd kernels this one replaced, recorded
# on the same card model (PERF.md §6; NVIDIA H100 80GB HBM3, 700 W): the
# resident kernel at k <= 1024, the chunked one beyond. Printed beside
# this run's times on a line of their own, never in the JSON line, which
# carries only this run's measurements.
REPLACED_MS = {(17_353, 103): 0.0967, (80_585, 190): 0.2411,
               (1_250_000, 831): 10.3226, (1_250_000, 1024): 12.5924,
               (1_250_000, 4): 0.1178, (1_250_000, 25): 0.3523,
               (1_250_000, 3_081): 5.2671, (65_536, 173_256): 18.9260}
# Float32 times, ms, of min_dist and remove_below on one point a thread
# (a walk since removed), recorded on the same card model before they
# moved onto the register-blocked walk (PERF.md §6; NVIDIA H100 80GB HBM3,
# 700 W): min_dist by (n, k) at d = 15, remove_below by (m, p, k).
# Printed beside this run's times on lines of their own, never in the
# JSON line.
MIN_DIST_BEFORE_MS = {(17_353, 103): 0.0260, (80_585, 190): 0.0323,
                      (1_250_000, 831): 1.3794, (1_250_000, 1024): 1.7045,
                      (1_250_000, 3_081): 5.0892,
                      (65_536, 173_256): 18.9917, (1_250_000, 4): 0.0360,
                      (1_250_000, 25): 0.0597}
REMOVE_BELOW_BEFORE_MS = {(8, 1_250_000, 103): 1.4190,
                          (8, 1_250_000, 190): 2.5446,
                          (8, 125_000, 1_111): 1.4963}
# fit_profile's device time, ms, and calls of the same kernels in a fit,
# recorded in PERF.md §5 before the walk moved, same card model: EIM11
# n = 1 M's min_dist and SOCCER k = 1000's remove_below
PROFILE_BEFORE = {("eim11", "min_dist_kernel"): (436.8, 12),
                  ("soccer", "remove_below_kernel"): (14.5, 1)}
EIM11_N, EIM11_K = 1_000_000, 25
# points of the same-seed repeat fits of SOCCER, k-means‖ and EIM11
REPEAT_N = 1_000_000
# The coreset and robust tier (ROADMAP Queue 1 items 11-13): the paper's §8
# mixture at n = 10 M, k = 25, with 2% isotropic gross outliers at 50x the
# data's RMS radius (seed 7) for the robust fits: 10.2 M points, 1,275,000
# a machine.
OUTLIER_FRAC, OUTLIER_SCALE, OUTLIER_SEED = 0.02, 50.0, 7
KZ_BUDGET = 1_640_000         # kzmeans uplink rows, both conditions
CORESET_BUDGET = 16_384       # coreset_kmeans uplink rows
K_WIDE = 1000                 # SOCCER at k = 1000: k_plus = 1,111
# (n, d, k) of lloyd_reduce's checks: kzmeans' gathered rows at k = 25
# (warp accumulators), and k = 1025 (global accumulators)
LLOYD_REDUCE_SHAPES = ((KZ_BUDGET, DIM, 25), (KZ_BUDGET, DIM, 1025))
# sensitivity_scores: one machine's shard against kb = 25 centers, and
# against SOCCER k = 1000's k_plus (global accumulators)
SENSITIVITY_SHAPES = ((1_275_000, DIM, 25), (1_275_000, DIM, 1_111))
# Float32 times, ms, of the two kernels before they moved onto the grouped
# fixed-point reduce (PERF.md §6 rows 10-11; NVIDIA H100 80GB HBM3, 700 W):
# lloyd_reduce's per-block partials at k = 25 and its ungrouped fixed-point
# kernel at k = 1025; sensitivity_scores on one point a thread at k = 25.
# Printed beside this run's times on lines of their own, never in the JSON
# line (scripts/time_reduce.py times the parent's kernels in the same call).
TIER_BEFORE_MS = {("lloyd_reduce", 25): 0.4063,
                  ("lloyd_reduce", 1025): 0.4545,
                  ("sensitivity_scores", 25): 0.0865}
# The fits' cost ratios before the two kernels moved (PERF.md §6, PR 16),
# printed beside this run's: the Lloyd sums and the masses now have other
# low bits.
COST_RATIOS_BEFORE = {"coreset_kmeans": 1.0151, "soccer_coreset": 0.8396,
                      "kzmeans_robust": 2911.14}
TRUNCATED_SHAPE = (MACHINES, 1_275_000, DIM, 25)
REMOVE_WIDE_SHAPE = (MACHINES, 125_000, DIM, 1_111)
# truncated_cost is also held at REMOVE_WIDE_SHAPE (one center slice: its
# 984 point tiles fill the card) and at 8 machines of an odd 12,501 rows
# against 1,111 centers: the center axis split in two, and every machine's
# base but the first off 16 bytes for the tiles' bulk copies, in float32
# and bfloat16 alike.
TRUNCATED_SPLIT_SHAPE = (MACHINES, 12_501, DIM, 1_111)
# Float32 ms of truncated_cost on one point a thread at TRUNCATED_SHAPE
# (PERF.md §6 row 12; NVIDIA H100 80GB HBM3, 700 W), printed beside
# this run's time on a line of its own, never in the JSON line.
TRUNCATED_BEFORE_MS = 0.4782
# the plain one-hot lloyd_reduce sums each center's rows in a float32
# matmul over 1.64 M rows, in another order than the kernel
LLOYD_PLAIN_RTOL = 1e-4
# paths of each fit -> the kernels it must launch
SOCCER_KERNELS = ("min_dist", "update_min_dist", "fused_assign_reduce",
                  "remove_below")
KMPAR_KERNELS = ("min_dist", "update_min_dist", "fused_assign_reduce")
EIM11_KERNELS = KMPAR_KERNELS
KZMEANS_KERNELS = ("min_dist", "update_min_dist", "sensitivity_scores",
                   "lloyd_reduce", "truncated_cost")
CORESET_KERNELS = ("update_min_dist", "sensitivity_scores",
                   "fused_assign_reduce")
SOCCER_CORESET_KERNELS = SOCCER_KERNELS + ("sensitivity_scores",)
SOCCER_WIDE_KERNELS = SOCCER_KERNELS


# the kernels on the register-blocked walk, whose instances print_ptxas
# reads from the build's own nvcc log: (source, kernel)
WALK_KERNELS = (("fused_assign.cu", "fused_assign_kernel"),
                ("min_dist.cu", "min_dist_kernel"),
                ("fused_lloyd.cu", "remove_below_kernel"),
                ("sensitivity.cu", "sensitivity_kernel"),
                ("truncated.cu", "truncated_kernel"))


# ... lloyd_reduce's kernel (the Lloyd step's reduce without the walk) and
# the seeding kernel, whose third template argument is its draw
PTXAS_KERNELS = WALK_KERNELS + (("lloyd.cu", "lloyd_reduce_kernel"),
                                ("fused_lloyd.cu", "seed_step_kernel"))


def print_ptxas(log: str, kernel: str) -> int:
    """One line a variant of ``kernel`` (one of PTXAS_KERNELS) from ``nvcc
    -Xptxas -v``: (point type, register row length DR, points a thread P
    or the draw on/off), registers, spill stores and loads. Returns the
    number of variants printed."""
    import re
    types = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}
    name, printed = None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN2rt\d+" + kernel
                      + r"I(f|13__nv_bfloat16|6__half)Li(\d+)EL([ib])(\d+)E",
                      line)
        if m:
            third = "P" if m.group(3) == "i" else "draw"
            name = (f"{types[m.group(1)]} DR={m.group(2)} "
                    f"{third}={m.group(4)}")
            spills = "spills not reported"
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            print(f"ptxas {kernel} {name}: {m.group(1)} registers, {spills}",
                  flush=True)
            name, printed = None, printed + 1
    return printed


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def host_note(ms: Ms) -> str:
    return f"host {ms.host_us:.1f} us a call"


def split_line(split: dict) -> str:
    if not split:
        return "not measured (the profiler saw no device time)"
    return ", ".join(f"{name} {us:.2f} us" for name, us in split.items())


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ kernel checks
#
# Tolerance: the kernel and its plain version compute the same expanded
# float32 distance ||x||^2 - 2 x.c + ||c||^2 from the same widened inputs,
# in different summation orders, so they differ by a few ulps of the
# largest term: TOL_ULPS float32 ulps of max(||x||^2) + max(||c||^2).
# Where two centers (or a point and the threshold v) are closer than that,
# the two may decide a tie differently; such points are counted as
# ambiguous and their effect is allowed for explicitly.
TOL_ULPS = 32
EPS32 = float(torch.finfo(torch.float32).eps)


def d2_tol(x: torch.Tensor, c: torch.Tensor) -> float:
    xf, cf = x.float(), c.float()
    scale = float((xf * xf).sum(-1).max()) + float((cf * cf).sum(-1).max())
    return TOL_ULPS * EPS32 * max(scale, 1.0)


def check_min_dist(ops, ref, x, c, cv):
    tol = d2_tol(x, c)
    d2_k, idx_k = ops.min_dist(x, c, cv)
    d2_p, _ = ref.min_dist_ref(x, c, cv)
    err = float((d2_k - d2_p).abs().max())
    check(err <= tol, f"min_dist d2 err {err} > {tol}")
    # argmin through the realized distance (ties may break differently)
    xf, cf = x.float(), c.float()
    ci = cf[idx_k.long()]
    real = torch.clamp((xf * xf).sum(-1) - 2.0 * (xf * ci).sum(-1)
                       + (ci * ci).sum(-1), min=0.0)
    arg_err = float((real - d2_p).abs().max())
    check(arg_err <= 2 * tol, f"min_dist argmin err {arg_err} > {2 * tol}")
    if cv is not None:
        check(bool(cv[idx_k.long()].all()), "min_dist chose an invalid center")
    return max(err, arg_err), tol


def check_update_min_dist(ops, ref, x, w, c, d2, cv):
    tol = d2_tol(x, c)
    a, ma = ops.update_min_dist(x, w, c, d2, cv)
    b, mb = ref.update_min_dist_ref(x, w, c, d2, cv)
    err = float((a - b).abs().max())
    check(err <= tol, f"update_min_dist d2 err {err} > {tol}")
    # the mass sums n products in another order: relative, plus the d2 slack
    m_tol = 1e-5 * abs(float(mb)) + tol * float(w.sum())
    m_err = abs(float(ma) - float(mb))
    check(m_err <= m_tol, f"update_min_dist mass err {m_err} > {m_tol}")
    check(bool((a <= d2).all()), "update_min_dist raised a running min-d2")
    return err, tol


FUSED_RTOL = 1e-5


def plain_fused(ref, x, w, c, cv, rows: int):
    """The plain Lloyd step and ``min_dist_ref`` over ``rows``-row chunks
    of x: ((k, d) sums, (k,) counts and () cost, each the chunks' float32
    sum, then (n,) d2 and argmin). A chunk's (rows, k) distance panel
    fits the card where a whole (n, k) one may not."""
    k, d = c.shape
    sums = torch.zeros((k, d), device=x.device)
    counts = torch.zeros(k, device=x.device)
    cost = torch.zeros((), device=x.device)
    d2s, idxs = [], []
    for i in range(0, x.shape[0], rows):
        xs, ws = x[i:i + rows], w[i:i + rows]
        s_c, n_c, cost_c = ref.fused_assign_reduce_ref(xs, ws, c, cv)
        sums, counts, cost = sums + s_c, counts + n_c, cost + cost_c
        d2_c, idx_c = ref.min_dist_ref(xs, c, cv)
        d2s.append(d2_c)
        idxs.append(idx_c)
    return sums, counts, cost, torch.cat(d2s), torch.cat(idxs)


def check_fused(ops, ref, x, w, c, cv, repeat: bool = False,
                plain_rows: int = 0):
    """The Lloyd step (one kernel at every k) against three references,
    element by element; ``repeat`` also checks that a second call gives
    the same bits, ``plain_rows`` runs the plain version over chunks of
    that many rows (``plain_fused``; all n rows at once when 0).

    1. Exact. The kernel walks the centers with min_dist's arithmetic, so
       its argmin (the wrapper's ``assign_out``) must equal
       ``ops.min_dist``'s, and its sums and counts — integer fixed-point
       sums, the same in any order — must equal
       ``ref.fixed_point_reduce_ref`` over that argmin bit for bit; its
       cost (a float32 sum in tile order) must be within FUSED_RTOL of a
       float64 sum of w·d2 over min_dist's d2.
    2. float64: the sums and counts within FUSED_RTOL of a float64
       index_add over the same argmin (what the fixed-point rounding may
       move).
    3. The plain version, whose assignment may differ from the kernel's
       at near-ties. Each point assigned differently must be
       one (its d2 to the kernel's center within 2·tol of the plain min,
       as in check_min_dist). The sums and counts are held within
       FUSED_RTOL of a float64 index_add over the plain version's
       assignment, with each such point's weight (times |x| for the sums)
       allowed on both of its centers and on no other; the float64 sums
       stand in for the plain version's float32 index_add, whose own
       rounding (~2e-5 at 1.25 M points over 4 centers, in an atomic order
       that changes from run to run) is not the kernel's to meet. The cost
       is held to the plain version's own.

    Returns the largest differences from the plain version's outputs
    (sums, counts, cost), the cost's tolerance, and the number of points
    assigned differently."""
    from repro_torch.kernels.fused_lloyd import fused_assign_reduce_cuda
    tol = d2_tol(x, c)
    k, d = c.shape
    s_k, n_k, cost_k = ops.fused_assign_reduce(x, w, c, cv)
    if repeat:
        again = fused_assign_reduce_cuda(x, w, c, cv)
        check(all(torch.equal(a, b) for a, b in
                  zip((s_k, n_k, cost_k), again)),
              f"fused_assign_reduce k={k}: a repeat call gave other bits")
    d2_m, idx_k = ops.min_dist(x, c, cv)
    own = torch.empty_like(idx_k)
    fused_assign_reduce_cuda(x, w, c, cv, assign_out=own)
    check(torch.equal(own, idx_k),
          f"fused_assign_reduce k={k}: its argmin differs from min_dist's "
          f"at {int((own != idx_k).sum())} points")
    s_e, n_e = ref.fixed_point_reduce_ref(x, w, idx_k, k)
    for what, got, want in (("sums", s_k, s_e), ("counts", n_k, n_e)):
        check(torch.equal(got, want),
              f"fused_assign_reduce k={k} {what}: "
              f"{int((got != want).sum())} elements differ from the "
              f"fixed-point emulation over min_dist's argmin")
    c64 = float((w.double() * d2_m.double()).sum())
    check(abs(float(cost_k) - c64) <= FUSED_RTOL * abs(c64),
          f"fused_assign_reduce k={k}: cost {float(cost_k)} vs float64 "
          f"{c64}")
    xd, wd = x.double(), w.double()
    wx = wd[:, None] * xd
    a_k = idx_k.long()
    s_own = torch.zeros((k, d), dtype=torch.float64,
                        device=x.device).index_add_(0, a_k, wx)
    n_own = torch.zeros(k, dtype=torch.float64,
                        device=x.device).index_add_(0, a_k, wd)
    for what, got, want in (("sums", s_k, s_own), ("counts", n_k, n_own)):
        err = (got.double() - want).abs()
        bad = err > FUSED_RTOL * want.abs() + 1e-6
        check(not bool(bad.any()),
              f"fused_assign_reduce k={k} {what}: {int(bad.sum())} elements "
              f"off its own assignment's index_add by more than "
              f"{FUSED_RTOL} of each (largest err {float(err.max())})")

    if cv is not None:
        check(float(n_k[~cv].abs().sum()) == 0.0,
              "fused_assign_reduce gave mass to an invalid center")
    s_p, n_p, cost_p, d2_p, idx_p = plain_fused(ref, x, w, c, cv,
                                                plain_rows or x.shape[0])
    moved = (idx_k != idx_p).nonzero().squeeze(1)
    slack_s = torch.zeros((k, d), dtype=torch.float64, device=x.device)
    slack_n = torch.zeros(k, dtype=torch.float64, device=x.device)
    if moved.numel():
        xf, cf = x[moved].float(), c.float()[a_k[moved]]
        real = torch.clamp((xf * xf).sum(-1) - 2.0 * (xf * cf).sum(-1)
                           + (cf * cf).sum(-1), min=0.0)
        gap = float((real - d2_p[moved]).abs().max())
        check(gap <= 2 * tol, f"fused_assign_reduce k={k}: a point assigned "
                              f"differently is {gap} from its min > {2 * tol}")
        for a in (a_k[moved], idx_p[moved].long()):
            slack_s.index_add_(0, a, wx[moved].abs())
            slack_n.index_add_(0, a, wd[moved])
    a_p = idx_p.long()
    s_own_p = torch.zeros((k, d), dtype=torch.float64,
                          device=x.device).index_add_(0, a_p, wx)
    n_own_p = torch.zeros(k, dtype=torch.float64,
                          device=x.device).index_add_(0, a_p, wd)
    errs = {}
    for what, got, plain, slack, exact in (
            ("sums", s_k, s_p, slack_s, s_own_p),
            ("counts", n_k, n_p, slack_n, n_own_p)):
        err = (got.double() - exact).abs()
        bad = err > FUSED_RTOL * exact.abs() + slack + 1e-6
        check(not bool(bad.any()),
              f"fused_assign_reduce k={k} {what}: {int(bad.sum())} elements "
              f"off the plain version's assignment beyond each center's "
              f"tie slack (largest err {float(err.max())})")
        errs[what] = float((got.double() - plain.double()).abs().max())
    errs["cost"] = abs(float(cost_k) - float(cost_p))
    t_c = FUSED_RTOL * abs(float(cost_p)) + tol * float(w.sum())
    check(errs["cost"] <= t_c,
          f"fused_assign_reduce cost err {errs['cost']} > {t_c}")
    return errs, t_c, int(moved.numel())


def fused_line(errs, t_c, moved) -> str:
    return (f"sums_err={errs['sums']:.3g} counts_err={errs['counts']:.3g} "
            f"cost_err={errs['cost']:.3g} (cost tol {t_c:.3g}; argmin = "
            f"min_dist's, sums and counts = the fixed-point emulation bit "
            f"for bit, plain version within each center's tie slack) "
            f"moved={moved}")


def check_remove_below(ops, ref, x, c, alive, v, cv):
    """remove_below exactly against min_dist's own d2 (the two share the
    walk: the mask is ``alive & (d2 > v)`` bit for bit and the counts are
    its row sums), then against its plain version, which may decide the
    points within tol of v the other way."""
    m, p, d = x.shape
    tol = d2_tol(x.reshape(m * p, d)[:1_000_000], c)
    a_k, l_k = ops.remove_below(x, c, alive, v, cv)
    d2_m, _ = ops.min_dist(x.reshape(m * p, d), c, cv)
    want = alive & (d2_m.reshape(m, p) > v)
    check(torch.equal(a_k, want),
          f"remove_below's mask differs from alive & (min_dist's d2 > v) at "
          f"{int((a_k != want).sum())} points")
    check(torch.equal(l_k, want.sum(1, dtype=torch.int32)),
          "remove_below counts differ from the mask's row sums")
    del d2_m, want
    a_p, _ = ref.remove_below_ref(x, c, alive, v, cv)
    flips = (a_k != a_p).nonzero()
    err = 0.0
    if flips.numel():
        # a flipped point is one whose d2 lies within tol of v
        xs = x[flips[:, 0], flips[:, 1]]
        d2_f, _ = ref.min_dist_ref(xs, c, cv)
        err = float((d2_f - v).abs().max())
    check(err <= tol, f"remove_below flipped a point {err} from v > {tol}")
    return err, tol, int(flips.shape[0])


def kernel_phase(ops, ref, consts):
    """Check every kernel at the main-path shapes; time them at row 1's."""
    gen = torch.Generator("cuda").manual_seed(0)
    dev = "cuda"
    rows = {}

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def note(name, err):
        rows.setdefault(name, {"max_abs_err": 0.0})
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)

    x_all = rand(MACHINES, N_POINTS // MACHINES, DIM)
    for const in consts:
        eta, kp = const.eta, const.k_plus
        c = rand(kp, DIM)
        cv = rand(kp) > 0.3
        cv[0] = True
        w = rand(eta)
        w[: eta // 5] = 0.0                       # padding rows
        for dt in DTYPES:
            x = x_all.reshape(-1, DIM)[:eta].to(dt).contiguous()
            for mask in (None, cv):
                err, tol = check_min_dist(ops, ref, x, c, mask)
                note("min_dist", err)
                print(f"check min_dist n={eta} k={kp} {dt} mask="
                      f"{mask is not None} max_abs_err={err:.3g} "
                      f"tol={tol:.3g}")
                d2 = rand(eta) * DIM
                err, tol = check_update_min_dist(ops, ref, x, w, c[:1], d2,
                                                 None if mask is None
                                                 else mask[:1])
                note("update_min_dist", err)
                print(f"check update_min_dist n={eta} kc=1 {dt} mask="
                      f"{mask is not None} max_abs_err={err:.3g} "
                      f"tol={tol:.3g}")
                errs, t_c, moved = check_fused(ops, ref, x, w, c, mask)
                note("fused_assign_reduce", max(errs.values()))
                print(f"check fused_assign_reduce n={eta} k={kp} {dt} mask="
                      f"{mask is not None} " + fused_line(errs, t_c, moved))
            # all-invalid seeding block: an exact no-op on d2
            d2 = rand(eta)
            a, mass = ops.update_min_dist(x, w, c[:3], d2,
                                          torch.zeros(3, dtype=torch.bool,
                                                      device=dev))
            check(torch.equal(a, d2),
                  "update_min_dist all-invalid not a no-op")
            check(abs(float(mass) - float((w * d2).sum()))
                  <= 1e-5 * float((w * d2).sum()), "all-invalid mass")
            # zero weights: every reduction exactly zero
            w0 = torch.zeros_like(w)
            s, n, cost = ops.fused_assign_reduce(x, w0, c)
            check(float(s.abs().max()) == 0.0 and float(n.abs().max()) == 0.0
                  and float(cost) == 0.0, "fused_assign_reduce zero weights")
            _, mass = ops.update_min_dist(x, w0, c[:1], d2)
            check(float(mass) == 0.0, "update_min_dist zero weights")
        # removal over all m machines of the 10 M points
        alive = rand(MACHINES, N_POINTS // MACHINES) > 0.1
        sample, _ = ref.min_dist_ref(x_all.reshape(-1, DIM)[:200_000], c)
        srt = torch.sort(sample).values
        v_mid = 0.5 * (srt[len(srt) // 2] + srt[len(srt) // 2 + 1])
        for dt in DTYPES:
            xm = x_all.to(dt)
            for v in (torch.zeros((), device=dev), v_mid):
                for mask in (None, cv):
                    err, tol, nflip = check_remove_below(ops, ref, xm, c,
                                                         alive, v, mask)
                    note("remove_below", err)
                    print(f"check remove_below m={MACHINES} "
                          f"p={N_POINTS // MACHINES} k={kp} {dt} "
                          f"v={float(v):.4g}"
                          f" mask={mask is not None} exact=min_dist's "
                          f"flips={nflip} max_abs_err={err:.3g} "
                          f"tol={tol:.3g}")
            del xm
        # no valid center: +inf and index 0, and nothing removed
        none = torch.zeros(kp, dtype=torch.bool, device=dev)
        xs = x_all[:, :20_000].contiguous()
        few = alive[:, :20_000].contiguous()
        d2n, idxn = ops.min_dist(xs.reshape(-1, DIM), c, none)
        an, ln = ops.remove_below(xs, c, few, v_mid, none)
        check(bool(torch.isinf(d2n).all()) and int(idxn.abs().max()) == 0
              and torch.equal(an, few)
              and torch.equal(ln, an.sum(1, dtype=torch.int32)),
              "min_dist / remove_below with no valid center")
        torch.cuda.synchronize()

    # times at every main-path shape (float32), row 1 kept for the JSON line
    for ci, const in enumerate(consts):
        eta, kp = const.eta, const.k_plus
        x = x_all.reshape(-1, DIM)[:eta].contiguous()
        c = rand(kp, DIM)
        w = rand(eta)
        d2 = rand(eta) * DIM
        alive = torch.ones(MACHINES, N_POINTS // MACHINES, dtype=torch.bool,
                           device=dev)
        v = torch.tensor(0.05, device=dev)
        n_all = N_POINTS
        cases = {
            "min_dist": (lambda: ops.min_dist(x, c),
                         lambda: ref.min_dist_ref(x, c),
                         lambda: torch.cdist(x, c),
                         eta * DIM * 4 + kp * DIM * 4 + eta * 8,
                         2.0 * eta * kp * DIM, f"n={eta} k={kp}"),
            "update_min_dist": (lambda: ops.update_min_dist(x, w, c[:1], d2),
                                lambda: ref.update_min_dist_ref(x, w, c[:1],
                                                                d2),
                                lambda: torch.cdist(x, c[:1]),
                                eta * DIM * 4 + 3 * eta * 4 + DIM * 4 + 4,
                                2.0 * eta * DIM + 2.0 * eta,
                                f"n={eta} kc=1"),
            "fused_assign_reduce": (
                lambda: ops.fused_assign_reduce(x, w, c),
                lambda: ref.fused_assign_reduce_ref(x, w, c),
                lambda: torch.cdist(x, c),
                eta * DIM * 4 + eta * 4 + kp * DIM * 4
                + (kp * DIM + kp + 1) * 4,
                2.0 * eta * kp * DIM + 2.0 * eta * DIM, f"n={eta} k={kp}"),
            "remove_below": (
                lambda: ops.remove_below(x_all, c, alive, v),
                lambda: ref.remove_below_ref(x_all, c, alive, v),
                lambda: torch.cdist(x_all.reshape(-1, DIM), c),
                n_all * DIM * 4 + 2 * n_all + kp * DIM * 4 + 4
                + MACHINES * 4,
                2.0 * n_all * kp * DIM,
                f"m={MACHINES} p={N_POINTS // MACHINES} k={kp}"),
        }
        for name, (kern, plain, lib, nbytes, flops, shape) in cases.items():
            ms = timed_ms(kern)
            plain_ms = timed_ms(plain, reps=5)
            lib_ms = timed_ms(lib, reps=5)
            bnd, by = bound_ms(nbytes, flops)
            print(f"time {name} {shape} f32: kernel {ms:.4f} ms "
                  f"({host_note(ms)}), plain {plain_ms:.4f} ms, torch.cdist "
                  f"{lib_ms:.4f} ms, bound {bnd:.4f} ms ({by}; "
                  f"{100 * bnd / ms:.1f}% of it)")
            before = (MIN_DIST_BEFORE_MS.get((eta, kp)) if name == "min_dist"
                      else REMOVE_BELOW_BEFORE_MS.get(
                          (MACHINES, N_POINTS // MACHINES, kp))
                      if name == "remove_below" else None)
            if before is not None:
                print(f"recorded {name} {shape}: one point a thread "
                      f"{before:.4f} ms (PERF.md, not this run); "
                      f"this run {ms:.4f} ms ({before / ms:.2f}x)")
            if name == "remove_below":
                xf = x_all.reshape(-1, DIM)
                md_ms = timed_ms(lambda: ops.min_dist(xf, c))
                print(f"time remove_below {shape} vs min_dist on the same "
                      f"{N_POINTS} points and {kp} centers: {ms:.4f} vs "
                      f"{md_ms:.4f} ms ({ms / md_ms:.3f}x)")
                if ci == 0:
                    rows[name].update(min_dist_ms=md_ms)
                del xf
            if ci == 0:
                rows[name].update(ms=ms, host_us=ms.host_us,
                                  plain_ms=plain_ms, bound_ms=bnd,
                                  bound_by=by, library_ms=None,
                                  yardstick="torch.cdist", yardstick_ms=lib_ms,
                                  shape=shape)
    del x_all
    torch.cuda.empty_cache()
    return rows


# (n, d, k) off the main path's shape: d = 37 and 513 run the any-width
# variant (the row re-read from L1) with several center tiles (221 and 15
# centers a tile), and k = 1024 at d = 15 takes two tiles of 512.
WIDTH_SHAPES = ((20_000, 37, 300), (20_000, 513, 190), (20_000, 15, 1024))


def width_phase(ops, ref, rows) -> None:
    """Every kernel against its plain version at the WIDTH_SHAPES, with the
    same tolerances as at the main path's shapes; the errors join each
    kernel's max_abs_err in ``rows``."""
    gen = torch.Generator("cuda").manual_seed(2)
    for n, d, k in WIDTH_SHAPES:
        x32 = torch.rand((n, d), generator=gen, device="cuda")
        c = torch.rand((k, d), generator=gen, device="cuda")
        cv = torch.rand(k, generator=gen, device="cuda") > 0.3
        cv[0] = True
        w = torch.rand(n, generator=gen, device="cuda")
        w[: n // 5] = 0.0
        d2_0 = torch.rand(n, generator=gen, device="cuda") * d
        alive = torch.rand((2, n // 2), generator=gen, device="cuda") > 0.1
        for dt in DTYPES:
            x = x32.to(dt)
            for mask in (None, cv):
                errs = {
                    "min_dist": check_min_dist(ops, ref, x, c, mask)[0],
                    "update_min_dist": check_update_min_dist(
                        ops, ref, x, w, c, d2_0, mask)[0],
                    "fused_assign_reduce": max(check_fused(
                        ops, ref, x, w, c, mask)[0].values())}
                d2, _ = ref.min_dist_ref(x, c, mask)
                v = torch.median(d2)
                errs["remove_below"] = check_remove_below(
                    ops, ref, x.reshape(2, n // 2, d), c, alive, v, mask)[0]
                for name, err in errs.items():
                    rows[name]["max_abs_err"] = max(
                        rows[name]["max_abs_err"], err)
                print(f"check widths n={n} d={d} k={k} {dt} mask="
                      f"{mask is not None} max_abs_err="
                      + " ".join(f"{nm}:{e:.3g}" for nm, e in errs.items()),
                      flush=True)
    torch.cuda.synchronize()


def regime(k: int, d: int) -> str:
    """The TPU kernel a (k, d) center set reaches: the resident one up to
    TPU_RESIDENT_K centers; beyond, the single walk while its accumulators
    fit the 6 MiB budget, else the two-walk fallback."""
    if k <= TPU_RESIDENT_K:
        return "resident"
    kp = -(-k // CHUNK_K) * CHUNK_K
    return ("single_walk" if kp * (d + 1) * 4 <= CHUNK_ACC_BUDGET
            else "two_walk")


def lloyd_bound(n: int, d: int, k: int):
    """The Lloyd step's bound: points, weights and centers read once, the
    sums, counts and cost written once; 2·n·k·d + 2·n·d float32
    operations."""
    return bound_ms(n * d * 4 + n * 4 + k * d * 4 + (k * d + k + 1) * 4,
                    2.0 * n * k * d + 2.0 * n * d)


def min_dist_bound(n: int, d: int, k: int):
    """min_dist's bound: points and centers read once, the (n,) d2 and
    argmin written once; 2·n·k·d float32 operations."""
    return bound_ms(n * d * 4 + k * d * 4 + n * 8, 2.0 * n * k * d)


def min_dist_launch(n: int, d: int, k: int) -> str:
    from repro_torch.kernels import walk
    ppt = walk.points_per_thread(d)
    sms = walk.sm_count(torch.device("cuda"))
    return f"ppt={ppt} slices={walk.center_slices(n, k, sms, ppt)}"


def time_lloyd(ops, x32, c):
    """Float32 times at one shape, every center valid and unit weights, as
    the weighing passes run: the Lloyd kernel and the min_dist kernel on
    the same inputs, each beside its bound. Returns the dict for the JSON
    line and prints one line for each, then the replaced kernels' and
    min_dist's recorded times (REPLACED_MS, MIN_DIST_BEFORE_MS) on lines
    of their own."""
    from repro_torch.kernels import fused_lloyd as fl
    from repro_torch.kernels import walk
    n, d = x32.shape
    k = c.shape[0]
    ones = torch.ones(n, device="cuda")
    torch.cuda.empty_cache()
    ms = timed_ms(lambda: ops.fused_assign_reduce(x32, ones, c))
    md_ms = timed_ms(lambda: ops.min_dist(x32, c))
    ppt = fl.points_per_thread(k, d)
    launch = (f"ppt={ppt} acc={fl.acc_mode(k, d)} slices="
              f"{walk.center_slices(n, k, walk.sm_count(x32.device), ppt)}")
    bnd, by = lloyd_bound(n, d, k)
    md_bnd, md_by = min_dist_bound(n, d, k)
    print(f"time fused_assign_reduce n={n} k={k} ({regime(k, d)}) f32: "
          f"kernel {ms:.4f} ms ({launch}; {host_note(ms)}), min_dist "
          f"{md_ms:.4f} ms ({host_note(md_ms)}), bound "
          f"{bnd:.4f} ms ({by}; {100 * bnd / ms:.1f}% of it)", flush=True)
    print(f"time min_dist n={n} k={k} f32: {md_ms:.4f} ms "
          f"({min_dist_launch(n, d, k)}), bound {md_bnd:.4f} ms ({md_by}; "
          f"{100 * md_bnd / md_ms:.1f}% of it, aim 50%: "
          f"{'met' if md_bnd / md_ms >= 0.5 else 'missed'}); the Lloyd "
          f"kernel on the same inputs {ms:.4f} ms: min_dist "
          f"{'no slower' if md_ms <= ms else 'slower'} "
          f"({md_ms / ms:.3f}x)", flush=True)
    before = REPLACED_MS.get((n, k))
    if before is not None:
        print(f"recorded fused_assign_reduce n={n} k={k}: the replaced "
              f"kernel's time {before:.4f} ms (PERF.md, not this run) is "
              f"{before / ms:.2f}x this run's {ms:.4f} ms", flush=True)
    before = MIN_DIST_BEFORE_MS.get((n, k))
    if before is not None:
        print(f"recorded min_dist n={n} k={k}: one point a thread "
              f"{before:.4f} ms (PERF.md, not this run); this run "
              f"{md_ms:.4f} ms ({before / md_ms:.2f}x)", flush=True)
    return dict(shape=f"n={n} d={d} k={k}", launch=launch, ms=ms,
                host_us=ms.host_us, min_dist_ms=md_ms,
                min_dist_host_us=md_ms.host_us, bound_ms=bnd, bound_by=by,
                share_of_bound=bnd / ms, min_dist_bound_ms=md_bnd,
                min_dist_share_of_bound=md_bnd / md_ms)


def lloyd_phase(ops, ref, rows) -> None:
    """The Lloyd kernel at LLOYD_SHAPES, in three dtypes, with invalid
    centers and zero weights (check_fused, with a same-bits repeat;
    all-zero weights give exact zeros; its argmin equals min_dist's);
    min_dist against its plain version on the same points (float32 only
    at 173,256 centers); the weighing shapes timed (time_lloyd). The
    three TPU regimes' timings go on the kernel's JSON row, min_dist's
    beside them on its own."""
    gen = torch.Generator("cuda").manual_seed(3)
    name = "fused_assign_reduce"
    regimes = []
    for n, d, k in LLOYD_SHAPES:
        x32 = torch.rand((n, d), generator=gen, device="cuda")
        c = torch.rand((k, d), generator=gen, device="cuda")
        cv = torch.rand(k, generator=gen, device="cuda") > 0.3
        cv[0] = True
        w = torch.rand(n, generator=gen, device="cuda")
        w[: n // 5] = 0.0
        reg = regime(k, d)
        shape_err = 0.0
        for dt in DTYPES:
            x = x32.to(dt)
            for mask in (None, cv):
                errs, t_c, moved = check_fused(ops, ref, x, w, c, mask,
                                               repeat=True)
                shape_err = max(shape_err, *errs.values())
                print(f"check {name} n={n} d={d} k={k} ({reg}) {dt} "
                      f"mask={mask is not None} "
                      + fused_line(errs, t_c, moved)
                      + " repeat=same bits", flush=True)
                if n * k <= 10 ** 9:     # min_dist, split or not
                    err, tol = check_min_dist(ops, ref, x, c, mask)
                    rows["min_dist"]["max_abs_err"] = max(
                        rows["min_dist"]["max_abs_err"], err)
                    print(f"check min_dist n={n} d={d} k={k} "
                          f"({min_dist_launch(n, d, k)}) {dt} mask="
                          f"{mask is not None} max_abs_err={err:.3g} "
                          f"tol={tol:.3g}; argmin = the Lloyd kernel's "
                          f"assign_out", flush=True)
            zero = ops.fused_assign_reduce(x, torch.zeros_like(w), c, cv)
            check(all(float(t.abs().max()) == 0.0 for t in zero),
                  f"{name} k={k} {dt}: zero weights")
            del x
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], shape_err)
        if k > 100_000:                  # min_dist at EIM11's clustering
            for mask in (None, cv):
                err, tol = check_min_dist(ops, ref, x32, c, mask)
                rows["min_dist"]["max_abs_err"] = max(
                    rows["min_dist"]["max_abs_err"], err)
                print(f"check min_dist n={n} k={k} "
                      f"({min_dist_launch(n, d, k)}) mask={mask is not None} "
                      f"max_abs_err={err:.3g} tol={tol:.3g}", flush=True)
        if n >= 65_536:                  # the weighing shapes
            ones = torch.ones(n, device="cuda")
            plain_ms = timed_ms(lambda: ref.fused_assign_reduce_ref(
                x32, ones, c), reps=5)
            lib_ms = timed_ms(lambda: torch.cdist(x32, c), reps=5)
            timing = time_lloyd(ops, x32, c)
            timing.update(regime=reg, replaces=REGIME_REPLACES[reg],
                          plain_ms=plain_ms, library_ms=None,
                          yardstick="torch.cdist", yardstick_ms=lib_ms,
                          max_abs_err=shape_err)
            print(f"time {name} n={n} k={k} plain {plain_ms:.4f} ms, "
                  f"torch.cdist {lib_ms:.4f} ms", flush=True)
            regimes.append(timing)
            rows["min_dist"].setdefault("weighing", []).append(dict(
                shape=timing["shape"], ms=timing["min_dist_ms"],
                bound_ms=timing["min_dist_bound_ms"],
                share_of_bound=timing["min_dist_share_of_bound"],
                lloyd_ms=timing["ms"], launch=min_dist_launch(n, d, k)))
            del ones
        del x32, c, cv, w
    check({r["regime"] for r in regimes} == set(REGIME_REPLACES),
          "the Lloyd checks did not cover all three TPU regimes")
    rows[name]["regimes"] = regimes
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def dispatch_phase(ops, ref, rows) -> None:
    """The Lloyd kernel at DISPATCH_SHAPES (d = 15): held in three dtypes,
    with and without the mask, with zero weights and a same-bits repeat
    (check_fused), then timed (time_lloyd) beside min_dist and the
    kernels it replaced."""
    gen = torch.Generator("cuda").manual_seed(5)
    out = []
    for n, k in DISPATCH_SHAPES:
        x32 = torch.rand((n, DIM), generator=gen, device="cuda")
        c = torch.rand((k, DIM), generator=gen, device="cuda")
        cv = torch.rand(k, generator=gen, device="cuda") > 0.3
        cv[0] = True
        w = torch.rand(n, generator=gen, device="cuda")
        w[: n // 5] = 0.0
        for dt in DTYPES:
            x = x32.to(dt)
            for mask in (None, cv):
                errs, t_c, moved = check_fused(ops, ref, x, w, c, mask,
                                               repeat=True)
                rows["fused_assign_reduce"]["max_abs_err"] = max(
                    rows["fused_assign_reduce"]["max_abs_err"],
                    *errs.values())
            zero = ops.fused_assign_reduce(x, torch.zeros_like(w), c, cv)
            check(all(float(t.abs().max()) == 0.0 for t in zero),
                  f"fused_assign_reduce n={n} k={k} {dt}: zero weights")
            del x
        print(f"check fused_assign_reduce n={n} k={k} (3 dtypes, mask "
              f"and none, zero weights): argmin = min_dist's, sums and "
              f"counts = the fixed-point emulation, repeat=same bits, "
              f"plain version within the tie slack and its own float32 "
              f"error", flush=True)
        out.append(time_lloyd(ops, x32, c))
        del x32, c, cv, w
    rows["fused_assign_reduce"]["dispatch"] = out
    torch.cuda.empty_cache()


# ----------------------------------------------- coreset and robust kernels

def check_lloyd_reduce(ops, ref, x, w, a, k, c, cv):
    """lloyd_reduce exactly against the fixed-point emulation
    (``ref.fixed_point_reduce_ref``) over the same assignment and against
    the Lloyd kernel's sums and counts over centers ``c`` (mask ``cv``)
    given that kernel's own argmin, both bit for bit; against a float64
    index_add over the same assignment (to FUSED_RTOL of each element: the
    reduction itself) and against its plain version (to
    LLOYD_PLAIN_RTOL); a repeat call gives the same bits and all-zero
    weights give exact zeros. Returns the largest difference from the
    plain version."""
    from repro_torch.kernels.fused_lloyd import fused_assign_reduce_cuda
    d = x.shape[1]
    s_k, n_k = ops.lloyd_reduce(x, w, a, k)
    again = ops.lloyd_reduce(x, w, a, k)
    check(torch.equal(s_k, again[0]) and torch.equal(n_k, again[1]),
          f"lloyd_reduce k={k}: a repeat call gave other bits")
    s_e, n_e = ref.fixed_point_reduce_ref(x, w, a, k)
    for what, got, want in (("sums", s_k, s_e), ("counts", n_k, n_e)):
        check(torch.equal(got, want),
              f"lloyd_reduce k={k} {what}: {int((got != want).sum())} "
              f"elements differ from the fixed-point emulation")
    own = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    s_f, n_f, _ = fused_assign_reduce_cuda(x, w, c, cv, assign_out=own)
    s_o, n_o = ops.lloyd_reduce(x, w, own, k)
    for what, got, want in (("sums", s_o, s_f), ("counts", n_o, n_f)):
        check(torch.equal(got, want),
              f"lloyd_reduce k={k} {what}: {int((got != want).sum())} "
              f"elements differ from the Lloyd kernel's given its argmin")
    del s_f, n_f, s_o, n_o, own
    ok = (a >= 0) & (a < k)
    al = a[ok].long()
    wd = w[ok].double()
    s64 = torch.zeros((k, d), dtype=torch.float64, device=x.device
                      ).index_add_(0, al, wd[:, None] * x[ok].double())
    n64 = torch.zeros(k, dtype=torch.float64, device=x.device
                      ).index_add_(0, al, wd)
    s_p, n_p = ref.lloyd_reduce_ref(x, w, a, k)
    err = 0.0
    for what, got, want, plain in (("sums", s_k, s64, s_p),
                                   ("counts", n_k, n64, n_p)):
        e = (got.double() - want).abs()
        check(bool((e <= FUSED_RTOL * want.abs() + 1e-6).all()),
              f"lloyd_reduce k={k} {what}: off a float64 index_add by "
              f"{float(e.max())}")
        e = (got.double() - plain.double()).abs()
        check(bool((e <= LLOYD_PLAIN_RTOL * plain.double().abs()
                    + 1e-5).all()),
              f"lloyd_reduce k={k} {what}: off the plain version by "
              f"{float(e.max())}")
        err = max(err, float(e.max()))
    zero = ops.lloyd_reduce(x, torch.zeros_like(w), a, k)
    check(all(float(t.abs().max()) == 0.0 for t in zero),
          f"lloyd_reduce k={k}: zero weights")
    return err


def check_sensitivity(ops, ref, x, w, c, cv):
    """sensitivity_scores against min_dist's own argmin and d2 (the kernel
    shares its walk: the same assignment and scores bit for bit), its
    masses against exact_index_add over that argmin (bit for bit), and a
    float64 sum of the masses and cost, then against its plain
    version: scores within tol·w, the cost within FUSED_RTOL plus the d2
    slack, each mass within FUSED_RTOL of a float64 sum over the plain
    version's assignment plus the weight of the near-tie points assigned
    differently (as in check_fused). A repeat call gives the same
    bits."""
    from repro_torch.kernels.exact import exact_index_add
    tol = d2_tol(x, c)
    k = c.shape[0]
    out = ops.sensitivity_scores(x, w, c, cv)
    again = ops.sensitivity_scores(x, w, c, cv)
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          "sensitivity_scores: a repeat call gave other bits")
    sc, asg, mass, cost = out
    d2, idx = ops.min_dist(x, c, cv)
    check(torch.equal(asg, idx), "sensitivity_scores: not min_dist's argmin")
    check(torch.equal(sc, w * d2), "sensitivity_scores: scores != w * d2")
    want = exact_index_add(w, idx, k)
    check(torch.equal(mass, want),
          f"sensitivity_scores: {int((mass != want).sum())} masses differ "
          f"from exact_index_add over min_dist's argmin")
    wd = w.double()
    m64 = torch.zeros(k, dtype=torch.float64, device=x.device
                      ).index_add_(0, idx.long(), wd)
    e = (mass.double() - m64).abs()
    check(bool((e <= FUSED_RTOL * m64 + 1e-6).all()),
          f"sensitivity_scores mass off a float64 index_add by "
          f"{float(e.max())}")
    c64 = float((wd * d2.double()).sum())
    check(abs(float(cost) - c64) <= FUSED_RTOL * abs(c64),
          f"sensitivity_scores cost {float(cost)} != {c64}")
    if cv is not None:
        check(float(mass[~cv].abs().sum()) == 0.0,
              "sensitivity_scores gave mass to an invalid center")

    sc_p, asg_p, mass_p, cost_p = ref.sensitivity_scores_ref(x, w, c, cv)
    s_err = float((sc - sc_p).abs().max())
    check(bool(((sc - sc_p).abs() <= tol * w + 1e-12).all()),
          f"sensitivity_scores: a score off the plain one by more than "
          f"tol·w (largest {s_err})")
    t_c = FUSED_RTOL * abs(float(cost_p)) + tol * float(w.sum())
    c_err = abs(float(cost) - float(cost_p))
    check(c_err <= t_c, f"sensitivity_scores cost err {c_err} > {t_c}")
    moved = (asg != asg_p).nonzero().squeeze(1)
    slack = torch.zeros(k, dtype=torch.float64, device=x.device)
    for a in (asg[moved].long(), asg_p[moved].long()):
        slack.index_add_(0, a, wd[moved])
    m64_p = torch.zeros(k, dtype=torch.float64, device=x.device
                        ).index_add_(0, asg_p.long(), wd)
    e = (mass.double() - m64_p).abs()
    check(bool((e <= FUSED_RTOL * m64_p + slack + 1e-6).all()),
          f"sensitivity_scores mass off the plain version's assignment "
          f"beyond the tie slack (largest {float(e.max())})")
    m_err = float((mass.double() - mass_p.double()).abs().max())
    return max(s_err, c_err, m_err), tol, int(moved.numel())


def check_truncated(ops, ref, x3, w2, c, cv, v):
    """truncated_cost over (m, p, d) shards against float64 sums over
    min_dist's own d2 (the kernel shares its distance code, so the split
    is exact) and against its plain version, which may put the points
    within tol of v on the other side: their weight and cost are the
    slack. A repeat call gives the same bits."""
    m, p, d = x3.shape
    tol = d2_tol(x3.reshape(m * p, d)[:1_000_000], c)
    out = ops.truncated_cost(x3, w2, c, v, cv)
    again = ops.truncated_cost(x3, w2, c, v, cv)
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          "truncated_cost: a repeat call gave other bits")
    d2, _ = ops.min_dist(x3.reshape(m * p, d), c, cv)
    dd, wd = d2.double().reshape(m, p), w2.double()
    below = dd <= float(v)
    s = torch.where(wd > 0, wd * dd, 0.0)
    want = (torch.where(below, s, 0.0).sum(1),
            torch.where(below, 0.0, wd).sum(1),
            torch.where(below, 0.0, s).sum(1))
    for what, got, w64 in zip(("kept", "tail mass", "tail cost"), out, want):
        e = (got.double() - w64).abs()
        check(bool((e <= FUSED_RTOL * w64.abs() + 1e-6).all()),
              f"truncated_cost {what} off a float64 sum by {float(e.max())}")
    plain = ref.truncated_cost_ref(x3, w2, c, v, cv)
    d2_p, _ = ref.min_dist_ref(x3.reshape(m * p, d), c, cv)
    near = ((d2_p.reshape(m, p) - v).abs() <= tol).double()
    slack = (near * s.abs()).sum(1), (near * wd).sum(1), (near * s.abs()).sum(1)
    err = 0.0
    for what, got, want_p, sl in zip(("kept", "tail mass", "tail cost"), out,
                                     plain, slack):
        e = (got.double() - want_p.double()).abs()
        bound = (FUSED_RTOL * want_p.double().abs() + sl
                 + tol * wd.sum(1) + 1e-6)
        check(bool((e <= bound).all()),
              f"truncated_cost {what} off the plain version beyond the "
              f"near-v slack (largest {float(e.max())})")
        err = max(err, float(e.max()))
    zero = ops.truncated_cost(x3, torch.zeros_like(w2), c, v, cv)
    check(all(float(t.abs().max()) == 0.0 for t in zero),
          "truncated_cost: zero weights fell on a side")
    return err, tol, int(near.sum())


def tier_phase(ops, ref, rows) -> None:
    """The coreset and robust tier's kernels, and remove_below beyond the
    resident limit, against their plain versions at that tier's shapes in
    three dtypes, with invalid centers and zero weights; float32 timings
    of kernel, plain version and the closest PyTorch call(s)."""
    from repro_torch.kernels.exact import exact_index_add
    from repro_torch.kernels.fused_lloyd import acc_mode
    gen = torch.Generator("cuda").manual_seed(6)
    dev = "cuda"

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def note(name, err, **timing):
        row = rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row.update(timing)

    def timing(kern, plain, lib, nbytes, flops, shape, lib_name):
        ms = timed_ms(kern)
        plain_ms = timed_ms(plain, reps=5)
        lib_ms = timed_ms(lib, reps=5)
        bnd, by = bound_ms(nbytes, flops)
        print(f"time {shape} f32: kernel {ms:.4f} ms ({host_note(ms)}), "
              f"plain {plain_ms:.4f} ms, {lib_name} {lib_ms:.4f} ms, bound "
              f"{bnd:.4f} ms ({by})", flush=True)
        return dict(ms=ms, host_us=ms.host_us, plain_ms=plain_ms,
                    bound_ms=bnd, bound_by=by, shape=shape), lib_ms

    # lloyd_reduce: kzmeans' gathered rows, assigned by min_dist to centers
    # of which some are invalid (so no row goes to an invalid center)
    for n, d, k in LLOYD_REDUCE_SHAPES:
        x32 = rand(n, d)
        c = rand(k, d)
        cv = rand(k) > 0.3
        cv[0] = True
        w = rand(n)
        w[: n // 5] = 0.0
        _, a = ops.min_dist(x32, c, cv)
        for dt in DTYPES:
            err = check_lloyd_reduce(ops, ref, x32.to(dt), w, a, k, c, cv)
            note("lloyd_reduce", err)
            print(f"check lloyd_reduce n={n} d={d} k={k} {dt} "
                  f"max_abs_err={err:.3g} (= the fixed-point emulation and "
                  f"the Lloyd kernel's sums given its argmin, bit for bit; "
                  f"float64 index_add within {FUSED_RTOL}, plain within "
                  f"{LLOYD_PLAIN_RTOL}) repeat=same bits", flush=True)
        wx = x32 * w[:, None]
        al = a.long()
        mode = acc_mode(k, d)
        t, lib_ms = timing(
            lambda: ops.lloyd_reduce(x32, w, a, k),
            lambda: ref.lloyd_reduce_ref(x32, w, a, k),
            lambda: (torch.zeros((k, d), device=dev).index_add_(
                0, al, wx), torch.bincount(al, weights=w, minlength=k)),
            n * d * 4 + 2 * n * 4 + (k * d + k) * 4, 2.0 * n * d + n,
            f"lloyd_reduce n={n} d={d} k={k} ({mode} accumulators)",
            "index_add_+bincount")
        # the bound pass reads x and w once more before the reduce
        floor, _ = bound_ms(2 * (n * d * 4 + n * 4) + n * 4
                            + (k * d + k) * 4, 0.0)
        split = device_split(lambda: ops.lloyd_reduce(x32, w, a, k))
        bound_us = sum(us for nm, us in split.items() if "bound_kernel" in nm)
        total_us = sum(split.values())
        print(f"time lloyd_reduce n={n} d={d} k={k} device split a call: "
              f"{split_line(split)}; bound pass {bound_us:.2f} us"
              + (f" ({100 * bound_us / total_us:.1f}% of {total_us:.2f} us)"
                 if total_us else "")
              + f"; two-read floor {floor:.4f} ms", flush=True)
        before = TIER_BEFORE_MS[("lloyd_reduce", k)]
        print(f"recorded lloyd_reduce n={n} d={d} k={k}: before the grouped "
              f"reduce {before:.4f} ms (PERF.md, not this run); this run "
              f"{t['ms']:.4f} ms ({before / t['ms']:.2f}x)", flush=True)
        row = dict(library_ms=lib_ms, acc_mode=mode,
                   bound_pass_us=bound_us, device_split_us=split,
                   library="index_add_ of the pre-weighted rows + bincount",
                   **t)
        if k == LLOYD_REDUCE_SHAPES[0][2]:
            note("lloyd_reduce", 0.0, **row)
        else:
            rows["lloyd_reduce"]["global_acc"] = row
        del x32, a, w, wx, al
    torch.cuda.empty_cache()

    # sensitivity_scores: one machine's shard against kb = 25 centers and
    # against SOCCER k = 1000's 1,111
    for n, d, k in SENSITIVITY_SHAPES:
        x32 = rand(n, d)
        c = rand(k, d)
        cv = rand(k) > 0.3
        cv[0] = True
        w = rand(n)
        w[: n // 5] = 0.0
        for dt in DTYPES:
            x = x32.to(dt)
            for mask in (None, cv):
                err, tol, moved = check_sensitivity(ops, ref, x, w, c, mask)
                note("sensitivity_scores", err)
                print(f"check sensitivity_scores n={n} k={k} {dt} mask="
                      f"{mask is not None} max_abs_err={err:.3g} tol="
                      f"{tol:.3g} moved={moved} (argmin and scores = "
                      f"min_dist's, masses = exact_index_add's, bit for "
                      f"bit) repeat=same bits", flush=True)
            del x
        t, lib_ms = timing(lambda: ops.sensitivity_scores(x32, w, c),
                           lambda: ref.sensitivity_scores_ref(x32, w, c),
                           lambda: torch.cdist(x32, c),
                           n * d * 4 + n * 4 + k * d * 4 + 2 * n * 4
                           + (k + 1) * 4, 2.0 * n * k * d,
                           f"sensitivity_scores n={n} k={k} "
                           f"({acc_mode(k, 0)} accumulators)", "torch.cdist")
        split = device_split(lambda: ops.sensitivity_scores(x32, w, c))
        w_us = sum(us for nm, us in split.items() if "max_abs_kernel" in nm)
        print(f"time sensitivity_scores n={n} k={k} device split a call: "
              f"{split_line(split)}; pass over w {w_us:.2f} us (it overlaps "
              f"the walk's start)", flush=True)
        row = dict(library_ms=None, yardstick="torch.cdist",
                   yardstick_ms=lib_ms, bound_pass_us=w_us,
                   device_split_us=split, **t)
        if k == SENSITIVITY_SHAPES[0][2]:
            before = TIER_BEFORE_MS[("sensitivity_scores", k)]
            print(f"recorded sensitivity_scores n={n} k={k}: one point a "
                  f"thread {before:.4f} ms (PERF.md, not this run); this "
                  f"run {t['ms']:.4f} ms ({before / t['ms']:.2f}x)",
                  flush=True)
            note("sensitivity_scores", 0.0, **row)
        else:
            # the route this kernel replaced beyond 1,024 centers: min_dist,
            # then the (n,)-sized tail in PyTorch with exact masses
            def old_route():
                d2, idx = ops.min_dist(x32, c)
                scores = w * d2
                return scores, exact_index_add(w, idx, k), scores.sum()
            old_ms = timed_ms(old_route)
            print(f"time sensitivity_scores n={n} k={k}: kernel "
                  f"{t['ms']:.4f} ms vs min_dist + PyTorch tail (the route "
                  f"it replaced) {old_ms:.4f} ms ({host_note(old_ms)}; "
                  f"{old_ms / t['ms']:.2f}x)", flush=True)
            rows["sensitivity_scores"]["wide"] = dict(
                min_dist_tail_ms=old_ms, **row)
        del x32, w
        torch.cuda.empty_cache()

    # truncated_cost: every machine's shard in one launch, v at the median,
    # at kzmeans' shape, at the wide shape (one slice) and at an odd p
    # whose center axis is split (unaligned machine bases)
    from repro_torch.kernels import truncated, walk
    sms = walk.sm_count(torch.device(dev))
    for m, p, d, k in (TRUNCATED_SHAPE, REMOVE_WIDE_SHAPE,
                       TRUNCATED_SPLIT_SHAPE):
        x32 = rand(m, p, d)
        c = rand(k, d)
        cv = rand(k) > 0.3
        cv[0] = True
        w = rand(m, p)
        w[:, : p // 5] = 0.0
        slices = truncated.launch_shape(m, p, d, k, sms)[2]
        for dt in DTYPES:
            x = x32.to(dt)
            # machine 1's rows begin off a 16-byte boundary
            off = (x.data_ptr() + p * d * x.element_size()) % 16
            for mask in (None, cv):
                d2, _ = ops.min_dist(x.reshape(m * p, d), c, mask)
                v = torch.median(d2[:1_000_000])
                err, tol, near = check_truncated(ops, ref, x, w, c, mask, v)
                note("truncated_cost", err)
                print(f"check truncated_cost m={m} p={p} k={k} {dt} mask="
                      f"{mask is not None} slices={slices} base_off={off} "
                      f"v={float(v):.4g} max_abs_err={err:.3g} tol="
                      f"{tol:.3g} near_v={near} (exact side = min_dist's "
                      f"d2) repeat=same bits zero_w=no side", flush=True)
            del x
        if (m, p, d, k) == TRUNCATED_SPLIT_SHAPE:
            # no valid center: every point in the tail, as the plain version
            none = torch.zeros(k, dtype=torch.bool, device=dev)
            kept, tmass, tcost = ops.truncated_cost(x32, w, c, v, none)
            e = float((tmass.double() - w.double().sum(1)).abs().max())
            check(float(kept.abs().max()) == 0.0 and bool(
                torch.isinf(tcost).all()) and e <= FUSED_RTOL * float(
                    w.double().sum(1).max()),
                  f"truncated_cost with no valid center: kept {kept}, tail "
                  f"mass off w's sums by {e}, tail cost {tcost}")
            print(f"check truncated_cost m={m} p={p} k={k} no valid center: "
                  f"kept 0, tail mass = w's sums (err {e:.3g}), tail cost "
                  f"inf", flush=True)
        if (m, p, d, k) == TRUNCATED_SHAPE:
            d2, _ = ops.min_dist(x32.reshape(m * p, d), c)
            v = torch.median(d2[:1_000_000])
            xf = x32.reshape(m * p, d)
            t, lib_ms = timing(lambda: ops.truncated_cost(x32, w, c, v),
                               lambda: ref.truncated_cost_ref(x32, w, c, v),
                               lambda: torch.cdist(xf, c),
                               m * p * d * 4 + m * p * 4 + k * d * 4 + 4
                               + 3 * m * 4, 2.0 * m * p * k * d,
                               f"truncated_cost m={m} p={p} k={k}",
                               "torch.cdist")
            print(f"recorded truncated_cost m={m} p={p} k={k}: one point a "
                  f"thread {TRUNCATED_BEFORE_MS:.4f} ms (PERF.md, not this "
                  f"run); this run {t['ms']:.4f} ms "
                  f"({TRUNCATED_BEFORE_MS / t['ms']:.2f}x); share of the "
                  f"bound {100 * t['bound_ms'] / t['ms']:.1f}%", flush=True)
            split = device_split(lambda: ops.truncated_cost(x32, w, c, v))
            print(f"time truncated_cost m={m} p={p} k={k} device split a "
                  f"call: {split_line(split)}", flush=True)
            note("truncated_cost", 0.0, library_ms=None,
                 yardstick="torch.cdist", yardstick_ms=lib_ms,
                 device_split_us=split, **t)
            del d2, xf
        del x32, w
        torch.cuda.empty_cache()

    # remove_below beyond the resident limit (PERF.md row 9)
    m, p, d, k = REMOVE_WIDE_SHAPE
    x32 = rand(m, p, d)
    c = rand(k, d)
    cv = rand(k) > 0.3
    cv[0] = True
    alive = rand(m, p) > 0.1
    d2, _ = ref.min_dist_ref(x32.reshape(m * p, d)[:200_000], c)
    srt = torch.sort(d2).values
    v_mid = 0.5 * (srt[len(srt) // 2] + srt[len(srt) // 2 + 1])
    wide_err = 0.0
    for dt in DTYPES:
        x = x32.to(dt)
        for v in (torch.zeros((), device=dev), v_mid):
            for mask in (None, cv):
                err, tol, nflip = check_remove_below(ops, ref, x, c, alive,
                                                     v, mask)
                wide_err = max(wide_err, err)
                print(f"check remove_below m={m} p={p} k={k} {dt} "
                      f"v={float(v):.4g} mask={mask is not None} "
                      f"exact=min_dist's flips={nflip} max_abs_err="
                      f"{err:.3g} tol={tol:.3g}", flush=True)
        del x
    note("remove_below", wide_err)
    ones = torch.ones((m, p), dtype=torch.bool, device=dev)
    t, lib_ms = timing(lambda: ops.remove_below(x32, c, ones, v_mid),
                       lambda: ref.remove_below_ref(x32, c, ones, v_mid),
                       lambda: torch.cdist(x32.reshape(m * p, d), c),
                       m * p * d * 4 + 2 * m * p + k * d * 4 + 4 + m * 4,
                       2.0 * m * p * k * d,
                       f"remove_below m={m} p={p} k={k}", "torch.cdist")
    xf = x32.reshape(m * p, d)
    md_ms = timed_ms(lambda: ops.min_dist(xf, c))
    print(f"time remove_below m={m} p={p} k={k} vs min_dist on the same "
          f"{m * p} points and {k} centers: {t['ms']:.4f} vs {md_ms:.4f} ms "
          f"({t['ms'] / md_ms:.3f}x); share of the bound "
          f"{100 * t['bound_ms'] / t['ms']:.1f}%", flush=True)
    # truncated_cost on the same points and centers (PERF.md §6 row 12)
    wt = rand(m, p)
    tr_ms = timed_ms(lambda: ops.truncated_cost(x32, wt, c, v_mid))
    tr_bnd, tr_by = bound_ms(m * p * d * 4 + m * p * 4 + k * d * 4 + 4
                             + 3 * m * 4, 2.0 * m * p * k * d)
    print(f"time truncated_cost m={m} p={p} k={k} f32: {tr_ms:.4f} ms "
          f"({host_note(tr_ms)}), bound {tr_bnd:.4f} ms ({tr_by}); "
          f"min_dist {md_ms:.4f} ms, remove_below {t['ms']:.4f} ms on the "
          f"same points ({tr_ms / md_ms:.3f}x, {tr_ms / t['ms']:.3f}x)",
          flush=True)
    rows["truncated_cost"]["wide"] = dict(
        shape=f"truncated_cost m={m} p={p} k={k}", ms=tr_ms,
        host_us=tr_ms.host_us, bound_ms=tr_bnd, bound_by=tr_by,
        min_dist_ms=md_ms, remove_below_ms=t["ms"])
    before = REMOVE_BELOW_BEFORE_MS[(m, p, k)]
    print(f"recorded remove_below m={m} p={p} k={k}: one point a thread "
          f"{before:.4f} ms (PERF.md, not this run); this run "
          f"{t['ms']:.4f} ms ({before / t['ms']:.2f}x)", flush=True)
    rows["remove_below"]["beyond_resident"] = dict(
        replaces=REMOVE_CHUNKED_REPLACES, library_ms=None,
        yardstick="torch.cdist", yardstick_ms=lib_ms, max_abs_err=wide_err,
        min_dist_ms=md_ms, **t)
    del x32, alive, ones, xf, wt
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ------------------------------------------------------------- seeding
#
# The seeding kernel (update_min_dist's, its draw on) at SOCCER k = 1000's
# coordinator shape (eta = 991,418 rows, k_plus = 1,111 steps) and Table 2
# row 1's (17,353 rows, 103 steps). Step by step from a shared state, its
# d2 must equal the draw-off kernel's (ops.update_min_dist) bit for bit and
# the plain step's within d2_tol; its draw must be the argmax of torch's
# keys from its own d2, and where it differs from the plain step's draw
# the two plain keys must lie within KEY_ULPS float32 ulps plus the d2
# slack of each (d2_tol / d2: the keys are logs of w·d2), both printed.
SEED_SHAPES = ((991_418, 1_111), (17_353, 103))
KEY_ULPS = 4
# the plain steps checked at the start and at the end of a seeding
SEED_CHECKED = 8
# seeding times with the parent's loop (core/kmeans.py before this kernel:
# one update_min_dist launch, a Gumbel draw in torch ops and a row gather
# a step), from scripts/time_seeding.py on the same card model (PERF.md
# §6; NVIDIA H100 80GB HBM3, 700 W): (n, k) -> (host ms, wall ms, device
# busy ms). Printed on lines of their own, never in the JSON line.
SEED_PARENT_MS = {(991_418, 1_111): (226.0, 226.1, 101.1),
                  (17_353, 103): (36.9, 37.0, 3.8)}
# SOCCER k = 1000's two seedings on the parent's loop (PERF.md §6, from
# scripts/fit_ab.py): device ms, the sum of event times, which equals the
# union of their time ranges there (no two of its events overlap)
SEED_PROFILE_BEFORE_MS = 191.5


def ulp32(v: float) -> float:
    return float(np.spacing(np.float32(abs(v))))


def seed_bound(n: int, d: int, itemsize: int):
    """One draw-on step's bound: x, w and d2 read once, d2 written once."""
    return bound_ms(n * d * itemsize + 3 * n * 4, 2.0 * n * d)


def parent_loop(ops, gen, x, w, k):
    """The parent's seeding loop (core/kmeans.py before this kernel), on
    the draw-off kernel: a yardstick for the host's time a step."""
    from repro_torch.core.kmeans import pick_row
    from repro_torch.core.sampling import gumbel_argmax
    n, d = x.shape
    centers = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    centers[0] = pick_row(x, gumbel_argmax(gen, w))
    d2min = torch.full((n,), torch.inf, dtype=torch.float32, device=x.device)
    for i in range(1, k):
        d2min, mass = ops.update_min_dist(x, w, centers[i - 1:i], d2min)
        p = torch.where(mass > 0, w * d2min, w)
        centers[i] = pick_row(x, gumbel_argmax(gen, p))
    return centers


def check_seed_step(ops, ref, fl, x, w, d2, prev, step, seed, what):
    """One draw-on step from the shared state (d2, prev) against the
    draw-off kernel and the plain step. Returns (the kernel's d2 and
    winner, the d2 error, whether the plain draw agreed)."""
    d2_k = d2.clone()
    words = fl.kmeans_pp_step_cuda(x, w, d2_k, prev, step, seed)
    g = ref.seed_gumbel(seed, x.shape[0], range(step, step + 1))[0]
    wf = w.float()
    err = 0.0
    if prev is not None:
        c = torch.index_select(x, 0, prev.reshape(1)).float()
        d2_u, _ = ops.update_min_dist(x, w, c, d2)
        check(torch.equal(d2_k, d2_u), f"{what}: the draw-on d2 differs from "
              f"ops.update_min_dist's at {int((d2_k != d2_u).sum())} points")
    d2_p, kd_p, kw_p = ref.kmeans_pp_step_ref(x, w, d2, prev, g)
    tol = d2_tol(x, x)                      # the center is a row of x
    err = float((d2_k - d2_p).abs().max()) if prev is not None else 0.0
    check(err <= tol, f"{what}: d2 err {err} > {tol}")
    # the kernel's draw against torch's keys from the kernel's own d2
    kd = ref.gumbel_keys(wf * d2_k, g) if prev is not None else None
    kw = ref.gumbel_keys(wf, g)
    use_d2 = kd is not None and bool(kd.max() > -torch.inf)
    keys = kd if use_d2 else kw
    a = int(ref.winner_from_words(words))
    check(bool(((words[0] >> 32) & ref.MASK32) > 0x007FFFFF) == use_d2,
          f"{what}: the kernel took the other key set")
    key_k = float(ref.key_of_word(words[0] if use_d2 else words[1]))
    key_t = float(keys[a])
    b = int(torch.argmax(keys))
    check(abs(key_k - key_t) <= KEY_ULPS * ulp32(key_t)
          and float(keys[b]) - key_t <= KEY_ULPS * ulp32(float(keys[b])),
          f"{what}: the kernel drew {a} (key {key_k!r}, torch {key_t!r}), "
          f"torch's argmax {b} (key {float(keys[b])!r})")
    # against the plain step's own d2 and draw
    p = int(ref.draw_winner(kd_p, kw_p))
    agree = p == a
    if not agree:
        keys_p = kd_p if use_d2 else kw_p
        ka, kb = float(keys_p[a]), float(keys_p[p])
        slack = KEY_ULPS * (ulp32(ka) + ulp32(kb))
        if use_d2:
            slack += tol / max(float(d2_p[a]), 1e-30) + tol / max(
                float(d2_p[p]), 1e-30)
        print(f"{what}: kernel drew {a}, plain {p}; plain keys {ka!r} and "
              f"{kb!r}, gap {kb - ka:.3g} within {slack:.3g}", flush=True)
        check(kb - ka <= slack, f"{what}: the draws differ beyond the keys' "
              f"tolerance")
    return d2_k, torch.tensor(a, device=x.device), err, agree


def check_seeding(ops, ref, x, w, k, seed, what):
    """A whole k-step seeding: its first SEED_CHECKED steps and last two
    from the shared state by ``check_seed_step``, the C loop's draws equal
    to the chain of single steps, a repeat giving the same draws, and no
    zero-weight row drawn. Returns (the largest d2 error, the checked
    steps where the plain step drew the kernel's row, the steps
    checked)."""
    from repro_torch.kernels import fused_lloyd as fl
    n = x.shape[0]
    d2 = torch.full((n,), torch.inf, device=x.device)
    prev, chain = None, []
    err_max, agreed, drawn = 0.0, 0, 0
    for step in range(k):
        if step < SEED_CHECKED or step >= k - 2:
            d2, prev, err, agree = check_seed_step(
                ops, ref, fl, x, w, d2, prev, step, seed,
                f"{what} step {step}")
            err_max = max(err_max, err)
            agreed += agree
            drawn += 1
        else:
            words = fl.kmeans_pp_step_cuda(x, w, d2, prev, step, seed)
            prev = ref.winner_from_words(words)
        chain.append(prev)
    idx = ops.kmeans_plusplus_indices(x, w, k, seed)
    check(torch.equal(idx, torch.stack(chain)),
          f"{what}: the C loop's draws differ from the chained steps")
    check(torch.equal(idx, ops.kmeans_plusplus_indices(x, w, k, seed)),
          f"{what}: a repeat seeding gave other draws")
    check(bool((w[idx] > 0).all()), f"{what}: drew a zero-weight row")
    print(f"check {what}: draw-on d2 = update_min_dist's bit for bit "
          f"at {SEED_CHECKED + 2} checked steps, the C loop = the "
          f"chained steps, repeat = same draws, no zero-weight row",
          flush=True)
    return err_max, agreed, drawn


def seeding_phase(ops, ref, rows) -> None:
    """The seeding kernel against the draw-off kernel and its plain version
    at SEED_SHAPES in three dtypes, with zero weights and the all-on-center
    fallback; a same-bits repeat of a whole seeding, which also equals the
    chain of single steps; times a seeding beside the parent's loop."""
    gen = torch.Generator("cuda").manual_seed(9)
    dev = "cuda"
    err_max, agreed, drawn = 0.0, 0, 0
    for n, k in SEED_SHAPES:
        x32 = torch.rand((n, DIM), generator=gen, device=dev)
        w = torch.rand(n, generator=gen, device=dev)
        w[: n // 5] = 0.0                         # padding rows
        seed = torch.randint(0, 1 << 32, (2,), generator=gen, device=dev)
        for dt in DTYPES:
            err, agree, checked = check_seeding(
                ops, ref, x32.to(dt), w, k, seed, f"seeding n={n} k={k} {dt}")
            err_max = max(err_max, err)
            agreed += agree
            drawn += checked
        # every point on a center: the D² mass is 0 from step 1 on and the
        # draw falls back to the weights; the C loop equals the plain loop
        xs = torch.ones((n, DIM), device=dev)
        idx = ops.kmeans_plusplus_indices(xs, w, 4, seed)
        idx_p = ref.kmeans_plusplus_indices_ref(xs, w, 4, seed)
        check(torch.equal(idx, idx_p) and bool((w[idx] > 0).all()),
              f"seeding fallback n={n}: kernel {idx.tolist()} plain "
              f"{idx_p.tolist()}")
        print(f"check seeding fallback n={n}: all on one center, draws "
              f"{idx.tolist()} = plain's", flush=True)
        del xs
    rows["update_min_dist"]["max_abs_err"] = max(
        rows["update_min_dist"]["max_abs_err"], err_max)
    print(f"check seeding: max d2 err {err_max:.3g}; the plain step drew "
          f"the kernel's row at {agreed} of {drawn} checked steps",
          flush=True)

    # times: a whole seeding, float32, and the parent's loop beside it
    timing = []
    for n, k in SEED_SHAPES:
        x = torch.rand((n, DIM), generator=gen, device=dev)
        w = torch.ones(n, device=dev)
        seed = torch.randint(0, 1 << 32, (2,), generator=gen, device=dev)
        ms = timed_ms(lambda: ops.kmeans_plusplus_indices(x, w, k, seed),
                      reps=3)
        g2 = torch.Generator(dev).manual_seed(1)
        loop_ms = timed_ms(lambda: parent_loop(ops, g2, x, w, k), reps=3)
        bnd, by = seed_bound(n, DIM, 4)
        step_us = ms * 1e3 / k
        print(f"time seeding n={n} d={DIM} k={k} f32: {ms:.4f} ms a "
              f"seeding ({host_note(ms)}), {step_us:.2f} us a step, bound "
              f"{bnd * 1e3:.2f} us a step ({by}; "
              f"{100 * bnd * 1e3 / step_us:.1f}% of it); the parent's "
              f"loop on the draw-off kernel {loop_ms:.4f} ms "
              f"({host_note(loop_ms)})", flush=True)
        host, wall, busy = SEED_PARENT_MS[(n, k)]
        print(f"recorded seeding n={n} k={k}: the parent tree's loop host "
              f"{host} ms, wall {wall} ms, device busy {busy} ms (PERF.md, "
              f"not this run); this run {ms:.4f} ms", flush=True)
        entry = dict(shape=f"n={n} d={DIM} k={k}", seeding_ms=ms,
                     seeding_host_us=ms.host_us, step_us=step_us,
                     step_bound_us=bnd * 1e3, parent_loop_ms=loop_ms,
                     parent_loop_host_us=loop_ms.host_us)
        if n == SEED_SHAPES[0][0]:
            # the JSON's numbers: one step at the k = 1000 coordinator
            prev = torch.tensor(5, device=dev)
            d2 = torch.rand(n, generator=gen, device=dev) * DIM
            g = ref.seed_gumbel(seed, n, range(1, 2))[0]

            def plain():
                d2_p, kd, kw = ref.kmeans_pp_step_ref(x, w, d2, prev, g)
                return ref.draw_winner(kd, kw)
            plain_ms = timed_ms(plain, reps=5)
            draw_off = {key: rows["update_min_dist"].get(key) for key in
                        ("ms", "host_us", "plain_ms", "bound_ms", "bound_by",
                         "shape")}
            # the draw-off call at this shape, one center: the parent
            # loop's call a step (PERF.md §6 row 3 holds the parent's)
            c1 = x[5:6].float()
            off_ms = timed_ms(lambda: ops.update_min_dist(x, w, c1, d2))
            off_bnd, _ = seed_bound(n, DIM, 4)
            draw_off.update(coordinator_ms=off_ms,
                            coordinator_host_us=off_ms.host_us,
                            coordinator_bound_ms=off_bnd)
            print(f"time update_min_dist draw-off n={n} d={DIM}, one "
                  f"center: {off_ms * 1e3:.2f} us a call ({host_note(off_ms)}"
                  f"), bound {off_bnd * 1e3:.2f} us", flush=True)
            rows["update_min_dist"].update(
                ms=ms / k, host_us=ms.host_us / k, plain_ms=plain_ms,
                bound_ms=bnd, bound_by=by, library_ms=None,
                yardstick="torch.cdist", yardstick_ms=timed_ms(
                    lambda: torch.cdist(x, x[:1]), reps=5),
                shape=f"n={n} d={DIM}, one draw-on step of a {k}-step "
                      f"seeding", draw_off=draw_off)
        timing.append(entry)
        del x, w
    rows["update_min_dist"]["seedings"] = timing
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ------------------------------------------------------------- main path

def sync_phase(params_cls) -> None:
    """One SOCCER round on 1 M points under CUDA's sync debug mode set to
    "error": any device->host synchronization inside the round raises."""
    from repro_torch.core import soccer
    from repro_torch.core.comm import VirtualCluster
    n = 1_000_000
    gen = torch.Generator("cuda").manual_seed(1)
    parts = torch.rand((MACHINES, n // MACHINES, DIM), generator=gen,
                       device="cuda")
    const = soccer.derive_constants(n, n // MACHINES,
                                    params_cls(k=25, epsilon=0.05))
    state = soccer.init_state(parts, const, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = soccer.soccer_round(state, VirtualCluster(MACHINES), const)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"sync: one soccer_round at n={n} ran with no host sync; "
          f"n_remaining={int(state.n_remaining)}", flush=True)


def tier_sync_phase(params_cls) -> None:
    """One SOCCER round with both of its slice-3 knobs on (the coreset
    uplink and outlier_frac) on 1 M points, and kzmeans' trimmed Lloyd on
    200,000 weighted rows, under CUDA's sync debug mode set to "error":
    neither reads a value back to the host."""
    from repro_torch.core import soccer
    from repro_torch.core.comm import VirtualCluster
    from repro_torch.robust.kzmeans import trimmed_lloyd
    n = 1_000_000
    gen = torch.Generator("cuda").manual_seed(7)
    parts = torch.rand((MACHINES, n // MACHINES, DIM), generator=gen,
                       device="cuda")
    const = soccer.derive_constants(n, n // MACHINES, params_cls(
        k=25, epsilon=0.05, uplink_mode="coreset", outlier_frac=0.02))
    state = soccer.init_state(parts, const, gen)
    rows = parts.reshape(n, DIM)[:200_000]
    w = torch.rand(200_000, generator=gen, device="cuda")
    z = torch.full((), 4_000.0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = soccer.soccer_round(state, VirtualCluster(MACHINES), const)
        c = trimmed_lloyd(rows, w, rows[:25], z, 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"sync: one soccer_round with uplink_mode=coreset, outlier_frac="
          f"0.02 at n={n} and 3 trimmed Lloyd steps ran with no host sync; "
          f"n_remaining={int(state.n_remaining)} uplink="
          f"{int(state.uplink[0])} centers finite="
          f"{bool(torch.isfinite(c).all())}", flush=True)


def kmpar_sync_phase() -> None:
    """k-means‖'s seeding — the weighted first choice and all five
    oversampling rounds at k = 100 on 1 M points — under CUDA's sync debug
    mode set to "error": the rounds read nothing back from the device."""
    from repro_torch.core import kmeans_parallel as kpar
    from repro_torch.core.comm import VirtualCluster
    n, k, rounds = 1_000_000, 100, 5
    gen = torch.Generator("cuda").manual_seed(4)
    x = torch.rand((MACHINES, n // MACHINES, DIM), generator=gen,
                   device="cuda")
    w = torch.ones((MACHINES, n // MACHINES), device="cuda")
    l, cap, rows = kpar.buffer_rows(k, rounds)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, valid, _, nsel, _, _ = kpar.oversample(
            VirtualCluster(MACHINES), gen, x, w, rounds, l, cap, rows)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"sync: k-means‖ seeding ({rounds} rounds, k={k}, {rows} rows) at "
          f"n={n} ran with no host sync; selected={nsel.tolist()} "
          f"oversampled={int(valid.sum())}", flush=True)


def mixture(n, k):
    from repro_torch.configs.soccer_paper import GaussianMixtureSpec
    from repro_torch.data.synthetic import gaussian_mixture
    x, _, means = gaussian_mixture(GaussianMixtureSpec(
        n=n, dim=DIM, k=k, sigma=0.001, zipf_gamma=1.5, seed=17))
    return x, means


def cost_of(x, centers) -> float:
    from repro_torch.core.metrics import centralized_cost
    xg = torch.from_numpy(x).cuda()
    cost = float(centralized_cost(xg, torch.as_tensor(
        np.asarray(centers, np.float32), device="cuda")))
    del xg
    return cost


def run_fit(api, KERNELS, x, k, algo, expect, **kw):
    """One ``fit`` with every launch count set to 0 just before it; fails
    unless each kernel of ``expect`` was launched."""
    torch.cuda.synchronize()
    for kern in KERNELS.values():
        kern.launches = 0
    t0 = time.perf_counter()
    res = api.fit(x, k, algo=algo, m=MACHINES, seed=0, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: kern.launches for name, kern in KERNELS.items()}
    missing = [name for name in expect if counts[name] == 0]
    check(not missing, f"fit {algo} k={k}: kernels of its path were not "
                       f"launched: {missing} ({counts})")
    check(np.isfinite(res.centers).all() and res.centers.shape[1] == DIM,
          f"fit {algo} k={k}: centers not finite (c, d)")
    check(int(np.sum(res.wire_bytes) + np.sum(res.wire_meta_bytes))
          == res.wire_bytes_total, f"fit {algo}: wire bytes do not sum")
    return res, wall, counts


def check_repeat(api, x, k, algo, first, what, **kw) -> None:
    """A second fit of ``first``'s algorithm, data and seed in this
    process: the same centers and cost, bit for bit (ROADMAP Queue 3's
    run-to-run fault)."""
    again = api.fit(x, k, algo=algo, m=MACHINES, seed=0, **kw)
    same = (again.centers.shape == first.centers.shape
            and np.array_equal(again.centers, first.centers))
    c1, c2 = cost_of(x, first.centers), cost_of(x, again.centers)
    print(f"repeat {what}: centers {'same bits' if same else 'DIFFER'}, "
          f"cost {c1!r} / {c2!r}", flush=True)
    check(same and c1 == c2, f"repeat {what}: a second fit at the same seed "
          f"gave other centers or cost")


def repeat_phase(api) -> None:
    """SOCCER, k-means‖ and EIM11 fitted twice in this process at one seed
    on REPEAT_N points of the paper's mixture (a reduced n; coreset_kmeans
    and kzmeans repeat at full size in their phases)."""
    x, _ = mixture(REPEAT_N, 25)
    for algo, kw in (("soccer", dict(epsilon=0.05, delta=0.1)),
                     ("kmeans_parallel", dict(rounds=5)),
                     ("eim11", dict(epsilon=0.1, delta=0.1))):
        first = api.fit(x, 25, algo=algo, m=MACHINES, seed=0, **kw)
        check_repeat(api, x, 25, algo, first, f"{algo} n={REPEAT_N} k=25",
                     **kw)


def report(algo, k, n, res, wall, ratio, counts, extra="") -> None:
    print(f"fit {algo} k={k} n={n}: rounds={res.rounds} "
          f"uplink={res.uplink_points.tolist()} "
          f"wire_bytes_total={res.wire_bytes_total} wall_s={wall:.3f} "
          f"cost/means_cost={ratio:.4f}{extra} launches={counts}",
          flush=True)


def check_soccer_structure(res, k, what) -> None:
    """Theorem 4.1's structural limits on a SOCCER fit: n_hist strictly
    decreasing, |C_out| <= I·k_plus + k, per-round uplink <= 2·eta + m."""
    const = res.extra["const"]
    up = res.uplink_points
    ns = res.n_hist[: res.rounds + 1]
    check(all(ns[i + 1] < ns[i] for i in range(res.rounds)),
          f"{what}: n_hist not strictly decreasing: {ns.tolist()}")
    check(res.centers.shape[0] <= res.rounds * const.k_plus + k,
          f"{what}: |C_out| > I*k_plus + k")
    check(all(up[r] <= 2 * const.eta + MACHINES for r in range(res.rounds)),
          f"{what}: per-round uplink > 2*eta + m")


def table2_phase(api, KERNELS, k, eps, per_fit):
    """SOCCER and k-means‖ on one Table 2 row at n = 10 M. Returns the
    data, the mixture's means, the SOCCER fit and its cost."""
    from repro_torch.core.kmeans_parallel import buffer_rows
    x, means = mixture(N_POINTS, k)
    ref = cost_of(x, means)

    res, wall, counts = run_fit(api, KERNELS, x, k, "soccer", SOCCER_KERNELS,
                                epsilon=eps, delta=0.1)
    per_fit[f"soccer_k{k}"] = counts
    const = res.extra["const"]
    cost = cost_of(x, res.centers)
    report("soccer", k, N_POINTS, res, wall, cost / ref, counts,
           f" eta={const.eta} k_plus={const.k_plus} "
           f"n_hist={res.n_hist.tolist()} |C_out|={res.centers.shape[0]}")
    check_soccer_structure(res, k, f"soccer k={k}")
    check(cost <= 3.0 * ref, f"cost {cost} > 3x mixture means' cost {ref}")

    rounds = 5
    _, cap, rows = buffer_rows(k, rounds)
    expect = KMPAR_KERNELS
    kres, kwall, kcounts = run_fit(api, KERNELS, x, k, "kmeans_parallel",
                                   expect, rounds=rounds)
    per_fit[f"kmeans_parallel_k{k}"] = kcounts
    over = kres.extra["oversampled"].shape[0]
    kcost = cost_of(x, kres.centers)
    report("kmeans_parallel", k, N_POINTS, kres, kwall, kcost / ref, kcounts,
           f" (soccer {cost / ref:.4f}) rows={rows} |oversampled|={over}")
    check(kres.rounds == rounds, f"k-means‖ ran {kres.rounds} rounds")
    check(1 <= over <= 1 + rounds * cap,
          f"|oversampled| = {over} > 1 + rounds*cap = {1 + rounds * cap}")
    check(kres.centers.shape == (k, DIM), "k-means‖ centers not (k, d)")
    return x, means, res, cost


def eim11_phase(api, KERNELS, per_fit):
    """EIM11 at n = 1 M, k = 25 against the claims of
    tests/test_baselines.py, with SOCCER on the same data for the
    broadcast comparison. Returns the fit's sample size s and rounds."""
    from repro_torch.core.eim11 import sample_sizes
    n, k = EIM11_N, EIM11_K
    x, means = mixture(n, k)
    ref = cost_of(x, means)
    soc, _, _ = run_fit(api, KERNELS, x, k, "soccer", SOCCER_KERNELS,
                        epsilon=0.1, delta=0.1)
    res, wall, counts = run_fit(api, KERNELS, x, k, "eim11", EIM11_KERNELS)
    per_fit[f"eim11_k{k}"] = counts
    s, rows = sample_sizes(MACHINES, n // MACHINES, k, 0.1, 0.1, 12)
    cost = cost_of(x, res.centers)
    nh = res.n_hist
    fracs = [float(1 - nh[i + 1] / nh[i]) for i in range(len(nh) - 1)]
    bcast = res.extra["broadcast_points"]
    soc_bcast = soc.rounds * soc.extra["const"].k_plus
    report("eim11", k, n, res, wall, cost / ref, counts,
           f" s={s} rows={rows} n_hist={nh.tolist()} removed_frac="
           f"{[round(f, 4) for f in fracs]} broadcast={bcast} "
           f"(soccer I*k_plus={soc_bcast})")
    check(res.rounds >= 2, f"EIM11 ran {res.rounds} rounds")
    for f in fracs[:2]:
        check(0.3 <= f <= 0.7, f"EIM11 removed {f:.3f} of a round, not ~half")
    check(cost <= 6.0 * ref, f"EIM11 cost {cost} > 6x means' cost {ref}")
    check(bcast > 20 * soc_bcast,
          f"EIM11 broadcast {bcast} <= 20x SOCCER's {soc_bcast}")
    check(res.centers.shape == (k, DIM), "EIM11 centers not (k, d)")
    return s, res.rounds


def eim11_sweep_phase(ops, ref, rows, s: int, rounds: int) -> None:
    """min_dist at the two largest sweeps of the EIM11 fit above, from its
    own sample size s and rounds: its last round's second sample (s rows,
    core/eim11.py:95) and all m·p points (:98), each against the
    clustering of that round (rounds·s rows). Held against the plain
    version (float32, every center valid) and timed beside its bound and
    the Lloyd kernel on the same inputs."""
    gen = torch.Generator("cuda").manual_seed(8)
    k = rounds * s
    c = torch.rand((k, DIM), generator=gen, device="cuda")
    out = []
    for what, n in (("s2 sample (eim11.py:95)", s),
                    ("all points (eim11.py:98)", EIM11_N)):
        x = torch.rand((n, DIM), generator=gen, device="cuda")
        err, tol = check_min_dist(ops, ref, x, c, None)
        rows["min_dist"]["max_abs_err"] = max(rows["min_dist"]["max_abs_err"],
                                              err)
        ones = torch.ones(n, device="cuda")
        ms = timed_ms(lambda: ops.min_dist(x, c), reps=5)
        lloyd_ms = timed_ms(lambda: ops.fused_assign_reduce(x, ones, c),
                            reps=5)
        bnd, by = min_dist_bound(n, DIM, k)
        launch = min_dist_launch(n, DIM, k)
        print(f"time min_dist EIM11 {what} n={n} k={k} f32: {ms:.4f} ms "
              f"({launch}), bound {bnd:.4f} ms ({by}; {100 * bnd / ms:.1f}% "
              f"of it); the Lloyd kernel on the same inputs {lloyd_ms:.4f} "
              f"ms ({ms / lloyd_ms:.3f}x); check max_abs_err={err:.3g} "
              f"tol={tol:.3g}", flush=True)
        out.append(dict(shape=f"n={n} d={DIM} k={k}", sweep=what, ms=ms,
                        bound_ms=bnd, bound_by=by, share_of_bound=bnd / ms,
                        lloyd_ms=lloyd_ms, launch=launch))
        del x, ones
    rows["min_dist"]["eim11_sweeps"] = out
    del c
    torch.cuda.empty_cache()


def profile_phase(rows) -> None:
    """fit_profile's device time of the kernels this walk moved, in the
    fits where they cost most: min_dist in EIM11 at n = 1 M, remove_below
    in SOCCER at k = 1000; each beside its time recorded before
    (PROFILE_BEFORE), on a line of its own."""
    from repro_torch import fit_profile
    for algo, k, n, kernel, row in (
            ("eim11", EIM11_K, EIM11_N, "min_dist_kernel", "min_dist"),
            ("soccer", K_WIDE, N_POINTS, "remove_below_kernel",
             "remove_below")):
        prof = fit_profile.profile_fit(k, n, algo=algo, top=60)
        hits = [r for r in prof["top"] if f"rt::{kernel}<" in r["name"]]
        ms = sum(r["device_ms"] for r in hits)
        calls = sum(r["calls"] for r in hits)
        check(calls > 0, f"fit_profile {algo}: no {kernel} in the trace")
        before_ms, before_calls = PROFILE_BEFORE[(algo, kernel)]
        print(f"profile {algo} k={k} n={n}: {kernel} {ms:.1f} ms of device "
              f"time in {calls} calls; fit wall {prof['wall_s']:.3f} s, "
              f"device busy {prof['device_busy_s']:.3f} s", flush=True)
        print(f"recorded profile {algo} k={k} n={n}: {kernel} "
              f"{before_ms} ms in {before_calls} calls (PERF.md, one point "
              f"a thread, not this run)", flush=True)
        rows[row][f"{algo}_k{k}_profile"] = dict(
            device_ms=ms, calls=calls, wall_s=prof["wall_s"],
            device_busy_s=prof["device_busy_s"])
        if algo == "soccer":
            # the union of the seeding kernels' time ranges, and their sum:
            # each step starts, and waits, while the step before runs
            names = ("rt::seed_step_kernel<", "rt::seed_indices_kernel")
            seed_ms = fit_profile.span_ms(prof, *names)
            seed_sum = sum(end - start for name, start, end
                           in prof["_device"]
                           if any(n in name for n in names)) / 1e3
            seed_calls = sum(r["calls"] for r in prof["top"]
                             if "rt::seed_step_kernel<" in r["name"])
            check(seed_calls > 0 and seed_ms > 0,
                  "fit_profile soccer: no seeding kernel in the trace")
            print(f"profile soccer k={k} n={n}: the seeding kernels "
                  f"{seed_ms:.1f} ms of device time in {seed_calls} steps "
                  f"as the union of their time ranges, {seed_sum:.1f} ms "
                  f"summed; fit wall {prof['wall_s']:.3f} s, device busy "
                  f"{prof['device_busy_s']:.3f} s", flush=True)
            print(f"recorded profile soccer k={k} n={n}: the parent's "
                  f"seeding loop {SEED_PROFILE_BEFORE_MS} ms of device time, "
                  f"summed and as a union (PERF.md, not this run)",
                  flush=True)
            rows["update_min_dist"][f"soccer_k{k}_profile"] = dict(
                seeding_device_ms=seed_ms, seeding_device_sum_ms=seed_sum,
                calls=seed_calls,
                wall_s=prof["wall_s"], device_busy_s=prof["device_busy_s"])


def print_ratio_before(fit: str, ratio: float) -> None:
    before = COST_RATIOS_BEFORE[fit]
    print(f"recorded {fit} cost/means_cost before the grouped reduce "
          f"{before} (PERF.md, not this run); this run {ratio:.4f}",
          flush=True)


def coreset_phase(api, KERNELS, x, means, soc, soc_cost, per_fit) -> None:
    """coreset_kmeans and SOCCER's coreset uplink on Table 2 row 1's data,
    against tests/test_coresets.py's claims; ``soc`` is the points-uplink
    SOCCER fit on the same data in this run."""
    k = 25
    ref = cost_of(x, means)
    res, wall, counts = run_fit(api, KERNELS, x, k, "coreset_kmeans",
                                CORESET_KERNELS, coreset_size=CORESET_BUDGET)
    per_fit[f"coreset_kmeans_k{k}"] = counts
    cost = cost_of(x, res.centers)
    rows_pm = CORESET_BUDGET // MACHINES
    report("coreset_kmeans", k, x.shape[0], res, wall, cost / ref, counts,
           f" (soccer {soc_cost / ref:.4f}) rows_per_machine="
           f"{res.extra['coreset_rows_per_machine']}")
    check(res.rounds == 1, f"coreset_kmeans ran {res.rounds} rounds")
    check(res.uplink_points.tolist() == [MACHINES * rows_pm],
          f"coreset_kmeans uplink {res.uplink_points.tolist()}")
    check(np.array_equal(res.uplink_bytes, res.uplink_points * DIM * 4),
          "coreset_kmeans uplink bytes != rows * d * 4")
    check(res.centers.shape == (k, DIM), "coreset_kmeans centers not (k, d)")
    print_ratio_before("coreset_kmeans", cost / ref)
    check_repeat(api, x, k, "coreset_kmeans", res,
                 f"coreset_kmeans n={x.shape[0]} k={k}",
                 coreset_size=CORESET_BUDGET)

    cres, cwall, ccounts = run_fit(api, KERNELS, x, k, "soccer",
                                   SOCCER_CORESET_KERNELS, epsilon=0.05,
                                   delta=0.1, uplink_mode="coreset")
    per_fit[f"soccer_coreset_k{k}"] = ccounts
    ccost = cost_of(x, cres.centers)
    const = cres.extra["const"]
    report("soccer uplink_mode=coreset", k, x.shape[0], cres, cwall,
           ccost / ref, ccounts,
           f" coreset_rows={const.coreset_rows} kb={const.coreset_kb} "
           f"n_hist={cres.n_hist.tolist()} uplink_bytes_total="
           f"{cres.uplink_bytes_total} (points: {soc.uplink_bytes_total}, "
           f"{soc.rounds} rounds, cost/means_cost {soc_cost / ref:.4f})")
    check(cres.params["uplink_mode"] == "coreset", "uplink_mode not kept")
    check(cres.uplink_bytes_total < soc.uplink_bytes_total,
          "the coreset uplink did not shrink the uplink bytes")
    check(cres.rounds <= soc.rounds + 1,
          f"coreset uplink ran {cres.rounds} rounds, points {soc.rounds}")
    check(ccost <= 2.0 * soc_cost,
          f"coreset uplink cost {ccost} > 2x the points uplink's {soc_cost}")
    print_ratio_before("soccer_coreset", ccost / ref)
    check_soccer_structure(cres, k, "soccer uplink_mode=coreset")


def robust_phase(api, KERNELS, x, means, per_fit) -> None:
    """kzmeans and SOCCER, with and without outlier_frac, on Table 2 row
    1's data with 2% gross outliers (10.2 M points), against
    tests/test_kzmeans.py's claims and Theorem 4.1's structure. ``x`` is
    exactly the inliers, so the inlier cost is the cost on ``x``."""
    from repro_torch.data.synthetic import contaminate
    k = 25
    xc, _ = contaminate(x, frac=OUTLIER_FRAC, scale=OUTLIER_SCALE,
                        seed=OUTLIER_SEED)
    n = xc.shape[0]
    ref = cost_of(x, means)
    fits = {}
    for frac in (0.0, OUTLIER_FRAC):
        res, wall, counts = run_fit(api, KERNELS, xc, k, "kzmeans",
                                    KZMEANS_KERNELS, outlier_frac=frac,
                                    coreset_size=KZ_BUDGET)
        per_fit[f"kzmeans_frac{frac}_k{k}"] = counts
        inl = cost_of(x, res.centers)
        e = res.extra
        report("kzmeans", k, n, res, wall, inl / ref, counts,
               f" outlier_frac={frac} (inlier cost) coreset_rows="
               f"{e['coreset_rows_per_machine']} candidate_rows="
               f"{e['candidate_rows_per_machine']} kz_cost={e['kz_cost']:.6g}"
               f" trimmed_mass={e['trimmed_mass']:.6g} trimmed_cost="
               f"{e['trimmed_cost']:.6g} v={e['trim_threshold']:.4g}")
        check(res.rounds == 1, f"kzmeans ran {res.rounds} rounds")
        check(res.uplink_points.tolist() == [KZ_BUDGET],
              f"kzmeans uplink {res.uplink_points.tolist()} != {KZ_BUDGET}")
        check(res.uplink_bytes.tolist() == [KZ_BUDGET * DIM * 4],
              "kzmeans uplink bytes != budget * d * 4")
        check(res.centers.shape == (k, DIM), "kzmeans centers not (k, d)")
        fits[frac] = (res, inl)
    (plain, plain_inl), (robust, robust_inl) = fits[0.0], fits[OUTLIER_FRAC]
    check(np.array_equal(plain.wire_bytes, robust.wire_bytes),
          "kzmeans: the two conditions moved different payload bytes")
    check(robust_inl < plain_inl,
          f"kzmeans robust inlier cost {robust_inl} not below the plain "
          f"fit's {plain_inl}")
    # tests/test_kzmeans.py:50-51 also bound the robust inlier cost by 3x
    # the means' and 0.01x the plain fit's, at n = 6,000 and k = 5. At this
    # configuration (a shard's 204,000 candidate rows, which never seed,
    # hold the small Zipf components whole) the reference misses both as
    # the port does (tests/test_torch_kzmeans.py::
    # test_kzmeans_claims_at_the_smoke_proportions; ROADMAP Queue 3), so
    # they are printed here, not asserted.
    print(f"kzmeans at n={n}: robust inlier cost / means' "
          f"{robust_inl / ref:.4f} (test_kzmeans.py bound 3: "
          f"{'met' if robust_inl <= 3.0 * ref else 'not met'}), robust / "
          f"plain {robust_inl / plain_inl:.4f} (bound 0.01: "
          f"{'met' if robust_inl < 0.01 * plain_inl else 'not met'})",
          flush=True)
    print_ratio_before("kzmeans_robust", robust_inl / ref)
    e = robust.extra
    total = cost_of(xc, robust.centers)
    check(abs(e["kz_cost"] + e["trimmed_cost"] - total) <= 1e-4 * total,
          f"kz_cost + trimmed_cost = {e['kz_cost'] + e['trimmed_cost']} "
          f"!= the full cost {total}")
    z = OUTLIER_FRAC * n
    check(0.5 * z <= e["trimmed_mass"] <= z + 1.0,
          f"trimmed mass {e['trimmed_mass']} outside [z/2, z + 1], z = {z}")
    check(e["kz_cost"] < 1e-3 * total,
          f"kz_cost {e['kz_cost']} not < 1e-3 of the total {total}")
    check(plain.extra["trimmed_mass"] == 0.0
          and plain.extra["trimmed_cost"] == 0.0,
          "kzmeans with outlier_frac=0 trimmed something")
    check_repeat(api, xc, k, "kzmeans", robust,
                 f"kzmeans outlier_frac={OUTLIER_FRAC} n={n} k={k}",
                 outlier_frac=OUTLIER_FRAC, coreset_size=KZ_BUDGET)

    inlier = {}
    for frac in (OUTLIER_FRAC, 0.0):
        res, wall, counts = run_fit(api, KERNELS, xc, k, "soccer",
                                    SOCCER_KERNELS, epsilon=0.05, delta=0.1,
                                    outlier_frac=frac)
        per_fit[f"soccer_frac{frac}_k{k}"] = counts
        inlier[frac] = cost_of(x, res.centers) / ref
        report("soccer", k, n, res, wall, inlier[frac], counts,
               f" outlier_frac={frac} (inlier cost of C_out) n_hist="
               f"{res.n_hist.tolist()} |C_out|={res.centers.shape[0]}")
        check_soccer_structure(res, k, f"soccer outlier_frac={frac}")
        check(res.extra["const"].outlier_frac == frac, "outlier_frac lost")
    print(f"inlier cost / means cost on the contaminated data: soccer "
          f"robust {inlier[OUTLIER_FRAC]:.4f}, plain {inlier[0.0]:.4f}; "
          f"kzmeans robust {robust_inl / ref:.4f}, plain "
          f"{plain_inl / ref:.4f}", flush=True)


def wide_phase(api, KERNELS, per_fit) -> None:
    """SOCCER at k = 1000 on a 10 M mixture: k_plus = 1,111 centers, past
    the resident kernels' limit, in the coordinator's Lloyd steps and in
    the machines' removal sweep; then the sharded coordinator on the same
    data, whose buffers hold cap_sharded = 991,418 rows a machine."""
    k = K_WIDE
    x, means = mixture(N_POINTS, k)
    ref = cost_of(x, means)
    res, wall, counts = run_fit(api, KERNELS, x, k, "soccer",
                                SOCCER_WIDE_KERNELS, epsilon=0.05, delta=0.1)
    per_fit[f"soccer_k{k}"] = counts
    const = res.extra["const"]
    cost = cost_of(x, res.centers)
    report("soccer", k, N_POINTS, res, wall, cost / ref, counts,
           f" eta={const.eta} k_plus={const.k_plus} "
           f"n_hist={res.n_hist.tolist()} |C_out|={res.centers.shape[0]}")
    check_soccer_structure(res, k, f"soccer k={k}")
    check(const.k_plus > TPU_RESIDENT_K and res.rounds >= 1,
          f"soccer k={k}: k_plus {const.k_plus}, {res.rounds} rounds")
    # every round's C_iter (k_plus rows) went through remove_below
    check(counts["remove_below"] == res.rounds
          and res.extra["state"].centers.shape[1] == const.k_plus,
          f"soccer k={k}: remove_below ran {counts['remove_below']} times "
          f"in {res.rounds} rounds")
    # the sharded coordinator on the same data: (m, 991,418, d) buffers,
    # against tests/test_system.py:128's claim and this gather fit
    sres, swall, scounts = run_fit(api, KERNELS, x, k, "soccer",
                                   SOCCER_WIDE_KERNELS, epsilon=0.05,
                                   delta=0.1, sharded_coordinator=True)
    per_fit[f"soccer_sharded_k{k}"] = scounts
    sconst = sres.extra["const"]
    scost = cost_of(x, sres.centers)
    report("soccer sharded_coordinator", k, N_POINTS, sres, swall,
           scost / ref, scounts, f" cap_sharded={sconst.cap_sharded} "
           f"n_hist={sres.n_hist.tolist()} |C_out|={sres.centers.shape[0]}"
           f" (gather {cost / ref:.4f})")
    check_soccer_structure(sres, k, f"soccer sharded k={k}")
    check(sconst.cap_sharded == 991_418, f"cap_sharded {sconst.cap_sharded}")
    check(scost <= 1.5 * cost + 0.1 * ref,
          f"soccer sharded k={k}: cost {scost} > 1.5x the gather fit's "
          f"{cost} + 0.1x the means' {ref}")
    del x


# ------------------------------------------- the knobs' paths (slice 4)
#
# The sharded coordinator, the mini-batch black box, the centralized
# lloyd and minibatch, the uplink knobs and failure injection (ROADMAP
# Queue 1 items 10-11): the kernels at the shapes these paths give them,
# a round of each under the sync debug mode, and their fits.
FAIL_AT = {0: (2, 5), 1: (3,)}
STRAGGLER_RATE = 0.3
MINIBATCH_ROWS = 1024         # SoccerParams.minibatch_size, fit's batch
CENTRAL_KERNELS = ("update_min_dist", "fused_assign_reduce")
MINIBATCH_CLAIM = "tests/test_kmeans.py:71"


def minibatch_bound(means_cost: float) -> float:
    """tests/test_kmeans.py:71's bound on a mini-batch fit's cost."""
    return 4.0 * max(means_cost, 1e-6) + 1.0


def sharded_buffer(gen, const):
    """A sharded round's flattened P1 buffer at ``const``: (m·cap_sharded,
    d) points whose first eta/m slots a machine weigh N/eta (the HT
    weight of a balanced draw) and the rest 0, and k_plus centers drawn
    from its live rows."""
    cap, share = const.cap_sharded, const.eta // MACHINES
    x = torch.rand((MACHINES * cap, DIM), generator=gen, device="cuda")
    w = torch.zeros((MACHINES, cap), device="cuda")
    w[:, :share] = N_POINTS / const.eta
    live = (torch.arange(MACHINES, device="cuda")[:, None] * cap
            + torch.arange(share, device="cuda")[None, :]).reshape(-1)
    pick = torch.randperm(live.numel(), generator=gen, device="cuda")
    c = x[live[pick[:const.k_plus]]]
    return x, w.reshape(-1), c


def time_fused(ops, ref, x, w, c, what, rows_key, rows):
    """Time the Lloyd step at a path's shape beside its plain version and
    bound; store it in the kernel's JSON row under ``rows_key``."""
    n, d = x.shape
    k = c.shape[0]
    ms = timed_ms(lambda: ops.fused_assign_reduce(x, w, c), reps=10)
    plain = (timed_ms(lambda: ref.fused_assign_reduce_ref(x, w, c), reps=3)
             if n * k <= 2e9 else None)
    bnd, by = lloyd_bound(n, d, k)
    print(f"time fused_assign_reduce {what} n={n} k={k} {x.dtype}: "
          f"{ms:.4f} ms ({host_note(ms)}), plain "
          + (f"{plain:.4f} ms" if plain is not None else
             "not timed (its (n, k) panels exceed the card)")
          + f", bound {bnd:.4f} ms ({by}; {100 * bnd / ms:.1f}% of it)",
          flush=True)
    rows["fused_assign_reduce"][rows_key] = dict(
        shape=f"n={n} d={d} k={k} {str(x.dtype).removeprefix('torch.')}",
        ms=ms, host_us=ms.host_us, plain_ms=plain, bound_ms=bnd,
        bound_by=by)


def knob_kernel_phase(ops, ref, rows, params_cls) -> None:
    """The kernels at the shapes the new paths give them: the sharded
    coordinator's flattened (m·cap_sharded, d) buffers at k = 25 (the
    seeding, the Lloyd step and min_dist, float32 as the buffers are) and
    k = 1000 (the seeding's 1,111 steps and the Lloyd step over all
    7,931,344 slots, its plain version over one machine's 991,418 at a
    time), and the mini-batch step's (1,024, d) batch against k_plus and
    k centers."""
    from repro_torch.core.soccer import derive_constants
    gen = torch.Generator("cuda").manual_seed(11)
    p = N_POINTS // MACHINES
    for k in (25, K_WIDE):
        const = derive_constants(N_POINTS, p, params_cls(
            k=k, epsilon=0.05, sharded_coordinator=True))
        x, w, c = sharded_buffer(gen, const)
        n = x.shape[0]
        what = f"sharded k={k} (m*cap_sharded={n})"
        if k == 25:
            errs, t_c, moved = check_fused(ops, ref, x, w, c, None,
                                           repeat=True)
            print(f"check fused_assign_reduce {what} f32: "
                  f"{fused_line(errs, t_c, moved)}", flush=True)
            err, tol = check_min_dist(ops, ref, x, c, None)
            print(f"check min_dist {what} f32: d2 err {err:.3g} (tol "
                  f"{tol:.3g})", flush=True)
            seed = torch.randint(0, 1 << 32, (2,), generator=gen,
                                 device="cuda")
            err, agree, checked = check_seeding(
                ops, ref, x, w, const.k_plus, seed,
                f"seeding {what} k_plus={const.k_plus}")
            print(f"check seeding {what}: d2 err {err:.3g}; the plain step "
                  f"drew the kernel's row at {agree} of {checked}",
                  flush=True)
            md = timed_ms(lambda: ops.min_dist(x, c), reps=10)
            md_bnd, md_by = min_dist_bound(n, DIM, const.k_plus)
            print(f"time min_dist {what} k={const.k_plus} f32: {md:.4f} ms "
                  f"({host_note(md)}), bound {md_bnd:.4f} ms ({md_by})",
                  flush=True)
            rows["min_dist"]["sharded_k25"] = dict(
                shape=f"n={n} d={DIM} k={const.k_plus}", ms=md,
                host_us=md.host_us, bound_ms=md_bnd, bound_by=md_by)
            sd = timed_ms(lambda: ops.kmeans_plusplus_indices(
                x, w, const.k_plus, seed), reps=3)
            s_bnd, _ = seed_bound(n, DIM, 4)
            print(f"time seeding {what} k_plus={const.k_plus} f32: "
                  f"{sd:.4f} ms a seeding ({host_note(sd)}), "
                  f"{sd * 1e3 / const.k_plus:.2f} us a step, bound "
                  f"{s_bnd * 1e3:.2f} us a step", flush=True)
            rows["update_min_dist"]["sharded_k25"] = dict(
                shape=f"n={n} d={DIM} k={const.k_plus}", seeding_ms=sd,
                step_us=sd * 1e3 / const.k_plus, step_bound_us=s_bnd * 1e3)
        else:
            errs, t_c, moved = check_fused(ops, ref, x, w, c, None,
                                           plain_rows=const.cap_sharded)
            print(f"check fused_assign_reduce {what} f32 (plain version "
                  f"over {const.cap_sharded}-row chunks): "
                  f"{fused_line(errs, t_c, moved)}", flush=True)
            seed = torch.randint(0, 1 << 32, (2,), generator=gen,
                                 device="cuda")
            err, agree, checked = check_seeding(
                ops, ref, x, w, const.k_plus, seed,
                f"seeding {what} k_plus={const.k_plus}")
            print(f"check seeding {what}: d2 err {err:.3g}; the plain step "
                  f"drew the kernel's row at {agree} of {checked}",
                  flush=True)
        time_fused(ops, ref, x, w, c, what, f"sharded_k{k}", rows)
        del x, w, c
        torch.cuda.empty_cache()
    # the mini-batch step: a float32 (1,024, d) batch of a narrow payload
    # against SOCCER's k_plus (its C_iter) and k (the finalize)
    for k in (103, 25):
        xb = torch.rand((MINIBATCH_ROWS, DIM), generator=gen,
                        device="cuda").to(torch.bfloat16).float()
        c = xb[:k].clone()
        ones = torch.ones(MINIBATCH_ROWS, device="cuda")
        errs, t_c, moved = check_fused(ops, ref, xb, ones, c, None,
                                       repeat=True)
        print(f"check fused_assign_reduce minibatch step k={k} f32: "
              f"{fused_line(errs, t_c, moved)}", flush=True)
        time_fused(ops, ref, xb, ones, c, "minibatch step",
                   f"minibatch_step_k{k}", rows)


def central_kernel_phase(ops, ref, x, rows) -> None:
    """The kernels at the shapes ``fit(algo="lloyd")`` and
    ``fit(algo="minibatch")`` give them on the gathered union of Table 2
    row 1's data (n = 10 M, unit weights, float32): the k = 25 seeding
    over all n rows, and the Lloyd step (every Lloyd iteration, the
    mini-batch fit's full-set cost) against the centers it drew."""
    n, k = x.shape[0], 25
    gen = torch.Generator("cuda").manual_seed(13)
    xg = torch.from_numpy(x).cuda()
    w = torch.ones(n, device="cuda")
    seed = torch.randint(0, 1 << 32, (2,), generator=gen, device="cuda")
    what = f"central n={n}"
    err, agree, checked = check_seeding(ops, ref, xg, w, k, seed,
                                        f"seeding {what} k={k}")
    print(f"check seeding {what} k={k}: d2 err {err:.3g}; the plain step "
          f"drew the kernel's row at {agree} of {checked}", flush=True)
    c = xg[ops.kmeans_plusplus_indices(xg, w, k, seed)]
    errs, t_c, moved = check_fused(ops, ref, xg, w, c, None, repeat=True)
    print(f"check fused_assign_reduce {what} k={k} f32: "
          f"{fused_line(errs, t_c, moved)}", flush=True)
    time_fused(ops, ref, xg, w, c, "central", f"central_k{k}", rows)
    del xg
    torch.cuda.empty_cache()


def knob_sync_phase(params_cls) -> None:
    """One sharded round, one straggler round, one int8-codes round and
    one mini-batch black box on 1 M points under CUDA's sync debug mode
    set to "error": none reads a value back to the host."""
    from repro_torch.core import soccer
    from repro_torch.core.comm import VirtualCluster
    from repro_torch.core.minibatch import minibatch_kmeans
    n = 1_000_000
    gen = torch.Generator("cuda").manual_seed(5)
    parts = torch.rand((MACHINES, n // MACHINES, DIM), generator=gen,
                       device="cuda")
    cases = (("sharded_coordinator", dict(sharded_coordinator=True), {}),
             ("straggler_rate", dict(straggler_rate=STRAGGLER_RATE), {}),
             ("int8 codes", {}, dict(uplink_dtype="int8",
                                     uplink_wire="codes")))
    for name, knobs, uplink in cases:
        const = soccer.derive_constants(
            n, n // MACHINES, params_cls(k=25, epsilon=0.05, **knobs),
            **uplink)
        state = soccer.init_state(parts, const, gen)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state = soccer.soccer_round(state, VirtualCluster(MACHINES),
                                        const)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print(f"sync: one soccer_round with {name} at n={n} ran with no "
              f"host sync; n_remaining={int(state.n_remaining)} uplink="
              f"{int(state.uplink[0])}", flush=True)
    pts = parts.reshape(n, DIM)[:17_353].to(torch.bfloat16)
    w = torch.rand(17_353, generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        c, cost = minibatch_kmeans(gen, pts, w, 103)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"sync: the mini-batch black box (60 steps of {MINIBATCH_ROWS} "
          f"rows, k=103) on 17,353 bfloat16 rows ran with no host sync; "
          f"cost={float(cost):.6g} centers finite="
          f"{bool(torch.isfinite(c).all())}", flush=True)


def knob_fit_phase(api, KERNELS, x, means, soc, soc_cost, per_fit) -> None:
    """The new fits on Table 2 row 1's data (n = 10 M, k = 25), each
    against the reference tests' claims, with every kernel of its path
    launched; ``soc`` is the default SOCCER fit on the same data."""
    k, n = 25, x.shape[0]
    ref = cost_of(x, means)
    paper = dict(epsilon=0.05, delta=0.1)

    def fit(key, algo, expect, extra="", **kw):
        res, wall, counts = run_fit(api, KERNELS, x, k, algo, expect, **kw)
        per_fit[key] = counts
        cost = cost_of(x, res.centers)
        report(f"{algo} {key}", k, n, res, wall, cost / ref, counts, extra)
        return res, cost

    # the sharded coordinator: tests/test_system.py:128's claim
    for key, kw in (("soccer_sharded_k25", {}),
                    ("soccer_sharded_topk_kmeanspar_k25",
                     dict(sharded_threshold="topk",
                          sharded_seeding="kmeanspar"))):
        res, cost = fit(key, "soccer", SOCCER_KERNELS,
                        sharded_coordinator=True, **paper, **kw)
        check_soccer_structure(res, k, key)
        check(cost <= 1.5 * soc_cost + 0.1 * ref,
              f"{key}: cost {cost} > 1.5x the gather fit's {soc_cost} + "
              f"0.1x the means' {ref}")
        if not kw:
            # D² seeding and bisection move metadata only; k-means‖
            # seeding's candidate scatter is payload, as the reference's
            check(int(np.sum(res.wire_bytes[:res.rounds])) == 0,
                  f"{key}: a sharded round moved payload bytes")
            check_repeat(api, x, k, "soccer", res, f"soccer sharded n={n} "
                         f"k={k}", sharded_coordinator=True, **paper)
    # the mini-batch black box: tests/test_kmeans.py:71's bound
    res, cost = fit("soccer_minibatch_k25", "soccer", SOCCER_KERNELS,
                    blackbox="minibatch", **paper)
    check_soccer_structure(res, k, "soccer blackbox=minibatch")
    check(cost < minibatch_bound(ref), f"soccer blackbox=minibatch: cost "
          f"{cost} >= {MINIBATCH_CLAIM}'s bound {minibatch_bound(ref)}")
    check_repeat(api, x, k, "soccer", res, f"soccer blackbox=minibatch "
                 f"n={n} k={k}", blackbox="minibatch", **paper)
    # the centralized baselines: one gather of all n rows
    for algo in ("lloyd", "minibatch"):
        res, cost = fit(f"{algo}_k{k}", algo, CENTRAL_KERNELS)
        check(res.rounds == 1 and res.uplink_points.tolist() == [n],
              f"{algo}: rounds {res.rounds}, uplink {res.uplink_points}")
        check(res.wire_bytes.tolist() == [n * DIM * 4]
              and res.uplink_bytes.tolist() == [n * DIM * 4],
              f"{algo}: wire bytes {res.wire_bytes} != n * d * 4")
        if algo == "lloyd":
            check(cost <= 3.0 * ref, f"lloyd: cost {cost} > 3x the means' "
                  f"{ref}")
        else:
            check(cost < minibatch_bound(ref), f"minibatch: cost {cost} >= "
                  f"{MINIBATCH_CLAIM}'s bound {minibatch_bound(ref)}")
    # the uplink dtypes: bytes at the dtype's width; int8 codes = values
    fits = {}
    for dtype, wire in (("bfloat16", None), ("float16", None),
                        ("int8", None), ("int8", "values")):
        key = f"soccer_{dtype}{'_values' if wire else ''}_k{k}"
        res, cost = fit(key, "soccer", SOCCER_KERNELS, uplink_dtype=dtype,
                        uplink_wire=wire, **paper)
        check_soccer_structure(res, k, key)
        check(cost <= 3.0 * ref, f"{key}: cost {cost} > 3x means' {ref}")
        width = {"bfloat16": 2, "float16": 2, "int8": 1}[dtype]
        check(np.array_equal(res.uplink_bytes,
                             res.uplink_points * DIM * width),
              f"{key}: uplink bytes not at {width} bytes a coordinate")
        fits[key] = res
    codes, values = fits[f"soccer_int8_k{k}"], fits[f"soccer_int8_values_k{k}"]
    check(np.array_equal(codes.centers, values.centers),
          "int8: the codes wire's centers differ from the values wire's")
    check(np.array_equal(codes.wire_bytes, codes.uplink_bytes),
          "int8 codes: measured payload bytes != modeled bytes")
    check(np.array_equal(4 * codes.wire_bytes, values.wire_bytes),
          "int8: the codes wire's payload is not 1/4 of the values wire's")
    for key in (f"soccer_bfloat16_k{k}", f"soccer_float16_k{k}"):
        check(np.array_equal(fits[key].wire_bytes, fits[key].uplink_bytes),
              f"{key}: measured payload bytes != modeled bytes")
    print(f"int8 at n={n}: codes and values wires give the same centers "
          f"bit for bit; payload {codes.wire_bytes.tolist()} vs "
          f"{values.wire_bytes.tolist()} bytes", flush=True)
    # the baselines on the int8 codes wire
    res, _ = fit(f"kmeans_parallel_int8_k{k}", "kmeans_parallel",
                 KMPAR_KERNELS, uplink_dtype="int8", rounds=5)
    check(res.rounds == 5 and np.array_equal(
        res.uplink_bytes, res.uplink_points * DIM),
        "k-means‖ int8: rounds or uplink bytes")
    res, _ = fit(f"coreset_kmeans_int8_k{k}", "coreset_kmeans",
                 CORESET_KERNELS, uplink_dtype="int8",
                 coreset_size=CORESET_BUDGET)
    check(res.rounds == 1 and res.uplink_bytes.tolist()
          == [CORESET_BUDGET * DIM] and np.array_equal(
              res.wire_bytes, res.uplink_bytes),
          f"coreset_kmeans int8: uplink {res.uplink_bytes} wire "
          f"{res.wire_bytes}")
    # the int8 codes wire into the tier's kernels: SOCCER's coreset uplink
    # (sensitivity_scores) and kzmeans (lloyd_reduce, truncated_cost)
    res, _ = fit(f"soccer_coreset_int8_k{k}", "soccer",
                 SOCCER_CORESET_KERNELS, uplink_dtype="int8",
                 uplink_mode="coreset", **paper)
    check(np.array_equal(res.uplink_bytes, res.uplink_points * DIM)
          and res.extra["const"].uplink_wire == "codes",
          f"soccer coreset int8: uplink bytes {res.uplink_bytes}")
    res, _ = fit(f"kzmeans_int8_k{k}", "kzmeans", KZMEANS_KERNELS,
                 uplink_dtype="int8", outlier_frac=OUTLIER_FRAC,
                 coreset_size=KZ_BUDGET)
    check(res.uplink_bytes.tolist() == [KZ_BUDGET * DIM]
          and np.array_equal(res.wire_bytes, res.uplink_bytes),
          f"kzmeans int8: uplink {res.uplink_bytes} wire {res.wire_bytes}")
    # failures and stragglers (tests/test_ft.py's claims)
    from repro_torch.ft.failures import FailurePlan
    res, cost = fit("soccer_failures_k25", "soccer", SOCCER_KERNELS,
                    failure_plan=FailurePlan(fail_at=FAIL_AT), **paper)
    # round 0's deaths are masked out of the shards before the run, a
    # later one marks its machine failed
    state = res.extra["state"]
    killed = (not bool(state.machine_ok[list(FAIL_AT[1])].any())
              if res.rounds >= 1 else True)
    check(int(res.n_hist[0]) == n - len(FAIL_AT[0]) * (n // MACHINES)
          and not bool(state.alive[list(FAIL_AT[0])].any()) and killed,
          f"failures: n_hist {res.n_hist}, machine_ok "
          f"{state.machine_ok.tolist()}")
    check(cost <= 4.0 * max(soc_cost, ref), f"failures: cost {cost} > 4x "
          f"max(the plain fit's {soc_cost}, the means' {ref})")
    res, cost = fit("soccer_stragglers_k25", "soccer", SOCCER_KERNELS,
                    failure_plan=FailurePlan(straggler_rate=STRAGGLER_RATE),
                    **paper)
    check(int(res.n_hist[0]) == n and bool(
        res.extra["state"].machine_ok.all()),
        f"stragglers lost data: n_hist {res.n_hist}")
    check(res.extra["const"].straggler_rate == STRAGGLER_RATE,
          "straggler_rate lost")
    check_soccer_structure(res, k, "soccer stragglers")


def eim11_bf16_phase(api, KERNELS, per_fit) -> None:
    """EIM11 at n = 1 M on the bfloat16 uplink, against
    tests/test_baselines.py's cost claim, bytes at 2 a coordinate."""
    n, k = EIM11_N, EIM11_K
    x, means = mixture(n, k)
    ref = cost_of(x, means)
    res, wall, counts = run_fit(api, KERNELS, x, k, "eim11", EIM11_KERNELS,
                                uplink_dtype="bfloat16")
    per_fit[f"eim11_bfloat16_k{k}"] = counts
    cost = cost_of(x, res.centers)
    report("eim11 bfloat16", k, n, res, wall, cost / ref, counts)
    check(res.rounds >= 2, f"EIM11 bf16 ran {res.rounds} rounds")
    check(cost <= 6.0 * ref, f"EIM11 bf16 cost {cost} > 6x means' {ref}")
    check(np.array_equal(res.uplink_bytes, res.uplink_points * DIM * 2)
          and np.array_equal(res.wire_bytes, res.uplink_bytes),
          "EIM11 bf16: bytes not at 2 a coordinate")


def knob_profile_phase() -> None:
    """fit_profile's wall, device busy time and idle share of the new
    paths' fits at Table 2 row 1 (n = 10 M, k = 25): the sharded
    coordinator, the mini-batch black box, the int8 codes uplink and the
    centralized lloyd and minibatch."""
    from repro_torch import fit_profile
    for name in ("soccer_sharded", "soccer_minibatch", "soccer_int8",
                 "lloyd", "minibatch"):
        prof = fit_profile.profile_fit(25, N_POINTS, algo=name, top=8)
        check(prof["device_busy_s"] is not None,
              f"fit_profile {name}: the profiler saw no device time")
        print(f"profile {name} k=25 n={N_POINTS}: fit wall "
              f"{prof['wall_s']:.3f} s, host shard placement "
              f"{prof['host_shard_s']:.3f} s, device busy "
              f"{prof['device_busy_s']:.3f} s, idle share "
              f"{prof['device_idle_share']:.3f}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch.cuda.is_available() "
              "is False", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"device: {smi.stdout.strip().splitlines()[0]}", flush=True)

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import api
    from repro_torch.core.soccer import derive_constants
    from repro_torch.configs.soccer_paper import SoccerParams
    from repro_torch.kernels import build, ops, ref

    secs = build.build_all()
    print(f"build: {len(build.SOURCES)} sources in {secs:.2f} s", flush=True)
    for source, kernel in PTXAS_KERNELS:
        check(print_ptxas(build.build_log(source), kernel) > 0,
              f"the build's nvcc log names no {kernel} variant")

    p = N_POINTS // MACHINES
    consts = [derive_constants(N_POINTS, p, SoccerParams(k=k, epsilon=e))
              for k, e in TABLE2]
    rows = kernel_phase(ops, ref, consts)
    width_phase(ops, ref, rows)
    lloyd_phase(ops, ref, rows)
    dispatch_phase(ops, ref, rows)
    tier_phase(ops, ref, rows)
    seeding_phase(ops, ref, rows)
    knob_kernel_phase(ops, ref, rows, SoccerParams)
    sync_phase(SoccerParams)
    tier_sync_phase(SoccerParams)
    kmpar_sync_phase()
    knob_sync_phase(SoccerParams)
    per_fit = {}
    x, means, soc, soc_cost = table2_phase(api, ops.KERNELS, *TABLE2[0],
                                           per_fit)
    for k, eps in TABLE2[1:]:
        table2_phase(api, ops.KERNELS, k, eps, per_fit)
    eim11_s, eim11_rounds = eim11_phase(api, ops.KERNELS, per_fit)
    eim11_sweep_phase(ops, ref, rows, eim11_s, eim11_rounds)
    eim11_bf16_phase(api, ops.KERNELS, per_fit)
    repeat_phase(api)
    coreset_phase(api, ops.KERNELS, x, means, soc, soc_cost, per_fit)
    robust_phase(api, ops.KERNELS, x, means, per_fit)
    central_kernel_phase(ops, ref, x, rows)
    knob_fit_phase(api, ops.KERNELS, x, means, soc, soc_cost, per_fit)
    del x, soc
    wide_phase(api, ops.KERNELS, per_fit)
    profile_phase(rows)
    knob_profile_phase()

    # launches: the fits together, each counted from 0;
    # launches_per_fit: each fit's own count
    line = {"kernels": [dict(
        name=name, route="cuda", source=SOURCES[name],
        replaces=REPLACES[name],
        launches=sum(c[name] for c in per_fit.values()),
        launches_per_fit={fit: c[name] for fit, c in per_fit.items()},
        **rows[name]) for name in ops.KERNELS]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
