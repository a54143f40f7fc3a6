"""Smoke test of the PyTorch port of SOCCER on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. It

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc/``;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes SOCCER's main path gives it (paper Table 2 rows 1 and 2, n = 10 M
   points, d = 15, m = 8 machines), in float32, bfloat16 and float16, with
   invalid centers and zero weights, and times kernel, plain version and
   the closest PyTorch call (``torch.cdist``, which computes the whole
   distance matrix rather than the same function); then holds them
   against their plain versions off the main path's shape too: d = 37
   and d = 513 (the any-width kernel variant, several center tiles) and
   k = 1024 at d = 15 (two tiles);
4. runs one SOCCER round with CUDA's sync debug mode set to "error", so
   a device->host synchronization inside a round fails the run;
5. runs ``repro_torch.api.fit`` on both Table 2 instances at n = 10 M and
   checks the paper's bounds and that every kernel was launched.

It prints one JSON line of per-kernel numbers before the last line
(``launches`` sums both fits, ``launches_per_fit`` gives each), and
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
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
N_POINTS, DIM, MACHINES = 10_000_000, 15, 8
TABLE2 = ((25, 0.05), (100, 0.05))    # (k, epsilon), delta = 0.1
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
SOURCES = {"min_dist": "src/repro_torch/kernels/csrc/min_dist.cu",
           "remove_below": "src/repro_torch/kernels/csrc/fused_lloyd.cu",
           "update_min_dist": "src/repro_torch/kernels/csrc/fused_lloyd.cu",
           "fused_assign_reduce":
               "src/repro_torch/kernels/csrc/fused_lloyd.cu"}
REPLACES = {"min_dist": "src/repro/kernels/min_dist.py:61",
            "remove_below": "src/repro/kernels/fused_lloyd.py:279",
            "update_min_dist": "src/repro/kernels/fused_lloyd.py:352",
            "fused_assign_reduce": "src/repro/kernels/fused_lloyd.py:138"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def timed_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds per call, after a warm-up, by CUDA events."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def plain_top2(x, c, cv):
    """Plain expanded-form d2 to the nearest and second-nearest valid
    center (float32, no TF32)."""
    xf, cf = x.float(), c.float()
    d2 = (xf * xf).sum(-1)[:, None] - 2.0 * (xf @ cf.T) + (cf * cf).sum(-1)
    if cv is not None:
        d2 = torch.where(cv[None, :], d2, torch.inf)
    top = torch.topk(d2, min(2, d2.shape[1]), dim=1, largest=False).values
    second = top[:, 1] if top.shape[1] > 1 else torch.full_like(top[:, 0],
                                                               torch.inf)
    return top[:, 0], second


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


def check_fused(ops, ref, x, w, c, cv):
    tol = d2_tol(x, c)
    s_k, n_k, cost_k = ops.fused_assign_reduce(x, w, c, cv)
    s_p, n_p, cost_p = ref.fused_assign_reduce_ref(x, w, c, cv)
    best, second = plain_top2(x, c, cv)
    amb = (second - best) <= tol          # may go to either center
    wa = w[amb].float()
    slack_n = float(wa.sum())
    slack_s = float((wa * x[amb].float().abs().max(-1).values).sum())
    rel = 1e-5
    e_s = float((s_k - s_p).abs().max())
    e_n = float((n_k - n_p).abs().max())
    e_c = abs(float(cost_k) - float(cost_p))
    t_s = rel * float(s_p.abs().max()) + 2 * slack_s
    t_n = rel * float(n_p.abs().max()) + 2 * slack_n
    t_c = rel * abs(float(cost_p)) + tol * float(w.sum())
    check(e_s <= t_s, f"fused_assign_reduce sums err {e_s} > {t_s}")
    check(e_n <= t_n, f"fused_assign_reduce counts err {e_n} > {t_n}")
    check(e_c <= t_c, f"fused_assign_reduce cost err {e_c} > {t_c}")
    if cv is not None:
        check(float(n_k[~cv].abs().sum()) == 0.0,
              "fused_assign_reduce gave mass to an invalid center")
    return e_c, t_c


def check_remove_below(ops, ref, x, c, alive, v, cv):
    m, p, d = x.shape
    tol = d2_tol(x.reshape(m * p, d)[:1_000_000], c)
    a_k, l_k = ops.remove_below(x, c, alive, v, cv)
    a_p, _ = ref.remove_below_ref(x, c, alive, v, cv)
    check(torch.equal(l_k, a_k.sum(1, dtype=torch.int32)),
          "remove_below counts disagree with its own mask")
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
                err, tol = check_fused(ops, ref, x, w, c, mask)
                note("fused_assign_reduce", err)
                print(f"check fused_assign_reduce n={eta} k={kp} {dt} mask="
                      f"{mask is not None} cost_abs_err={err:.3g} "
                      f"tol={tol:.3g}")
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
                          f" mask={mask is not None} flips={nflip} "
                          f"max_abs_err={err:.3g} tol={tol:.3g}")
            del xm
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
            print(f"time {name} {shape} f32: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, torch.cdist {lib_ms:.4f} ms, bound "
                  f"{bnd:.4f} ms ({by})")
            if ci == 0:
                rows[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bnd,
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
                    "fused_assign_reduce": check_fused(ops, ref, x, w, c,
                                                       mask)[0]}
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


def fit_phase(api, KERNELS, k, eps):
    from repro_torch.configs.soccer_paper import GaussianMixtureSpec
    from repro_torch.core.metrics import centralized_cost
    from repro_torch.data.synthetic import gaussian_mixture
    spec = GaussianMixtureSpec(n=N_POINTS, dim=DIM, k=k, sigma=0.001,
                               zipf_gamma=1.5, seed=17)
    x, _, means = gaussian_mixture(spec)
    torch.cuda.synchronize()
    for kern in KERNELS.values():
        kern.launches = 0
    t0 = time.perf_counter()
    res = api.fit(x, k, algo="soccer", m=MACHINES, epsilon=eps, delta=0.1,
                  seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: kern.launches for name, kern in KERNELS.items()}
    const = res.extra["const"]
    xg = torch.from_numpy(x).cuda()
    cost = float(centralized_cost(xg, torch.from_numpy(res.centers).cuda()))
    ref = float(centralized_cost(xg, torch.from_numpy(means).cuda()))
    del xg
    up = res.uplink_points
    print(f"fit k={k} eps={eps} n={N_POINTS}: rounds={res.rounds} "
          f"eta={const.eta} k_plus={const.k_plus} n_hist={res.n_hist.tolist()}"
          f" uplink={up.tolist()} wire_bytes_total={res.wire_bytes_total} "
          f"|C_out|={res.centers.shape[0]} wall_s={wall:.3f} "
          f"cost/means_cost={cost / ref:.4f} launches={counts}")
    check(all(v > 0 for v in counts.values()),
          f"a kernel was not launched on the main path: {counts}")
    ns = res.n_hist[: res.rounds + 1]
    check(all(ns[i + 1] < ns[i] for i in range(res.rounds)),
          f"n_hist not strictly decreasing: {ns.tolist()}")
    check(res.centers.shape[0] <= res.rounds * const.k_plus + k,
          "|C_out| > I*k_plus + k")
    check(all(up[r] <= 2 * const.eta + MACHINES for r in range(res.rounds)),
          "per-round uplink > 2*eta + m")
    check(np.isfinite(res.centers).all() and res.centers.shape[1] == DIM,
          "centers not finite (c, d)")
    check(cost <= 3.0 * ref, f"cost {cost} > 3x mixture means' cost {ref}")
    return counts


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

    p = N_POINTS // MACHINES
    consts = [derive_constants(N_POINTS, p, SoccerParams(k=k, epsilon=e))
              for k, e in TABLE2]
    rows = kernel_phase(ops, ref, consts)
    width_phase(ops, ref, rows)
    sync_phase(SoccerParams)
    per_fit = {f"k{k}": fit_phase(api, ops.KERNELS, k, eps)
               for k, eps in TABLE2}

    # launches: both Table 2 fits together, each counted from 0;
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
