"""Time the kernels that take the tiled walk at d > 16 on one CUDA card
(``min_dist``, the Lloyd step, ``remove_below`` and the seeding step),
and check their bits against the register-blocked walk.

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
profiler sees device time. Then ``remove_below`` at REMOVE_SHAPES (every
point alive, v the median d2) and, at SEED_SHAPES, the seeding step
against one center (a row of x): the draw-off ``update_min_dist`` call
(its mass pass included) and a draw-on step (``kmeans_pp_step_cuda``,
d2 lowered in place), each beside its plain version, ``torch.cdist`` and
its bound.

With ``--check`` it first holds, in float32, bfloat16 and float16, with
and without a center mask and with no valid center, at CHECK_SHAPES:
``min_dist``'s (d2, argmin) and the Lloyd step's ``assign_out`` against
``sensitivity_scores`` at w = 1 (its scores are 1·d2, exact, and its
argmin is the register-blocked walk's), bit for bit, and the Lloyd
step's sums and counts against ``ref.fixed_point_reduce_ref`` over that
argmin, bit for bit; ``remove_below``'s mask and counts against
``alive & (scores > v)`` over two machines, and ``update_min_dist``'s d2
against ``min(d2, scores)`` at k centers and at one, bit for bit; then,
unmasked, a draw-on step's d2 against the draw-off call's at the same
center, ``kmeans_pp_step_at`` over two parts against the one-call step's
words, and a whole seeding against its chained steps and its repeat.

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
# (m, p, k, d): the tables' removals, every row alive (PERF.md §6 row 2)
REMOVE_SHAPES = ((8, 20_480, 78, 7_168), (8, 18_992, 78, 1_536))
# (n, d): the tables' coordinator seedings, one center a step
SEED_SHAPES = ((43_106, 7_168), (42_460, 1_536))
SEED_STEPS = 6              # steps of the seeding checked by --check
# (n, k, d): ragged n, more centers than a center tile, odd d
CHECK_SHAPES = ((1_001, 78, 7_168), (3_001, 300, 37), (2_000, 190, 513),
                (129, 81, 17), (500, 5, 1_536))
PEAK_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BYTES = 3.35e12        # HBM3


def bound_ms(nbytes: float, flops: float):
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def check_seeding(ops, ref, x, w, seed, what: str) -> None:
    """A draw-on step's d2 against the draw-off call's at the same center,
    the step over two parts (``kmeans_pp_step_at``) against the one-call
    step's d2 and words, and a SEED_STEPS seeding against its chained
    steps and its repeat, bit for bit."""
    from repro_torch.kernels import fused_lloyd as fl
    n = x.shape[0]
    d2 = torch.full((n,), torch.inf, device="cuda")
    prev, chain, cut = None, [], n // 3
    for step in range(SEED_STEPS):
        center = None if prev is None else x[prev].float()
        off = None if center is None else ops.update_min_dist(
            x, w, center.reshape(1, -1), d2)[0]
        parts = [fl.kmeans_pp_step_at_cuda(x[lo:hi], w[lo:hi],
                                           d2[lo:hi].clone(), center, step,
                                           seed, lo)
                 for lo, hi in ((0, cut), (cut, n))]
        words = fl.kmeans_pp_step_cuda(x, w, d2, prev, step, seed)
        if off is not None and not torch.equal(d2, off):
            sys.exit(f"check failed at {what} step {step}: the draw-on d2 "
                     f"differs from the draw-off call's")
        whole = ref.max_word(torch.stack([wd for _, wd in parts]), dim=0)
        if not (torch.equal(torch.cat([p for p, _ in parts]), d2)
                and torch.equal(whole, words)):
            sys.exit(f"check failed at {what} step {step}: the step over "
                     f"two parts differs from the one-call step")
        prev = ref.winner_from_words(words)
        chain.append(prev)
    idx = ops.kmeans_plusplus_indices(x, w, SEED_STEPS, seed)
    if not (torch.equal(idx, torch.stack(chain)) and torch.equal(
            idx, ops.kmeans_plusplus_indices(x, w, SEED_STEPS, seed))):
        sys.exit(f"check failed at {what}: the C loop's draws differ from "
                 f"the chained steps or from its repeat")


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
        d2_0 = torch.rand(n, generator=g, device="cuda") * d
        alive = torch.rand((2, n // 2), generator=g, device="cuda") > 0.2
        seed = torch.randint(0, 1 << 32, (2,), generator=g, device="cuda")
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
                # remove_below over two machines, v the median score
                p = n // 2
                v = torch.nan_to_num(torch.median(sc), posinf=1.0)
                keep, live = ops.remove_below(x[:2 * p].view(2, p, d), c,
                                              alive, v, mask)
                want = alive & (sc[:2 * p].view(2, p) > v)
                # the draw-off step at k centers and at the first one
                up, _ = ops.update_min_dist(x, w, c, d2_0, mask)
                one = None if mask is None else mask[:1]
                up1, _ = ops.update_min_dist(x, w, c[:1], d2_0, one)
                sc1, _, _, _ = ops.sensitivity_scores(x, ones, c[:1], one)
                ok = {"remove_below's mask and counts": torch.equal(
                          keep, want) and torch.equal(
                          live, want.sum(1, dtype=torch.int32)),
                      "update_min_dist's d2": torch.equal(
                          up, torch.where(sc < d2_0, sc, d2_0)),
                      "its d2 at one center": torch.equal(
                          up1, torch.where(sc1 < d2_0, sc1, d2_0))}
                if not all(ok.values()):
                    sys.exit(f"check failed at {what}: {ok}")
                held += 1
            check_seeding(ops, ref, x, w, seed, f"n={n} d={d} {dt}")
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
    for m, p, k, d in REMOVE_SHAPES:
        g = torch.Generator("cuda").manual_seed(m + p + k + d)
        x = torch.randn((m, p, d), generator=g, device="cuda")
        c = torch.randn((k, d), generator=g, device="cuda")
        alive = torch.ones((m, p), dtype=torch.bool, device="cuda")
        v = torch.median(ops.min_dist(x.view(m * p, d), c)[0])
        rb = timed_ms(lambda: ops.remove_below(x, c, alive, v), args.reps)
        rb_p = timed_ms(lambda: ref.remove_below_ref(x, c, alive, v),
                        args.reps)
        cd = timed_ms(lambda: torch.cdist(x.view(m * p, d), c), args.reps)
        b = bound_ms(m * p * d * 4 + 2 * m * p + k * d * 4 + 4 + m * 4,
                     2.0 * m * p * k * d)
        print(f"remove_below m={m} p={p} k={k} d={d} f32: {rb:.4f} ms "
              f"(bound {b[0]:.4f} {b[1]}, {100 * b[0] / rb:.1f}%), plain "
              f"{rb_p:.4f} ms, torch.cdist {cd:.4f} ms", flush=True)
        out.append(dict(kernel="remove_below", m=m, p=p, k=k, d=d, ms=rb,
                        plain_ms=rb_p, cdist_ms=cd, bound_ms=b[0]))
        del x, c, alive
        torch.cuda.empty_cache()
    from repro_torch.kernels import fused_lloyd as tfl
    for n, d in SEED_SHAPES:
        g = torch.Generator("cuda").manual_seed(n + d)
        x = torch.randn((n, d), generator=g, device="cuda")
        w = torch.ones(n, device="cuda")
        d2 = torch.rand(n, generator=g, device="cuda") * d
        seed = torch.tensor([3, 5], device="cuda")
        prev = torch.tensor(5, device="cuda")
        c1 = x[5:6]
        gs = ref.seed_gumbel(seed, n, range(1, 2))[0]
        d2_on = d2.clone()
        off = timed_ms(lambda: ops.update_min_dist(x, w, c1, d2), args.reps)
        on = timed_ms(lambda: tfl.kmeans_pp_step_cuda(x, w, d2_on, prev, 1,
                                                      seed), args.reps)
        off_p = timed_ms(lambda: ref.update_min_dist_ref(x, w, c1, d2),
                         args.reps)
        on_p = timed_ms(lambda: ref.kmeans_pp_step_ref(x, w, d2, prev, gs),
                        args.reps)
        cd = timed_ms(lambda: torch.cdist(x, c1), args.reps)
        b = bound_ms(n * d * 4 + 3 * n * 4 + d * 4 + 4, 2.0 * n * d + 2.0 * n)
        print(f"seeding step n={n} d={d} one center f32: draw off {off:.4f} "
              f"ms, draw on {on:.4f} ms (bound {b[0]:.4f} {b[1]}, "
              f"{100 * b[0] / off:.1f}% / {100 * b[0] / on:.1f}%), plain "
              f"{off_p:.4f} / {on_p:.4f} ms, torch.cdist {cd:.4f} ms",
              flush=True)
        out.append(dict(kernel="update_min_dist", n=n, d=d, ms=off,
                        step_ms=on, plain_ms=off_p, step_plain_ms=on_p,
                        cdist_ms=cd, bound_ms=b[0]))
        del x, w, d2, d2_on
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "src": args.src, "calls": out}))


if __name__ == "__main__":
    main()
