"""Measured tuning of the walk's center split on the running card.

The port of ``repro.kernels.autotune``. ``kernels/tuning.py`` hands the
walk its split by a rule; this module times candidate splits on the card
the process runs on and keeps a measured entry only where one beats the
rule. For each key of the tuning table that the repo's own cells reach
where the split decides (fewer point tiles than ``fill_per_sm`` blocks an
SM: ``SHAPES``) it times every candidate (``min_slice`` x
``fill_per_sm`` of ``CANDIDATE_MIN_SLICE`` x ``CANDIDATE_FILL``, the
rule's pair among them) by ``min_dist`` plus the Lloyd kernel
(``fused_assign_reduce``) at the cell's shape, as the reference scores
its panels. A candidate is set through ``tuning.candidate`` while it is
timed, so the sweep adds no parameter to any wrapper; one whose launch
shapes are the rule's or an earlier candidate's is not timed again; one
whose split scratch exceeds ``SCRATCH_BUDGET`` is skipped (the
reference's VMEM filter). The rule is timed ``RULE_REPEATS`` times, and
a key gets an entry only where the best candidate is faster than the
rule's fastest time less its run-to-run spread.

The timer is injectable (``timer(fn, meta) -> ms``); the default is the
median of 3 CUDA-event timings after one warm-up call that builds the
kernels. Tables are keyed by the card (``tuning.card_of``) and written
as JSON:

  python3 -m repro_torch.kernels.autotune            # -> ~/.cache
  python3 -m repro_torch.kernels.autotune --quick    # float32 keys only
  python3 -m repro_torch.kernels.autotune --package  # kernels/tuned/
  python3 -m repro_torch.kernels.autotune --out PATH
  python3 -m repro_torch.kernels.autotune --quick --mode off
                            # each key's lookup printed in that mode
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.kernels import tuning

CANDIDATE_MIN_SLICE = (128, 256, 512, 1024, 2048)
CANDIDATE_FILL = (1, 2, 4, 8)
# the largest split scratch (bytes) a candidate may ask for
SCRATCH_BUDGET = 256 * 2 ** 20
RULE_REPEATS = 3
# (name, n, k, d): the repo's cells where the split decides at some
# candidate: EIM11's weighing and sample (n = 1 M, eps = 0.1), the smoke's
# 20,000 x 4,096 min_dist, SOCCER k = 1000's Lloyd fits (991,418 rows
# against 1,111 centers)
SHAPES = (("eim11_weighing", 65_536, 173_256, 15),
          ("eim11_sample", 14_438, 86_628, 15),
          ("smoke_split", 20_000, 4_096, 15),
          ("soccer_k1000", 991_418, 1_111, 15))
QUICK_DTYPES = (torch.float32,)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)

Timer = Callable[[Callable[[], object], dict], float]


def default_timer(fn: Callable[[], object], meta: dict) -> float:
    """Median ms of 3 CUDA-event timings of ``fn()`` after one warm-up
    call (which builds the kernels)."""
    del meta
    fn()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(statistics.median(times))


def launch_slices(n: int, k: int, d: int, sms: int, pair) -> tuple:
    """(min_dist's, the Lloyd kernel's) center slices at ``pair``."""
    from repro_torch.kernels import fused_lloyd, walk
    with tuning.candidate(pair):
        return tuple(walk.center_slices(n, k, sms, ppt, device="cuda")
                     for ppt in (walk.points_per_thread(d),
                                 fused_lloyd.points_per_thread(k, d)))


def scratch_bytes(n: int, k: int, d: int, sms: int, pair) -> int:
    """The larger split scratch of the two scored kernels at ``pair``."""
    from repro_torch.kernels import fused_lloyd, walk
    md, fl = launch_slices(n, k, d, sms, pair)
    return max(walk.split_scratch_bytes(n, walk.points_per_thread(d), md),
               fused_lloyd.scratch_bytes(
                   n, d, k, fused_lloyd.points_per_thread(k, d), fl))


def _inputs(n: int, k: int, d: int, dtype, device):
    gen = torch.Generator(device).manual_seed(n + k + d)
    x = torch.randn((n, d), generator=gen, device=device).to(dtype)
    c = torch.randn((k, d), generator=gen, device=device)
    w = torch.ones((n,), device=device)
    return x, w, c


def sweep_key(name: str, n: int, k: int, d: int, dtype, *, timer: Timer,
              sms: int, device="cuda", inputs=None) -> dict:
    """The rule's and every candidate's ms at one shape; the record of the
    key (``entry`` None where the rule is not beaten by more than its
    spread)."""
    from repro_torch.kernels import fused_lloyd, min_dist
    x, w, c = inputs if inputs is not None else _inputs(n, k, d, dtype,
                                                        device)
    rule = tuning.rule()
    rule_shape = launch_slices(n, k, d, sms, rule)

    def score(pair, what):
        meta = dict(key=tuning.key(d, k, dtype), shape=(n, k, d),
                    min_slice=pair[0], fill_per_sm=pair[1], what=what)
        with tuning.candidate(pair):
            return (timer(lambda: min_dist.min_dist_cuda(x, c),
                          dict(meta, kernel="min_dist")) +
                    timer(lambda: fused_lloyd.fused_assign_reduce_cuda(
                        x, w, c), dict(meta, kernel="fused_assign_reduce")))

    rule_ms = [score(rule, f"rule {i}") for i in range(RULE_REPEATS)]
    best, skipped, timed = None, 0, 0
    seen = {rule_shape}
    for ms_ in CANDIDATE_MIN_SLICE:
        for fill in CANDIDATE_FILL:
            pair = (ms_, fill)
            shape = launch_slices(n, k, d, sms, pair)
            if shape in seen:       # the rule's or a timed candidate's
                continue
            seen.add(shape)
            if scratch_bytes(n, k, d, sms, pair) > SCRATCH_BUDGET:
                skipped += 1
                continue
            t = score(pair, "candidate")
            timed += 1
            if best is None or t < best[1]:
                best = (pair, t)
    spread = max(rule_ms) - min(rule_ms)
    rec = {"name": name, "shape": [n, k, d], "rule": list(rule),
           "rule_slices": list(rule_shape), "rule_ms": rule_ms,
           "spread_ms": spread, "timed": timed, "skipped": skipped,
           "best": None, "entry": None}
    if best is not None:
        rec["best"] = {"min_slice": best[0][0], "fill_per_sm": best[0][1],
                       "ms": best[1],
                       "slices": list(launch_slices(n, k, d, sms, best[0]))}
        if best[1] < min(rule_ms) - spread:
            rec["entry"] = {"min_slice": best[0][0],
                            "fill_per_sm": best[0][1], "ms": best[1],
                            "rule_ms": min(rule_ms), "spread_ms": spread,
                            "shape": [n, k, d]}
    return rec


def sweep(*, quick: bool = False, dtypes: Optional[Sequence] = None,
          shapes=SHAPES, timer: Optional[Timer] = None, device="cuda",
          card=None, verbose: bool = False) -> dict:
    """The sweep's payload (not saved): ``card``, ``sms``, ``entries``
    {key: entry} where a candidate beat the rule, and every key's record
    under ``keys``. ``card`` (name, SMs) defaults to the running card's."""
    timer = timer or default_timer
    card = tuple(card) if card is not None else tuning.card_of(device)
    dtypes = dtypes or (QUICK_DTYPES if quick else DTYPES)
    entries: Dict[str, dict] = {}
    keys: Dict[str, dict] = {}
    for dtype in dtypes:
        for name, n, k, d in shapes:
            key = tuning.key(d, k, dtype)
            rec = sweep_key(name, n, k, d, dtype, timer=timer, sms=card[1],
                            device=device)
            keys[key] = rec
            if rec["entry"] is not None:
                entries[key] = rec["entry"]
            if verbose:
                best = rec["best"]
                print(f"{key} ({name}, {n} x {k} x {d}): rule "
                      f"{rec['rule']} {min(rec['rule_ms']):.4f} ms (spread "
                      f"{rec['spread_ms']:.4f}), best "
                      + (f"({best['min_slice']}, {best['fill_per_sm']}) "
                         f"{best['ms']:.4f} ms" if best else "none timed")
                      + (" -> entry" if rec["entry"] else " -> rule"),
                      flush=True)
    return {"card": card[0], "sms": card[1], "quick": quick,
            "entries": entries, "keys": keys}


def save_table(payload: dict, path) -> pathlib.Path:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=1, sort_keys=True))
    tuning.invalidate()
    return path


_ENSURED: set = set()


def ensure_tuned(device) -> None:
    """The ``force`` mode's miss: the quick sweep of this card, once a
    process, into the user cache."""
    card = tuning.card_of(device)
    if card in _ENSURED:
        return
    _ENSURED.add(card)
    save_table(sweep(quick=True, device=device, card=card),
               tuning.cache_table_path(card))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="measure the walk's center split on this card")
    ap.add_argument("--quick", action="store_true",
                    help="float32 keys only")
    ap.add_argument("--package", action="store_true",
                    help="write the committed table (kernels/tuned/) "
                         "instead of the user cache")
    ap.add_argument("--out", default=None,
                    help="explicit output path (overrides --package)")
    ap.add_argument("--mode", default="cached", choices=tuning.MODES,
                    help="the lookup mode in which to print each swept "
                         "key's pair after the table is written")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the sweep times kernels on a CUDA card; none is available",
              file=sys.stderr)
        return 2
    card = tuning.card_of("cuda")
    payload = sweep(quick=args.quick, card=card, verbose=True)
    out = (pathlib.Path(args.out) if args.out
           else tuning.package_table_path(card) if args.package
           else tuning.cache_table_path(card))
    path = save_table(payload, out)
    print(f"# {len(payload['entries'])} entries of {len(payload['keys'])} "
          f"keys -> {path}")
    tuning.set_mode(args.mode)
    for key, rec in payload["keys"].items():
        n, k, d = rec["shape"]
        dtype = getattr(torch, key.rsplit(":", 1)[1])
        print(f"# lookup {key} ({args.mode}): "
              f"{tuning.split_params('cuda', d, k, dtype)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
