"""The run-report CLI: render per-round trace tables and run diffs.

    # one run (or several) written by obs.export.write_jsonl from
    # fit(trace=...).extra["trace"]:
    python -m repro_torch.obs.report trace.jsonl

    # diff two runs (e.g. SOCCER vs k-means|| on the same scenario):
    python -m repro_torch.obs.report soccer.jsonl kmeanspar.jsonl

    # convert to Chrome trace-event JSON (open in Perfetto / chrome://tracing)
    python -m repro_torch.obs.report trace.jsonl --chrome trace.chrome.json

The port of ``repro.obs.report``: it reads the JSONL of either package
and renders it with the same strings. ``repro_torch.api.selfcheck``
prints through the same helpers.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs.export import load_jsonl, write_chrome_trace

_COLS = (
    ("round", 5), ("phase", 8), ("n_live", 10), ("alpha", 8), ("v", 10),
    ("removed", 10), ("stop_ratio", 10), ("stop_margin", 11),
    ("uplink_rows", 11), ("wire_B", 10), ("wall_s", 8), ("compile_s", 9),
)


def _cell(rec: Dict[str, Any], name: str) -> str:
    if name == "wire_B":
        p, m = rec.get("wire_payload_bytes"), rec.get("wire_meta_bytes")
        return "—" if p is None else str(int(p) + int(m or 0))
    v = rec.get(name)
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.3g}"
    return str(v)


def format_round_table(summary: Dict[str, Any]) -> str:
    """The round-by-round table for one run summary."""
    header = "  ".join(n.ljust(w) for n, w in _COLS)
    lines = [header, "  ".join("-" * w for _, w in _COLS)]
    for rec in summary.get("records", ()):
        lines.append("  ".join(_cell(rec, n).ljust(w) for n, w in _COLS))
    return "\n".join(lines)


def _label(summary: Dict[str, Any]) -> str:
    meta = summary.get("meta") or {}
    bits = [str(meta[k]) for k in ("scenario", "condition", "algo",
                                   "backend") if meta.get(k)]
    return " / ".join(bits) or "run"


def format_summary(summary: Dict[str, Any]) -> str:
    """One-screen header + table: what selfcheck and the CLI print."""
    rounds = [r for r in summary.get("records", ())
              if r.get("phase") == "round"]
    wire = ((summary.get("wire_payload_bytes") or 0)
            + (summary.get("wire_meta_bytes") or 0))
    wall = summary.get("wall_s")
    comp = summary.get("compile_s")
    head = [
        f"# {_label(summary)} (trace={summary.get('mode')})",
        f"rounds={len(rounds)} stop_reason={summary.get('stop_reason')} "
        f"rounds_to_margin={summary.get('rounds_to_margin')} "
        f"wire_bytes={wire}"
        + ("" if wall is None else
           f" wall={wall:.3f}s (compile {0.0 if comp is None else comp:.3f}s"
           f", {0.0 if not wall else min(1.0, (comp or 0.0) / wall):.0%})"),
    ]
    return "\n".join(head) + "\n" + format_round_table(summary)


# ----------------------------------------------------------------- diffs

_DIFF_FIELDS = ("n_live", "uplink_rows", "wire_B", "wall_s")


def format_diff(a: Dict[str, Any], b: Dict[str, Any]) -> str:
    """Side-by-side per-round diff of two runs (rounds, bytes, stop)."""
    la, lb = _label(a), _label(b)
    ra = {r["round"]: r for r in a.get("records", ())}
    rb = {r["round"]: r for r in b.get("records", ())}
    lines = [f"# A = {la}", f"# B = {lb}", ""]
    na = len([r for r in a.get("records", ()) if r.get("phase") == "round"])
    nb = len([r for r in b.get("records", ()) if r.get("phase") == "round"])
    wa = ((a.get("wire_payload_bytes") or 0) + (a.get("wire_meta_bytes")
                                                or 0))
    wb = ((b.get("wire_payload_bytes") or 0) + (b.get("wire_meta_bytes")
                                                or 0))
    lines.append(f"rounds:      A={na}  B={nb}  (B-A {nb - na:+d})")
    lines.append(f"wire bytes:  A={wa}  B={wb}  "
                 f"(B/A {wb / wa:.2f}x)" if wa else
                 f"wire bytes:  A={wa}  B={wb}")
    lines.append(f"stop_reason: A={a.get('stop_reason')}  "
                 f"B={b.get('stop_reason')}")
    lines.append("")
    hdr = ["round"] + [f"A.{f}" for f in _DIFF_FIELDS] + [
        f"B.{f}" for f in _DIFF_FIELDS]
    widths = [5] + [11] * (2 * len(_DIFF_FIELDS))
    lines.append("  ".join(h.ljust(w) for h, w in zip(hdr, widths)))
    lines.append("  ".join("-" * w for w in widths))
    for rnd in sorted(set(ra) | set(rb)):
        row = [str(rnd)]
        for side in (ra, rb):
            rec = side.get(rnd)
            row.extend("—" if rec is None else _cell(rec, f)
                       for f in _DIFF_FIELDS)
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
    return "\n".join(lines)


def _select_run(runs: List[Dict[str, Any]], selector: Optional[str],
                path: str) -> Dict[str, Any]:
    if not runs:
        raise SystemExit(f"{path}: no runs in file")
    if selector is None:
        return runs[0]
    try:
        return runs[int(selector)]
    except (ValueError, IndexError):
        matches = [r for r in runs if selector in _label(r)]
        if len(matches) != 1:
            raise SystemExit(
                f"{path}: --run {selector!r} matches {len(matches)} of "
                f"{len(runs)} runs; labels: "
                f"{', '.join(_label(r) for r in runs[:20])}") from None
        return matches[0]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="render per-round trace tables / diff two traced runs")
    ap.add_argument("trace", help="trace JSONL (fit(trace=...) export)")
    ap.add_argument("other", nargs="?",
                    help="second trace JSONL: print a per-round diff")
    ap.add_argument("--run", default=None,
                    help="select one run from a multi-run file, by index "
                         "or label substring (default: first; ignored "
                         "with --all)")
    ap.add_argument("--all", action="store_true",
                    help="render every run in the file (single-file mode)")
    ap.add_argument("--chrome", metavar="OUT.json",
                    help="also write Chrome trace-event JSON (Perfetto)")
    args = ap.parse_args(argv)

    runs = load_jsonl(args.trace)
    if args.chrome:
        out = write_chrome_trace(runs, args.chrome)
        print(f"# wrote {out} ({len(runs)} run(s); open in Perfetto or "
              f"chrome://tracing)")
    if args.other:
        a = _select_run(runs, args.run, args.trace)
        b = _select_run(load_jsonl(args.other), args.run, args.other)
        print(format_diff(a, b))
        return 0
    if args.all:
        for i, run in enumerate(runs):
            if i:
                print()
            print(format_summary(run))
        return 0
    print(format_summary(_select_run(runs, args.run, args.trace)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
