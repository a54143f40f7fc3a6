"""Report formatting for scenario sweeps: one aligned table + BENCH json.

The port of ``repro.scenarios.report``. The JSON artifact
(``BENCH_scenarios_torch.json`` by default; the port never writes the
reference's ``BENCH_scenarios.json``) keeps the rows of the printed
table cell for cell, plus the device they ran on.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import time
from typing import Optional, Sequence

from repro_torch.device import DeviceLike, resolve_device

_COLUMNS = (
    ("scenario", 22), ("algo", 16), ("condition", 16), ("cost_ratio", 10),
    ("rounds", 6), ("uplink_pts", 10), ("uplink_MB", 9), ("wire_MB", 9),
    ("x_omega", 9), ("time_s", 7), ("compile_s", 9), ("stop", 12),
    ("rnd_margin", 10),
)
# uplink_MB is the MODELED volume (uplink-dtype accounting); wire_MB the
# ACHIEVED volume measured at the collectives' itemsizes, and x_omega is
# wire bytes over the Ω(m·k) frontier (Zhang et al., arXiv:1507.00026).
# stop / rnd_margin come from the per-cell trace (repro_torch.obs): why the
# round loop ended, and the first round whose live set fit the
# coordinator (the round count's explanation).


def _fmt(row: dict) -> Sequence[str]:
    if row.get("skipped"):
        return (row["scenario"], row["algo"], row["condition"],
                "—", "—", "—", "—", "—", "—", "—", "—", "—", "—")
    wire = row.get("wire_bytes")
    omega = row.get("bytes_vs_omega_mk")
    rtm = row.get("rounds_to_margin")
    return (
        row["scenario"], row["algo"], row["condition"],
        f"{row['cost_ratio']:.3f}",
        str(row["rounds"]),
        str(row["uplink_points"]),
        f"{row['uplink_bytes'] / 1e6:.3f}",
        "—" if wire is None else f"{wire / 1e6:.3f}",
        "—" if omega is None else f"{omega:.1f}",
        f"{row['wall_time_s']:.2f}",       # steady-state (compile excluded)
        f"{row.get('compile_s', 0.0):.2f}",
        row.get("stop_reason") or "—",
        "—" if rtm is None else str(rtm),
    )


def format_table(rows: Sequence[dict]) -> str:
    header = [name for name, _ in _COLUMNS]
    widths = [w for _, w in _COLUMNS]
    lines = ["  ".join(h.ljust(w) for h, w in zip(header, widths)),
             "  ".join("-" * w for w in widths)]
    for row in rows:
        cells = _fmt(row)
        lines.append("  ".join(str(c).ljust(w)
                               for c, w in zip(cells, widths)))
    return "\n".join(lines)


def summarize_gap(rows: Sequence[dict]) -> Optional[str]:
    """The adversarial-scenario headline: SOCCER rounds vs k-means‖
    rounds-to-match (None when the sweep did not run that scenario)."""
    adv = [r for r in rows if r["scenario"] == "adversarial_kmeanspar"
           and not r.get("skipped")]
    soccer = next((r for r in adv if r["algo"] == "soccer"), None)
    kp = next((r for r in adv if r["algo"] == "kmeans_parallel"), None)
    if not (soccer and kp):
        return None
    matched = ("" if kp.get("rounds_matched_target", True)
               else f" (cost never matched within {kp['rounds']} rounds)")
    return (f"adversarial gap: SOCCER {soccer['rounds']} round(s) vs "
            f"k-means|| {kp['rounds']} round(s) to match cost{matched}")


def device_label(device: DeviceLike = "cuda") -> str:
    """What ran the sweep: ``"cpu"``, or on the card nvidia-smi's
    ``name, power.limit`` line (a card below its full power limit runs
    slower, so every time carries it)."""
    if resolve_device(device).type == "cpu":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return smi.stdout.strip().splitlines()[0]


def write_bench_json(rows: Sequence[dict], path, *, suite: str,
                     quick: bool, algos: Sequence[str],
                     seed: int, device: str) -> pathlib.Path:
    """``device`` is ``device_label``'s string for the sweep's device."""
    path = pathlib.Path(path)
    payload = {
        "kind": "scenario_sweep",
        "suite": suite,
        "quick": quick,
        "algos": list(algos),
        "seed": seed,
        "device": device,
        "unix_time": int(time.time()),
        "gap": summarize_gap(rows),
        # full per-round traces ship separately (run.py --trace-out
        # JSONL); the perf-trajectory artifact keeps only the row scalars
        "rows": [{k: v for k, v in row.items() if k != "trace"}
                 for row in rows],
    }
    path.write_text(json.dumps(payload, indent=1, default=str))
    return path
