"""Trace exporters: JSONL (the repo's interchange) + Chrome trace-event.

The port of ``repro.obs.export``: the same line layout and events, so
either package's files load in the other.

JSONL layout — one JSON object per line, grouped into runs:

    {"kind": "run",   ... RunTrace.summary() minus records/spans/events}
    {"kind": "round", ... one pinned-schema per-round record}
    {"kind": "span",  "name": ..., "t0": ..., "t1": ..., "attrs": {...}}
    {"kind": "event", "name": ..., "t": ..., "attrs": {...}}

A ``run`` line opens a run; every following line belongs to it until the
next ``run`` line, so one file holds a whole sweep's traces and
``load_jsonl`` reassembles the original summaries. The Chrome export
writes the standard ``{"traceEvents": [...]}`` JSON that chrome://tracing
and Perfetto's UI open directly: spans become ``"ph": "X"`` duration
events, per-round records become synthetic duration events on a
``rounds`` track (built from ``wall_s`` even in mode="rounds", which has
no spans), carrying the full record in ``args`` for inspection.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, Iterable, List, Optional, Union

from repro_torch.obs.trace import ROUND_FIELDS

PathLike = Union[str, pathlib.Path]

_RUN_KEYS = ("mode", "meta", "stop_reason", "rounds_to_margin", "wall_s",
             "compile_s", "wire_payload_bytes", "wire_meta_bytes")


def _jsonable(obj):
    """Best-effort JSON coercion for meta values (numpy or torch scalars,
    paths)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, bool)) or obj is None:
        return obj
    if isinstance(obj, (int, float)):
        return obj
    if hasattr(obj, "item"):  # numpy and torch scalars
        return obj.item()
    return repr(obj)


def iter_jsonl_lines(summary: Dict[str, Any]) -> Iterable[str]:
    """One trace summary (``RunTrace.summary()``) -> its JSONL lines."""
    head = {"kind": "run"}
    head.update({k: _jsonable(summary.get(k)) for k in _RUN_KEYS})
    yield json.dumps(head)
    for rec in summary.get("records", ()):
        yield json.dumps({"kind": "round", **_jsonable(rec)})
    for sp in summary.get("spans", ()):
        yield json.dumps({"kind": "span", **_jsonable(sp)})
    for ev in summary.get("events", ()):
        yield json.dumps({"kind": "event", **_jsonable(ev)})


def writes_here() -> bool:
    """Whether this process writes exporter files: every process but the
    ranks other than 0 of an initialized process group (every rank of a
    mesh fit holds the same trace)."""
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def write_jsonl(summaries, path: PathLike) -> pathlib.Path:
    """Write one or more trace summaries to ``path`` as JSONL (rank 0
    alone under a process group, ``writes_here``)."""
    if isinstance(summaries, dict):
        summaries = [summaries]
    path = pathlib.Path(path)
    if not writes_here():
        return path
    with path.open("w") as fh:
        for summary in summaries:
            for line in iter_jsonl_lines(summary):
                fh.write(line + "\n")
    return path


def load_jsonl(path: PathLike) -> List[Dict[str, Any]]:
    """Reassemble the list of trace summaries from a JSONL file."""
    runs: List[Dict[str, Any]] = []
    with pathlib.Path(path).open() as fh:
        for ln, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            kind = obj.pop("kind", None)
            if kind == "run":
                runs.append({**{k: obj.get(k) for k in _RUN_KEYS},
                             "records": [], "spans": [], "events": []})
            elif kind in ("round", "span", "event"):
                if not runs:
                    raise ValueError(
                        f"{path}:{ln}: {kind!r} line before any 'run' line")
                key = {"round": "records", "span": "spans",
                       "event": "events"}[kind]
                runs[-1][key].append(obj)
            else:
                raise ValueError(f"{path}:{ln}: unknown line kind {kind!r}")
    return runs


# -------------------------------------------------- Chrome trace-event JSON


def _us(t: Optional[float]) -> float:
    return 0.0 if t is None else float(t) * 1e6


def chrome_trace_events(summary: Dict[str, Any],
                        pid: int = 0) -> List[Dict[str, Any]]:
    """One summary -> Chrome trace-event dicts (``ph: X`` complete events).

    Spans land on the ``spans`` track with their recorded clock times.
    Per-round records have only durations (``wall_s``), so the rounds
    track lays them out back-to-back from t=0 — the relative widths (and
    the attached ``args``) are the signal, not absolute alignment.
    """
    events: List[Dict[str, Any]] = []
    meta = summary.get("meta") or {}
    label = "/".join(str(meta[k]) for k in ("algo", "backend")
                     if k in meta) or "run"
    events.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                   "args": {"name": f"repro fit: {label}"}})
    for tid, track in ((1, "rounds"), (2, "spans")):
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": track}})
    t = 0.0
    for rec in summary.get("records", ()):
        dur = (rec.get("wall_s") or 0.0) + (rec.get("compile_s") or 0.0)
        events.append({
            "name": f"{rec.get('phase', 'round')} {rec.get('round')}",
            "ph": "X", "pid": pid, "tid": 1, "ts": _us(t), "dur": _us(dur),
            "args": {k: rec.get(k) for k in ROUND_FIELDS}})
        t += dur
    base = min((sp["t0"] for sp in summary.get("spans", ())), default=0.0)
    for sp in summary.get("spans", ()):
        events.append({
            "name": sp["name"], "ph": "X", "pid": pid, "tid": 2,
            "ts": _us(sp["t0"] - base), "dur": _us(sp["t1"] - sp["t0"]),
            "args": dict(sp.get("attrs") or {})})
    for ev in summary.get("events", ()):
        events.append({
            "name": ev["name"], "ph": "i", "pid": pid, "tid": 2,
            "ts": _us(ev["t"] - base), "s": "t",
            "args": dict(ev.get("attrs") or {})})
    return events


def write_chrome_trace(summaries, path: PathLike) -> pathlib.Path:
    """Write Perfetto/chrome://tracing-loadable trace-event JSON (rank 0
    alone under a process group, ``writes_here``)."""
    if isinstance(summaries, dict):
        summaries = [summaries]
    if not writes_here():
        return pathlib.Path(path)
    events: List[Dict[str, Any]] = []
    for pid, summary in enumerate(summaries):
        events.extend(chrome_trace_events(summary, pid=pid))
    path = pathlib.Path(path)
    path.write_text(json.dumps(
        {"traceEvents": events, "displayTimeUnit": "ms"}))
    return path
