"""Per-run structured tracing: spans, events, and per-round records.

The port of ``repro.obs.trace``. Design constraints, as the reference's:

* **Off by default, near-zero-cost when off.** Every public hook
  (``span``/``event``/``emit_round``/``current_trace``) is one
  list-truthiness check when no trace is active: no allocation, no clock
  read, no string formatting. The module stat counter ``_STATS`` lets
  tests assert that an untraced ``fit()`` allocated zero spans and zero
  traces.
* **Injectable clock.** All timestamps come from the module clock
  (``clock()``, default ``time.perf_counter``); ``set_clock`` swaps it
  for a fake in tests. Everything in the port that times a fit (the
  facade, the stream updates, the serving histogram) reads THIS clock.
* **``torch.profiler.record_function`` passthrough.** In ``mode="full"``
  with ``annotate=True`` (what ``fit(trace="full")`` builds), each span
  also opens a profiler range, so the repo's spans line up with the
  kernels in a captured ``torch.profiler`` trace.
* **No added synchronization.** A driver times a step clock to clock
  around the step and the one device->host read it makes anyway; tracing
  never waits for the card on its own.

The per-round record schema (``ROUND_SCHEMA``) is the reference's: the
same 14 field names and value types in the same order, so JSONL written
by either package reads in the other. Fields that do not apply to an
algorithm (e.g. ``v`` for k-means‖) are ``None``.

The reference's ``timed_compile`` (ahead-of-time lowering of a jitted
step) has no eager counterpart: the port's compile is the kernels'
first-call ``nvcc`` build (``kernels/build.py``). ``StepClock`` times a
step and splits off the build seconds the step triggered: ``compile_s``
is those seconds (None when every kernel was already built) and
``wall_s`` the rest. Drivers take one from ``step_clock()``, a shared
no-op when no trace is active, so they keep one code path.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.kernels.build import build_seconds

# ------------------------------------------------------------------ clock

_CLOCK: Callable[[], float] = time.perf_counter


def clock() -> float:
    """The one wall clock every timed path of the port reads."""
    return _CLOCK()


def set_clock(fn: Optional[Callable[[], float]]) -> Callable[[], float]:
    """Swap the module clock (tests); returns the previous clock.
    ``set_clock(None)`` restores the default ``time.perf_counter``."""
    global _CLOCK
    prev = _CLOCK
    _CLOCK = time.perf_counter if fn is None else fn
    return prev


# ------------------------------------------------------------- the schema

# The pinned per-round record: (field name, type of non-None values).
ROUND_SCHEMA = (
    ("round", int),               # 1-based communication round index
    ("phase", str),               # "round" | "finalize" | "upload"
    ("n_live", int),              # live points at the round's start
    ("capacity", int),            # stopping capacity (SOCCER eta, EIM11 s)
    ("alpha", float),             # realized P2 sampling rate (SOCCER)
    ("v", float),                 # removal threshold broadcast this round
    ("removed", int),             # points removed by this round
    ("stop_ratio", float),        # n_live_after / capacity
    ("stop_margin", float),       # n_live_after - capacity (<= 0: stop)
    ("uplink_rows", int),         # realized uploaded rows this round
    ("wire_payload_bytes", int),  # achieved payload bytes (WireTally)
    ("wire_meta_bytes", int),     # achieved metadata-sideband bytes
    ("wall_s", float),            # host wall time of this round's step
    ("compile_s", float),         # kernel build time the step triggered
)
ROUND_FIELDS = tuple(name for name, _ in ROUND_SCHEMA)

PHASES = ("round", "finalize", "upload")

TRACE_MODES = ("rounds", "full")

# Allocation stats for the zero-overhead-when-off test: traces created,
# spans entered, records emitted. Incremented only on the active paths.
_STATS = collections.Counter()


def round_record(**fields) -> Dict[str, Any]:
    """Build one schema-conforming per-round record.

    Unknown field names raise (the schema is pinned); missing fields are
    ``None``; present values are coerced to the schema type, so exported
    records are JSON-stable whatever numpy or torch scalars drivers pass.
    """
    unknown = sorted(set(fields) - set(ROUND_FIELDS))
    if unknown:
        raise ValueError(
            f"unknown round-record field(s) {', '.join(unknown)}; the "
            f"schema is pinned to {ROUND_FIELDS}")
    phase = fields.get("phase")
    if phase is not None and phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r}: expected one of {PHASES}")
    out: Dict[str, Any] = {}
    for name, typ in ROUND_SCHEMA:
        v = fields.get(name)
        out[name] = None if v is None else typ(v)
    return out


class StepClock:
    """Times one traced driver step for its round record.

    Started at construction; ``stop()`` is called right after the step's
    first device->host read, the read the untraced step makes too.
    ``compile_s`` is the seconds of kernel builds (``nvcc``) the step
    triggered, None when it built nothing; ``wall_s`` is the clock from
    start to stop less those seconds.
    """

    __slots__ = ("t0", "b0", "wall_s", "compile_s")

    def __init__(self):
        self.b0 = build_seconds()
        self.wall_s: Optional[float] = None
        self.compile_s: Optional[float] = None
        self.t0 = clock()

    def stop(self) -> "StepClock":
        t1 = clock()
        built = build_seconds() - self.b0
        self.compile_s = built if built > 0.0 else None
        self.wall_s = t1 - self.t0 - built
        return self


class _NullClock:
    """The do-nothing step clock handed out whenever tracing is off."""

    __slots__ = ()
    wall_s = compile_s = None

    def stop(self) -> "_NullClock":
        return self


_NULL_CLOCK = _NullClock()


def step_clock():
    """A started ``StepClock`` inside an active trace, else a shared
    no-op (no allocation, no clock read when tracing is off)."""
    if not _STACK:
        return _NULL_CLOCK
    return StepClock()


# ------------------------------------------------------------------- spans


class Span:
    """One named, timed interval inside a ``mode="full"`` trace.

    Records ``(name, t0, t1, attrs)`` on exit; with ``annotate`` it also
    opens a ``torch.profiler.record_function`` range of the same name.
    """

    __slots__ = ("name", "attrs", "t0", "t1", "_trace", "_annotation")

    def __init__(self, name: str, trace: "RunTrace", attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.t0 = self.t1 = 0.0
        self._trace = trace
        self._annotation = None

    def __enter__(self) -> "Span":
        _STATS["spans"] += 1
        if self._trace.annotate:
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self.t0 = clock()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = clock()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        self._trace.spans.append(
            {"name": self.name, "t0": self.t0, "t1": self.t1,
             "attrs": self.attrs})

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


class _NullSpan:
    """The do-nothing span handed out whenever tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL_SPAN = _NullSpan()


# --------------------------------------------------------------- RunTrace


class RunTrace:
    """The per-run trace container behind ``fit(trace=...)``.

    ``mode="rounds"`` collects only per-round records plus the run-level
    wall/compile split; ``mode="full"`` also records spans and events
    (and, with ``annotate=True``, mirrors spans into ``torch.profiler``).
    ``summary()`` is the JSON-clean shape that lands in
    ``ClusterResult.extra["trace"]`` and that the exporters consume.
    """

    def __init__(self, mode: str = "rounds", *,
                 meta: Optional[Dict[str, Any]] = None,
                 annotate: bool = False):
        if mode not in TRACE_MODES:
            raise ValueError(
                f"unknown trace mode {mode!r}: expected one of "
                f"{TRACE_MODES} (or trace off)")
        _STATS["traces"] += 1
        self.mode = mode
        self.annotate = annotate and mode == "full"
        self.meta: Dict[str, Any] = dict(meta or {})
        self.records: List[Dict[str, Any]] = []
        self.spans: List[Dict[str, Any]] = []
        self.events: List[Dict[str, Any]] = []
        self.stop_reason: Optional[str] = None
        self.wall_s: Optional[float] = None
        self.t_start = clock()

    # --- emission (drivers call these through the module helpers)
    def emit_round(self, **fields) -> Dict[str, Any]:
        _STATS["records"] += 1
        rec = round_record(**fields)
        self.records.append(rec)
        return rec

    def span(self, name: str, **attrs):
        if self.mode != "full":
            return _NULL_SPAN
        return Span(name, self, attrs)

    def event(self, name: str, **attrs) -> None:
        if self.mode != "full":
            return
        self.events.append({"name": name, "t": clock(), "attrs": attrs})

    # --- derived summaries
    @property
    def compile_s(self) -> float:
        """Total kernel build seconds attributed across the records."""
        return float(sum(r["compile_s"] or 0.0 for r in self.records))

    @property
    def wire_payload_total(self) -> int:
        return int(sum(r["wire_payload_bytes"] or 0 for r in self.records))

    @property
    def wire_meta_total(self) -> int:
        return int(sum(r["wire_meta_bytes"] or 0 for r in self.records))

    @property
    def rounds_to_margin(self) -> Optional[int]:
        """First round whose post-removal live set fit the coordinator
        (``stop_margin <= 0``), or None if no round got there."""
        for rec in self.records:
            if rec["stop_margin"] is not None and rec["stop_margin"] <= 0:
                return rec["round"]
        return None

    def summary(self) -> Dict[str, Any]:
        return {
            "mode": self.mode,
            "meta": dict(self.meta),
            "stop_reason": self.stop_reason,
            "rounds_to_margin": self.rounds_to_margin,
            "wall_s": self.wall_s,
            "compile_s": self.compile_s,
            "wire_payload_bytes": self.wire_payload_total,
            "wire_meta_bytes": self.wire_meta_total,
            "records": [dict(r) for r in self.records],
            "spans": [dict(s) for s in self.spans],
            "events": [dict(e) for e in self.events],
        }


# --------------------------------------------------- ambient trace context

_STACK: List[RunTrace] = []


def current_trace() -> Optional[RunTrace]:
    """The innermost active RunTrace, or None (one truthiness check)."""
    return _STACK[-1] if _STACK else None


def run_trace(trace: Optional[RunTrace]):
    """Activate ``trace`` for the block: drivers inside publish to it.
    ``run_trace(None)`` is a null context (tracing stays off)."""
    if trace is None:
        return contextlib.nullcontext()
    return _activate(trace)


@contextlib.contextmanager
def _activate(trace: RunTrace):
    _STACK.append(trace)
    try:
        yield trace
    finally:
        _STACK.pop()


def span(name: str, **attrs):
    """Ambient span: a real Span inside an active full trace, else a
    shared no-op (no allocation when tracing is off)."""
    if not _STACK:
        return _NULL_SPAN
    return _STACK[-1].span(name, **attrs)


def event(name: str, **attrs) -> None:
    """Ambient event (no-op unless a full trace is active)."""
    if not _STACK:
        return
    _STACK[-1].event(name, **attrs)


def emit_round(**fields) -> None:
    """Ambient per-round record (no-op unless a trace is active)."""
    if not _STACK:
        return
    _STACK[-1].emit_round(**fields)
