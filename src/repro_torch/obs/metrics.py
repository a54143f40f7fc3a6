"""The metrics registry: one read/reset API over the port's counters.

The port of ``repro.obs.metrics``. Everything registers here:

* **adopted sources** — the port's module-level counters, wrapped by name
  with *lazy* resolvers: ``core.comm.active_tallies`` (the depth of
  ``core.comm``'s wire-tally stack, whose reset clears a leaked entry),
  ``kernels.launches`` (each CUDA kernel's launch count,
  ``kernels.ops.KERNELS``) and ``kernels.tuning.autotune`` (the walk's
  split lookups, ``kernels.tuning.TUNE_COUNTS``: measured hits, misses
  and rule-only lookups, one a kernel call on the card);
* **owned metrics** — ``Counter``/``Gauge``/``Histogram``/``EventLog``
  created through the registry (serving latency, drift re-clusters).

The reference also adopts ``*.trace_counts`` (how often JAX traced a
jitted body); eager PyTorch traces nothing, so they have no counterpart
here.

``read()`` returns one JSON-clean snapshot, ``reset()`` zeroes
everything (or a named subset), and ``scope()`` yields a delta-reader so
a caller can attribute counts to one run without resetting globals under
a concurrent reader. A source whose read raises fails the read: the
port's sources are its own modules, so nothing is caught.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import importlib
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# ----------------------------------------------------------- metric kinds


class Counter:
    """A monotonically increasing, labeled counter (reset to zero only)."""

    def __init__(self):
        self._counts = collections.Counter()

    def inc(self, key: str = "", n: float = 1) -> None:
        self._counts[key] += n

    def read(self) -> Dict[str, float]:
        return dict(self._counts)

    def reset(self) -> None:
        self._counts.clear()


class Gauge:
    """A point-in-time value, either set imperatively or computed by a
    callback at read time (callback gauges ignore ``reset``)."""

    def __init__(self, fn: Optional[Callable[[], Any]] = None):
        self._fn = fn
        self._value: Any = 0

    def set(self, value) -> None:
        if self._fn is not None:
            raise TypeError("callback gauges are read-only")
        self._value = value

    def read(self) -> Dict[str, Any]:
        return {"value": self._fn() if self._fn is not None else self._value}

    def reset(self) -> None:
        if self._fn is None:
            self._value = 0


class Histogram:
    """Fixed-boundary histogram with count/sum (Prometheus-shaped).

    ``buckets`` are inclusive upper bounds; observations above the last
    bound land in the implicit +inf bucket.
    """

    def __init__(self, buckets: Sequence[float]):
        self.buckets: Tuple[float, ...] = tuple(sorted(float(b)
                                                       for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._n = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self._counts[bisect.bisect_left(self.buckets, v)] += 1
        self._sum += v
        self._n += 1

    def read(self) -> Dict[str, Any]:
        labels = [f"le={b:g}" for b in self.buckets] + ["le=+inf"]
        return {"count": self._n, "sum": self._sum,
                "buckets": dict(zip(labels, self._counts))}

    def reset(self) -> None:
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._n = 0


class EventLog:
    """A bounded append-only log of structured events (drift re-clusters,
    serving rollovers); ``read`` returns the retained tail."""

    def __init__(self, maxlen: int = 1000):
        self._events: collections.deque = collections.deque(maxlen=maxlen)

    def append(self, **event) -> None:
        self._events.append(dict(event))

    def read(self) -> Dict[str, Any]:
        return {"count": len(self._events), "events": list(self._events)}

    def reset(self) -> None:
        self._events.clear()


class _AdoptedHook:
    """Arbitrary read/reset callables (wire-tally scoping and friends)."""

    def __init__(self, read: Callable[[], Any],
                 reset: Optional[Callable[[], None]] = None):
        self._read = read
        self._reset = reset

    def read(self):
        return self._read()

    def reset(self) -> None:
        if self._reset is not None:
            self._reset()


# --------------------------------------------------------------- registry


class MetricsRegistry:
    """Named metrics with one snapshot/reset surface.

    Names are dotted paths (``streaming.serve.latency_ms``); ``read``
    resolves lazily-adopted sources on demand.
    """

    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    # --- registration
    def register(self, name: str, metric) -> Any:
        """Register any object with ``read()``/``reset()``; returns it.
        Re-registering a name returns the existing metric (idempotent
        module-level registration under re-imports)."""
        with self._lock:
            return self._metrics.setdefault(name, metric)

    def counter(self, name: str) -> Counter:
        return self.register(name, Counter())

    def gauge(self, name: str,
              fn: Optional[Callable[[], Any]] = None) -> Gauge:
        return self.register(name, Gauge(fn))

    def histogram(self, name: str, buckets: Sequence[float]) -> Histogram:
        return self.register(name, Histogram(buckets))

    def event_log(self, name: str, maxlen: int = 1000) -> EventLog:
        return self.register(name, EventLog(maxlen))

    def adopt(self, name: str, read: Callable[[], Any],
              reset: Optional[Callable[[], None]] = None) -> None:
        self.register(name, _AdoptedHook(read, reset))

    # --- snapshot / reset / scoping
    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def read(self, *names: str) -> Dict[str, Any]:
        """Snapshot the named metrics (all when no names are given)."""
        out: Dict[str, Any] = {}
        for name in names or self.names():
            out[name] = self._get(name).read()
        return out

    def _get(self, name: str):
        try:
            return self._metrics[name]
        except KeyError:
            raise KeyError(
                f"unknown metric {name!r}; registered: "
                f"{', '.join(self.names())}") from None

    def reset(self, *names: str) -> None:
        """Zero the named metrics (all when no names are given)."""
        for name in names or self.names():
            self._get(name).reset()

    @contextlib.contextmanager
    def scope(self, *names: str):
        """Attribute counts to one block without resetting globals:

            with REGISTRY.scope() as scoped:
                fit(...)
            per_run = scoped.delta()

        ``delta()`` is the difference between the exit (or current) and
        entry snapshots for every numeric leaf; non-numeric leaves
        report their current value.
        """
        before = self.read(*names)
        s = _Scope(self, names, before)
        yield s
        s.freeze()

    def summary_lines(self, *names: str) -> List[str]:
        """Human-oriented one-line-per-metric rendering (selfcheck)."""
        lines = []
        for name, val in sorted(self.read(*names).items()):
            lines.append(f"{name}: {_render(val)}")
        return lines


class _Scope:
    def __init__(self, registry: MetricsRegistry, names, before):
        self._registry = registry
        self._names = names
        self._before = before
        self._after: Optional[Dict[str, Any]] = None

    def freeze(self) -> None:
        if self._after is None:
            self._after = self._registry.read(*self._names)

    def delta(self) -> Dict[str, Any]:
        after = self._after or self._registry.read(*self._names)
        return {name: _diff(self._before.get(name), val)
                for name, val in after.items()}


def _diff(before, after):
    if isinstance(after, dict):
        before = before if isinstance(before, dict) else {}
        return {k: _diff(before.get(k), v) for k, v in after.items()}
    if isinstance(after, (int, float)) and not isinstance(after, bool):
        base = before if isinstance(before, (int, float)) else 0
        return after - base
    return after


def _render(val, depth: int = 0) -> str:
    if isinstance(val, dict):
        inner = " ".join(f"{k}={_render(v, depth + 1)}"
                         for k, v in sorted(val.items(), key=str))
        return inner if depth == 0 else f"({inner})"
    if isinstance(val, list):
        return f"[{len(val)} events]"
    return f"{val:g}" if isinstance(val, float) else str(val)


# ------------------------------------------------------- the default tree

REGISTRY = MetricsRegistry()


def _adopt_defaults(reg: MetricsRegistry) -> None:
    """Adopt the port's module-level sources, lazily."""

    def _comm():
        return importlib.import_module("repro_torch.core.comm")

    # WireTally scoping: the tally stack must be empty between runs — a
    # leaked entry would silently double-count the next run's traffic.
    # The gauge exposes the depth; reset clears leaked entries.
    reg.adopt("core.comm.active_tallies",
              read=lambda: {"value": len(_comm()._TALLY_STACK)},
              reset=lambda: _comm()._TALLY_STACK.clear())

    def _kernels():
        return importlib.import_module("repro_torch.kernels.ops").KERNELS

    def _zero_launches():
        for kern in _kernels().values():
            kern.launches = 0

    # launches of each CUDA kernel (0 on the CPU, where the plain
    # versions run and count nothing)
    reg.adopt("kernels.launches",
              read=lambda: {name: kern.launches
                            for name, kern in _kernels().items()},
              reset=_zero_launches)

    def _tune():
        return importlib.import_module(
            "repro_torch.kernels.tuning").TUNE_COUNTS

    # the walk's split lookups (none on the CPU, where no launch shape is
    # decided)
    reg.adopt("kernels.tuning.autotune", read=lambda: dict(_tune()),
              reset=lambda: _tune().clear())


_adopt_defaults(REGISTRY)
