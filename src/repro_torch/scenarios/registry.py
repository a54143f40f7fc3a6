"""Scenario registry: named (dataset x sharding x run-condition) specs.

The port of ``repro.scenarios.registry``, with a registry of its own.

A *scenario* is everything the paper varies between experiment rows —
the data generator, how shards land on machines, and the run conditions
(failures, stragglers, reduced-precision uplink) — packaged so that the
sweep runner (``repro_torch.scenarios.sweep``) can drive every registered
algorithm through ``repro_torch.api.fit()`` and emit one comparable report
row per scenario x algorithm x condition cell.

Registering a new scenario is one call::

    from repro_torch.scenarios import Scenario, ScenarioData, register_scenario

    @register_scenario
    def my_scenario():
        return Scenario(
            name="my_scenario", summary="what it stresses",
            make_data=lambda quick: ScenarioData(x=...),
            k=25, quick_k=8)

(decorate a zero-arg factory — data generation stays lazy until the
sweep actually needs it). Everything else (conditions, shard policy,
per-algorithm knobs) has paper-faithful defaults.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Condition:
    """One run condition: extra ``fit()`` kwargs applied to a cell.

    ``algos`` restricts the condition to the algorithms that support it
    (e.g. ``failure_plan`` needs SOCCER's ``on_round`` hook); cells for
    other algorithms are reported as skipped rather than silently run
    without the condition.
    """
    name: str = "baseline"
    fit_kwargs: Mapping = dataclasses.field(default_factory=dict)
    algos: Optional[Tuple[str, ...]] = None
    note: str = ""


@dataclasses.dataclass(frozen=True)
class ScenarioData:
    """What a generator hands the sweep: points + evaluation context."""
    x: np.ndarray                              # (n, d) float32
    w: Optional[np.ndarray] = None             # (n,) per-point weights
    eval_mask: Optional[np.ndarray] = None     # cost is measured on
    meta: Mapping = dataclasses.field(         # x[eval_mask] (inliers)
        default_factory=dict)

    def eval_x(self) -> np.ndarray:
        return self.x if self.eval_mask is None else self.x[self.eval_mask]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named dataset x sharding x conditions spec for the sweep.

    ``make_data(quick)`` returns a ``ScenarioData``; ``quick=True`` is
    the CI-sized variant. ``algo_params[algo]`` / ``common_params`` are
    extra ``fit()`` kwargs; condition kwargs override both.

    ``match_rounds=True`` turns the fixed-round baselines' hidden
    hyper-parameter into a measurement: k-means‖ cells are re-run with
    growing ``rounds`` until their cost is within ``match_tol`` of the
    same-condition SOCCER cell (paper Table 3's protocol), and the cell
    reports the matched round count.

    ``algos`` (when set) pins the scenario's algorithm list, overriding
    the sweep-wide default — for scenarios whose point is a specific
    head-to-head (e.g. the coreset-budget comparison needs
    ``coreset_kmeans`` in the row even though it is not a sweep
    default).

    ``stream`` (when set) turns the scenario into a *streaming* one:
    ``stream(quick)`` returns the batch sequence (a list of ``(n_i, d)``
    arrays) and the sweep plays it against every policy in
    ``stream_policies`` through ``repro_torch.streaming.protocol`` — one row
    per policy, scoring staleness cost vs recompute uplink instead of
    the batch algo x condition grid (``algos``/``conditions`` are
    ignored for these).
    """
    name: str
    summary: str
    make_data: Callable[[bool], ScenarioData]
    k: int
    quick_k: Optional[int] = None
    m: int = 8
    algos: Optional[Tuple[str, ...]] = None
    shard_policy: object = "shuffle"
    conditions: Tuple[Condition, ...] = (Condition(),)
    common_params: Mapping = dataclasses.field(default_factory=dict)
    algo_params: Mapping[str, Mapping] = dataclasses.field(
        default_factory=dict)
    match_rounds: bool = False
    match_tol: float = 1.05
    max_match_rounds: int = 8
    baseline_iters: int = 40
    tags: Tuple[str, ...] = ("paper",)
    stream: Optional[Callable] = None          # quick -> list of batches
    stream_policies: Tuple = ()                # streaming.StreamPolicy s

    def k_for(self, quick: bool) -> int:
        return self.quick_k if (quick and self.quick_k) else self.k

    def params_for(self, algo: str, condition: Condition,
                   quick: bool = True) -> dict:
        """fit() kwargs for one cell; ``common_params``/``algo_params``
        entries may be callables of ``quick`` for size-dependent knobs."""
        def resolve(v):
            return dict(v(quick)) if callable(v) else dict(v)

        p = resolve(self.common_params)
        p.update(resolve(self.algo_params.get(algo, {})))
        p.update(condition.fit_kwargs)
        return p


_REGISTRY: Dict[str, Scenario] = {}


def register_scenario(factory: Callable[[], Scenario]) -> Callable:
    """Decorator on a zero-arg factory; latest registration wins."""
    scenario = factory()
    _REGISTRY[scenario.name] = scenario
    return factory


def get_scenario(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; registered: "
            f"{', '.join(sorted(_REGISTRY))}") from None


def list_scenarios(tag: Optional[str] = None) -> Tuple[str, ...]:
    names = sorted(_REGISTRY)
    if tag is not None:
        names = [n for n in names if tag in _REGISTRY[n].tags]
    return tuple(names)
