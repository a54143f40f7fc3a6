"""Scenario lab: pluggable dataset/condition registry + sweep runner (the
port of ``repro.scenarios``).

    from repro_torch.scenarios import list_scenarios, run_sweep
    rows = run_sweep(list_scenarios(tag="paper"), quick=True)   # the card
    rows = run_sweep(["zipf_gaussian"], quick=True, device="cpu")

Scenarios bundle a data generator, a shard-placement policy, and run
conditions (failures, stragglers, uplink precision) into one named spec;
the sweep drives every registered ``repro_torch.api.fit`` algorithm
through them and emits one comparable report row per cell. Register new
ones with ``@register_scenario`` (see ``repro_torch.scenarios.registry``);
the CLI is ``python -m repro_torch.scenarios.run --suite paper --quick``.
"""
from repro_torch.scenarios.registry import (Condition, Scenario,
                                            ScenarioData, get_scenario,
                                            list_scenarios,
                                            register_scenario)
from repro_torch.scenarios.report import (device_label, format_table,
                                          summarize_gap, write_bench_json)
from repro_torch.scenarios.sweep import (DEFAULT_ALGOS, capture_round,
                                         exact_baseline, run_scenario,
                                         run_sweep)
from repro_torch.scenarios import library as _library  # noqa: F401
                                              # (registers the built-ins)

__all__ = [
    "Condition", "DEFAULT_ALGOS", "Scenario", "ScenarioData",
    "capture_round", "device_label", "exact_baseline", "format_table",
    "get_scenario", "list_scenarios", "register_scenario", "run_scenario",
    "run_sweep", "summarize_gap", "write_bench_json",
]
