"""A quick sweep of the port's scenario lab beside the JAX package's:
every report column, the deterministic columns exactly, costs and rounds
in law, the bf16 uplink's bytes, and the Theorem 7.2 scenario's quick
outcome in both packages (its strict gap is asserted at full size, in
tests/test_torch_scenarios.py). The reference's sweep is most of this
file's time: its jit compiles of one scenario's cells."""
import numpy as np
import pytest
import torch

from repro.scenarios import run_sweep as jrun_sweep
from repro_torch.scenarios import get_scenario, run_sweep, summarize_gap

# one intra-op thread a worker (xdist runs one worker per core)
torch.set_num_threads(1)

CPU = dict(device="cpu")
SWEEP = ("adversarial_kmeanspar", "bf16_uplink")
# the reference sweeps the first alone: its jit compiles are most of this
# file's time, and tests/test_torch_scenarios.py's registry test holds
# every cell's knobs
REF_SWEEP = SWEEP[:1]


@pytest.fixture(scope="module")
def sweeps():
    kw = dict(algos=("soccer", "kmeans_parallel"), quick=True, seed=0,
              verbose=False)
    return run_sweep(SWEEP, **kw, **CPU), jrun_sweep(REF_SWEEP, **kw)


def _key(row):
    return row["scenario"], row["algo"], row["condition"]


def test_sweep_rows_have_report_columns(sweeps):
    rows, _ = sweeps
    ran = [r for r in rows if not r["skipped"]]
    assert len(ran) >= 6
    for row in ran:
        for col in ("scenario", "algo", "condition", "cost", "cost_ratio",
                    "rounds", "uplink_points", "uplink_bytes", "wire_bytes",
                    "bytes_vs_omega_mk", "wall_time_s", "compile_s",
                    "baseline_cost", "stop_reason", "rounds_to_margin"):
            assert col in row, (row["scenario"], col)
        assert row["cost"] >= 0 and np.isfinite(row["cost"])
        assert row["uplink_bytes"] >= row["uplink_points"] * 2
        assert row["wall_time_s"] >= 0 and row["compile_s"] >= 0
        assert row["trace"]["meta"]["scenario"] == row["scenario"]


def test_sweep_matches_reference(sweeps):
    """The deterministic columns exactly; costs and rounds in law."""
    rows, jrows = sweeps
    ref_rows = [r for r in rows if r["scenario"] in REF_SWEEP]
    assert [_key(r) for r in ref_rows] == [_key(r) for r in jrows]
    for r, j in zip(ref_rows, jrows):
        for col in ("k", "m", "skipped", "params", "note"):
            assert r[col] == j[col], (_key(r), col)
        assert (r["uplink_bytes"] / r["uplink_points"]
                == j["uplink_bytes"] / j["uplink_points"]), _key(r)
    # bf16_uplink against the reference's accounting (d * itemsize bytes a
    # point, tests/test_scenarios.py::test_fit_uplink_dtype_accounting)
    # and its outcome: one SOCCER round on the mixture, k-means‖'s fixed
    # 5, each within Thm 4.1's constant of the exact baseline
    d = get_scenario("bf16_uplink").make_data(True).x.shape[1]
    for r in rows:
        if r["scenario"] == "bf16_uplink":
            width = 2 if r["condition"] == "bf16_uplink" else 4
            assert r["uplink_bytes"] == r["uplink_points"] * d * width
            assert r["rounds"] == (1 if r["algo"] == "soccer" else 5)
            assert r["cost_ratio"] <= 3.0, _key(r)


def test_bf16_condition_halves_uplink_bytes(sweeps):
    rows, _ = sweeps
    cells = {(r["condition"], r["algo"]): r for r in rows
             if r["scenario"] == "bf16_uplink"}
    for algo in ("soccer", "kmeans_parallel"):
        fp32 = cells[("fp32_uplink", algo)]
        bf16 = cells[("bf16_uplink", algo)]
        assert (bf16["uplink_bytes"] / bf16["uplink_points"]
                == fp32["uplink_bytes"] / fp32["uplink_points"] / 2), algo
        assert bf16["cost"] <= 3.0 * max(fp32["cost"],
                                         fp32["baseline_cost"]), algo


def test_adversarial_quick_outcome_beside_reference(sweeps):
    """At quick size (k = 16, z = 250, eta 512) the strict gap is not
    asserted: v = 0 there, and which duplicated locations survive a round
    is decided by the float32 rounding of their d2
    (tests/test_torch_scenarios.py's round-one test). Both
    packages match SOCCER's cost within the round budget, and in both a
    round removes or keeps whole locations."""
    rows, jrows = sweeps
    for rs in (rows, jrows):
        adv = {r["algo"]: r for r in rs
               if r["scenario"] == "adversarial_kmeanspar"}
        assert adv["kmeans_parallel"]["rounds_matched_target"]
        assert all(v % 250 == 0 for v in adv["soccer"]["n_hist"])
        assert summarize_gap(rs) is not None
    adv = {r["algo"]: r for r in rows
           if r["scenario"] == "adversarial_kmeanspar"}
    assert adv["soccer"]["rounds"] <= adv["kmeans_parallel"]["rounds"]
