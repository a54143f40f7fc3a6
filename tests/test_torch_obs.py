"""The port's telemetry (``repro_torch.obs``, ``fit(trace=)``,
``api.selfcheck``) against the JAX package's ``repro.obs``: the pinned
schema, the exporters and report strings on files either package wrote,
the registry, the trace-off guarantee, and every driver's traced fit."""
import json

import numpy as np
import pytest
import torch

from repro.api import fit as jfit
from repro.obs import export as jexport
from repro.obs import report as jreport
from repro.obs import trace as jtrace
from repro_torch import api
from repro_torch.api import selfcheck
from repro_torch.ft.failures import FailurePlan
from repro_torch.kernels import build
from repro_torch.obs import REGISTRY, MetricsRegistry
from repro_torch.obs import export, report, trace
from repro_torch.obs.trace import (ROUND_FIELDS, ROUND_SCHEMA, RunTrace,
                                   _STATS, round_record, run_trace)

# xdist runs one worker per core: with torch's default of one intra-op
# thread per core in every worker, the pools contend and small ops run
# several times slower
torch.set_num_threads(1)

M, K = 4, 4


def _data(seed=0, p=256, d=8):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(M, p, d)).astype(np.float32)


def _soccer(x, trace=None, seed=0, **kw):
    return api.fit(x, K, algo="soccer", epsilon=0.2, seed=seed, trace=trace,
                   device="cpu", **kw)


def _wire(summary) -> int:
    return sum(r["wire_payload_bytes"] + r["wire_meta_bytes"]
               for r in summary["records"])


@pytest.fixture(scope="module")
def jax_traces(tmp_path_factory):
    """One traced reference SOCCER fit (one compile; it runs a removal
    round) and the port's on the same data, both written as JSONL by the
    reference's exporter."""
    x = _data(p=2048)
    jres = jfit(x, K, algo="soccer", backend="virtual", epsilon=0.2, seed=0,
                trace="rounds")
    ours = _soccer(x, trace="rounds")
    runs = [jres.extra["trace"], ours.extra["trace"]]
    path = tmp_path_factory.mktemp("jax") / "soccer.jsonl"
    jexport.write_jsonl(runs, path)
    return runs, path, jres, ours


# ------------------------------------------------------------ schema


def test_round_schema_is_the_references():
    """The same 14 fields, names, types and order, the same phases and
    modes: JSONL from either package reads in the other."""
    assert ROUND_SCHEMA == jtrace.ROUND_SCHEMA
    assert ROUND_FIELDS == jtrace.ROUND_FIELDS
    assert trace.PHASES == jtrace.PHASES
    assert trace.TRACE_MODES == jtrace.TRACE_MODES
    assert len(ROUND_SCHEMA) == 14


@pytest.mark.parametrize("scalar", [np.int64, torch.tensor],
                         ids=["numpy", "torch"])
def test_round_record_coerces_and_rejects(scalar):
    rec = round_record(round=scalar(2), phase="round", n_live=scalar(10),
                       alpha=np.float32(0.5), v=torch.tensor(0.25))
    assert rec["round"] == 2 and type(rec["round"]) is int
    assert type(rec["n_live"]) is int
    assert type(rec["alpha"]) is float and type(rec["v"]) is float
    assert rec["removed"] is None
    assert list(rec) == list(ROUND_FIELDS)
    assert rec == jtrace.round_record(round=2, phase="round", n_live=10,
                                      alpha=0.5, v=0.25)
    with pytest.raises(ValueError):
        round_record(round=1, phase="round", bogus_field=3)
    with pytest.raises(ValueError):
        round_record(round=1, phase="warmup")


# ------------------------------------------------------------ export/report


def test_reads_reference_jsonl_with_reference_strings(jax_traces, tmp_path):
    """A JSONL file the reference wrote loads in the port to the same
    summaries, renders to the same summary, diff and Chrome events; a
    file the port writes loads in the reference unchanged."""
    runs, path, _, _ = jax_traces
    mine = export.load_jsonl(path)
    assert mine == jexport.load_jsonl(path)
    assert mine[0]["records"] == runs[0]["records"]
    for run in mine:
        assert report.format_summary(run) == jreport.format_summary(run)
        assert export.chrome_trace_events(run, pid=3) == \
            jexport.chrome_trace_events(run, pid=3)
    assert report.format_diff(*mine) == jreport.format_diff(*mine)

    ours = _soccer(_data(), trace="rounds").extra["trace"]
    back = export.write_jsonl([ours], tmp_path / "port.jsonl")
    assert jexport.load_jsonl(back) == export.load_jsonl(back)
    assert jexport.load_jsonl(back)[0]["records"] == ours["records"]
    assert jreport.format_summary(ours) == report.format_summary(ours)


def test_report_cli_reads_both_packages(jax_traces, tmp_path, capsys):
    _, jpath, _, _ = jax_traces
    x = _data()
    a = _soccer(x, trace="rounds").extra["trace"]
    pa = export.write_jsonl([a], tmp_path / "a.jsonl")
    assert report.main([str(pa)]) == 0
    out = capsys.readouterr().out
    assert "stop_reason" in out and "finalize" in out
    assert report.main([str(pa), str(jpath)]) == 0
    assert "wall_s" in capsys.readouterr().out   # the diff table
    chrome = tmp_path / "t.chrome.json"
    assert report.main([str(jpath), "--all", "--chrome", str(chrome)]) == 0
    events = json.loads(chrome.read_text())["traceEvents"]
    assert sum(e["ph"] == "X" for e in events) == sum(
        len(r["records"]) for r in jax_traces[0])


def test_jsonl_round_trip_and_orphan_line(tmp_path):
    x = _data()
    a = _soccer(x, trace="rounds").extra["trace"]
    b = _soccer(x, trace="rounds", seed=1).extra["trace"]
    runs = export.load_jsonl(export.write_jsonl([a, b], tmp_path / "t.jsonl"))
    assert len(runs) == 2
    assert runs[0]["records"] == a["records"]
    assert runs[1]["stop_reason"] == b["stop_reason"]
    assert runs[0]["wire_payload_bytes"] == a["wire_payload_bytes"]
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"kind": "round", "round": 1}) + "\n")
    with pytest.raises(ValueError):
        export.load_jsonl(bad)


def test_chrome_rounds_lie_back_to_back():
    t = _soccer(_data(p=2048), trace="rounds").extra["trace"]
    events = export.chrome_trace_events(t)
    complete = [e for e in events if e["ph"] == "X"]
    assert len(complete) == len(t["records"])
    assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in complete)
    rounds = sorted((e["ts"], e["dur"]) for e in complete if e["tid"] == 1)
    for (ts0, d0), (ts1, _) in zip(rounds, rounds[1:]):
        assert abs((ts0 + d0) - ts1) < 1.0


# ------------------------------------------------------------ registry


def test_registry_mechanics():
    reg = MetricsRegistry()
    c = reg.counter("t.hits")
    reg.gauge("t.depth", lambda: 7)
    h = reg.histogram("t.lat", buckets=(1.0, 10.0))
    log = reg.event_log("t.events", maxlen=2)
    c.inc()
    c.inc("", 2)
    c.inc("miss")
    for v in (0.5, 5.0, 50.0):
        h.observe(v)
    for i in range(3):
        log.append(i=i)
    snap = reg.read()
    assert snap["t.hits"] == {"": 3, "miss": 1}
    assert snap["t.depth"] == {"value": 7}
    assert snap["t.lat"]["count"] == 3 and snap["t.lat"]["sum"] == 55.5
    assert snap["t.lat"]["buckets"] == {"le=1": 1, "le=10": 1, "le=+inf": 1}
    assert snap["t.events"] == {"count": 2, "events": [{"i": 1}, {"i": 2}]}
    assert reg.counter("t.hits") is c         # idempotent re-registration
    with reg.scope() as sc:
        c.inc("", 5)
        h.observe(2.0)
    delta = sc.delta()
    assert delta["t.hits"][""] == 5 and delta["t.hits"]["miss"] == 0
    assert delta["t.lat"]["count"] == 1
    reg.reset()
    assert reg.read()["t.hits"] == {}
    assert reg.read()["t.lat"]["count"] == 0
    assert reg.read()["t.depth"] == {"value": 7}  # callback gauge re-samples
    with pytest.raises(TypeError):
        reg.gauge("t.depth").set(3)
    assert reg.summary_lines("t.hits", "t.lat")
    with pytest.raises(KeyError):
        reg.read("t.nonexistent")
    with pytest.raises(KeyError):
        reg.reset("t.nonexistent")


def test_default_registry_adoptions():
    """The global registry reads the port's own sources (wire tallies,
    kernel launches and the walk's split lookups; the reference's trace
    counters have no eager counterpart), a scope over a fit reads
    cleanly, and reset() clears a leaked wire tally and the lookups."""
    from repro_torch.core import comm
    from repro_torch.kernels import tuning
    snap = REGISTRY.read()
    assert {"core.comm.active_tallies", "kernels.launches",
            "kernels.tuning.autotune"} <= set(snap)
    assert set(snap["kernels.launches"]) == set(
        __import__("repro_torch.kernels.ops",
                   fromlist=["KERNELS"]).KERNELS)
    with REGISTRY.scope() as sc:
        _soccer(_data())
    delta = sc.delta()
    assert delta["core.comm.active_tallies"] == {"value": 0}
    assert set(delta["kernels.launches"].values()) == {0}   # plain on CPU
    # no launch shape is decided on the CPU
    assert not any(delta["kernels.tuning.autotune"].values())
    tuning.TUNE_COUNTS["measured_miss"] += 1
    assert REGISTRY.read("kernels.tuning.autotune")[
        "kernels.tuning.autotune"]["measured_miss"] >= 1
    REGISTRY.reset("kernels.tuning.autotune")
    assert REGISTRY.read("kernels.tuning.autotune")[
        "kernels.tuning.autotune"] == {}
    comm._TALLY_STACK.append(comm.WireTally())               # a leak
    assert REGISTRY.read()["core.comm.active_tallies"] == {"value": 1}
    REGISTRY.reset("core.comm.active_tallies")
    assert REGISTRY.read()["core.comm.active_tallies"] == {"value": 0}


# ------------------------------------------------------------ off = free


def test_trace_off_allocates_nothing():
    """An untraced fit touches none of the trace machinery: no RunTrace,
    no span, no record, no 'trace' key."""
    x = _data()
    before = dict(_STATS)
    res = _soccer(x)
    res2 = api.fit(x, K, algo="kmeans_parallel", rounds=2, device="cpu")
    assert dict(_STATS) == before
    assert "trace" not in res.extra and "trace" not in res2.extra


# ------------------------------------------------------------ drivers

# (algo, params, expected phases, stop reason, the reference's args)
DRIVERS = {
    "soccer": ("soccer", dict(epsilon=0.2), None, "capacity"),
    "soccer_multiround": ("soccer", dict(epsilon=0.2, eta_override=600),
                          None, "capacity"),
    "soccer_max_rounds": ("soccer", dict(epsilon=0.2, eta_override=300),
                          None, "max_rounds"),
    "soccer_sharded": ("soccer", dict(epsilon=0.2, eta_override=300,
                                      sharded_coordinator=True), None, None),
    "soccer_coreset": ("soccer", dict(epsilon=0.2, eta_override=300,
                                      uplink_mode="coreset"), None, None),
    "soccer_int8": ("soccer", dict(epsilon=0.2, eta_override=300,
                                   uplink_dtype="int8"), None, None),
    "soccer_failures": ("soccer", dict(
        epsilon=0.2, eta_override=300,
        failure_plan=FailurePlan(fail_at={0: (1,)}, straggler_rate=0.3)),
        None, None),
    "kmeans_parallel": ("kmeans_parallel", dict(rounds=3, lloyd_iters=5),
                        ["round"] * 3, "fixed_rounds"),
    "eim11": ("eim11", dict(epsilon=0.2, max_rounds=3), None, None),
    "lloyd": ("lloyd", dict(iters=3), ["upload"], "one_shot"),
    "minibatch": ("minibatch", dict(batch=128, steps=10), ["upload"],
                  "one_shot"),
    "coreset_kmeans": ("coreset_kmeans", dict(coreset_size=64,
                                              lloyd_iters=3),
                       ["upload"], "one_shot"),
    "kzmeans": ("kzmeans", dict(outlier_frac=0.02), ["upload"], "one_shot"),
}


@pytest.mark.parametrize("mode", ["rounds", "full"])
@pytest.mark.parametrize("case", sorted(DRIVERS))
def test_traced_fit_equals_untraced(case, mode):
    """Every driver: a traced fit computes what the untraced one does,
    bit for bit (centers, rounds, n_hist, uplink, wire bytes); its records
    follow the schema, sum exactly to wire_bytes_total, run in the
    driver's phase order, and rounds_to_margin names the first round
    whose post-removal live set fit the coordinator."""
    algo, params, phases, stop = DRIVERS[case]
    x = _data(p=1024)
    plain = api.fit(x, K, algo=algo, seed=0, device="cpu", **params)
    res = api.fit(x, K, algo=algo, seed=0, device="cpu", trace=mode,
                  **params)
    np.testing.assert_array_equal(res.centers, plain.centers)
    assert res.rounds == plain.rounds
    for f in ("n_hist", "uplink_points", "wire_bytes", "wire_meta_bytes"):
        a, b = getattr(res, f), getattr(plain, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    t = res.extra["trace"]
    recs = t["records"]
    assert t["mode"] == mode and t["meta"]["algo"] == algo
    assert all(list(r) == list(ROUND_FIELDS) for r in recs)
    assert _wire(t) == res.wire_bytes_total
    assert t["wire_payload_bytes"] + t["wire_meta_bytes"] == _wire(t)
    assert t["wall_s"] == res.wall_time_s
    assert all(r["wall_s"] is not None and r["wall_s"] >= 0 for r in recs)
    assert t["compile_s"] == 0.0          # nothing to build on the CPU
    if phases is None:                    # a host loop + its finalize
        phases = ["round"] * res.rounds + ["finalize"]
    assert [r["phase"] for r in recs] == phases
    assert [r["round"] for r in recs] == list(range(1, len(recs) + 1))
    if stop is not None:
        assert t["stop_reason"] == stop
    if phases[-1] == "finalize":
        rounds = recs[:-1]
        np.testing.assert_array_equal(
            [r["uplink_rows"] for r in recs], res.uplink_points)
        margins = [r["round"] for r in rounds if r["stop_margin"] <= 0]
        assert t["rounds_to_margin"] == (margins[0] if margins else None)
        if t["stop_reason"] == "capacity" and res.rounds:
            assert t["rounds_to_margin"] == res.rounds
        for r in rounds:
            assert r["removed"] == r["n_live"] - (r["stop_margin"]
                                                  + r["capacity"])
    else:
        assert t["rounds_to_margin"] is None
    if mode == "full" and algo == "soccer":
        names = {s["name"] for s in t["spans"]}
        assert {"soccer.round", "soccer.finalize"} & names


def test_soccer_records_against_the_reference(jax_traces):
    """The same data through both packages' traced SOCCER: the same
    phases, capacity, first live count and stop reason, and both sum
    their records to their own wire total (the random streams differ, so
    the removal counts are the reference's only in distribution)."""
    _, _, ref, ours = jax_traces
    a, b = ours.extra["trace"], ref.extra["trace"]
    assert ours.rounds >= 1
    assert [r["phase"] for r in a["records"]] == \
        [r["phase"] for r in b["records"]]
    for f in ("capacity", "n_live"):
        assert a["records"][0][f] == b["records"][0][f], f
    assert a["stop_reason"] == b["stop_reason"] == "capacity"
    assert a["rounds_to_margin"] == b["rounds_to_margin"]
    assert _wire(a) == ours.wire_bytes_total
    assert _wire(b) == ref.wire_bytes_total
    assert a["meta"]["eta"] == b["meta"]["eta"]


def test_full_mode_spans_events_and_profiler_ranges():
    rt = RunTrace(mode="full", annotate=True)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with run_trace(rt):
            with trace.span("outer", layer="test"):
                trace.event("ping", n=1)
    assert [s["name"] for s in rt.spans] == ["outer"]
    assert rt.spans[0]["attrs"] == {"layer": "test"}
    assert rt.events[0]["name"] == "ping"
    assert "outer" in {e.key for e in prof.key_averages()}
    summary = rt.summary()
    assert summary["mode"] == "full"
    assert len(summary["spans"]) == 1 and len(summary["events"]) == 1
    rounds = RunTrace(mode="rounds", annotate=True)
    assert not rounds.annotate and rounds.span("x") is trace._NULL_SPAN
    with pytest.raises(ValueError):
        RunTrace(mode="verbose")


def test_fit_full_trace_opens_profiler_ranges():
    """fit(trace="full") mirrors its spans into torch.profiler ranges; an
    unknown mode raises."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        res = _soccer(_data(p=2048), trace="full")
    spans = {s["name"] for s in res.extra["trace"]["spans"]}
    assert {"soccer.round", "soccer.upload", "soccer.coordinator",
            "soccer.removal", "soccer.finalize"} <= spans
    assert spans <= {e.key for e in prof.key_averages()}
    with pytest.raises(ValueError, match="trace mode"):
        _soccer(_data(), trace="verbose")


def test_step_clock_splits_off_build_seconds(monkeypatch):
    """compile_s is the nvcc seconds a step triggered (None when nothing
    was built) and wall_s the rest, both from the one module clock."""
    ticks = iter([10.0, 14.5, 20.0, 21.0])
    prev = trace.set_clock(lambda: next(ticks))
    try:
        built = [3.0]
        monkeypatch.setattr(trace, "build_seconds", lambda: built[0])
        sc = trace.StepClock()
        built[0] = 5.0                       # a build of 2 s inside
        sc.stop()
        assert sc.compile_s == 2.0 and sc.wall_s == 2.5
        sc = trace.StepClock().stop()
        assert sc.compile_s is None and sc.wall_s == 1.0
    finally:
        trace.set_clock(prev)
    assert trace.clock is not None and build.build_seconds() >= 0.0


def test_step_clock_and_run_trace_are_null_when_off():
    """Off a trace, step_clock() is the shared no-op (reads no clock) and
    run_trace(None) leaves tracing off; inside one, a real StepClock."""
    prev = trace.set_clock(lambda: pytest.fail("clock read off a trace"))
    try:
        with run_trace(None):
            assert trace.current_trace() is None
            sc = trace.step_clock()
            assert sc is trace._NULL_CLOCK and sc.stop() is sc
            assert sc.wall_s is None and sc.compile_s is None
    finally:
        trace.set_clock(prev)
    with run_trace(RunTrace()):
        sc = trace.step_clock().stop()
        assert isinstance(sc, trace.StepClock) and sc.wall_s >= 0.0


def test_sequential_fits_report_identical_metrics():
    """The same fit twice in one process gives identical telemetry (walls
    excluded): no counter bleed, no stale tally."""
    x = _data()

    def run():
        t = _soccer(x, trace="rounds").extra["trace"]
        recs = [{k: v for k, v in r.items()
                 if k not in ("wall_s", "compile_s")} for r in t["records"]]
        return (recs, t["stop_reason"], t["rounds_to_margin"],
                t["wire_payload_bytes"], t["wire_meta_bytes"])

    assert run() == run()


def test_selfcheck_on_the_cpu(capsys):
    assert selfcheck.main(device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count(" ok ") == len(api.list_algorithms())
    assert "stop_reason" in out and "kernels.launches" in out
    assert selfcheck.cli(["--device", "cpu"]) == 0
