"""The port's scenario lab (``repro_torch.scenarios``) and k-means examples
against the JAX package's ``repro.scenarios``: the two generators and
every registered scenario bit for bit at quick and full size, the
Theorem 7.2 gap at the scenario's full size, the cause of the quick
size's round-1 survivors in both packages, the CLI and the examples (a
quick sweep beside the reference's: tests/test_torch_scenarios_sweep.py)."""
import hashlib
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import fit as jfit
from repro.data.synthetic import heavy_tailed_mixture as j_heavy
from repro.data.synthetic import kmeans_parallel_hard_instance as j_hard
from repro.kernels import ops as jops
from repro.scenarios import get_scenario as jget_scenario
from repro.scenarios import list_scenarios as jlist_scenarios
from repro.scenarios.sweep import _describe_params as j_describe
from repro_torch.api import list_algorithms
from repro_torch.data.synthetic import (heavy_tailed_mixture,
                                        kmeans_parallel_hard_instance)
from repro_torch.kernels import ops
from repro_torch.scenarios import (Scenario, ScenarioData, capture_round,
                                   get_scenario, list_scenarios,
                                   register_scenario, registry, run,
                                   run_scenario, summarize_gap)
from repro_torch.scenarios.sweep import _describe_params

# xdist runs one worker per core: with torch's default of one intra-op
# thread per core in every worker, the pools contend and small ops run
# several times slower
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = dict(device="cpu")
PAPER = ("adversarial_kmeanspar", "bf16_uplink", "coreset_budget",
         "faulty_cluster", "heavy_tailed", "imbalanced_shards",
         "int8_coreset", "noniid_shards", "outlier_clustered",
         "outlier_contaminated", "outlier_heavy", "streaming_drift",
         "streaming_stationary", "zipf_gaussian")
# The float32 expanded form's error bound for a d2 (chip_smoke.py's
# d2_tol): 32 ulps of max ||x||^2 + max ||c||^2.
TOL_ULPS = 32


def _eq(a, b):
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# ------------------------------------------------------------ generators


@pytest.mark.parametrize("kw", [
    dict(k=16, z=250, dim=4, spread=100.0, sigma=0.0, seed=3),
    dict(k=25, z=400, dim=4, spread=100.0, sigma=0.0, seed=3),
    dict(k=6, z=40, dim=3, sigma=0.05, seed=0, heavy_factor=2)])
def test_hard_instance_matches_reference(kw):
    assert _eq(kmeans_parallel_hard_instance(**kw), j_hard(**kw))


@pytest.mark.parametrize("kw", [
    dict(n=6144, k=8, dim=8, df=2.0, seed=5),
    dict(n=3000, k=5, dim=4, seed=1)])
def test_heavy_tailed_matches_reference(kw):
    for a, b in zip(heavy_tailed_mixture(**kw), j_heavy(**kw)):
        assert _eq(a, b)


def test_generators_basic_properties():
    x = kmeans_parallel_hard_instance(k=6, z=40, dim=3, sigma=0.0, seed=0)
    assert x.shape == (5 * 40 + 5 * 40, 3)
    assert len(np.unique(x, axis=0)) == 6
    xh, labels, means = heavy_tailed_mixture(n=3000, k=5, dim=4, seed=1)
    assert xh.shape == (3000, 4) and means.shape == (5, 4)


# -------------------------------------------------------------- registry


def test_registry_names_match_reference():
    assert list_scenarios(tag="paper") == PAPER
    assert list_scenarios() == PAPER          # no scenario of the port's own
    # the reference's own tests may register "_test" scenarios in this
    # worker's process; the paper suite is the shared one
    assert jlist_scenarios(tag="paper") == PAPER


def _spec(sc, describe):
    return dict(
        name=sc.name, summary=sc.summary, k=sc.k, quick_k=sc.quick_k,
        m=sc.m, algos=sc.algos, shard_policy=sc.shard_policy,
        match_rounds=sc.match_rounds, match_tol=sc.match_tol,
        max_match_rounds=sc.max_match_rounds,
        baseline_iters=sc.baseline_iters, tags=sc.tags,
        stream=sc.stream is None, stream_policies=repr(sc.stream_policies),
        conditions=[(c.name, describe(dict(c.fit_kwargs)), c.algos, c.note)
                    for c in sc.conditions])


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
@pytest.mark.parametrize("name", PAPER)
def test_scenario_matches_reference(name, quick):
    """Fields, conditions, every algorithm's fit() params as the report
    describes them, the data and the stream batches, bit for bit."""
    sc, ref = get_scenario(name), jget_scenario(name)
    assert _spec(sc, _describe_params) == _spec(ref, j_describe)
    assert sc.k_for(quick) == ref.k_for(quick)
    for algo in list_algorithms():
        for cond, rcond in zip(sc.conditions, ref.conditions):
            assert (_describe_params(sc.params_for(algo, cond, quick))
                    == j_describe(ref.params_for(algo, rcond, quick)))
    data, rdata = sc.make_data(quick), ref.make_data(quick)
    for field in ("x", "w", "eval_mask"):
        assert _eq(getattr(data, field), getattr(rdata, field)), field
    assert _eq(data.eval_x(), rdata.eval_x())
    assert sorted(data.meta) == sorted(rdata.meta)
    for key in data.meta:
        assert _eq(data.meta[key], rdata.meta[key]), key
    if sc.stream is not None:
        batches, rbatches = sc.stream(quick), ref.stream(quick)
        assert len(batches) == len(rbatches)
        assert all(_eq(a, b) for a, b in zip(batches, rbatches))


def test_registry_well_formed():
    for name in list_scenarios(tag="paper"):
        sc = get_scenario(name)
        assert sc.summary and sc.k >= 1 and sc.m >= 1
        assert sc.conditions, name
        for cond in sc.conditions:
            assert isinstance(sc.params_for("soccer", cond, quick=True), dict)


def test_registry_quick_data_shapes():
    for name in PAPER:
        sc = get_scenario(name)
        data = sc.make_data(True)
        n, d = data.x.shape
        k = sc.k_for(True)
        assert np.all(np.isfinite(data.x)), name
        assert n >= 50 * k, (name, n, k)
        if data.eval_mask is not None:
            assert data.eval_mask.shape == (n,)
            assert 0 < data.eval_mask.sum() < n


def test_register_scenario_plugs_in(monkeypatch):
    # a registry of this test's own, so the plug-in leaves the port's as
    # it was for the tests after it in this process
    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))

    @register_scenario
    def _tiny():
        return Scenario(
            name="_test_tiny", summary="registration smoke",
            make_data=lambda quick: ScenarioData(
                x=np.random.default_rng(0).normal(
                    size=(400, 3)).astype(np.float32)),
            k=3, tags=("_test",))

    assert "_test_tiny" in list_scenarios(tag="_test")
    assert "_test_tiny" not in list_scenarios(tag="paper")
    rows = run_scenario(get_scenario("_test_tiny"), algos=("lloyd",),
                        quick=True, **CPU)
    assert len(rows) == 1 and rows[0]["cost_ratio"] > 0
    with pytest.raises(ValueError, match="unknown scenario"):
        get_scenario("_test_missing")


def test_coreset_scenarios_pinned_algos():
    assert get_scenario("coreset_budget").algos == (
        "soccer", "kmeans_parallel", "coreset_kmeans")
    assert get_scenario("int8_coreset").algos == ("soccer", "coreset_kmeans")
    assert get_scenario("zipf_gaussian").algos is None


def test_streaming_scenarios_registered():
    names = set(list_scenarios(tag="paper"))
    assert {"streaming_drift", "streaming_stationary"} <= names
    for name in ("streaming_drift", "streaming_stationary"):
        sc = get_scenario(name)
        assert sc.stream is not None and sc.stream_policies
        batches = sc.stream(True)
        assert len(batches) >= 8
        assert all(b.ndim == 2 and b.shape[1] == batches[0].shape[1]
                   for b in batches)
        assert {p.mode for p in sc.stream_policies} >= {"full", "update"}


def test_condition_restriction_reports_skipped():
    rows = run_scenario(get_scenario("faulty_cluster"),
                        algos=("kmeans_parallel",), quick=True, seed=0, **CPU)
    by_cond = {r["condition"]: r for r in rows}
    assert not by_cond["baseline"]["skipped"]
    assert by_cond["stragglers"]["skipped"]
    assert by_cond["hard_failure"]["skipped"]


def test_sweep_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("the default device is there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scenario(get_scenario("adversarial_kmeanspar"), quick=True)


# --------------------------------------------------- the adversarial gap


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_adversarial_gap_at_full_size(seed):
    """Theorem 7.2's gap at the scenario's own size (k = 25, z = 400):
    SOCCER needs strictly fewer rounds than k-means‖ needs to match its
    cost at equal coordinator memory."""
    rows = run_scenario(get_scenario("adversarial_kmeanspar"), quick=False,
                        seed=seed, **CPU)
    adv = {r["algo"]: r for r in rows}
    assert adv["kmeans_parallel"]["rounds_matched_target"]
    assert adv["soccer"]["rounds"] < adv["kmeans_parallel"]["rounds"]
    gap = summarize_gap(rows)
    assert gap is not None
    print(f"seed {seed}: {gap}; SOCCER n_hist {adv['soccer']['n_hist']}")


def _round_one(pkg, x, k, eta):
    kw = dict(m=8, seed=0, eta_override=eta)
    _, st = (capture_round(x, k, fit_fn=jfit, backend="virtual", **kw)
             if pkg == "jax" else capture_round(x, k, **kw, **CPU))
    return {name: np.asarray(a) for name, a in st.items()}


def _d2(pkg, x, c, cv):
    if pkg == "jax":
        return np.asarray(jops.min_dist(jnp.asarray(x), jnp.asarray(c),
                                        jnp.asarray(cv))[0])
    return ops.min_dist(torch.as_tensor(x), torch.as_tensor(c),
                        torch.as_tensor(cv))[0].numpy()


def test_adversarial_round_one_survivors_are_rounding():
    """Why round 1 leaves whole locations at the quick size, in both
    packages: every location is covered (its exact d2 to a round center
    is ~0) and v = 0, so a location survives iff the float32 expanded
    form ||x||^2 - 2 x.c + ||c||^2 comes out a few ulps above 0. At the
    same centers and v the two packages' removals differ only at such
    points: the shared arithmetic in two summation orders, not a fault."""
    sc = get_scenario("adversarial_kmeanspar")
    x, k = sc.make_data(True).x, sc.k_for(True)
    eta = sc.params_for("soccer", sc.conditions[0], True)["eta_override"]
    for pkg in ("jax", "torch"):
        st = _round_one(pkg, x, k, eta)
        m, p, d = st["x"].shape
        xs = st["x"].reshape(m * p, d)
        c, cv, v = st["c"], st["cv"], float(st["v"])
        assert v == 0.0, pkg
        tol = TOL_ULPS * np.finfo(np.float32).eps * (
            float((xs.astype(np.float64) ** 2).sum(1).max())
            + float((c[cv].astype(np.float64) ** 2).sum(1).max()))
        live = (xs[:, None, :] == np.unique(x, axis=0)[None]).all(-1).any(1)
        diff = xs.astype(np.float64)[:, None] - c[cv].astype(np.float64)[None]
        exact = (diff * diff).sum(-1).min(1)
        # every location is covered: round 1's centers sit on them
        assert exact[live].max() <= 1e-6, pkg
        surv = st["kept"].reshape(-1)
        assert surv.sum() > 0 and surv.sum() % 250 == 0, pkg
        other = "torch" if pkg == "jax" else "jax"
        d2o = _d2(other, xs, c, cv)
        d2s = _d2(pkg, xs, c, cv)
        kept_o = live & (d2o > v)
        # both packages' float32 d2 of every live point: within the
        # expanded form's bound of 0, so v = 0 decides by rounding alone
        assert d2o[live].max() <= tol and d2s[live].max() <= tol, pkg
        flips = kept_o != surv
        assert np.all(np.abs(d2o[flips] - v) <= tol), pkg
        print(f"{pkg}'s round 1: {surv.sum()} survivors; {other}'s "
              f"removal keeps {kept_o.sum()} (differs at {flips.sum()}); "
              f"live d2 up to {d2s[live].max():.4g} / {d2o[live].max():.4g}"
              f", exact up to {exact[live].max():.3g}, tol {tol:.3g}")


# ----------------------------------------------------------- the CLI


def test_run_list_matches_reference(capsys):
    assert run.main(["--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == list(PAPER)
    from repro.scenarios import run as jrun
    assert jrun.main(["--list"]) == 0
    assert capsys.readouterr().out.splitlines() == lines


def test_run_cli_writes_its_own_file(tmp_path, monkeypatch, capsys):
    bench = ROOT / "BENCH_scenarios.json"
    before = hashlib.sha256(bench.read_bytes()).hexdigest()
    monkeypatch.chdir(tmp_path)
    trace = tmp_path / "trace.jsonl"
    assert run.main(["--suite", "adversarial_kmeanspar", "--quick",
                     "--device", "cpu", "--trace-out", str(trace)]) == 0
    out = capsys.readouterr().out
    assert "adversarial gap: SOCCER" in out
    payload = json.loads((tmp_path / "BENCH_scenarios_torch.json")
                         .read_text())
    assert payload["device"] == "cpu" and payload["quick"]
    assert {r["algo"] for r in payload["rows"]} == {"soccer",
                                                    "kmeans_parallel"}
    assert all("trace" not in r for r in payload["rows"])
    assert len(trace.read_text().splitlines()) > 0
    assert not (tmp_path / "BENCH_scenarios.json").exists()
    assert hashlib.sha256(bench.read_bytes()).hexdigest() == before
    with pytest.raises(ValueError, match="no process group"):
        run.main(["--suite", "adversarial_kmeanspar", "--quick",
                  "--device", "cpu", "--backend", "mesh", "--out", ""])


# ----------------------------------------------------------- examples


def _example(name):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,lines", [
    ("quickstart_torch", ("rounds used:        1", "k-means cost:")),
    ("distributed_clustering_torch", ("round 1: N=", "!! killed machines [3]",
                                      "SOCCER cost (k centers",
                                      "k-means|| with the same rounds")),
    ("streaming_clustering_torch", ("full re-clusters fired: 1",
                                    "cumulative uplink:"))])
def test_example_runs_on_the_cpu(name, lines, capsys):
    _example(name).main(["--device", "cpu"])
    out = capsys.readouterr().out
    for line in lines:
        assert line in out, (line, out)


def test_distributed_example_law_over_seeds(capsys):
    """The distributed example's outcome is a draw: the reference's
    k-means‖ misses a cluster (10²x optimal) at two of seeds 0-3 and its
    SOCCER's final reduce to k, one k-means++ draw, can miss one too.
    Over seeds 0-3 the port's SOCCER stays within 2x optimal at three or
    more and its k-means‖ at one or more (chip_smoke.py's SEED_LAW)."""
    mod = _example("distributed_clustering_torch")
    ratios = [mod.main(["--device", "cpu", "--seed", str(seed)])
              for seed in range(4)]
    capsys.readouterr()
    assert all(np.isfinite(r).all() and min(r) > 0 for r in ratios), ratios
    assert sum(soc <= 2.0 for soc, _ in ratios) >= 3, ratios
    assert sum(kp <= 2.0 for _, kp in ratios) >= 1, ratios

