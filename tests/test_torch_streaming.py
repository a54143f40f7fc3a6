"""The port's streaming path (``repro_torch.streaming``, ``fit_update``,
``repro_torch.checkpoint``) against the JAX package's ``repro.streaming``:
the padded layouts bit for bit, serving on shared centers, the tree's
bookkeeping, the drift trigger, checkpoints either package wrote, and the
drifting-mixture acceptance at the reference test's size."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import fit as jfit
from repro.api import fit_update as jfit_update
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.data.synthetic import drifting_mixture as jdrifting_mixture
from repro.streaming import serve as jserve
from repro.streaming import tree as jtree
from repro.streaming.state import save_stream as jsave_stream
from repro.streaming.update import _shard_stream_batch as j_shard
from repro_torch.api import fit, fit_update
from repro_torch.api.backends import MACHINE, REPLICATED, MeshBackend
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.kmeans import kmeans
from repro_torch.core.metrics import centralized_cost
from repro_torch.coresets.sensitivity import build_coreset
from repro_torch.data.synthetic import drifting_mixture
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import REGISTRY
from repro_torch.streaming import (CenterSnapshot, StreamPolicy,
                                   flatten_tree, fold_batch, resident_rows,
                                   restore_stream, run_stream_suite,
                                   save_stream, serve_assign, snapshot,
                                   stream_bucket, tree_epsilon)
from repro_torch.streaming.update import _shard_stream_batch

# xdist runs one worker per core: with torch's default of one intra-op
# thread per core in every worker, the pools contend and small ops run
# several times slower
torch.set_num_threads(1)

CPU = dict(device="cpu")

MEANS4 = np.asarray([[0, 0, 0, 0], [6, 0, 0, 0],
                     [0, 6, 0, 0], [0, 0, 6, 0]], np.float32)


def _mixture_batch(rng, n, means, sigma=0.05):
    k, d = means.shape
    lab = rng.integers(0, k, size=n)
    return (means[lab] + sigma * rng.normal(size=(n, d))).astype(np.float32)


def _bootstrap(rng, means=MEANS4, n=1024):
    x0 = _mixture_batch(rng, n, means)
    return fit(x0, means.shape[0], algo="lloyd", m=1, seed=0, iters=20,
               **CPU)


def _cost(x, centers) -> float:
    return float(centralized_cost(torch.as_tensor(x),
                                  torch.as_tensor(centers)))


# ---------------------------------------------------------------- layouts


def test_stream_bucket_matches_reference():
    sizes = list(range(1, 3000)) + [4096, 4097, 156_250, 1_250_000]
    assert [stream_bucket(n) for n in sizes] == \
        [jtree.stream_bucket(n) for n in sizes]
    assert stream_bucket(156_250) == 262_144   # 1.25 M rows over 8


@pytest.mark.parametrize("n,m,weighted", [(1001, 4, False), (100, 8, True),
                                          (7, 3, False), (4096, 8, True)])
def test_shard_stream_batch_bit_for_bit(n, m, weighted):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    w = rng.uniform(size=n).astype(np.float32) if weighted else None
    xs, ws = _shard_stream_batch(x, w, m, **CPU)
    jxs, jws = j_shard(x, w, m)
    assert xs.dtype == torch.float32 and ws.dtype == torch.float32
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))


@pytest.mark.parametrize("kw", [dict(drift=0.04, birth_step=5),
                                dict(drift=0.0, death_step=2),
                                dict(drift=0.1, birth_step=1, death_step=3)],
                         ids=["birth", "death", "both"])
def test_drifting_mixture_matches_reference(kw):
    a, ha = drifting_mixture(steps=6, n_per_step=300, k=5, dim=15,
                             sigma=0.02, seed=53, **kw)
    b, hb = jdrifting_mixture(steps=6, n_per_step=300, k=5, dim=15,
                              sigma=0.02, seed=53, **kw)
    assert len(a) == len(b) == 6
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p, q)
    np.testing.assert_array_equal(ha, hb)


# ---------------------------------------------------------------- tree


@pytest.mark.parametrize("occupied", [[], [True], [False, True],
                                      [True, False, True],
                                      [False, False, False, True]])
@pytest.mark.parametrize("t", [1, 80, 128])
def test_resident_rows_and_tree_epsilon_match_reference(occupied, t):
    assert resident_rows(occupied, t) == jtree.resident_rows(occupied, t)
    assert tree_epsilon(occupied, t) == jtree.tree_epsilon(occupied, t)


def test_fold_is_a_binary_counter():
    """Five folds of batches of five sizes (one bucket width): levels 0
    and 2 occupied (binary 101), t rows each, the weight mass kept."""
    rng = np.random.default_rng(0)
    t, kb, m = 80, 3, 4
    levels, occupied = [], []
    total = 0
    for key, n in enumerate([100, 390, 222, 512, 64]):
        xs, ws = _shard_stream_batch(
            rng.normal(size=(n, 3)).astype(np.float32), None, m, **CPU)
        assert xs.shape == (m, 128, 3)   # all sizes hit one bucket
        fold_batch(levels, occupied, key, xs, ws, t, kb)
        total += n
    assert occupied == [True, False, True]
    assert levels[1] is None
    assert [tuple(b[0].shape) for b in levels if b is not None] == \
        [(m, t, 3)] * 2
    assert resident_rows(occupied, t) == 2 * t
    pts, wts = flatten_tree(levels, occupied, m, t, 3, **CPU)
    assert pts.shape == (m, 3 * t, 3) and wts.shape == (m, 3 * t)
    assert float(wts[:, t:2 * t].abs().sum()) == 0.0   # the empty level
    assert float(wts.sum()) == pytest.approx(total, rel=0.25)
    # the same keys give the same tree
    again_l, again_o = [], []
    rng = np.random.default_rng(0)
    for key, n in enumerate([100, 390, 222, 512, 64]):
        xs, ws = _shard_stream_batch(
            rng.normal(size=(n, 3)).astype(np.float32), None, m, **CPU)
        fold_batch(again_l, again_o, key, xs, ws, t, kb)
    for a, b in zip(levels, again_l):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_tree_matches_one_shot_coreset_cost():
    """Centers fit on the flattened tree cost about the same on the full
    data as centers fit on a one-shot coreset of equal size."""
    rng = np.random.default_rng(1)
    m, t, kb, k = 2, 64, 4, 4
    batches = [_mixture_batch(rng, 512, MEANS4) for _ in range(6)]
    levels, occupied = [], []
    for key, b in enumerate(batches):
        xs, ws = _shard_stream_batch(b, None, m, **CPU)
        fold_batch(levels, occupied, 7 + key, xs, ws, t, kb)
    pts, wts = flatten_tree(levels, occupied, m, t, 4, **CPU)
    tree_x, tree_w = pts.reshape(-1, 4), wts.reshape(-1)
    full = torch.as_tensor(np.concatenate(batches))
    assert float(tree_w.sum()) == pytest.approx(full.shape[0], rel=0.25)
    one_x, one_w = build_coreset(torch.Generator().manual_seed(3), full,
                                 torch.ones(full.shape[0]),
                                 resident_rows(occupied, t) * m, kb)

    def best_cost(x, w):
        return min(_cost(full, kmeans(torch.Generator().manual_seed(s), x,
                                      w, k, 20)[0]) for s in (0, 1))

    cost_tree = best_cost(tree_x, tree_w)
    cost_one = best_cost(one_x, one_w)
    cost_full = best_cost(full, torch.ones(full.shape[0]))
    assert cost_tree <= 2.0 * max(cost_one, 1e-12)
    assert cost_tree <= 2.5 * max(cost_full, 1e-12)


# ----------------------------------------------------------- fit_update


def test_fit_update_validation_errors(monkeypatch):
    rng = np.random.default_rng(2)
    res = _bootstrap(rng)
    xb = _mixture_batch(rng, 256, MEANS4)
    with pytest.raises(ValueError, match="recluster"):
        fit_update(res, xb, m=4, recluster="sometimes", **CPU)
    with pytest.raises(ValueError, match="d="):
        fit_update(res, rng.normal(size=(256, 7)).astype(np.float32),
                   m=4, coreset_rows=128, **CPU)
    with pytest.raises(NotImplementedError,
                       match="fit_update currently runs on the virtual"):
        fit_update(res, xb, m=4, backend=MeshBackend(), **CPU)
    with pytest.raises(ValueError, match="backend"):
        fit_update(res, xb, m=4, backend="tpu", **CPU)
    res2 = fit_update(res, xb, m=4, coreset_rows=128, backend="auto", **CPU)
    with pytest.raises(ValueError, match="conflicts"):
        fit_update(res2, xb, m=8, **CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit_update(res, xb, m=4)           # the card is the default


def test_no_drift_never_reclusters():
    """Stationary stream + auto trigger: the warm start tracks, the
    trigger stays quiet, every update uploads m·k·refine_iters rows, and
    each evaluation lands in the drift event log."""
    rng = np.random.default_rng(3)
    res = _bootstrap(rng)
    with REGISTRY.scope("streaming.drift.events") as sc:
        for _ in range(5):
            res = fit_update(res, _mixture_batch(rng, 1024, MEANS4), m=4,
                             coreset_rows=128, refine_iters=2,
                             drift_tol=1.5, **CPU)
            assert res.extra["reclustered"] is False
    assert res.rounds == 0
    assert res.extra["stream"].n_reclusters == 0
    assert list(res.uplink_points) == [4 * 4 * 2] * 5
    np.testing.assert_array_equal(res.uplink_bytes, 4 * 4 * 2 * 4 * 4)
    log = sc.delta()["streaming.drift.events"]
    assert not any(e["fired"] for e in log["events"][-5:])


def test_injected_shift_fires_drift_trigger():
    """A mean shift the warm start cannot track fires the re-cluster, the
    re-cluster fixes the centers, and a full trace records the event."""
    rng = np.random.default_rng(4)
    res = _bootstrap(rng)
    for _ in range(3):
        res = fit_update(res, _mixture_batch(rng, 1024, MEANS4), m=4,
                         coreset_rows=128, refine_iters=2, drift_tol=1.5,
                         **CPU)
    assert res.rounds == 0
    stale = np.asarray(res.centers)
    shifted = MEANS4 + np.asarray([[8.0, 8.0, 0, 0]], np.float32)
    fired = False
    rt = obs_trace.RunTrace(mode="full")
    with obs_trace.run_trace(rt):
        for _ in range(3):
            xb = _mixture_batch(rng, 1024, shifted)
            res = fit_update(res, xb, m=4, coreset_rows=128, refine_iters=2,
                             drift_tol=1.5, **CPU)
            fired = fired or res.extra["reclustered"]
    assert fired and res.rounds >= 1
    assert [e["name"] for e in rt.events] == \
        ["streaming.drift.recluster"] * res.rounds
    assert {"streaming.fold", "streaming.refine",
            "streaming.recluster"} <= {s["name"] for s in rt.spans}
    assert res.cost(xb, **CPU) < 0.5 * _cost(xb, stale)
    assert max(res.uplink_points) > 10 * min(res.uplink_points)


def test_recluster_modes_never_and_always():
    rng = np.random.default_rng(5)
    res_n = _bootstrap(rng)
    shifted = MEANS4 + 8.0
    for _ in range(3):
        res_n = fit_update(res_n, _mixture_batch(rng, 512, shifted), m=4,
                           coreset_rows=128, recluster="never", **CPU)
    assert res_n.rounds == 0
    res_a = _bootstrap(rng)
    res_a = fit_update(res_a, _mixture_batch(rng, 512, MEANS4), m=4,
                       coreset_rows=128, recluster="always", **CPU)
    assert res_a.rounds == 1 and res_a.extra["reclustered"] is True
    assert res_a.extra["stream"].n_reclusters == 1


# -------------------------------------------------------------- serving


@pytest.mark.parametrize("n,batch,k", [(1001, 256, 5), (4096, 4096, 25),
                                       (5000, 4096, 3)])
def test_serve_assign_matches_reference(n, batch, k):
    """On shared centers the port serves what the reference serves: d2
    within 2e-3, an argmin that differs only on a tie (its realized
    distance equals the reference's within the tolerance), the snapshot's
    version, and one latency observation a chunk."""
    rng = np.random.default_rng(n)
    centers = rng.normal(size=(k, 15)).astype(np.float32)
    x = rng.normal(size=(n, 15)).astype(np.float32)
    snap = CenterSnapshot(centers, version=7)
    hist = REGISTRY.read("streaming.serve.latency_ms")
    before = hist["streaming.serve.latency_ms"]["count"]
    assign, d2, version = serve_assign(snap, x, batch=batch, **CPU)
    after = REGISTRY.read("streaming.serve.latency_ms")
    assert after["streaming.serve.latency_ms"]["count"] - before == \
        -(-n // batch)
    ja, jd, jv = jserve.serve_assign(jserve.CenterSnapshot(centers, 7), x,
                                     batch=batch)
    assert version == jv == 7
    assert assign.dtype == np.int32 and d2.dtype == np.float32
    np.testing.assert_allclose(d2, jd, rtol=2e-3, atol=2e-3)
    real = np.sum((x - centers[assign]) ** 2, axis=1)
    jreal = np.sum((x - centers[ja]) ** 2, axis=1)
    np.testing.assert_allclose(real, jreal, rtol=2e-3, atol=2e-3)
    with pytest.raises(ValueError, match="queries"):
        serve_assign(snap, np.zeros((4, 9), np.float32), **CPU)


def test_snapshot_versions_are_monotone():
    rng = np.random.default_rng(7)
    res = _bootstrap(rng)
    assert snapshot(res).version == 0          # batch fit serves as v0
    seen = [0]
    for _ in range(3):
        res = fit_update(res, _mixture_batch(rng, 512, MEANS4), m=4,
                         coreset_rows=128, **CPU)
        seen.append(snapshot(res).version)
    assert seen == sorted(seen) and len(set(seen)) == len(seen)
    assert snapshot(res).centers.shape == (4, 4)


# ----------------------------------------------------------- checkpoint


def test_checkpointer_layout_matches_reference(tmp_path):
    """step-N/leaves.npz + manifest.json under the same a/b/0 keys: a tree
    the reference wrote restores in the port and the port's in the
    reference; keep-k and the async writer work; restore(shardings=)
    places each leaf by a device or a placement mark."""
    tree = {"b": [np.arange(6.0, dtype=np.float32).reshape(2, 3),
                  np.zeros((4,), np.int32)],
            "a": np.arange(10.0), "c": {"d": np.float32(3.5)}}
    JCheckpointer(str(tmp_path / "j"), use_async=False).save(7, tree)
    Checkpointer(str(tmp_path / "t"), use_async=False).save(7, tree)
    for side in ("j", "t"):
        files = sorted(p.name for p in (tmp_path / side / "step-7").iterdir())
        assert files == ["leaves.npz", "manifest.json"]
    jman = np.load(tmp_path / "j" / "step-7" / "leaves.npz")
    tman = np.load(tmp_path / "t" / "step-7" / "leaves.npz")
    assert sorted(jman.files) == sorted(tman.files) == \
        ["a", "b/0", "b/1", "c/d"]
    template = {"a": torch.zeros(10, dtype=torch.float64),
                "b": [np.zeros((2, 3)), np.zeros(4)],
                "c": {"d": np.zeros(())}}
    got = Checkpointer(str(tmp_path / "j"), use_async=False).restore(template)
    assert isinstance(got["a"], torch.Tensor)
    np.testing.assert_array_equal(got["a"].numpy(), tree["a"])
    np.testing.assert_array_equal(got["b"][0], tree["b"][0])
    assert got["b"][1].dtype == np.int32 and float(got["c"]["d"]) == 3.5
    jgot = JCheckpointer(str(tmp_path / "t"), use_async=False).restore(
        jax.eval_shape(lambda: jax.tree.map(jnp.asarray, tree)))
    np.testing.assert_array_equal(np.asarray(jgot["b"][0]), tree["b"][0])
    with pytest.raises(ValueError, match="leaf a"):
        Checkpointer(str(tmp_path / "t")).restore({**template,
                                                   "a": np.zeros(3)})
    placed = Checkpointer(str(tmp_path / "t")).restore(
        template, shardings={"a": "cpu", "b": [MACHINE, REPLICATED],
                             "c": {"d": torch.device("cpu")}})
    assert isinstance(placed["b"][0], torch.Tensor)
    np.testing.assert_array_equal(placed["b"][0].numpy(), tree["b"][0])
    np.testing.assert_array_equal(placed["a"].numpy(), tree["a"])
    assert float(placed["c"]["d"]) == 3.5

    ck = Checkpointer(str(tmp_path / "k"), keep=2, use_async=True)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.full((3,), float(s))})
    ck.wait()
    assert sorted(ck.all_steps()) == [3, 4] and ck.latest_step() == 4
    np.testing.assert_array_equal(
        ck.restore({"x": np.zeros(3)})["x"], np.full(3, 4.0))
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "none")).restore({"x": np.zeros(3)})


def test_stream_checkpoint_roundtrip_and_resume(tmp_path):
    """Save a mid-stream state, restore it cold (no template), and the
    restored fork replays the next two updates bit for bit: tree buffers,
    centers, version and the random stream all survive."""
    rng = np.random.default_rng(8)
    res = _bootstrap(rng)
    for _ in range(3):
        res = fit_update(res, _mixture_batch(rng, 512, MEANS4), m=4,
                         coreset_rows=128, **CPU)
    state = res.extra["stream"]
    ck = Checkpointer(str(tmp_path), use_async=False)
    save_stream(ck, 3, state)
    got = restore_stream(ck, **CPU)
    assert got.version == state.version and got.k == state.k
    assert got.occupied == state.occupied
    assert got.n_updates == 3 and got.n_seen == state.n_seen
    assert got.uplink_points == state.uplink_points
    np.testing.assert_array_equal(got.key, state.key)
    np.testing.assert_array_equal(got.centers, state.centers)
    for a, b in zip(got.levels, state.levels):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    fork = dataclasses.replace(res, extra={**res.extra, "stream": got})
    for _ in range(2):
        xb = _mixture_batch(rng, 512, MEANS4)
        res = fit_update(res, xb, recluster="always", **CPU)
        fork = fit_update(fork, xb, recluster="always", **CPU)
        np.testing.assert_array_equal(res.centers, fork.centers)
        assert res.extra["version"] == fork.extra["version"]
    with pytest.raises(FileNotFoundError):
        restore_stream(Checkpointer(str(tmp_path / "none")), **CPU)


def test_port_restores_reference_stream_checkpoint(tmp_path):
    """A stream checkpoint the reference wrote restores in the port with
    every buffer but the reference's PRNG key as written, and the port
    carries the stream on from it."""
    rng = np.random.default_rng(9)
    x0 = _mixture_batch(rng, 1024, MEANS4)
    res = jfit(x0, 4, algo="lloyd", backend="virtual", m=1, seed=0,
               iters=20)
    batches = [_mixture_batch(rng, 512, MEANS4) for _ in range(3)]
    for xb in batches[:2]:               # occupancy [False, True]
        res = jfit_update(res, xb, m=4, coreset_rows=128)
    jstate = res.extra["stream"]
    assert jstate.occupied == [False, True]
    jck = JCheckpointer(str(tmp_path), use_async=False)
    jsave_stream(jck, 2, jstate)

    got = restore_stream(Checkpointer(str(tmp_path), use_async=False),
                         **CPU)
    np.testing.assert_array_equal(got.centers, jstate.centers)
    assert got.occupied == jstate.occupied
    assert (got.version, got.k, got.m, got.t, got.kb, got.n_updates,
            got.n_reclusters) == (jstate.version, jstate.k, jstate.m,
                                  jstate.t, jstate.kb, jstate.n_updates,
                                  jstate.n_reclusters)
    assert got.n_seen == jstate.n_seen
    assert got.uplink_points == jstate.uplink_points
    assert got.uplink_bytes == jstate.uplink_bytes
    for a, b in zip(got.levels, jstate.levels):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a[0].numpy(), np.asarray(b[0]))
            np.testing.assert_array_equal(a[1].numpy(), np.asarray(b[1]))
    from repro_torch.api.result import ClusterResult
    carry = ClusterResult(centers=got.centers, k=4, algo="stream",
                          backend="virtual", rounds=0,
                          uplink_points=np.zeros(1), uplink_bytes=np.zeros(1),
                          extra={"stream": got})
    nxt = fit_update(carry, batches[2], **CPU)
    assert nxt.extra["version"] == jstate.version + 1
    assert nxt.extra["stream"].n_updates == 3
    assert nxt.extra["stream"].occupied == [True, True]
    assert nxt.cost(batches[2], **CPU) <= 1.5 * _cost(batches[2], MEANS4)


# ------------------------------------------------- acceptance


@pytest.fixture(scope="module")
def stream_rows():
    eta = dict(eta_override=1024)
    pols = (
        StreamPolicy("full_every_step", mode="full", cadence=1,
                     fit_params=eta),
        StreamPolicy("update_c1", mode="update", cadence=1,
                     recluster="auto", drift_tol=1.5, refine_iters=2,
                     fit_params=eta),
        StreamPolicy("update_c4", mode="update", cadence=4,
                     recluster="auto", drift_tol=1.5, refine_iters=2,
                     fit_params=eta),
    )
    drift, _ = drifting_mixture(steps=12, n_per_step=768, k=8, dim=8,
                                drift=0.04, sigma=0.02, birth_step=6,
                                seed=53)
    flat, _ = drifting_mixture(steps=12, n_per_step=768, k=8, dim=8,
                               drift=0.0, sigma=0.02, seed=59)
    return {
        "drift": run_stream_suite(drift, 8, pols, m=8, seed=0, **CPU),
        "stationary": run_stream_suite(flat, 8, pols[:2], m=8, seed=0,
                                       **CPU),
    }


def test_acceptance_update_tracks_full_at_fraction_of_uplink(stream_rows):
    """The reference's acceptance (tests/test_streaming.py:280-334) at its
    size: on the drifting mixture, ``fit_update`` at cadence 1 stays
    within 1.1x the cost of a full re-cluster every step on <= 25% of its
    uplink, catches the birth, and cadence 4 spends less."""
    by = {r["policy"]: r for r in stream_rows["drift"]}
    up = by["update_c1"]
    assert up["cost_vs_full"] <= 1.1
    assert up["uplink_frac_of_full"] <= 0.25
    assert up["reclusters"] >= 1
    c4 = by["update_c4"]
    assert c4["uplink_bytes"] < up["uplink_bytes"]
    assert c4["cost_vs_full"] <= 1.25
    for r in stream_rows["drift"]:
        for col in ("policy", "mode", "cadence", "staleness_cost",
                    "final_cost", "uplink_bytes", "bootstrap_uplink_bytes",
                    "reclusters", "version"):
            assert col in r, col


def test_acceptance_stationary_control_never_reclusters(stream_rows):
    by = {r["policy"]: r for r in stream_rows["stationary"]}
    up = by["update_c1"]
    assert up["reclusters"] == 0
    assert up["cost_vs_full"] <= 1.15
    assert up["uplink_frac_of_full"] <= 0.25
