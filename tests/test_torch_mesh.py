"""The mesh backend on the CPU: one machine per ``torch.distributed`` rank.

One module fixture runs a 4-rank gloo job in a subprocess with a hard
timeout (``python tests/test_torch_mesh.py OUT``: the ranks start by
``spawn`` from ``repro_torch.launch.mesh.spawn_local``, one intra-op
thread each, over a ``file://`` store under the test's temporary
directory). Every rank runs the same mesh fits over the same numpy
data, rank 0 also the virtual fits, and each writes what it got; the
tests read those files. Beside it the launch CLI runs on 2 CPU ranks.
The claims are the reference's (``tests/test_distributed.py``,
``tests/test_wire.py``'s mesh tests, ``tests/test_obs.py``'s mesh leg),
held bit for bit where the port gives the virtual run's bits: everywhere
but the sharded coordinator's Lloyd step, whose plain version sums in
float (the card's kernel sums in fixed point, and there the mesh gives
its bits: ``chip_smoke.py``'s ``mesh_phase``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RANKS = 4
JOB_TIMEOUT_S = 240
K = 5

# fit knobs of each mesh-vs-virtual configuration (small: a job's fits
# share one subprocess)
FITS = {
    "soccer": dict(algo="soccer", epsilon=0.2, eta_override=900),
    "kmeans_parallel": dict(algo="kmeans_parallel", rounds=2,
                            lloyd_iters=5),
    "eim11": dict(algo="eim11", epsilon=0.2, max_rounds=2),
    "lloyd": dict(algo="lloyd", iters=5),
    "minibatch": dict(algo="minibatch", batch=128, steps=10),
    "coreset_kmeans": dict(algo="coreset_kmeans", coreset_size=512,
                           lloyd_iters=5),
    "kzmeans": dict(algo="kzmeans", coreset_size=512, lloyd_iters=5,
                    outlier_frac=0.02),
    "sharded_bisect": dict(algo="soccer", epsilon=0.2, eta_override=1200,
                           sharded_coordinator=True, max_rounds=2),
    "sharded_topk": dict(algo="soccer", epsilon=0.2, eta_override=1200,
                         sharded_coordinator=True, max_rounds=2,
                         sharded_threshold="topk"),
    "sharded_kmeanspar": dict(algo="soccer", epsilon=0.2, eta_override=1200,
                              sharded_coordinator=True, max_rounds=2,
                              sharded_seeding="kmeanspar"),
    "coreset_uplink": dict(algo="soccer", epsilon=0.2, eta_override=900,
                           uplink_mode="coreset"),
    "raw_uplink": dict(algo="soccer", epsilon=0.2, eta_override=900),
    "int8": dict(algo="soccer", epsilon=0.2, eta_override=900,
                 uplink_dtype="int8"),
    "failures": dict(algo="soccer", epsilon=0.2, eta_override=900,
                     fail_at={1: (2,)}, straggler_rate=0.3),
    "coreset_codes": dict(algo="coreset_kmeans", coreset_size=128,
                          uplink_dtype="int8"),
    "coreset_values": dict(algo="coreset_kmeans", coreset_size=128,
                           uplink_dtype="int8", uplink_wire="values"),
}
ALGOS = ("soccer", "kmeans_parallel", "eim11", "lloyd", "minibatch",
         "coreset_kmeans", "kzmeans")
SHARDED = ("sharded_bisect", "sharded_topk", "sharded_kmeanspar")


def _data():
    rng = np.random.default_rng(0)
    means = rng.normal(scale=5.0, size=(K, 6))
    return (means[rng.integers(K, size=4800)]
            + rng.normal(size=(4800, 6))).astype(np.float32)


def _summary(res, x) -> dict:
    def ints(a):
        return None if a is None else [int(v) for v in a]
    return dict(
        centers=np.asarray(res.centers, np.float32).tobytes().hex(),
        finite=bool(np.all(np.isfinite(res.centers))),
        rounds=int(res.rounds), n_hist=ints(res.n_hist),
        uplink=ints(res.uplink_points), wire=ints(res.wire_bytes),
        meta=ints(res.wire_meta_bytes), backend=res.backend,
        uplink_bytes_total=int(res.uplink_bytes_total),
        cost=float(res.cost(x, device="cpu")))


def _fit(x, kw, backend, **extra):
    from repro_torch.api import fit
    from repro_torch.ft.failures import FailurePlan
    kw = dict(kw)
    algo = kw.pop("algo")
    if "fail_at" in kw:
        kw["failure_plan"] = FailurePlan(fail_at=kw.pop("fail_at"),
                                         straggler_rate=kw.pop(
                                             "straggler_rate"))
    return fit(x, K, algo=algo, m=RANKS, backend=backend, seed=4,
               device="cpu", **kw, **extra)


def _wire_checks(rank: int) -> dict:
    """test_wire.py's comm-level mesh checks: the collectives move the
    virtual wire's bits."""
    from repro_torch.api.backends import mesh_comm
    from repro_torch.core.comm import VirtualCluster
    from repro_torch.ft.compression import (affine_qparams,
                                            quantize_affine_int8)
    comm, virt = mesh_comm(), VirtualCluster(RANKS)
    x = torch.from_numpy(np.random.default_rng(11).normal(
        size=(RANKS, 5, 3)).astype(np.float32))
    xp = x[rank:rank + 1]
    scale, zp = affine_qparams(xp)
    codes = quantize_affine_int8(xp, scale, zp)
    got = [comm._gather(codes), comm._gather(scale), comm._gather(zp),
           comm.all_machines_compressed(xp)]
    sv, zv = affine_qparams(x)
    want = [quantize_affine_int8(x, sv, zv), sv, zv,
            virt.all_machines_compressed(x)]
    counts = torch.tensor([2, 0] * (RANKS // 2), dtype=torch.int32)
    ragged = comm.gather_ragged(xp, counts, rows=3 * RANKS)
    return dict(
        codes_int8=got[0].dtype == torch.int8,
        qparams_bits=all(torch.equal(a, b) for a, b in zip(got, want)),
        ragged_bits=torch.equal(
            ragged, virt.gather_ragged(x, counts, rows=3 * RANKS)))


def _part_checks(rank: int) -> dict:
    """The sharded coordinator's two part-by-part steps against one call
    over the flattened buffer: the seeding's draws (the virtual
    seeding's bits) and the Lloyd step's fixed-point sums (the card
    kernel's arithmetic, ``ref.fixed_point_reduce_ref``, over all
    rows)."""
    from repro_torch.api.backends import mesh_comm
    from repro_torch.core.comm import VirtualCluster
    from repro_torch.core.sharded_kmeans import (distributed_kmeans_pp,
                                                 distributed_lloyd)
    from repro_torch.kernels import ref
    comm = mesh_comm()
    rng = np.random.default_rng(7)
    pts = torch.from_numpy(rng.normal(size=(RANKS, 300, 4)).astype(
        np.float32))
    ws = torch.from_numpy(rng.random((RANKS, 300)).astype(np.float32))
    ws[:, 250:] = 0.0                     # empty slots, as the draws leave
    mine = slice(rank, rank + 1)

    def seeded(c):
        return distributed_kmeans_pp(torch.Generator().manual_seed(3), c,
                                     pts[mine] if c is comm else pts,
                                     ws[mine] if c is comm else ws, 9)
    c_mesh, c_virt = seeded(comm), seeded(VirtualCluster(RANKS))
    step = distributed_lloyd(comm, pts[mine], ws[mine], c_virt, 1)
    xf, wf = pts.reshape(-1, 4), ws.reshape(-1)
    _, assign = ref.min_dist_ref(xf, c_virt)
    sums, counts = ref.fixed_point_reduce_ref(xf, wf, assign, 9)
    want = torch.where(counts[:, None] > 0,
                       sums / torch.clamp(counts[:, None], min=1e-30),
                       c_virt)
    return dict(seeding_bits=torch.equal(c_mesh, c_virt),
                lloyd_fixed_point_bits=torch.equal(step, want))


def _restore_check(rank: int, out: str) -> dict:
    """restore(shardings=MACHINE) under a group keeps this rank's row."""
    from repro_torch.api.backends import MACHINE, REPLICATED
    from repro_torch.checkpoint.checkpointer import Checkpointer
    tree = {"x": np.arange(RANKS * 3.0).reshape(RANKS, 3),
            "c": np.ones(2)}
    ck = Checkpointer(os.path.join(out, f"ck{rank}"), use_async=False)
    ck.save(1, tree)
    got = ck.restore({"x": np.zeros((RANKS, 3)), "c": np.zeros(2)},
                     shardings={"x": MACHINE, "c": REPLICATED})
    return dict(restore_row=bool(
        got["x"].shape == (1, 3)
        and np.array_equal(got["x"].numpy(), tree["x"][rank:rank + 1])
        and np.array_equal(got["c"].numpy(), tree["c"])))


def _shim_checks(rank: int) -> dict:
    """core/distributed.py's entry points: ``run_soccer_mesh`` gives the
    virtual ``run_soccer``'s bits, and rounds driven one by one through
    ``make_mesh_step`` give ``run_soccer_mesh``'s."""
    from repro_torch.configs.soccer_paper import SoccerParams
    from repro_torch.core import distributed, soccer
    parts = _data().reshape(RANKS, -1, 6)
    params = SoccerParams(k=K, epsilon=0.2, n_machines=RANKS, seed=4)
    virt = soccer.run_soccer(parts, params, eta_override=900, device="cpu")
    mesh = distributed.run_soccer_mesh(parts, params, eta_override=900,
                                       device="cpu")
    const = soccer.derive_constants(parts.shape[0] * parts.shape[1],
                                    parts.shape[1], params, 900, m=RANKS)
    state = soccer.init_state(
        torch.from_numpy(parts[rank:rank + 1]), const,
        torch.Generator().manual_seed(params.seed),
        comm=distributed.mesh_cluster())
    step = distributed.make_mesh_step(const)
    for _ in range(mesh.rounds):
        state = step(state)
    state = distributed.make_mesh_step(const, finalize=True)(state)
    return dict(
        run_soccer_mesh_bits=bool(
            mesh.backend == "mesh" and mesh.rounds == virt.rounds >= 2
            and np.array_equal(mesh.n_hist, virt.n_hist)
            and mesh.centers.tobytes() == virt.centers.tobytes()),
        mesh_step_bits=bool(
            soccer.flatten_centers(state).tobytes()
            == mesh.centers.tobytes()
            and np.array_equal(state.n_hist.numpy(), mesh.n_hist)))


def _job(rank: int, out: str) -> None:
    x = _data()
    res = {}
    for name, kw in FITS.items():
        res[name] = dict(mesh=_summary(_fit(x, kw, "mesh"), x))
        if rank == 0:       # the virtual fits are every rank's alike
            res[name]["virtual"] = _summary(_fit(x, kw, "virtual"), x)
    for algo in ALGOS:
        res[algo]["repeat"] = _summary(_fit(x, FITS[algo], "mesh"), x)
    traces = {}
    for backend in ("virtual", "mesh") if rank == 0 else ("mesh",):
        r = _fit(x, FITS["soccer"], backend, trace="rounds")
        traces[backend] = dict(records=r.extra["trace"]["records"],
                               wire_total=r.wire_bytes_total)
    res["traces"] = traces
    res["checks"] = {**_wire_checks(rank), **_part_checks(rank),
                     **_restore_check(rank, out), **_shim_checks(rank)}
    Path(out, f"rank{rank}.json").write_text(json.dumps(
        res, default=lambda v: v.item() if hasattr(v, "item") else str(v)))


def _reference_soccer() -> dict:
    """The JAX reference's virtual SOCCER fit on ``_data()`` (runs in the
    test process while the ranks run)."""
    import jax.numpy as jnp

    from repro.api import fit as jfit
    x = _data()
    kw = {k: v for k, v in FITS["soccer"].items() if k != "algo"}
    ref = jfit(x, K, algo="soccer", backend="virtual", m=RANKS, seed=4,
               **kw)
    return dict(rounds=int(ref.rounds),
                n_hist=[int(v) for v in ref.n_hist],
                cost=float(ref.cost(jnp.asarray(x))))


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               TMPDIR=str(out))
    pipes = dict(env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                 text=True)
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch", "--devices", "2",
         "--device", "cpu", "--algo", "soccer", "--k", "4", "--n", "4000",
         "--param", "eta_override=500"], **pipes)
    ranks = subprocess.Popen([sys.executable, __file__, str(out)], **pipes)
    try:
        reference = _reference_soccer()
        _, err = ranks.communicate(timeout=JOB_TIMEOUT_S)
        cli_out, cli_err = cli.communicate(timeout=JOB_TIMEOUT_S)
    finally:
        ranks.kill()
        cli.kill()
    assert ranks.returncode == 0, err[-4000:]
    assert cli.returncode == 0, cli_err[-4000:]
    return dict(ranks=[json.loads((out / f"rank{r}.json").read_text())
                       for r in range(RANKS)],
                cli=json.loads(cli_out), cli_err=cli_err,
                reference=reference)


def _pair(job, name):
    r0 = job["ranks"][0][name]
    return r0["mesh"], r0["virtual"]


@pytest.mark.parametrize("field", ["centers", "rounds", "n_hist", "uplink",
                                   "wire", "meta"])
def test_soccer_gather_mesh_equals_virtual_bitwise(job, field):
    mesh, virt = _pair(job, "soccer")
    assert mesh["rounds"] >= 2            # removal rounds really ran
    assert mesh[field] == virt[field]


@pytest.mark.parametrize("algo", ALGOS)
def test_every_algorithm_runs_on_the_mesh(job, algo):
    """Finite centers, backend "mesh", a same-seed rerun bit for bit, and
    the virtual fit's bits."""
    mesh, virt = _pair(job, algo)
    repeat = job["ranks"][0][algo]["repeat"]
    assert mesh["backend"] == "mesh" and virt["backend"] == "virtual"
    assert mesh["finite"] and np.isfinite(mesh["cost"])
    assert repeat == mesh
    assert {**mesh, "backend": None} == {**virt, "backend": None}


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_coordinator_meets_the_reference_claim(job, name):
    """tests/test_distributed.py's claim for the sharded coordinator: the
    same rounds and cost <= 1.5x the virtual fit's + 1e-3 (on the CPU the
    Lloyd step's plain float sums differ from the mesh's fixed point)."""
    mesh, virt = _pair(job, name)
    assert mesh["backend"] == "mesh" and mesh["finite"]
    assert mesh["rounds"] == virt["rounds"] and mesh["n_hist"][0] == 4800
    assert mesh["cost"] <= 1.5 * virt["cost"] + 1e-3


@pytest.mark.parametrize("check", ["seeding_bits",
                                   "lloyd_fixed_point_bits"])
def test_sharded_steps_part_by_part(job, check):
    assert all(r["checks"][check] for r in job["ranks"])


def test_coreset_uplink_mesh_equals_virtual_below_raw(job):
    mesh, virt = _pair(job, "coreset_uplink")
    raw, _ = _pair(job, "raw_uplink")
    assert {**mesh, "backend": None} == {**virt, "backend": None}
    assert mesh["uplink_bytes_total"] < raw["uplink_bytes_total"]


def test_failure_plan_mesh_equals_virtual(job):
    mesh, virt = _pair(job, "failures")
    assert {**mesh, "backend": None} == {**virt, "backend": None}


@pytest.mark.parametrize("check", ["codes_int8", "qparams_bits",
                                   "ragged_bits"])
def test_mesh_collectives_move_the_virtual_bits(job, check):
    """test_wire.py's codes/qparams parity (int8 codes at one byte) and
    its ragged gather, bit for bit on every rank."""
    assert all(r["checks"][check] for r in job["ranks"])


def test_mesh_int8_codes_wire_is_quarter_of_f32(job):
    f32, _ = _pair(job, "soccer")
    i8, _ = _pair(job, "int8")
    assert f32["backend"] == i8["backend"] == "mesh"
    assert sum(i8["wire"]) / sum(f32["wire"]) <= 0.3
    assert i8["wire"] == [int(u) * 6 for u in i8["uplink"]]


def test_mesh_fit_codes_matches_values_wire(job):
    codes, _ = _pair(job, "coreset_codes")
    vals, _ = _pair(job, "coreset_values")
    assert codes["centers"] == vals["centers"]
    assert sum(vals["wire"]) == 4 * sum(codes["wire"])


def test_traces_equal_except_time(job):
    """test_obs.py's mesh leg: the wire-sum identity on both backends and
    every record field but the times equal."""
    t = job["ranks"][0]["traces"]
    for side in t.values():
        assert sum(r["wire_payload_bytes"] + r["wire_meta_bytes"]
                   for r in side["records"]) == side["wire_total"]
    drop = ("wall_s", "compile_s")
    strip = [[{k: v for k, v in r.items() if k not in drop}
              for r in t[b]["records"]] for b in ("virtual", "mesh")]
    assert strip[0] == strip[1] and len(strip[0]) >= 3


@pytest.mark.parametrize("name", sorted(FITS))
def test_every_rank_returns_the_same_result(job, name):
    first = job["ranks"][0][name]["mesh"]
    assert all(r[name]["mesh"] == first for r in job["ranks"][1:])


@pytest.mark.parametrize("check", ["run_soccer_mesh_bits",
                                   "mesh_step_bits"])
def test_distributed_entry_points(job, check):
    assert all(r["checks"][check] for r in job["ranks"])


def test_restore_places_machine_rows(job):
    assert all(r["checks"]["restore_row"] for r in job["ranks"])


def test_launch_cli_report(job):
    """python -m repro_torch.launch --devices 2 --device cpu: a gloo mesh
    fit whose per-round wire bytes sum to its total."""
    rep = job["cli"]
    assert rep["backend"] == "mesh" and rep["m"] == rep["processes"] == 2
    assert rep["process_group"] == "gloo" and "over gloo" in job["cli_err"]
    assert sum(rep["wire_bytes"]) + sum(rep["wire_meta_bytes"]) == \
        rep["wire_bytes_total"]
    assert rep["omega_mk_bytes"] == 2 * 4 * 8 * 4
    assert len(rep["wire_bytes"]) == rep["rounds"] + 1
    assert np.isfinite(rep["cost"])


def test_mesh_fit_beside_the_jax_reference(job):
    """The mesh fit's outcomes beside the reference's virtual fit on the
    same numpy data: the same rounds, the n_hist law (N at each round's
    start falls, the last at most eta) and the cost within 10% (the
    random streams differ)."""
    ref = job["reference"]
    mesh, _ = _pair(job, "soccer")
    eta = FITS["soccer"]["eta_override"]
    assert mesh["rounds"] == ref["rounds"]
    n_hist = mesh["n_hist"]
    assert n_hist[0] == 4800 == ref["n_hist"][0]
    assert all(b < a for a, b in zip(n_hist, n_hist[1:]))
    assert n_hist[-1] <= eta and ref["n_hist"][-1] <= eta
    assert mesh["cost"] <= 1.1 * ref["cost"]


def test_without_a_group_mesh_raises_and_auto_stays_virtual():
    from repro_torch.api import fit
    from repro_torch.api.backends import resolve_backend
    x = _data()[:400]
    with pytest.raises(ValueError, match="world size m=4"):
        fit(x, 3, m=4, backend="mesh", device="cpu")
    assert fit(x, 3, m=4, backend="auto", device="cpu").backend == "virtual"
    assert resolve_backend("auto", 4).name == "virtual"
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("tpu", 4)


@pytest.mark.parametrize("device,ranks,cards,want", [
    ("cuda", 1, 1, "nccl"), ("cuda", 4, 4, "nccl"), ("cuda", 8, 1, "gloo"),
    ("cpu", 4, 0, "gloo"), ("cuda", 2, 0, "gloo")])
def test_process_group_rule(device, ranks, cards, want):
    from repro_torch.launch.mesh import process_group_backend
    assert process_group_backend(device, ranks, cards) == want


if __name__ == "__main__":
    from repro_torch.launch.mesh import spawn_local
    spawn_local(_job, RANKS, (sys.argv[1],), device="cpu",
                store_dir=sys.argv[1], timeout_s=JOB_TIMEOUT_S)
