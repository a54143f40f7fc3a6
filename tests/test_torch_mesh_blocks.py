"""The mesh train driver's per-block gathers and sharded update, on the
CPU.

``launch/train.py::MeshTrainer`` stores each rank's shards and gathers a
block's parameters whole only around its use (``sharding.activations.
whole`` in ``models/model.py``'s loops); the backward sums each block's
gradients over the batch ranks into the shards, and the optimizer runs
on the shards (``train/optimizer.py::apply_updates``' ``shards``).

One module fixture runs ``python tests/test_torch_mesh_blocks.py OUT N``
for N = 2 and 4 gloo ranks side by side (``launch.mesh.spawn_local``,
one intra-op thread a rank). Each rank steps every case: the "fsdp"
policy (qwen2-1.5b reduced: batch and storage over every axis) and the
"2d" policy (mixtral-8x22b reduced: heads, ``d_ff`` and expert ``d_ff``
over "model", its 4 experts kept local over the data ranks), AdamW and
Adafactor (``adafactor_min_dim`` 8, so the reduced leaves factor and
their row and column means cross split dims), remat none, selective
and full, plus microbatches 2 on the "fsdp" arch; 2 ranks as (2, 1) for
"fsdp" and (1, 2) for "2d", 4 ranks as (2, 2). Each case is held to one
process's ``make_train_step`` on the same global batches by
``PERF.md`` §2's float32 gates (nll rel ≤ 1e-4, grad norm rel ≤ 1e-5:
the sums over ranks change the summation order only).

The fake 16 × 16 mesh (``launch/mesh.py::make_production_mesh``) runs
qwen2-1.5b at full width and 2 layers under ``FakeTensorMode`` and
``MemTracker``: the step's peak lies below the whole parameters,
gradients and moments that a whole-model gather holds, and no gathered
leaf is alive
when the next block gathers.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JOB_TIMEOUT_S = 300
NLL_REL, GNORM_REL = 1e-4, 1e-5
STEPS, BATCH, SEQ = 2, 8, 16
ARCHS = {"fsdp": "qwen2-1.5b", "2d": "mixtral-8x22b"}
MESHES = {2: {"fsdp": (2, 1), "2d": (1, 2)}, 4: {"fsdp": (2, 2),
                                                 "2d": (2, 2)}}
CASES = [(pol, opt, remat, 1) for pol in ARCHS
         for opt in ("adamw", "adafactor")
         for remat in ("none", "selective", "full")] + \
    [("fsdp", "adamw", "full", 2)]


def _case_id(case):
    pol, opt, remat, mb = case
    return f"{pol}-{opt}-{remat}-mb{mb}"


def _cfg(case):
    from repro_torch.configs import get_config
    pol, opt, remat, mb = case
    return dataclasses.replace(get_config(ARCHS[pol]).reduced(),
                               optimizer=opt, remat=remat, microbatches=mb)


def _opt(cfg):
    from repro_torch.train.optimizer import OptConfig
    return OptConfig(name=cfg.optimizer, lr_peak=3e-3, warmup_steps=1,
                     decay_steps=STEPS, adafactor_min_dim=8)


def _batches(cfg):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        t = rng.integers(0, cfg.vocab_size, size=(BATCH, SEQ + 1),
                         dtype=np.int32)
        out.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    return out


def _rank(rank: int, out_dir: str, world: int) -> None:
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import make_test_mesh
    res = {}
    for case in CASES:
        cfg = _cfg(case)
        mesh = make_test_mesh(*MESHES[world][case[0]])
        trainer = lt.MeshTrainer(cfg, mesh, _opt(cfg), device="cpu")
        rows = lt.local_rows(mesh, trainer.part, BATCH)
        metrics = []
        for b in _batches(cfg):
            m = trainer.step({k: torch.from_numpy(v[rows])
                              for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        res[_case_id(case)] = metrics
    res["route"] = trainer.scatter_route
    res["routes"] = dict(lt.SCATTER_ROUTES)
    if rank == 0:
        with open(os.path.join(out_dir, f"world{world}.json"), "w") as f:
            json.dump(res, f)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_blocks")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {w: subprocess.Popen([sys.executable, __file__, str(out), str(w)],
                                 env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for w in MESHES}
    try:
        errs = {w: p.communicate(timeout=JOB_TIMEOUT_S)[1]
                for w, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    for w, p in procs.items():
        assert p.returncode == 0, errs[w][-3000:]
    return {w: json.loads((out / f"world{w}.json").read_text())
            for w in MESHES}


@pytest.fixture(scope="module")
def one_process():
    """Each case's metrics from ``make_train_step`` in one process."""
    from repro_torch.train.train_step import make_train_state, \
        make_train_step
    res = {}
    for case in CASES:
        cfg = _cfg(case)
        state = make_train_state(cfg, _opt(cfg), device="cpu")
        step = make_train_step(cfg, _opt(cfg))
        metrics = []
        for b in _batches(cfg):
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        res[_case_id(case)] = metrics
    return res


@pytest.mark.parametrize("case", CASES, ids=_case_id)
@pytest.mark.parametrize("world", sorted(MESHES))
def test_per_block_step_matches_one_process(jobs, one_process, world, case):
    """Each step's loss and nll within NLL_REL and its grad norm within
    GNORM_REL of one process's."""
    got, want = jobs[world][_case_id(case)], one_process[_case_id(case)]
    assert len(got) == STEPS
    for g, w in zip(got, want):
        for k, tol in (("loss", NLL_REL), ("nll", NLL_REL),
                       ("grad_norm", GNORM_REL)):
            assert abs(g[k] - w[k]) <= tol * abs(w[k]), (k, g[k], w[k])


@pytest.mark.parametrize("world", sorted(MESHES))
def test_gradient_sums_take_the_stated_route(jobs, world):
    """The installed gloo's route for the leaves split over the batch
    axes alone is the one the trainer probed, and it ran."""
    res = jobs[world]
    assert res["route"] in ("reduce_scatter", "all_reduce")
    assert res["routes"].get(res["route"], 0) > 0


def _fake_trainer(mesh):
    """qwen2-1.5b at full width and 2 layers, remat full, on the fake
    16 × 16 ``mesh``, with its batch of one row a rank."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import MeshTrainer, local_rows
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2,
                              remat="full")
    trainer = MeshTrainer(cfg, mesh, device="cpu")
    rows = local_rows(mesh, trainer.part, 256)
    n = len(range(*rows.indices(256)))
    batch = {k: torch.zeros((n, 32), dtype=torch.int32)
             for k in ("tokens", "targets")}
    return trainer, batch


def test_per_block_peak_and_no_leaf_whole_outside_its_block(monkeypatch):
    """Under ``MemTracker`` the step's peak is below the bytes of the
    whole parameters, their float32 gradients and moments (what a step
    that gathers the whole model, its gradients and its optimizer state
    holds at its update), and each time a block
    gathers, no tensor an earlier gather made is alive."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import make_production_mesh
    gathered, live_at_gather = [], []
    apply = lt._Whole.apply

    def recording(trainer, names, *shards):
        live_at_gather.append(sum(r() is not None for r in gathered))
        outs = apply(trainer, names, *shards)
        gathered.extend(weakref.ref(t) for t in outs)
        return outs

    try:
        mesh = make_production_mesh()
        with FakeTensorMode(allow_non_fake_inputs=True):
            trainer, batch = _fake_trainer(mesh)
            # the whole parameters, their float32 gradients and moments
            whole = sum(math.prod(trainer.shape(n)) *
                        (t.element_size() + 4)
                        for n, t in trainer.params.items()) + \
                sum(math.prod(trainer.shape(k)) * t.element_size()
                    for k, t in trainer.opt_state.items())
            monkeypatch.setattr(lt._Whole, "apply", recording)
            tracker = MemTracker()
            tracker.track_external(*trainer.params.values(),
                                   *trainer.opt_state.values())
            with tracker:
                trainer.step(batch)
            peak = max(int(v.get("Total", 0)) for v in
                       tracker.get_tracker_snapshot("peak").values())
    finally:
        dist.destroy_process_group()
    # embed, 2 blocks, the final norm with the tied head; the backward's
    # recompute gathers the 2 blocks again
    assert len(live_at_gather) == 6
    assert live_at_gather == [0] * 6
    assert 0 < peak < whole


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import spawn_local
    spawn_local(_rank, int(sys.argv[2]), (sys.argv[1], int(sys.argv[2])),
                device="cpu", timeout_s=JOB_TIMEOUT_S)
