"""The LM on a device mesh, on the CPU: ``models/moe_sharded.py`` and the
mesh train driver (``launch/train.py``) on gloo ranks.

One module fixture runs ``python tests/test_torch_mesh_lm.py OUT``: 8
gloo ranks (``launch.mesh.spawn_local``, one intra-op thread each) on a
4 × 2 ("data", "model") mesh. Each rank runs:

* ``moe_apply_sharded`` in the reference's two cases
  (``tests/test_moe_sharded.py``): experts moved (E = 8 over n_data = 4)
  and tokens kept (E = 2 < n_data), "model" = 2, on its rows of one
  batch, at a drop-free capacity factor (8), the configs' published one
  (1.25) and one at which both cases drop (0.5); gradients of
  ``sum(out²) + aux``, each rank's objective taking ``aux / n_data``,
  summed over the data ranks (the mesh train driver's convention,
  ``sharding/activations.py``);
* the mesh trainer (``MeshTrainer``) on the reduced mistral-nemo-12b
  (heads and ``d_ff`` split over "model") and mixtral-8x22b (4 experts
  over 4 data ranks), 3 steps;
* the mesh train driver's CLI (``launch.train.main``, which runs on the
  group it finds running) twice, as the reference's
  ``tests/test_launch_train.py`` runs it: 10 steps with a checkpoint
  every 5, then a restart to 15; rank 0 keeps what it printed. The same
  two runs through ``launch.train.train`` give each step's metrics.

Beside it, a JAX process with 8 host devices runs the reference's
``moe_apply_sharded`` on the same numpy weights and batch on the same
4 × 2 mesh, and each source's kept slots under the reference's
per-source capacity. The sharded MoE is held to it at every factor, the
dropping ones included, and to ``_moe_apply_dense`` at the drop-free
one. The tests hold the trainers to one process: the same global
batches through ``train/train_step.py::make_train_step``, whose losses
the mesh's equal to float32 summation order (rel 1e-5; the averaged
gradients sum the rows in another order). ``python -m
repro_torch.launch.train`` itself, which starts its own ranks, runs in
``tests/test_torch_imports.py`` (``--help``) and on the card.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MESH = (4, 2)
JOB_TIMEOUT_S = 300
LOSS_REL = 1e-5
TRAIN_2D = ("mistral-nemo-12b", "mixtral-8x22b")
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 3, 8, 16


MOE_CASES = (("ep", 8), ("local", 2))
MOE_FACTORS = (8.0, 1.25, 0.5)
DROP_FREE = 8.0
MOE_BATCH, MOE_SEQ = 8, 4


def _moe_cfg(e):
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(name="t", family="moe", d_model=32, n_heads=4,
                      n_kv_heads=4, d_ff=64, vocab_size=64, n_experts=e,
                      experts_per_token=2, d_ff_expert=48,
                      n_shared_experts=1, moe_capacity_factor=DROP_FREE,
                      param_dtype="float32", compute_dtype="float32")


def _moe_arrays(e):
    """The layer's weights (named as the port's parameters, dotted as
    the reference's dict nests them) and the (B, S, d) batch, from a
    seed."""
    from repro_torch.models import moe
    rng = np.random.default_rng(e)
    shapes = {n: tuple(t.shape) for n, t in
              moe.MoE(_moe_cfg(e), torch.Generator()).named_parameters()}
    out = {n: (rng.standard_normal(sh) / math.sqrt(sh[-2])).astype(
        np.float32) for n, sh in shapes.items()}
    out["x"] = (rng.standard_normal((MOE_BATCH, MOE_SEQ, 32)) * 0.5
                ).astype(np.float32)
    return out


def _moe_inputs(e, arrays):
    """The port's layer holding ``arrays``, with gradients, and x."""
    from repro_torch.models import moe
    cfg = _moe_cfg(e)
    p = moe.MoE(cfg, torch.Generator())
    with torch.no_grad():
        for n, prm in p.named_parameters():
            prm.copy_(torch.from_numpy(arrays[n]))
    p.requires_grad_(True)
    return cfg, p, torch.from_numpy(arrays["x"])


def _moe_npz(path):
    """Every case's arrays in one file, keys "<case>/<name>"."""
    np.savez(path, **{f"{case}/{n}": a for case, e in MOE_CASES
                      for n, a in _moe_arrays(e).items()})


def _moe_case(npz, case):
    return {k.split("/", 1)[1]: npz[k] for k in npz.files
            if k.startswith(case + "/")}


# The reference on the same arrays: python -c _REFERENCE IN.npz OUT.npz
_REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs.base import ArchConfig
from repro.launch.mesh import make_mesh_compat
from repro.models import moe, moe_sharded
from repro.sharding.activations import activation_mesh

CASES, FACTORS, MESH = %r, %r, %r
inp, res = np.load(sys.argv[1]), {}
mesh = make_mesh_compat(MESH, ("data", "model"))
for case, e in CASES:
    cfg = ArchConfig(name="t", family="moe", d_model=32, n_heads=4,
                     n_kv_heads=4, d_ff=64, vocab_size=64, n_experts=e,
                     experts_per_token=2, d_ff_expert=48,
                     n_shared_experts=1, moe_capacity_factor=8.0,
                     param_dtype="float32", compute_dtype="float32")
    a = {k.split("/", 1)[1]: jnp.asarray(inp[k]) for k in inp.files
         if k.startswith(case + "/")}
    x = a.pop("x")
    p = {"router": a["router"], "wi_gate": a["wi_gate"],
         "wi_up": a["wi_up"], "wo": a["wo"],
         "shared": {n: a["shared." + n] for n in ("wi_gate", "wi_up", "wo")}}
    b, s, d = x.shape
    rows, t_slice = b // MESH[0], b // MESH[0] * s // MESH[1]
    for cf in FACTORS:
        key = f"{case}/{cf}"

        def f(p, x):
            out, aux = moe.moe_apply(p, cfg, x, capacity_factor=cf)
            return jnp.sum(out ** 2) + aux

        with mesh, activation_mesh(mesh):
            out, aux = jax.jit(lambda p, x: moe.moe_apply(
                p, cfg, x, capacity_factor=cf))(p, x)
            g = jax.jit(jax.grad(f))(p, x)
        res[key + "/out"], res[key + "/aux"] = np.asarray(out), float(aux)
        for n in ("router", "wi_gate", "wi_up", "wo"):
            res[f"{key}/grad/{n}"] = np.asarray(g[n])
        for n in ("wi_gate", "wi_up", "wo"):
            res[f"{key}/grad/shared.{n}"] = np.asarray(g["shared"][n])
        # each source's (data rank, model rank) kept slots, as local_fn
        # groups its token slice
        cap = max(int(cf * t_slice * cfg.experts_per_token / e), 1)
        kept = []
        for di in range(MESH[0]):
            xf_all = x[di * rows:(di + 1) * rows].reshape(rows * s, d)
            for mi in range(MESH[1]):
                xf = xf_all[mi * t_slice:(mi + 1) * t_slice]
                _, eidx, _, _ = moe_sharded._route(p, cfg, xf)
                _, dest = moe_sharded._group(xf, eidx, e, cap,
                                             cfg.experts_per_token)
                kept.append(np.asarray(dest) < e * cap)
        res[key + "/kept"] = np.stack(kept)
np.savez(sys.argv[2], **res)
""" % (MOE_CASES, MOE_FACTORS, MESH)


def _train_batches(cfg, steps):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab_size,
                            size=(TRAIN_BATCH, TRAIN_SEQ + 1),
                            dtype=np.int32)
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    return out


def _train_opt(cfg, steps):
    from repro_torch.train.optimizer import OptConfig
    return OptConfig(name=cfg.optimizer, lr_peak=3e-3, warmup_steps=2,
                     decay_steps=steps)


def _rank(rank: int, out_dir: str) -> None:
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import MeshTrainer, local_rows
    from repro_torch.models import moe
    from repro_torch.sharding.activations import activation_mesh
    mesh = make_test_mesh(*MESH)
    d_idx, n_data = mesh.get_local_rank("data"), MESH[0]
    res = {"moe": {}, "train": {}}
    npz = np.load(os.path.join(out_dir, "moe_inputs.npz"))
    for case, e in MOE_CASES:
        cfg, p, x = _moe_inputs(e, _moe_case(npz, case))
        rows = slice(d_idx * 2, (d_idx + 1) * 2)
        for cf in MOE_FACTORS:
            with activation_mesh(mesh):
                out, aux = moe.moe_apply(p, cfg, x[rows], capacity_factor=cf)
                grads = torch.autograd.grad(
                    (out ** 2).sum() + aux / n_data, list(p.parameters()))
            grads = [g.clone() for g in grads]
            for g in grads:
                dist.all_reduce(g, group=mesh.get_group("data"))
            res["moe"][f"{case}/{cf}"] = {
                "out": out.detach().tolist(), "aux": float(aux),
                "grads": {n: g.tolist() for (n, _), g in
                          zip(p.named_parameters(), grads)}}
    for arch in TRAIN_2D:
        cfg = get_config(arch).reduced()
        trainer = MeshTrainer(cfg, mesh, _train_opt(cfg, TRAIN_STEPS),
                              device="cpu")
        rows = local_rows(mesh, trainer.part, TRAIN_BATCH)
        losses = []
        for b in _train_batches(cfg, TRAIN_STEPS):
            m = trainer.step({k: torch.from_numpy(v[rows])
                              for k, v in b.items()})
            losses.append({k: float(v) for k, v in m.items()})
        res["train"][arch] = {"metrics": losses,
                              "shard_elems": sum(t.numel() for t in
                                                 trainer.params.values())}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    _cli(rank, out_dir)


def _cli(rank: int, out_dir: str) -> None:
    """The CLI twice on the running group, rank 0's stdout to files;
    then the same two runs through ``train``, rank 0 keeping each
    step's metrics."""
    import contextlib
    import io
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    run = ["--arch", "qwen2-1.5b", "--steps", "10", "--mesh",
           ",".join(map(str, MESH)), "--batch", "8", "--ckpt-every", "5",
           "--ckpt-dir", os.path.join(out_dir, "ck"), "--device", "cpu"]
    for name, steps in (("first", "10"), ("second", "15")):
        run[run.index("--steps") + 1] = steps
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train.main(run)
        if rank == 0:
            with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
                f.write(f"rc={rc}\n" + buf.getvalue())
    cfg, metrics = get_config("qwen2-1.5b").reduced(), []
    for steps in (10, 15):
        metrics += train.train(
            cfg, steps=steps, batch=8, seq=64,
            mesh_shape=",".join(map(str, MESH)), ckpt_every=5,
            ckpt_dir=os.path.join(out_dir, "ck_metrics"), device="cpu",
            log=lambda s: None)
    if rank == 0:
        with open(os.path.join(out_dir, "driver_metrics.json"), "w") as f:
            json.dump(metrics, f)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The gloo ranks and, beside them, the reference's process."""
    out = tmp_path_factory.mktemp("mesh_lm")
    _moe_npz(out / "moe_inputs.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(out / "moe_inputs.npz"),
         str(out / "moe_reference.npz")],
        env=dict(env, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ranks = subprocess.run([sys.executable, __file__, str(out)],
                               env=env, capture_output=True, text=True,
                               timeout=JOB_TIMEOUT_S)
        _, ref_err = ref.communicate(timeout=JOB_TIMEOUT_S)
    finally:
        ref.kill()
    assert ranks.returncode == 0, ranks.stderr[-3000:]
    assert ref.returncode == 0, ref_err[-3000:]
    return {"out": out, "ck": out / "ck",
            "first": (out / "first.txt").read_text(),
            "second": (out / "second.txt").read_text(),
            "metrics": json.loads(
                (out / "driver_metrics.json").read_text()),
            "inputs": np.load(out / "moe_inputs.npz"),
            "reference": np.load(out / "moe_reference.npz"),
            "ranks": [json.loads((out / f"rank{r}.json").read_text())
                      for r in range(math.prod(MESH))]}


def _rank_rows(r):
    """Rank ``r``'s rows of the MoE batch (its data rank's)."""
    d_idx = r // MESH[1]
    rows = MOE_BATCH // MESH[0]
    return slice(d_idx * rows, (d_idx + 1) * rows)


def _assert_grads(got, want):
    for n, g_want in want.items():
        g_got = torch.tensor(got[n])
        assert torch.isfinite(g_got).all(), n
        scale = float(g_want.abs().max())
        assert float((g_got - g_want).abs().max()) <= 1e-4 * scale, n


@pytest.mark.parametrize("case", [c for c, _ in MOE_CASES])
def test_sharded_moe_matches_dense(job, case):
    from repro_torch.models import moe
    e = dict(MOE_CASES)[case]
    cfg, p, x = _moe_inputs(e, _moe_case(job["inputs"], case))
    want, aux = moe._moe_apply_dense(p, cfg, x, DROP_FREE)
    grads = torch.autograd.grad((want ** 2).sum() + aux,
                                list(p.parameters()))
    grads = {n: g for (n, _), g in zip(p.named_parameters(), grads)}
    for r, res in enumerate(job["ranks"]):
        got = res["moe"][f"{case}/{DROP_FREE}"]
        rows = want[_rank_rows(r)].detach()
        assert float((torch.tensor(got["out"]) - rows).abs().max()) <= 1e-4
        assert abs(got["aux"] - float(aux.detach())) <= 1e-5
        _assert_grads(got["grads"], grads)


@pytest.mark.parametrize("cf", MOE_FACTORS)
@pytest.mark.parametrize("case", [c for c, _ in MOE_CASES])
def test_sharded_moe_matches_reference(job, case, cf):
    """Each rank's rows, aux and (data-summed) gradients against the
    reference's ``moe_apply_sharded`` on the same 4 × 2 mesh, at the
    factors that drop as well as the drop-free one."""
    ref = job["reference"]
    key = f"{case}/{cf}"
    want = torch.from_numpy(ref[key + "/out"])
    grads = {k.rsplit("/", 1)[1]: torch.from_numpy(ref[k])
             for k in ref.files if k.startswith(key + "/grad/")}
    assert len(grads) == 7
    for r, res in enumerate(job["ranks"]):
        got = res["moe"][key]
        assert float((torch.tensor(got["out"]) -
                      want[_rank_rows(r)]).abs().max()) <= 1e-4
        assert abs(got["aux"] - float(ref[key + "/aux"])) <= 1e-5
        _assert_grads(got["grads"], grads)


@pytest.mark.parametrize("cf", MOE_FACTORS)
@pytest.mark.parametrize("case", [c for c, _ in MOE_CASES])
def test_sharded_moe_drops_the_reference_slots(job, case, cf):
    """Per source (data rank, model rank), the port's routing and
    dispatch over its token slice at the slice's capacity keep the
    slots the reference's ``local_fn`` keeps; nothing drops at the
    drop-free factor, and the smallest factor drops in both cases."""
    from repro_torch.models import moe
    e = dict(MOE_CASES)[case]
    cfg, p, x = _moe_inputs(e, _moe_case(job["inputs"], case))
    rows = MOE_BATCH // MESH[0]
    t_slice = rows * MOE_SEQ // MESH[1]
    cap = moe.capacity(cfg, t_slice, cf)
    kept = []
    with torch.no_grad():
        for di in range(MESH[0]):
            xf_all = x[di * rows:(di + 1) * rows].reshape(rows * MOE_SEQ, -1)
            for mi in range(MESH[1]):
                xf = xf_all[mi * t_slice:(mi + 1) * t_slice]
                _, _, eidx = moe.route(p, cfg, xf)
                _, dest = moe.group_tokens(xf, eidx, e, cap)
                kept.append((dest < e * cap).numpy())
    want = job["reference"][f"{case}/{cf}/kept"]
    np.testing.assert_array_equal(np.stack(kept), want)
    if cf == DROP_FREE:
        assert want.all()
    if cf == min(MOE_FACTORS):
        assert not want.all()


def _single_process(arch, batches, steps, opt_steps=None):
    from repro_torch.configs import get_config
    from repro_torch.train.train_step import make_train_state, \
        make_train_step
    cfg = get_config(arch).reduced()
    opt = _train_opt(cfg, opt_steps or steps)
    state = make_train_state(cfg, opt, device="cpu")
    step = make_train_step(cfg, opt)
    out = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        out.append({k: float(v) for k, v in m.items()})
    return out


def _close(got, want, keys=("loss", "nll", "aux", "grad_norm")):
    for k in keys:
        assert abs(got[k] - want[k]) <= LOSS_REL * max(1.0, abs(want[k])), \
            (k, got[k], want[k])


@pytest.mark.parametrize("arch", TRAIN_2D)
def test_mesh_trainer_2d_matches_one_process(job, arch):
    """Heads, d_ff and experts split over the mesh; the same losses as
    one process, and each rank stores less than the whole model."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    want = _single_process(arch, _train_batches(cfg, TRAIN_STEPS),
                           TRAIN_STEPS)
    from repro_torch.launch.input_specs import param_structs
    whole = sum(p.numel() for p in param_structs(cfg).values())
    for res in job["ranks"]:
        got = res["train"][arch]
        for g, w in zip(got["metrics"], want):
            _close(g, w)
        assert got["shard_elems"] < whole


def test_mesh_train_driver_runs_and_checkpoints(job):
    """The reference's test_launch_train: lines and manifests."""
    first, second, ck = job["first"], job["second"], job["ck"]
    assert first.startswith("rc=0\n"), first
    assert "step   10" in first
    assert (ck / "step-10" / "manifest.json").exists()
    assert second.startswith("rc=0\n"), second
    assert "resumed from step 10" in second
    assert (ck / "step-15" / "manifest.json").exists()


def test_mesh_train_driver_losses_match_one_process(job):
    """Steps 1-15 through ``train`` against one process on the same
    global batches; the restart draws its batches from the start again,
    as the reference's driver does, from the restored step-10 state."""
    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import make_train_state, \
        make_train_step
    lines = job["metrics"]
    assert len(lines) == 15
    cfg = get_config("qwen2-1.5b").reduced()
    rng = np.random.default_rng(0)

    def batches(n):
        out = []
        for _ in range(n):
            t = rng.integers(0, cfg.vocab_size, size=(8, 65), dtype=np.int32)
            out.append({"tokens": torch.from_numpy(t[:, :-1]),
                        "targets": torch.from_numpy(t[:, 1:])})
        return out

    def run(steps, bs, state=None):
        opt = OptConfig(name=cfg.optimizer, lr_peak=3e-3, warmup_steps=10,
                        decay_steps=steps)
        state = state or make_train_state(cfg, opt, device="cpu")
        step = make_train_step(cfg, opt)
        out = []
        for b in bs:
            state, m = step(state, b)
            out.append({k: float(v) for k, v in m.items()})
        return state, out

    first = batches(10)
    state, want = run(10, first)
    rng = np.random.default_rng(0)
    _, want2 = run(15, batches(5), state)
    for g, w in zip(lines, want + want2):
        _close(g, w, ("loss", "nll", "grad_norm"))


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import spawn_local
    spawn_local(_rank, math.prod(MESH), (sys.argv[1],), device="cpu",
                timeout_s=JOB_TIMEOUT_S)
