"""The port's train step (``repro_torch.train``) against the JAX package's
(``repro.train``), at the ``.reduced()`` configs of all ten
architectures, in float32: a train state in the layout of each arch's
reference ``make_train_state``, with random weights, is carried across by
``convert.train_state_from_reference``, then both packages take the
same three steps on the same numpy batches. ``_DENSE_MAX_KV`` and
``_FLASH_CHUNK`` are 4 in both packages, so every attention (self and
cross) runs the chunked path and its custom backward, over 4-key chunks.

The learning rate is 0 at step 0 (``schedule``'s warm-up), so the first
step moves no parameter: its moments are compared, and the parameters
after the third.

Tolerances. Metrics (``loss``, ``nll``, ``aux``, ``grad_norm``, ...):
rel 1e-5; both packages sum the same float32 expressions in other
orders (~1e-7 measured). Moments after step 1: rtol 1e-4 with atol 1e-4
of the parameter's largest moment (a small gradient summed with
cancellation, e.g. whisper's cross-attention norm bias, carries ~2e-5
of its parameter's largest in rounding). Parameters after the last
step: atol 2e-6 (an update is lr = 5e-4-1e-3 a step) at every element
whose final AdamW moments agree across the packages (m to 2e-4, v to
4e-4 relative, so m̂/√v̂ to ~4e-4: 2 updates part by < 1e-6). Where
they do not, the gradient is at the level of its
own rounding (a gradient near 0, e.g. components of the key bias under
RoPE), and AdamW's m̂/(√v̂ + ε) turns rounding of either sign into a
full ±lr step in each package: there the two may part by at most
2·Σlr, the most two AdamW walks can part, and such elements must stay
under 2% of the parameters (measured: xlstm-125m 0.84%, the other
AdamW archs 0.29-0.37%); no tolerance is widened elsewhere.
Adafactor (mixtral, kimi) scales a gradient by its row and column
averages, not its own size, and is compared at every element at 2e-6.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.models import attention as tattn
from repro_torch.models.convert import (flat_arrays,
                                        train_state_from_reference)
from repro_torch.models.model import reference_leaf_path
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

torch.set_num_threads(1)

STEPS, B, S = 3, 2, 16
OPT = dict(lr_peak=1e-3, warmup_steps=2, decay_steps=10)
METRIC_REL = 1e-5
PARAM_ATOL = 2e-6


def _batches(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        d = {"tokens": t[:, :-1], "targets": t[:, 1:]}
        if cfg.n_frontend_tokens:
            d["frontend"] = (rng.standard_normal(
                (B, cfg.n_frontend_tokens, cfg.d_model)) * 0.1
            ).astype(np.float32)
        out.append(d)
    return out


def _np_tree(tree):
    """Flattened copies (the port updates its state in place)."""
    return {k: np.array(v) for k, v in
            flat_arrays(jax.tree.map(np.asarray, tree)).items()}


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


@contextlib.contextmanager
def _flash_everywhere():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jattn, tattn):
            mp.setattr(mod, "_DENSE_MAX_KV", 4)
            mp.setattr(mod, "_FLASH_CHUNK", 4)
        yield


def _reference_state(jcfg, jo, seed):
    """A train state in the layout of the reference's ``make_train_state``
    (``jax.eval_shape`` of it: tracing, no compile), its params drawn
    from a numpy seed (scales 1 + 0.1·N, everything else 0.1·N, so no
    bias is 0), its moments 0 and its step 0."""
    shapes = jax.eval_shape(functools.partial(
        jts.make_train_state, cfg=jcfg, opt=jo), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return jnp.asarray(1.0 + 0.1 * z)
        return jnp.asarray(0.1 * z)

    return {"params": jax.tree_util.tree_map_with_path(draw,
                                                       shapes["params"]),
            "opt": jax.tree.map(lambda l: jnp.zeros(l.shape, l.dtype),
                                shapes["opt"]),
            "step": jnp.zeros((), jnp.int32)}


def _run_reference(jcfg, jo, state, batches):
    step = jax.jit(jts.make_train_step(jcfg, jo))
    metrics, opt1 = [], None
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append(_floats(m))
        if opt1 is None:
            opt1 = _np_tree(state["opt"])
    return metrics, opt1, _np_tree(state["params"]), _np_tree(state["opt"])


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def _port_tree(state):
    return _clone(tts.state_tree(state))


@pytest.fixture(scope="module", params=ASSIGNED_ARCHS)
def run(request, tmp_path_factory):
    """Both packages' three steps, and the port's run saved after step 1
    and resumed from the checkpoint into a fresh state."""
    name = request.param
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    jo = jopt.OptConfig(name=cfg.optimizer, **OPT)
    to = topt.OptConfig(name=cfg.optimizer, **OPT)
    batches = _batches(cfg, STEPS)
    with _flash_everywhere():
        init = _reference_state(jcfg, jo, 0)
        init_np = jax.tree.map(np.asarray, init)
        ref = _run_reference(jcfg, jo, init, batches)

        step = tts.make_train_step(cfg, to)
        state = train_state_from_reference(init_np, cfg, to, device="cpu")
        ckpt = Checkpointer(str(tmp_path_factory.mktemp(f"ck-{name}")),
                            use_async=False)
        metrics, opt1 = [], None
        for i, b in enumerate(batches):
            state, m = step(state, b)
            metrics.append(_floats(m))
            if i == 0:
                opt1 = _np_tree(state["opt"])
                ckpt.save(1, tts.state_tree(state))
        full = _port_tree(state)

        resumed = train_state_from_reference(init_np, cfg, to, device="cpu")
        resumed = tts.load_state_tree(
            resumed, ckpt.restore(tts.state_tree(resumed)))
        rmetrics = []
        for b in batches[1:]:
            resumed, m = step(resumed, b)
            rmetrics.append(_floats(m))
    lrs = [m["lr"] for m in ref[0]]
    return dict(name=name, cfg=cfg, opt=to, ref_metrics=ref[0],
                ref_opt1=ref[1], ref_params=ref[2], ref_opt=ref[3],
                metrics=metrics, opt1=opt1, state=state, full=full,
                resumed=_port_tree(resumed), rmetrics=rmetrics,
                lr_sum=sum(lrs))


def test_metrics_match_reference(run):
    assert len(run["metrics"]) == STEPS
    for i, (got, want) in enumerate(zip(run["metrics"], run["ref_metrics"])):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=METRIC_REL,
                                       atol=1e-7,
                                       err_msg=f"{run['name']} step {i} {k}")
        assert np.isfinite(got["loss"]) and np.isfinite(got["grad_norm"])
    assert run["ref_metrics"][0]["lr"] == 0.0
    assert run["ref_metrics"][-1]["lr"] > 0.0


def _moment_keys(state, name, opt):
    """(key in the port's flattened opt tree, prefix, suffix of the
    reference's) for each moment of parameter ``name``."""
    if opt.name == "adamw":
        return [(f"{k}/{name}", f"{k}/", "") for k in ("m", "v")]
    return [(f"v/{name}/{k}", "v/", f"/{k}") for k in state["opt"]["v"][name]]


def _leaf_moment(flat, cfg, name, prefix, suffix):
    keys, idx = reference_leaf_path(cfg, name)
    a = flat[prefix + "/".join(map(str, keys)) + suffix]
    return a[idx] if idx else a


def _check_moments(got, want_flat, state, cfg, opt, what):
    for name, _ in state["params"].named_parameters():
        for port_key, prefix, suffix in _moment_keys(state, name, opt):
            want = _leaf_moment(want_flat, cfg, name, prefix, suffix)
            have = got[port_key]
            assert have.shape == want.shape, port_key
            atol = 1e-4 * max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(have, want, rtol=1e-4, atol=atol,
                                       err_msg=f"{what} {port_key}")


def test_moments_after_step_one(run):
    _check_moments(run["opt1"], run["ref_opt1"], run["state"], run["cfg"],
                   run["opt"], run["name"])


def test_params_after_last_step(run):
    cfg, opt = run["cfg"], run["opt"]
    noise = 0
    for name, got in run["full"]["params"].items():
        got = got.numpy()
        want = _leaf_moment(run["ref_params"], cfg, name, "", "")
        diff = np.abs(got - want)
        if opt.name == "adamw":
            signal = np.ones(got.shape, bool)
            for k, rel in (("m", 2e-4), ("v", 4e-4)):
                ref_k = _leaf_moment(run["ref_opt"], cfg, name, f"{k}/", "")
                port_k = run["full"]["opt"][k][name].numpy()
                signal &= np.abs(port_k - ref_k) <= rel * np.abs(ref_k)
        else:
            signal = np.ones(got.shape, bool)
        np.testing.assert_array_less(
            diff[signal], PARAM_ATOL, err_msg=f"{run['name']} {name}")
        assert (diff[~signal] <= 2 * run["lr_sum"] + 1e-6).all(), name
        noise += int((~signal).sum())
    total = sum(p.numel() for p in run["full"]["params"].values())
    assert noise < 0.02 * total


def test_resume_bit_for_bit(run):
    """Saved after step 1 through the port's ``Checkpointer`` and resumed
    into a fresh state: steps 2-3 give the uninterrupted run's bits."""
    full, res = run["full"], run["resumed"]
    assert run["rmetrics"] == run["metrics"][1:]
    assert int(res["step"]) == int(full["step"]) == STEPS
    for n, t in full["params"].items():
        assert torch.equal(t, res["params"][n]), n
    a, b = flat_arrays(full["opt"]), flat_arrays(res["opt"])
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "mixtral-8x22b"])
def test_microbatches(name):
    """``cfg.microbatches`` = 2 (the batch of 2 split in 2): the reference's
    microbatched step at the tolerances above, and the port's own
    unsplit step at the reference test's nll rtol 1e-4."""
    jcfg = dataclasses.replace(jget_config(name).reduced(), microbatches=2)
    cfg = dataclasses.replace(get_config(name).reduced(), microbatches=2)
    jo = jopt.OptConfig(name=cfg.optimizer, **OPT)
    to = topt.OptConfig(name=cfg.optimizer, **OPT)
    batch = _batches(cfg, 1, seed=5)[0]
    init = _reference_state(jcfg, jo, 1)
    init_np = jax.tree.map(np.asarray, init)
    ref_m, ref_opt, _, _ = _run_reference(jcfg, jo, init, [batch])
    st2 = train_state_from_reference(init_np, cfg, to, device="cpu")
    st2, m2 = tts.make_train_step(cfg, to)(st2, batch)
    cfg1 = dataclasses.replace(cfg, microbatches=1)
    st1 = train_state_from_reference(init_np, cfg1, to, device="cpu")
    st1, m1 = tts.make_train_step(cfg1, to)(st1, batch)
    for k, want in ref_m[0].items():
        np.testing.assert_allclose(float(m2[k]), want, rtol=METRIC_REL,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(m2["nll"]), float(m1["nll"]),
                               rtol=1e-4)
    if cfg.family != "moe":   # the MoE's aux loss is a mean per call
        np.testing.assert_allclose(float(m2["grad_norm"]),
                                   float(m1["grad_norm"]), rtol=1e-4)
    _check_moments(_np_tree(st2["opt"]), ref_opt, st2, cfg, to, name)


def test_train_example_runs_and_resumes(tmp_path, capsys):
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    ck = str(tmp_path / "ck")
    args = ["--reduced", "--batch", "2", "--seq", "16", "--ckpt-every", "2",
            "--device", "cpu", "--resume", ck]
    state, m = ex.main(args + ["--steps", "4"])
    assert int(state["step"]) == 4 and np.isfinite(float(m["loss"]))
    state, m = ex.main(args + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    assert int(state["step"]) == 6 and np.isfinite(float(m["loss"]))
