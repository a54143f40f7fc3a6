"""The port's recurrent blocks (``repro_torch.models.mamba2`` and
``xlstm``) against the reference's, at the ``.reduced()`` widths of
zamba2-2.7b (Mamba2: d = 64, 8 heads of 16 × 16 state) and xlstm-125m
(mLSTM, sLSTM: d = 64, 4 heads): the reference's own initial weights with
their vectors (gate biases, ``a_log``, ``dt_bias``, skips, norm scales)
moved off their constant starts by seeded numpy noise, inputs from a
numpy seed. The full passes run chunked and sequential at S = 17, 256
and 300 (inside one ``CHUNK`` = 256 chunk, exactly one, and across two),
each against the reference in the same mode; the decode step and the
state a prefill leaves are held to the reference's and to the full pass.

Tolerance: float32 in both packages, the same expressions in other
summation orders, ~1e-6 here; ATOL = RTOL = 1e-4."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import mamba2 as jmamba
from repro.models import xlstm as jxlstm
from repro_torch.configs import get_config
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import xlstm as txlstm

# xdist runs one worker per core: with torch's default of one intra-op
# thread per core in every worker, the pools contend and small ops run
# several times slower
torch.set_num_threads(1)

ATOL = RTOL = 1e-4
B = 2
LENGTHS = (17, 256, 300)
# vector parameters moved off their constant starts by this scale of
# N(0, 1) noise
NOISE = {"a_log": 0.5, "dt_bias": 0.5, "d_skip": 0.3, "norm_scale": 0.1,
         "conv_b": 0.1, "b_i": 0.5, "b_f": 0.5, "gn_scale": 0.1, "b": 0.5}
KINDS = {
    "mamba2": ("zamba2-2.7b", jmamba.init_mamba2, tmamba.Mamba2),
    "mlstm": ("xlstm-125m", jxlstm.init_mlstm, txlstm.MLSTM),
    "slstm": ("xlstm-125m", jxlstm.init_slstm, txlstm.SLSTM),
}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@functools.lru_cache(maxsize=None)
def _block(kind):
    """One block kind: the reference's weights (numpy-perturbed), the
    port's module holding them, and its configs."""
    arch, jinit, tcls = KINDS[kind]
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    rng = np.random.default_rng(11)
    p_ref = {}
    for name, leaf in jinit(jax.random.PRNGKey(5), jcfg).items():
        leaf = np.array(leaf, np.float32)
        if name in NOISE:
            leaf = leaf + NOISE[name] * rng.standard_normal(
                leaf.shape).astype(np.float32)
        p_ref[name] = leaf
    mod = tcls(cfg, torch.Generator().manual_seed(0))
    for name, prm in mod.named_parameters():
        prm.copy_(torch.from_numpy(p_ref[name]))
    return dict(kind=kind, jcfg=jcfg, cfg=cfg,
                jp={k: jnp.asarray(v) for k, v in p_ref.items()}, mod=mod)


@pytest.fixture(params=sorted(KINDS))
def block(request):
    return _block(request.param)


def _x(cfg, s, seed=1):
    return (np.random.default_rng(seed).standard_normal(
        (B, s, cfg.d_model)) * 0.5).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jitted(jfn, static):
    """The reference's apply under ``jax.jit``, its config and its
    ``static`` flags (``sequential``, ``decode``) static: the same
    function, compiled once a shape, where an eager call traces its scans
    anew each call."""
    return jax.jit(jfn, static_argnums=1, static_argnames=static)


def _apply(block, x, **kw):
    """(reference output, port output) of the block over x."""
    jfn = {"mamba2": jmamba.mamba2_apply, "mlstm": jxlstm.mlstm_apply,
           "slstm": jxlstm.slstm_apply}[block["kind"]]
    tfn = {"mamba2": tmamba.mamba2_apply, "mlstm": txlstm.mlstm_apply,
           "slstm": txlstm.slstm_apply}[block["kind"]]
    jstate, tstate = kw.pop("jstate", None), kw.pop("tstate", None)
    static = tuple(sorted(kw))
    want = _jitted(jfn, static)(block["jp"], block["jcfg"], jnp.asarray(x),
                                state=jstate, **kw)
    got = tfn(block["mod"], block["cfg"], torch.from_numpy(x), state=tstate,
              **kw)
    return want, got


def _init_state(block, batch):
    kind, jcfg, cfg = block["kind"], block["jcfg"], block["cfg"]
    jinit, tinit = {"mamba2": (jmamba.init_ssm_state, tmamba.init_ssm_state),
                    "mlstm": (jxlstm.init_mlstm_state,
                              txlstm.init_mlstm_state),
                    "slstm": (jxlstm.init_slstm_state,
                              txlstm.init_slstm_state)}[kind]
    return jinit(jcfg, batch), tinit(cfg, batch)


def _close_state(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        _close(got[key], want[key])


@pytest.mark.parametrize("kind,mode", [
    ("mamba2", "chunked"), ("mamba2", "sequential"), ("mlstm", "chunked"),
    ("mlstm", "sequential"), ("slstm", "scan")])
@pytest.mark.parametrize("s", LENGTHS)
def test_full_pass_matches_reference(kind, mode, s):
    """The stateless full pass: output against the reference's in the
    same mode (sLSTM has one, a walk over time)."""
    kw = {} if mode == "scan" else {"sequential": mode == "sequential"}
    (want, wst), (got, gst) = _apply(_block(kind), _x(_block(kind)["cfg"], s),
                                     **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)
    assert wst is None and gst is None


@pytest.mark.parametrize("s", LENGTHS)
def test_prefill_state_matches_reference(block, s):
    """A prefill from the initial state: the state it leaves (conv tail,
    SSD state; mLSTM's (C, n, m) carry; sLSTM's (h, c, n, m)) against
    the reference's."""
    jst, tst = _init_state(block, B)
    (want, wst), (got, gst) = _apply(block, _x(block["cfg"], s, seed=2),
                                     jstate=jst, tstate=tst)
    _close(got, want)
    _close_state(gst, wst)


def test_decode_steps_match_full_pass(block):
    """A prefill of 40 tokens, then 4 decode steps: each step's output
    against the reference's step and against the port's full pass over
    all 44 tokens (sequential, the oracle; chunked agrees with it)."""
    cfg = block["cfg"]
    x = _x(cfg, 44, seed=3)
    seq = {} if block["kind"] == "slstm" else {"sequential": True}
    (_, _), (full, _) = _apply(block, x, **seq)
    jst, tst = _init_state(block, B)
    (_, jst), (_, tst) = _apply(block, x[:, :40], jstate=jst, tstate=tst)
    for i in range(40, 44):
        (want, jst), (got, tst) = _apply(block, x[:, i:i + 1], jstate=jst,
                                         tstate=tst, decode=True)
        _close(got, want)
        _close(got[:, 0], full[:, i])
        _close_state(tst, jst)


def test_chunked_equals_sequential():
    """The port's two Mamba2 and mLSTM passes agree with each other at a
    length across two chunks (the reference's own claim,
    tests/test_sequence_models.py, at its tolerances)."""
    cfg = get_config("zamba2-2.7b").reduced()
    x = torch.from_numpy(_x(cfg, 300, seed=4))
    m = tmamba.Mamba2(cfg, torch.Generator().manual_seed(1))
    y_c, _ = tmamba.mamba2_apply(m, cfg, x)
    y_s, _ = tmamba.mamba2_apply(m, cfg, x, sequential=True)
    np.testing.assert_allclose(y_c.numpy(), y_s.numpy(), rtol=2e-4,
                               atol=2e-4)
    cfg = get_config("xlstm-125m").reduced()
    ml = txlstm.MLSTM(cfg, torch.Generator().manual_seed(1))
    y_c, _ = txlstm.mlstm_apply(ml, cfg, x)
    y_s, _ = txlstm.mlstm_apply(ml, cfg, x, sequential=True)
    np.testing.assert_allclose(y_c.numpy(), y_s.numpy(), rtol=3e-4,
                               atol=3e-4)


def test_ssd_upper_triangle_overflow_stays_out():
    """With strong decay the intra-chunk ``exp`` overflows to inf above
    the diagonal; the ``where`` after it keeps that out, as the
    reference's ``jnp.where`` does: finite outputs equal to the
    sequential oracle's."""
    rng = np.random.default_rng(6)
    b, s, h, p, n = 1, 64, 2, 4, 3
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(
        np.float32))
    bi = torch.from_numpy(rng.standard_normal((b, s, n)).astype(np.float32))
    ci = torch.from_numpy(rng.standard_normal((b, s, n)).astype(np.float32))
    log_a = torch.full((b, s, h), -5.0)       # cums reach -320: exp(+320)
    dt = torch.full((b, s, h), 0.5)
    h0 = torch.zeros((b, h, p, n))
    y_c, h_c = tmamba._ssd_chunked(x, bi, ci, log_a, dt, h0)
    y_s, h_s = tmamba._ssd_sequential(x, bi, ci, log_a, dt, h0)
    assert torch.isfinite(y_c).all() and torch.isfinite(h_c).all()
    _close(y_c, y_s)
    _close(h_c, h_s)
