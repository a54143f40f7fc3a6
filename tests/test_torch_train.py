"""The port's training pieces against the JAX package, on the CPU, with
inputs made from a numpy seed: ``train.loss.lm_loss``, ``schedule``,
``apply_updates`` (AdamW and Adafactor on stacked leaves, bf16 and
float32 parameters), the flash backward (``attention._FlashAttention``)
against ``jax.grad`` of the reference's ``attention_core(...,
force="flash")`` and against the port's own dense gradient, remat
none/selective/full, the SSD exponent's overflow, and the
``Checkpointer``'s bfloat16 leaves.

Tolerances are stated at each test."""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.models import attention as jattn
from repro.models import mamba2 as jmamba
from repro.train import loss as jloss
from repro.train import optimizer as jopt
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import model as tmodel
from repro_torch.train import loss as tloss
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_state

torch.set_num_threads(1)
MUST_SAVE = CheckpointPolicy.MUST_SAVE


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_reference(masked):
    """float32 rtol 1e-6: the same logsumexp, gather and means."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 11, 37)) * 3).astype(np.float32)
    targets = rng.integers(0, 37, (3, 11)).astype(np.int32)
    logits[1, np.arange(11), targets[1]] = 50.0   # argmax hits
    mask = (rng.random((3, 11)) < 0.6).astype(np.float32) if masked \
        else None
    jl, jm = jloss.lm_loss(jnp.asarray(logits), jnp.asarray(targets),
                           None if mask is None else jnp.asarray(mask))
    tl, tm = tloss.lm_loss(_t(logits), _t(targets),
                           None if mask is None else _t(mask))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert set(tm) == set(jm) == {"nll", "z_loss", "accuracy", "tokens"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                   err_msg=k)
    assert float(tm["accuracy"]) > 0


def test_schedule_matches_reference():
    """Steps 0-200 through warm-up, the cosine and its floor, rtol 1e-6."""
    opt = dict(lr_peak=3e-3, warmup_steps=20, decay_steps=150)
    steps = np.arange(201, dtype=np.int32)
    want = np.asarray(jopt.schedule(jopt.OptConfig(**opt),
                                    jnp.asarray(steps)))
    got = topt.schedule(topt.OptConfig(**opt), _t(steps)).numpy()
    assert got.dtype == np.float32 and want[0] == got[0] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got[-1], 0.1 * 3e-3, rtol=1e-6)


# ------------------------------------------------------------- optimizer
class _Stack(nn.Module):
    """A dense model's two leaves, ``blocks/attn/wq`` (L, 130, 129) and
    ``blocks/ln1/scale`` (L, 7), as per-layer parameters."""

    def __init__(self, cfg, wq, scale):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList()
        for w, sc in zip(wq, scale):
            blk = nn.Module()
            blk.attn, blk.ln1 = nn.Module(), nn.Module()
            blk.attn.wq = nn.Parameter(w)
            blk.ln1.scale = nn.Parameter(sc)
            self.blocks.append(blk)


def _as(a, dtype):
    return _t(a).to(dtype)


def _stack_case(dtype, seed=0):
    """Stacked params, grads and a nonzero state whose layers differ by
    orders of magnitude (so each layer's update RMS differs and the
    stack-wide clip is not the per-layer one)."""
    rng = np.random.default_rng(seed)
    lay = np.array([100.0, 1.0, 0.01], np.float32)
    shapes = {"wq": (3, 130, 129), "scale": (3, 7)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         shapes.items()}
    if dtype == torch.bfloat16:   # bf16-representable starting values
        p = {k: _as(v, dtype).float().numpy() for k, v in p.items()}
    g = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in shapes.items()}
    v2 = {k: (rng.random(s) * lay.reshape((3,) + (1,) * (len(s) - 1)) *
              1e-2).astype(np.float32) for k, s in shapes.items()}
    return p, g, v2


def _ref_tree(d):
    return {"blocks": {"attn": {"wq": d["wq"]}, "ln1": {"scale": d["scale"]}}}


def _port_state(opt_name, v2, g, model):
    names = {"wq": "attn.wq", "scale": "ln1.scale"}
    if opt_name == "adamw":
        return {"m": {f"blocks.{i}.{names[k]}": _t(0.3 * g[k][i])
                      for k in g for i in range(3)},
                "v": {f"blocks.{i}.{names[k]}": _t(v2[k][i])
                      for k in g for i in range(3)}}
    st = topt.init_opt_state(model, topt.OptConfig(name="adafactor"))
    for i in range(3):
        st["v"][f"blocks.{i}.attn.wq"] = {"vr": _t(v2["wq"][i].mean(-1)),
                                          "vc": _t(v2["wq"][i].mean(-2))}
        st["v"][f"blocks.{i}.ln1.scale"] = {"v": _t(v2["scale"][i])}
    return st


def _ref_state(opt_name, v2, g):
    if opt_name == "adamw":
        return {"m": _ref_tree({k: jnp.asarray(0.3 * a) for k, a in g.items()}),
                "v": _ref_tree({k: jnp.asarray(a) for k, a in v2.items()})}
    return {"v": _ref_tree({
        "wq": {"vr": jnp.asarray(v2["wq"].mean(-1)),
               "vc": jnp.asarray(v2["wq"].mean(-2))},
        "scale": {"v": jnp.asarray(v2["scale"])}})}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_apply_updates_on_a_stacked_leaf(opt_name, dtype):
    """Three updates (steps 5-7, lr > 0) of the (3, 130, 129) leaf
    (factored under Adafactor) and the (3, 7) leaf (not factored), with
    a clip: float32 rtol 1e-5, atol 1e-6 (the same float32 expressions);
    bf16 parameters within one bf16 ulp (the float32 results, equal to
    ~1e-7, may round to either neighbour), the float32 state as for
    float32. Adafactor's update RMS is the whole stack's: the reference
    run leaf by leaf (its per-layer RMS) must differ."""
    cfg = get_config("qwen2-1.5b").reduced()
    p, g, v2 = _stack_case(dtype)
    model = _Stack(cfg, _as(p["wq"], dtype), _as(p["scale"], dtype))
    kw = dict(name=opt_name, warmup_steps=2, decay_steps=10, clip_norm=5.0)
    jo, to = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp = _ref_tree({k: jnp.asarray(a).astype(jdt) for k, a in p.items()})
    js = _ref_state(opt_name, v2, g)
    ts = _port_state(opt_name, v2, g, model)
    jg = _ref_tree({k: jnp.asarray(a).astype(jdt) for k, a in g.items()})
    tg = {f"blocks.{i}.{n}": _as(g[k][i], dtype)
          for k, n in (("wq", "attn.wq"), ("scale", "ln1.scale"))
          for i in range(3)}
    if opt_name == "adafactor":
        assert set(ts["v"]["blocks.0.attn.wq"]) == {"vr", "vc"}
        assert set(ts["v"]["blocks.0.ln1.scale"]) == {"v"}
    for step in (5, 6, 7):
        jp, js, jm = jopt.apply_updates(jp, jg, js, jo, jnp.int32(step))
        ts, tm = topt.apply_updates(model, tg, ts, to,
                                    torch.tensor(step, dtype=torch.int32))
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5)
    assert float(jm["grad_norm"]) > kw["clip_norm"]      # clipped
    for i, blk in enumerate(model.blocks):
        for got, want in ((blk.attn.wq, jp["blocks"]["attn"]["wq"][i]),
                          (blk.ln1.scale, jp["blocks"]["ln1"]["scale"][i])):
            got = got.detach().float().numpy()
            want = np.asarray(want.astype(jnp.float32))
            if dtype == torch.float32:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            else:
                ulp = 2.0 ** -7 * np.abs(want)
                assert (np.abs(got - want) <= ulp + 1e-30).all()
    flat_t = {k: v.numpy() for k, v in _flat(ts).items()}
    flat_j = _flat(jax.tree.map(np.asarray, js))
    for key, want in flat_j.items():
        np.testing.assert_allclose(_stack_port(flat_t, key), want,
                                   rtol=1e-5, atol=1e-9, err_msg=key)
    if opt_name == "adafactor":
        # the same three updates with each layer its own leaf
        p2, _, _ = _stack_case(dtype)
        per = []
        for i in range(3):
            pl = {"w": jnp.asarray(p2["wq"][i]).astype(jdt)}
            sl = {"v": {"w": {"vr": jnp.asarray(v2["wq"][i].mean(-1)),
                              "vc": jnp.asarray(v2["wq"][i].mean(-2))}}}
            gl = {"w": jnp.asarray(g["wq"][i]).astype(jdt)}
            for step in (5, 6, 7):
                jo1 = jopt.OptConfig(**dict(kw, clip_norm=1e9))
                sc = min(1.0, kw["clip_norm"] / float(jm["grad_norm"]))
                gl1 = {"w": (gl["w"].astype(jnp.float32) * sc).astype(jdt)}
                pl, sl, _ = jopt.apply_updates(pl, gl1, sl, jo1,
                                               jnp.int32(step))
            per.append(np.asarray(pl["w"].astype(jnp.float32)))
        stacked = np.asarray(jp["blocks"]["attn"]["wq"].astype(jnp.float32))
        assert np.abs(np.stack(per) - stacked).max() > 1e-3


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _stack_port(flat_t, ref_key):
    """The port's per-layer moments of reference moment ``ref_key``
    (e.g. ``v/blocks/attn/wq/vr``), stacked."""
    parts = ref_key.split("/")
    what, leaf, sub = parts[0], parts[2:4], parts[4:]
    name = ".".join(leaf)
    return np.stack([flat_t["/".join([what, f"blocks.{i}.{name}"] + sub)]
                     for i in range(3)])


# ------------------------------------------------------------- attention
B, SQ, HD = 2, 50, 16


def _attn_inputs(h, kv, layout, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, SQ, h, HD)) * 0.3).astype(dtype)
    k = (rng.standard_normal((B, SQ, kv, HD)) * 0.3).astype(dtype)
    v = (rng.standard_normal((B, SQ, kv, HD)) * 0.3).astype(dtype)
    pos = np.broadcast_to(np.arange(SQ, dtype=np.int32), (B, SQ)).copy()
    valid = np.ones((B, SQ), bool)
    if layout in ("holes", "masked_row"):
        valid = rng.random((B, SQ)) < 0.7
        valid[:, 0] = layout == "holes"   # key 0 off: query 0 sees nothing
    return q, k, v, pos, valid


def _ref_grads(q, k, v, pos, valid, window, layout, force):
    def f(q, k, v):
        o = jattn.attention_core(
            q, k, v, q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos),
            kv_valid=jnp.asarray(valid), causal=True, window=window,
            force=force, contiguous_kv=layout == "contiguous")
        return jnp.sum(jnp.sin(3 * o.astype(jnp.float32))), o
    (loss, o), g = jax.value_and_grad(f, (0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return float(loss), np.asarray(o.astype(jnp.float32)), \
        [np.asarray(a.astype(jnp.float32)) for a in g]


def _port_grads(q, k, v, pos, valid, window, layout, force, dtype=None):
    ts = [_t(a) if dtype is None else _t(a).to(dtype) for a in (q, k, v)]
    ts = [t.requires_grad_(True) for t in ts]
    o = tattn.attention_core(*ts, q_pos=_t(pos), kv_pos=_t(pos),
                             kv_valid=_t(valid), causal=True, window=window,
                             force=force,
                             contiguous_kv=layout == "contiguous")
    loss = torch.sin(3 * o.float()).sum()
    loss.backward()
    return float(loss.detach()), o.detach().float().numpy(), \
        [t.grad.float().numpy() for t in ts]


@pytest.fixture
def chunk16(monkeypatch):
    """16-key chunks in both packages: 50 keys are 4 chunks, the last
    padded."""
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "_FLASH_CHUNK", 16)


@pytest.mark.parametrize("layout", ["positions", "contiguous", "holes"])
@pytest.mark.parametrize("gqa", [(8, 8), (8, 2)])
@pytest.mark.parametrize("window", [0, 16])
def test_flash_backward_matches_reference(window, gqa, layout, chunk16):
    """``tests/test_sequence_models.py``'s grid (window 0/16, GQA 8/8 and
    8/2), with kv positions, contiguous keys, or a ``kv_valid`` with
    holes: dq, dk, dv against ``jax.grad`` through the reference's
    custom_vjp (its ``_flash_bwd_rule``) and against the port's dense
    gradient, at that test's rtol 1e-3, atol 1e-4 (float32 both)."""
    q, k, v, pos, valid = _attn_inputs(*gqa, layout)
    rl, ro, rg = _ref_grads(q, k, v, pos, valid, window, layout, "flash")
    tl, to_, tg = _port_grads(q, k, v, pos, valid, window, layout, "flash")
    dl, do_, dg = _port_grads(q, k, v, pos, valid, window, layout, "dense")
    np.testing.assert_allclose(tl, rl, rtol=1e-5)
    np.testing.assert_allclose(to_, ro, rtol=1e-4, atol=1e-5)
    for name, a, c, d in zip("qkv", tg, rg, dg):
        np.testing.assert_allclose(a, c, rtol=1e-3, atol=1e-4,
                                   err_msg=f"d{name} vs reference")
        np.testing.assert_allclose(a, d, rtol=1e-3, atol=1e-4,
                                   err_msg=f"d{name} vs dense")


def test_flash_backward_fully_masked_row(chunk16):
    """A query that sees no key (key 0 invalid, causal): every score of
    its row is ``_NEG``, so the online softmax weighs every key slot of
    every chunk alike (exp(_NEG - _NEG) = 1), the padding's too, and its
    lse is _NEG + log(slots); the backward recomputes the same uniform
    probabilities from that lse. The port's output and gradients are
    the reference's (1e-4 / 1e-5 and 1e-3 / 1e-4), finite."""
    q, k, v, pos, valid = _attn_inputs(8, 2, "masked_row")
    _, ro, rg = _ref_grads(q, k, v, pos, valid, 0, "masked_row", "flash")
    _, to_, tg = _port_grads(q, k, v, pos, valid, 0, "masked_row", "flash")
    np.testing.assert_allclose(to_, ro, rtol=1e-4, atol=1e-5)
    for a, c in zip(tg, rg):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, c, rtol=1e-3, atol=1e-4)


def test_flash_backward_bf16_matches_reference(chunk16):
    """bfloat16 q, k, v: both packages cast p and ds to bf16 before their
    products and the gradients to bf16 at the end, so they agree to a
    bf16 rounding: within 2^-7 of each gradient's largest |value|."""
    import ml_dtypes
    q, k, v, pos, valid = _attn_inputs(8, 2, "contiguous",
                                       dtype=ml_dtypes.bfloat16)
    _, _, rg = _ref_grads(q, k, v, pos, valid, 16, "contiguous", "flash")
    args = [a.astype(np.float32) for a in (q, k, v)]
    _, _, tg = _port_grads(*args, pos, valid, 16, "contiguous", "flash",
                           dtype=torch.bfloat16)
    for a, c in zip(tg, rg):
        assert np.abs(a - c).max() <= 2.0 ** -7 * np.abs(c).max()


def test_flash_forward_unchanged_for_serving(chunk16):
    """Without grad mode the Function's forward is the serving path's:
    the same bits with and without gradients."""
    q, k, v, pos, valid = _attn_inputs(8, 2, "holes")
    args = dict(q_pos=_t(pos), kv_pos=_t(pos), kv_valid=_t(valid),
                causal=True, window=0, force="flash")
    with torch.no_grad():
        served = tattn.attention_core(_t(q), _t(k), _t(v), **args)
    trained = tattn.attention_core(_t(q).requires_grad_(True), _t(k), _t(v),
                                   **args)
    assert torch.equal(served, trained.detach())


# ----------------------------------------------------------------- remat
REMAT_CASES = (("qwen2-1.5b", False), ("qwen2-1.5b", True),
               ("llama-3.2-vision-11b", False), ("zamba2-2.7b", False),
               ("whisper-base", False), ("mixtral-8x22b", False))


@pytest.mark.parametrize("name,flash", REMAT_CASES)
def test_remat_changes_no_value(name, flash, monkeypatch):
    """none / selective / full give the same loss and every gradient bit
    for bit (a recompute repeats the forward's ops on the same inputs),
    on the dense attention path and (``flash``: 4-key chunks) through
    the flash ``Function`` inside the checkpointed layer; selective
    saves exactly the weight products: for a dense layer wq, wk, wv, wo
    and the MLP's three, 7 a layer (never attention's batched
    products)."""
    from repro_torch.train.train_step import _grads
    if flash:
        monkeypatch.setattr(tattn, "_DENSE_MAX_KV", 4)
        monkeypatch.setattr(tattn, "_FLASH_CHUNK", 4)
    cfg = get_config(name).reduced()
    state = make_train_state(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(4)
    t = rng.integers(0, cfg.vocab_size, (2, 13))
    fe = None
    if cfg.n_frontend_tokens:
        fe = _t((rng.standard_normal((2, cfg.n_frontend_tokens,
                                      cfg.d_model)) * 0.1).astype(np.float32))
    saved = collections.Counter()
    policy = tmodel._selective_policy

    def counting(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if out == MUST_SAVE and not ctx.is_recompute:
            a, b = args[-2], args[-1]
            saved["products"] += 1
            saved["bytes"] += (a.shape[:-1].numel() * b.shape[-1] *
                               a.element_size())
        return out

    monkeypatch.setattr(tmodel, "_selective_policy", counting)
    out = {}
    for mode in ("none", "selective", "full"):
        out[mode] = _grads(state["params"],
                           dataclasses.replace(cfg, remat=mode),
                           _t(t[:, :-1]), _t(t[:, 1:]), fe)
        if mode == "selective":
            n_saved, nbytes = saved["products"], saved["bytes"]
    m0, g0 = out["none"]
    for mode in ("selective", "full"):
        m, g = out[mode]
        for k in m0:
            assert torch.equal(m[k], m0[k]), (mode, k)
        for n in g0:
            assert torch.equal(g[n], g0[n]), (mode, n)
    assert saved["products"] == n_saved                # full saves none
    if cfg.family == "dense":
        # (2, 12) tokens: q and o of H·hd, k and v of KV·hd, the MLP's
        # gate and up of d_ff and its down of d, float32
        hd = cfg.resolved_head_dim
        per = (2 * cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd +
               2 * cfg.d_ff + cfg.d_model)
        assert n_saved == 7 * cfg.n_layers
        assert nbytes == cfg.n_layers * 2 * 12 * per * 4
    assert n_saved > 0


# --------------------------------------------------------- SSD overflow
def test_ssd_exponent_overflow_gradient(monkeypatch):
    """A chunk whose dt·exp(a_log) sums past ~88 (dt = 8 over 16 steps):
    the reference's exp-then-where gives a NaN gradient (0·inf, ROADMAP
    Queue 3), the port's masked exponent a finite one; the forwards
    agree (rtol 1e-5: the same float32 expressions)."""
    for mod in (jmamba, tmamba):
        monkeypatch.setattr(mod, "CHUNK", 16)
    rng = np.random.default_rng(0)
    bsz, s, h, p, n = 1, 32, 2, 4, 4
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    b_in = rng.standard_normal((bsz, s, n)).astype(np.float32)
    c_in = rng.standard_normal((bsz, s, n)).astype(np.float32)
    dt = np.full((bsz, s, h), 8.0, np.float32)
    log_a = -dt
    h0 = np.zeros((bsz, h, p, n), np.float32)
    w = rng.standard_normal((bsz, s, h, p)).astype(np.float32)

    def jf(la):
        y, _ = jmamba._ssd_chunked(jnp.asarray(x), jnp.asarray(b_in),
                                   jnp.asarray(c_in), la, jnp.asarray(dt),
                                   jnp.asarray(h0))
        return jnp.sum(y * w), y
    (_, jy), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(log_a))
    la = _t(log_a).requires_grad_(True)
    ty, _ = tmamba._ssd_chunked(_t(x), _t(b_in), _t(c_in), la, _t(dt),
                                _t(h0))
    (ty * _t(w)).sum().backward()
    assert np.isnan(np.asarray(jg)).any()
    assert torch.isfinite(la.grad).all()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ checkpoint
def test_checkpointer_bf16_leaves_both_ways(tmp_path):
    """A bfloat16 leaf goes through the port's ``Checkpointer`` bit for
    bit, and the reference's bf16 leaves (numpy's ``|V2``) read into a
    bf16 template bit for bit."""
    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32)
                         ).to(torch.bfloat16)
    tree = {"w": t, "m": torch.arange(4.0), "step": torch.tensor(3)}
    ck = Checkpointer(str(tmp_path / "port"), use_async=False)
    ck.save(1, tree)
    got = ck.restore({"w": torch.zeros_like(t), "m": torch.zeros(4),
                      "step": torch.tensor(0)})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], t)
    assert torch.equal(got["m"], tree["m"]) and int(got["step"]) == 3
    jck = JCheckpointer(str(tmp_path / "ref"), use_async=False)
    jw = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    jck.save(2, {"w": jw})
    back = Checkpointer(str(tmp_path / "ref")).restore(
        {"w": torch.zeros_like(t)})
    assert torch.equal(back["w"], t)
