"""The port's LM serving path (``repro_torch.models``) against the JAX
package, at the ``.reduced()`` configs of all ten architectures (the
dense, moe, vlm, audio, hybrid and ssm families), in float32: weights in the reference's pytree layout, carried across by
``params_from_reference``, and inputs, all made from a numpy seed. The
weights are random everywhere, norms' scales and biases included, so a
term the port dropped shows (``tests/test_torch_serve.py`` converts the
reference's own ``init_lm``, whose biases are zero).

Tolerance: both packages compute the same float32 expressions in
different summation orders, so logits and cache entries agree to
rounding, ~1e-6 here; ATOL = RTOL = 1e-4 (logits are O(1)) leaves room
for that and fails on any change of arithmetic (a missed bias, a mask, a
bfloat16 cast, tanh vs erf GELU)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.convert import flat_arrays, params_from_reference

# xdist runs one worker per core: with torch's default of one intra-op
# thread per core in every worker, the pools contend and small ops run
# several times slower
torch.set_num_threads(1)

ATOL = RTOL = 1e-4
B, S = 2, 16
SERVED = ASSIGNED_ARCHS


def _inputs(cfg, seed=0, s=S):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    fe = None
    if cfg.n_frontend_tokens:
        fe = (rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model))
              * 0.1).astype(np.float32)
    return tokens, fe


def _j(a):
    return None if a is None else jnp.asarray(a)


def reference_weights(jcfg, seed=0):
    """A pytree shaped as the reference's ``init_lm``'s (by
    ``jax.eval_shape``), of numpy float32 draws: scales 1 + 0.1·N, biases
    0.1·N, every matrix 0.1·N (d_model is 64 at the reduced configs)."""
    shapes = jax.eval_shape(functools.partial(jmodel.init_lm, cfg=jcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return jnp.asarray(1.0 + 0.1 * z)
        return jnp.asarray(0.1 * z)
    return jax.tree_util.tree_map_with_path(draw, shapes)


# the reference's entry points under jax.jit: the same functions, compiled
# once a shape, where an eager call traces its scans anew each call
_jfwd = jax.jit(jmodel.lm_forward, static_argnums=1)
_jprefill = jax.jit(jmodel.lm_prefill, static_argnums=1,
                    static_argnames=("max_len",))
_jdecode = jax.jit(jmodel.lm_decode_step, static_argnums=1)


@pytest.fixture(scope="module", params=SERVED)
def arch(request):
    """Reference weights, the port's model holding them, inputs, and the
    reference's forward, prefill (of S-1 tokens) and one decode step."""
    name = request.param
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    params = reference_weights(jcfg)
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    tokens, fe = _inputs(cfg)
    logits, aux = _jfwd(params, jcfg, _j(tokens), frontend=_j(fe))
    last, cache = _jprefill(params, jcfg, _j(tokens[:, :S - 1]),
                            frontend=_j(fe), max_len=S + 4)
    step, _ = _jdecode(params, jcfg, _j(tokens[:, S - 1:]), cache)
    return dict(name=name, cfg=cfg, jcfg=jcfg, params=params, model=model,
                tokens=tokens, fe=fe, logits=np.asarray(logits),
                aux=float(aux),
                last=np.asarray(last),
                cache=flat_arrays(jax.tree.map(np.asarray, cache)),
                step=np.asarray(step))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_weights_carried_across(arch):
    """Every reference leaf lands in the port's model unchanged."""
    m, cfg, params = arch["model"], arch["cfg"], arch["params"]
    ref = flat_arrays(jax.tree.map(np.asarray, params))
    np.testing.assert_array_equal(m.embed.numpy(), ref["embed/embedding"])
    blk = "blocks/attn/wq"
    if cfg.family == "vlm":
        per = cfg.cross_attn_every - 1
        np.testing.assert_array_equal(m.blocks[per + 0].attn.wq.numpy(),
                                      ref[blk][1, 0])
        np.testing.assert_array_equal(m.cross_blocks[1].mlp.wo.numpy(),
                                      ref["cross_blocks/mlp/wo"][1])
    elif cfg.family == "hybrid":
        per = cfg.attn_every
        np.testing.assert_array_equal(m.blocks[per + 1].m.in_proj.numpy(),
                                      ref["blocks/m/in_proj"][1, 1])
        np.testing.assert_array_equal(m.shared_blocks[1].attn.wq.numpy(),
                                      ref["shared_blocks/attn/wq"][1])
    elif cfg.family == "ssm":
        i = cfg.slstm_at[0]
        np.testing.assert_array_equal(m.blocks[i].slstm.r.numpy(),
                                      ref[f"blocks/{i}/slstm/r"])
        np.testing.assert_array_equal(m.blocks[-1].mlstm.wq.numpy(),
                                      ref[f"blocks/{cfg.n_layers - 1}/mlstm/"
                                          f"wq"])
    else:
        np.testing.assert_array_equal(m.blocks[-1].attn.wq.numpy(),
                                      ref[blk][-1])
    if cfg.family == "moe":
        np.testing.assert_array_equal(m.blocks[-1].moe.wo.numpy(),
                                      ref["blocks/moe/wo"][-1])
        if cfg.first_k_dense:
            np.testing.assert_array_equal(
                m.dense_blocks[0].mlp.wi_up.numpy(),
                ref["dense_blocks/mlp/wi_up"][0])
            np.testing.assert_array_equal(
                m.blocks[0].moe.shared.wi_gate.numpy(),
                ref["blocks/moe/shared/wi_gate"][0])
    if cfg.family == "audio":
        np.testing.assert_array_equal(m.cross_blocks[1].attn.wv.numpy(),
                                      ref["blocks/cross/attn/wv"][1])
        np.testing.assert_array_equal(m.enc_blocks[0].ln1.bias.numpy(),
                                      ref["enc_blocks/ln1/bias"][0])
    n_port = sum(p.numel() for p in m.parameters())
    assert n_port == sum(a.size for a in ref.values())


def test_forward_matches_reference(arch):
    logits, aux = tmodel.lm_forward(arch["model"], arch["cfg"],
                                    arch["tokens"], frontend=arch["fe"])
    assert logits.dtype == torch.float32
    assert logits.shape == (B, S, arch["cfg"].vocab_size)
    if arch["cfg"].family == "moe":
        assert float(aux) > 0.0
    else:
        assert float(aux) == 0.0
    _close(aux, arch["aux"])
    _close(logits, arch["logits"])


def test_prefill_matches_reference(arch):
    last, cache = tmodel.lm_prefill(arch["model"], arch["cfg"],
                                    arch["tokens"][:, :S - 1],
                                    frontend=arch["fe"], max_len=S + 4)
    _close(last, arch["last"])
    got = flat_arrays(cache)
    assert got.keys() == arch["cache"].keys()
    for key, want in arch["cache"].items():
        assert got[key].shape == want.shape and got[key].dtype == want.dtype
        _close(got[key], want)


def test_decode_step_matches_reference(arch):
    _, cache = tmodel.lm_prefill(arch["model"], arch["cfg"],
                                 arch["tokens"][:, :S - 1],
                                 frontend=arch["fe"], max_len=S + 4)
    step, cache = tmodel.lm_decode_step(arch["model"], arch["cfg"],
                                        arch["tokens"][:, S - 1:], cache)
    _close(step, arch["step"])
    assert cache["t"].tolist() == [S] * B


def test_prefill_plus_decode_equals_forward(arch):
    """The reference's own claim (tests/test_models.py): the decode step
    after a prefill of S-1 tokens gives the forward's last logits; here
    at the float32 tolerance instead of its 2e-2."""
    logits, _ = tmodel.lm_forward(arch["model"], arch["cfg"],
                                  arch["tokens"], frontend=arch["fe"])
    _, cache = tmodel.lm_prefill(arch["model"], arch["cfg"],
                                 arch["tokens"][:, :S - 1],
                                 frontend=arch["fe"], max_len=S + 4)
    step, _ = tmodel.lm_decode_step(arch["model"], arch["cfg"],
                                    arch["tokens"][:, S - 1:], cache)
    _close(step[:, 0], logits[:, S - 1])


def test_init_cache_matches_prefill_structure(arch):
    """init_cache has exactly lm_prefill's leaves (names, shapes, dtypes),
    and those are the reference's init_cache's."""
    cfg = arch["cfg"]
    empty = flat_arrays(tmodel.init_cache(cfg, B, S + 4, device="cpu"))
    _, cache = tmodel.lm_prefill(arch["model"], cfg,
                                 arch["tokens"][:, :S - 1],
                                 frontend=arch["fe"], max_len=S + 4)
    filled = flat_arrays(cache)
    ref = flat_arrays(jax.tree.map(
        np.asarray, jmodel.init_cache(arch["jcfg"], B, S + 4)))
    for other in (filled, ref):
        assert empty.keys() == other.keys()
        for key in empty:
            assert (empty[key].shape, empty[key].dtype) == \
                (other[key].shape, other[key].dtype), key


@pytest.fixture
def flash_everywhere(monkeypatch):
    """Both packages take the flash path above 4 keys, in 4-key chunks, so
    the reduced models' prefill, forward and ring decode go through the
    chunked online softmax with a padded last chunk."""
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "_DENSE_MAX_KV", 4)
        monkeypatch.setattr(mod, "_FLASH_CHUNK", 4)


@pytest.mark.parametrize("prompt", [13, 5])
def test_ring_cache_crosses_window(flash_everywhere, prompt):
    """h2o-danube's sliding window (8 at the reduced config) with a prompt
    that crosses it (13 tokens: the prefill keeps the last 8, rolled) or
    not (5), then 6 decode steps that wrap the ring: every step's logits
    against the reference's and against the full forward over the same
    tokens, all on the flash path."""
    jcfg = jget_config("h2o-danube-3-4b").reduced()
    cfg = get_config("h2o-danube-3-4b").reduced()
    params = reference_weights(jcfg, seed=1)
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    jdecode = jax.jit(functools.partial(jmodel.lm_decode_step, params,
                                        jcfg))
    steps = 6
    tokens, _ = _inputs(cfg, seed=3, s=prompt + steps)
    full, _ = tmodel.lm_forward(model, cfg, tokens)
    # fresh jits over these weights: traced here, under the patched chunk
    jfull, _ = jax.jit(functools.partial(jmodel.lm_forward, params, jcfg))(
        _j(tokens))
    _close(full, jfull)
    max_len = prompt + steps + 4
    _, cache = tmodel.lm_prefill(model, cfg, tokens[:, :prompt],
                                 max_len=max_len)
    _, jcache = jax.jit(functools.partial(
        jmodel.lm_prefill, params, jcfg, max_len=max_len))(
            _j(tokens[:, :prompt]))
    assert cache["layers"]["k"].shape[2] == cfg.window
    for key, want in flat_arrays(jax.tree.map(np.asarray, jcache)).items():
        _close(flat_arrays(cache)[key], want)
    for i in range(prompt, prompt + steps):
        tok = tokens[:, i:i + 1]
        step, cache = tmodel.lm_decode_step(model, cfg, tok, cache)
        jstep, jcache = jdecode(_j(tok), jcache)
        _close(step, jstep)
        _close(step[:, 0], full[:, i])


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("gqa", [(8, 8), (8, 2)])
def test_attention_dense_equals_flash(window, gqa):
    """attention_core's two paths agree and each equals the reference's,
    forward (tests/test_sequence_models.py's case, without the backward)."""
    h, kv = gqa
    b, sq, hd = 2, 50, 16
    rng = np.random.default_rng(0)
    q = (rng.standard_normal((b, sq, h, hd)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((b, sq, kv, hd)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((b, sq, kv, hd)) * 0.3).astype(np.float32)
    pos = np.broadcast_to(np.arange(sq, dtype=np.int32)[None], (b, sq))
    tq, tk, tv, tp = (torch.from_numpy(np.array(a)) for a in (q, k, v, pos))
    out = {f: tattn.attention_core(tq, tk, tv, q_pos=tp, kv_pos=tp,
                                   causal=True, window=window, force=f)
           for f in ("dense", "flash")}
    _close(out["dense"], out["flash"])
    for f in ("dense", "flash"):
        ref = jattn.attention_core(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), q_pos=jnp.asarray(pos),
                                   kv_pos=jnp.asarray(pos), causal=True,
                                   window=window, force=f)
        _close(out[f], ref)


def test_flash_respects_kv_validity():
    """Masked (invalid) cache slots contribute nothing: flash over 40
    slots of which 10 are valid equals dense over those 10."""
    b, sq, h, hd, skv = 1, 1, 2, 8, 40
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((b, sq, h, hd)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((b, skv, h, hd)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((b, skv, h, hd)).astype(
        np.float32))
    pos_q = torch.full((b, sq), 100, dtype=torch.int32)
    pos_kv = torch.arange(skv, dtype=torch.int32).expand(b, skv)
    valid = pos_kv < 10
    masked = tattn.attention_core(q, k, v, q_pos=pos_q, kv_pos=pos_kv,
                                  kv_valid=valid, causal=True, window=0,
                                  force="flash")
    trunc = tattn.attention_core(q, k[:, :10], v[:, :10], q_pos=pos_q,
                                 kv_pos=pos_kv[:, :10], causal=True,
                                 window=0, force="dense")
    _close(masked, trunc)
    ref = jattn.attention_core(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), q_pos=jnp.asarray(pos_q.numpy()),
        kv_pos=jnp.asarray(pos_kv.numpy()), kv_valid=jnp.asarray(
            valid.numpy()), causal=True, window=0, force="flash")
    _close(masked, ref)


def test_cache_ring_positions_match_reference():
    """cache_positions and the ring writes, slot by slot, against the
    reference's at positions before, at and after the window wraps."""
    width, b = 8, 3
    for t in ([0, 3, 7], [8, 9, 20], [5, 15, 31]):
        pos, valid = tattn.cache_positions(torch.tensor(t), width, b)
        jpos, jvalid = jattn.cache_positions(jnp.asarray(t), width, b)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        cfg = get_config("h2o-danube-3-4b").reduced()   # window 8
        cache = tattn.init_kv_cache(cfg, b, 2 * width, dtype=torch.float32,
                                    device="cpu")
        assert cache["k"].shape == (b, width, cfg.n_kv_heads, 16)
        cache = {key: buf[:, :, :1, :2] for key, buf in cache.items()}
        new = torch.arange(b * 2, dtype=torch.float32).reshape(b, 1, 1, 2) + 1
        tattn.cache_write_decode(cache, new, -new, torch.tensor(t))
        jcache = jattn.cache_write_decode(
            {"k": jnp.zeros((b, width, 1, 2)), "v": jnp.zeros((b, width, 1,
                                                                 2))},
            jnp.asarray(new.numpy()), jnp.asarray(-new.numpy()),
            jnp.asarray(t))
        for key in ("k", "v"):
            np.testing.assert_array_equal(cache[key].numpy(),
                                          np.asarray(jcache[key]))


def test_entry_points_default_to_the_card(monkeypatch):
    """Without CUDA the LM's constructors raise unless given the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-1.5b").reduced()
    for call in (lambda: tmodel.init_lm(cfg),
                 lambda: tmodel.init_cache(cfg, B, S),
                 lambda: params_from_reference({}, cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
