"""The port's serving entry points (``repro_torch.serve.decode``) and the
LM examples against the JAX package, on the CPU at the ``.reduced()``
configs, with the reference's own ``init_lm`` weights carried across by
``params_from_reference``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import fit as jfit
from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.serve import decode as jdecode
from repro_torch.api import fit
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.models import model as tmodel
from repro_torch.models.layers import init_embedding
from repro_torch.models.convert import flat_arrays, params_from_reference
from repro_torch.serve import decode as tdecode

# xdist runs one worker per core: with torch's default of one intra-op
# thread per core in every worker, the pools contend and small ops run
# several times slower
torch.set_num_threads(1)

# float32 logits of the two packages agree to ~1e-6 (tests/test_torch_
# models.py); a greedy token is decided where the top two logits are
# farther apart than this
GAP_TOL = 1e-4
B, PROMPT, STEPS = 2, 12, 5
FAMILIES = ("qwen2-1.5b", "kimi-k2-1t-a32b", "llama-3.2-vision-11b",
            "whisper-base", "zamba2-2.7b", "xlstm-125m")


@pytest.fixture(scope="module", autouse=True)
def jitted_reference_steps():
    """The reference's ``prefill`` and ``serve_step`` under ``jax.jit``
    while this module runs (``generate`` calls them by name): the same
    functions, compiled once a shape, where an eager call traces its
    scans anew every step."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jdecode, "prefill", jax.jit(
        jdecode.prefill, static_argnums=1, static_argnames=("max_len",)))
    mp.setattr(jdecode, "serve_step", jax.jit(
        jdecode.serve_step, static_argnums=1,
        static_argnames=("temperature",)))
    yield
    mp.undo()


@functools.lru_cache(maxsize=None)
def reference_init(name):
    """The reference's init_lm (jitted) at ``name``'s reduced config."""
    jcfg = jget_config(name).reduced()
    return jcfg, jax.jit(jmodel.init_lm, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module", params=FAMILIES)
def served(request):
    """The reference's init_lm at the reduced config (one arch a family),
    the port's model holding its weights, a prompt and a frontend."""
    name = request.param
    (jcfg, params), cfg = reference_init(name), get_config(name).reduced()
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    fe = None
    if cfg.n_frontend_tokens:
        fe = (rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model))
              * 0.1).astype(np.float32)
    return dict(cfg=cfg, jcfg=jcfg, params=params, model=model,
                prompt=prompt, fe=fe)


def test_reference_init_carried_across(served):
    """params_from_reference on the reference's own init_lm: every leaf of
    the pytree, unstacked, equals the port's parameter bit for bit."""
    m, cfg = served["model"], served["cfg"]
    ref = flat_arrays(jax.tree.map(np.asarray, served["params"]))
    port = {name: p.numpy() for name, p in m.named_parameters()}
    assert sum(a.size for a in ref.values()) == \
        sum(a.size for a in port.values())
    per = {"vlm": cfg.cross_attn_every - 1,
           "hybrid": cfg.attn_every}.get(cfg.family)
    for name, val in port.items():
        parts = name.split(".")
        if len(parts) > 2 and parts[1].isdigit():
            group, i = parts[0], int(parts[1])
            if group == "cross_blocks" and cfg.family == "audio":
                key, idx = "blocks/cross/" + "/".join(parts[2:]), (i,)
            elif cfg.family == "ssm":
                key, idx = f"blocks/{i}/" + "/".join(parts[2:]), ()
            else:
                key = group + "/" + "/".join(parts[2:])
                idx = (i // per, i % per) if (per and group == "blocks") \
                    else (i,)
            np.testing.assert_array_equal(val, ref[key][idx], err_msg=name)
        else:
            key = {"embed": "embed/embedding", "head": "head/w"}.get(
                name, name.replace(".", "/"))
            np.testing.assert_array_equal(val, ref[key], err_msg=name)


def test_greedy_generate_matches_reference(served):
    """``generate`` greedy equals the reference's ``generate`` token for
    token wherever the top-2 logit gap exceeds GAP_TOL at that step and
    every earlier one (a closer pair may break either way at rounding;
    the gaps are the port's logits', which tests/test_torch_models.py
    holds to the reference's within 1e-4)."""
    cfg, jcfg, params = served["cfg"], served["jcfg"], served["params"]
    prompt, fe = served["prompt"], served["fe"]
    max_len = PROMPT + STEPS + 1
    jfe = None if fe is None else jnp.asarray(fe)
    want, _ = jdecode.generate(params, jcfg, jnp.asarray(prompt),
                               steps=STEPS, max_len=max_len, frontend=jfe)
    want = np.asarray(want)
    got, cache = tdecode.generate(served["model"], cfg, prompt, steps=STEPS,
                                  max_len=max_len, frontend=fe)
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    assert cache["t"].tolist() == [PROMPT + STEPS - 1] * B
    logits, c = tmodel.lm_prefill(served["model"], cfg, prompt, frontend=fe,
                                  max_len=max_len)
    decided = np.ones(B, bool)
    for i in range(STEPS):
        top2 = torch.topk(logits[:, -1], 2, dim=-1).values.numpy()
        decided &= (top2[:, 0] - top2[:, 1]) > GAP_TOL
        np.testing.assert_array_equal(got[decided, i].numpy(),
                                      want[decided, i])
        logits, c = tmodel.lm_decode_step(served["model"], cfg,
                                          got[:, i:i + 1], c)
    assert decided.any()


def _clone(tree):
    """A copy of a cache whose buffers the decode step writes in place."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def test_serve_step_greedy_is_argmax(served):
    cfg, model = served["cfg"], served["model"]
    logits, cache = tdecode.prefill(model, cfg, served["prompt"],
                                    frontend=served["fe"], max_len=PROMPT + 2)
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    ref_logits, _ = tmodel.lm_decode_step(model, cfg, tok,
                                          _clone(cache))
    nxt, cache = tdecode.serve_step(model, cfg, tok, cache)
    assert nxt.dtype == torch.int32 and nxt.shape == (B, 1)
    assert torch.equal(nxt[:, 0], torch.argmax(ref_logits[:, -1], -1).to(
        torch.int32))


def test_temperature_draws_in_law(served):
    """With temperature > 0 the draws come from the caller's generator:
    tokens in range, the same seed repeats its draws, and the first token
    (the prefill's argmax) is the greedy one, as in the reference."""
    cfg, model = served["cfg"], served["model"]
    kw = dict(steps=STEPS, max_len=PROMPT + STEPS + 1, frontend=served["fe"],
              temperature=1.0)
    runs = [tdecode.generate(model, cfg, served["prompt"],
                             generator=torch.Generator().manual_seed(s),
                             **kw)[0] for s in (3, 3, 4)]
    greedy, _ = tdecode.generate(model, cfg, served["prompt"], steps=1,
                                 max_len=PROMPT + 2, frontend=served["fe"])
    for toks in runs:
        assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
        assert torch.equal(toks[:, 0], greedy[:, 0])
    assert torch.equal(runs[0], runs[1])


def test_embedding_example_beside_reference():
    """examples/embedding_clustering*.py's fit on the reduced qwen2-1.5b
    table (256 x 64, the reference's init_lm weights): the same rounds in
    both packages and the port's cost within 1.1x of the reference's, in
    either direction (the two draw their samples from different
    generators)."""
    _, params = reference_init("qwen2-1.5b")
    emb = params["embed"]["embedding"]
    x = jnp.asarray(emb, jnp.float32)
    jres = jfit(x, k=16, algo="soccer", backend="virtual", m=8, epsilon=0.2,
                seed=0)
    model = params_from_reference(jax.tree.map(np.asarray, params),
                                  get_config("qwen2-1.5b").reduced(),
                                  device="cpu")
    tx = model.embed.float()
    res = fit(tx, k=16, algo="soccer", backend="virtual", m=8, epsilon=0.2,
              seed=0, device="cpu")
    assert res.rounds == jres.rounds
    assert res.centers.shape == jres.centers.shape
    cost, jcost = res.cost(tx, device="cpu"), float(jres.cost(x))
    assert cost <= 1.1 * jcost and jcost <= 1.1 * cost


@pytest.mark.parametrize("name", ASSIGNED_ARCHS)
def test_embedding_table_alone_equals_init_lm(name):
    """examples/embedding_clustering_torch.py builds only the table (a
    full-width kimi-k2 would be 1 T parameters): ``init_embedding`` on a
    generator seeded 0 equals ``init_lm(cfg, seed=0).embed`` bit for
    bit, at the reduced config."""
    cfg = get_config(name).reduced()
    table = init_embedding(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(table, tmodel.init_lm(cfg, seed=0,
                                             device="cpu").embed)


def test_examples_run_on_the_cpu(capsys):
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1] / "examples"
    for name, argv in (("serve_lm_torch", ["--device", "cpu", "--steps", "4",
                                           "--arch", "whisper-base"]),
                       ("embedding_clustering_torch", ["--device", "cpu"])):
        spec = importlib.util.spec_from_file_location(
            name, root / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.main(argv)
    out = capsys.readouterr().out
    assert "decoded 4 tokens x 4 seqs" in out
    assert "into 16 prototypes" in out
