"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's one-device path (``repro.models.moe._moe_apply_dense``), at
the ``.reduced()`` kimi-k2 (a shared expert; its leading dense layer is
``tests/test_torch_models.py``'s) and mixtral configs: weights from the
reference's ``init_moe``, tokens from a numpy seed, once drop-free
(the reduced configs' capacity factor, 8.0) and once at a factor that
drops slots.

Tolerance: float32 in both packages, the same expressions in other
summation orders, ~1e-6 here; ATOL = RTOL = 1e-4. A slot dropped by one
package and kept by the other would move its token's output by its
gate times an expert's output, O(0.1), so the outputs' agreement
already implies the same drops; ``test_dropped_slots_match_reference``
checks the slots themselves."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import moe as tmoe
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_reference

# xdist runs one worker per core: with torch's default of one intra-op
# thread per core in every worker, the pools contend and small ops run
# several times slower
torch.set_num_threads(1)

ATOL = RTOL = 1e-4
B, S = 3, 24
ARCHS = ("kimi-k2-1t-a32b", "mixtral-8x22b")
DROP_FREE, DROPPING = 8.0, 0.75


def port_moe(p_ref, cfg) -> tmoe.MoE:
    """The port's MoE holding the reference ``init_moe`` dict's values."""
    m = tmoe.MoE(cfg, torch.Generator().manual_seed(0))
    for name, prm in m.named_parameters():
        leaf = p_ref
        for key in name.split("."):
            leaf = leaf[key]
        prm.copy_(torch.from_numpy(np.array(leaf)))
    return m


@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    """The reference's MoE weights and the port's layer holding them,
    and (B, S, d) tokens."""
    name = request.param
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    p_ref = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    x = np.random.default_rng(0).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return dict(name=name, jcfg=jcfg, cfg=cfg, p_ref=p_ref,
                model=port_moe(p_ref, cfg), x=x)


def _reference(layer, cf):
    out, aux = jmoe._moe_apply_dense(layer["p_ref"], layer["jcfg"],
                                     jnp.asarray(layer["x"]), cf)
    return np.asarray(out), float(aux)


@pytest.mark.parametrize("cf", [DROP_FREE, DROPPING])
def test_moe_apply_matches_reference(layer, cf):
    want, want_aux = _reference(layer, cf)
    got, aux = tmoe.moe_apply(layer["model"], layer["cfg"],
                              torch.from_numpy(layer["x"]),
                              capacity_factor=cf)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), want_aux, rtol=RTOL, atol=ATOL)


def test_moe_apply_takes_the_config_capacity(layer):
    """Without ``capacity_factor`` the layer uses the config's."""
    x = torch.from_numpy(layer["x"])
    cfg = layer["cfg"]
    default, _ = tmoe.moe_apply(layer["model"], cfg, x)
    explicit, _ = tmoe.moe_apply(layer["model"], cfg, x,
                                 capacity_factor=cfg.moe_capacity_factor)
    assert torch.equal(default, explicit)


@pytest.mark.parametrize("cf", [DROP_FREE, DROPPING])
def test_dropped_slots_match_reference(layer, cf):
    """The port's dispatch keeps and drops the very slots the reference's
    stable sort does: its (T·k) keep mask against the one the reference's
    expressions (moe.py:87-95) give on the reference's own routing, and
    the factor that drops does drop."""
    cfg = layer["cfg"]
    e, k = cfg.n_experts, cfg.experts_per_token
    t = B * S
    xf = jnp.asarray(layer["x"]).reshape(t, -1)
    probs = jax.nn.softmax(xf @ layer["p_ref"]["router"], axis=-1)
    _, jeidx = jax.lax.top_k(probs, k)
    cap = max(int(cf * t * k / e), 1)
    eflat = jeidx.reshape(-1)
    jorder = jnp.argsort(eflat, stable=True)
    es = eflat[jorder]
    starts = jnp.searchsorted(es, jnp.arange(e, dtype=es.dtype))
    rank = jnp.arange(t * k) - starts[es]
    want = np.zeros(t * k, bool)
    want[np.asarray(jorder)] = np.asarray(rank < cap)

    _, _, eidx = tmoe.route(layer["model"], cfg, torch.from_numpy(
        layer["x"]).reshape(t, -1))
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(jeidx))
    assert tmoe.capacity(cfg, t, cf) == cap
    order, dest = tmoe.dispatch(eidx, e, cap)
    got = np.zeros(t * k, bool)
    got[order.numpy()] = (dest < e * cap).numpy()
    np.testing.assert_array_equal(got, want)
    assert (~got).any() == (cf == DROPPING)
    kept = dest[dest < e * cap]
    assert kept.unique().numel() == kept.numel()


@pytest.mark.parametrize("name", ARCHS)
def test_lm_forward_drops_as_the_reference(name):
    """The whole LM at a capacity factor that drops slots in every MoE
    layer (kimi-k2's leading dense layer included): logits and the
    summed aux loss against the reference's."""
    jcfg = dataclasses.replace(jget_config(name).reduced(),
                               moe_capacity_factor=DROPPING)
    cfg = dataclasses.replace(get_config(name).reduced(),
                              moe_capacity_factor=DROPPING)
    params = jmodel.init_lm(jax.random.PRNGKey(1), jcfg)
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    want, want_aux = jmodel.lm_forward(params, jcfg, jnp.asarray(tokens))
    got, aux = tmodel.lm_forward(model, cfg, tokens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=RTOL,
                               atol=ATOL)
    assert float(aux) > 0.0
