"""The port's ``fit`` front end: results, wire accounting, device rules
and the knobs outside the ported main path."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import fit as jfit
from repro.api import result as jresult
from repro_torch import api
from repro_torch.api import result as tresult
from repro_torch.configs.soccer_paper import GaussianMixtureSpec
from repro_torch.core import soccer as tsoc
from repro_torch.data.synthetic import gaussian_mixture

# xdist runs one worker per core: with torch's default of one intra-op
# thread per core in every worker, the pools contend and small ops run
# several times slower
torch.set_num_threads(1)



@pytest.fixture(scope="module")
def data():
    x, _, means = gaussian_mixture(GaussianMixtureSpec(
        n=8000, dim=15, k=6, sigma=0.001, seed=4))
    return x, means


@pytest.fixture(scope="module")
def result(data):
    x, _ = data
    return api.fit(x, 6, epsilon=0.1, seed=3, device="cpu")


def test_fit_result_shape(data, result):
    x, means = data
    res = result
    assert res.algo == "soccer" and res.backend == "virtual" and res.k == 6
    assert res.rounds == 1 and res.centers.shape[1] == 15
    assert len(res.uplink_points) == len(res.wire_bytes) == res.rounds + 1
    np.testing.assert_array_equal(res.uplink_bytes,
                                  res.uplink_points * 15 * 4)
    assert res.params["device"] == "cpu" and res.wall_time_s > 0
    means_cost = tresult.ClusterResult(
        centers=means, k=6, algo="", backend="", rounds=0,
        uplink_points=np.zeros(1), uplink_bytes=np.zeros(1)).cost(
            x, device="cpu")
    assert res.cost(x, device="cpu") <= 3.0 * means_cost


def test_wire_bytes_sum_per_round(result):
    """Per-round payload + metadata sum exactly to wire_bytes_total, and
    the float32 point payload moves exactly its modeled bytes."""
    res = result
    assert int(np.sum(res.wire_bytes) + np.sum(res.wire_meta_bytes)) == \
        res.wire_bytes_total
    np.testing.assert_array_equal(res.wire_bytes, res.uplink_bytes)
    assert (res.wire_meta_bytes > 0).all()


def test_fit_matches_reference_outcome(data, result):
    """The same data through the reference's fit: the same rounds and a
    cost within 10% (the random streams differ)."""
    x, _ = data
    ref = jfit(x, 6, backend="virtual", epsilon=0.1, seed=3)
    assert ref.rounds == result.rounds
    np.testing.assert_array_equal(ref.uplink_points, result.uplink_points)
    assert result.cost(x, device="cpu") <= 1.1 * ref.cost(jnp.asarray(x))


def test_seed_determinism(data):
    x, _ = data
    a = api.fit(x[:2000], 3, epsilon=0.2, seed=5, device="cpu")
    b = api.fit(x[:2000], 3, epsilon=0.2, seed=5, device="cpu")
    np.testing.assert_array_equal(a.centers, b.centers)
    np.testing.assert_array_equal(a.n_hist, b.n_hist)


def test_torch_tensor_input_same_result(data):
    """A CPU tensor (and its weights as a tensor) gives the ClusterResult
    of its numpy array bit for bit; a bfloat16 tensor that of its float32
    widening (the reference's np.asarray reads a jax.Array the same way)."""
    x, _ = data
    x = x[:4000]
    w = np.linspace(0.5, 1.5, x.shape[0], dtype=np.float32)
    a = api.fit(x, 3, w=w, epsilon=0.2, seed=5, device="cpu")
    b = api.fit(torch.from_numpy(x), 3, w=torch.from_numpy(w), epsilon=0.2,
                seed=5, device="cpu")
    for f in ("centers", "n_hist", "v_hist", "uplink_points", "uplink_bytes",
              "wire_bytes", "wire_meta_bytes"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.rounds, a.k, a.algo, a.backend) == \
        (b.rounds, b.k, b.algo, b.backend)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    c = api.fit(xb, 3, epsilon=0.2, seed=5, device="cpu")
    d = api.fit(xb.float().numpy(), 3, epsilon=0.2, seed=5, device="cpu")
    np.testing.assert_array_equal(c.centers, d.centers)
    np.testing.assert_array_equal(c.n_hist, d.n_hist)


def test_presharded_input_and_weights(data):
    x, _ = data
    parts = x[:4000].reshape(8, 500, 15)
    w = np.ones((8, 500), np.float32)
    res = api.fit(parts, 3, w=w, epsilon=0.2, device="cpu")
    assert res.params["m"] == 8
    assert res.cost(parts, w, device="cpu") > 0.0
    with pytest.raises(ValueError, match="conflicts"):
        api.fit(parts, 3, m=4, device="cpu")
    with pytest.raises(ValueError, match="shard_policy"):
        api.fit(parts, 3, shard_policy="sorted", device="cpu")


def test_fit_without_cuda_raises(monkeypatch, data):
    """The entry points run on the card unless the caller asks for the
    CPU: with no CUDA and no device=, they raise instead of carrying on."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, _ = data
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.fit(x, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsoc.run_soccer(x.reshape(8, 1000, 15),
                        tsoc.SoccerParams(k=3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tresult.ClusterResult(
            centers=x[:3], k=3, algo="", backend="", rounds=0,
            uplink_points=np.zeros(1), uplink_bytes=np.zeros(1)).cost(x)


@pytest.mark.parametrize("kwargs,item", [
    (dict(backend="mesh"), "world size m=8"),
], ids=["backend_mesh"])
def test_knobs_outside_the_slice_raise(data, kwargs, item):
    """backend="mesh" with no process group raises ValueError naming the
    world size it needs (the mesh runs: test_torch_mesh.py; every
    SoccerParams knob, the uplink knobs and failure_plan: see
    test_torch_sharded.py, test_torch_minibatch.py, test_torch_uplink.py
    and test_torch_failures.py; trace: test_torch_obs.py)."""
    x, _ = data
    with pytest.raises(ValueError, match=item):
        api.fit(x[:800], 3, device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs,item", [
    (dict(backend="mesh"), "world size m=8"),
], ids=["backend_mesh"])
@pytest.mark.parametrize("algo", ["kmeans_parallel", "eim11"])
def test_baseline_run_knobs_raise(data, algo, kwargs, item):
    """The baselines resolve the backend through the same guard as SOCCER
    (core.soccer.check_run_knobs): no process group, no mesh."""
    x, _ = data
    with pytest.raises(ValueError, match=item):
        api.fit(x[:800], 3, algo=algo, device="cpu", **kwargs)


def test_registry_and_validation(data):
    x, _ = data
    assert api.list_algorithms() == ("coreset_kmeans", "eim11",
                                     "kmeans_parallel", "kzmeans", "lloyd",
                                     "minibatch", "soccer")
    with pytest.raises(ValueError, match="unknown algorithm"):
        api.fit(x[:800], 3, algo="kmedoids", device="cpu")
    for algo, bad in (("kmeans_parallel", "epsilon"), ("eim11", "rounds")):
        with pytest.raises(TypeError, match="unexpected parameter"):
            api.fit(x[:800], 3, algo=algo, device="cpu", **{bad: 1})
    with pytest.raises(TypeError, match="unexpected parameter"):
        api.fit(x[:800], 3, epsilonn=0.1, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        api.fit(x[:800], 3, backend="nope", device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        api.fit(x[:800], 3, device="meta")


def test_byte_models_match_reference():
    up = np.asarray([34706, 0])
    for dt in ("float32", "bfloat16", "float16", "int8"):
        np.testing.assert_array_equal(tresult.uplink_bytes(up, 15, dt),
                                      jresult.uplink_bytes(up, 15, dt))
    assert tresult.omega_mk_bytes(8, 25, 15) == jresult.omega_mk_bytes(
        8, 25, 15)
