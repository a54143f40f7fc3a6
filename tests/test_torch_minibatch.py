"""The mini-batch black box and the centralized ``lloyd`` and
``minibatch`` algorithms in the port, on the CPU, against the JAX
package: tests/test_kmeans.py:71's claim, the weighted batch draw, the
facade's centralized fits (tests/test_api.py:146-186 and the wire
bytes of tests/test_wire.py:204), and ``blackbox="minibatch"`` in SOCCER
and ``coreset_kmeans``.

The batch draws differ between the packages (the reference's
``jax.random.categorical``, the port's exact CDF and ``searchsorted``),
so the fits are held to the reference's outcomes; the uplink rows and
bytes depend on shapes alone and are held exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import fit as jfit
from repro.core.minibatch import minibatch_kmeans as jminibatch
from repro_torch import api
from repro_torch.configs.soccer_paper import GaussianMixtureSpec
from repro_torch.core.metrics import centralized_cost
from repro_torch.core.minibatch import minibatch_kmeans, row_sampler
from repro_torch.data.synthetic import gaussian_mixture, shard_points
from repro_torch.kernels.exact import exact_cumsum

# xdist runs one worker per core: with torch's default of one intra-op
# thread per core in every worker, the pools contend and small ops run
# several times slower
torch.set_num_threads(1)

M, K = 8, 5
# the port's cost over the reference's on the same data: the random
# streams differ, and k-means++ may land in another local optimum
COST_RATIO_TOL = 0.10


def _blobs(n=600, k=6, d=5, sigma=0.02, seed=0):
    """tests/test_kmeans.py's blobs."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(size=(k, d)).astype(np.float32)
    lbl = rng.integers(0, k, n)
    return (means[lbl] + sigma * rng.normal(size=(n, d))).astype(
        np.float32), means


def _cost(x, centers) -> float:
    return float(centralized_cost(torch.from_numpy(np.asarray(x)),
                                  torch.from_numpy(np.asarray(centers))))


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_minibatch_reasonable(seed):
    """tests/test_kmeans.py:71's bound, for the port and the reference on
    the same blobs; the returned cost is the full weighted set's."""
    x, means = _blobs(n=2000, k=5, seed=seed)
    w = np.ones(2000, np.float32)
    c, cost = minibatch_kmeans(torch.Generator().manual_seed(3),
                               torch.from_numpy(x), torch.from_numpy(w), 5,
                               batch=256, steps=40)
    full = _cost(x, means)
    assert c.shape == (5, 5) and c.dtype == torch.float32
    assert float(cost) < 4.0 * max(full, 1e-6) + 1.0
    assert float(cost) == pytest.approx(_cost(x, c), rel=1e-4)
    _, jcost = jminibatch(jax.random.PRNGKey(3), jnp.asarray(x),
                          jnp.asarray(w), 5, batch=256, steps=40)
    assert float(jcost) < 4.0 * max(full, 1e-6) + 1.0


def test_row_sampler_by_distribution():
    """Rows are drawn ∝ w with replacement (5 sigma per row); a row of
    weight 0 is never drawn, the trailing padding rows included."""
    w = torch.tensor([1.0, 0.0, 3.0, 2.0, 0.0, 4.0, 0.0, 0.0])
    cdf = exact_cumsum(w, torch.float64)
    draws = 40_000
    idx = row_sampler(cdf)(torch.Generator().manual_seed(0), draws)
    counts = torch.bincount(idx, minlength=8).double().numpy()
    prob = (w / w.sum()).double().numpy()
    assert counts[prob == 0].sum() == 0
    se = np.sqrt(draws * prob * (1 - prob))
    assert np.all(np.abs(counts - draws * prob) <= 5 * se + 1)
    ones = exact_cumsum(torch.ones(3), torch.float64)
    assert row_sampler(ones)(torch.Generator().manual_seed(1), 10).max() <= 2


def test_row_sampler_resolves_rows_past_2_24():
    """A total of 2^26 over 2^20 rows, in pairs weighing (1, 127): the
    light rows of each quarter of the rows take 1/512 of the draws (5
    sigma). With float32 uniforms (a grid of total·2^-24 = 4) a light row
    would hold one grid point of its pair's 32, 4x its share; with a
    float32 CDF the light rows past 2^24 would round away."""
    pairs = 2 ** 19
    w = torch.tensor([1.0, 127.0]).repeat(pairs)
    cdf = exact_cumsum(w, torch.float64)
    assert cdf.dtype == torch.float64 and float(cdf[-1]) == 2.0 ** 26
    assert torch.equal(cdf[1:] - cdf[:-1], w[1:].double())
    draws = 200_000
    idx = row_sampler(cdf)(torch.Generator().manual_seed(2), draws)
    quarter = (idx // (pairs // 2))[idx % 2 == 0]
    light = torch.bincount(quarter, minlength=4).numpy()
    prob = 1.0 / 512
    se = np.sqrt(draws * prob * (1 - prob))
    assert np.all(np.abs(light - draws * prob) <= 5 * se), light


def test_minibatch_narrow_payload():
    """A bfloat16 payload is clustered without an upcast copy of it; the
    centers come back float32, near the float32 fit's."""
    x, means = _blobs(n=3000, k=4, seed=5)
    w = torch.ones(3000)
    c16, _ = minibatch_kmeans(torch.Generator().manual_seed(0),
                              torch.from_numpy(x).to(torch.bfloat16), w, 4,
                              batch=256, steps=30)
    assert c16.dtype == torch.float32
    assert _cost(x, c16) < 4.0 * _cost(x, means) + 1.0


def test_minibatch_ignores_zero_weight_rows():
    """Garbage rows of weight 0 are never drawn into a batch nor seeded."""
    x, _ = _blobs(n=1200, k=4, seed=7)
    x[600:] = 1e3
    w = np.ones(1200, np.float32)
    w[600:] = 0.0
    c, cost = minibatch_kmeans(torch.Generator().manual_seed(1),
                               torch.from_numpy(x), torch.from_numpy(w), 4,
                               batch=128, steps=20)
    assert bool((c.abs() < 100.0).all()) and float(cost) < 50.0


def test_minibatch_repeats_bit_for_bit():
    x, _ = _blobs(n=1500, k=5, seed=2)
    runs = [minibatch_kmeans(torch.Generator().manual_seed(4),
                             torch.from_numpy(x), torch.ones(1500), 5,
                             batch=200, steps=25) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.fixture(scope="module")
def data():
    """tests/test_api.py's mixture."""
    x, _, means = gaussian_mixture(GaussianMixtureSpec(
        n=6_000, dim=8, k=K, sigma=0.001, seed=11))
    return x, shard_points(x, M), means


# (fit knobs, reference fit knobs) per centralized case
CENTRAL = {
    "lloyd": ("lloyd", dict(iters=5)),
    "minibatch": ("minibatch", dict(batch=128, steps=10)),
    "lloyd_int8": ("lloyd", dict(iters=5, uplink_dtype="int8")),
    "lloyd_int8_values": ("lloyd", dict(iters=5, uplink_dtype="int8",
                                        uplink_wire="values")),
    "minibatch_bf16": ("minibatch", dict(batch=128, steps=10,
                                         uplink_dtype="bfloat16")),
}


@pytest.mark.parametrize("case", sorted(CENTRAL))
def test_central_fit_matches_reference(data, case):
    """One round, the reference's uplink rows and bytes (at the dtype's
    width) and achieved wire bytes exactly, a cost within 10% of the
    reference's and within test_api's bounds of the means'."""
    x, parts, means = data
    algo, kw = CENTRAL[case]
    res = api.fit(parts, K, algo=algo, seed=7, device="cpu", **kw)
    jres = jfit(parts, K, algo=algo, backend="virtual", seed=7, **kw)
    assert res.algo == algo and res.rounds == jres.rounds == 1
    np.testing.assert_array_equal(res.uplink_points, jres.uplink_points)
    np.testing.assert_array_equal(res.uplink_bytes, jres.uplink_bytes)
    np.testing.assert_array_equal(res.wire_bytes, jres.wire_bytes)
    np.testing.assert_array_equal(res.wire_meta_bytes, jres.wire_meta_bytes)
    assert res.centers.shape == (K, 8)
    cost, jcost = _cost(x, res.centers), float(jres.cost(jnp.asarray(x)))
    assert cost <= (1 + COST_RATIO_TOL) * jcost + 1e-3
    assert cost <= 4.0 * _cost(x, means) + 1.0
    if "uplink_dtype" not in kw:       # the black box saw the exact points
        assert res.extra["blackbox_cost"] == pytest.approx(cost, rel=1e-3)


def test_lloyd_int8_codes_measured_equals_modeled(data):
    """The wire-gate invariant on the codes wire: achieved payload bytes
    equal the modeled uplink bytes, 1 byte a coordinate; the values wire
    moves the float32 reconstruction, 4x."""
    _, parts, _ = data
    res = api.fit(parts, K, algo="lloyd", iters=3, uplink_dtype="int8",
                  device="cpu")
    assert np.array_equal(res.wire_bytes, res.uplink_bytes)
    assert res.uplink_bytes.tolist() == [6_000 * 8]
    assert res.params["uplink_dtype"] == "int8"
    vals = api.fit(parts, K, algo="lloyd", iters=3, uplink_dtype="int8",
                   uplink_wire="values", device="cpu")
    assert np.array_equal(vals.wire_bytes, 4 * vals.uplink_bytes)
    assert vals.params["uplink_wire"] == "values"


@pytest.mark.parametrize("algo", ["lloyd", "minibatch"])
def test_central_fit_seed_deterministic(data, algo):
    _, parts, _ = data
    kw = CENTRAL[algo][1]
    r1 = api.fit(parts, K, algo=algo, seed=7, device="cpu", **kw)
    r2 = api.fit(parts, K, algo=algo, seed=7, device="cpu", **kw)
    assert np.array_equal(r1.centers, r2.centers)
    with pytest.raises(TypeError, match="unexpected parameter"):
        api.fit(parts, K, algo=algo, device="cpu", epsilon=0.1)


def test_central_fit_masks_dead_points(data):
    """On imbalanced shards the padding rows weigh 0: they are no uploaded
    rows, but the fixed-width gather moves them, as in the reference."""
    x, _, _ = data
    kw = dict(m=M, iters=5, seed=0, shard_policy="imbalanced")
    res = api.fit(x, K, algo="lloyd", device="cpu", **kw)
    jres = jfit(x, K, algo="lloyd", backend="virtual", **kw)
    assert res.uplink_points.tolist() == [x.shape[0]]
    assert res.wire_bytes.tolist() == jres.wire_bytes.tolist()
    assert res.wire_bytes[0] > res.uplink_bytes[0]


@pytest.mark.parametrize("algo,kw", [
    ("soccer", dict(epsilon=0.1, blackbox="minibatch", minibatch_size=128)),
    ("soccer", dict(epsilon=0.1, blackbox="minibatch", minibatch_size=128,
                    outlier_frac=0.02)),
    ("coreset_kmeans", dict(coreset_size=512, blackbox="minibatch",
                            minibatch_size=256))],
    ids=["soccer", "soccer_trimmed_finalize", "coreset_kmeans"])
def test_blackbox_minibatch_matches_reference(data, algo, kw):
    """``blackbox="minibatch"`` in SOCCER (each round's C_iter and the
    finalize) and in coreset_kmeans: the reference's rounds, n_hist[0]
    and the rounds' uplink rows (the finalize's follows the random
    survivors), a cost within 10% of its."""
    x, parts, means = data
    res = api.fit(parts, K, algo=algo, seed=3, device="cpu", **kw)
    jres = jfit(parts, K, algo=algo, backend="virtual", seed=3, **kw)
    assert res.rounds == jres.rounds
    rows = max(res.rounds, 1)
    np.testing.assert_array_equal(res.uplink_points[:rows],
                                  jres.uplink_points[:rows])
    if algo == "soccer":
        assert res.extra["const"].blackbox == "minibatch"
        assert int(res.n_hist[0]) == int(jres.n_hist[0])
    cost, jcost = _cost(x, res.centers), float(jres.cost(jnp.asarray(x)))
    assert cost <= (1 + COST_RATIO_TOL) * jcost + 1e-3
    assert cost <= 4.0 * _cost(x, means) + 1.0


def test_minibatch_claim_at_the_smoke_proportions(capsys):
    """On the paper's Zipf mixture at k = 25 (the smoke's proportions at
    n = 20,000; short runs, since the seeding decides the outcome), a
    centralized mini-batch fit seeds on the first 16k rows and can miss
    whole small components, and tests/test_kmeans.py:71's bound with
    them. The seeds where each package misses it are recorded (ROADMAP
    Queue 3); the port misses it at no more of seeds 0-3 than the
    reference does. ``chip_smoke.py`` asserts the bound at n = 10 M."""
    x, _, means = gaussian_mixture(GaussianMixtureSpec(
        n=20_000, dim=15, k=25, sigma=0.001, zipf_gamma=1.5, seed=17))
    full = _cost(x, means)
    bound = 4.0 * full + 1.0
    kw = dict(algo="minibatch", m=M, batch=128, steps=10)
    missed = {"port": [], "reference": []}
    for seed in range(4):
        res = api.fit(x, 25, seed=seed, device="cpu", **kw)
        jres = jfit(x, 25, backend="virtual", seed=seed, **kw)
        assert res.rounds == 1 and res.uplink_points.tolist() == [20_000]
        assert np.isfinite(res.centers).all()
        for who, cost in (("port", _cost(x, res.centers)),
                          ("reference", float(jres.cost(jnp.asarray(x))))):
            if cost >= bound:
                missed[who].append((seed, round(cost / full, 2)))
    with capsys.disabled():
        print(f"\nminibatch at the smoke's proportions, the seeds (and cost "
              f"/ means' cost) missing {bound / full:.2f}x: {missed}")
    assert len(missed["port"]) <= len(missed["reference"]), missed
