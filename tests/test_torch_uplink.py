"""The uplink knobs in the port's drivers, on the CPU, against the JAX
package: SOCCER at every ``uplink_dtype``, the int8 codes wire against
the values wire (the same fit, bit for bit, at a quarter of the payload
bytes), the wire-gate invariant of tests/test_wire.py:204-236 (on the
codes wire the achieved payload bytes equal the modeled ones), and the
baselines under int8 and bfloat16.

The random streams differ between the packages, so fits are held to the
reference's outcomes (rounds, n_hist[0], uplink rows and bytes, the cost
ratio); bytes that depend on shapes alone are held exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import fit as jfit
from repro_torch import api
from repro_torch.core import kmeans_parallel as kpar
from repro_torch.core.comm import VirtualCluster
from repro_torch.core.metrics import centralized_cost
from repro_torch.ft.compression import fake_quantize_int8

# xdist runs one worker per core: with torch's default of one intra-op
# thread per core in every worker, the pools contend and small ops run
# several times slower
torch.set_num_threads(1)

M = 8
# the port's cost over the reference's: the streams differ, and a narrow
# payload's rounding moves the optimum itself
COST_RATIO_TOL = 0.15


def _data(n=2048, d=4, m=M, seed=0):
    """tests/test_wire.py's six blobs."""
    rng = np.random.default_rng(seed)
    c = rng.normal(scale=4.0, size=(6, d))
    x = (c[rng.integers(6, size=n)] + rng.normal(size=(n, d))).astype(
        np.float32)
    return x.reshape(m, n // m, d)


def _cost(x, centers) -> float:
    x = np.asarray(x).reshape(-1, np.asarray(x).shape[-1])
    return float(centralized_cost(torch.from_numpy(x),
                                  torch.from_numpy(np.asarray(centers))))


@pytest.fixture(scope="module")
def parts():
    return _data()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int8"])
def test_soccer_uplink_dtype_matches_reference(parts, dtype):
    """The reference's rounds, n_hist[0], uplink rows and bytes at the
    dtype's width, measured bytes equal to modeled ones (the int8 payload
    on the codes wire), and a cost within 15% of the reference's."""
    res = api.fit(parts, 5, epsilon=0.2, uplink_dtype=dtype, seed=1,
                  device="cpu")
    jres = jfit(parts, 5, algo="soccer", backend="virtual", epsilon=0.2,
                uplink_dtype=dtype, seed=1)
    assert res.rounds == jres.rounds
    assert int(res.n_hist[0]) == int(jres.n_hist[0])
    rows = max(res.rounds, 1)
    np.testing.assert_array_equal(res.uplink_points[:rows],
                                  jres.uplink_points[:rows])
    width = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}[dtype]
    np.testing.assert_array_equal(res.uplink_bytes,
                                  res.uplink_points * 4 * width)
    np.testing.assert_array_equal(res.wire_bytes, res.uplink_bytes)
    assert res.extra["const"].uplink_dtype == dtype
    assert res.extra["const"].uplink_wire == (
        "codes" if dtype == "int8" else "values")
    assert _cost(parts, res.centers) <= (1 + COST_RATIO_TOL) * float(
        jres.cost(jnp.asarray(parts.reshape(-1, 4))))


CODES_VS_VALUES = {
    "soccer": ("soccer", dict(epsilon=0.2)),
    "soccer_coreset": ("soccer", dict(epsilon=0.2, uplink_mode="coreset")),
    "eim11": ("eim11", dict(epsilon=0.2, max_rounds=3)),
    "coreset_kmeans": ("coreset_kmeans", dict(coreset_size=256)),
    "kzmeans": ("kzmeans", dict(coreset_size=256, outlier_frac=0.02,
                                lloyd_iters=5)),
}


@pytest.mark.parametrize("case", sorted(CODES_VS_VALUES))
def test_codes_equal_values_bit_for_bit(parts, case):
    """The wire changes the bytes, never the statistics: int8 on the codes
    wire gives the values wire's centers bit for bit, with a quarter of
    its payload bytes, and measured bytes equal modeled ones."""
    algo, kw = CODES_VS_VALUES[case]
    codes = api.fit(parts, 5, algo=algo, uplink_dtype="int8", seed=2,
                    device="cpu", **kw)
    values = api.fit(parts, 5, algo=algo, uplink_dtype="int8",
                     uplink_wire="values", seed=2, device="cpu", **kw)
    assert np.array_equal(codes.centers, values.centers)
    assert codes.rounds == values.rounds
    np.testing.assert_array_equal(codes.uplink_bytes, values.uplink_bytes)
    assert np.array_equal(4 * codes.wire_bytes, values.wire_bytes)
    if case != "soccer_coreset":      # its finalize ships fixed-width rows
        assert np.array_equal(codes.wire_bytes, codes.uplink_bytes)
    assert codes.params["uplink_dtype"] == "int8"
    assert values.params["uplink_wire"] == "values"


@pytest.mark.parametrize("algo,kw", [
    ("soccer", dict(epsilon=0.2)), ("eim11", dict(max_rounds=3)),
    ("lloyd", {}),
    ("coreset_kmeans", dict(coreset_size=256))],
    ids=["soccer", "eim11", "lloyd", "coreset_kmeans"])
def test_int8_codes_measured_equals_modeled(parts, algo, kw):
    """tests/test_wire.py:204's invariant, and the reference's bytes."""
    res = api.fit(parts, 5, algo=algo, uplink_dtype="int8", device="cpu",
                  **kw)
    jres = jfit(parts, 5, algo=algo, backend="virtual", uplink_dtype="int8",
                **kw)
    assert np.array_equal(res.wire_bytes, res.uplink_bytes)
    assert res.params.get("uplink_dtype") == "int8"
    assert np.array_equal(jres.wire_bytes, jres.uplink_bytes)
    assert res.wire_bytes_total == int(
        np.sum(res.wire_bytes) + np.sum(res.wire_meta_bytes))
    if algo in ("lloyd", "coreset_kmeans"):       # shapes alone
        np.testing.assert_array_equal(res.wire_bytes, jres.wire_bytes)
        np.testing.assert_array_equal(res.wire_meta_bytes,
                                      jres.wire_meta_bytes)


def test_int8_values_wire_measures_4x_model(parts):
    res = api.fit(parts, 5, epsilon=0.2, uplink_dtype="int8",
                  uplink_wire="values", device="cpu")
    assert np.array_equal(res.wire_bytes, 4 * res.uplink_bytes)
    assert res.params["uplink_wire"] == "values"
    f32 = api.fit(parts, 5, epsilon=0.2, device="cpu")
    assert np.array_equal(f32.wire_bytes, f32.uplink_bytes)


def test_uplink_knob_validation_through_fit(parts):
    with pytest.raises(ValueError, match="codes"):
        api.fit(parts, 5, uplink_wire="codes", epsilon=0.2, device="cpu")
    with pytest.raises(ValueError, match="uplink_dtype"):
        api.fit(parts, 5, uplink_dtype="float64", device="cpu")
    with pytest.raises(ValueError, match="uplink_wire"):
        api.fit(parts, 5, algo="eim11", uplink_wire="zip", device="cpu")
    res = api.fit(parts, 5, epsilon=0.2, uplink_dtype=torch.bfloat16,
                  device="cpu")
    assert res.params["uplink_dtype"] == "bfloat16"


@pytest.mark.parametrize("algo,dtype,kw", [
    ("kmeans_parallel", "int8", dict(rounds=2, lloyd_iters=5)),
    ("kmeans_parallel", "bfloat16", dict(rounds=2, lloyd_iters=5)),
    ("eim11", "int8", dict(epsilon=0.2, max_rounds=3)),
    ("coreset_kmeans", "bfloat16", dict(coreset_size=512)),
    ("kzmeans", "int8", dict(coreset_size=512, outlier_frac=0.02,
                             lloyd_iters=5))],
    ids=["kmeans_parallel_int8", "kmeans_parallel_bf16", "eim11_int8",
         "coreset_kmeans_bf16", "kzmeans_int8"])
def test_baselines_under_narrow_uplinks(parts, algo, dtype, kw):
    """The reference's rounds, uplink bytes at the dtype's width where
    they follow from shapes, and a cost within 15% of the reference's."""
    res = api.fit(parts, 5, algo=algo, uplink_dtype=dtype, seed=4,
                  device="cpu", **kw)
    jres = jfit(parts, 5, algo=algo, backend="virtual", uplink_dtype=dtype,
                seed=4, **kw)
    assert res.rounds == jres.rounds
    width = {"bfloat16": 2, "int8": 1}[dtype]
    np.testing.assert_array_equal(res.uplink_bytes,
                                  res.uplink_points * 4 * width)
    if algo in ("coreset_kmeans", "kzmeans"):
        np.testing.assert_array_equal(res.uplink_points, jres.uplink_points)
        np.testing.assert_array_equal(res.wire_bytes, jres.wire_bytes)
    if algo == "kmeans_parallel":     # the dense f32 scatter, as the ref's
        np.testing.assert_array_equal(res.wire_bytes, jres.wire_bytes)
    assert _cost(parts, res.centers) <= (1 + COST_RATIO_TOL) * float(
        jres.cost(jnp.asarray(parts.reshape(-1, 4))))


def test_kmeans_parallel_int8_payload_on_machine_grid(parts):
    """k-means‖ uploads its selections on each machine's int8 grid over
    its whole shard, as the reference quantizes ``x``: every oversampled
    row after the first choice is a row of the fake-quantized shards."""
    x = torch.from_numpy(parts)
    w = torch.ones(parts.shape[:2])
    l, cap, rows = kpar.buffer_rows(5, 2)
    centers, valid, _, nsel, _, _ = kpar.oversample(
        VirtualCluster(M), torch.Generator().manual_seed(0), x, w, 2, l, cap,
        rows, upload_dtype="int8")
    grid = fake_quantize_int8(x).reshape(-1, 4)
    picked = centers[valid][1:]
    assert picked.shape[0] == int(nsel.sum()) > 0
    assert bool((picked[:, None, :] == grid[None]).all(-1).any(-1).all())
    assert not bool((picked[:, None, :] == x.reshape(-1, 4)[None]).all(
        -1).any(-1).all())
