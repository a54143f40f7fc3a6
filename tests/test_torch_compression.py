"""The port's uplink compression against the JAX package, on the CPU: the
affine int8 code book and codes (bit for bit), the compressed gathers of
``core.comm``, the top-k error feedback, and the uplink dtype contract
(``core.sampling.quantize_uplink`` and the knob checks).

The reference's quantizer is called eagerly here: under ``jit`` XLA may
fuse the dequantization into one FMA, a last-bit difference that is not
the codes'.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comm as jcomm
from repro.core import sampling as jsamp
from repro.ft import compression as jcomp
from repro_torch.core import comm as tcomm
from repro_torch.core import sampling as tsamp
from repro_torch.ft import compression as tcomp

# xdist runs one worker per core: with torch's default of one intra-op
# thread per core in every worker, the pools contend and small ops run
# several times slower
torch.set_num_threads(1)

M = 4


def _blocks(shape=(M, 6, 3), seed=0, scale=1.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale + offset).astype(np.float32)


def _bits(a) -> np.ndarray:
    return np.atleast_1d(np.asarray(a)).view(np.uint8)


PAYLOADS = {
    "2d": _blocks((50, 3), seed=1),
    "machines": _blocks(seed=2),
    "one_constant_machine": np.concatenate(
        [_blocks((3, 6, 3), seed=3), np.full((1, 6, 3), 0.25, np.float32)]),
    "unit_cube_15": _blocks((8, 40, 15), seed=4, scale=0.3, offset=0.5),
    "wide_range": _blocks((2, 64, 5), seed=5, scale=1e4),
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_qparams_and_codes_equal_reference(name):
    """One code book a payload (2-d) or a machine (rank 3), the same
    (scale, zero point), the same codes and the same reconstruction, bit
    for bit."""
    x = PAYLOADS[name]
    js, jz = jcomp.affine_qparams(jnp.asarray(x))
    ts, tz = tcomp.affine_qparams(torch.from_numpy(x))
    assert np.array_equal(_bits(ts.numpy()), _bits(js))
    assert np.array_equal(_bits(tz.numpy()), _bits(jz))
    jq = jcomp.quantize_affine_int8(jnp.asarray(x), js, jz)
    tq = tcomp.quantize_affine_int8(torch.from_numpy(x), ts, tz)
    assert tq.dtype == torch.int8
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(
        _bits(tcomp.dequantize_affine_int8(tq, ts, tz).numpy()),
        _bits(jcomp.dequantize_affine_int8(jq, js, jz)))
    assert np.array_equal(
        _bits(tcomp.fake_quantize_int8(torch.from_numpy(x)).numpy()),
        _bits(jcomp.fake_quantize_int8(jnp.asarray(x))))


def test_round_half_to_even():
    """Codes round half to even, as ``jnp.round``: the payload [0, 255]
    has scale 1 and zero point 0, so x.5 lands on the even level."""
    x = np.asarray([[0.0, 0.5, 1.5, 2.5, 254.5, 255.0]], np.float32)
    codes = tcomp.quantize_affine_int8(torch.from_numpy(x),
                                       *tcomp.affine_qparams(
                                           torch.from_numpy(x)))
    assert (codes.numpy().astype(int) + 128).tolist() == [
        [0, 0, 2, 2, 254, 255]]


def test_concat_machines_compressed_matches_fake_quantize():
    """Per-machine code books: the gathered reconstruction is each
    machine's own fake-quantize, and the reference's gather, bit for
    bit; the wire holds 1-byte codes and 8 bytes of qparams a machine."""
    x = _blocks(seed=3)
    with tcomm.wire_tally() as t:
        out = tcomm.VirtualCluster(M).concat_machines_compressed(
            torch.from_numpy(x))
    expect = torch.stack([tcomp.fake_quantize_int8(torch.from_numpy(b))
                          for b in x]).reshape(-1, 3)
    assert torch.equal(out, expect)
    with jcomm.wire_tally() as jt:
        jout = jcomm.VirtualCluster(M).concat_machines_compressed(
            jnp.asarray(x))
    assert np.array_equal(_bits(out.numpy()), _bits(jout))
    assert (t.payload, t.meta) == (jt.payload, jt.meta) == (M * 6 * 3,
                                                            8 * M)


@pytest.mark.parametrize("counts", [[2, 0, 3, 1], [0, 0, 4, 0]],
                         ids=["zero_row_machine", "all_dead_but_one"])
def test_gather_ragged_compressed_zero_rows(counts):
    """The codes wire packs like the plain gather (machines with count 0
    contribute nothing, the tail is exactly 0) and reconstructs each
    machine's rows on its own grid; bits and bytes equal the
    reference's."""
    x = _blocks()
    c = np.asarray(counts, np.int32)
    with tcomm.wire_tally() as t:
        out = tcomm.VirtualCluster(M).gather_ragged_compressed(
            torch.from_numpy(x), torch.from_numpy(c), 8).numpy()
    fq = np.stack([tcomp.fake_quantize_int8(torch.from_numpy(b)).numpy()
                   for b in x])
    expect = np.concatenate([fq[j, :c[j]] for j in range(M)])
    assert np.array_equal(out[:len(expect)], expect)
    assert np.all(out[len(expect):] == 0)
    with jcomm.wire_tally() as jt:
        jout = jcomm.VirtualCluster(M).gather_ragged_compressed(
            jnp.asarray(x), jnp.asarray(c), 8)
    assert np.array_equal(_bits(out), _bits(jout))
    assert (t.payload, t.meta, t.row_bytes) == (jt.payload, jt.meta,
                                                jt.row_bytes) == (
        0, 4 * M + 8 * M, 3)


def test_compressed_needs_machine_axis():
    comm = tcomm.VirtualCluster(M)
    with pytest.raises(ValueError, match="code book"):
        comm.all_machines_compressed(torch.ones((M, 5)))
    with pytest.raises(ValueError, match="blocks"):
        comm.gather_ragged_compressed(torch.ones((M, 5)),
                                      torch.ones((M,), dtype=torch.int32), 5)


@pytest.mark.parametrize("dtype,itemsize", [(torch.float32, 4),
                                            (torch.bfloat16, 2)],
                         ids=["f32", "bf16"])
def test_compressed_psum_modeled_equals_tallied(dtype, itemsize):
    """One source of truth: the bytes ``compressed_psum`` returns are what
    its wire records, k (value, int32 index) pairs a machine, at the
    gradient's width (``topk_wire_bytes``, the reference's number)."""
    comm = tcomm.VirtualCluster(M)
    g = torch.from_numpy(_blocks((M, 32), seed=1)).to(dtype)
    with tcomm.wire_tally() as t:
        _, _, nbytes = tcomp.compressed_psum(
            comm, g, tcomp.init_error_feedback(g), k=8)
    assert isinstance(nbytes, int)
    assert nbytes == t.payload == M * 8 * (itemsize + 4)
    assert nbytes == jcomp.topk_wire_bytes(
        M, 8, jnp.float32 if dtype == torch.float32 else jnp.bfloat16)


def test_compressed_psum_matches_reference():
    """Without ties the top-k entries, the sparse mean and the new error
    feedback equal the reference's."""
    comm = tcomm.VirtualCluster(M)
    g, err = _blocks((M, 32), seed=6), _blocks((M, 32), seed=7, scale=0.1)
    t_mean, t_err, _ = tcomp.compressed_psum(
        comm, torch.from_numpy(g), torch.from_numpy(err), k=5)
    j_mean, j_err, _ = jcomp.compressed_psum(
        jcomm.VirtualCluster(M), jnp.asarray(g), jnp.asarray(err), k=5)
    np.testing.assert_allclose(t_mean.numpy(), np.asarray(j_mean),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(t_err.numpy(), np.asarray(j_err))
    vals, idx = tcomp.topk_compress(torch.from_numpy(g[0]), 5)
    jv, ji = jcomp.topk_compress(jnp.asarray(g[0]), 5)
    assert idx.dtype == torch.int32
    assert sorted(idx.tolist()) == sorted(np.asarray(ji).tolist())
    assert sorted(vals.tolist()) == sorted(np.asarray(jv).tolist())


def test_topk_compression_converges():
    """EF top-k SGD on a quadratic reaches the optimum (tests/test_ft.py's
    claim)."""
    m, dim = 4, 64
    rng = np.random.default_rng(0)
    target = torch.from_numpy(rng.normal(size=(dim,)).astype(np.float32))
    offsets = torch.from_numpy((rng.normal(size=(m, dim)) * 0.1).astype(
        np.float32))
    comm = tcomm.VirtualCluster(m)
    x = torch.zeros((dim,))
    err = tcomp.init_error_feedback(torch.zeros((m, dim)))
    opt = target - offsets.mean(dim=0)
    dist = []
    for step in range(700):
        mean_g, err, nbytes = tcomp.compressed_psum(
            comm, 2 * (x - target + offsets), err, k=8)
        x = x - 0.05 * mean_g
        if step in (99, 699):
            dist.append(float(torch.linalg.norm(x - opt)))
    assert dist[-1] < 0.1 and dist[-1] < dist[0], dist
    assert nbytes == m * 8 * 8


@pytest.mark.parametrize("dtype", tsamp.UPLINK_DTYPES)
def test_quantize_uplink_every_dtype_exact(dtype):
    """quantize_uplink gives the reference's values bit for bit, in the
    storage dtype (the dtype itself, float32 for int8)."""
    x = _blocks((M, 20, 15), seed=8, scale=0.3, offset=0.5)
    got = tsamp.quantize_uplink(torch.from_numpy(x), dtype)
    want = jsamp.quantize_uplink(jnp.asarray(x), dtype)
    assert got.dtype == tsamp.uplink_storage_dtype(dtype)
    assert str(got.dtype).removeprefix("torch.") == \
        jsamp.uplink_storage_dtype(dtype)
    assert np.array_equal(_bits(got.float().numpy()),
                          _bits(np.asarray(want, np.float32)))


def test_uplink_knob_validation():
    """The reference's contract: "auto" is "codes" for int8 only, "codes"
    needs int8, dtypes are named or given as a torch dtype."""
    check = tsamp.check_uplink_wire
    assert check("auto", "int8") == "codes"
    assert check("auto", "float32") == "values"
    assert check("codes", "int8") == "codes"
    assert check("values", "int8") == "values"
    with pytest.raises(ValueError, match="codes"):
        check("codes", "float32")
    with pytest.raises(ValueError, match="uplink_wire"):
        check("zip", "int8")
    assert tsamp.check_uplink_dtype(torch.bfloat16) == "bfloat16"
    assert tsamp.check_uplink_dtype("int8") == "int8"
    with pytest.raises(ValueError, match="uplink_dtype"):
        tsamp.check_uplink_dtype("float64")


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_draw_global_sample_codes_and_narrow_payloads(dtype):
    """``wire=`` changes the bytes, never the statistics: int8 codes
    reconstruct the values-wire payload bit for bit (same mask, same
    per-machine qparams); a float payload arrives in its own dtype,
    equal to the float32 draw rounded, at its width on the wire."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(M, 32, 3)).astype(np.float32))
    w = torch.ones((M, 32))
    alive = torch.from_numpy(rng.random((M, 32)) < 0.8)
    n_vec = alive.sum(dim=1, dtype=torch.int32)
    comm = tcomm.VirtualCluster(M)
    out = {}
    for wire in (("codes", "values") if dtype == "int8" else ("values",)):
        with tcomm.wire_tally() as t:
            out[wire] = tsamp.draw_global_sample(
                comm, torch.Generator().manual_seed(0), x, w, alive, n_vec,
                24, 16, upload_dtype=dtype, wire=wire) + (t,)
    with tcomm.wire_tally():
        p32, w32, r32 = tsamp.draw_global_sample(
            comm, torch.Generator().manual_seed(0), x, w, alive, n_vec, 24,
            16)
    pts, wts, real, t = out["values"]
    assert int(real) == int(r32) == 24
    assert torch.equal(wts, w32)
    if dtype == "int8":
        cp, cw, cr, ct = out["codes"]
        assert pts.dtype == cp.dtype == torch.float32
        assert torch.equal(cp, pts) and torch.equal(cw, wts)
        assert (ct.row_bytes, t.row_bytes) == (3, 12)
    else:
        assert pts.dtype == torch.bfloat16
        assert torch.equal(pts, p32.to(torch.bfloat16))
        assert t.row_bytes == 3 * 2

