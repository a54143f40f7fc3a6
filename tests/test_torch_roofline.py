"""The port's roofline (``repro_torch.roofline``) and dry runs
(``repro_torch.launch.dryrun``, ``cluster_dryrun``) on the CPU.

The counterpart of ``tests/test_roofline.py``: FLOPs of a matmul exact, a
loop of T matmuls counted T times (the port's eager trace dispatches a
loop body once a trip, where the reference multiplies a while body by
its trip count), bytes that scale with the trips, and collectives
counted by kind with their result bytes on a fake process group. The
analytic ``model_flops_for`` and the ``Roofline`` record are held to the
reference's. One LM dry-run cell and a small SOCCER cluster dry run run
end to end. The fake group lives in this process only for the test that
starts it.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.roofline import analysis as janalysis
from repro_torch.configs import ASSIGNED_ARCHS, get_config, get_shape
from repro_torch.roofline import analysis, hw
from repro_torch.roofline.op_stats import op_stats

torch.set_num_threads(1)


@pytest.fixture
def fake_group():
    from repro_torch.launch.mesh import fake_process_group
    assert not dist.is_initialized()
    fake_process_group(8)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_match_reference(arch):
    for name in JSHAPES:
        assert analysis.model_flops_for(get_config(arch), get_shape(name)) \
            == janalysis.model_flops_for(jget_config(arch), JSHAPES[name])


def test_roofline_record_has_the_reference_keys():
    kw = dict(flops=2e12, hbm_bytes=1e11, coll_bytes=3e9,
              coll_by_kind={"all-gather": 3e9}, model_flops=1e14, chips=64)
    got = analysis.Roofline(**kw).as_dict()
    want = janalysis.Roofline(**kw).as_dict()
    assert list(got) == list(want)
    assert [f.name for f in dataclasses.fields(analysis.Roofline)] == \
        [f.name for f in dataclasses.fields(janalysis.Roofline)]
    # the H100's peaks in place of the v5e's
    assert got["t_compute_s"] == 2e12 / 989e12
    assert got["t_memory_s"] == 1e11 / 3.35e12
    assert got["t_collective_s"] == 3e9 / hw.LINK_BW
    assert got["bottleneck"] == "collective"


def test_matmul_flops_exact():
    a, b = torch.zeros(64, 32), torch.zeros(32, 16)
    with op_stats() as st:
        a @ b
    assert st.flops == 2 * 64 * 32 * 16
    assert st.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4


def test_loop_counts_every_trip():
    ws = torch.zeros(8, 16, 16)
    with op_stats() as st:
        x = torch.eye(16)
        for w in ws:
            x = x @ w
    assert st.flops == 8 * 2 * 16 * 16 * 16


def test_bytes_scale_with_trips():
    xs = torch.zeros(4, 256, 256)
    with op_stats() as st:
        c = torch.zeros(256, 256)
        for x in xs:
            c = c + 2 * x
    assert st.bytes >= 4 * 256 * 256 * 4


def test_collectives_counted_by_kind(fake_group):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.sharding.activations import axis_group
    mesh = build_mesh((4, 2))
    g = axis_group(mesh, "data")
    with FakeTensorMode(), op_stats() as st:
        x = torch.zeros(1024, 64)
        dist.all_reduce(x, group=g)
        out = torch.empty(4 * 1024, 64)
        dist.all_gather_into_tensor(out, x, group=g)
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=g)
    assert st.coll == {"all-reduce": 1024 * 64 * 4,
                       "all-gather": 4 * 1024 * 64 * 4,
                       "all-to-all": 1024 * 64 * 4}
    assert st.coll_ops == {"all-reduce": 1, "all-gather": 1,
                           "all-to-all": 1}
    assert st.coll_total == 6 * 1024 * 64 * 4


def test_lm_dry_run_cell(tmp_path):
    """xlstm-125m's decode cell on the 16 x 16 fake mesh: status ok, the
    parameters' bytes a device are the Partitioner's arithmetic, and the
    useful share of the counted FLOPs is in (0, 1]."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.input_specs import make_partitioner, param_structs
    from repro_torch.sharding.partition import shard_bytes
    try:
        rec = dryrun.run_cell("xlstm-125m", "decode_32k", "single")
        path = dryrun.save(rec, tmp_path)
    finally:
        dist.destroy_process_group()
    assert rec["status"] == "ok", rec.get("traceback")
    assert path.exists()
    cfg = get_config("xlstm-125m")
    sizes = {"data": 16, "model": 16}

    class Mesh:
        axis_names = ("data", "model")
        devices = np.empty((16, 16), dtype=object)

    part = make_partitioner(Mesh(), cfg)
    params = param_structs(cfg)
    specs = part.specs(((n, p.shape) for n, p in params.items()), cfg)
    want = sum(shard_bytes(p.shape, p.element_size(), specs[n], sizes)
               for n, p in params.items())
    assert rec["memory"]["param_bytes"] == want
    assert rec["memory"]["argument_bytes"] > want
    r = rec["roofline"]
    assert 0 < r["useful_flops_frac"] <= 1
    assert r["chips"] == 256 and r["flops_per_dev"] > 0
    assert rec["memory"]["peak_per_device"] > 0


def test_cluster_dry_run_small():
    """SOCCER at m = 16: its per-round wire bytes sum to the fit's
    ClusterResult's, which a plain fit at the same seed repeats, and the
    removal pass's operations are the model's removal term."""
    from repro_torch.api import fit
    from repro_torch.configs.soccer_paper import GaussianMixtureSpec
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.launch import cluster_dryrun
    n, k, m = 320_000, 5, 16
    for mode in ("gather", "sharded"):
        rec = cluster_dryrun.run(mode, False, n=n, k=k, machines=m,
                                 device="cpu", save=False)
        assert rec["status"] == "ok" and rec["rounds"] >= 1
        assert sum(rec["wire_bytes_by_round"]) == rec["wire_bytes_total"]
        x, _, _ = gaussian_mixture(GaussianMixtureSpec(n=n, dim=15, k=k,
                                                       seed=17))
        res = fit(x, k, algo="soccer", m=m, device="cpu", epsilon=0.1,
                  sharded_coordinator=mode == "sharded")
        assert res.wire_bytes_total == rec["wire_bytes_total"]
        eta = rec["const"]["eta"]
        for up in rec["uplink_points_by_round"][:rec["rounds"]]:
            assert up <= 2 * eta + m
        assert rec["kernel_calls_round1"]["remove_below"] == 1
        r = rec["roofline"]
        assert r["chips"] == m and r["flops_per_dev"] > 0
        assert r["coll_bytes_per_dev"] == rec["wire_bytes_by_round"][0]
