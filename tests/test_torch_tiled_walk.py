"""The tiled walk's launch shape (d > 16), decided on the host.

``min_dist``, the Lloyd step and ``remove_below`` walk d > 16 on the
tiled walk (``csrc/common.cuh::tiled_nearest``), and the seeding step
takes its tiles of points there (``csrc/fused_lloyd.cu::
tiled_seed_kernel``); ``kernels/walk.py`` and ``kernels/fused_lloyd.py``
decide its tiles, its points a thread, the column reduce's grid, the
seeding's per-tile partials and the scratch the Lloyd wrapper allocates,
and mirror the C constants and layout. Here, on the CPU: the rules at
d = 17, 37, 513, 1,536 and 7,168 (tiles >= 1 and under the grid limits),
the mirrors against the constants in the C sources, and the wrappers'
arguments to the C entry points (the launch recorded, not run: the
kernels run only on the card, ``tests/test_torch_cuda.py``).
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import build as tbuild
from repro_torch.kernels import fused_lloyd as tfused
from repro_torch.kernels import min_dist as tmin
from repro_torch.kernels import tuning
from repro_torch.kernels import walk as twalk

# xdist runs one worker per core: one intra-op thread a worker
torch.set_num_threads(1)

CSRC = Path(tfused.__file__).resolve().parent / "csrc"
WIDTHS = [17, 37, 513, 1_536, 7_168]
# (n, k): the embedding fits' coordinators (kimi-k2 and qwen2-1.5b), the
# smoke's WIDTH_SHAPES, ragged and tiny n, many centers, 10 M rows
SIZES = [(43_106, 78), (42_460, 78), (20_000, 300), (20_000, 190),
         (1_001, 81), (1, 1), (0, 5), (3_000, 4_096), (10_000_000, 1_111)]
GRID_X, GRID_YZ = 2 ** 31 - 1, 65_535
SMEM_MAX = 232_448              # bytes of shared memory a block (H100)


def _r8(b):
    return -(-b // 8) * 8


def _constexpr(source: str, name: str) -> str:
    text = (CSRC / source).read_text()
    m = re.search(rf"constexpr (?:int|long long) {name} = ([^;]+);", text)
    assert m, f"{name} not in {source}"
    return m.group(1)


def test_mirrors_match_the_c_constants():
    """walk.py's and fused_lloyd.py's constants are the C sources'."""
    threads = int(_constexpr("common.cuh", "kThreads"))
    ppt = int(_constexpr("common.cuh", "kTiledPPT"))
    cpt = int(_constexpr("common.cuh", "kTiledCPT"))
    assert _constexpr("common.cuh", "kTiledRows") == "kThreads / 16"
    assert twalk.TILED_PPT == ppt
    assert twalk.TILED_POINTS == threads // 16 * ppt
    assert twalk.TILED_CENTERS == 16 * cpt
    assert _constexpr("fused_assign.cu", "kColSlab") == "4 * kThreads"
    assert tfused.REDUCE_SLAB == 4 * threads
    assert tfused.REDUCE_RANGE == int(_constexpr("fused_assign.cu",
                                                 "kRangeCenters"))
    assert tfused.REDUCE_SPLIT_MIN == int(_constexpr("fused_assign.cu",
                                                     "kSplitMin"))
    # both sides route d > 16 to the tiled walk
    assert "if (d <= 16) return f((T*)nullptr, std::integral_constant<int, " \
        "16>());" in (CSRC / "common.cuh").read_text()
    assert "const bool tiled = d > 16;" in \
        (CSRC / "fused_assign.cu").read_text()
    assert not twalk.tiled(16) and twalk.tiled(17)
    # remove_below and the seeding step: by_width's d > 16 instance takes
    # the tiled kernels, the seeding's tiles the tiled walk's points
    fl = (CSRC / "fused_lloyd.cu").read_text()
    assert tbuild.BLOCK_POINTS == threads
    assert "return d <= 16 ? kThreads : kTilePoints;" in fl
    assert int(_constexpr("fused_lloyd.cu", "kSeedStages")) >= 2
    for entry, kernels in (
            ("rt_remove_below", ["tiled_remove_below_kernel<T>",
                                 "dim3((unsigned)tiled_tiles(p), "
                                 "(unsigned)m)"]),
            ("rt_update_min_dist", ["tiled_seed_kernel<T, false>",
                                    "tiled_update_kernel<T>",
                                    "(n + kTilePoints - 1) / kTilePoints"]),
            ("seed_steps", ["tiled_seed_kernel<T, true>",
                            "(n + kTilePoints - 1) / kTilePoints"])):
        body = fl[fl.index(f" {entry}("):]
        body = body[:body.index("\n}\n")]
        route = body[body.index("if constexpr (DR == 0)"):]
        for name in kernels:
            assert name in route, (entry, name)
    # the any-width instances are gone: no DR = 0 seeding kernel or walk,
    # and remove_below's register-blocked kernel only at P = 4
    assert "DR > 0 ? DR : d" not in fl
    assert "constexpr int P = 4;" in fl and "P = DR > 0 ? 4 : 2" not in fl


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("n,k", SIZES)
def test_tiled_rules(n, d, k):
    """At every width past 16: the walk's tiles cover n in tiles of
    TILED_POINTS (at least one) under the grid's x limit, one center
    slice, the tiled walk's points a thread; the column reduce's slabs
    cover the d + 1 columns, its even center ranges cover k, each at most
    REDUCE_RANGE centers in shared memory the block can take, its splits
    cover n under the grid's limits and bring the blocks to 4 an SM of
    132 unless a split would fall under REDUCE_SPLIT_MIN points; the
    scratch mirrors the C layout: the accumulators first, then the bound,
    the tile counters and cost partials, and the (n,) argmin."""
    assert twalk.tiled(d)
    tiles = twalk.tiled_tiles(n)
    assert tiles == max(-(-n // twalk.TILED_POINTS), 1)
    assert 1 <= tiles <= GRID_X
    assert tiles * twalk.TILED_POINTS >= n
    assert tfused.points_per_thread(k, d) == twalk.TILED_PPT
    assert tfused.launch_slices(n, k, d, 132, None, torch.float32) == 1
    slabs, ranges, kr, splits, split = tfused.reduce_grid(n, d, k, 132)
    assert (slabs - 1) * tfused.REDUCE_SLAB < d + 1 <= \
        slabs * tfused.REDUCE_SLAB
    assert 1 <= kr <= tfused.REDUCE_RANGE and ranges * kr >= k
    assert (ranges - 1) * kr < k
    assert kr * tfused.REDUCE_SLAB * 8 <= SMEM_MAX
    assert 1 <= slabs <= GRID_X and ranges <= GRID_YZ
    assert 1 <= splits <= GRID_YZ and splits * split >= n
    blocks = slabs * ranges * splits
    assert (blocks >= 4 * 132 or
            splits == max(-(-n // tfused.REDUCE_SPLIT_MIN), 1))
    acc = k * (d + 1) * 8
    assert tfused.scratch_bytes(n, d, k, twalk.TILED_PPT, 1) == (
        acc + 8 + 2 * _r8(tiles * 4) + _r8(n * 4))
    # the register-blocked layout at the same n is the tiled one less the
    # argmin and with its own tiles: the two share scratch_layout
    assert tfused.scratch_bytes(n, 0, k, 2, 1) == (
        k * 8 + 8 + 2 * _r8(twalk.point_tiles(n, 2) * 4))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("n,k", SIZES)
def test_removal_and_seeding_tiles(n, d, k):
    """Past 16 the seeding step's tiles are the tiled walk's (at least
    one), the draw-off wrapper's per-tile partials one a tile, and
    remove_below's grid (tiled_tiles(p), m) stays under the grid's limits
    for the n points split over m = 8 machines, or held by one."""
    tiles = tfused.seed_tiles(n, d)
    assert tiles == twalk.tiled_tiles(n)
    assert tiles * twalk.TILED_POINTS >= n and 1 <= tiles <= GRID_X
    for m in (1, 8):
        p = -(-n // m)
        assert 1 <= twalk.tiled_tiles(p) <= GRID_X and m <= GRID_YZ
        assert twalk.tiled_tiles(p) * twalk.TILED_POINTS >= p


class _Recorder:
    """Stands in for a CudaKernel: records the C call's arguments."""

    def __init__(self):
        self.args = None

    def __call__(self, *args, launches=1):
        self.args = args


@pytest.fixture
def on_card(monkeypatch):
    """The wrappers run on CPU tensors with their launch recorded."""
    for mod in (tmin, tfused):
        monkeypatch.setattr(mod, "check_on_card", lambda *a, **k: None)
        monkeypatch.setattr(mod, "stream_of", lambda t: None)
    monkeypatch.setattr(twalk, "sm_count", lambda device: 132)
    monkeypatch.setitem(tuning._STATE, "mode", "off")      # no card table
    rec = {"min_dist": _Recorder(), "fused": _Recorder()}
    monkeypatch.setattr(tmin, "MIN_DIST", rec["min_dist"])
    monkeypatch.setattr(tfused, "FUSED_ASSIGN_REDUCE", rec["fused"])
    for name in ("REMOVE_BELOW", "UPDATE_MIN_DIST", "KMEANS_PP",
                 "KMEANS_PP_STEP", "KMEANS_PP_STEP_AT"):
        rec[name] = _Recorder()
        monkeypatch.setattr(tfused, name, rec[name])
    return rec


@pytest.mark.parametrize("d,tiled", [(15, False), (16, False), (17, True),
                                     (513, True), (7_168, True)])
def test_wrappers_take_the_tiled_walk(on_card, d, tiled):
    """min_dist and the Lloyd step hand the C entry points the tiled
    walk's points a thread and one slice at d > 16 (no split scratch),
    and the register-blocked walk's shape at d <= 16; the Lloyd step's
    scratch is ``scratch_bytes``' at that shape."""
    n, k = 300, 90
    x = torch.zeros((n, d))
    c = torch.zeros((k, d))
    w = torch.ones(n)
    tmin.min_dist_cuda(x, c)
    args = on_card["min_dist"].args
    ppt, slices, scratch = args[7], args[8], args[9]
    assert (ppt, slices) == ((twalk.TILED_PPT, 1) if tiled
                             else (twalk.points_per_thread(d), 1))
    assert scratch is None
    tfused.fused_assign_reduce_cuda(x, w, c)
    args = on_card["fused"].args
    ppt, slices, mode, nbytes = args[8], args[9], args[10], args[13]
    want = twalk.TILED_PPT if tiled else tfused.points_per_thread(k, d)
    assert (ppt, slices) == (want, 1)
    assert mode == tfused.ACC_MODES[tfused.acc_mode(k, d)]
    assert nbytes == tfused.scratch_bytes(n, d, k, ppt, slices)
    if tiled:
        assert nbytes == (k * (d + 1) * 8 + 8 + 2 * _r8(
            twalk.tiled_tiles(n) * 4) + _r8(n * 4))


@pytest.mark.parametrize("d,tiled", [(15, False), (16, False), (17, True),
                                     (513, True), (7_168, True)])
def test_removal_and_seeding_take_the_tiled_walk(on_card, d, tiled):
    """remove_below and the four seeding wrappers hand their C entry
    points the points' width, on which the C side routes d > 16 to the
    tiled kernels (``test_mirrors_match_the_c_constants``), and the
    draw-off wrapper sizes its per-tile partials by the walk's tiles: the
    tiled walk's at d > 16, 256 rows a tile at d <= 16."""
    m, p, k = 2, 300, 3
    n = m * p
    assert twalk.tiled(d) == tiled
    x = torch.zeros((n, d))
    w = torch.ones(n)
    seed = torch.tensor([1, 2])
    tfused.remove_below_cuda(x.view(m, p, d), torch.zeros((k, d)),
                             torch.ones((m, p), dtype=torch.bool), 0.5)
    assert on_card["REMOVE_BELOW"].args[2:5] == (m, p, d)
    tfused.update_min_dist_cuda(x, w, torch.zeros((1, d)), torch.ones(n))
    args = on_card["UPDATE_MIN_DIST"].args
    assert args[2:4] == (n, d) and args[8] == 1
    assert args[11] == (twalk.tiled_tiles(n) if tiled
                        else -(-n // tbuild.BLOCK_POINTS))
    tfused.kmeans_plusplus_indices_cuda(x, w, 4, seed)
    assert on_card["KMEANS_PP"].args[2:4] == (n, d)
    tfused.kmeans_pp_step_cuda(x, w, torch.ones(n), torch.tensor(7), 1, seed)
    assert on_card["KMEANS_PP_STEP"].args[2:4] == (n, d)
    tfused.kmeans_pp_step_at_cuda(x[:p], w[:p], torch.ones(p),
                                  torch.zeros(d), 1, seed, p)
    assert on_card["KMEANS_PP_STEP_AT"].args[2:4] == (p, d)
