"""The walk's tuned center split (``kernels/tuning.py``,
``kernels/autotune.py``): the reference's ``tests/test_autotune.py``
ported to the port's key (width variant, k bucket, dtype) and pair
(``min_slice``, ``fill_per_sm``), plus the ``force`` miss and the rule's
ties, and the launch shapes with no table.

The sweep is driven by a fake timer that never calls its function (no
card, no clock): the wanted candidate wins, and the assertions check
that exactly it comes back out of ``tuning.split_params`` and
``walk.slices_for_tiles`` after the JSON round trip. The card is a
stand-in name and SM count (``tuning.card_of`` is patched), and both
table paths point into the test's tmp dir.
"""
import json

import pytest
import torch

from repro_torch.kernels import autotune, tuning, walk

torch.set_num_threads(1)

CARD = ("Test Card 80GB", 132)
OTHER = ("Test Card 80GB", 114)
# a shape where the split decides: 2 point tiles against 4,096 centers
SHAPE = ("t", 2_048, 4_096, 15)
WANT = (256, 1)       # the first pair of its launch shape (16 slices)


def wanted_timer(fn, meta):
    """The wanted candidate 1 ms, every other pair 2 ms; never calls
    fn."""
    del fn
    return 1.0 if (meta["min_slice"], meta["fill_per_sm"]) == WANT else 2.0


@pytest.fixture
def tuned(tmp_path, monkeypatch):
    """Both tables in tmp, the stand-in card, cached mode, nothing read."""
    monkeypatch.setattr(tuning, "cache_table_path",
                        lambda card: tmp_path / f"cache_{card[1]}.json")
    monkeypatch.setattr(tuning, "package_table_path",
                        lambda card: tmp_path / f"pkg_{card[1]}.json")
    monkeypatch.setattr(tuning, "card_of", lambda device: CARD)
    monkeypatch.setitem(tuning._STATE, "mode", "cached")
    tuning.invalidate()
    yield tmp_path
    tuning.invalidate()


def _sweep(timer=wanted_timer, shapes=(SHAPE,)):
    return autotune.sweep(quick=True, shapes=shapes, timer=timer,
                          device="cpu", card=CARD)


def _slices(pair=None):
    """walk's slices at SHAPE on the card, by lookup (or at ``pair``)."""
    _, n, k, d = SHAPE
    tiles = walk.point_tiles(n, walk.points_per_thread(d))
    if pair is not None:
        with tuning.candidate(pair):
            return walk.slices_for_tiles(tiles, k, CARD[1], device="cuda")
    return walk.slices_for_tiles(tiles, k, CARD[1], device="cuda", d=d,
                                 dtype=torch.float32)


def _write(path, card, entries):
    path.write_text(json.dumps({"card": card[0], "sms": card[1],
                                "entries": entries}))
    tuning.invalidate()


def _entry(pair):
    return {"min_slice": pair[0], "fill_per_sm": pair[1], "ms": 1.0}


KEY = tuning.key(SHAPE[3], SHAPE[2], torch.float32)


def test_sweep_cache_roundtrip(tuned):
    """sweep -> save_table -> split_params returns the measured winner;
    a key the sweep did not measure keeps the rule."""
    payload = _sweep()
    assert (payload["card"], payload["sms"]) == CARD
    entry = payload["entries"][KEY]
    assert (entry["min_slice"], entry["fill_per_sm"]) == WANT
    assert entry["ms"] == 2.0 and entry["rule_ms"] == 4.0   # two kernels
    autotune.save_table(payload, tuning.cache_table_path(CARD))
    assert tuning.split_params("cuda", 15, 4_096, torch.float32) == WANT
    assert _slices() == _slices(WANT) != _slices(tuning.rule())
    # another dtype, width and k bucket: not measured
    assert tuning.split_params("cuda", 15, 4_096, torch.bfloat16) == \
        tuning.rule()
    assert tuning.split_params("cuda", 64, 4_096, torch.float32) == \
        tuning.rule()
    assert tuning.split_params("cuda", 15, 200_000, torch.float32) == \
        tuning.rule()


def test_tuning_off_ignores_table(tuned):
    autotune.save_table(_sweep(), tuning.cache_table_path(CARD))
    tuning.set_mode("off")
    before = tuning.TUNE_COUNTS["rule_only"]
    assert tuning.split_params("cuda", 15, 4_096, torch.float32) == \
        tuning.rule()
    assert _slices() == _slices(tuning.rule())
    assert tuning.TUNE_COUNTS["rule_only"] == before + 2
    with pytest.raises(ValueError, match="tuning mode"):
        tuning.set_mode("bogus")


def test_user_cache_overrides_package_table(tuned):
    """The user cache's entry shadows the committed package table's."""
    _write(tuning.package_table_path(CARD), CARD, {KEY: _entry((512, 8))})
    assert tuning.split_params("cuda", 15, 4_096, torch.float32) == (512, 8)
    _write(tuning.cache_table_path(CARD), CARD, {KEY: _entry((128, 2))})
    assert tuning.split_params("cuda", 15, 4_096, torch.float32) == (128, 2)


@pytest.mark.parametrize("card", [OTHER, ("Another Card", CARD[1])])
def test_other_card_table_never_consulted(tuned, card):
    """A table measured on another card (another name or SM count) does
    not leak in, even at this card's path."""
    _write(tuning.cache_table_path(CARD), card, {KEY: _entry((128, 8))})
    before = tuning.TUNE_COUNTS["measured_miss"]
    assert tuning.split_params("cuda", 15, 4_096, torch.float32) == \
        tuning.rule()
    assert tuning.TUNE_COUNTS["measured_miss"] == before + 1


def test_measured_pairs_normalized(tuned):
    """A hand-edited entry comes out normalized, and one that holds no
    pair is a miss."""
    _write(tuning.cache_table_path(CARD), CARD,
           {KEY: {"min_slice": 0, "fill_per_sm": 1000.7},
            tuning.key(15, 4_096, torch.float16): {"min_slice": "x"}})
    got = tuning.split_params("cuda", 15, 4_096, torch.float32)
    assert got == (1, tuning.MAX_FILL) == tuning.normalize(*got)
    s = _slices()
    assert 1 <= s <= SHAPE[2] and s < 65_536
    assert tuning.split_params("cuda", 15, 4_096, torch.float16) == \
        tuning.rule()


def test_scratch_feasibility_filter(monkeypatch):
    """Candidates whose split scratch exceeds the budget are skipped, and
    what the sweep keeps fits it."""
    _, n, k, d = SHAPE
    sizes = {autotune.scratch_bytes(n, k, d, CARD[1], (m, f))
             for m in autotune.CANDIDATE_MIN_SLICE
             for f in autotune.CANDIDATE_FILL}
    budget = sorted(sizes)[len(sizes) // 2]
    monkeypatch.setattr(autotune, "SCRATCH_BUDGET", budget)
    payload = _sweep(timer=lambda fn, meta: (
        0.5 if meta["what"] == "candidate" else 1.0))
    rec = payload["keys"][KEY]
    assert rec["skipped"] > 0
    for e in payload["entries"].values():
        assert autotune.scratch_bytes(n, k, d, CARD[1], (
            e["min_slice"], e["fill_per_sm"])) <= budget


@pytest.mark.parametrize("pair,want", [
    ((512, 4), (512, 4)),                 # the rule's
    ((0, 4), (1, 4)),                     # a slice holds >= 1 center
    ((-7, -1), (1, 1)),                   # negatives come up to 1
    ((300.9, 2.5), (300, 2)),             # floats floor to integers
    ((1, tuning.MAX_FILL + 1), (1, tuning.MAX_FILL)),
    ((10 ** 9, 10 ** 9), (10 ** 9, tuning.MAX_FILL)),
    ((1, 1), (1, 1)),
])
def test_normalize_edges(pair, want):
    got = tuning.normalize(*pair)
    assert got == want
    assert tuning.normalize(*got) == got           # idempotent


def test_candidates_roundtrip():
    """Every candidate the sweep can time survives normalize unchanged,
    and the rule's pair is among them."""
    pairs = [(m, f) for m in autotune.CANDIDATE_MIN_SLICE
             for f in autotune.CANDIDATE_FILL]
    assert tuning.rule() in pairs
    for p in pairs:
        assert tuning.normalize(*p) == p


def test_force_sweeps_once_on_a_miss(tuned, monkeypatch):
    """``force``: the first miss runs the quick sweep into the user cache
    and uses it; later lookups read it, with no second sweep."""
    calls, real = [], autotune.sweep

    def sweep(**kw):
        calls.append(kw)
        return real(quick=True, shapes=(SHAPE,), timer=wanted_timer,
                    device="cpu", card=CARD)

    monkeypatch.setattr(autotune, "sweep", sweep)
    monkeypatch.setattr(autotune, "_ENSURED", set())
    tuning.set_mode("force")
    try:
        assert tuning.split_params("cuda", 15, 4_096, torch.float32) == WANT
        assert tuning.split_params("cuda", 15, 4_096, torch.float32) == WANT
        # a key the sweep has no entry for misses without sweeping again
        assert tuning.split_params("cuda", 64, 4_096, torch.float32) == \
            tuning.rule()
    finally:
        tuning.set_mode("cached")
    assert len(calls) == 1 and calls[0]["quick"]
    assert tuning.cache_table_path(CARD).exists()


@pytest.mark.parametrize("cand_ms", [1.0, 2.0, 0.95])
def test_sweep_writes_no_entry_where_the_rule_wins_or_ties(cand_ms):
    """The rule's three timings 0.95, 1.0 and 1.0 ms (a spread of 0.05):
    a candidate that ties, loses or wins by less than the spread gets no
    entry."""
    rule_times = iter([0.5, 0.45, 0.5, 0.5, 0.5, 0.5])

    def timer(fn, meta):
        if meta["what"].startswith("rule"):
            return next(rule_times)
        return cand_ms / 2
    rec = _sweep(timer=timer)
    assert rec["entries"] == {}
    assert rec["keys"][KEY]["best"] is not None
    assert rec["keys"][KEY]["spread_ms"] == pytest.approx(0.05)


def test_rule_without_a_table_is_the_constant_rule(tuned):
    """With no table, every launch shape is the rule's, which is the
    constant rule (``device=None``) at every (tiles, k), and the values
    the walk's tests pin: EIM11's 64 tiles against 173,256 centers take
    10 slices."""
    assert walk.slices_for_tiles(64, 173_256, 132, device="cuda", d=15,
                                 dtype=torch.float32) == 10
    assert walk.center_slices(65_536, 173_256, 132, 4, device="cuda",
                              d=15) == 10
    assert walk.center_slices(991_418, 1_111, 132, 4, device="cuda",
                              d=15) == 1
    assert walk.center_slices(3_000, 2_100, 132, 4, device="cuda",
                              d=15) == 4
    assert walk.center_slices(125_000, 1_111, 132, 4, device="cuda",
                              d=15) == 2
    for tiles in (1, 2, 13, 64, 123, 527, 528, 984):
        for k in (25, 1_023, 1_024, 1_111, 2_100, 4_096, 86_628, 173_256):
            for d, dtype in ((15, torch.float32), (1_536, torch.bfloat16)):
                assert walk.slices_for_tiles(
                    tiles, k, 132, device="cuda", d=d, dtype=dtype) == \
                    walk.slices_for_tiles(tiles, k, 132)


def test_sweep_keys_are_the_cells_own():
    """EIM11's weighing and sample, the smoke's split and SOCCER
    k = 1000's centers each have a key of their own, and at each some
    candidate splits where the rule does not or splits otherwise."""
    keys = [tuning.key(d, k, torch.float32) for _, _, k, d in
            autotune.SHAPES]
    assert len(set(keys)) == len(keys)
    for _, n, k, d in autotune.SHAPES:
        rule = autotune.launch_slices(n, k, d, 132, tuning.rule())
        assert any(autotune.launch_slices(n, k, d, 132, (m, f)) != rule
                   for m in autotune.CANDIDATE_MIN_SLICE
                   for f in autotune.CANDIDATE_FILL)


def test_cli_needs_the_card(capsys):
    """The sweep CLI times kernels on a card: without CUDA it says so
    and returns 2, writing nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would sweep it")
    assert autotune.main(["--quick", "--mode", "off"]) == 2
    assert "CUDA card" in capsys.readouterr().err
