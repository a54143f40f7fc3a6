"""Machine failures and stragglers in the port, on the CPU, against the
JAX package: ``ft.failures`` on the same arrays (exact), the
``FailurePlan`` validation, the facade's round-0 mask and ``on_round``
hook, and the claims of tests/test_ft.py:26-143 on its own mixture.

The random streams differ between the packages, so the randomized runs
are held to the reference's outcomes; what depends on the data alone
(the live counts of round 0, the masks) is held exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import fit as jfit
from repro.configs.soccer_paper import SoccerParams as JParams
from repro.core import soccer as jsoc
from repro.ft import failures as jft
from repro_torch import api
from repro_torch.configs.soccer_paper import GaussianMixtureSpec, SoccerParams
from repro_torch.core import soccer as tsoc
from repro_torch.core.comm import VirtualCluster
from repro_torch.core.metrics import centralized_cost
from repro_torch.data.synthetic import gaussian_mixture, shard_points
from repro_torch.ft import failures as tft
from repro_torch.ft.failures import FailurePlan

# xdist runs one worker per core: with torch's default of one intra-op
# thread per core in every worker, the pools contend and small ops run
# several times slower
torch.set_num_threads(1)

M = 8


@pytest.fixture(scope="module")
def data():
    """tests/test_ft.py's mixture."""
    x, _, means = gaussian_mixture(GaussianMixtureSpec(
        n=12_000, dim=10, k=6, sigma=0.001, seed=6))
    return x, means


def _cost(x, centers) -> float:
    return float(centralized_cost(torch.from_numpy(np.asarray(x)),
                                  torch.from_numpy(np.asarray(centers))))


def _states(m=M, p=50, d=3, seed=0):
    """The same (m, p, d) state in both packages, with a ragged alive."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, p, d)).astype(np.float32)
    w = rng.random((m, p)).astype(np.float32)
    alive = rng.random((m, p)) < 0.7
    params = SoccerParams(k=3, epsilon=0.2)
    tconst = tsoc.derive_constants(m * p, p, params)
    ts = tsoc.init_state(torch.from_numpy(x), tconst,
                         torch.Generator().manual_seed(0),
                         w=torch.from_numpy(w), alive=torch.from_numpy(alive))
    jconst = jsoc.derive_constants(m * p, p, JParams(k=3, epsilon=0.2))
    js = jsoc.init_state(jnp.asarray(x), jconst, jax.random.PRNGKey(0),
                         w=jnp.asarray(w), alive=jnp.asarray(alive))
    return ts, js


def test_fail_machines_and_surviving_fraction_match_reference():
    ts, js = _states()
    ts, js = tft.fail_machines(ts, [2, 5]), jft.fail_machines(js, [2, 5])
    np.testing.assert_array_equal(ts.machine_ok.numpy(),
                                  np.asarray(js.machine_ok))
    assert tft.surviving_fraction(ts) == jft.surviving_fraction(js)
    ts = tft.fail_machines(ts, [5, 7])
    assert ts.machine_ok.tolist() == [True, True, False, True, True, False,
                                      True, False]


@pytest.mark.parametrize("m_new", [3, 8, 16])
def test_reshard_state_matches_reference(m_new):
    """Elastic restore keeps the global point order and pads with removed
    slots, the reference's layout exactly; every new machine is ok."""
    ts, js = _states()
    ts = tft.fail_machines(ts, [1])
    js = jft.fail_machines(js, [1])
    tr, jr = tft.reshard_state(ts, m_new), jft.reshard_state(js, m_new)
    for name in ("x", "w", "alive", "machine_ok"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)), name)
    assert tr.x.dtype == torch.float32 and tr.alive.dtype == torch.bool


@pytest.mark.parametrize("kw,match", [
    (dict(straggler_rate=1.0), "straggler_rate"),
    (dict(straggler_rate=-0.1), "straggler_rate"),
    (dict(fail_at={-1: (0,)}), "fail_at"),
    (dict(fail_at={2: ()}), "fail_at")],
    ids=["rate_one", "rate_negative", "negative_round", "empty_ids"])
def test_failure_plan_validation(kw, match):
    """The reference's checks, message for message."""
    with pytest.raises(ValueError, match=match):
        jft.FailurePlan(**kw)
    with pytest.raises(ValueError, match=match):
        FailurePlan(**kw)


def test_failure_plan_hooks():
    """``initial_failures`` is round 0; ``on_round`` kills a round's
    machines and leaves other rounds alone; ``chain`` applies the
    failures before the user's hook and keeps its returned state."""
    ts, _ = _states()
    plan = FailurePlan(fail_at={0: (4,), 2: (1, 6)})
    assert plan.initial_failures() == (4,)
    assert FailurePlan().initial_failures() == ()
    assert plan.on_round(1, ts) is ts
    assert plan.on_round(2, ts).machine_ok.tolist() == [
        True, False, True, True, True, True, False, True]
    seen = []
    hook = plan.chain(lambda r, s: seen.append((r, s.machine_ok.tolist())))
    out = hook(2, ts)
    assert seen == [(2, out.machine_ok.tolist())]
    assert not out.machine_ok[1] and plan.chain(None) == plan.on_round


def test_failure_plan_round0_masks_shards(data):
    """Round-0 failures are applied before the first round: the dead
    machines' mass is out of every count the coordinator sees, so
    n_hist[0] is exactly the survivors' points, as in the reference."""
    x, _ = data
    plan = FailurePlan(fail_at={0: (1, 3, 6)})
    res = api.fit(x, 6, m=M, epsilon=0.1, seed=0, failure_plan=plan,
                  device="cpu")
    jres = jfit(x, 6, algo="soccer", backend="virtual", m=M, epsilon=0.1,
                seed=0, failure_plan=jft.FailurePlan(fail_at={0: (1, 3, 6)}))
    assert int(res.n_hist[0]) == int(jres.n_hist[0]) == x.shape[0] - 3 * 1500
    assert not res.extra["state"].alive[[1, 3, 6]].any()
    assert res.params["failure_plan"] is plan
    assert "on_round" not in res.params


def test_failure_plan_validation_through_fit(data):
    x = np.zeros((256, 3), np.float32)
    with pytest.raises(TypeError, match="failure_plan"):
        api.fit(x, 2, algo="kmeans_parallel", m=4, rounds=1, device="cpu",
                failure_plan=FailurePlan(fail_at={1: (0,)}))
    with pytest.raises(ValueError, match="m=4"):
        api.fit(x, 2, m=4, device="cpu",
                failure_plan=FailurePlan(fail_at={0: (7,)}))
    with pytest.raises(TypeError, match="FailurePlan"):
        api.fit(x, 2, m=4, device="cpu", failure_plan=object())


def test_machine_failure_graceful(data):
    """Kill 2 of 8 machines before the run: cost degrades gracefully, not
    catastrophically (tests/test_ft.py:26)."""
    x, means = data
    parts = shard_points(x, M)
    params = SoccerParams(k=6, epsilon=0.1)
    ok = tsoc.run_soccer(parts, params, device="cpu")
    const = tsoc.derive_constants(x.shape[0], parts.shape[1], params)
    comm = VirtualCluster(M)
    state = tsoc.init_state(torch.from_numpy(parts), const,
                            torch.Generator().manual_seed(0))
    state = tft.fail_machines(state, [2, 5])
    assert tft.surviving_fraction(state) == 0.75
    rounds = 0
    n_rem = int(torch.sum(state.alive & state.machine_ok[:, None]))
    while rounds < const.max_rounds and n_rem > const.eta:
        state = tsoc.soccer_round(state, comm, const)
        n_rem = int(state.n_remaining)
        rounds += 1
    state = tsoc.soccer_finalize(state, comm, const)
    cost_fail = _cost(x, tsoc.flatten_centers(state))
    assert cost_fail <= 4.0 * max(_cost(x, ok.centers), _cost(x, means))


def test_stragglers_do_not_break_rounds(data):
    x, means = data
    res = tsoc.run_soccer(shard_points(x, M), SoccerParams(
        k=6, epsilon=0.1, straggler_rate=0.3, seed=3), device="cpu")
    assert res.rounds <= res.const.max_rounds
    assert _cost(x, res.centers) <= 4.0 * _cost(x, means)


@pytest.mark.parametrize("fail_at", [{0: (2, 5)}, {1: (2,), 2: (5,)}],
                         ids=["round0", "mid_run"])
def test_failure_plan_through_facade_degrades_gracefully(data, fail_at):
    """Machines die before the run and mid-run; cost degrades with the
    lost mass, never catastrophically (tests/test_ft.py:71)."""
    x, means = data
    ok = api.fit(x, 6, m=M, epsilon=0.1, seed=0, device="cpu")
    res = api.fit(x, 6, m=M, epsilon=0.1, seed=0, eta_override=900,
                  failure_plan=FailurePlan(fail_at=fail_at), device="cpu")
    assert _cost(x, res.centers) <= 4.0 * max(_cost(x, ok.centers),
                                              _cost(x, means))
    jres = jfit(x, 6, algo="soccer", backend="virtual", m=M, epsilon=0.1,
                seed=0, eta_override=900,
                failure_plan=jft.FailurePlan(fail_at=fail_at))
    assert int(res.n_hist[0]) == int(jres.n_hist[0])
    assert abs(res.rounds - jres.rounds) <= 1


def test_straggler_plan_never_loses_data(data):
    """Stragglers miss the sampling deadline only: every machine stays
    ok, the coordinator's count starts at the full n, removal still
    reaches every machine, and the user's ``on_round`` runs once a round
    (tests/test_ft.py:105)."""
    x, means = data
    seen = []
    res = api.fit(x, 6, m=M, epsilon=0.1, seed=1, eta_override=900,
                  failure_plan=FailurePlan(straggler_rate=0.4),
                  on_round=lambda r, s: seen.append(int(torch.sum(
                      s.alive & s.machine_ok[:, None]))) or None,
                  device="cpu")
    state = res.extra["state"]
    assert bool(state.machine_ok.all())
    assert int(res.n_hist[0]) == x.shape[0]
    assert res.rounds >= 1 and len(seen) == res.rounds
    assert res.extra["const"].straggler_rate == 0.4
    assert (state.alive.sum(dim=1) < x.shape[0] // M).all()
    assert _cost(x, res.centers) <= 4.0 * _cost(x, means)


def test_on_round_kill_counts_from_the_next_round(data):
    """A machine killed by ``on_round`` after round r is first left out
    by round r + 1's live counts: n_hist[r] is the live points of the
    machines still ok, as the reference's loop orders it."""
    x, _ = data
    after = {}

    def spy(r, s):
        after[r] = (s.alive & s.machine_ok[:, None]).sum().item()

    res = api.fit(x, 6, m=M, epsilon=0.1, seed=0, eta_override=900,
                  failure_plan=FailurePlan(fail_at={1: (0, 4)}),
                  on_round=spy, device="cpu")
    assert res.rounds >= 2 and not res.extra["state"].machine_ok[[0, 4]].any()
    for r in range(1, res.rounds + 1):
        assert int(res.n_hist[r]) == after[r], r


def test_straggler_masks_independent_and_never_empty():
    """Each upload draws its own respond mask from the run's generator;
    with a rate near 1 some draw still has responders (all respond when
    none would), and a rate of 0 draws nothing."""
    const = tsoc.derive_constants(800, 100, SoccerParams(
        k=3, straggler_rate=0.999))
    gen = torch.Generator().manual_seed(0)
    n_vec = torch.arange(1, M + 1, dtype=torch.int32) * 10
    masks = [tsoc._respond(gen, const, n_vec) for _ in range(20)]
    assert all(int(m.sum()) > 0 for m in masks)
    half = tsoc.derive_constants(800, 100, SoccerParams(k=3,
                                                        straggler_rate=0.5))
    drawn = torch.stack([tsoc._respond(gen, half, n_vec) > 0
                         for _ in range(400)])
    assert 0.4 < float(drawn.float().mean()) < 0.6
    assert any(not torch.equal(drawn[i], drawn[i + 1]) for i in range(399))
    assert torch.equal(tsoc._respond(gen, half, torch.zeros_like(n_vec)),
                       torch.zeros_like(n_vec))
    zero = tsoc.derive_constants(800, 100, SoccerParams(k=3))
    state = gen.get_state()
    assert tsoc._respond(gen, zero, n_vec) is n_vec
    assert torch.equal(gen.get_state(), state)
