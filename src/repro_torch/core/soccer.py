"""SOCCER — Sampling, Optimal Clustering Cost Estimation, Removal (Alg. 1).

The port of ``repro.core.soccer`` with every ``SoccerParams`` knob: the
gather coordinator or the sharded one (``sharded_coordinator``,
``core.sharded_kmeans``), the k-means or mini-batch black box, straggler
deadlines, raw points or machine-side coresets on the uplink
(``uplink_mode``) at any uplink precision and wire (``uplink_dtype``,
``uplink_wire``), and the robust knob ``outlier_frac`` (truncated
removal threshold, trimmed finalize). One ``soccer_round`` is one
communication round of the paper:

  sample P1, P2 (exact-size, HT-weighted)  ->  ragged "upload"
  coordinator:  C_iter = A(P1, k_plus); v from the truncated cost on P2
  machines:     remove points with rho(x, C_iter)^2 <= v   (CUDA kernel)
  stop when N <= eta  ->  finalize: gather survivors, A(V, k)

The number of rounds is data-dependent, so ``run_soccer`` is a host loop
with one device->host read per round (``int(state.n_remaining)``), the
synchronization barrier a real deployment pays, and an optional host
hook ``on_round`` after each round (failure injection, ``ft.failures``).
Nothing inside a round reads a value back to the host. Removed points are
masked, never moved. Under ``fit(trace=...)`` each round and the finalize
emit one record of ``obs.trace.ROUND_SCHEMA``, timed from the step's
start to that read; tracing adds no read of its own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.soccer_paper import SoccerParams
from repro_torch.core.comm import VirtualCluster, wire_tally
from repro_torch.core.kmeans import kmeans
from repro_torch.core.minibatch import minibatch_kmeans
from repro_torch.core.sampling import draw_global_sample
from repro_torch.core.sharded_kmeans import sharded_center_threshold
from repro_torch.core.truncated_cost import removal_threshold, trim_top_mass
from repro_torch.coresets.uplink import draw_coreset_sample
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class SoccerConstants:
    """Quantities derived from the paper's formulas (fixed for a run)."""
    k: int
    k_plus: int          # k + 9·log(1.1k/(δε))
    d_k: float           # 6.5·log(1.1k/(δε))
    eta: int             # coordinator capacity 36·k·n^ε·log(1.1k/(δε))
    max_rounds: int
    cap: int             # per-machine sample buffer width (gather mode)
    cap_sharded: int     # per-machine sample buffer (sharded coordinator):
                         # ~8x the balanced share eta/m instead of eta
    lloyd_iters: int
    blackbox: str        # kmeans | minibatch
    minibatch_size: int
    sharded_coordinator: bool
    sharded_threshold: str = "bisect"   # bisect | topk
    sharded_seeding: str = "d2"         # d2 | kmeanspar
    outlier_frac: float = 0.0   # (k, z) mass z = outlier_frac·N, untouched
                                # by the removal threshold and trimmed
                                # from the finalize fit
    straggler_rate: float = 0.0
    uplink_dtype: str = "float32"       # payload precision
    uplink_wire: str = "values"         # resolved transport: values | codes
    uplink_mode: str = "points"  # points | coreset
    coreset_rows: int = 0       # per-machine coreset rows t
    coreset_kb: int = 0         # machine-side bicriteria centers


def derive_constants(n: int, p_local: int, params: SoccerParams,
                     eta_override: int = 0, m: int = 0,
                     uplink_dtype: str = "float32",
                     uplink_wire: str = "values") -> SoccerConstants:
    log_term = math.log(1.1 * params.k / (params.delta * params.epsilon))
    d_k = 6.5 * log_term
    k_plus = int(math.ceil(params.k + 9.0 * log_term))
    eta = eta_override or int(math.ceil(
        36.0 * params.k * (n ** params.epsilon) * log_term))
    eta = min(eta, n)
    max_rounds = params.max_rounds or (
        int(math.ceil(1.0 / params.epsilon)) + 2)
    m = m or params.n_machines
    cap_sharded = min(p_local, eta,
                      max(64, int(math.ceil(8.0 * eta / max(m, 1)))))
    coreset_rows = coreset_kb = 0
    if params.uplink_mode == "coreset":
        # uplink budget in rows, decoupled from eta: by default enough rows
        # for the k_plus-center black box and a 4x wire reduction
        total_cs = params.coreset_size or max(4 * k_plus, eta // 4)
        total_cs = min(total_cs, eta)
        coreset_rows = max(1, min(-(-total_cs // max(m, 1)),
                                  min(p_local, eta)))
        coreset_kb = params.coreset_bicriteria or max(
            1, min(params.k, coreset_rows))
    return SoccerConstants(
        k=params.k, k_plus=k_plus, d_k=d_k, eta=eta, max_rounds=max_rounds,
        cap=min(p_local, eta), cap_sharded=cap_sharded,
        lloyd_iters=params.lloyd_iters, blackbox=params.blackbox,
        minibatch_size=params.minibatch_size,
        sharded_coordinator=params.sharded_coordinator,
        sharded_threshold=params.sharded_threshold,
        sharded_seeding=params.sharded_seeding,
        outlier_frac=params.outlier_frac,
        straggler_rate=params.straggler_rate,
        uplink_dtype=uplink_dtype, uplink_wire=uplink_wire,
        uplink_mode=params.uplink_mode,
        coreset_rows=coreset_rows, coreset_kb=coreset_kb)


# The reference's run-condition options (``repro.api.fit``) that ``fit``
# passes to every driver and each driver checks with ``check_run_knobs``
# (``trace`` is taken by ``fit`` itself: drivers read the ambient trace).
RUN_KNOBS = ("backend", "uplink_dtype", "uplink_wire")


def check_run_knobs(m: int, **run_knobs):
    """The one guard over ``RUN_KNOBS``, called by every driver: TypeError
    for an option the reference does not have, ValueError for a value it
    rejects (``api.backends.resolve_backend``: an unknown backend, or
    "mesh" without a process group of world size ``m``). Returns the
    resolved backend, the uplink dtype's name and the resolved wire
    ("values" or "codes")."""
    from repro_torch.api.backends import check_uplink_wire, resolve_backend
    unknown = set(run_knobs) - set(RUN_KNOBS)
    if unknown:
        raise TypeError(f"unexpected option(s) {sorted(unknown)}")
    bk = resolve_backend(run_knobs.get("backend"), m,
                         run_knobs.get("uplink_dtype"),
                         run_knobs.get("uplink_wire"))
    return bk, bk.uplink_dtype, check_uplink_wire(bk.uplink_wire,
                                                  bk.uplink_dtype)


@dataclasses.dataclass
class SoccerState:
    """(local_m, ...) tensors are per-machine (all m machines on the
    virtual backend, this rank's one on a mesh); the rest are replicated.

    The history buffers (``centers`` ... ``alpha_hist``) are updated in
    place, one row per round: PyTorch tensors are mutable, and a round
    otherwise copies (R, k_plus, d) for one new row.
    """
    x: torch.Tensor             # (local_m, p, d) points
    w: torch.Tensor             # (local_m, p) data weights (1.0 = plain)
    alive: torch.Tensor         # (local_m, p) not-yet-removed mask
    machine_ok: torch.Tensor    # (local_m,) False = machine failed
    gen: torch.Generator        # the run's random stream, on x's device
    round_idx: int              # rounds run so far (host-side)
    n_remaining: torch.Tensor   # () int32 live points
    centers: torch.Tensor       # (R, k_plus, d) C_out; R = max_rounds + 1
    centers_valid: torch.Tensor  # (R, k_plus)
    v_hist: torch.Tensor        # (R,) thresholds
    n_hist: torch.Tensor        # (R,) N at the start of each round
    uplink: torch.Tensor        # (R,) realized points uploaded per round
    alpha_hist: torch.Tensor    # (R,) realized P2 sampling rate per round
    machine_base: int = 0       # global id of the first per-machine row


def init_state(x_parts: torch.Tensor, const: SoccerConstants,
               gen: torch.Generator, w: Optional[torch.Tensor] = None,
               alive: Optional[torch.Tensor] = None,
               comm=None) -> SoccerState:
    """The state before round 1 over ``x_parts`` (this process's
    machines); ``comm`` (None: a virtual cluster of them) sums the live
    count over every machine."""
    m, p, d = x_parts.shape
    dev = x_parts.device
    r = const.max_rounds + 1
    w = torch.ones((m, p), dtype=torch.float32, device=dev) if w is None else w
    alive = (torch.ones((m, p), dtype=torch.bool, device=dev)
             if alive is None else alive)
    comm = VirtualCluster(m) if comm is None else comm
    return SoccerState(
        x=x_parts.to(torch.float32), w=w, alive=alive,
        machine_ok=torch.ones((m,), dtype=torch.bool, device=dev), gen=gen,
        round_idx=0, n_remaining=comm._reduce(torch.sum(
            alive, dim=1, dtype=torch.int32)).to(torch.int32),
        centers=torch.zeros((r, const.k_plus, d), dtype=torch.float32,
                            device=dev),
        centers_valid=torch.zeros((r, const.k_plus), dtype=torch.bool,
                                  device=dev),
        v_hist=torch.zeros((r,), dtype=torch.float32, device=dev),
        n_hist=torch.zeros((r,), dtype=torch.int32, device=dev),
        uplink=torch.zeros((r,), dtype=torch.int32, device=dev),
        alpha_hist=torch.zeros((r,), dtype=torch.float32, device=dev),
        machine_base=comm.machine_base)


# SoccerState fields that hold tensors, with the dtype each is carried in
_TENSOR_FIELDS = {"x": torch.float32, "w": torch.float32,
                  "alive": torch.bool, "machine_ok": torch.bool,
                  "n_remaining": torch.int32, "centers": torch.float32,
                  "centers_valid": torch.bool, "v_hist": torch.float32,
                  "n_hist": torch.int32, "uplink": torch.int32,
                  "alpha_hist": torch.float32}


def state_from_numpy(fields: Dict[str, np.ndarray],
                     device: DeviceLike = "cuda",
                     seed: int = 0) -> SoccerState:
    """The port's state from a JAX ``SoccerState``'s leaves as numpy arrays.

    ``fields`` maps every field name but ``key`` to its value (e.g.
    ``{f: np.asarray(getattr(s, f)) for f in s._fields if f != "key"}``),
    so a run can continue from exactly where the reference stood. JAX's
    PRNG key has no counterpart: the new state's generator is seeded with
    ``seed``.
    """
    dev = resolve_device(device)
    missing = (set(_TENSOR_FIELDS) | {"round_idx"}) - set(fields)
    if missing:
        raise ValueError(f"state_from_numpy: missing fields {sorted(missing)}")
    tensors = {name: torch.as_tensor(np.array(fields[name]), device=dev
                                     ).to(dt)
               for name, dt in _TENSOR_FIELDS.items()}
    return SoccerState(gen=torch.Generator(dev).manual_seed(seed),
                       round_idx=int(fields["round_idx"]), **tensors)


def _live_counts(comm: VirtualCluster, state: SoccerState):
    alive_eff = state.alive & state.machine_ok[:, None]
    n_vec = comm.all_machines(torch.sum(alive_eff, dim=1, dtype=torch.int32))
    return alive_eff, n_vec, torch.sum(n_vec, dtype=torch.int32)


def _draw_sample(comm: VirtualCluster, const: SoccerConstants,
                 state: SoccerState, alive_eff: torch.Tensor,
                 n_vec_resp: torch.Tensor):
    """One exact-size global sample -> (points, weights, uplink_rows,
    sample_real).

    ``uplink_mode="points"``: the paper's raw upload of the eta-point
    draw; uplink_rows == sample_real == the realized draw.
    ``uplink_mode="coreset"``: each machine compresses its share of the
    same draw to a sensitivity coreset before the upload
    (``coresets.uplink``); uplink_rows shrinks to the m·t coreset rows,
    while sample_real keeps the underlying draw size, which drives the
    alpha = |P2|/N threshold scaling.
    """
    uplink = dict(upload_dtype=const.uplink_dtype, wire=const.uplink_wire)
    if const.uplink_mode == "coreset":
        return draw_coreset_sample(comm, state.gen, state.x, state.w,
                                   alive_eff, n_vec_resp, const.eta,
                                   const.cap, const.coreset_rows,
                                   const.coreset_kb, **uplink)
    pts, wts, real = draw_global_sample(comm, state.gen, state.x, state.w,
                                        alive_eff, n_vec_resp, const.eta,
                                        const.cap, **uplink)
    return pts, wts, real, real


def _blackbox(const: SoccerConstants, gen: torch.Generator, x: torch.Tensor,
              w: torch.Tensor, k: int) -> torch.Tensor:
    """The coordinator's black box A(S, k): k-means++ + Lloyd, or
    mini-batch k-means (``blackbox="minibatch"``)."""
    if const.blackbox == "minibatch":
        c, _ = minibatch_kmeans(gen, x, w, k, batch=const.minibatch_size)
    else:
        c, _ = kmeans(gen, x, w, k, const.lloyd_iters)
    return c


def _respond(gen: torch.Generator, const: SoccerConstants,
             n_vec: torch.Tensor) -> torch.Tensor:
    """The live counts of the machines that meet one upload's sampling
    deadline (0 for a straggler). Each upload has its own deadline, so
    each draws its own mask; if every machine with points would miss it,
    all respond. Draws nothing when ``straggler_rate`` is 0."""
    if const.straggler_rate <= 0.0:
        return n_vec
    r = torch.rand(n_vec.shape, generator=gen,
                   device=n_vec.device) >= const.straggler_rate
    r = r | (torch.sum(torch.where(r, n_vec, 0)) == 0)
    return torch.where(r, n_vec, 0)


def _outlier_mass(const: SoccerConstants, n_total: torch.Tensor):
    """z = outlier_frac·N population points (0 when the knob is off); a
    float32 product on the device, no host value copied over."""
    return n_total.to(torch.float32) * const.outlier_frac


def soccer_round(state: SoccerState, comm: VirtualCluster,
                 const: SoccerConstants) -> SoccerState:
    alive_eff, n_vec, n_total = _live_counts(comm, state)
    # --- straggler deadlines: laggards skip sampling this round only;
    # they keep the broadcast and the removal
    n_vec_r1 = _respond(state.gen, const, n_vec)
    n_vec_r2 = _respond(state.gen, const, n_vec)

    if const.sharded_coordinator:
        # beyond-paper: the samples stay sharded; the collectives shrink
        # from O(eta·d) to O(k_plus·d·iters) (core.sharded_kmeans)
        with obs_trace.span("soccer.sharded_coordinator"):
            c_iter, v, uplink_pts, alpha = sharded_center_threshold(
                comm, const, state, alive_eff, n_vec_r1, n_vec_r2, n_total)
    else:
        # --- upload P1, P2 (independent draws; in coreset mode each is
        # compressed machine-side before the upload)
        with obs_trace.span("soccer.upload"):
            p1, w1, up1, _ = _draw_sample(comm, const, state, alive_eff,
                                          n_vec_r1)
            p2, w2, up2, real2 = _draw_sample(comm, const, state,
                                              alive_eff, n_vec_r2)
        # --- coordinator: C_iter = A(P1, k_plus); threshold from P2.
        # alpha is P2's OWN realized sampling rate: the truncation mass
        # L = l/alpha and the psi->population rescale both describe the
        # P2 statistic. The (k, z) mass must not inflate the threshold.
        with obs_trace.span("soccer.coordinator"):
            c_iter = _blackbox(const, state.gen, p1, w1, const.k_plus)
            d2_p2, _ = ops.min_dist(p2, c_iter)
            alpha = real2.to(torch.float32) / torch.clamp(
                n_total.to(torch.float32), min=1.0)
            v = removal_threshold(d2_p2, w2, const.k, const.d_k, alpha,
                                  outlier_mass=_outlier_mass(const, n_total))
        uplink_pts = up1 + up2

    # --- broadcast (v, C_iter); the machines remove points in one fused
    # sweep: min-d2, threshold compare, mask update and live counts
    with obs_trace.span("soccer.removal"):
        alive_new, live = ops.remove_below(state.x, c_iter, alive_eff, v)
        n_rem = comm.psum(live)

    i = state.round_idx
    state.centers[i] = c_iter
    state.centers_valid[i] = True
    state.v_hist[i] = v
    state.n_hist[i] = n_total
    state.uplink[i] = uplink_pts
    state.alpha_hist[i] = alpha
    return dataclasses.replace(state, alive=alive_new, round_idx=i + 1,
                               n_remaining=n_rem)


def soccer_finalize(state: SoccerState, comm: VirtualCluster,
                    const: SoccerConstants) -> SoccerState:
    """Gather the <= eta survivors and cluster them with A(V, k).

    With ``outlier_frac > 0`` (the paper's §9 robustness knob) the
    finalize is one trimmed k-means step: a provisional A(V, k) fit, then
    the top ``z = outlier_frac·N`` weight mass of the gathered survivors
    (by distance to the provisional centers) is zeroed out of the HT
    weights before the final fit.
    """
    alive_eff, n_vec, n_total = _live_counts(comm, state)
    v_pts, v_w, up, _ = _draw_sample(comm, const, state, alive_eff, n_vec)
    if const.outlier_frac > 0.0:
        c_prov = _blackbox(const, state.gen, v_pts, v_w, const.k)
        d2, _ = ops.min_dist(v_pts, c_prov)
        v_w = trim_top_mass(d2, v_w, _outlier_mass(const, n_total))
    c_fin = _blackbox(const, state.gen, v_pts, v_w, const.k)
    i = state.round_idx
    state.centers[i] = 0.0
    state.centers[i, :const.k] = c_fin
    state.centers_valid[i] = torch.arange(
        const.k_plus, device=c_fin.device) < const.k
    state.n_hist[i] = n_total
    state.uplink[i] = up
    return state


@dataclasses.dataclass
class SoccerResult:
    centers: np.ndarray        # (|C_out|, d) valid centers, flattened
    rounds: int                # I (communication rounds before finalize)
    const: SoccerConstants
    n_hist: np.ndarray
    v_hist: np.ndarray
    uplink: np.ndarray         # points uploaded per round (incl. finalize)
    state: SoccerState
    # achieved wire traffic per executed round (incl. finalize): payload
    # vs metadata (count vectors, HT weights)
    wire_payload: np.ndarray
    wire_meta: np.ndarray
    backend: str = "virtual"   # the resolved backend's name


def flatten_centers(state: SoccerState) -> np.ndarray:
    c = state.centers.cpu().numpy()
    return c[state.centers_valid.cpu().numpy()]


def effective_n(m: int, p: int, w, alive) -> int:
    """Instance size for the paper's formulas: total live *weight*."""
    if w is None and alive is None:
        return m * p
    w_np = np.ones((m, p), np.float64) if w is None else np.asarray(
        w, np.float64)
    if alive is not None:
        w_np = np.where(np.asarray(alive), w_np, 0.0)
    return max(int(round(float(np.sum(w_np)))), 1)


def stopping_rule(remaining: float, capacity: float, prev: float) -> bool:
    """Issue more work iff ``remaining`` still exceeds ``capacity`` AND
    the last step made progress (``remaining < prev``; pass ``math.inf``
    before the first step)."""
    return remaining > capacity and remaining < prev


def run_soccer(x_parts, params: SoccerParams, *, backend="virtual",
               generator: Optional[torch.Generator] = None,
               w=None, alive=None, eta_override: int = 0,
               device: DeviceLike = "cuda",
               on_round: Optional[Callable] = None,
               **run_knobs) -> SoccerResult:
    """The SOCCER host driver.

    ``x_parts`` is (m, p, d) points (numpy or a tensor), ``w``/``alive``
    optional (m, p) weights and mask: every machine's, on every rank of a
    mesh, which keeps its own machine's rows (``backend.put``).
    ``backend`` is anything ``api.backends.resolve_backend`` takes.
    ``generator`` defaults to one on ``device`` seeded with
    ``params.seed``; on a mesh every rank's must be seeded alike. ``on_round(round_idx, state)``
    is an optional host callback after each round, once the round's live
    count has been read (failure injection); if it returns a state, the
    loop continues from it. ``run_knobs`` are the reference's other
    run-condition options (``RUN_KNOBS``, checked by ``check_run_knobs``).
    """
    from repro_torch.api.backends import MACHINE
    m, p, _ = x_parts.shape
    bk, uplink_dtype, uplink_wire = check_run_knobs(m, backend=backend,
                                                    **run_knobs)
    dev = resolve_device(device)
    comm = bk.make_comm(m)
    const = derive_constants(effective_n(m, p, w, alive), p, params,
                             eta_override, m=m, uplink_dtype=uplink_dtype,
                             uplink_wire=uplink_wire)
    gen = (torch.Generator(dev).manual_seed(params.seed)
           if generator is None else generator)
    x_dev, w_dev, alive_dev = bk.put(
        (x_parts, None if w is None else np.asarray(w, np.float32),
         None if alive is None else np.asarray(alive, bool)), MACHINE,
        device=dev)
    state = init_state(x_dev, const, gen, w=w_dev, alive=alive_dev,
                       comm=comm)

    # The progress half of stopping_rule doubles as the no-progress guard:
    # if the threshold cannot remove anything, finalize on a subsample
    # instead of spinning to max_rounds.
    trace = obs_trace.current_trace()
    if trace is not None:
        trace.meta.setdefault("eta", const.eta)
        trace.meta.setdefault("k", const.k)
        trace.meta.setdefault("max_rounds", const.max_rounds)
    rounds = 0
    prev_n = math.inf
    n_rem = int(state.n_remaining)      # the one device->host read a round
    tallies, clocks = [], []
    while rounds < const.max_rounds and stopping_rule(n_rem, const.eta,
                                                      prev_n):
        prev_n = n_rem
        sc = obs_trace.step_clock()
        with obs_trace.span("soccer.round", round=rounds + 1), \
                wire_tally() as t:
            state = soccer_round(state, comm, const)
            n_rem = int(state.n_remaining)
        clocks.append(sc.stop())
        tallies.append(t)
        rounds += 1
        if on_round is not None:
            state = on_round(rounds, state) or state
    sc = obs_trace.step_clock()
    with obs_trace.span("soccer.finalize"), wire_tally() as t:
        state = soccer_finalize(state, comm, const)
    tallies.append(t)
    for t in tallies:
        t.warn_overflow()
    up = state.uplink.cpu().numpy()
    clocks.append(sc.stop())

    wire_payload = np.asarray([t.bytes_at(up[r]) for r, t in
                               enumerate(tallies)], np.int64)
    wire_meta = np.asarray([t.meta_bytes_at(up[r]) for r, t in
                            enumerate(tallies)], np.int64)
    res = SoccerResult(
        centers=flatten_centers(state), rounds=rounds, const=const,
        n_hist=state.n_hist.cpu().numpy(), v_hist=state.v_hist.cpu().numpy(),
        uplink=up, state=state, wire_payload=wire_payload,
        wire_meta=wire_meta, backend=bk.name)
    if trace is not None:
        _emit_soccer_records(trace, res, state.alpha_hist.cpu().numpy(),
                             n_rem, prev_n, clocks)
    return res


def _emit_soccer_records(trace: obs_trace.RunTrace, res: "SoccerResult",
                         a_hist: np.ndarray, n_rem: int, prev_n: float,
                         clocks) -> None:
    """Turn the run's histories into the pinned per-round records.

    ``n_hist[i]`` is N at the *start* of (0-indexed) round ``i``;
    finalize writes ``n_hist[rounds]``, so the post-removal live count of
    round ``r`` (1-based) is ``n_hist[r]``: the number the stopping rule
    compared against eta. ``n_rem`` is the live count the loop read last,
    ``clocks`` one ``StepClock`` a round and one for the finalize.
    """
    const, rounds, up = res.const, res.rounds, res.uplink
    n_hist, v_hist = res.n_hist, res.v_hist
    wire_payload, wire_meta = res.wire_payload, res.wire_meta
    for r in range(1, rounds + 1):
        n_after = int(n_hist[r])
        trace.emit_round(
            round=r, phase="round",
            n_live=n_hist[r - 1], capacity=const.eta,
            alpha=a_hist[r - 1], v=v_hist[r - 1],
            removed=int(n_hist[r - 1]) - n_after,
            stop_ratio=n_after / const.eta,
            stop_margin=n_after - const.eta,
            uplink_rows=up[r - 1],
            wire_payload_bytes=wire_payload[r - 1],
            wire_meta_bytes=wire_meta[r - 1],
            wall_s=clocks[r - 1].wall_s, compile_s=clocks[r - 1].compile_s)
    trace.emit_round(
        round=rounds + 1, phase="finalize",
        n_live=n_hist[rounds], capacity=const.eta,
        uplink_rows=up[rounds],
        wire_payload_bytes=wire_payload[rounds],
        wire_meta_bytes=wire_meta[rounds],
        wall_s=clocks[rounds].wall_s, compile_s=clocks[rounds].compile_s)
    if n_rem <= const.eta:
        trace.stop_reason = "capacity"
    elif prev_n != math.inf and n_rem >= prev_n:
        trace.stop_reason = "no_progress"
    else:
        trace.stop_reason = "max_rounds"
