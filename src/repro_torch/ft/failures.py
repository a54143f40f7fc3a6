"""Machine-failure and straggler handling for SOCCER.

The port of ``repro.ft.failures``. Two mechanisms the algorithm admits:

* **Hard failure** (a machine dies, its shard is lost): mark
  ``machine_ok[j] = False``. The round is already failure-aware: the
  count vector drives apportionment, the HT weights stay consistent, and
  the coordinator estimates over the surviving population.
* **Straggler deadline** (a machine misses the sampling deadline): the
  round's respond masks drop it from sampling only; it still receives
  the broadcast and removes points, so no data is lost.

``reshard_state`` restores a state onto another machine count.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.soccer import SoccerState


@dataclasses.dataclass(frozen=True)
class FailurePlan:
    """Declarative failure and straggler injection for ``fit(...)``.

    ``fail_at`` maps a communication-round index to the machine ids that
    die right after that round (round 0 = before the first round: the
    shard is lost for the whole run). ``straggler_rate`` is the per-round
    probability that a machine misses an upload's sampling deadline.

    The facade turns the plan into SOCCER's ``on_round`` hook plus the
    ``straggler_rate`` param: ``fit(x, k, failure_plan=FailurePlan(
    fail_at={1: (2, 5)}, straggler_rate=0.3))``.
    """
    fail_at: Mapping[int, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    straggler_rate: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.straggler_rate < 1.0:
            raise ValueError(
                f"FailurePlan.straggler_rate must be in [0, 1), got "
                f"{self.straggler_rate}")
        for r, ids in self.fail_at.items():
            if r < 0 or not len(tuple(ids)):
                raise ValueError(
                    f"FailurePlan.fail_at: round {r} -> {ids!r} (rounds "
                    f"must be >= 0 and machine lists non-empty)")

    def initial_failures(self) -> Tuple[int, ...]:
        """Machines dead before round 1 (the ``fail_at[0]`` entry)."""
        return tuple(self.fail_at.get(0, ()))

    def on_round(self, round_idx: int, state: SoccerState) -> SoccerState:
        """SOCCER host-loop hook: apply this round's failures, if any."""
        ids = self.fail_at.get(round_idx)
        return state if not ids else fail_machines(state, ids)

    def chain(self, other):
        """Compose with a user ``on_round`` hook (failures apply first)."""
        if other is None:
            return self.on_round

        def hook(round_idx, state):
            state = self.on_round(round_idx, state)
            return other(round_idx, state) or state

        return hook


def fail_machines(state: SoccerState, ids: Sequence[int]) -> SoccerState:
    """Mark machines failed (axis-0 machine ids); the next round's live
    counts exclude them."""
    dead = torch.zeros_like(state.machine_ok)
    dead[list(ids)] = True
    return dataclasses.replace(state, machine_ok=state.machine_ok & ~dead)


def surviving_fraction(state: SoccerState) -> float:
    """Share of all point slots that are alive on a machine still ok."""
    alive = state.alive & state.machine_ok[:, None]
    return float(torch.sum(alive)) / max(float(alive.numel()), 1.0)


def reshard_state(state: SoccerState, m_new: int) -> SoccerState:
    """Elastic restore: repartition the (m, p, ...) machine tensors onto
    ``m_new`` machines, keeping the global point order and padding with
    removed slots; every new machine is ok."""
    def regroup(a: torch.Tensor, fill=0) -> torch.Tensor:
        a_np = a.cpu().numpy()
        m, p = a_np.shape[:2]
        flat = a_np.reshape((m * p,) + a_np.shape[2:])
        p_new = -(-(m * p) // m_new)
        pad = m_new * p_new - m * p
        if pad:
            flat = np.concatenate(
                [flat, np.full((pad,) + flat.shape[1:], fill, a_np.dtype)])
        return torch.as_tensor(flat.reshape((m_new, p_new) + a_np.shape[2:]),
                               device=a.device)

    return dataclasses.replace(
        state, x=regroup(state.x), w=regroup(state.w),
        alive=regroup(state.alive, fill=False),
        machine_ok=torch.ones((m_new,), dtype=torch.bool,
                              device=state.machine_ok.device))
