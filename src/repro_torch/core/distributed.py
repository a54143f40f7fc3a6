"""Mesh deployment of SOCCER: the reference's mesh entry points.

The algorithm code in ``core/`` is written once against the comm
abstraction and bound to a process group by
``repro_torch.api.backends.MeshBackend``: every rank is one machine
(local_m == 1) and the collectives run over the group. The host driver
loop lives in one place, ``core.soccer.run_soccer``; this module keeps
the reference's mesh entry points as thin shims over it.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch.configs.soccer_paper import SoccerParams
from repro_torch.core import soccer as soccer_lib
from repro_torch.core.comm import MeshCluster
from repro_torch.core.soccer import SoccerConstants, SoccerResult, SoccerState
from repro_torch.device import DeviceLike


def mesh_cluster(group=None) -> MeshCluster:
    """MeshCluster over every rank of ``group`` (None: the default)."""
    from repro_torch.api.backends import mesh_comm
    return mesh_comm(group)


def make_mesh_step(const: SoccerConstants, group=None,
                   finalize: bool = False
                   ) -> Callable[[SoccerState], SoccerState]:
    """One SOCCER round (or the finalize) on the mesh comm of ``group``:
    a callable of this rank's ``SoccerState``. The port runs eagerly, so
    where the reference compiles ``jit(shard_map(soccer_round))`` this is
    the round bound to its comm."""
    fn = soccer_lib.soccer_finalize if finalize else soccer_lib.soccer_round
    return functools.partial(fn, comm=mesh_cluster(group), const=const)


def run_soccer_mesh(x_parts, params: SoccerParams, group=None, *,
                    generator: Optional[torch.Generator] = None,
                    eta_override: int = 0,
                    device: DeviceLike = "cuda") -> SoccerResult:
    """Thin shim: the unified driver with a MeshBackend. ``x_parts`` is
    (m, p, d), every machine's on every rank; each rank keeps its own."""
    from repro_torch.api.backends import MeshBackend
    return soccer_lib.run_soccer(
        x_parts, params, backend=MeshBackend(group), generator=generator,
        eta_override=eta_override, device=device)
