"""Per-device statistics of an eagerly run step: FLOPs, bytes and
collectives (the port's counterpart of ``repro.roofline.hlo_stats``).

The reference parses XLA's optimized HLO and multiplies each while body
by its trip count. The port runs the step itself, typically under
``FakeTensorMode`` on the fake process group of a production mesh
(``launch/mesh.py::make_production_mesh``), where every tensor is a
rank's local shard: what is dispatched is what one device does, and a
Python loop dispatches its ops once a trip, so no trip count is needed.
``OpStats`` keeps ``HloStats``'s fields:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of the
  matmuls, convolutions and attention products over the local shapes
  (elementwise FLOPs ignored, as the reference ignores them);
* ``bytes``: each materializing op's operands read and results written
  (views, metadata ops and the collectives' own buffers aside), XLA's
  "bytes accessed" convention;
* ``coll`` / ``coll_ops``: bytes and count of each kind of collective
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``)
  seen as ``c10d`` or functional-collective ops in the dispatch; an op
  contributes its result's bytes, the reference's convention.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_COLL = {
    "allgather": "all-gather", "_allgather_base": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "allgather_into_tensor_coalesced": "all-gather",
    "allreduce": "all-reduce", "all_reduce": "all-reduce",
    "allreduce_coalesced": "all-reduce",
    "reduce_scatter": "reduce-scatter",
    "_reduce_scatter_base": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall": "all-to-all", "alltoall_base": "all-to-all",
    "all_to_all_single": "all-to-all",
}

@dataclasses.dataclass
class OpStats:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_ops: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def coll_total(self) -> float:
        return float(sum(self.coll.values()))


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _collective(func):
    ns = func.namespace
    if ns not in ("c10d", "_c10d_functional", "c10d_functional"):
        return None
    name = func._schema.name.split("::")[-1].rstrip("_")
    return _COLL.get(name)


class _Counter(TorchDispatchMode):
    def __init__(self, stats: OpStats):
        super().__init__()
        self.stats = stats

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = _collective(func)
        if kind is not None:
            # the in-place c10d ops write their first argument, the
            # functional ones return the result
            res = args[0] if func.namespace == "c10d" else out
            b = sum(_nbytes(t) for t in tree_flatten(res)[0])
            self.stats.coll[kind] = self.stats.coll.get(kind, 0.0) + b
            self.stats.coll_ops[kind] = self.stats.coll_ops.get(kind, 0) + 1
            return out
        if func.is_view or func.namespace == "prim":
            return out
        ins = sum(_nbytes(t) for t in tree_flatten((args, kwargs))[0])
        outs = sum(_nbytes(t) for t in tree_flatten(out)[0])
        self.stats.bytes += ins + outs
        return out


@contextlib.contextmanager
def op_stats() -> Iterator[OpStats]:
    """Count what runs inside the block (``stats.flops`` is filled when
    the block ends)."""
    from torch.utils.flop_counter import FlopCounterMode
    stats = OpStats()
    flops = FlopCounterMode(display=False)
    with flops, _Counter(stats):
        yield stats
    stats.flops = float(flops.get_total_flops())
