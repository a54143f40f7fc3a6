"""Execution backends for ``repro_torch.api.fit``.

A *backend* decides where the machine axis of a ``(m, p, ...)`` tensor
lives; the drivers are written once against the comm abstraction
(``core.comm``) and take their comm from ``resolve_backend(...).
make_comm(m)``:

* ``VirtualBackend`` — all ``m`` machines folded into axis 0 on one
  device (``VirtualCluster``).
* ``MeshBackend`` — one machine per rank of a ``torch.distributed``
  process group (``MeshCluster``). The design is SPMD, the counterpart of
  the reference's ``jit(shard_map(...))``: every rank runs the same host
  loop and computes the coordinator's work on the same gathered data;
  only the machines' rows are split across ranks.

Drivers describe placement with *marks*: ``MACHINE`` (a leading machine
axis, of which a mesh rank keeps its own rows) or ``REPLICATED``
(identical on every machine). The port runs eagerly, so there is no
``compile`` and no counterpart of the reference's ``donate``.

The uplink dtype contract (``check_uplink_dtype``,
``check_uplink_wire``) lives here, as in the reference;
``core.sampling`` re-exports it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.comm import MeshCluster, VirtualCluster

# Marks for the leaves of a placed tree.
MACHINE = "machine"        # (m, ...) leading machine axis
REPLICATED = "rep"         # identical value on every machine

# Machine->coordinator payload precisions (the ``uplink_dtype`` knob):
# points are rounded to this dtype before the upload and accounted at its
# width in ``ClusterResult.uplink_bytes``. "int8" goes through the affine
# quantizer in ``ft.compression``; its payload is stored as the float32
# reconstruction, so the kernels need no int8 path.
UPLINK_DTYPES = ("float32", "bfloat16", "float16", "int8")
# Wire transport of the quantized payload (the ``uplink_wire`` knob):
# "values" moves payloads at their storage width (int8 as its float32
# reconstruction), "codes" moves int8 payloads as 1-byte codes plus one
# per-machine (scale, zero_point) pair (``core.comm``'s compressed
# gathers), "auto" is "codes" for int8 and "values" otherwise.
UPLINK_WIRES = ("auto", "codes", "values")


def check_uplink_dtype(dtype) -> str:
    """The uplink dtype's name (a name, a torch or a numpy dtype);
    ValueError for one outside ``UPLINK_DTYPES``."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = str(getattr(dtype, "__name__", dtype))
    if name not in UPLINK_DTYPES:
        raise ValueError(
            f"unsupported uplink_dtype {dtype!r}: expected one of "
            f"{', '.join(UPLINK_DTYPES)}")
    return name


def check_uplink_wire(wire, dtype: str = "float32") -> str:
    """Validate an ``uplink_wire`` knob against the uplink dtype and
    resolve it to the transport, "codes" or "values"."""
    if wire not in UPLINK_WIRES:
        raise ValueError(
            f"unsupported uplink_wire {wire!r}: expected one of "
            f"{', '.join(UPLINK_WIRES)}")
    if wire == "auto":
        return "codes" if dtype == "int8" else "values"
    if wire == "codes" and dtype != "int8":
        raise ValueError(
            f"uplink_wire='codes' ships int8 codes + per-machine qparams "
            f"and needs uplink_dtype='int8', got uplink_dtype={dtype!r}")
    return wire


def _tree_map(fn, tree, marks):
    """``fn(leaf, mark)`` over a tree of dicts, lists and tuples; one mark
    may stand for a whole subtree."""
    if isinstance(marks, str):
        if isinstance(tree, dict):
            return {k: _tree_map(fn, v, marks) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(_tree_map(fn, v, marks) for v in tree)
        return fn(tree, marks)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], marks[k]) for k in tree}
    return type(tree)(_tree_map(fn, t, mk) for t, mk in zip(tree, marks))


def _place(leaf, rows: Optional[slice], device):
    """A leaf (tensor, numpy array or None) as a tensor on ``device``
    (None: where it is), cut to ``rows`` of its first axis."""
    if leaf is None:
        return None
    if rows is not None:
        leaf = leaf[rows]
    if isinstance(leaf, torch.Tensor):
        return leaf if device is None else leaf.to(device)
    return torch.as_tensor(np.asarray(leaf), device=device)


@runtime_checkable
class Backend(Protocol):
    """What a driver needs: a comm, data placement, and the uplink knobs
    (``uplink_dtype``, one of ``UPLINK_DTYPES``; ``uplink_wire``, one of
    ``UPLINK_WIRES``)."""
    name: str
    uplink_dtype: str
    uplink_wire: str

    def make_comm(self, m: int):
        """Comm object for ``m`` machines (VirtualCluster/MeshCluster)."""

    def put(self, tree: Any, marks: Any, device=None) -> Any:
        """Place a tree of tensors by its marks on ``device``."""


@dataclasses.dataclass(frozen=True)
class VirtualBackend:
    """Single-device execution: the machine axis is a plain tensor axis."""
    name: str = "virtual"
    uplink_dtype: str = "float32"
    uplink_wire: str = "auto"

    def make_comm(self, m: int) -> VirtualCluster:
        return VirtualCluster(m)

    def put(self, tree, marks, device=None):
        return _tree_map(lambda leaf, mk: _place(leaf, None, device), tree,
                         marks)


def _world(group) -> int:
    import torch.distributed as dist
    return dist.get_world_size(group)


@dataclasses.dataclass(frozen=True)
class MeshBackend:
    """One machine per rank of ``group`` (None: the default group)."""
    group: Any = None
    name: str = "mesh"
    uplink_dtype: str = "float32"
    uplink_wire: str = "auto"

    def make_comm(self, m: int) -> MeshCluster:
        import torch.distributed as dist
        world = _world(self.group)
        if world != m:
            raise ValueError(
                f"mesh backend has {world} ranks (one machine per rank) "
                f"but the data has m={m} machines")
        return MeshCluster(m=m, rank=dist.get_rank(self.group),
                           group=self.group)

    def put(self, tree, marks, device=None):
        """A ``MACHINE`` leaf's own row (this rank's machine) and a
        ``REPLICATED`` leaf whole, on ``device``."""
        import torch.distributed as dist
        r = dist.get_rank(self.group)
        return _tree_map(
            lambda leaf, mk: _place(leaf, slice(r, r + 1) if mk == MACHINE
                                    else None, device), tree, marks)


def mesh_comm(group=None) -> MeshCluster:
    """MeshCluster over every rank of ``group`` (None: the default)."""
    return MeshBackend(group).make_comm(_world(group))


def group_world() -> Optional[int]:
    """The default group's world size when one is initialized, else
    None."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return None


def _replace_knob(backend, field: str, value: str):
    if not (dataclasses.is_dataclass(backend) and any(
            f.name == field for f in dataclasses.fields(backend))):
        raise ValueError(
            f"backend {type(backend).__name__} does not carry an "
            f"{field} field; construct it with {field}={value!r} instead "
            f"of passing the knob to fit()")
    return dataclasses.replace(backend, **{field: value})


def resolve_backend(backend, m: int, uplink_dtype=None,
                    uplink_wire=None) -> Backend:
    """A ``Backend``, a ``torch.distributed.ProcessGroup`` (a mesh over
    its ranks), or "virtual" | "mesh" | "auto".

    "mesh" needs an initialized default process group whose world size is
    ``m`` (one machine per rank) and raises ValueError otherwise; "auto"
    is "mesh" exactly when such a group exists (and m > 1), "virtual"
    otherwise, so a single-process call stays virtual. ``uplink_dtype``/
    ``uplink_wire`` (if given) set the upload precision and transport on
    the resolved backend; a constructed Backend is rebuilt with
    ``dataclasses.replace`` when a knob differs from its own. The final
    (dtype, wire) pair is validated here, once.
    """
    ud = None if uplink_dtype is None else check_uplink_dtype(uplink_dtype)
    uw = uplink_wire
    knobs = dict(uplink_dtype=ud or "float32", uplink_wire=uw or "auto")

    def _check(bk):
        check_uplink_wire(bk.uplink_wire, check_uplink_dtype(
            bk.uplink_dtype))
        return bk

    if backend is None:
        backend = "virtual"
    if _is_group(backend):
        return _check(MeshBackend(backend, **knobs))
    if not isinstance(backend, str):
        if ud and getattr(backend, "uplink_dtype", "float32") != ud:
            backend = _replace_knob(backend, "uplink_dtype", ud)
        if uw and getattr(backend, "uplink_wire", "auto") != uw:
            backend = _replace_knob(backend, "uplink_wire", uw)
        return _check(backend)
    if backend == "auto":
        backend = "mesh" if m > 1 and group_world() == m else "virtual"
    if backend == "virtual":
        return _check(VirtualBackend(**knobs))
    if backend == "mesh":
        world = group_world()
        if world != m:
            have = ("no process group is initialized" if world is None
                    else f"the process group has world size {world}")
            raise ValueError(
                f"backend='mesh' needs an initialized torch.distributed "
                f"process group of world size m={m} (one machine per "
                f"rank), but {have}; launch with `python -m "
                f"repro_torch.launch` or use backend='virtual'")
        return _check(MeshBackend(**knobs))
    raise ValueError(
        f"unknown backend {backend!r}: expected 'virtual', 'mesh', 'auto', "
        f"a torch.distributed ProcessGroup, or a Backend instance")


def _is_group(obj) -> bool:
    import torch.distributed as dist
    return dist.is_available() and isinstance(obj, dist.ProcessGroup)
