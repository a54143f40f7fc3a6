"""Machine/coordinator communication: the virtual and the mesh cluster.

The paper's coordinator model has ``m`` machines that talk only to a
coordinator. ``VirtualCluster`` folds all ``m`` machines into axis 0 of
every per-machine tensor (``(m, ...)``) on one device, as the reference's
``repro.core.comm.VirtualCluster`` does; ``MeshCluster`` holds one machine
per ``torch.distributed`` rank (``(1, ...)`` blocks), the counterpart of
the reference's ``MeshCluster`` inside ``shard_map``. Each provides two
raw collectives —
``_reduce`` (sum over machines) and ``_gather`` (per-machine blocks) —
and ``_WireOps`` derives the recording wrappers the algorithms use:
``psum``, ``all_machines``, the fixed-width ``concat_machines``, the
length-prefixed ragged gather ``gather_ragged``, and their int8 codes
variants (``*_compressed``): machine-side affine quantization, 1-byte
codes plus one per-machine (scale, zero_point) pair through the
collective, dequantization on arrival. The values land on each
machine's own 256-level grid, the bits of ``ft.compression.
fake_quantize_int8`` applied before a plain gather, so a codes-wire fit
equals a values-wire fit.

Both clusters give every rank the virtual cluster's bits: the mesh's
``_reduce`` gathers the ``(m, ...)`` blocks and sums them over the machine
axis in machine order, as the virtual one does, never through
``all_reduce``, whose summation order is the library's. Machine-axis
random draws go through ``machine_rand``/``machine_draws``: both clusters
draw every machine's numbers from the run's generator, in machine order,
and keep their own machines' share, so a machine draws the same numbers
whichever process holds it and every rank's generator stays in step.

Wire accounting: the JAX package records bytes once, when a round is
traced, and multiplies by the rounds it ran. PyTorch runs eagerly, so
here every executed call records into the innermost active ``WireTally``;
a driver opens one tally per round and reads that round's bytes from it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import warnings
from typing import Any, Callable, List, Optional

import numpy as np
import torch

# ------------------------------------------------------------------ tallies


@dataclasses.dataclass
class WireTally:
    """Machine->coordinator traffic recorded by the calls executed under
    one ``wire_tally`` context.

    ``payload``/``meta`` are bytes of fixed-shape collectives (count
    vectors, cost sums). ``row_bytes``/``row_meta_bytes`` are per-realized-
    row widths of the ragged channels; ``bytes_at`` multiplies them by the
    realized row count the driver tracks (the ``uplink`` history). Ragged
    widths merge by max, so the ragged gathers under one tally share one
    row width — true for SOCCER (a round's two uploads have one shape).

    ``overflow`` holds one device flag per ragged gather whose rows
    exceeded its budget; the driver checks them once, after its loop, so
    the round itself never waits for the device.
    """
    payload: int = 0
    meta: int = 0
    row_bytes: int = 0
    row_meta_bytes: int = 0
    overflow: List[torch.Tensor] = dataclasses.field(default_factory=list)

    def bytes_at(self, rows) -> np.ndarray:
        """Achieved payload bytes for realized ragged ``rows``."""
        return self.payload + self.row_bytes * np.asarray(rows, np.int64)

    def meta_bytes_at(self, rows) -> np.ndarray:
        return self.meta + self.row_meta_bytes * np.asarray(rows, np.int64)

    def warn_overflow(self) -> None:
        """Warn if any ragged gather under this tally truncated rows."""
        if self.overflow and bool(torch.stack(self.overflow).any()):
            warnings.warn("gather_ragged: machines contributed more rows "
                          "than the budget; the tail was truncated",
                          stacklevel=2)


_TALLY_STACK: List[WireTally] = []


@contextlib.contextmanager
def wire_tally(tally: Optional[WireTally] = None):
    """Collect wire-byte records from the comm calls executed in the block."""
    t = WireTally() if tally is None else tally
    _TALLY_STACK.append(t)
    try:
        yield t
    finally:
        _TALLY_STACK.pop()


def record_wire(*, payload: int = 0, meta: int = 0, row_bytes: int = 0,
                row_meta_bytes: int = 0) -> None:
    """Add to the innermost active tally (no-op outside any context).
    Static channels accumulate; per-row widths merge by max."""
    if not _TALLY_STACK:
        return
    t = _TALLY_STACK[-1]
    t.payload += int(payload)
    t.meta += int(meta)
    t.row_bytes = max(t.row_bytes, int(row_bytes))
    t.row_meta_bytes = max(t.row_meta_bytes, int(row_meta_bytes))


def static_nbytes(x: torch.Tensor) -> int:
    """Wire width of a fixed-shape tensor."""
    return x.numel() * x.element_size()


def _row_nbytes(x: torch.Tensor) -> int:
    """Bytes per (machine, slot) row of a ``(local_m, cap, ...)`` block."""
    return math.prod(x.shape[2:]) * x.element_size()


# ------------------------------------------------------------ shared ops


class _WireOps:
    """Derived collectives + wire recording over ``_reduce``/``_gather``,
    and the machine-axis draws over ``machine_base``."""

    def _mine(self, rows):
        """This process's machines' entries of an m-long machine axis."""
        return rows[self.machine_base:self.machine_base + self.local_m]

    def machine_ids(self, device) -> torch.Tensor:
        """(local_m,) int32 global ids of this process's machines."""
        return torch.arange(self.machine_base,
                            self.machine_base + self.local_m,
                            dtype=torch.int32, device=device)

    def machine_rand(self, gen: torch.Generator, shape, device
                     ) -> torch.Tensor:
        """(local_m, *shape) uniforms in [0, 1): this process's rows of
        one (m, *shape) ``torch.rand`` draw from ``gen``."""
        return self._mine(torch.rand((self.m, *shape), generator=gen,
                                     device=device))

    def machine_draws(self, draw: Callable[[], Any]) -> List[Any]:
        """``draw()`` once a machine, in machine order; this process's
        machines' results (a list of local_m). For per-machine draws
        that interleave with a machine's own work, as the coreset
        builds' seed and inverse-CDF draws do."""
        return self._mine([draw() for _ in range(self.m)])

    @property
    def _fan(self) -> int:
        # one local op stands for m // local_m machines' worth of traffic
        return self.m // self.local_m

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        record_wire(meta=static_nbytes(x) * self._fan)
        return self._reduce(x)

    def all_machines(self, x: torch.Tensor) -> torch.Tensor:
        record_wire(meta=static_nbytes(x) * self._fan)
        return self._gather(x)

    def concat_machines(self, x: torch.Tensor, *, meta: bool = False
                        ) -> torch.Tensor:
        """(local_m, t, ...) fixed-width blocks -> (m*t, ...) replicated.

        ``meta=True`` charges the bytes to the metadata channel (weight
        columns that ride alongside a payload, like the HT weights).
        """
        record_wire(**{"meta" if meta else "payload":
                       static_nbytes(x) * self._fan})
        g = self._gather(x)
        return g.reshape((-1,) + tuple(g.shape[2:]))

    def _encode(self, x: torch.Tensor):
        """Per-machine int8 codes and qparams of (local_m, rows, ...)
        blocks, and the qparams' metadata bytes."""
        from repro_torch.ft.compression import (affine_qparams,
                                                quantize_affine_int8)
        scale, zp = affine_qparams(x)          # one pair per machine
        codes = quantize_affine_int8(x, scale, zp)
        return codes, scale, zp, (static_nbytes(scale)
                                  + static_nbytes(zp)) * self._fan

    def _decode(self, codes, scale, zp) -> torch.Tensor:
        from repro_torch.ft.compression import dequantize_affine_int8
        return dequantize_affine_int8(self._gather(codes),
                                      self._gather(scale),
                                      self._gather(zp))

    def all_machines_compressed(self, x: torch.Tensor) -> torch.Tensor:
        """(local_m, t, ...) float32 blocks -> (m, t, ...) float32; the
        wire carries int8 codes plus one per-machine affine
        (scale, zero_point) pair on the metadata channel."""
        if x.dim() < 3:
            raise ValueError(
                f"compressed gathers need (local_m, rows, ...) blocks so "
                f"each machine gets its own code book; got shape "
                f"{tuple(x.shape)}")
        codes, scale, zp, meta = self._encode(x)
        record_wire(payload=static_nbytes(codes) * self._fan, meta=meta)
        return self._decode(codes, scale, zp)

    def concat_machines_compressed(self, x: torch.Tensor) -> torch.Tensor:
        """(local_m, t, ...) -> (m*t, ...) float32; int8 codes on the wire."""
        g = self.all_machines_compressed(x)
        return g.reshape((-1,) + tuple(g.shape[2:]))

    def _budget_counts(self, counts: torch.Tensor, cap: int, rows: int
                       ) -> torch.Tensor:
        """Counts clipped to the block width. Rows beyond the budget are
        truncated with a warning: at once for counts on the CPU, after the
        driver's loop (``WireTally.warn_overflow``) for counts on the card,
        so that no round waits on the device for it."""
        counts = torch.clamp(counts.to(torch.int32), max=cap)
        over = torch.sum(counts) > rows
        if _TALLY_STACK:
            _TALLY_STACK[-1].overflow.append(over)
        elif over.device.type == "cpu" and bool(over):
            warnings.warn(
                f"gather_ragged: machines contribute {int(counts.sum())} "
                f"rows but the budget is {rows}; the tail is truncated",
                stacklevel=3)
        return counts

    @staticmethod
    def _compact(g: torch.Tensor, counts: torch.Tensor, rows: int
                 ) -> torch.Tensor:
        """(m, cap, ...) gathered blocks -> (rows, ...): machine j's first
        counts[j] rows at offset sum(counts[:j]); the rest exactly zero."""
        m, cap = g.shape[0], g.shape[1]
        offs = torch.cumsum(counts, 0) - counts        # exclusive
        slot = torch.arange(cap, dtype=torch.int32, device=g.device)
        pos = offs[:, None] + slot[None, :]
        # live rows map to disjoint, in-order positions; untaken slots and
        # budget overflow land on the spare row `rows`, which is dropped
        pos = torch.where((slot[None, :] < counts[:, None]) & (pos < rows),
                          pos, rows)
        tail = tuple(g.shape[2:])
        out = torch.zeros((rows + 1,) + tail, dtype=g.dtype, device=g.device)
        out[pos.reshape(-1).long()] = g.reshape((m * cap,) + tail)
        return out[:rows]

    def gather_ragged(self, values: torch.Tensor, counts: torch.Tensor,
                      rows: int, *, meta: bool = False) -> torch.Tensor:
        """Length-prefixed ragged gather without a dense pad.

        Args:
          values: (local_m, cap, ...) per-machine blocks — the first
            ``counts[j]`` rows of machine j's block are live.
          counts: (m,) int32 live-row counts, replicated.
          rows: static output row budget.
          meta: charge the per-row bytes to the metadata channel.

        Returns:
          (rows, ...) in ``values.dtype``: live rows packed contiguously in
          machine order, remaining slots exactly zero.
        """
        counts = self._budget_counts(counts, values.shape[1], rows)
        record_wire(meta=4 * self.m,
                    **{"row_meta_bytes" if meta else "row_bytes":
                       _row_nbytes(values)})
        return self._compact(self._gather(values), counts, rows)

    def gather_ragged_compressed(self, values: torch.Tensor,
                                 counts: torch.Tensor, rows: int
                                 ) -> torch.Tensor:
        """Ragged gather whose wire carries int8 codes + per-machine affine
        qparams; returns the (rows, ...) float32 reconstruction.

        Callers mask never-uploaded slots (e.g. with a live row) before
        the call, so that padding cannot widen a machine's code book.
        """
        if values.dim() < 3:
            raise ValueError(
                f"compressed gathers need (local_m, cap, ...) blocks, got "
                f"shape {tuple(values.shape)}")
        counts = self._budget_counts(counts, values.shape[1], rows)
        codes, scale, zp, meta = self._encode(values)
        record_wire(meta=4 * self.m + meta, row_bytes=_row_nbytes(codes))
        return self._compact(self._decode(codes, scale, zp), counts, rows)


# ------------------------------------------------------------ clusters


@dataclasses.dataclass(frozen=True)
class VirtualCluster(_WireOps):
    """All ``m`` machines folded into axis 0 of every tensor (one device)."""
    m: int

    @property
    def local_m(self) -> int:
        return self.m

    @property
    def machine_base(self) -> int:
        return 0

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(x, dim=0)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        return x


# dtypes that move through a gather as their bytes: not every gloo or
# NCCL build takes them, and a byte view keeps every bit
_BYTE_WIRE = (torch.bool, torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class MeshCluster(_WireOps):
    """One machine per rank of a ``torch.distributed`` process group
    (``group`` None: the default group): per-machine tensors are this
    rank's ``(1, ...)`` block, and machine ``rank`` is this rank's."""
    m: int
    rank: int
    group: Any = None

    def __post_init__(self):
        if not 0 <= self.rank < self.m:
            raise ValueError(f"MeshCluster: rank {self.rank} outside "
                             f"[0, {self.m})")

    @property
    def local_m(self) -> int:
        return 1

    @property
    def machine_base(self) -> int:
        return self.rank

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """(1, ...) -> (m, ...) in rank order, on ``x``'s device. An int8
        block moves at one byte an element: compression survives the
        collective. Under gloo a CUDA block is staged through the host
        (gloo's collectives move host memory); NCCL moves it on the
        card."""
        import torch.distributed as dist
        if x.shape[0] != 1:
            raise ValueError(f"MeshCluster: per-machine blocks are (1, ...), "
                             f"got {tuple(x.shape)}")
        x = x.contiguous()
        wire = x.view(torch.uint8) if x.dtype in _BYTE_WIRE else x
        if wire.is_cuda and dist.get_backend(self.group) == "gloo":
            wire = wire.cpu()       # gloo moves host memory: stage there
        parts = [torch.empty_like(wire) for _ in range(self.m)]
        dist.all_gather(parts, wire, group=self.group)
        g = torch.cat(parts, 0).to(x.device)
        if g.dtype != x.dtype:
            g = g.view(x.dtype).reshape((self.m,) + tuple(x.shape[1:]))
        return g

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over machines: the gathered (m, ...) blocks summed over
        axis 0 in machine order on every rank, the virtual cluster's
        ``torch.sum(x, dim=0)`` bits."""
        return torch.sum(self._gather(x), dim=0)
