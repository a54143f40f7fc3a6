"""The one result shape every algorithm returns (the port of
``repro.api.result``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


def dtype_itemsize(dtype) -> int:
    """Bytes per element of an uplink dtype name or numpy dtype."""
    name = str(dtype)
    if name in _ITEMSIZE:
        return _ITEMSIZE[name]
    return np.dtype(dtype).itemsize


def uplink_bytes(points, d: int, dtype=np.float32) -> np.ndarray:
    """MODELED communication volume of ``points`` uploaded d-dim rows, in
    bytes, at the uplink dtype's width. The measured counterpart is
    ``ClusterResult.wire_bytes``."""
    pts = np.asarray(points, np.int64)
    return pts * int(d) * dtype_itemsize(dtype)


def omega_mk_bytes(m: int, k: int, d: int, itemsize: int = 4) -> int:
    """The Ω(m·k) communication lower-bound frontier of Zhang et al.
    (arXiv:1507.00026), in bytes: m·k·d coordinates at ``itemsize``."""
    return int(m) * int(k) * int(d) * int(itemsize)


@dataclasses.dataclass
class ClusterResult:
    """Unified result of ``repro_torch.api.fit``.

    ``uplink_points``/``uplink_bytes`` are per-communication-round
    realized machine->coordinator upload volumes (including the finalize
    gather); ``wire_bytes``/``wire_meta_bytes`` the achieved payload and
    metadata bytes per round, recorded by ``core.comm.WireTally``.
    """
    centers: np.ndarray                 # (c, d) final centers
    k: int                              # requested number of clusters
    algo: str                           # registry name
    backend: str                        # "virtual" | "mesh"
    rounds: int                         # communication rounds used
    uplink_points: np.ndarray           # (R,) points uploaded per round
    uplink_bytes: np.ndarray            # (R,) same in bytes (dtype-aware)
    n_hist: Optional[np.ndarray] = None   # live-point counts per round
    v_hist: Optional[np.ndarray] = None   # removal thresholds per round
    wire_bytes: Optional[np.ndarray] = None
    wire_meta_bytes: Optional[np.ndarray] = None
    wall_time_s: float = 0.0
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def uplink_points_total(self) -> int:
        return int(np.sum(self.uplink_points))

    @property
    def uplink_bytes_total(self) -> int:
        return int(np.sum(self.uplink_bytes))

    @property
    def wire_bytes_total(self) -> Optional[int]:
        """Total measured wire bytes (payload + metadata), or None."""
        if self.wire_bytes is None:
            return None
        meta = 0 if self.wire_meta_bytes is None else np.sum(
            self.wire_meta_bytes)
        return int(np.sum(self.wire_bytes) + meta)

    def cost(self, x, w=None, *, device: DeviceLike = "cuda") -> float:
        """Centralized k-means cost of ``self.centers`` on ``x`` ((n, d) or
        machine-sharded (m, p, d); pair with the matching ``w`` to mask
        padding points), computed on ``device``."""
        from repro_torch.core.metrics import centralized_cost
        dev = resolve_device(device)
        x = torch.as_tensor(x, device=dev)
        if x.dim() == 3:
            x = x.reshape(-1, x.shape[-1])
        if w is not None:
            w = torch.as_tensor(w, device=dev).reshape(-1)
        c = torch.as_tensor(self.centers, dtype=torch.float32, device=dev)
        return float(centralized_cost(x, c, w))
