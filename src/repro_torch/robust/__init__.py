"""Outlier-robust ((k, z)-means) clustering tier (the port of
``repro.robust``).

``kzmeans``, the one-round distributed (k, z)-means baseline, registers
with ``repro_torch.api`` on import (the api package imports this one).
The truncated-cost machinery it shares with robust SOCCER is in
``core.truncated_cost``, its scoring kernel behind
``kernels.ops.truncated_cost``.
"""
from repro_torch.robust.kzmeans import fit_kzmeans

__all__ = ["fit_kzmeans"]
