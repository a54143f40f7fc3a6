"""Coreset-compressed uplink for SOCCER (``uplink_mode="coreset"``).

The port of ``repro.coresets.uplink``. Each machine draws its apportioned
share of the eta-point uniform sample (the same statistics and HT weights
as the points uplink), then compresses its draw to a ``t``-row
sensitivity coreset before the upload: the coordinator receives m·t
weighted rows, so the uplink size becomes a knob (``coreset_size``)
independent of eta.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.sampling import apportion, gather_weighted, sample_local
from repro_torch.coresets.sensitivity import build_coresets


def draw_coreset_sample(comm, gen: torch.Generator, x: torch.Tensor,
                        w: torch.Tensor, alive: torch.Tensor,
                        n_vec_resp: torch.Tensor, total: int, cap: int,
                        t: int, kb: int, upload_dtype: str = "float32",
                        wire: str = "values"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """Exact-size global sample, coreset-compressed before the upload.

    Args:
      x: (local_m, p, d); w: (local_m, p) data weights; alive: (local_m, p).
      n_vec_resp: (m,) live counts of responding machines.
      total: global sample size (eta); cap: per-machine buffer.
      t: per-machine coreset rows (the uplink knob).
      kb: bicriteria center count for the machine-side solve.

    Returns:
      ((m*t, d) coreset points, (m*t,) float32 weights (HT over both the
      uniform draw and the sensitivity sampling), () int32 rows uploaded
      (machines whose quota is 0 upload nothing), () int32 realized size
      of the underlying uniform sample, which drives the alpha = |P2|/N
      threshold scaling).
    """
    ids = comm.machine_ids(x.device)
    c_vec = apportion(n_vec_resp, total)
    my_c = c_vec[ids]
    idx, take = sample_local(gen, alive, my_c, cap, comm)
    pts = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    w_pt = torch.gather(w, 1, idx)
    n_local = torch.sum(alive, dim=1).to(torch.float32)
    ht = n_local / torch.clamp(my_c.to(torch.float32), min=1.0)
    w_s = w_pt * ht[:, None] * take.to(torch.float32)    # HT-weighted draw
    cpts, cw = build_coresets(gen, pts, w_s, t, kb, comm)
    g_pts, g_w = gather_weighted(comm, cpts, cw, upload_dtype, wire=wire)
    uplink_rows = torch.sum(c_vec > 0, dtype=torch.int32) * t
    return g_pts, g_w, uplink_rows, torch.sum(c_vec, dtype=torch.int32)
