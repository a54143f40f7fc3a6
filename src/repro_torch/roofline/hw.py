"""Hardware peaks: the H100 SXM's datasheet constants, plus a measured
calibration of the card the process runs on.

The port of ``repro.roofline.hw``, with the NVIDIA H100 SXM5 80 GB in
place of the TPU v5e. The constants drive the dry runs' projected
roofline terms (``roofline/analysis.py``); ``measured_peaks()`` times a
square bf16 matmul and a copy on the card with CUDA events, as the
reference times a matmul and a copy on its device, so a reader can set
the datasheet beside what this card sustains.
"""
from __future__ import annotations

import dataclasses
import functools

# NVIDIA H100 SXM5 datasheet (dense, no sparsity): 989 TFLOP/s bf16
# tensor-core, 3.35 TB/s HBM3, 80 GB of HBM3
PEAK_FLOPS_BF16 = 989e12      # per card
HBM_BW = 3.35e12              # bytes/s per card
HBM_BYTES = 80 * 10**9        # bytes per card
# The collective term's link: a 16 x 16 mesh is 32 hosts of 8 cards, so
# most of its rings cross hosts, over one 400 Gb/s NDR InfiniBand port a
# card (DGX H100): 50 GB/s a direction. NVLink 4 inside a host gives 450
# GB/s a direction (900 GB/s both ways), kept for reference.
NET_LINK_BW = 50e9            # bytes/s per card, between hosts
NVLINK_BW = 450e9             # bytes/s per card, within a host
LINK_BW = NET_LINK_BW


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    backend: str        # the card's name (torch.cuda.get_device_name)
    flops: float        # sustained bf16 matmul flops/s
    mem_bw: float       # sustained copy read + write bytes/s

    def roofline_s(self, flops: float, bytes_moved: float) -> float:
        """Best-case seconds for work moving ``bytes_moved`` while
        executing ``flops``, at the measured peaks."""
        return max(flops / self.flops, bytes_moved / self.mem_bw)


def _median_ms(fn, iters: int = 5) -> float:
    import torch
    fn()                                  # warm-up (cuBLAS heuristics)
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    ts.sort()
    return ts[len(ts) // 2]


@functools.lru_cache(maxsize=None)
def measured_peaks(matmul_dim: int = 8192, copy_mib: int = 1024
                   ) -> DevicePeaks:
    """Calibrate the current card once a process (raises without CUDA).

    flops: a square bf16 matmul (2·dim³ flops); mem_bw: ``b + 1`` over a
    float32 buffer of ``copy_mib`` MiB (one read and one write an
    element)."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("measured_peaks times the card: CUDA is not "
                           "available")
    a = torch.ones((matmul_dim, matmul_dim), dtype=torch.bfloat16,
                   device="cuda")
    out = torch.empty_like(a)
    t_mm = _median_ms(lambda: torch.mm(a, a, out=out)) / 1e3
    n = copy_mib * 2**20 // 4
    buf = torch.ones((n,), dtype=torch.float32, device="cuda")
    dst = torch.empty_like(buf)
    t_cp = _median_ms(lambda: torch.add(buf, 1.0, out=dst)) / 1e3
    return DevicePeaks(backend=torch.cuda.get_device_name(0),
                       flops=2.0 * matmul_dim**3 / t_mm,
                       mem_bw=2.0 * 4.0 * n / t_cp)
