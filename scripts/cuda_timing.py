"""Device and host timing on one CUDA card, shared by ``chip_smoke.py``
and the parent / change scripts (``time_reduce.py``, ``time_seeding.py``,
``fit_ab.py``).

* ``timed_ms(fn)``: device ms a call by CUDA events over back-to-back
  calls enqueued behind a device sleep, with the host's own µs a call
  beside it (``Ms.host_us``);
* ``device_split(fn)``: device µs a call of each kernel and memset ``fn``
  launches, from ``torch.profiler``;
* ``union_us(ranges)`` and ``device_busy_ms(fn)``: the time the device is
  busy, counting overlapping events once (a kernel launched as a
  programmatic dependent of the one before it overlaps it).

Imports only ``torch``.
"""
from __future__ import annotations

import time

import torch


class Ms(float):
    """Device milliseconds a call, with ``host_us``: the host's own
    microseconds a call, the wall time of issuing one call to an idle
    device. Where host_us exceeds the device time, the host bounds the
    call when calls follow one another."""
    host_us: float


# The longest device sleep timed_ms enqueues before its calls, in ms:
# where the host's time for the calls is longer, the device bounds none
# of them at that rate anyway.
SLEEP_MAX_MS = 200.0
_cycles_per_ms = []


def device_sleep(ms: float) -> None:
    """Enqueue a device-side spin of about ``ms`` milliseconds."""
    if not _cycles_per_ms:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        torch.cuda.synchronize()
        _cycles_per_ms.append(10_000_000 / start.elapsed_time(end))
    torch.cuda._sleep(int(_cycles_per_ms[0] * ms))


def timed_ms(fn, reps: int = 20) -> Ms:
    """Mean device milliseconds per call, after a warm-up, by CUDA events,
    and the host's own microseconds a call beside it (``Ms.host_us``: the
    least of three warm-up calls, each issued to an idle device). The
    timed calls are enqueued behind a device sleep twice as long as the
    host takes for them, so the device reaches them only after the host
    has issued them all and the events time the device alone, unless a
    call waits for the device itself or fills the launch queue."""
    host_one = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_one.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    device_sleep(min(2e3 * reps * min(host_one) + 1.0, SLEEP_MAX_MS))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    out = Ms(start.elapsed_time(end) / reps)
    out.host_us = min(host_one) * 1e6
    return out


def _is_device(evt) -> bool:
    return getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA


def device_split(fn, reps: int = 10) -> dict:
    """Device µs a call of each kernel and memset that ``fn`` launches, by
    short name, from torch.profiler over ``reps`` calls after a warm-up;
    empty where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if not _is_device(e):
            continue
        us = float(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0)))
        if us > 0:
            name = e.key.split("(")[0].replace("void ", "")
            out[name] = out.get(name, 0.0) + us / reps
    return out


def union_us(ranges) -> float:
    """Length of the union of (start, end) ranges, in their unit."""
    total, lo, hi = 0.0, None, None
    for start, end in sorted(ranges):
        if hi is None or start > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    return total + (hi - lo if hi is not None else 0.0)


def device_busy_ms(fn) -> float:
    """Milliseconds the device is busy in one call of ``fn`` (kernels and
    copies, each overlap counted once), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return union_us((e.time_range.start, e.time_range.end)
                    for e in prof.events() if _is_device(e)) / 1e3
