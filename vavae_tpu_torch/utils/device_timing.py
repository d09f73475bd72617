"""Times of a call on the card: CUDA events around each call, and the
kernels' own device time from one torch.profiler trace.

Imports only torch, so that ``chip_ab.py`` can load this file into a run of
another checkout and read every checkout with one definition of each time.
"""
from __future__ import annotations

import statistics
import time

import torch

TRACE_ATTEMPTS = 10
GUARD_S = 0.05


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median time of ``fn`` in ms (CUDA events around each call, after
    ``warmup`` calls). Holds the host's share of a short call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _trace(fn, reps: int, guard_s: float = GUARD_S) -> list:
    """The CUDA events of ``reps`` calls of ``fn``, aggregated by name. The
    profiler runs ``reps`` calls as a warm-up step, whose records it
    discards, before the ``reps`` it keeps: the records of the kernels in a
    trace's first moments are often missing. The card idles ``guard_s``
    before each step ends."""
    cuda = torch.autograd.DeviceType.CUDA
    kept: list = []

    def ready(prof) -> None:
        kept.extend(ev for ev in prof.key_averages()
                    if getattr(ev, "device_type", None) == cuda)

    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                schedule=schedule, on_trace_ready=ready) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(guard_s)
            prof.step()
    return kept


def device_kernels(fn, reps: int = 20) -> dict:
    """Device time per call of ``fn`` in ms of each kernel it runs, by
    kernel name: the kernel's total over one trace of ``reps`` calls,
    divided by ``reps``. Every kernel of a call runs in every call, so a
    trace in which a kernel's launch count is not a whole multiple of
    ``reps``, or that holds no kernel at all, lost records: it is reported
    and taken again, with a longer idle before each step ends (the traces
    of calls of a few microseconds lose records most); after
    ``TRACE_ATTEMPTS`` such traces the run fails."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        events = _trace(fn, reps, GUARD_S * attempt)
        partial = {ev.key: ev.count for ev in events if ev.count % reps}
        if events and not partial:
            return {ev.key: ev.self_device_time_total / 1e3 / reps for ev in events}
        print(f"[timing] trace {attempt} of {TRACE_ATTEMPTS} lost launches: counts "
              f"{partial or 'none recorded'} over {reps} calls", flush=True)
    raise RuntimeError(f"device_kernels: {TRACE_ATTEMPTS} traces lost launches")


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call of ``fn`` in ms: all its kernels' time in one
    trace over ``reps``. Unlike ``time_ms`` it leaves out the host's share
    of a call that the device waits for."""
    return sum(device_kernels(fn, reps).values())
