"""Step timing and profiler windows (port of ``vavae_tpu/utils/profiling.py``).

  - ``StepTimer``: steps/s since a reset, fenced so that queued device work
    counts;
  - ``trace(log_dir)``: a ``torch.profiler`` trace of the block, exported
    to ``log_dir`` as a Chrome trace;
  - ``WindowTracer``: the trace of a window of training steps, driven by
    ``VAVAE_PROFILE`` (the directory), ``VAVAE_PROFILE_AT`` (first step, 10)
    and ``VAVAE_PROFILE_STEPS`` (its length, 5);
  - ``device_memory_stats()``: live and peak device memory per card.

CUDA work is asynchronous, so every fence synchronises: by fetching a value
of ``sync_on`` when one is given (which waits for the work it depends on),
else by ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Iterator

import torch


def _fence(sync_on: Any = None) -> None:
    """Wait for the device: fetch the first tensor of ``sync_on`` (a tensor,
    or a list, tuple or dict holding one), else synchronise every stream."""
    leaves = sync_on.values() if isinstance(sync_on, dict) else (
        sync_on if isinstance(sync_on, (list, tuple)) else [sync_on])
    first = next((x for x in leaves if torch.is_tensor(x)), None)
    if first is not None:
        first.detach().reshape(-1)[:1].cpu()
    elif torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def step(self) -> None:
        self._steps += 1

    def rate(self, sync_on: Any = None) -> float:
        """Steps/s since the last reset, after the device has finished them."""
        _fence(sync_on)
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else float("inf")


def _start_profiler(log_dir: str) -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    return prof


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """A profiler trace of the block, written under ``log_dir``
    (``*.pt.trace.json``, which TensorBoard's profiler plugin and
    chrome://tracing read)."""
    prof = _start_profiler(log_dir)
    try:
        yield
    finally:
        _fence()
        prof.stop()


class WindowTracer:
    """Trace a window of training steps. With ``VAVAE_PROFILE=/dir`` set,
    the steps [``VAVAE_PROFILE_AT``, ``VAVAE_PROFILE_AT`` +
    ``VAVAE_PROFILE_STEPS``) are traced into ``/dir``. Call ``step(i,
    sync_on=...)`` once a step and ``close()`` at the loop's end, which also
    stops a window that an early exit or a preemption cut short. Does
    nothing when the variable is unset."""

    def __init__(self) -> None:
        self.log_dir = os.environ.get("VAVAE_PROFILE")
        self.at = int(os.environ.get("VAVAE_PROFILE_AT", "10"))
        self.n = int(os.environ.get("VAVAE_PROFILE_STEPS", "5"))
        self._prof = None
        self._done = False
        self._start_i = 0

    def step(self, i: int, sync_on: Any = None) -> None:
        if not self.log_dir:
            return
        # >=, not ==: a loop resumed from a checkpoint feeds absolute step
        # numbers that may already be past ``at``; trace the first window seen
        if i >= self.at and self._prof is None and not self._done:
            _fence(sync_on)
            self._prof = _start_profiler(self.log_dir)
            self._start_i = i
        elif self._prof is not None and i >= self._start_i + self.n:
            _fence(sync_on)
            self._stop()

    def _stop(self) -> None:
        self._prof.stop()
        self._prof = None
        self._done = True

    def close(self) -> None:
        if self._prof is not None:
            _fence()
            self._stop()


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Bytes in use, peak bytes in use and total memory of each card
    (``torch.cuda.memory_stats``); empty without CUDA."""
    if not torch.cuda.is_available():
        return {}
    stats = {}
    for i in range(torch.cuda.device_count()):
        m = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": m.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": m.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return stats
