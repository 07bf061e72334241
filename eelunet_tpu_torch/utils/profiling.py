"""Tracing and step timing (counterpart of ``eelunet_tpu/utils/profiling.py``).

- ``trace_context``: a ``torch.profiler`` trace over the enclosed region,
  CPU and (on a card) CUDA activity, written as a Chrome trace into a
  directory; a no-op without one.
- ``StepTimer``: wall-clock step timing that waits for the device before it
  reads the clock, with EWMA smoothing and images/s.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_trace(log_dir: str):
    """Start a profiler that writes its Chrome trace into ``log_dir``
    (``*.pt.trace.json``, TensorBoard's layout) when ``stop_trace`` ends it.
    Work enqueued before the call finishes first, so it stays out of the
    trace."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=_activities(),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    return prof


def stop_trace(prof) -> None:
    """Wait for the device to finish the traced work, then stop ``prof``,
    which writes the trace."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]):
    """Trace the enclosed region into ``log_dir``; no-op if it is falsy. The
    trace is stopped and written even when the region raises."""
    if not log_dir:
        yield
        return
    prof = start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace(prof)


def _sync(result) -> None:
    """Wait until the device has computed ``result`` (tensors, or nested
    tuples, lists and dicts of them)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.current_stream(result.device).synchronize()
    elif isinstance(result, dict):
        for v in result.values():
            _sync(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _sync(v)


class StepTimer:
    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        """Wait for the device to finish ``result`` and record the elapsed
        step time in seconds."""
        if result is not None:
            _sync(result)
        dt = time.perf_counter() - self._t0
        self.ewma = dt if self.ewma is None else (1 - self.alpha) * self.ewma + self.alpha * dt
        return dt

    def images_per_sec(self, batch_size: int) -> float:
        return batch_size / self.ewma if self.ewma else 0.0
