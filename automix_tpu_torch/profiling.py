"""Profiling helpers: a device trace, stage timers and throughput.

Counterpart of ``automix_tpu/profiling.py``.  :func:`trace` records the
enclosed block with ``torch.profiler`` (the CUDA and CPU activities where
a card is present, the CPU alone otherwise) and writes a Chrome trace
file under its directory, which Perfetto or ``chrome://tracing`` opens:
each kernel launch and torch operation with its device and host time.
:class:`StageTimer` keeps named wall-clock segments, each closed after
the device of its ``sync`` tensors has finished its queued work, and
:func:`throughput` reads the aggregate stage-3 chain-sweeps/s of a
``RunStats``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Capture a trace of the enclosed block into a Chrome trace file
    ``logdir/trace_<pid>_<n>.json`` (the directory made if missing).
    Yields the profiler, whose ``key_averages()`` tables the same
    events.  Example::

        with profiling.trace("traces/run1"):
            am.rjmcmc_samples(1000)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        n = len([f for f in os.listdir(logdir) if f.startswith("trace_")])
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))


def _synchronize(sync) -> None:
    """Wait for the devices of the tensor (or the tensors of a sequence)
    ``sync`` to finish their queued work."""
    for x in (sync,) if isinstance(sync, torch.Tensor) else sync:
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)


class StageTimer:
    """Named wall-clock segments with a summary, device-synchronized."""

    def __init__(self):
        self.segments = {}

    @contextlib.contextmanager
    def segment(self, name: str, sync=None) -> Iterator[None]:
        """Time the enclosed block into segment ``name`` (segments of one
        name add up).  ``sync``, a tensor or a sequence of tensors, is
        waited for before the clock is read, so work queued on the card
        counts in its segment."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            self.segments[name] = self.segments.get(name, 0.0) + (
                time.perf_counter() - t0)

    def summary(self) -> str:
        total = sum(self.segments.values()) or 1.0
        lines = [f"{name}: {secs:.3f}s ({100 * secs / total:.1f}%)"
                 for name, secs in sorted(self.segments.items(),
                                          key=lambda kv: -kv[1])]
        return "\n".join(lines)


def throughput(stats) -> Optional[float]:
    """Aggregate stage-3 chain-sweeps/s of an accumulated RunStats, None
    before any time is recorded."""
    if stats is None or stats.timesecs_rjmcmc <= 0:
        return None
    return stats.n_chains * stats.nsweeps / stats.timesecs_rjmcmc
