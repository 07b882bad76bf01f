"""Stage timing (PyTorch port of rajepy_tpu.utils.profiling).

* :class:`KernelTimer` — context manager timing a device computation with
  a completion barrier (``torch.cuda.synchronize`` when the registered
  result lives on a card), optionally logged through a ``Log``;
* :func:`record_stage` — opt-in per-stage aggregation of the timers'
  exclusive seconds (:func:`collect_stage_times`, :func:`stage_times`,
  :func:`split_stage_times`);
* :func:`trace` — context manager capturing a ``torch.profiler`` trace of
  a block and writing it as a Chrome trace (Perfetto, chrome://tracing);
* :func:`timed_call` — time a callable's steady-state execution.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


def _tensors(result):
    """The tensors of a result: a tensor, or (nested) tuples, lists and
    dict values of them."""
    if torch.is_tensor(result):
        yield result
    elif isinstance(result, (tuple, list)):
        for r in result:
            yield from _tensors(r)
    elif isinstance(result, dict):
        for r in result.values():
            yield from _tensors(r)


def _sync(result) -> None:
    """Wait for the device work that produces ``result`` (a tensor or a
    nest of them) to finish: one synchronisation per card it lies on."""
    for dev in {t.device for t in _tensors(result) if t.is_cuda}:
        torch.cuda.synchronize(dev)


_STAGE_TIMES: dict = {}
_COLLECTING = False


def collect_stage_times(enable: bool = True) -> None:
    """Start (or stop) aggregating KernelTimer/record_stage durations
    into a process-global registry; starting clears it."""
    global _COLLECTING
    _COLLECTING = enable
    if enable:
        _STAGE_TIMES.clear()


def record_stage(name: str, seconds: float) -> None:
    """Add ``seconds`` to the named stage's total (no-op unless
    :func:`collect_stage_times` is active)."""
    if _COLLECTING:
        _STAGE_TIMES[name] = _STAGE_TIMES.get(name, 0.0) + float(seconds)


def stage_times() -> dict:
    """Snapshot of the aggregated {stage name: total seconds}."""
    return dict(_STAGE_TIMES)


#: stage-name substrings whose time is device compute (launch to sync of
#: device work; the imaging timers include their host drains)
DEVICE_STAGE_MARKERS = ('grid fill', 'device compute', 'uv tracks',
                        'vis sampling', 'gain corruption', 'applycal',
                        'imaging', 'selfcal round')
#: stage-name substrings whose time is device->host product transfer
#: plus disk IO
TRANSFER_STAGE_MARKERS = ('write', 'product transfer')


def split_stage_times(times: Optional[dict] = None):
    """(device_compute_s, transfer_io_s, other_s) totals of a stage-time
    dict per the marker lists above."""
    times = stage_times() if times is None else times
    dev = tr = other = 0.0
    for name, s in times.items():
        if any(m in name for m in TRANSFER_STAGE_MARKERS):
            tr += s
        elif any(m in name for m in DEVICE_STAGE_MARKERS):
            dev += s
        else:
            other += s
    return dev, tr, other


#: live KernelTimer nesting stack: a nested timer's seconds are subtracted
#: from its parent's recorded stage so the registry totals stay disjoint
_TIMER_STACK: list = []


class KernelTimer:
    """``with KernelTimer("fill factors", log) as t: ...`` — logs the
    elapsed wall time with a device sync at exit.

    The log line reports the INCLUSIVE elapsed time; the stage registry
    (:func:`record_stage`) receives the EXCLUSIVE time (children's
    seconds subtracted)."""

    def __init__(self, name: str, log=None, result=None):
        self.name = name
        self.log = log
        self.elapsed: Optional[float] = None
        self._result = result
        self._child_s = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        _TIMER_STACK.append(self)
        return self

    def set_result(self, result):
        """Register a device output (a tensor or a nest of them) to wait
        for before stopping the clock."""
        self._result = result

    def __exit__(self, exc_type, exc, tb):
        if self._result is not None:
            _sync(self._result)
        self.elapsed = time.perf_counter() - self._t0
        if _TIMER_STACK and _TIMER_STACK[-1] is self:
            _TIMER_STACK.pop()
        if _TIMER_STACK:
            _TIMER_STACK[-1]._child_s += self.elapsed
        if exc_type is None:
            record_stage(self.name,
                         max(self.elapsed - self._child_s, 0.0))
        if self.log is not None and exc_type is None:
            self.log.add_entry(
                "INFO", f"[timing] {self.name}: {self.elapsed:.3f}s",
                timestamp=False)
        return False


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block (host
    activity, and the card's where one is present) and write it to
    ``logdir/trace.json`` as a Chrome trace.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


def timed_call(fn: Callable, *args, n_rep: int = 3, **kwargs):
    """(result, seconds-per-call) for the steady state of a callable: one
    warm-up call, then ``n_rep`` timed calls with a final synchronisation
    of the result's card."""
    out = fn(*args, **kwargs)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(n_rep):
        out = fn(*args, **kwargs)
    _sync(out)
    return out, (time.perf_counter() - t0) / n_rep
