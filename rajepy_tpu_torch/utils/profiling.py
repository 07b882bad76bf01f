"""Stage timing (PyTorch port of rajepy_tpu.utils.profiling).

* :class:`KernelTimer` — context manager timing a device computation with
  a completion barrier (``torch.cuda.synchronize`` when the registered
  result lives on a card), optionally logged through a ``Log``;
* :func:`record_stage` — opt-in per-stage aggregation of the timers'
  exclusive seconds (:func:`collect_stage_times`, :func:`stage_times`);
* :func:`span` — a named host span (``torch.profiler.record_function``)
  while a profiler records, nothing otherwise; each KernelTimer opens one
  as ``rajepy.<stage name>``;
* :data:`COUNTERS` / :func:`count` — event counts over the process's
  lifetime (RT runs, bytes of products copied out);
* :func:`trace` — context manager capturing a ``torch.profiler`` trace of
  a block and writing it as a Chrome trace (Perfetto, chrome://tracing).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.profiler import record_function


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


_profiler_enabled = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager marking ``name`` on the host timeline: a
    ``torch.profiler.record_function`` range while a profiler is
    recording (so the span shares the device trace's clock), else a
    shared no-op that costs one flag check."""
    if _profiler_enabled():
        return record_function(name)
    return _NO_SPAN


#: event counts for the process's lifetime ("rt.runs",
#: "rt.products_out_bytes"); the program never resets them
COUNTERS: dict = {}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    COUNTERS[name] = COUNTERS.get(name, 0) + n


#: live KernelTimer nesting stack: a nested timer's seconds are subtracted
#: from its parent's recorded stage so the registry totals stay disjoint
_TIMER_STACK: list = []


class KernelTimer:
    """``with KernelTimer("fill factors", log) as t: ...`` — logs the
    elapsed wall time with a device sync at exit.

    The log line reports the INCLUSIVE elapsed time; the stage registry
    (:func:`record_stage`) receives the EXCLUSIVE time (children's
    seconds subtracted).  While a profiler records, the timer is the span
    ``rajepy.<name>``."""

    def __init__(self, name: str, log=None, result=None):
        self.name = name
        self.log = log
        self.elapsed: Optional[float] = None
        self._result = result
        self._child_s = 0.0

    def __enter__(self):
        self._span = span('rajepy.' + self.name)
        self._span.__enter__()
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
        self._span.__exit__(exc_type, exc, tb)
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

