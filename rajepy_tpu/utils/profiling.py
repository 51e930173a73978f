"""Tracing and per-kernel timing.

The reference's only instrumentation is a wall-clock log line around the
fill-factor computation (classes.py:655, 743-750; SURVEY §5.1).  Here:

* :class:`KernelTimer` — context manager timing a device computation with a
  completion barrier, optionally logged through a ``rajepy_tpu.utils.Log``;
* :func:`trace` — context manager wrapping ``jax.profiler`` so a pipeline
  stage can be captured for TensorBoard/Perfetto with one line;
* :func:`timed_call` — time a jitted callable's steady-state execution.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import jax


# --------------------------------------------------------------------- #
# stage-time aggregation (opt-in): a caller (bench.py, chip_smoke.py)
# separates device-compute seconds from transfer/IO seconds and reads
# each stage's total.
# --------------------------------------------------------------------- #

_STAGE_TIMES: dict = {}
_COLLECTING = False

#: stage-name substrings whose time is device compute (dispatch-to-sync
#: of jitted programs; cube/mfs imaging timers include their overlapped
#: per-chunk host drains, which the overlap makes inseparable)
DEVICE_STAGE_MARKERS = ('grid fill', 'device compute', 'uv tracks',
                        'vis sampling', 'gain corruption', 'applycal',
                        'imaging', 'selfcal round')
#: stage-name substrings whose time is device->host product transfer
#: plus disk IO
TRANSFER_STAGE_MARKERS = ('write', 'product transfer')


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


#: live KernelTimer nesting stack (single-threaded pipeline): a nested
#: timer's seconds are subtracted from its parent's recorded stage so
#: the registry totals stay disjoint — e.g. a cold execute's 'grid fill'
#: timer fires inside the 'rt stage: device compute' timer, and without
#: the subtraction split_stage_times would count those seconds twice
#: (both names match DEVICE_STAGE_MARKERS)
_TIMER_STACK: list = []


class KernelTimer:
    """``with KernelTimer("fill factors", log) as t: ...`` — logs the
    elapsed wall time with a device sync at exit.

    The log line reports the INCLUSIVE elapsed time; the stage registry
    (:func:`record_stage`) receives the EXCLUSIVE time (children's
    seconds subtracted), keeping aggregated stage totals disjoint under
    nesting."""

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
        """Register device output(s) to block on before stopping the
        clock."""
        self._result = result

    def __exit__(self, exc_type, exc, tb):
        if self._result is not None:
            jax.block_until_ready(self._result)
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
    """Capture a jax.profiler trace of the enclosed block."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed_call(fn: Callable, *args, n_rep: int = 3, **kwargs):
    """(result, seconds-per-call) for the steady state of a jitted
    callable: one warm-up call, then ``n_rep`` timed calls with a final
    barrier."""
    out = jax.block_until_ready(fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(n_rep):
        out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    return out, (time.perf_counter() - t0) / n_rep
