"""Per-stage timing and device tracing.

The reference has no profiling at all (SURVEY.md §5.1 — tqdm bars only);
this framework targets a perf number, so instrumentation is first-class:

- ``stage(name)``: context manager accumulating wall time per pipeline
  stage; a report prints at process exit when profiling is enabled.
- ``trace(logdir)``: wraps ``jax.profiler`` tracing for TensorBoard; set
  POPPUNK_TPU_TRACE_DIR to capture traces from any CLI run.

Enable with ``--profile`` on the CLIs or POPPUNK_TPU_PROFILE=1.
"""

import atexit
import contextlib
import os
import sys
import time
from collections import OrderedDict

_ENABLED = bool(os.environ.get("POPPUNK_TPU_PROFILE"))
_STAGES = OrderedDict()  # name -> [total_seconds, calls]
_REPORT_REGISTERED = False


def enable(flag=True):
    global _ENABLED, _REPORT_REGISTERED
    _ENABLED = flag
    if flag and not _REPORT_REGISTERED:
        atexit.register(report)
        _REPORT_REGISTERED = True


def enabled():
    return _ENABLED


if _ENABLED:
    enable(True)


@contextlib.contextmanager
def stage(name, sync=False):
    """Time a pipeline stage. With sync=True, waits for outstanding device
    work first so the stage is charged its true device time."""
    if not _ENABLED:
        yield
        return
    if sync:
        _device_sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            _device_sync()
        dt = time.perf_counter() - t0
        entry = _STAGES.setdefault(name, [0.0, 0])
        entry[0] += dt
        entry[1] += 1


def record(name, seconds):
    """Add an already-measured duration to stage ``name``."""
    if not _ENABLED:
        return
    entry = _STAGES.setdefault(name, [0.0, 0])
    entry[0] += seconds
    entry[1] += 1


def _device_sync():
    import jax

    # a trivial computation queued behind the stage's device work
    jax.block_until_ready(jax.numpy.zeros(()) + 0)


def report(stream=None):
    if not _STAGES:
        return
    stream = stream or sys.stderr
    total = sum(v[0] for v in _STAGES.values())
    stream.write("\n== poppunk_tpu stage timings ==\n")
    width = max(len(k) for k in _STAGES)
    for name, (secs, calls) in _STAGES.items():
        share = 100.0 * secs / total if total else 0.0
        stream.write(f"  {name.ljust(width)}  {secs:9.3f} s  "
                     f"x{calls:<5d} {share:5.1f}%\n")
    stream.write(f"  {'TOTAL'.ljust(width)}  {total:9.3f} s\n")


def timings():
    """Snapshot of accumulated timings: {stage: (seconds, calls)}."""
    return {k: tuple(v) for k, v in _STAGES.items()}


def reset():
    _STAGES.clear()


@contextlib.contextmanager
def trace(logdir=None):
    """jax.profiler trace around a block (TensorBoard format)."""
    logdir = logdir or os.environ.get("POPPUNK_TPU_TRACE_DIR")
    if not logdir:
        yield
        return
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        sys.stderr.write(f"Profiler trace written to {logdir}\n")
