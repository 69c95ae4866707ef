"""Profiler harness: ``torch.profiler`` traces around a benchmark region.

The port's copy of ``ceph_tpu/utils/profiling.py`` (ref: the
reference's tracing stack, SURVEY.md §5.1: PerfCounters + LTTng/Blkin
spans). ``trace()`` wraps ``torch.profiler.profile`` (the CPU's
activity, and the card's through CUPTI when CUDA is available) around a
region and writes a Chrome trace into ``log_dir`` (open it in
ui.perfetto.dev or chrome://tracing); ``annotate()`` names a sub-region
in that trace (``torch.profiler.record_function``). Both are no-ops
when ``log_dir`` is None, and a profiler that cannot start logs and
lets the run go on: profiling never breaks a benchmark run.
"""

from __future__ import annotations

import contextlib
import os
import time

from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("prof")

TRACE_FILE = "trace-{pid}-{stamp}.json"


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the enclosed region into ``log_dir`` (None = no-op): one
    Chrome trace file, ``TRACE_FILE`` formatted with the pid and the
    start time."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = None
    try:
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # pragma: no cover - platform dependent
        prof = None
        log.dout(1, "profiler unavailable", error=str(e))
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                path = os.path.join(log_dir, TRACE_FILE.format(
                    pid=os.getpid(), stamp=int(time.time() * 1e3)))
                prof.export_chrome_trace(path)
                log.dout(1, "profile written", dir=log_dir)
            except Exception as e:  # pragma: no cover
                log.dout(1, "profiler stop failed", error=str(e))


def annotate(name: str):
    """Named sub-region (``record_function``) for kernel attribution."""
    from torch.profiler import record_function

    return record_function(name)
