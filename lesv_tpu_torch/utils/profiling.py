"""Structured tracing / profiling.

The reference has only wall-clock stderr timers (`hbn_aux.h:97-106`,
hbn_timing_begin/end) and commented-out gperftools hooks
(`app/map/main.c:39,74`).  This build provides three structured layers
on top of the same per-stage timers:

* `trace(name)` — span context manager feeding an in-process registry;
  nestable; thread-safe; ~zero cost when disabled.  Spans opened on the
  dispatch and map worker threads add up, so a span's total (and a
  parent span's) can exceed the wall time it ran in.
* machine-readable report: `report()` returns {span: {count, total_s,
  mean_s}}; `dump_json(path)` writes it.
* device profiling: `device_trace(logdir)` wraps `torch.profiler.profile`
  (CPU and, with a GPU, CUDA activities; a Chrome trace) when
  `LESV_TORCH_PROFILE=dir` or used explicitly; `annotate(name)` names a
  region inside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict

_lock = threading.Lock()
_spans: dict[str, list[float]] = defaultdict(list)
_enabled = os.environ.get("LESV_TORCH_TRACE", "1") != "0"


def reset() -> None:
    with _lock:
        _spans.clear()


@contextlib.contextmanager
def trace(name: str):
    """Span timer: accumulates wall time under `name` (nest with '/')."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _spans[name].append(dt)


def add(name: str, seconds: float) -> None:
    """Record an externally-measured span (e.g. driver stage timers)."""
    with _lock:
        _spans[name].append(seconds)


def report() -> dict[str, dict[str, float]]:
    with _lock:
        return {
            k: {
                "count": len(v),
                "total_s": round(sum(v), 4),
                "mean_s": round(sum(v) / len(v), 6),
            }
            for k, v in sorted(_spans.items())
        }


def dump_json(path: str) -> None:
    with open(path, "w") as fh:
        json.dump(report(), fh, indent=2)


@contextlib.contextmanager
def device_trace(logdir: str | None = None):
    """torch profiler over the wrapped region; writes `trace.json` (Chrome
    trace format) into `logdir`.

    Enabled when `logdir` is given or `LESV_TORCH_PROFILE` is set; no-op
    otherwise, so callers can wrap hot paths unconditionally.
    """
    logdir = logdir or os.environ.get("LESV_TORCH_PROFILE")
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region visible in device profiles (``device_trace``): a
    ``torch.profiler.record_function`` context manager."""
    from torch.profiler import record_function

    return record_function(name)
