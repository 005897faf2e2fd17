"""Spans: where the port's time goes, by name, in-process and in the
torch profiler's trace.

The reference has only wall-clock stderr timers (`hbn_aux.h:97-106`,
hbn_timing_begin/end) and commented-out gperftools hooks
(`app/map/main.c:39,74`).  This module is the port's one span registry:

* ``trace(name)`` opens a span (nest names with '/').  Per name the
  registry keeps ``count``, ``total_s`` and ``self_s``: ``total_s`` the
  seconds of every span of that name, summed over threads, so spans
  opened on the dispatch and map worker threads add up to thread-seconds
  and can exceed the wall time they ran in; ``self_s`` the same less the
  seconds of the child spans opened inside it on the same thread.  Each
  thread keeps its own stack of open spans: a span opened on a pool
  worker has no parent, even when the thread that submitted its work has
  a span open, so its seconds are its own and not its submitter's child.
  ``LESV_TORCH_TRACE=0`` (read once, at import) turns spans off.
* ``report()`` returns ``{name: {count, total_s, mean_s, self_s}}``;
  ``dump_json(path)`` writes it (``run_pipeline`` writes
  ``profile.json`` into its ``out_dir``).
* While the torch profiler records on the span's thread, a span is also
  a ``record_function`` range named ``lesv/<name>``, so the spans sit in
  the Chrome trace nested as they ran, on the clock of the kernels,
  copies and memsets.  With the profiler off a span reads one flag and
  makes no range.  ``device_trace(logdir)`` wraps a region in the
  profiler (CPU and, with a GPU, CUDA activity) and writes
  ``trace.json``; ``LESV_TORCH_PROFILE=dir`` wraps ``run_pipeline``.
* ``idle_by_span(events)`` reads such a trace back: the seconds in which
  no kernel, copy or memset ran, by the innermost ``lesv/`` range they
  fell in, ``between spans`` outside every range
  (``tools/torch_idle_by_span.py`` prints it).
"""

from __future__ import annotations

import contextlib
import heapq
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _tprof

RANGE_PREFIX = "lesv/"
BETWEEN = "between spans"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_lock = threading.Lock()
_stats: dict[str, list] = {}        # name -> [count, total_s, self_s]
_local = threading.local()
_enabled = os.environ.get("LESV_TORCH_TRACE", "1") != "0"


def reset() -> None:
    with _lock:
        _stats.clear()


class _Span:
    __slots__ = ("name", "t0", "child_s", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.child_s = 0.0
        self.rf = None
        # the global flag first: off, no call into torch at all; on, the
        # range only where this thread records (pool workers may not)
        if _tprof._is_profiler_enabled and \
                torch._C._autograd._profiler_enabled():
            self.rf = _tprof.record_function(RANGE_PREFIX + self.name)
            self.rf.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child_s += dt
        own = dt - self.child_s
        with _lock:
            agg = _stats.get(self.name)
            if agg is None:
                _stats[self.name] = [1, dt, own]
            else:
                agg[0] += 1
                agg[1] += dt
                agg[2] += own
        return False


_OFF = contextlib.nullcontext()


def trace(name: str):
    """A span named ``name``: a context manager that adds its seconds to
    the registry, and a ``lesv/<name>`` range to a recording profiler."""
    return _Span(name) if _enabled else _OFF


def report() -> dict[str, dict[str, float]]:
    with _lock:
        return {
            k: {
                "count": n,
                "total_s": round(tot, 4),
                "mean_s": round(tot / n, 6),
                "self_s": round(own, 4),
            }
            for k, (n, tot, own) in sorted(_stats.items())
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
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _union(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Sorted, merged intervals."""
    out: list[list[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_by_span(events: list) -> dict:
    """The device's idle seconds in a Chrome trace, by program span.

    ``events`` are a trace's ``traceEvents`` (timestamps in
    microseconds).  The window runs from the first event's start to the
    last one's end; the device is idle where no kernel, copy or memset
    runs on any device.  Each idle stretch goes to the innermost
    (shortest) ``lesv/`` range that covers its midpoint, on any thread,
    or to ``"between spans"``.  Returns ``window_s``, ``busy_s``,
    ``idle_s`` and ``by_span`` ({span name: idle seconds}, largest
    first); all zero for a trace without events."""
    dev: list[tuple[float, float]] = []
    ranges: list[tuple[float, float, str]] = []
    lo, hi = float("inf"), float("-inf")
    for e in events:
        if "dur" not in e or "ts" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        lo, hi = min(lo, a), max(hi, b)
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append((a, b))
        elif cat == "user_annotation" and \
                str(e.get("name", "")).startswith(RANGE_PREFIX):
            ranges.append((a, b, e["name"][len(RANGE_PREFIX):]))
    if lo >= hi:
        return dict(window_s=0.0, busy_s=0.0, idle_s=0.0, by_span={})
    busy = _union(dev)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < hi:
        gaps.append((t, hi))
    # one sweep over the midpoints, in order: a heap of the ranges begun,
    # shortest on top; a top that ended before this midpoint has ended
    # before every later one
    ranges.sort()
    open_: list[tuple[float, float, str]] = []
    by: dict[str, float] = {}
    k = 0
    for a, b in gaps:
        mid = (a + b) / 2
        while k < len(ranges) and ranges[k][0] <= mid:
            ra, rb, n = ranges[k]
            heapq.heappush(open_, (rb - ra, rb, n))
            k += 1
        while open_ and open_[0][1] <= mid:
            heapq.heappop(open_)
        name = open_[0][2] if open_ else BETWEEN
        by[name] = by.get(name, 0.0) + (b - a) * 1e-6
    return dict(window_s=(hi - lo) * 1e-6,
                busy_s=sum(b - a for a, b in busy) * 1e-6,
                idle_s=sum(b - a for a, b in gaps) * 1e-6,
                by_span=dict(sorted(by.items(), key=lambda kv: -kv[1])))
