"""What the ``--trace 1`` run reads: the card's profiler trace over the
window, and the work of the fill and chain kernels, counted from the
arguments at their entries.

The counters wrap ``align_batch.banded_align_dispatch`` (every fill, mesh
or not, goes through it) and ``chain_torch.chain_scan_cuda`` from the
benchmark's side for the traced window only; the program is unchanged.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time

from benchmark import arith

FILL_KERNELS = ("fill_warp", "fill_block")
CHAIN_KERNELS = ("chain_kernel",)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANNOTATION = "bench/"


class Work:
    """Bytes and operations of the fill and chain launches in a window."""

    def __init__(self):
        self.lock = threading.Lock()
        self.fill_bytes = self.fill_ops = 0
        self.chain_bytes = 0
        self.chain_J = []           # (J, device tensor of valid seeds)

    def totals(self) -> dict:
        chain_ops = sum(int(v.sum()) * J * arith.CHAIN_OPS_PER_PAIR
                        for J, v in self.chain_J)
        return dict(fill_bytes=self.fill_bytes, fill_ops=self.fill_ops,
                    chain_bytes=self.chain_bytes, chain_ops=chain_ops)


@contextlib.contextmanager
def count_work():
    """Count the fill and chain kernels' work while the block runs."""
    from lesv_tpu_torch.ops import align_batch, chain_torch

    work = Work()
    dispatch = align_batch.banded_align_dispatch
    scan = chain_torch.chain_scan_cuda

    def counted_dispatch(q, s, qlen, slen, W, *a, **kw):
        nbytes, ops = arith.fill_work(qlen, slen, W)
        with work.lock:
            work.fill_bytes += nbytes
            work.fill_ops += ops
        return dispatch(q, s, qlen, slen, W, *a, **kw)

    def counted_scan(qs, ss, vs, J, *a, **kw):
        B, M = qs.shape
        # the valid count stays on the card until the window has closed
        with work.lock:
            work.chain_bytes += B * M * arith.CHAIN_BYTES_PER_SLOT
            work.chain_J.append((J, (vs != 0).sum()))
        return scan(qs, ss, vs, J, *a, **kw)

    align_batch.banded_align_dispatch = counted_dispatch
    chain_torch.chain_scan_cuda = counted_scan
    try:
        yield work
    finally:
        align_batch.banded_align_dispatch = dispatch
        chain_torch.chain_scan_cuda = scan


def annotate(name: str):
    """A host range in the trace that names what an idle gap waited on."""
    from torch.profiler import record_function

    return record_function(ANNOTATION + name)


@contextlib.contextmanager
def device_trace(devices: list):
    """``torch.profiler`` (CPU and CUDA activity) over the block; yields a
    dict that is filled once the block ends: ``window_s``, ``busy_s`` (the
    union of kernel, copy and memset intervals of each card, averaged over
    ``devices``), ``kernel_s`` by kernel name, and ``idle_gaps`` by the
    benchmark's host range that each idle stretch fell in."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out: dict = {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    for d in devices:
        torch.cuda.synchronize(d)
    with prof:
        t0 = time.perf_counter()
        yield out
        for d in devices:
            torch.cuda.synchronize(d)
        out["window_s"] = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    out.update(read_events(events, len(devices)))


def read_events(events: list, n_devices: int) -> dict:
    """Busy seconds, kernel seconds by name and idle gaps from the events
    of a Chrome trace (timestamps in microseconds)."""
    per_dev: dict = {}
    kernel_s: dict = {}
    host: list = []
    for e in events:
        if "dur" not in e or "ts" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev = e.get("args", {}).get("device", 0)
            per_dev.setdefault(dev, []).append((a, b))
            if cat == "kernel":
                kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + \
                    float(e["dur"]) * 1e-6
        elif cat == "user_annotation" and \
                e.get("name", "").startswith(ANNOTATION):
            host.append((a, b, e["name"][len(ANNOTATION):]))
    busy = [arith.union_s(v) * 1e-6 for v in per_dev.values()]
    gaps: dict = {}
    if host:
        h_lo = min(a for a, _, _ in host)
        h_hi = max(b for _, b, _ in host)
        spans = [s for v in per_dev.values() for s in v]
        for a, b in arith.idle_gaps(spans, h_lo, h_hi):
            mid = (a + b) / 2
            name = "between stages"
            inner = [(hb - ha, n) for ha, hb, n in host if ha <= mid < hb]
            if inner:
                name = min(inner)[1]
            gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    return dict(busy_s=sum(busy) / max(1, n_devices), kernel_s=kernel_s,
                idle_gaps=gaps)


def kernel_time(kernel_s: dict, names: tuple) -> float:
    return sum(v for k, v in kernel_s.items() if any(n in k for n in names))
