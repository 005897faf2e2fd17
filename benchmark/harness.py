"""The benchmark's core: finds a cell, its configuration, its driver and
its metrics by name, runs set-up, the window and the checks, and builds
the result line.

Data-driven: ``cells/<cell>.json`` names its configuration
(``configs/<config>.json``) and its driver (``drivers/<driver>.py``);
``BENCHMARK.json`` lists the metrics, and ``metrics/<stem>.py`` reads
each one from the run's context (the stem is the metric's name before its
first dot).  A later cell, configuration or metric
is a new file and a new entry.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "lesv_tpu")


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_spec(name: str) -> dict:
    return load_json(os.path.join(HERE, "cells", name + ".json"))


def config_spec(name: str) -> dict:
    return load_json(os.path.join(HERE, "configs", name + ".json"))


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def metrics_of(man: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    return [m for m in man["per_layer" if trace else "end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    """``read(ctx)`` of ``metrics/<stem>.py``, the stem being the name
    before its first dot: ``fill_roofline.cns`` and
    ``fill_roofline.evidence`` share one reader."""
    stem = name.split(".", 1)[0]
    path = os.path.join(HERE, "metrics", stem + ".py")
    spec = importlib.util.spec_from_file_location("bench_metric_" + stem,
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``lesv_tpu_torch`` is not ``lesv_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def device_info(devices: list) -> dict:
    import torch

    if not devices or torch.device(devices[0]).type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(devices[0]),
                count=len(devices),
                memory_peak_bytes=max(torch.cuda.max_memory_allocated(d)
                                      for d in devices))


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else None


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        t_start: float, devices: list, cell: dict | None = None,
        config: dict | None = None, man: dict | None = None) -> dict:
    """One run of a cell; returns the result line's object.  ``devices``
    are the torch devices the cell uses (the tests pass the CPU)."""
    import torch

    from benchmark import trace as tr

    cell = cell or cell_spec(cell_name)
    config = config or config_spec(cell["config"])
    man = man or manifest()
    driver = importlib.import_module("benchmark.drivers." + cell["driver"])
    on_card = torch.device(devices[0]).type == "cuda"
    state = driver.setup(cell, config, seed, devices)
    ctx: dict = dict(cell=cell_name, seed=seed, seconds=seconds,
                     setup_s=time.perf_counter() - t_start)
    spans0 = _spans()
    stats0 = _fill_stats()
    if trace and on_card:
        with tr.count_work() as work, tr.device_trace(devices) as dt:
            driver.window(state, seconds, ctx)
        ctx["trace"] = dt
        ctx["work"] = work.totals()
    else:
        driver.window(state, seconds, ctx)
    ctx["spans"] = {k: v - spans0.get(k, 0.0) for k, v in _spans().items()}
    stats1 = _fill_stats()
    ctx["fill_stats"] = {k: stats1[k] - stats0.get(k, 0) for k in stats1}
    dev = device_info(devices)
    driver.release(state)
    checks = driver.check(state, ctx)
    metrics = {}
    for m in metrics_of(man, cell_name, trace):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    if trace and "trace" in ctx:
        dev["busy_s"] = ctx["trace"]["busy_s"]
        dev["window_s"] = ctx["trace"]["window_s"]
        dev["power"] = power_limit()
    out = dict(correct=all(c["value"] <= c["limit"] for c in checks.values()),
               attempted=ctx["attempted"], failed=ctx.get("failed", 0),
               metrics=metrics, device=dev)
    if trace and "trace" in ctx:
        t = ctx["trace"]
        top = sorted(t["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(t["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = dict(device_ops=[[k[:120], v] for k, v in top],
                                idle_gaps=[[k, v] for k, v in gaps])
    out["info"] = dict(ctx.get("info", {}), setup_s=ctx["setup_s"])
    out["checks"] = checks
    return out


def _spans() -> dict:
    from lesv_tpu_torch.utils import profiling

    return {k: v["total_s"] for k, v in profiling.report().items()}


def _fill_stats() -> dict:
    from lesv_tpu_torch.ops import align_batch

    return dict(align_batch.FILL_STATS)
