"""The port's span registry (``lesv_tpu_torch.utils.profiling``): counts,
totals and self time per name, one stack of open spans per thread, the
``lesv/`` ranges in a torch profiler trace, the idle reader over such a
trace and its tool.  The registry is module state: each test resets it."""

import json
import os
import subprocess
import sys
import threading
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lesv_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def clock(monkeypatch):
    """The registry's clock, advanced by hand: ``clock.t``."""
    fake = types.SimpleNamespace(t=0.0)
    fake.perf_counter = lambda: fake.t
    monkeypatch.setattr(profiling, "time", fake)
    monkeypatch.setattr(profiling, "_enabled", True)
    profiling.reset()
    yield fake
    profiling.reset()


def test_nesting_gives_self_time(clock):
    with profiling.trace("p"):
        clock.t = 1.0
        with profiling.trace("p/c"):
            clock.t = 3.0
        clock.t = 4.0
        with profiling.trace("p/c"):
            clock.t = 4.5
            with profiling.trace("p/c/d"):
                clock.t = 5.0
        clock.t = 10.0
    rep = profiling.report()
    assert rep["p"] == dict(count=1, total_s=10.0, mean_s=10.0, self_s=7.0)
    assert rep["p/c"] == dict(count=2, total_s=3.0, mean_s=1.5, self_s=2.5)
    assert rep["p/c/d"]["self_s"] == rep["p/c/d"]["total_s"] == 0.5


def test_spans_on_two_threads_do_not_parent_each_other(clock):
    """A span opened on a worker while the submitting thread has one open
    is no child of it: both keep all their seconds as self time."""
    opened, closed = threading.Event(), threading.Event()

    def worker():
        with profiling.trace("worker"):
            opened.set()
            assert closed.wait(10)

    t = threading.Thread(target=worker)
    with profiling.trace("caller"):
        t.start()
        assert opened.wait(10)
        clock.t = 2.0
        closed.set()
        t.join(10)
    assert not t.is_alive()
    rep = profiling.report()
    assert rep["caller"]["self_s"] == rep["caller"]["total_s"] == 2.0
    assert rep["worker"]["self_s"] == rep["worker"]["total_s"]


def test_counts_and_totals_aggregate(clock, tmp_path):
    for dt in (0.25, 0.5, 1.25):
        with profiling.trace("unit/a"):
            clock.t += dt
    rep = profiling.report()
    assert rep == {"unit/a": dict(count=3, total_s=2.0,
                                  mean_s=round(2.0 / 3, 6), self_s=2.0)}
    p = str(tmp_path / "profile.json")
    profiling.dump_json(p)
    with open(p) as fh:
        assert json.load(fh) == rep


def test_trace_off_records_nothing(clock, monkeypatch):
    monkeypatch.setattr(profiling, "_enabled", False)
    with profiling.trace("unit/off"):
        with profiling.trace("unit/off/inner"):
            clock.t = 1.0
    assert profiling.report() == {}


def test_many_threads_lose_no_span(monkeypatch):
    """More threads than cores, a short switch interval: every span of
    every thread is counted once."""
    monkeypatch.setattr(profiling, "_enabled", True)
    profiling.reset()
    n_threads, per = 24, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with profiling.trace("stress"):
                    with profiling.trace("stress/inner"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rep = profiling.report()
    assert rep["stress"]["count"] == rep["stress/inner"]["count"] == \
        n_threads * per
    assert rep["stress"]["self_s"] <= rep["stress"]["total_s"]
    profiling.reset()


def _ranges(events):
    return {e["name"]: e for e in events
            if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("lesv/")}


def test_span_is_a_range_nested_under_its_parent(monkeypatch, tmp_path):
    monkeypatch.setattr(profiling, "_enabled", True)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.trace("outer"):
            torch.arange(64).sum()
            with profiling.trace("outer/inner"):
                torch.arange(64).sum()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        got = _ranges(json.load(fh)["traceEvents"])
    outer, inner = got["lesv/outer"], got["lesv/outer/inner"]
    assert inner["tid"] == outer["tid"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert profiling.report()["outer"]["count"] == 1
    profiling.reset()


def test_no_range_object_without_the_profiler(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a range was made with the profiler off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_enabled", True)
    profiling.reset()
    with profiling.trace("quiet"):
        torch.ones(4).sum()
    assert profiling.report()["quiet"]["count"] == 1
    profiling.reset()


def _x(name, cat, ts, dur, tid=1):
    return dict(name=name, cat=cat, ph="X", ts=ts, dur=dur, tid=tid,
                pid=1)


# a trace of 140 us (-20..120, from the benchmark's range): stage 0..100
# holding select 10..60 holding realign 20..40; kernels 0..5, 30..35 (and a
# copy overlapping it 33..38), 70..80, 110..115; the card's projection of a
# range is no range
EVENTS = [
    _x("lesv/stage/x", "user_annotation", 0, 100),
    _x("lesv/svr/select", "user_annotation", 10, 50),
    _x("lesv/svr/realign", "user_annotation", 20, 20),
    _x("bench/x", "user_annotation", -20, 140),
    _x("lesv/stage/x", "gpu_user_annotation", 0, 100, tid=7),
    _x("k1", "kernel", 0, 5, tid=7),
    _x("k2", "kernel", 30, 5, tid=7),
    _x("copy", "gpu_memcpy", 33, 5, tid=8),
    _x("k3", "kernel", 70, 10, tid=7),
    _x("k4", "kernel", 110, 5, tid=7),
    dict(name="meta", ph="M"),
]


def test_idle_by_span_on_hand_built_events():
    r = profiling.idle_by_span(EVENTS)
    assert r["window_s"] == pytest.approx(140e-6)
    assert r["busy_s"] == pytest.approx(28e-6)
    assert r["idle_s"] == pytest.approx(112e-6)
    # idle stretches -20..0 (mid -10: none), 5..30 (mid 17.5: select),
    # 38..70 (mid 54: select), 80..110 (mid 95: stage), 115..120 (none)
    assert r["by_span"] == pytest.approx({"svr/select": 57e-6,
                                          "stage/x": 30e-6,
                                          "between spans": 25e-6})
    assert list(r["by_span"]) == ["svr/select", "stage/x", "between spans"]
    # stretches in a nested range and in the next one
    ev = [_x("lesv/a", "user_annotation", 0, 10),
          _x("lesv/a/b", "user_annotation", 2, 6),
          _x("lesv/c", "user_annotation", 20, 10),
          _x("k", "kernel", 0, 1)]
    r = profiling.idle_by_span(ev)
    assert r["by_span"] == pytest.approx({"between spans": 29e-6})
    ev.append(_x("k", "kernel", 9, 12))
    r = profiling.idle_by_span(ev)
    assert r["by_span"] == pytest.approx({"a/b": 8e-6, "c": 9e-6})
    # no program range: all of it between spans; no timed event: nothing
    r = profiling.idle_by_span(EVENTS[3:])
    assert r["by_span"] == pytest.approx({"between spans": 112e-6})
    assert profiling.idle_by_span([EVENTS[-1]])["window_s"] == 0.0


def test_idle_by_span_tool(tmp_path):
    path = str(tmp_path / "trace.json")
    with open(path, "w") as fh:
        json.dump({"traceEvents": EVENTS}, fh)
    tool = os.path.join(REPO, "tools", "torch_idle_by_span.py")
    out = subprocess.run([sys.executable, tool, path], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    lines = out.splitlines()
    assert lines[0] == ("window 0.000140 s, device busy 0.000028 s, "
                        "idle 0.000112 s")
    rows = [ln.split(None, 2) for ln in lines[2:]]
    assert [r[2] for r in rows] == ["svr/select", "stage/x", "between spans"]
    assert [r[0] for r in rows] == ["0.000057", "0.000030", "0.000025"]
    assert rows[0][1] == "50.89%"
