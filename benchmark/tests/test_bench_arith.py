"""The yardstick's arithmetic on known shapes and intervals: the least
time of the fill and chain kernels' work, the busy union and idle gaps of
a trace, and the per-layer readers built on them."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import arith, harness, trace


def test_union_and_gaps():
    spans = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert arith.union_s(spans) == 4.0
    assert arith.idle_gaps(spans, 0.0, 8.0) == [(3.0, 5.0), (6.0, 8.0)]
    assert arith.idle_gaps([], 1.0, 2.0) == [(1.0, 2.0)]
    assert arith.union_s([]) == 0.0


def test_fill_work_counts_live_lanes_once():
    qlen = np.array([100, 50, 0])
    slen = np.array([120, 60, 0])
    nbytes, ops = arith.fill_work(qlen, slen, 64)
    rows, B = 150, 2
    assert ops == rows * 64 * 42
    assert nbytes == rows + 180 + 8 * B + (rows + B) * 64 + 13 * B


def test_least_time_is_the_larger_bound():
    # 16.75e12 operations take one second; 3.35e12 bytes take one second
    assert arith.least_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert arith.least_s(1.0, 2 * arith.INT32_OPS_S) == pytest.approx(2.0)
    assert arith.INT32_OPS_S == 67e12 / 4
    assert arith.chain_work(2, 8, 64, 10) == (2 * 8 * 25, 10 * 64 * 34)


def _events():
    k = dict(cat="kernel", args={"device": 0})
    return [
        dict(k, name="void fill_warp<I32>(x)", ts=100.0, dur=50.0),
        dict(k, name="void fill_block<int>(x)", ts=120.0, dur=80.0),
        dict(k, name="void chain_kernel<2>(x)", ts=400.0, dur=100.0),
        dict(cat="gpu_memcpy", name="Memcpy DtoH", ts=600.0, dur=100.0,
             args={"device": 0}),
        dict(cat="user_annotation", name="bench/map_all", ts=0.0, dur=500.0),
        dict(cat="user_annotation", name="bench/extract_signatures",
             ts=500.0, dur=500.0),
        dict(cat="cpu_op", name="aten::add", ts=10.0, dur=5.0),
    ]


def test_read_events():
    r = trace.read_events(_events(), 1)
    assert r["busy_s"] == pytest.approx(300e-6)
    assert trace.kernel_time(r["kernel_s"], trace.FILL_KERNELS) == \
        pytest.approx(130e-6)
    assert trace.kernel_time(r["kernel_s"], trace.CHAIN_KERNELS) == \
        pytest.approx(100e-6)
    assert r["idle_gaps"]["map_all"] == pytest.approx(300e-6)
    assert r["idle_gaps"]["extract_signatures"] == pytest.approx(400e-6)


def _ctx():
    r = trace.read_events(_events(), 1)
    r["window_s"] = 1000e-6
    return dict(trace=r, work=dict(fill_bytes=0, fill_ops=int(0.5 * 130e-6 * arith.INT32_OPS_S),
                                   chain_bytes=int(3.35e12 * 25e-6),
                                   chain_ops=1),
                fill_stats=dict(device_cells=3, host_cells=1),
                spans={"map/read_chains": 2.0, "cns/admission": 1.0},
                evidence_bases=4_000_000, cns_bases=2_000_000, window_s=2.0,
                map_s=1.0, svsig_s=1.0, setup_s=7.0)


@pytest.mark.parametrize("name,want", [
    ("fill_roofline.evidence", 50.0),
    ("fill_roofline.cns", 50.0),
    ("chain_roofline.evidence", 25.0),
    ("device_idle_share.evidence", 70.0),
    ("device_idle_share.cns", 70.0),
    ("device_cell_share.evidence", 75.0),
    ("device_cell_share.cns", 75.0),
    ("read_chains_s_per_mb.evidence", 0.5),
    ("cns_host_s_per_mb.cns", 0.5),
    ("evidence_bases_per_s", 2e6),
    ("cns_bases_per_s", 1e6),
    ("map_bases_per_s.evidence", 4e6),
    ("svsig_bases_per_s.evidence", 4e6),
    ("setup_s", 7.0),
])
def test_readers(name, want):
    assert harness.reader(name)(_ctx()) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name", ["fill_roofline.evidence",
                                  "chain_roofline.evidence",
                                  "device_idle_share.cns",
                                  "extend_s_per_mb.evidence",
                                  "cns_wave_s_per_mb.cns"])
def test_readers_without_their_source_read_nothing(name):
    ctx = _ctx()
    del ctx["trace"]
    ctx["spans"] = {}
    assert harness.reader(name)(ctx) is None
