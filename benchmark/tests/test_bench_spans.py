"""The readers of the program's spans and counters inside SV-read
selection, signature extraction and consensus: each on a hand-made
context, without its source, and on tiny runs of the evidence and cns
drivers on the CPU."""

from __future__ import annotations

import time

import pytest

from benchmark import harness
from benchmark.tests import tiny

MB = 2e6                                # bases of the hand-made window
SPANS = {"svr/select": 10.0, "svr/realign": 6.0, "svsig/extract": 9.0,
         "svsig/align": 5.0, "svsig/repair": 1.0,
         "align/global_fallback": 4.0, "cns/finish": 3.0,
         "cns/overlap_cands": 0.5}
STATS = {"fallback_fills": 8, "fallback_kept": 6, "fallback_cells": 2e9}

# name: (value on the hand-made context, the spans or counters it reads)
CASES = {
    "svr_realign_s_per_mb.evidence": (3.0, ["svr/realign"]),
    "svsig_align_s_per_mb.evidence": (3.0, ["svsig/align",
                                            "svsig/repair"]),
    "sv_fallback_s_per_mb.evidence": (2.0, ["align/global_fallback"]),
    "sv_self_s_per_mb.evidence": ((10 + 9 - 6 - 5 - 1) / 2.0,
                                  ["svr/select", "svsig/extract"]),
    "sv_fallback_kept_share.evidence": (75.0, ["fallback_fills"]),
    "sv_fallback_cells_per_s.evidence": (5e8, ["fallback_cells",
                                               "align/global_fallback"]),
    "cns_fccns_s_per_mb.cns": (1.5, ["cns/finish"]),
    "cns_overlap_s_per_mb.cns": (0.25, ["cns/overlap_cands"]),
}
NEW = set(CASES)


def _ctx(drop=()) -> dict:
    return dict(evidence_bases=MB, cns_bases=MB,
                spans={k: v for k, v in SPANS.items() if k not in drop},
                fill_stats={k: v for k, v in STATS.items()
                            if k not in drop})


def test_every_new_metric_is_in_the_manifest():
    man = harness.manifest()
    got = {m["name"]: m for m in man["per_layer"] if m["name"] in NEW}
    assert set(got) == NEW
    for name, m in got.items():
        cns = name.endswith(".cns")
        assert m["moves"] == ("cns_bases_per_s" if cns
                              else "evidence_bases_per_s")
        assert m["workloads"] == (["cns.chr21"] if cns else
                                  ["evidence.hg002_45x", "evidence.chr21"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_on_a_hand_made_context(name):
    want, sources = CASES[name]
    read = harness.reader(name)
    assert read(_ctx()) == pytest.approx(want)
    # without its source (as at a parent that lacks the span or counter)
    assert read(_ctx(drop=sources)) is None
    # nothing in the window
    assert read(dict(evidence_bases=0, cns_bases=0, spans={},
                     fill_stats={})) is None


def test_self_time_counts_a_missing_part_as_zero():
    read = harness.reader("sv_self_s_per_mb.evidence")
    assert read(_ctx(drop=["svr/realign"])) == \
        pytest.approx((10 + 9 - 5 - 1) / 2.0)


def _run_seeing_ctx(monkeypatch, cell, config, seed, names) -> tuple:
    """A tiny run that reports ``names``; returns its result and the
    context the readers saw."""
    seen: list = []
    real = harness.reader

    def reader(name):
        read = real(name)

        def wrapped(ctx):
            seen.append(ctx)
            return read(ctx)
        return wrapped

    monkeypatch.setattr(harness, "reader", reader)
    man = harness.manifest()
    # the tiny cell is in no metric's list of cells
    man = dict(end_to_end=[], per_layer=[
        {k: v for k, v in m.items() if k != "workloads"}
        for m in man["per_layer"] if m["name"] in names])
    out = harness.run("tiny", seed, 0.1, True, time.perf_counter(),
                      ["cpu"], cell=cell, config=config, man=man)
    return out, seen[0]


def test_tiny_evidence_run_reports_its_spans(monkeypatch):
    names = {n for n in NEW if n.endswith(".evidence")}
    out, ctx = _run_seeing_ctx(monkeypatch, tiny.EVIDENCE_CELL,
                               tiny.EVIDENCE_CONFIG, 2_200_000_041, names)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in ("svsig_align_s_per_mb.evidence",
                 "sv_self_s_per_mb.evidence"):
        assert got[name]["value"] >= 0, name
    for name in names:
        sources = CASES[name][1]
        ran = all(ctx["spans"].get(k) or ctx["fill_stats"].get(k)
                  for k in sources)
        if ran:
            assert name in got, name
    sp = ctx["spans"]
    assert sp["svr/select"] + sp["svsig/extract"] <= ctx["svsig_s"] + 1e-3


def test_tiny_cns_run_reports_its_spans(monkeypatch):
    names = {n for n in NEW if n.endswith(".cns")}
    out, ctx = _run_seeing_ctx(monkeypatch, tiny.CNS_CELL, tiny.CNS_CONFIG,
                               2_200_000_043, names)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == names
    sp = ctx["spans"]
    parts = sum(sp[k] for k in ("cns/overlap_cands", "cns/mem_anchors",
                                "cns/align_wave", "cns/admission",
                                "cns/finish"))
    assert parts <= ctx["window_s"]
