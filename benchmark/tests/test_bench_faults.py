"""``correct`` on tiny worlds on the CPU, past the harness' look for a
card: true for the port as it is (the benchmark's plain reference agrees
with the port's plain path), false for the control of each driver and for
each fault its cells can have, planted underneath the timed path."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import control
from benchmark.drivers import cns, evidence
from benchmark.tests import tiny


def test_evidence_sound():
    out = tiny.run(tiny.EVIDENCE_CELL, tiny.EVIDENCE_CONFIG, 2_200_000_041)
    assert out["correct"], out["checks"]
    assert out["info"]["sv_reads_held"] > 0


def test_evidence_control_int16_fails():
    sound = tiny.run(tiny.LONG_CELL, tiny.LONG_CONFIG, 2_200_000_042)
    assert sound["correct"], sound["checks"]
    with control.mode_of("evidence", "control"):
        out = tiny.run(tiny.LONG_CELL, tiny.LONG_CONFIG, 2_200_000_042)
    assert not out["correct"]
    assert out["checks"]["score_gap"]["value"] > 30_000


def _altered_answer(real):
    def map_all(recs, *a, **kw):
        m4s, qstore = real(recs, *a, **kw)
        m = m4s[len(m4s) // 2]
        ops = m.ops.copy()
        i = int(np.flatnonzero(ops == 0)[len(ops) // 3])
        ops[i] = 1           # one match column made an insertion
        m.ops = ops
        return m4s, qstore
    return map_all


def _unchanged_state(real):
    def extract_signatures(svrs, *a, **kw):
        return []
    return extract_signatures


def test_evidence_half_batch_fails():
    with control.mode_of("evidence", "half"):
        out = tiny.run(tiny.EVIDENCE_CELL, tiny.EVIDENCE_CONFIG,
                       2_200_000_041)
    assert not out["correct"]
    for name in ("misplaced", "sv_missed"):
        c = out["checks"][name]
        assert c["value"] > c["limit"]


@pytest.mark.parametrize("name,fault,fails", [
    ("map_all", _altered_answer, "m4_bad"),
    ("extract_signatures", _unchanged_state, "sv_missed"),
])
def test_evidence_faults_fail(monkeypatch, name, fault, fails):
    monkeypatch.setattr(evidence, name, fault(getattr(evidence, name)))
    out = tiny.run(tiny.EVIDENCE_CELL, tiny.EVIDENCE_CONFIG, 2_200_000_041)
    assert not out["correct"]
    c = out["checks"][fails]
    assert c["value"] > c["limit"]


def test_cns_sound_and_stateless():
    out = tiny.run(tiny.CNS_CELL, tiny.CNS_CONFIG, 2_200_000_043)
    assert out["correct"], out["checks"]
    assert out["info"]["corrected"] > 0
    assert len(out["info"]["loci"]) == tiny.CNS_CELL["loci"]


def _key(r) -> tuple:
    return (r.global_id, r.name, r.seq.tobytes(), r.cns_from, r.cns_to,
            r.fsqdir, r.subject_id, r.fsfrom, r.fsto, r.group_id, r.kind)


def test_cns_repeat_call_is_identical():
    """The stage keeps no state: a window's later call over the same
    groups gives what its first gave."""
    st = cns.setup(tiny.CNS_CELL, tiny.CNS_CONFIG, 2_200_000_043, ["cpu"])
    ctx: dict = {}
    cns.window(st, 0.01, ctx)
    assert ctx["calls"] == 1 and ctx["attempted"] == len(st.groups)
    again = cns.cns_groups(st.groups, st.qstore, st.cfg, device="cpu")
    assert [_key(r) for r in again] == [_key(r) for r in st.outs[0]]


def _altered_read(real):
    def cns_groups(groups, *a, **kw):
        out = real(groups, *a, **kw)
        out[0].fsfrom += 1
        return out
    return cns_groups


def test_cns_control_fails():
    with control.mode_of("cns", "control"):
        out = tiny.run(tiny.CNS_CELL, tiny.CNS_CONFIG, 2_200_000_043)
    assert not out["correct"]
    c = out["checks"]["kmer_miss"]
    assert c["value"] > c["limit"]


def test_cns_half_groups_fails():
    with control.mode_of("cns", "half"):
        out = tiny.run(tiny.CNS_CELL, tiny.CNS_CONFIG, 2_200_000_043)
    assert not out["correct"]
    c = out["checks"]["loci_missed"]
    assert c["value"] > c["limit"]


def _one_locus_ungrouped(real):
    def group_signatures(sigs, *a, **kw):
        groups = real(sigs, *a, **kw)
        first = min(groups, key=lambda g: g.sigs[0].sfrom)
        near = first.sigs[0].sfrom
        return [g for g in groups
                if abs(g.sigs[0].sfrom - near) > 5_000]
    return group_signatures


def _group_off_its_locus(real):
    def group_signatures(sigs, *a, **kw):
        groups = real(sigs, *a, **kw)
        for s in groups[0].sigs:
            s.sfrom += 5_000
            s.sto += 5_000
        return groups
    return group_signatures


@pytest.mark.parametrize("fault,fails", [
    (_one_locus_ungrouped, "loci_ungrouped"),
    (_group_off_its_locus, "groups_off"),
])
def test_cns_grouping_faults_fail(monkeypatch, fault, fails):
    """The groups set-up makes are the port's: a locus left without a
    group, or a group away from any planted SV, is not correct."""
    monkeypatch.setattr(cns, "group_signatures",
                        fault(cns.group_signatures))
    out = tiny.run(tiny.CNS_CELL, tiny.CNS_CONFIG, 2_200_000_043)
    assert not out["correct"]
    c = out["checks"][fails]
    assert c["value"] > c["limit"]


def test_cns_altered_answer_fails(monkeypatch):
    monkeypatch.setattr(cns, "cns_groups", _altered_read(cns.cns_groups))
    out = tiny.run(tiny.CNS_CELL, tiny.CNS_CONFIG, 2_200_000_043)
    assert not out["correct"]
    c = out["checks"]["cns_bad"]
    assert c["value"] > c["limit"]
