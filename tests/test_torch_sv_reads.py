"""SV-read selection of the port against lesv_tpu's on split (dual)
alignments, the path that realigns a union span (``realign_span``:
host pair chains, anchored alignment on the torch device, whole-span
global fallback), and the port's profiling context.  Records are
compared field by field with exact equality."""

import dataclasses
import json
import os
import types

import numpy as np
import torch

from lesv_tpu.config import LesvConfig as JaxConfig
from lesv_tpu.io.seqstore import SeqStore as JaxSeqStore
from lesv_tpu.pipeline import sv_reads as jax_sv_reads
from lesv_tpu.pipeline.mapper import M4 as JaxM4
from lesv_tpu.sim import mutate_read
from lesv_tpu_torch import convert
from lesv_tpu_torch.io.seqstore import SeqStore
from lesv_tpu_torch.pipeline import sv_reads
from lesv_tpu_torch.pipeline.mapper import M4
from lesv_tpu_torch.utils import profiling

# one intra-op thread: the suite runs several workers at once, and the
# small CPU tensor ops of the plain versions gain nothing from more
torch.set_num_threads(1)


def _world():
    """A read spanning a 3 kb deletion, mapped as a left and a right
    part (no ops, as M4s parsed from text), and a second read whose right
    part has two placements (an ambiguous dual: nothing is chained)."""
    rng = np.random.default_rng(11)
    left = rng.integers(0, 4, 2_500).astype(np.uint8)
    gap = rng.integers(0, 4, 3_000).astype(np.uint8)
    seg = rng.integers(0, 4, 2_500).astype(np.uint8)
    filler = rng.integers(0, 4, 2_000).astype(np.uint8)
    subject = np.concatenate([left, gap, seg, filler, seg])
    q0 = np.concatenate([mutate_read(rng, left, err=0.05),
                         mutate_read(rng, seg, err=0.05)])
    cut = len(q0) - 2_500
    recs = dict(subject=[("chr1", subject)], reads=[("q0", q0), ("q1", q0)])

    def m4s(cls):
        def m4(qid, qoff, qend, soff, send):
            return cls(qid=qid, qdir=0, qoff=qoff, qend=qend, qsize=len(q0),
                       sid=0, soff=soff, send=send, ssize=len(subject),
                       ident_perc=95.0, score=1000, dist=0, ops=None)

        return [m4(0, 0, cut, 0, 2_500), m4(0, cut, len(q0), 5_500, 8_000),
                m4(1, 0, cut, 0, 2_500), m4(1, cut, len(q0), 5_500, 8_000),
                m4(1, cut, len(q0), 10_000, 12_500)]

    return recs, m4s


def test_select_sv_reads_dual_realign_equals_jax():
    recs, m4s = _world()
    jcfg = JaxConfig()
    want = jax_sv_reads.select_sv_reads(
        m4s(JaxM4), JaxSeqStore.from_records(recs["reads"]),
        JaxSeqStore.from_records(recs["subject"]), jcfg)
    got = sv_reads.select_sv_reads(
        m4s(M4), SeqStore.from_records(recs["reads"]),
        SeqStore.from_records(recs["subject"]),
        convert.config_from_dict(dataclasses.asdict(jcfg)), device="cpu")
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    assert len(got) == 1 and got[0].query_id == 0
    assert got[0].send - got[0].soff > 7_500      # spans the deletion


def test_realign_span_equals_jax():
    recs, _ = _world()
    jcfg = JaxConfig()
    n = len(recs["reads"][0][1])
    jq, js, ja = jax_sv_reads.realign_span(
        JaxSeqStore.from_records(recs["reads"]),
        JaxSeqStore.from_records(recs["subject"]), 0, 0, 100, n - 50, 0,
        200, 8_000, jcfg)
    r = sv_reads.realign_span(
        SeqStore.from_records(recs["reads"]),
        SeqStore.from_records(recs["subject"]), 0, 0, 100, n - 50, 0, 200,
        8_000, convert.config_from_dict(dataclasses.asdict(jcfg)),
        device="cpu")
    q, s, a = r
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    assert (a.qb, a.qe, a.sb, a.se, a.score) == \
        (ja.qb, ja.qe, ja.sb, ja.se, ja.score)
    np.testing.assert_array_equal(a.ops, ja.ops)
    assert a.qe - a.qb > 4_000 and a.se - a.sb > 7_000


def test_profiling_spans_and_device_trace(tmp_path, monkeypatch):
    """The span registry reports and dumps; device_trace is a no-op
    without a directory and writes a torch profiler trace with one."""
    import torch

    profiling.reset()
    with profiling.trace("unit/a"):
        pass
    ticks = iter([0.0, 1.5])
    with monkeypatch.context() as m:
        m.setattr(profiling, "time",
                  types.SimpleNamespace(perf_counter=lambda: next(ticks)))
        with profiling.trace("stage/x"):
            pass
    rep = profiling.report()
    assert rep["unit/a"]["count"] == 1 and rep["stage/x"]["total_s"] == 1.5
    p = str(tmp_path / "prof.json")
    profiling.dump_json(p)
    with open(p) as fh:
        assert json.load(fh)["unit/a"]["count"] == 1
    monkeypatch.delenv("LESV_TORCH_PROFILE", raising=False)
    with profiling.device_trace():
        pass
    logdir = str(tmp_path / "trace")
    with profiling.device_trace(logdir):
        torch.ones(8).add_(1)
    with open(os.path.join(logdir, "trace.json")) as fh:
        assert json.load(fh)["traceEvents"]


def test_realign_span_fallback_equals_jax_and_is_counted(monkeypatch):
    """A span whose query begins with 600 bases the subject lacks: the
    anchored alignment leaves them out, so the whole-span NW runs.  Equal
    to lesv_tpu's; ``FILL_STATS`` counts the NW's pair, its cells (each
    band attempt, as the native calls saw them) and whether it was kept;
    the NW's span lies inside ``svr/realign``."""
    from lesv_tpu_torch import native
    from lesv_tpu_torch.ops import align_batch

    rng = np.random.default_rng(12)
    body = rng.integers(0, 4, 6_000).astype(np.uint8)
    junk = rng.integers(0, 4, 600).astype(np.uint8)
    q = np.concatenate([junk, mutate_read(rng, body, err=0.05)])
    reads, subject = [("q0", q)], [("chr1", body)]
    jcfg = JaxConfig()
    jq, js, ja = jax_sv_reads.realign_span(
        JaxSeqStore.from_records(reads), JaxSeqStore.from_records(subject),
        0, 0, 0, len(q), 0, 0, len(body), jcfg)

    calls = []
    real = native.banded_align_one

    def seen(qq, ss, W, mode_diag, *a):
        calls.append(len(qq) * W if mode_diag
                     else (len(qq) + 1) * (len(ss) + 1))
        return real(qq, ss, W, mode_diag, *a)

    monkeypatch.setattr(native, "banded_align_one", seen)
    profiling.reset()
    align_batch.reset_fill_stats()
    q2, s2, a = sv_reads.realign_span(
        SeqStore.from_records(reads), SeqStore.from_records(subject),
        0, 0, 0, len(q), 0, 0, len(body),
        convert.config_from_dict(dataclasses.asdict(jcfg)), device="cpu")
    np.testing.assert_array_equal(q2, jq)
    np.testing.assert_array_equal(s2, js)
    assert (a.qb, a.qe, a.sb, a.se, a.score) == \
        (ja.qb, ja.qe, ja.sb, ja.se, ja.score)
    np.testing.assert_array_equal(a.ops, ja.ops)

    st = dict(align_batch.FILL_STATS)
    assert st["fallback_fills"] == 1 and calls
    assert 0 <= st["fallback_kept"] <= st["fallback_fills"]
    assert st["fallback_cells"] == sum(calls) > 0
    rep = profiling.report()
    assert rep["svr/realign"]["count"] == 1
    assert rep["align/global_fallback"]["total_s"] <= \
        rep["svr/realign"]["total_s"]
    assert rep["svr/realign"]["self_s"] <= rep["svr/realign"]["total_s"]
