"""State crosses from lesv_tpu to the port as plain data
(``lesv_tpu_torch.convert`` and the stage ``.npz`` files): a store, an
index and a configuration rebuilt from arrays and dicts equal the
originals field by field; the port's own ``SeqStore.from_records`` and
``KmerIndex.build`` give the same arrays as lesv_tpu's on the same
records; each stage's checkpoint written by lesv_tpu's ``stages_io`` is
read back equal by the port's, and the port's own write/read round trip
keeps every field.  All comparisons are exact (floats after
``round(x, 9)``)."""

import dataclasses

import numpy as np
import pytest
import torch

from lesv_tpu.config import LesvConfig as JaxConfig
from lesv_tpu.index.kmer_index import KmerIndex as JaxKmerIndex
from lesv_tpu.io.seqstore import SeqStore as JaxSeqStore
from lesv_tpu.ops.anchored import sanitize_anchors as jax_sanitize_anchors
from lesv_tpu.pipeline import stages_io as jax_sio
from lesv_tpu.pipeline.cns import CorrectedRead as JaxCorrectedRead
from lesv_tpu.pipeline.mapper import M4 as JaxM4
from lesv_tpu.pipeline.remap import RemapResult as JaxRemapResult
from lesv_tpu.pipeline.signatures import SvSignature as JaxSvSignature
from lesv_tpu.pipeline.sv_reads import SvRead as JaxSvRead
from lesv_tpu.sim import random_genome
from lesv_tpu_torch import convert
from lesv_tpu_torch.config import LesvConfig
from lesv_tpu_torch.index.kmer_index import KmerIndex
from lesv_tpu_torch.io.seqstore import SeqStore
from lesv_tpu_torch.ops.anchored import sanitize_anchors
from lesv_tpu_torch.pipeline import stages_io as sio

# one intra-op thread: the suite runs several workers at once, and the
# small CPU tensor ops of the plain versions gain nothing from more
torch.set_num_threads(1)

STORE_FIELDS = ("names", "starts", "packed", "ambig")
INDEX_FIELDS = ("k", "window", "uniq_hash", "start", "positions",
                "subject_starts")


def _records(rng):
    g1 = random_genome(rng, 30_000)
    g2 = random_genome(rng, 9_001)
    g2[100:140] = 4                 # an ambiguous run
    g2[-3:] = 4
    return [("chr1", g1), ("chr2 with a description", g2)]


def _assert_fields_equal(got, want, fields):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


def test_store_from_arrays_and_from_records_equal_jax():
    recs = _records(np.random.default_rng(0))
    want = JaxSeqStore.from_records(recs)
    got = convert.seqstore_from_arrays(want.names, want.starts, want.packed,
                                       want.ambig)
    own = SeqStore.from_records(recs)
    for st in (got, own):
        assert type(st) is SeqStore
        _assert_fields_equal(st, want, STORE_FIELDS)
        assert st.num_seqs == 2 and st.total_res == want.total_res
        for sid in range(2):
            np.testing.assert_array_equal(st.get(sid), want.get(sid))
            assert st.name_of(sid) == want.name_of(sid)
        np.testing.assert_array_equal(st.get(1, 50, 400, rc=True),
                                      want.get(1, 50, 400, rc=True))
    with pytest.raises(ValueError):
        convert.seqstore_from_arrays(["a"], [0], want.packed, want.ambig)


def test_index_from_arrays_and_build_equal_jax():
    recs = _records(np.random.default_rng(1))
    jstore = JaxSeqStore.from_records(recs)
    want = JaxKmerIndex.build(jstore, JaxConfig().index)
    got = convert.kmer_index_from_arrays(
        want.k, want.window, want.uniq_hash, want.start, want.positions,
        want.subject_starts)
    own = KmerIndex.build(SeqStore.from_records(recs), LesvConfig().index)
    vol = KmerIndex.build(SeqStore.from_records(recs), LesvConfig().index,
                          sid_range=(1, 2))
    jvol = JaxKmerIndex.build(jstore, JaxConfig().index, sid_range=(1, 2))
    for idx, ref in ((got, want), (own, want), (vol, jvol)):
        assert type(idx) is KmerIndex
        _assert_fields_equal(idx, ref, INDEX_FIELDS)
    assert len(want.uniq_hash) > 1000
    with pytest.raises(ValueError):
        convert.kmer_index_from_arrays(15, 10, want.uniq_hash,
                                       want.start[:-1], want.positions,
                                       want.subject_starts)


def test_config_from_dict_round_trip():
    jcfg = JaxConfig.ultra_long()
    jcfg.cns.min_size = 1234
    jcfg.map.engine = "host"
    jcfg.num_threads = 3
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert type(cfg) is LesvConfig
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(LesvConfig()) == dataclasses.asdict(JaxConfig())
    assert dataclasses.asdict(LesvConfig.ultra_long()) == \
        dataclasses.asdict(JaxConfig.ultra_long())
    align = convert.config_from_dict({"match": 3}, "align")
    assert (align.match, align.mismatch) == (3, JaxConfig().align.mismatch)
    with pytest.raises(ValueError):
        convert.config_from_dict({"align": {"no_such_field": 1}})
    with pytest.raises(ValueError):
        convert.config_from_dict({"no_such_section": {}})


def _plain(rec):
    out = {}
    for f in dataclasses.fields(rec):
        v = getattr(rec, f.name)
        if isinstance(v, np.ndarray):
            v = (v.dtype.str, v.tolist())
        elif isinstance(v, float):
            v = round(v, 9)
        out[f.name] = v
    return out


def _stage_records():
    ops = np.array([0, 0, 1, 2, 0], np.uint8)
    seq = np.array([0, 1, 2, 3, 3, 1], np.uint8)
    return {
        "m4s": [JaxM4(3, 1, 5, 905, 1000, 0, 77, 990, 5000, 91.25, 1500, 80,
                      ops), JaxM4(4, 0, 0, 10, 20, 1, 2, 12, 30, 100.0, 20)],
        "sv_reads": [JaxSvRead(7, 1, 10, 4000, 4100, 0, 500, 4700, 321)],
        "signatures": [JaxSvSignature("DEL", 7, 0, 100, 101, 600, 900, 0,
                                      300, 10, 3900, 520, 4690),
                       JaxSvSignature("INS", 8, 1, 50, 250, 700, 701, 1,
                                      200)],
        "corrected": [JaxCorrectedRead(7, "read/7", seq, 1, 5, 1, 0, 500,
                                       4700, 2, "DEL")],
        "remapped": [JaxRemapResult("read/7_svr", 7, True, 0, 510, 4600, ops,
                                    seq, 93.5, 95.125, 2, "INS")],
    }


@pytest.mark.parametrize("stage", ["m4s", "sv_reads", "signatures",
                                   "corrected", "remapped"])
def test_stage_npz_crosses_and_round_trips(tmp_path, stage):
    recs = _stage_records()[stage]
    jpath = str(tmp_path / "jax.npz")
    getattr(jax_sio, "save_" + stage)(jpath, recs)
    got = getattr(sio, "load_" + stage)(jpath)
    assert [_plain(r) for r in got] == [_plain(r) for r in recs]
    assert all(type(r).__module__.startswith("lesv_tpu_torch.") for r in got)
    tpath = str(tmp_path / "torch.npz")
    getattr(sio, "save_" + stage)(tpath, got)
    again = getattr(sio, "load_" + stage)(tpath)
    assert [_plain(r) for r in again] == [_plain(r) for r in recs]
    back = getattr(jax_sio, "load_" + stage)(tpath)
    assert [_plain(r) for r in back] == [_plain(r) for r in recs]


def test_sanitize_anchors_equals_jax():
    rng = np.random.default_rng(3)
    q = np.sort(rng.integers(0, 5000, 200))
    a2 = np.stack([q, q + rng.integers(-3, 4, 200).cumsum() + 100], axis=1)
    a3 = np.concatenate([a2, rng.integers(10, 40, (200, 1))], axis=1)
    for a, k in ((a2, 15), (a3, 10), (np.empty((0, 2), np.int64), 15)):
        np.testing.assert_array_equal(sanitize_anchors(a, k),
                                      jax_sanitize_anchors(a, k))
