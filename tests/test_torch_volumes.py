"""The subject-volume loop of the port against lesv_tpu's, on the CPU.

(a) ``map_all_volumes`` on 5 chromosomes of 30 kb in 3 volumes against
lesv_tpu's ``map_all_volumes``, then a resume after one part file is
removed; (b) ``run_pipeline`` on a reference of two chromosomes that
``max_subject_vol_res`` splits into two volumes (the driver's multi-volume
branch) against lesv_tpu's: every stage's ``.npz`` arrays equal, and
``remapped.sam`` and ``calls.vcf`` byte-identical; (c) each volume's
index, host and device copy, is freed before the next one is built;
(d) seeding and chaining against an index whose subject offsets are
shifted past 2^31 equal lesv_tpu's on the same index and the unshifted
chains plus the shift; (e) ``tools/torch_genome_scale.py`` at a tiny size
on the CPU.  Exact equality throughout (ident_perc after round(x, 9)).
"""

import dataclasses
import os
import sys
import weakref

import numpy as np
import pytest
import torch

from lesv_tpu.config import LesvConfig as JaxConfig
from lesv_tpu.index.kmer_index import KmerIndex as JaxKmerIndex
from lesv_tpu.io.seqstore import SeqStore as JaxSeqStore
from lesv_tpu.ops import chain_jax, seeding_jax
from lesv_tpu.pipeline import driver as jax_driver
from lesv_tpu.pipeline import mapper as jax_mapper
from lesv_tpu_torch import convert
from lesv_tpu_torch.index.kmer_index import KmerIndex
from lesv_tpu_torch.io.seqstore import SeqStore
from lesv_tpu_torch.ops import chain_torch, seeding_torch
from lesv_tpu_torch.pipeline import driver, mapper
from lesv_tpu_torch.sim import plant_svs, random_genome, simulate_reads
from torch_cases import (
    GENOME_SCALE_SHIFT,
    shifted_index_arrays,
    volume_world,
)

# one intra-op thread: the suite runs several workers at once, and the
# small CPU tensor ops of the plain versions gain nothing from more
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOL_RES = 65_000            # 5 x 30 kb -> volumes of 2, 2 and 1 chromosomes


def _key(m):
    return (m.qid, m.qdir, m.sid, m.qoff, m.qend, m.qsize, m.soff, m.send,
            m.ssize, m.score, m.dist, round(m.ident_perc, 9))


def _assert_same_m4s(got, want):
    assert [_key(m) for m in got] == [_key(m) for m in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.ops, b.ops)


def _jax_cfg():
    cfg = JaxConfig()
    cfg.map.max_subject_vol_res = VOL_RES
    return cfg


def _port_cfg(jcfg):
    return convert.config_from_dict(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def vworld():
    chroms, reads = volume_world(np.random.default_rng(11))
    return chroms, reads


def test_map_all_volumes_matches_jax_and_resumes(vworld, tmp_path):
    chroms, reads = vworld
    jcfg = _jax_cfg()
    want, _ = jax_mapper.map_all_volumes(reads,
                                         JaxSeqStore.from_records(chroms),
                                         jcfg)
    store = SeqStore.from_records(chroms)
    assert len(mapper.subject_volumes(store, VOL_RES)) == 3
    ck = str(tmp_path / "parts")
    got, _ = mapper.map_all_volumes(reads, store, _port_cfg(jcfg),
                                    ckpt_dir=ck, device="cpu")
    assert {m.qid for m in got} == set(range(len(reads)))
    _assert_same_m4s(got, want)
    parts = sorted(os.listdir(ck))
    assert [p[:8] for p in parts] == ["map_v000", "map_v001", "map_v002"]
    os.remove(os.path.join(ck, parts[1]))
    again, _ = mapper.map_all_volumes(reads, store, _port_cfg(jcfg),
                                      ckpt_dir=ck, device="cpu")
    _assert_same_m4s(again, want)
    assert sorted(os.listdir(ck)) == parts


def test_each_volume_index_is_freed_before_the_next(vworld, monkeypatch):
    """No reference to volume v's host index (the device cache's
    included) outlives its volume: when volume v+1's index is built, no
    earlier index is alive, and none is once the call returns."""
    chroms, reads = vworld
    built: list = []
    alive_at_build: list = []
    build = KmerIndex.build.__func__

    def spy(cls, *a, **kw):
        alive_at_build.append(sum(r() is not None for r in built))
        index = build(cls, *a, **kw)
        built.append(weakref.ref(index))
        return index

    monkeypatch.setattr(KmerIndex, "build", classmethod(spy))
    stats: list = []
    got, _ = mapper.map_all_volumes(reads[:3], SeqStore.from_records(chroms),
                                    _port_cfg(_jax_cfg()), device="cpu",
                                    volume_stats=stats)
    assert got and len(built) == 3
    assert alive_at_build == [0, 0, 0]
    assert all(r() is None for r in built)
    assert seeding_torch._DEVICE_INDEX_CACHE == []
    assert [s["subjects"] for s in stats] == [[0, 2], [2, 4], [4, 5]]
    assert all(s["index_device_bytes"] > 0 for s in stats)


def _sv_world():
    """Two chromosomes of 15 kb, a 200 bp-scale DEL planted in the first,
    reads of 2 to 4 kb at coverage 8 from both donors."""
    rng = np.random.default_rng(5)
    ref, reads = [], []
    for c in range(2):
        genome = random_genome(rng, 15_000)
        donor = genome
        if c == 0:
            donor, _ = plant_svs(rng, genome, n_del=1, n_ins=0, min_len=150,
                                 max_len=300, margin=6_000, min_gap=1_000)
        ref.append((f"chr{c + 1}", genome))
        reads += [(f"c{c}_{n}", r) for n, r in simulate_reads(
            rng, donor, coverage=5.0, mean_len=3_000, min_len=2_000,
            err=0.08)]
    return ref, reads


def test_run_pipeline_over_two_volumes_matches_jax(tmp_path):
    ref, reads = _sv_world()
    jcfg = JaxConfig()
    jcfg.cns.min_size = 1_000       # short synthetic reads
    jcfg.map.max_subject_vol_res = 20_000
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jres = jax_driver.run_pipeline(ref, reads, jcfg, out_dir=jdir,
                                   resume=True)
    tres = driver.run_pipeline(ref, reads, _port_cfg(jcfg), out_dir=tdir,
                               resume=True, device="cpu")
    assert len(mapper.subject_volumes(SeqStore.from_records(ref),
                                      20_000)) == 2
    parts = sorted(os.listdir(os.path.join(tdir, "map_parts")))
    assert {p[:8] for p in parts} == {"map_v000", "map_v001"}
    assert tres.stats == jres.stats and tres.stats["calls"] > 0
    for name in ("map", "sv_reads", "signatures", "consensus", "remap"):
        with np.load(os.path.join(jdir, name + ".npz")) as a, \
                np.load(os.path.join(tdir, name + ".npz")) as b:
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=name)
    for name in ("remapped.sam", "calls.vcf"):
        with open(os.path.join(tdir, name), "rb") as fh:
            got = fh.read()
        with open(os.path.join(jdir, name), "rb") as fh:
            assert got == fh.read(), name


def _chain_keys(lanes, shift: int = 0):
    return [[(c.score, c.qbeg, c.qend, c.sbeg - shift, c.send - shift,
              (c.anchors - [0, shift]).tobytes()) for c in cs]
            for cs in lanes]


def test_seeding_and_chaining_past_2_31_match_jax(vworld):
    """An index of the volume world's chromosomes with every subject
    offset moved up by 2,200,000,000: the port's seeds and chains (full
    and sliced fetch) equal lesv_tpu's on the same index and the unshifted
    ones plus the shift, and map_batch gives the same records."""
    chroms, reads = vworld
    jcfg = JaxConfig()
    jstore = JaxSeqStore.from_records(chroms)
    jindex = JaxKmerIndex.build(jstore, jcfg.index)
    arrays = shifted_index_arrays(jindex, GENOME_SCALE_SHIFT)
    jshift = JaxKmerIndex(*arrays)
    index = convert.kmer_index_from_arrays(*shifted_index_arrays(jindex, 0))
    shifted = convert.kmer_index_from_arrays(*arrays)
    assert int(shifted.positions.max()) > 2**31
    cfg = _port_cfg(jcfg)
    batch = [r for _, r in reads]
    M, k = 2048, jindex.k

    jq, js, jv, jt = seeding_jax.seed_matches_batch(batch, jshift,
                                                    jcfg.seeding, M=M)
    want = chain_jax.chain_lanes(jq, js, jv, k, jcfg.chain)
    q, s, v, t = seeding_torch.seed_matches_batch(batch, shifted,
                                                  cfg.seeding, M=M,
                                                  device="cpu")
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    assert int(s[v].max()) > 2**31
    got = chain_torch.chain_lanes(q, s, v, k, cfg.chain)
    assert _chain_keys(got) == _chain_keys(want)
    sliced = chain_torch.chain_lanes_sliced(q, s, v, t.numpy(), M, k,
                                            cfg.chain)
    assert _chain_keys(sliced) == _chain_keys(want)
    assert sum(map(len, got)) >= len(batch)

    q0, s0, v0, t0 = seeding_torch.seed_matches_batch(batch, index,
                                                      cfg.seeding, M=M,
                                                      device="cpu")
    assert torch.equal(v0, v) and torch.equal(t0, t)
    torch.testing.assert_close(s0[v0] + GENOME_SCALE_SHIFT, s[v], rtol=0,
                               atol=0)
    base = chain_torch.chain_lanes(q0, s0, v0, k, cfg.chain)
    assert _chain_keys(got, GENOME_SCALE_SHIFT) == _chain_keys(base)

    store = SeqStore.from_records(chroms)
    qb = list(enumerate(batch[:3]))
    _assert_same_m4s(mapper.map_batch(qb, store, shifted, cfg, device="cpu"),
                     mapper.map_batch(qb, store, index, cfg, device="cpu"))


def test_genome_scale_tool_at_a_tiny_size(tmp_path, capsys):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import json

    import torch_genome_scale

    out = str(tmp_path / "gscale")
    rc = torch_genome_scale.main(
        ["--gbases", "0.00016", "--chroms", "4", "--vol-res", "60000",
         "--reads", "6", "--device", "cpu", "--out", out])
    with open(os.path.join(out, "genome_scale.json")) as fh:
        rep = json.load(fh)
    assert rc == 0, rep["reads_off_source"]
    store = SeqStore.open(os.path.join(out, "store"))
    assert rep["volumes"] == len(mapper.subject_volumes(store, 60_000)) == 4
    assert len(rep["per_volume"]) == 4
    assert rep["reads_total"] == rep["reads_mapped"] == 6
    assert rep["best_on_source"] == 6
    assert rep["card"] is None and rep["max_memory_allocated"] is None
    assert len(rep["parts_mapped"]) == 4
    assert json.loads(capsys.readouterr().out) == rep
