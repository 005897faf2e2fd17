"""The port's pooled orchestration on the CPU, with the worker counts
forced above 1 by monkeypatch (4 dispatch workers, 3 host workers, 2 map
batches in flight): ``align_batch.align_pairs``,
``batch_align.batch_pair_chains`` and ``mapper.map_all`` against the
lesv_tpu function on the same numpy inputs and against the port's serial
arm (worker counts 1), with exact equality, ``align_batch.FILL_STATS``
included.  Then a stress test of the counters the workers share."""

import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

from lesv_tpu.config import LesvConfig
from lesv_tpu.index.kmer_index import KmerIndex
from lesv_tpu.io.fasta import revcomp
from lesv_tpu.io.seqstore import SeqStore
from lesv_tpu.ops import align_batch as jax_align_batch
from lesv_tpu.pipeline import batch_align as jax_batch_align
from lesv_tpu.pipeline import mapper as jax_mapper
from lesv_tpu.sim import mutate_read, random_genome, repeat_genome
from lesv_tpu_torch import _ext, convert
from lesv_tpu_torch.io.seqstore import SeqStore as PortSeqStore
from lesv_tpu_torch.ops import align_batch, seeding_torch
from lesv_tpu_torch.pipeline import batch_align, mapper
from torch_cases import MONSTER_DIRS_BYTES, N_MONSTER, align_pairs_world

# one intra-op thread: the suite runs several workers at once, and the
# small CPU tensor ops of the plain versions gain nothing from more
torch.set_num_threads(1)


def _pooled(monkeypatch) -> None:
    monkeypatch.setattr(align_batch, "_n_dispatch_workers", lambda dev: 4)
    monkeypatch.setattr(align_batch, "_n_host_workers", lambda: 3)
    monkeypatch.setattr(mapper, "_map_overlap_depth", lambda dev: 2)


def _serial(monkeypatch) -> None:
    monkeypatch.setattr(align_batch, "_n_dispatch_workers", lambda dev: 1)
    monkeypatch.setattr(mapper, "_map_overlap_depth", lambda dev: 1)


def _aln(a):
    return None if a is None else (a.qb, a.qe, a.sb, a.se, a.score,
                                   a.ops.tobytes())


def _port(store, index, cfg):
    return (convert.seqstore_from_arrays(store.names, store.starts,
                                         store.packed, store.ambig),
            convert.kmer_index_from_arrays(
                index.k, index.window, index.uniq_hash, index.start,
                index.positions, index.subject_starts),
            convert.config_from_dict(dataclasses.asdict(cfg)))


def _m4_key(m):
    return (m.qid, m.qdir, m.sid, m.qoff, m.qend, m.qsize, m.soff, m.send,
            m.ssize, m.score, m.dist, round(m.ident_perc, 9),
            m.ops.tobytes())


# -- align_pairs -------------------------------------------------------------

@pytest.mark.parametrize("free_end", [False, True])
def test_pooled_align_pairs_matches_jax_and_serial(monkeypatch, free_end):
    """Pooled align_pairs with a monster chunk on the host pool and a band
    escape: equal to lesv_tpu's device path (``_align_pairs_jax``) on the
    device chunks, to lesv_tpu's host path on the monster chunk (the path
    lesv_tpu's own monster rule takes on a device), and to the port's
    serial arm, ``FILL_STATS`` included."""
    rng = np.random.default_rng(31)
    pairs = align_pairs_world(rng)
    # only the long pairs' chunk is a monster at this bound
    monkeypatch.setattr(align_batch, "MONSTER_DIRS_BYTES",
                        MONSTER_DIRS_BYTES)
    cfg = convert.config_from_dict(dataclasses.asdict(LesvConfig().align),
                                   "align")
    buckets = {(align_batch._ext_bucket_of(len(q), len(s)) if free_end
                else align_batch._bucket_of(len(q), len(s),
                                            align_batch._next_pow2))
               for q, s in pairs if len(q) and len(s)}
    assert len(buckets) >= 6

    arms = {}
    for name, setup in (("serial", _serial), ("pooled", _pooled)):
        setup(monkeypatch)
        align_batch.reset_fill_stats()
        arms[name] = ([_aln(a) for a in align_batch.align_pairs(
            pairs, cfg, free_end=free_end, device="cpu")],
            dict(align_batch.FILL_STATS))
    assert arms["pooled"] == arms["serial"]
    got, stats = arms["pooled"]

    jcfg = LesvConfig().align
    dev = len(pairs) - N_MONSTER
    want = [_aln(a) for a in jax_align_batch._align_pairs_jax(
        pairs[:dev], jcfg, free_end)]
    want += [_aln(a) for a in jax_align_batch.align_pairs_host(
        pairs[dev:], jcfg, free_end)]
    assert got == want
    assert got[dev - 1] is None and all(got[dev:])
    # host fills: the monster pairs, plus the escaped lane when free_end
    assert stats["host_fills"] == N_MONSTER + (1 if free_end else 0)
    assert stats["device_fills"] >= dev - 1


# -- batch_pair_chains -------------------------------------------------------

def _chain_key(chains):
    return [(c.score, c.qbeg, c.qend, c.sbeg, c.send,
             np.asarray(c.anchors).tobytes()) for c in chains]


def test_pooled_batch_pair_chains_matches_jax_and_serial(monkeypatch):
    """Pair chains of reads against windows over several (Q, S) buckets,
    with lanes over a small pair-match budget redone by the host oracle:
    the pooled arm equals lesv_tpu's device path and the serial arm."""
    rng = np.random.default_rng(5)
    genome, _ = repeat_genome(rng, 60_000, n_tandem=3, n_dups=1, n_runs=0)
    pairs = []
    for k in range(24):
        n = int(rng.integers(300, 5_000))
        st = int(rng.integers(0, len(genome) - n - 600))
        s = genome[st : st + n + 600]
        q = mutate_read(rng, genome[st + 300 : st + 300 + n], err=0.1)
        pairs.append((q, s))
    jcfg = LesvConfig()
    jcfg.map.pair_match_budget = 128
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    oracle = []
    pair_chains = batch_align.pair_chains

    def counting(q, s, **kw):
        oracle.append(len(q))
        return pair_chains(q, s, **kw)

    monkeypatch.setattr(batch_align, "pair_chains", counting)
    arms = {}
    for name, setup in (("serial", _serial), ("pooled", _pooled)):
        setup(monkeypatch)
        arms[name] = [_chain_key(c) for c in batch_align.batch_pair_chains(
            pairs, cfg, device="cpu")]
    assert arms["pooled"] == arms["serial"]
    want = [_chain_key(c) for c in jax_batch_align.batch_pair_chains(
        pairs, jcfg)]
    assert arms["pooled"] == want
    assert all(want)
    # lanes over the budget went to the host oracle, the same in both arms
    assert len(oracle) % 2 == 0 and 0 < len(oracle) // 2 < len(pairs)


# -- map_all -----------------------------------------------------------------

@pytest.fixture(scope="module")
def map_world():
    """A 120 kb genome and nine reads (forward, reverse, one spanning an
    800 bp deletion, one unmappable), three to a batch: three batches."""
    rng = np.random.default_rng(42)
    genome = random_genome(rng, 120_000)
    store = SeqStore.from_records([("chr1", genome)])
    cfg = LesvConfig()
    cfg.map.batch_reads = 3
    index = KmerIndex.build(store, cfg.index)
    donor = np.concatenate([genome[:70_000], genome[70_800:]])
    reads = [("sv", mutate_read(rng, donor[66_000:74_000], err=0.1)),
             ("junk", rng.integers(0, 4, 3_000).astype(np.uint8))]
    for i in range(7):
        st = int(rng.integers(0, 110_000))
        r = mutate_read(rng, genome[st : st + int(rng.integers(2_000, 5_000))],
                        err=0.1)
        reads.append((f"r{i}", revcomp(r) if i % 2 else r))
    want, _ = jax_mapper.map_all(reads, store, index, cfg)
    return dict(reads=reads, port=_port(store, index, cfg),
                want=[_m4_key(m) for m in want])


@pytest.mark.parametrize("ckpt", [False, True])
def test_pooled_map_all_matches_jax_and_serial(monkeypatch, tmp_path,
                                               map_world, ckpt):
    """Three batches, two in flight: the M4s equal lesv_tpu's and the
    serial arm's, and so do ``FILL_STATS``; with ``ckpt_dir`` every batch
    leaves its checkpoint."""
    store, index, cfg = map_world["port"]
    assert len(list(mapper._query_batches(
        PortSeqStore.from_records(map_world["reads"]), cfg))) == 3
    arms = {}
    for name, setup in (("serial", _serial), ("pooled", _pooled)):
        setup(monkeypatch)
        ck = str(tmp_path / name) if ckpt else None
        align_batch.reset_fill_stats()
        m4s, _ = mapper.map_all(map_world["reads"], store, index, cfg,
                                ckpt_dir=ck, device="cpu")
        arms[name] = ([_m4_key(m) for m in m4s],
                      dict(align_batch.FILL_STATS))
        if ckpt:
            assert sorted(os.listdir(ck)) == [f"map_part_{b:05d}.npz"
                                              for b in range(3)]
    assert arms["pooled"] == arms["serial"]
    assert arms["pooled"][0] == map_world["want"]
    assert {k[0] for k in map_world["want"]} >= {0, 2, 3}


def test_pooled_map_all_resumes_halfway(monkeypatch, tmp_path, map_world):
    """A pooled run whose checkpoints of batches 1 and 2 are gone maps only
    those two batches again and returns lesv_tpu's M4s."""
    _pooled(monkeypatch)
    store, index, cfg = map_world["port"]
    ck = str(tmp_path / "parts")
    first, _ = mapper.map_all(map_world["reads"], store, index, cfg,
                              ckpt_dir=ck, device="cpu")
    for b in (1, 2):
        os.remove(os.path.join(ck, f"map_part_{b:05d}.npz"))
    mapped = []
    map_batch = mapper.map_batch

    def counting(batch, *a, **kw):
        mapped.append(batch[0][0])
        return map_batch(batch, *a, **kw)

    monkeypatch.setattr(mapper, "map_batch", counting)
    again, _ = mapper.map_all(map_world["reads"], store, index, cfg,
                              ckpt_dir=ck, device="cpu")
    assert sorted(mapped) == [3, 6]          # first qids of batches 1, 2
    assert [_m4_key(m) for m in again] == map_world["want"]
    assert [_m4_key(m) for m in first] == map_world["want"]


# -- the shared counters -----------------------------------------------------

def test_shared_counters_lose_no_update():
    """32 threads (more than the cores) with a short switch interval add
    to ``_ext.LAUNCHES`` / ``FILL_SHAPES`` and ``FILL_STATS`` and fetch
    the device index at once: every count is exact, and the index is
    built once."""
    n_threads, n_adds = 32, 5000
    rng = np.random.default_rng(2)
    store = SeqStore.from_records([("c", random_genome(rng, 20_000))])
    index = KmerIndex.build(store, LesvConfig().index)
    _, pindex, _ = _port(store, index, LesvConfig())
    seeding_torch._DEVICE_INDEX_CACHE.clear()
    saved = dict(_ext.LAUNCHES), dict(_ext.FILL_SHAPES)
    saved_stats = dict(align_batch.FILL_STATS)
    _ext.reset_launches()
    align_batch.reset_fill_stats()
    copies = []
    start = threading.Barrier(n_threads)

    def work():
        start.wait(timeout=60)
        copies.append(seeding_torch.device_index_of(pindex, "cpu"))
        for _ in range(n_adds):
            _ext.count_launch("fill_i16", ("i16", "full", False, 64, 64, 8))
            _ext.count_launch("chain")
            align_batch._count_fills(device_fills=2, device_cells=3)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        total = n_threads * n_adds
        assert _ext.LAUNCHES["fill_i16"] == total
        assert _ext.LAUNCHES["chain"] == total
        assert _ext.FILL_SHAPES == {("i16", "full", False, 64, 64, 8): total}
        assert align_batch.FILL_STATS["device_fills"] == 2 * total
        assert align_batch.FILL_STATS["device_cells"] == 3 * total
        assert len(copies) == n_threads
        assert all(c is copies[0] for c in copies)
    finally:
        sys.setswitchinterval(interval)
        _ext.reset_launches()
        _ext.LAUNCHES.update(saved[0])
        _ext.FILL_SHAPES.update(saved[1])
        align_batch.FILL_STATS.update(saved_stats)
        seeding_torch._DEVICE_INDEX_CACHE.clear()
