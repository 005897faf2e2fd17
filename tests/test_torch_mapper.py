"""The port's map stage on CPU tensors against lesv_tpu's map_all
(engine "device") on the worlds of tests/test_mapper.py: the M4 lists
must be equal, op strings included (no tolerance; ident_perc after
round(x, 9)).  The world is built with lesv_tpu; the port gets its store,
index and configuration as plain arrays through lesv_tpu_torch.convert."""

import dataclasses

import numpy as np
import pytest
import torch

from lesv_tpu.config import LesvConfig
from lesv_tpu.index.kmer_index import KmerIndex
from lesv_tpu.io.fasta import revcomp
from lesv_tpu.io.seqstore import SeqStore
from lesv_tpu.pipeline import mapper as jax_mapper
from lesv_tpu.sim import mutate_read, random_genome
from lesv_tpu_torch import convert
from lesv_tpu_torch.pipeline import mapper

# one intra-op thread: the suite runs several workers at once, and the
# small CPU tensor ops of the plain versions gain nothing from more
torch.set_num_threads(1)


def _port(store, index, cfg):
    """The port's own store, index and configuration from lesv_tpu's."""
    return (convert.seqstore_from_arrays(store.names, store.starts,
                                         store.packed, store.ambig),
            convert.kmer_index_from_arrays(
                index.k, index.window, index.uniq_hash, index.start,
                index.positions, index.subject_starts),
            convert.config_from_dict(dataclasses.asdict(cfg)))


def _key(m):
    return (m.qid, m.qdir, m.sid, m.qoff, m.qend, m.qsize, m.soff, m.send,
            m.ssize, m.score, m.dist, round(m.ident_perc, 9))


def _assert_same_m4s(got, want):
    assert [_key(m) for m in got] == [_key(m) for m in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.ops, b.ops)


@pytest.fixture(scope="module")
def world():
    """The tests/test_mapper.py world: a 120 kb genome and four reads --
    forward, reverse, spanning an 800 bp deletion, and unmappable."""
    rng = np.random.default_rng(42)
    genome = random_genome(rng, 120_000)
    store = SeqStore.from_records([("chr1", genome)])
    cfg = LesvConfig()
    index = KmerIndex.build(store, cfg.index)
    donor = np.concatenate([genome[:70_000], genome[70_800:]])
    reads = [
        ("fwd", mutate_read(rng, genome[20_000:35_000], err=0.1)),
        ("rev", revcomp(mutate_read(rng, genome[50_000:62_000], err=0.1))),
        ("sv", mutate_read(rng, donor[64_000:78_000], err=0.1)),
        ("junk", rng.integers(0, 4, 5_000).astype(np.uint8)),
    ]
    want, _ = jax_mapper.map_all(reads, store, index, cfg)
    got, qstore = mapper.map_all(reads, *_port(store, index, cfg),
                                 device="cpu")
    return dict(want=want, got=got, store=store, index=index, cfg=cfg,
                reads=reads, qstore=qstore)


@pytest.mark.parametrize("qid,name", [(0, "fwd"), (1, "rev"), (2, "sv"),
                                      (3, "junk")])
def test_map_read_matches_jax(world, qid, name):
    got = [m for m in world["got"] if m.qid == qid]
    want = [m for m in world["want"] if m.qid == qid]
    _assert_same_m4s(got, want)
    if name == "junk":
        assert got == []
        return
    best = got[0]
    assert best.qdir == (1 if name == "rev" else 0)
    assert best.ident_perc > 85.0
    if name == "sv":
        from lesv_tpu.ops.cigar import scan_indel_signatures

        sigs = scan_indel_signatures(best.ops, best.qoff, best.soff,
                                     min_size=40)
        dels = [t for t in sigs if t[0] == "DEL"]
        assert len(dels) == 1 and abs(dels[0][3] - 800) < 80


def test_map_batch_host_engine_matches_jax(world):
    """engine "host" (host seeding/chaining, device alignment)."""
    cfg = dataclasses.replace(world["cfg"])
    cfg.map = dataclasses.replace(cfg.map, engine="host")
    batch = [(i, world["qstore"].get(i)) for i in range(3)]
    want = jax_mapper.map_batch(batch, world["store"], world["index"], cfg)
    got = mapper.map_batch(batch, *_port(world["store"], world["index"],
                                         cfg), device="cpu")
    _assert_same_m4s(got, want)


def test_map_all_volumes_matches_single_volume(tmp_path):
    """Two subject volumes give the same M4 set as one index (and as
    lesv_tpu), and resume from their per-(volume, batch) checkpoints."""
    import os

    rng = np.random.default_rng(11)
    chroms = [(f"chr{i}", random_genome(rng, 30_000)) for i in range(4)]
    store = SeqStore.from_records(chroms)
    cfg = LesvConfig()
    reads = []
    for i in range(8):
        ci = int(rng.integers(0, 4))
        start = int(rng.integers(0, 20_000))
        frag = chroms[ci][1][start : start + int(rng.integers(4000, 9000))]
        reads.append((f"r{i}", mutate_read(rng, frag, err=0.05)))
    index = KmerIndex.build(store, cfg.index)
    want, _ = jax_mapper.map_all(reads, store, index, cfg)
    mono, _ = mapper.map_all(reads, *_port(store, index, cfg), device="cpu")
    _assert_same_m4s(mono, want)

    cfg.map.max_subject_vol_res = 65_000      # two volumes of 2 chroms
    ck = str(tmp_path / "vparts")
    store, _, cfg = _port(store, index, cfg)
    vols, _ = mapper.map_all_volumes(reads, store, cfg, ckpt_dir=ck,
                                     device="cpu")
    key = lambda m: (m.qid, m.qdir, m.sid, m.qoff, m.qend, m.soff, m.send,
                     m.score)
    assert sorted(map(key, vols)) == sorted(map(key, want))
    assert all(m.ssize == store.seq_size(m.sid) for m in vols)
    parts = sorted(p for p in os.listdir(ck) if p.startswith("map_v001"))
    assert parts
    os.remove(os.path.join(ck, parts[0]))
    again, _ = mapper.map_all_volumes(reads, store, cfg, ckpt_dir=ck,
                                      device="cpu")
    assert sorted(map(key, again)) == sorted(map(key, vols))


def test_map_routes_fills_to_both_state_types(monkeypatch):
    """A read with a 1.6 kb stretch at 35% error holds no seed there, so
    the stretch becomes one inter-anchor segment of the Q=2048 bucket,
    outside the int16 gate: the map path hands that bucket to the int32
    fill and the small buckets to the int16 one, and the records equal
    lesv_tpu's."""
    from lesv_tpu_torch.ops import align_torch

    rng = np.random.default_rng(4)
    genome = random_genome(rng, 200_000)
    store = SeqStore.from_records([("chr1", genome)])
    cfg = LesvConfig()
    index = KmerIndex.build(store, cfg.index)
    st = 50_000
    reads = [
        ("clean", mutate_read(rng, genome[120_000:132_000], err=0.1)),
        ("noisy_mid", np.concatenate([
            mutate_read(rng, genome[st : st + 5_000], err=0.1),
            mutate_read(rng, genome[st + 5_000 : st + 6_600], err=0.35),
            mutate_read(rng, genome[st + 6_600 : st + 12_000], err=0.1)])),
    ]
    seen = set()
    plain = align_torch.banded_align_kernel

    def spy(q, *a, i16=False, **kw):
        seen.add((q.shape[1], i16))
        return plain(q, *a, i16=i16, **kw)

    monkeypatch.setattr(align_torch, "banded_align_kernel", spy)
    got, _ = mapper.map_all(reads, *_port(store, index, cfg), device="cpu")
    assert (2048, False) in seen
    assert any(i16 for _, i16 in seen)
    assert all(i16 == (Q < 2048) for Q, i16 in seen), seen
    want, _ = jax_mapper.map_all(reads, store, index, cfg)
    assert {m.qid for m in got} == {0, 1}
    _assert_same_m4s(got, want)
