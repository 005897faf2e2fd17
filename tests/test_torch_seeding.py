"""The port's reference-index seeding and pair seeding (torch ops on CPU
tensors) against lesv_tpu's seed_matches_batch / pair_matches_batch:
exact equality of (qoff, soff, valid, total), budget-truncated lanes
included.  The index is built with lesv_tpu and handed to the port as
plain arrays (lesv_tpu_torch.convert)."""

import dataclasses

import numpy as np
import pytest
import torch

from lesv_tpu.config import IndexConfig, SeedingConfig
from lesv_tpu.index.kmer_index import KmerIndex
from lesv_tpu.io.seqstore import SeqStore
from lesv_tpu.sim import mutate_read, random_genome
from lesv_tpu_torch import convert
from lesv_tpu_torch.ops import pairseed_torch, seeding_torch

# one intra-op thread: the suite runs several workers at once, and the
# small CPU tensor ops of the plain versions gain nothing from more
torch.set_num_threads(1)


def _port_index(index):
    return convert.kmer_index_from_arrays(
        index.k, index.window, index.uniq_hash, index.start,
        index.positions, index.subject_starts)


def _assert_same(want, got):
    for w, g in zip(want, got):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                      np.asarray(g).astype(np.int64))


def _index_world(k, w):
    rng = np.random.default_rng(3)
    genome = random_genome(rng, 30_000)
    store = SeqStore.from_records([("chr1", genome)])
    index = KmerIndex.build(store, IndexConfig(kmer_size=k, kmer_window=w))
    reads = []
    for _ in range(5):
        start = int(rng.integers(0, 25_000))
        frag = genome[start : start + int(rng.integers(800, 4000))]
        reads.append(mutate_read(rng, frag, err=0.08))
    amb = reads[0].copy()
    amb[50:80] = 4
    reads.append(amb)
    return index, reads


@pytest.mark.parametrize("k,w,M", [(15, 10, 8192), (19, 20, 8192),
                                   (15, 10, 16)])
def test_seed_matches_batch_matches_jax(k, w, M):
    from lesv_tpu.ops.seeding_jax import seed_matches_batch

    index, reads = _index_world(k, w)
    cfg = SeedingConfig()
    want = seed_matches_batch(reads, index, cfg, M=M)
    got = seeding_torch.seed_matches_batch(
        reads, _port_index(index),
        convert.config_from_dict(dataclasses.asdict(cfg), "seeding"), M=M,
        device="cpu")
    _assert_same(want, got)
    total = got[3].numpy()
    assert total.max() > 0
    if M == 16:
        assert (total > M).any()       # truncated lanes covered


def test_sampled_offsets_and_device_index_round_trip():
    from lesv_tpu.ops.seeding_jax import sampled_offsets_static

    cfg = SeedingConfig()
    for k, w in ((15, 10), (19, 20), (12, 7)):
        np.testing.assert_array_equal(
            seeding_torch.sampled_offsets_static(4096, k, w, cfg),
            sampled_offsets_static(4096, k, w, cfg))
    index, _ = _index_world(15, 10)
    index = _port_index(index)
    di = seeding_torch.device_index_of(index, "cpu")
    assert seeding_torch.device_index_of(index, "cpu") is di
    h, start = di.hash.numpy(), di.start.numpy()
    pos = di.positions.numpy().astype(index.positions.dtype)
    np.testing.assert_array_equal(h, index.uniq_hash)
    np.testing.assert_array_equal(start, index.start)
    np.testing.assert_array_equal(pos, index.positions)
    assert di.nbytes == 8 * (len(h) + len(start) + len(pos))


def _pairs():
    rng = np.random.default_rng(11)
    pairs = []
    for _ in range(4):
        s = random_genome(rng, int(rng.integers(2000, 6000)))
        start = int(rng.integers(0, len(s) - 1500))
        pairs.append((mutate_read(rng, s[start : start + 1400], err=0.1), s))
    q0, s0 = pairs[0]
    q0 = q0.copy()
    q0[100:140] = 4
    pairs.append((q0, s0))
    # a tandem repeat: every hash over the occupancy caps
    rep = np.tile(np.array([0, 1, 2, 3, 0, 1, 2, 3, 3, 1, 2], np.uint8), 120)
    pairs.append((rep[:900], rep))
    return pairs


@pytest.mark.parametrize("M", [8192, 40])
def test_pair_matches_batch_matches_jax(M):
    from lesv_tpu.ops.pairseed_jax import pair_matches_batch

    pairs = _pairs()
    want = pair_matches_batch(pairs, M=M)
    got = pairseed_torch.pair_matches_batch(pairs, M=M, device="cpu")
    _assert_same(want, got)
    assert got[3][5] == 0
    if M == 40:
        assert (got[3] > M).any()


def test_pack_unpack_and_expand_slots_match_jax():
    import jax.numpy as jnp

    from lesv_tpu.ops.pairseed_jax import expand_slots, pack_codes

    rng = np.random.default_rng(2)
    codes = rng.integers(0, 5, (4, 64)).astype(np.uint8)
    want = pack_codes(codes)
    got = pairseed_torch.pack_codes(codes)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    back = pairseed_torch.unpack_codes(torch.from_numpy(got[0]),
                                       torch.from_numpy(got[1]))
    np.testing.assert_array_equal(back.numpy(), np.minimum(codes, 4))

    cnt = rng.integers(0, 4, (3, 50)).astype(np.int32)
    cnt[1] = 0
    for M in (16, 256):
        ws, wr, wv, wt = map(np.asarray, expand_slots(jnp.asarray(cnt), M))
        gs, gr, gv, gt = pairseed_torch.expand_slots(torch.from_numpy(cnt), M)
        np.testing.assert_array_equal(gv.numpy(), wv)
        np.testing.assert_array_equal(gt.numpy(), wt)
        np.testing.assert_array_equal(gs.numpy()[wv], ws[wv])
        np.testing.assert_array_equal(gr.numpy()[wv], wr[wv])
