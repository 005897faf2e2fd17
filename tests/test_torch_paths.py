"""The port's read and pair chaining with the sliced fetch, on the CPU,
against lesv_tpu with exact equality: seeding + ``chain_lanes_sliced``
(the chain at the live slots, one sliced readback) against lesv_tpu's
fused programs (``seed_chain_lanes_fused``, ``pair_chain_lanes_fused``,
which fetch through its ``fetch_chain_sliced``), ``fetch_chain_sliced``
against ``fetch_chain_arrays`` and lesv_tpu's, ``_shrink_M``,
``map_batch`` and ``batch_pair_chains`` (which take the sliced fetch),
``map_read`` and ``annotate``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from lesv_tpu.config import LesvConfig
from lesv_tpu.index.kmer_index import KmerIndex
from lesv_tpu.io.seqstore import SeqStore
from lesv_tpu.ops import chain_jax
from lesv_tpu.ops import pairseed_jax
from lesv_tpu.ops import seeding_jax
from lesv_tpu.pipeline import batch_align as jax_batch_align
from lesv_tpu.pipeline import mapper as jax_mapper
from lesv_tpu.sim import mutate_read, random_genome
from lesv_tpu_torch import convert
from lesv_tpu_torch.ops import chain_torch
from lesv_tpu_torch.ops import pairseed_torch
from lesv_tpu_torch.pipeline import batch_align, mapper
from lesv_tpu_torch.utils import profiling
from torch_cases import U32_TOP, chain_edge_lanes

# one intra-op thread: the suite runs several workers at once, and the
# small CPU tensor ops of the plain versions gain nothing from more
torch.set_num_threads(1)


def _chain_key(c):
    return (c.score, c.qbeg, c.qend, c.sbeg, c.send, c.anchors.tobytes(),
            c.seed_len)


def _lanes_key(lanes):
    return [[_chain_key(c) for c in lane] for lane in lanes]


def _m4_key(m):
    return (m.qid, m.qdir, m.sid, m.qoff, m.qend, m.qsize, m.soff, m.send,
            m.ssize, m.score, m.dist, round(m.ident_perc, 9),
            m.ops.tobytes())


@pytest.fixture(scope="module")
def world():
    """A 52 kb genome whose last 12 kb are twelve copies of one 1 kb unit;
    reads at 10% error, one error-free read inside the repeat (its
    forward lane overflows a small seed budget), and pair tasks of read
    pieces against their windows, one of them inside the repeat."""
    rng = np.random.default_rng(5)
    g = random_genome(rng, 40_000)
    genome = np.concatenate([g, np.tile(g[30_000:31_000], 12)])
    store = SeqStore.from_records([("chr1", genome)])
    cfg = LesvConfig()
    index = KmerIndex.build(store, cfg.index)
    reads = [mutate_read(rng, genome[a : a + n], err=0.1)
             for a, n in ((1_000, 3_000), (20_000, 2_500), (5_000, 1_200))]
    reads.append(genome[40_500:43_000].copy())
    pairs = []
    for _ in range(20):
        n = int(rng.integers(200, 2_000))
        a = int(rng.integers(0, 38_000 - n))
        pairs.append((mutate_read(rng, genome[a : a + n], err=0.1),
                      genome[max(0, a - 300) : a + n + 300]))
    pairs.append((genome[41_000:42_500].copy(), genome[40_000:44_000]))
    port = (convert.seqstore_from_arrays(store.names, store.starts,
                                         store.packed, store.ambig),
            convert.kmer_index_from_arrays(
                index.k, index.window, index.uniq_hash, index.start,
                index.positions, index.subject_starts),
            convert.config_from_dict(dataclasses.asdict(cfg)))
    return dict(store=store, index=index, cfg=cfg, reads=reads, pairs=pairs,
                port=port)


# -- seeding + chain_lanes_sliced against lesv_tpu's fused programs ----------

@pytest.mark.parametrize("chain", ["scan", "pallas"])
def test_seed_chain_chunk_equals_jax_fused(world, monkeypatch, chain):
    """The mapper's seeding + chaining of a read chunk
    (``mapper._seed_chain_chunk``: the chain at the live slots, the sliced
    fetch) gives, lane for lane, the chains and totals of lesv_tpu's fused
    program (its XLA scan, or its Pallas chain kernel in interpret mode);
    the repeat read's forward lane has a total above the budget M."""
    if chain == "pallas":
        monkeypatch.setenv("LESV_TPU_CHAIN", "pallas")
        monkeypatch.setenv("LESV_TPU_PALLAS", "interp")
    M, Qmax = 1024, 4096
    cfg = world["cfg"]
    _, pidx, pcfg = world["port"]
    want, wtot = seeding_jax.seed_chain_lanes_fused(
        world["reads"], world["index"], cfg.seeding, cfg.chain, M=M,
        Qmax=Qmax, J=64)
    got, gtot = mapper._seed_chain_chunk(world["reads"], pidx, pcfg, M, Qmax,
                                         "cpu")
    n = 2 * len(world["reads"])
    np.testing.assert_array_equal(gtot[:n], np.asarray(wtot)[:n])
    assert gtot[6] > M and sum(len(lane) for lane in got) >= 4
    assert _lanes_key(got[:n]) == _lanes_key(want[:n])


def test_pair_chain_lanes_sliced_equals_jax_fused(world):
    """Pair seeding + ``chain_lanes_sliced`` (``batch_pair_chains``'s
    chunk) gives, pair for pair, the chains and totals of lesv_tpu's fused
    program; the repeat pair's total is above the budget M."""
    cfg = world["cfg"]
    _, _, pcfg = world["port"]
    jc = jax_batch_align._pair_chain_cfg(cfg)
    tc = batch_align._pair_chain_cfg(pcfg)
    m = cfg.memsc
    M, Qb, Sb = 512, 2048, 4096
    n = len(world["pairs"])
    want, wtot = pairseed_jax.pair_chain_lanes_fused(
        world["pairs"], k=m.kmer_size, q_stride=m.kmer_window,
        max_occ=m.max_occ, M=M, Qb=Qb, Sb=Sb, ccfg=jc, J=64)
    qoff, soff, valid, gtot = pairseed_torch.pair_matches_batch(
        world["pairs"], k=m.kmer_size, q_stride=m.kmer_window,
        max_occ=m.max_occ, M=M, Qb=Qb, Sb=Sb, device="cpu")
    got = chain_torch.chain_lanes_sliced(qoff, soff, valid, gtot, M,
                                         m.kmer_size, tc, J=64, q16=True,
                                         s16=True)
    np.testing.assert_array_equal(gtot[:n], np.asarray(wtot)[:n])
    assert gtot[n - 1] > M
    assert sum(len(lane) for lane in got) >= 15
    assert _lanes_key(got[:n]) == _lanes_key(want[:n])


# -- the sliced fetch ------------------------------------------------------------

def _seed_lanes(rng, J: int, M: int, local: bool, overflow: bool):
    """chain_edge_lanes (valid counts 0, 1, J - 1, J, J + 1, M / 2) and,
    with ``overflow``, a lane with every slot valid whose total is above M;
    with ``local`` the subject offsets are cut below 2^16 (pair windows).
    Returns numpy (qoff, soff, valid, total)."""
    qoff, soff, valid = chain_edge_lanes(rng, J, M)
    total = valid.sum(1)
    if overflow:
        q = np.sort(rng.integers(0, 6 * M, M)).astype(np.int32)
        s = U32_TOP - 8 * M + q.astype(np.int64) + rng.integers(0, 300, M)
        qoff = np.vstack([qoff, q[None]])
        soff = np.vstack([soff, s[None]])
        valid = np.vstack([valid, np.ones((1, M), bool)])
        total = np.append(total, M + 100)
    if local:
        soff = np.where(valid, soff - (U32_TOP - 60_000), soff)
    return qoff, soff, valid, total


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("overflow", [False, True])
def test_fetch_chain_sliced_equals_fetch_chain_arrays_and_jax(local,
                                                              overflow):
    """On the same scan outputs, the sliced fetch gives the full fetch's
    f, p, v, qs and ss on every valid slot, and its valid mask clamped at M
    (with ``overflow`` a lane's total exceeds M, and Mp is M; without, Mp
    is M / 2); and it equals lesv_tpu's ``fetch_chain_sliced`` on every
    slot."""
    import jax.numpy as jnp

    J, M = 64, 512
    qoff, soff, valid, total = _seed_lanes(np.random.default_rng(3), J, M,
                                           local, overflow)
    Mp = chain_torch._shrink_M(total, M)
    assert Mp == (M if overflow else M // 2)
    f, p_rel, v, qs, ss, vs = chain_torch.sort_scan(
        torch.from_numpy(qoff), torch.from_numpy(soff),
        torch.from_numpy(valid), J, 15, 5000, 5000, 500)
    full = chain_torch.fetch_chain_arrays(f, p_rel, v, qs, ss, vs)
    got = chain_torch.fetch_chain_sliced(f, p_rel, qs, ss, total, M, Mp,
                                         q16=True, s16=local)
    n_valid = np.minimum(total, M)
    np.testing.assert_array_equal(got[5],
                                  np.arange(Mp)[None] < n_valid[:, None])
    np.testing.assert_array_equal(got[5], full[5][:, :Mp])
    for b, n in enumerate(n_valid):
        for a, w in zip(got[:5], full[:5]):
            np.testing.assert_array_equal(a[b, :n], w[b, :n])
    want = chain_jax.fetch_chain_sliced(
        *(jnp.asarray(x.numpy()) for x in (f, p_rel, v, qs)),
        jnp.asarray(ss.numpy().astype(np.uint32)), total, M, Mp, q16=True,
        s16=local)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(w))


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("overflow", [False, True])
def test_chain_lanes_sliced_equals_chain_lanes_and_jax(local, overflow):
    """``chain_lanes_sliced`` (the chain at Mp, the sliced fetch) gives the
    chains of ``chain_lanes`` (the full fetch) at the same Mp and of
    lesv_tpu's ``chain_lanes``, lane for lane, on seeds whose valid slots
    are a prefix, a lane of them with its total above M."""
    import jax.numpy as jnp

    from lesv_tpu.config import ChainConfig

    J, M = 64, 512
    qoff, soff, valid, total = _seed_lanes(np.random.default_rng(17), J, M,
                                           local, overflow)
    cfg = ChainConfig()
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg), "chain")
    t = [torch.from_numpy(x) for x in (qoff, soff, valid)]
    got = chain_torch.chain_lanes_sliced(*t, total, M, 15, pcfg, J=J,
                                         q16=True, s16=local)
    Mp = chain_torch._shrink_M(total, M)
    full = chain_torch.chain_lanes(*t, 15, pcfg, J=J, Mp=Mp)
    want = chain_jax.chain_lanes(jnp.asarray(qoff),
                                 jnp.asarray(soff.astype(np.uint32)),
                                 jnp.asarray(valid), 15, cfg, J=J, Mp=Mp)
    assert sum(len(lane) for lane in got) >= 3
    assert _lanes_key(got) == _lanes_key(full) == _lanes_key(want)


@pytest.mark.parametrize("M", [256, 1024, 16_384])
def test_shrink_M_equals_jax(M):
    """``chain_torch._shrink_M`` takes lesv_tpu's slot count on totals below,
    at and above every step of its ladder and above the budget."""
    totals = [np.array([0]), np.array([], np.int64)]
    for step in (256, 512, 1024, 4096, 16_384, 32_768):
        for d in (-1, 0, 1):
            totals.append(np.array([3, step + d, 7]))
    for total in totals:
        assert (chain_torch._shrink_M(total, M)
                == jax_batch_align._shrink_M(total, M))


def test_sort_scan_chain_batch_device_extract_lanes_equal_jax():
    """``sort_scan``, ``chain_batch_device`` (at a slot cut Mp) and
    ``extract_lanes`` equal lesv_tpu's on the same seeds (its XLA scan)."""
    import jax.numpy as jnp

    from lesv_tpu.config import ChainConfig

    J, M, Mp = 64, 512, 256
    qoff, soff, valid, _ = _seed_lanes(np.random.default_rng(9), J, M,
                                       False, False)
    cfg = ChainConfig()
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg), "chain")
    args = (J, 15, cfg.max_dist_qry, cfg.max_dist_ref, cfg.max_band_width)
    got = chain_torch.sort_scan(torch.from_numpy(qoff),
                                torch.from_numpy(soff),
                                torch.from_numpy(valid), *args)
    want = chain_jax.sort_scan(jnp.asarray(qoff),
                               jnp.asarray(soff.astype(np.uint32)),
                               jnp.asarray(valid), *args, False, False)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w).astype(
            a.numpy().dtype))
    got = chain_torch.chain_batch_device(
        torch.from_numpy(qoff), torch.from_numpy(soff),
        torch.from_numpy(valid), 15, pcfg, J=J, Mp=Mp)
    want = chain_jax.chain_batch_device(
        jnp.asarray(qoff), jnp.asarray(soff.astype(np.uint32)),
        jnp.asarray(valid), 15, cfg, J=J, Mp=Mp)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, w)
    lanes = chain_torch.extract_lanes(*got, 15, pcfg)
    assert sum(len(lane) for lane in lanes) >= 3
    assert _lanes_key(lanes) == _lanes_key(chain_jax.extract_lanes(
        *want, 15, cfg))


# -- the pipeline, against lesv_tpu ----------------------------------------------

def test_map_batch_and_pair_chains_sliced_equal_jax(world, monkeypatch):
    """``map_batch`` and ``batch_pair_chains`` on the CPU equal lesv_tpu's;
    spies show that their chaining took the sliced fetch and never the
    full one.  The pair budget is cut so that the repeat pair is redone on
    the host."""
    calls = {"sliced": 0}
    sliced = chain_torch.fetch_chain_sliced

    def spy(*a, **kw):
        calls["sliced"] += 1
        return sliced(*a, **kw)

    def no_full_fetch(*a, **kw):
        raise AssertionError("the pipeline took the full fetch")

    monkeypatch.setattr(chain_torch, "fetch_chain_sliced", spy)
    monkeypatch.setattr(chain_torch, "fetch_chain_arrays", no_full_fetch)
    pstore, pidx, pcfg = world["port"]
    batch = list(enumerate(world["reads"][:2]))
    want = jax_mapper.map_batch(batch, world["store"], world["index"],
                                world["cfg"])
    got = mapper.map_batch(batch, pstore, pidx, pcfg, device="cpu")
    assert calls["sliced"] >= 2
    assert len(got) >= 2
    assert [_m4_key(m) for m in got] == [_m4_key(m) for m in want]

    cfg = dataclasses.replace(world["cfg"])
    cfg.map = dataclasses.replace(cfg.map, pair_match_budget=1024)
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    calls["sliced"] = 0
    want = jax_batch_align.batch_pair_chains(world["pairs"], cfg)
    got = batch_align.batch_pair_chains(world["pairs"], pcfg, device="cpu")
    assert calls["sliced"] >= 1
    assert _lanes_key(got) == _lanes_key(want)


def test_map_read_equals_jax(world):
    pstore, pidx, pcfg = world["port"]
    read = world["reads"][1]
    want = jax_mapper.map_read(7, read, world["store"], world["index"],
                               world["cfg"])
    got = mapper.map_read(7, read, pstore, pidx, pcfg, device="cpu")
    assert len(got) >= 1 and {m.qid for m in got} == {7}
    assert [_m4_key(m) for m in got] == [_m4_key(m) for m in want]


# -- a span names a region -----------------------------------------------------

def test_annotate_names_a_region_in_the_device_trace(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "_enabled", True)
    with profiling.device_trace(str(tmp_path)):
        with profiling.trace("paths/annotated_region"):
            torch.arange(64).sum()
    with open(os.path.join(tmp_path, "trace.json")) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "lesv/paths/annotated_region" in names
