"""The port's mesh path (``lesv_tpu_torch.parallel.mesh``) on CPU tensors
against its own one-device path and against ``lesv_tpu.parallel.mesh`` on
the 8-device virtual CPU mesh of tests/conftest.py.

A CPU mesh is ``make_mesh(devices=[cpu] * n)``: n shards computed in turn
by the plain PyTorch versions, which exercises the cut, the padding, the
per-shard traceback and the concatenation.  Every comparison is exact (all
values are integers).  Direction bytes are compared on the rows 0..qlen of
each lane (later rows are unspecified), and only between fills of one
state type: the int16 and int32 fills may differ in cells the traceback
cannot visit, so across state types the op strings are compared instead.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lesv_tpu.config import AlignConfig as JaxAlignConfig
from lesv_tpu.config import IndexConfig, LesvConfig
from lesv_tpu.index.kmer_index import KmerIndex
from lesv_tpu.io.seqstore import SeqStore
from lesv_tpu.ops import align_jax
from lesv_tpu.parallel import mesh as jax_mesh
from lesv_tpu.sim import mutate_read, random_genome
from lesv_tpu_torch import convert
from lesv_tpu_torch.ops import align_torch
from lesv_tpu_torch.parallel import mesh
from lesv_tpu_torch.pipeline import mapper

# one intra-op thread: the suite runs several workers at once, and the
# small CPU tensor ops of the plain versions gain nothing from more
torch.set_num_threads(1)

CPU = torch.device("cpu")
B, Q, S, W = 16, 64, 128, 64      # as tests/test_parallel.py


def cpu_mesh(n):
    return mesh.make_mesh(devices=[CPU] * n)


def _cfgs():
    jcfg = JaxAlignConfig()
    return jcfg, convert.config_from_dict(dataclasses.asdict(jcfg), "align")


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    s = rng.integers(0, 4, (B, S), dtype=np.uint8)
    q = np.zeros((B, Q), np.uint8)
    qlen = np.zeros(B, np.int32)
    for i in range(B):
        m = mutate_read(rng, s[i, :Q], err=0.05)[:Q]
        q[i, : len(m)] = m
        qlen[i] = len(m)
    qlen[3] = 40                      # ragged: shards differ in depth
    slen = np.minimum(qlen + 8, S - 1).astype(np.int32)
    return q, s, qlen, slen


@pytest.fixture(scope="module")
def jax_fill(batch):
    """lesv_tpu's mesh_fill (XLA scan, int32) on the 8-device mesh."""
    jcfg, _ = _cfgs()
    out = jax_mesh.mesh_fill(jax_mesh.make_mesh(8),
                             *(jnp.asarray(x) for x in batch), W, "diag",
                             jcfg, False, use_pallas=False)
    return [np.asarray(x) for x in out]


def _joined(fill):
    """A ShardedFill as five host arrays in batch order."""
    return [torch.cat([sh[j] for sh in fill.shards]).numpy()
            for j in range(5)]


def _assert_fill_equal(got, want, qlen, dirs=True):
    for name, g, w in zip(("score", "end_i", "end_b", "ok"), got[1:],
                          want[1:]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    if dirs:
        live = np.arange(got[0].shape[1])[None, :, None] <= \
            qlen[:, None, None]
        assert not (live & (got[0] != want[0])).any()


def _ops(dirs, end_i, end_b, ok, mode="diag"):
    t = [torch.from_numpy(np.array(x))
         for x in (dirs, end_i, end_b, ok)]
    ops, n, reached = align_torch.traceback_plain(
        *t, W, mode, dirs.shape[1] + W + 2)
    return [o[:k].tolist() if r else None
            for o, k, r in zip(ops.numpy(), n.numpy(), reached.numpy())]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_fill_equals_one_device_and_jax(batch, jax_fill, n):
    _, cfg = _cfgs()
    qlen = batch[2]
    fill = mesh.mesh_fill(cpu_mesh(n), *batch, W, "diag", cfg, False,
                          force_i16=False)
    assert len(fill.shards) == n and not fill.i16
    assert all(sh[0].shape == (B // n, Q + 1, W) for sh in fill.shards)
    got = _joined(fill)
    one = [x.numpy() for x in align_torch.banded_fill(
        *(torch.from_numpy(x) for x in batch), W, "diag", cfg, False,
        force_i16=False)]
    _assert_fill_equal(got, one, qlen)
    _assert_fill_equal(got, jax_fill, qlen)
    for g, w in zip(fill.small(), got[1:]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[4].all()


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_fill_gate_is_decided_for_the_whole_batch(batch, jax_fill, n):
    """With no state type pinned the int16 gate holds at (Q=64, W=64):
    every shard is filled in int16, and score, end cell, ok and the op
    strings equal the int32 fill of lesv_tpu."""
    _, cfg = _cfgs()
    fill = mesh.mesh_fill(cpu_mesh(n), *batch, W, "diag", cfg, False)
    assert fill.i16 and align_torch.i16_ok(Q, W, cfg)
    got = _joined(fill)
    _assert_fill_equal(got, jax_fill, batch[2], dirs=False)
    assert _ops(*got[:1], *got[2:]) == _ops(jax_fill[0], *jax_fill[2:])


def test_mesh_fill_equals_jax_pallas_interpret(batch):
    """lesv_tpu's mesh_fill through the Pallas kernel in interpret mode
    (2 devices x 8 lanes; its gate picks int16 too)."""
    jcfg, cfg = _cfgs()
    pd, ps, pei, peb, pok = (np.asarray(x) for x in jax_mesh.mesh_fill(
        jax_mesh.make_mesh(2), *(jnp.asarray(x) for x in batch), W, "diag",
        jcfg, True, use_pallas=True, interpret=True))
    got = _joined(mesh.mesh_fill(cpu_mesh(2), *batch, W, "diag", cfg, True))
    _assert_fill_equal(got, [None, ps, pei, peb, pok], batch[2], dirs=False)
    pops, pn, preach = align_jax.traceback_batch(pd, pei, peb, pok, W,
                                                 "diag", layout="rwb")
    want = [o[:k].tolist() if r else None
            for o, k, r in zip(pops, pn, preach)]
    assert _ops(*got[:1], *got[2:]) == want and any(want)


def test_mesh_fill_refuses_a_ragged_batch(batch):
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        mesh.mesh_fill(cpu_mesh(3), *batch, W, "diag", cfg, False)


def test_mesh_selection():
    m4 = cpu_mesh(4)
    assert m4.size == 4
    assert mesh.active_mesh("cpu") is None
    with mesh.use_mesh(m4):
        assert mesh.active_mesh("cpu") is m4
        # a mesh of another device type, or a device with an index, is
        # not taken
        assert mesh.active_mesh("cuda") is None
        assert mesh.active_mesh("cuda:0") is None
        with mesh.use_mesh(cpu_mesh(2)) as inner:
            assert mesh.active_mesh(CPU) is inner
        assert mesh.active_mesh("cpu") is m4
    assert mesh.active_mesh("cpu") is None
    with pytest.raises(ValueError):
        mesh.make_mesh(devices=[])
    with pytest.raises(ValueError, match="not both"):
        mesh.make_mesh(2, devices=[CPU] * 4)
    if not torch.cuda.is_available():
        # no fallback to fewer devices or to the CPU
        with pytest.raises(RuntimeError):
            mesh.make_mesh()
        with pytest.raises(RuntimeError):
            mesh.make_mesh(devices=["cuda:0", "cuda:1"])


@pytest.mark.parametrize("n_lanes,n", [(13, 4), (16, 8), (13, 8), (2, 4)])
@pytest.mark.parametrize("free_end", [False, True])
def test_align_batch_under_mesh_equals_no_mesh(batch, monkeypatch, n_lanes,
                                               n, free_end):
    """A batch that is not a multiple of the mesh (13 live lanes, 3 dead
    ones behind them) is padded inside the dispatch; the result equals the
    one-device result lane for lane, and no padding lane is ok.  Fewer live
    lanes than devices stay on one device."""
    _, cfg = _cfgs()
    q, s, qlen, slen = (x.copy() for x in batch)
    qlen[n_lanes:] = 0
    slen[n_lanes:] = 0
    calls = []
    real = mesh.mesh_fill
    monkeypatch.setattr(mesh, "mesh_fill",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    want = align_torch.banded_align_batch(q, s, qlen, slen, W, "diag", cfg,
                                          free_end=free_end, device="cpu")
    assert not calls
    with mesh.use_mesh(cpu_mesh(n)):
        got = align_torch.banded_align_batch(q, s, qlen, slen, W, "diag",
                                             cfg, free_end=free_end,
                                             device="cpu")
    assert len(calls) == (1 if n_lanes >= n else 0)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert len(got[key]) == B
    assert got["ok"][:n_lanes].all() and not got["ok"][n_lanes:].any()
    jwant = align_jax.banded_align_batch(q, s, qlen, slen, W, "diag",
                                         JaxAlignConfig(), free_end=free_end)
    for key in ("score", "ok", "qe", "se", "nops"):
        np.testing.assert_array_equal(got[key], jwant[key], err_msg=key)


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_align_step_equals_jax(batch, n):
    jcfg, cfg = _cfgs()
    want = jax_mesh.sharded_align_step(jax_mesh.make_mesh(8), W, "diag",
                                       jcfg)(*(jnp.asarray(x) for x in batch))
    got = mesh.sharded_align_step(cpu_mesh(n), W, "diag", cfg)(*batch)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3] == int(want[3]) == B
    assert got[4] == int(want[4]) == int(got[0].sum())


@pytest.mark.parametrize("n", [1, 4])
def test_sharded_seed_chain_step_equals_jax(n):
    """Reads cut over the mesh, the index replicated: f, best, n_chained
    and score_sum equal lesv_tpu's step on its 8-device mesh."""
    from lesv_tpu.ops.seeding_jax import device_index_of

    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, 20_000).astype(np.uint8)
    icfg = IndexConfig()
    index = KmerIndex.build(SeqStore.from_records([("chr1", genome)]), icfg)
    Bs, Qmax, M = 16, 1024, 512
    codes = np.full((Bs, Qmax), 4, np.uint8)
    qlen = np.full(Bs, Qmax, np.int32)
    for b in range(Bs):
        st = int(rng.integers(0, len(genome) - Qmax))
        codes[b] = genome[st : st + Qmax]
    codes[5] = rng.integers(0, 4, Qmax)          # a read that chains nowhere
    codes[6, 500:] = 4
    qlen[6] = 500
    di = device_index_of(index)
    want = jax_mesh.sharded_seed_chain_step(
        jax_mesh.make_mesh(8), k=icfg.kmer_size, M=M)(
        jnp.asarray(codes), jnp.asarray(qlen), di.hash_hi, di.hash_lo,
        di.start, di.positions)
    pindex = convert.kmer_index_from_arrays(
        index.k, index.window, index.uniq_hash, index.start,
        index.positions, index.subject_starts)
    step = mesh.sharded_seed_chain_step(cpu_mesh(n), k=icfg.kmer_size, M=M)
    f, best, n_chained, score_sum = step(codes, qlen, pindex)
    np.testing.assert_array_equal(f.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(best.numpy(), np.asarray(want[1]))
    assert n_chained == int(want[2]) == Bs - 1
    assert score_sum == int(want[3]) > 0
    # the replicas are made once per index
    assert step(codes, qlen, pindex)[2] == n_chained


def test_map_batch_under_mesh_equals_map_batch(monkeypatch):
    """The whole map stage with every fill chunk shared over a 4-shard
    mesh gives the M4 records of the one-device path."""
    rng = np.random.default_rng(12)
    genome = random_genome(rng, 40_000)
    store = SeqStore.from_records([("chr1", genome)])
    jcfg = LesvConfig()
    index = KmerIndex.build(store, jcfg.index)
    donor = np.concatenate([genome[:20_000], genome[20_300:]])
    batch = [(0, mutate_read(rng, genome[3_000:8_000], err=0.1)),
             (1, mutate_read(rng, donor[17_000:23_000], err=0.1)),
             (2, mutate_read(rng, genome[30_000:34_000], err=0.08))]
    port = (convert.seqstore_from_arrays(store.names, store.starts,
                                         store.packed, store.ambig),
            convert.kmer_index_from_arrays(
                index.k, index.window, index.uniq_hash, index.start,
                index.positions, index.subject_starts),
            convert.config_from_dict(dataclasses.asdict(jcfg)))
    want = mapper.map_batch(batch, *port, device="cpu")
    calls = []
    real = mesh.mesh_fill
    monkeypatch.setattr(mesh, "mesh_fill",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with mesh.use_mesh(cpu_mesh(4)):
        got = mapper.map_batch(batch, *port, device="cpu")
    assert calls, "no fill went through the mesh"
    key = lambda m: (m.qid, m.qdir, m.sid, m.qoff, m.qend, m.qsize, m.soff,
                     m.send, m.ssize, m.score, m.dist, m.ident_perc)
    assert [key(m) for m in got] == [key(m) for m in want]
    assert {m.qid for m in got} == {0, 1, 2}
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.ops, b.ops)
