"""The port's routing of small work to the host and its round-robin fill
dispatch without a mesh, on the CPU, against lesv_tpu under the same
switches (``LESV_TPU_*`` there, ``LESV_TORCH_*`` here), with exact
equality: ``align_batch._host_route``, ``_chunk_prefers_host`` (given
lesv_tpu's rates), ``batch_align._host_route_pairs``, ``align_pairs``,
``batch_pair_chains`` and ``map_all`` with routing forced on, and
``align_pairs`` dealt over three CPU devices in turn against lesv_tpu's
mesh-off path on its eight virtual devices."""

import dataclasses

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
from lesv_tpu_torch import convert
from lesv_tpu_torch.ops import align_batch
from lesv_tpu_torch.parallel import mesh
from lesv_tpu_torch.pipeline import batch_align, mapper
from torch_cases import align_pairs_world

# one intra-op thread: the suite runs several workers at once, and the
# small CPU tensor ops of the plain versions gain nothing from more
torch.set_num_threads(1)

# lesv_tpu's rates (ops/align_batch.py: LESV_TPU_HOST_CELL_RATE,
# LESV_TPU_D2H_BPS and the literals of _chunk_prefers_host); its x8 term
# above W=1,024 is the wide rate, which no chunk here reaches
JAX_RATES = align_batch.CostRates(
    host_cells_s=3e8, chunk_s=0.05, fill_i32_cells_s=25e9,
    fill_i16_cells_s=25e9, fill_wide_cells_s=25e9 / 8, traceback_s=0.09e-6,
    d2h_bytes_s=25e6)


def _switch(monkeypatch, name: str, value) -> None:
    """Set one switch in both packages."""
    monkeypatch.setenv(f"LESV_TPU_{name}", str(value))
    monkeypatch.setenv(f"LESV_TORCH_{name}", str(value))


def _pooled(monkeypatch) -> None:
    monkeypatch.setattr(align_batch, "_n_dispatch_workers", lambda dev: 4)
    monkeypatch.setattr(align_batch, "_n_host_workers", lambda: 3)
    monkeypatch.setattr(mapper, "_map_overlap_depth", lambda dev: 2)


def _aln(a):
    return None if a is None else (a.qb, a.qe, a.sb, a.se, a.score,
                                   a.ops.tobytes())


def _aln_norm(a):
    """``_aln`` with a zero-score empty alignment read as None: the device
    path and the host engine give the two forms for a lane with nothing to
    align, and every caller treats them alike."""
    if a is not None and len(a.ops) == 0 and a.score <= 0:
        return None
    return _aln(a)


def _length_grid(rng, n: int = 400):
    """(q, s) pairs of random lengths, 0 to 3,000, some far apart."""
    pairs = []
    for _ in range(n):
        lq = int(rng.integers(0, 3_000))
        ls = int(rng.integers(0, 3_000)) if rng.random() < 0.3 else max(
            0, lq + int(rng.integers(-200, 200)))
        pairs.append((np.zeros(lq, np.uint8), np.zeros(ls, np.uint8)))
    return pairs


# -- the routing plans -------------------------------------------------------

@pytest.mark.parametrize("free_end", [False, True])
def test_host_route_equals_jax(monkeypatch, free_end):
    """``_host_route`` gives lesv_tpu's set on a grid of caps and budgets,
    forced on and in ``auto`` on a card; ``auto`` on the CPU and ``0`` give
    none."""
    pairs = _length_grid(np.random.default_rng(11))
    seen = set()
    for mode, dev, on_cpu in (("1", "cpu", True), ("auto", "cuda", False),
                              ("1", "cuda:0", False)):
        _switch(monkeypatch, "HOST_SMALL", mode)
        for cap in (1 << 12, 1 << 18, 1 << 21):
            for budget in (1e5, 3e6, 3e8):
                _switch(monkeypatch, "HOST_CELLS_CAP", cap)
                _switch(monkeypatch, "HOST_CELLS_BUDGET", budget)
                got = align_batch._host_route(pairs, free_end, dev)
                want = jax_align_batch._host_route(pairs, free_end, on_cpu)
                assert got == want
                seen.add(len(got))
    assert len(seen) >= 5 and 0 not in seen
    for mode, dev, on_cpu in (("auto", "cpu", True), ("0", "cuda", False)):
        _switch(monkeypatch, "HOST_SMALL", mode)
        assert align_batch._host_route(pairs, free_end, dev) == set()
        assert jax_align_batch._host_route(pairs, free_end, on_cpu) == set()


def test_host_route_pairs_equals_jax(monkeypatch):
    """``_host_route_pairs`` gives lesv_tpu's set on a grid of caps and
    budgets, forced on and in ``auto`` on a card; none in ``auto`` on the
    CPU."""
    pairs = _length_grid(np.random.default_rng(12))
    seen = set()
    for mode, dev, on_cpu in (("1", "cpu", True), ("auto", "cuda", False)):
        _switch(monkeypatch, "HOST_SMALL", mode)
        for cap in (1_000, 4_000, 16_384):
            for budget in (2e4, 2e5, 2e8):
                _switch(monkeypatch, "HOST_PAIR_CAP", cap)
                _switch(monkeypatch, "HOST_PAIR_BUDGET", budget)
                got = batch_align._host_route_pairs(pairs, dev)
                assert got == jax_batch_align._host_route_pairs(pairs,
                                                                on_cpu)
                seen.add(len(got))
    assert len(seen) >= 5 and 0 not in seen
    _switch(monkeypatch, "HOST_SMALL", "auto")
    assert batch_align._host_route_pairs(pairs, "cpu") == set()
    assert jax_batch_align._host_route_pairs(pairs, True) == set()


def _chunks(rng):
    """(pairs, chunk, W, mode) of 8, 128 or 1,024 lanes and W up to 1,024
    (where lesv_tpu's padded lanes equal the port's), queries of 20 to
    4,000 bases."""
    out = []
    for n in (8, 128, 1024):
        for W in (64, 128, 256, 512, 1024):
            for hi in (100, 1_000, 4_000):
                lq = rng.integers(max(10, hi // 5), hi, n)
                ls = lq + rng.integers(-W // 4, W // 4, n)
                pairs = [(np.zeros(int(a), np.uint8),
                          np.zeros(max(1, int(b)), np.uint8))
                         for a, b in zip(lq, ls)]
                out.append((pairs, list(range(n)), W,
                            "diag" if W < 1024 else "full"))
    return out


@pytest.mark.parametrize("free_end", [False, True])
def test_chunk_prefers_host_equals_jax(monkeypatch, free_end):
    """Given lesv_tpu's rates, ``_chunk_prefers_host`` takes lesv_tpu's
    decision on every chunk, in either state type; with the rates read from
    the switches too.  A monster chunk goes to the host whatever the rates;
    with an infinitely slow host no other chunk does."""
    cases = _chunks(np.random.default_rng(13))
    decisions = []
    for pairs, chunk, W, mode in cases:
        want = jax_align_batch._chunk_prefers_host(pairs, chunk, W, mode,
                                                   free_end)
        for i16 in (False, True):
            assert align_batch._chunk_prefers_host(
                pairs, chunk, W, mode, free_end, JAX_RATES, i16=i16) == want
        decisions.append(want)
    assert 0 < sum(decisions) < len(decisions)

    # the switches: host rate and readback rate, both packages
    _switch(monkeypatch, "HOST_CELL_RATE", 2e9)
    _switch(monkeypatch, "D2H_BPS", 1e7)
    rates = align_batch.cost_rates()
    assert (rates.host_cells_s, rates.d2h_bytes_s) == (2e9, 1e7)
    env_rates = dataclasses.replace(JAX_RATES, host_cells_s=2e9,
                                    d2h_bytes_s=1e7)
    for pairs, chunk, W, mode in cases:
        assert align_batch._chunk_prefers_host(
            pairs, chunk, W, mode, free_end, env_rates) == \
            jax_align_batch._chunk_prefers_host(pairs, chunk, W, mode,
                                                free_end)

    slow_host = dataclasses.replace(JAX_RATES, host_cells_s=1e-12)
    for pairs, chunk, W, mode in cases:
        monster = align_batch._monster(max(len(p[0]) for p in pairs), W,
                                       len(chunk))
        assert align_batch._chunk_prefers_host(
            pairs, chunk, W, mode, free_end, slow_host) == monster
    # a monster: 8 lanes of 4,096 rows (Rq 16,384) at W = 16,384 full
    big = [(np.zeros(4_096, np.uint8), np.zeros(16_000, np.uint8))] * 8
    assert align_batch._monster(4_096, 16_384, 8)
    for rates in (JAX_RATES, slow_host, align_batch.COST_RATES):
        assert align_batch._chunk_prefers_host(big, list(range(8)), 16_384,
                                               "full", free_end, rates)
    assert jax_align_batch._chunk_prefers_host(big, list(range(8)), 16_384,
                                               "full", free_end)


# -- the paths, routing forced on --------------------------------------------

@pytest.mark.parametrize("free_end", [False, True])
def test_routed_align_pairs_equals_jax(monkeypatch, free_end):
    """``align_pairs`` with routing forced on (a cap that routes some of the
    pairs, a budget that stops it) equals lesv_tpu's ``_align_pairs_jax``
    under the same switches, and the port's routing-off result up to the
    form of an empty alignment; ``FILL_STATS`` counts the routed pairs."""
    pairs = align_pairs_world(np.random.default_rng(31))
    jcfg = LesvConfig().align
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg), "align")
    _switch(monkeypatch, "HOST_SMALL", "0")
    off = [_aln_norm(a) for a in align_batch.align_pairs(
        pairs, cfg, free_end=free_end, device="cpu")]
    _switch(monkeypatch, "HOST_SMALL", "1")
    _switch(monkeypatch, "HOST_CELLS_CAP", 20_000)
    _switch(monkeypatch, "HOST_CELLS_BUDGET", 8e5)
    hosted = align_batch._host_route(pairs, free_end, "cpu")
    under_cap = sum(1 for q, s in pairs if len(q) and len(s) and
                    align_batch._host_cost(len(q), len(s), free_end) <= 20_000)
    assert 50 <= len(hosted) < under_cap <= len(pairs) - 50
    align_batch.reset_fill_stats()
    got = align_batch.align_pairs(pairs, cfg, free_end=free_end,
                                  device="cpu")
    stats = dict(align_batch.FILL_STATS)
    want = jax_align_batch._align_pairs_jax(pairs, jcfg, free_end)
    assert [_aln(a) for a in got] == [_aln(a) for a in want]
    assert [_aln_norm(a) for a in got] == off
    assert stats["host_routed"] == len(hosted)
    assert stats["chunks_to_host"] == 0             # no cost model on CPU
    assert stats["host_fills"] >= len(hosted)
    assert stats["device_fills"] + stats["host_fills"] >= len(pairs) - 1


def test_routed_batch_pair_chains_equals_jax(monkeypatch):
    """``batch_pair_chains`` with routing forced on (a pair cap between the
    short and the long pairs, a budget that stops it), pooled: lesv_tpu's
    chains; the routed pairs never reach the device path."""
    rng = np.random.default_rng(5)
    genome, _ = repeat_genome(rng, 60_000, n_tandem=3, n_dups=1, n_runs=0)
    pairs = []
    for _ in range(24):
        n = int(rng.integers(300, 5_000))
        st = int(rng.integers(0, len(genome) - n - 600))
        s = genome[st : st + n + 600]
        q = mutate_read(rng, genome[st + 300 : st + 300 + n], err=0.1)
        pairs.append((q, s))
    jcfg = LesvConfig()
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    _switch(monkeypatch, "HOST_SMALL", "1")
    _switch(monkeypatch, "HOST_PAIR_CAP", 6_000)
    _switch(monkeypatch, "HOST_PAIR_BUDGET", 30_000)
    hosted = batch_align._host_route_pairs(pairs, "cpu")
    assert 3 <= len(hosted) <= len(pairs) - 6
    _pooled(monkeypatch)
    seen = []
    batch = batch_align.pair_matches_batch

    def spy(chunk, **kw):
        seen.extend(len(q) + len(s) for q, s in chunk)
        return batch(chunk, **kw)

    monkeypatch.setattr(batch_align, "pair_matches_batch", spy)
    got = batch_align.batch_pair_chains(pairs, cfg, device="cpu")
    want = jax_batch_align.batch_pair_chains(pairs, jcfg)
    key = lambda cs: [(c.score, c.qbeg, c.qend, c.sbeg, c.send,
                       np.asarray(c.anchors).tobytes()) for c in cs]
    assert [key(c) for c in got] == [key(c) for c in want]
    assert all(want)
    assert sorted(seen) == sorted(len(q) + len(s) for i, (q, s)
                                  in enumerate(pairs) if i not in hosted)


def _m4_key(m):
    return (m.qid, m.qdir, m.sid, m.qoff, m.qend, m.qsize, m.soff, m.send,
            m.ssize, m.score, m.dist, round(m.ident_perc, 9),
            m.ops.tobytes())


def test_routed_map_all_equals_jax(monkeypatch):
    """The map stage on a 120 kb world, three batches, with routing forced
    on in both packages and the port pooled: lesv_tpu's M4 records, and
    ``FILL_STATS`` shows routed fills."""
    rng = np.random.default_rng(42)
    genome = random_genome(rng, 120_000)
    store = SeqStore.from_records([("chr1", genome)])
    cfg = LesvConfig()
    cfg.map.batch_reads = 3
    index = KmerIndex.build(store, cfg.index)
    donor = np.concatenate([genome[:70_000], genome[70_800:]])
    reads = [("sv", mutate_read(rng, donor[66_000:74_000], err=0.1))]
    for i in range(6):
        st = int(rng.integers(0, 110_000))
        r = mutate_read(rng, genome[st : st + int(rng.integers(2_000, 5_000))],
                        err=0.1)
        reads.append((f"r{i}", revcomp(r) if i % 2 else r))
    _switch(monkeypatch, "HOST_SMALL", "1")
    want, _ = jax_mapper.map_all(reads, store, index, cfg)
    _pooled(monkeypatch)
    pstore = convert.seqstore_from_arrays(store.names, store.starts,
                                          store.packed, store.ambig)
    pindex = convert.kmer_index_from_arrays(
        index.k, index.window, index.uniq_hash, index.start,
        index.positions, index.subject_starts)
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    align_batch.reset_fill_stats()
    got, _ = mapper.map_all(reads, pstore, pindex, pcfg, device="cpu")
    stats = dict(align_batch.FILL_STATS)
    assert [_m4_key(m) for m in got] == [_m4_key(m) for m in want]
    assert len(want) >= 7
    assert stats["host_routed"] > 0
    assert stats["host_fills"] >= stats["host_routed"]


# -- round-robin without a mesh ----------------------------------------------

def test_round_robin_align_pairs_equals_jax_mesh_off(monkeypatch):
    """With ``LESV_TORCH_MESH=0`` and three CPU devices, device chunk t goes
    to device t % 3, and ``align_pairs`` equals lesv_tpu's
    ``_align_pairs_jax`` under ``LESV_TPU_MESH=0``, which deals its chunks
    over eight virtual devices; global and free-end."""
    _switch(monkeypatch, "MESH", "0")
    assert len(jax_align_batch._fill_devices()) >= 8
    devs = [torch.device("cpu") for _ in range(3)]
    monkeypatch.setattr(align_batch, "_fill_devices", lambda device: devs)
    sent = []
    dispatch = align_batch.banded_align_dispatch

    def spy(*a, device, **kw):
        sent.append(device)
        return dispatch(*a, device=device, **kw)

    monkeypatch.setattr(align_batch, "banded_align_dispatch", spy)
    rng = np.random.default_rng(3)
    pairs = []
    for _ in range(60):
        n = int(rng.integers(20, 700))
        q = rng.integers(0, 4, n).astype(np.uint8)
        pairs.append((q, mutate_read(rng, q, err=0.08)))
    jcfg = LesvConfig().align
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg), "align")
    for free_end in (False, True):
        sent.clear()
        got = align_batch.align_pairs(pairs, cfg, free_end=free_end,
                                      device="cpu")
        want = jax_align_batch._align_pairs_jax(pairs, jcfg, free_end)
        assert [_aln(a) for a in got] == [_aln(a) for a in want]
        assert len(sent) >= 4
        assert all(d is devs[t % 3] for t, d in enumerate(sent))


def test_mesh_switch_and_fill_devices(monkeypatch):
    """``LESV_TORCH_MESH=0`` turns the automatic mesh off and leaves an
    explicit ``use_mesh``; ``_fill_devices`` deals over every visible card
    for plain ``cuda`` (capped by ``LESV_TORCH_FILL_DEVICES``) and keeps
    ``cuda:N`` and ``cpu`` to one device."""
    cards = tuple(torch.device("cuda", i) for i in range(4))
    monkeypatch.setattr(mesh, "_AUTO", mesh.Mesh(cards))
    assert mesh.active_mesh("cuda").devices == cards
    monkeypatch.setenv("LESV_TORCH_MESH", "0")
    assert mesh.active_mesh("cuda") is None
    explicit = mesh.Mesh(cards[:2])
    with mesh.use_mesh(explicit):
        assert mesh.active_mesh("cuda") is explicit
    monkeypatch.delenv("LESV_TORCH_MESH")
    assert mesh.active_mesh("cuda:1") is None

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert align_batch._fill_devices("cuda") == list(cards)
    assert align_batch._fill_devices("cuda:2") == [cards[2]]
    assert align_batch._fill_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setenv("LESV_TORCH_FILL_DEVICES", "2")
    assert align_batch._fill_devices("cuda") == list(cards[:2])
