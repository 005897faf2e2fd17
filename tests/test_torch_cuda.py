"""The CUDA kernels of lesv_tpu_torch against their plain PyTorch
versions, on the card.  Marked ``cuda``: they skip where CUDA is not
available.  Run them on a GPU host with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports jax, which a GPU host need
not have; this file imports only the port).  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from lesv_tpu_torch import _ext
from lesv_tpu_torch.config import AlignConfig, LesvConfig
from lesv_tpu_torch.index.kmer_index import KmerIndex
from lesv_tpu_torch.io.seqstore import SeqStore
from lesv_tpu_torch.sim import mutate_read, random_genome
from lesv_tpu_torch.ops import align_torch, chain_torch
from torch_cases import (
    GENOME_SCALE_SHIFT,
    chain_edge_lanes,
    shifted_index_arrays,
    traceback_edge_case,
    unsorted_invalid_tail,
    volume_world,
)

# one intra-op thread: the suite runs several workers at once, and the
# small CPU tensor ops of the plain versions gain nothing from more
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _fill_batch(rng, W, mode, B=16, lo=200, hi=600, Q=None):
    """B lanes of a read against its source; from B = 8 on, lanes 0 to 3
    are the edges: query length 0, query length 1, subject length 0, and a
    subject shorter than W/2 (in global diag mode its end slot falls
    outside the band)."""
    pairs = []
    for k in range(B):
        s = rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.uint8)
        q = mutate_read(rng, s, err=0.12)[:Q]
        if B >= 8 and k < 4:
            q, s = ((q[:0], s), (q[:1], s), (q, s[:0]),
                    (q, s[: max(1, W // 4)]))[k]
        pairs.append((q, s))
    Q = Q or max(len(q) for q, _ in pairs)
    S = Q + W if mode == "diag" else W
    q = np.zeros((B, Q), np.uint8)
    s = np.zeros((B, S), np.uint8)
    for i, (qi, si) in enumerate(pairs):
        q[i, : len(qi)] = qi
        s[i, : min(len(si), S)] = si[:S]
    qlen = np.array([len(p[0]) for p in pairs], np.int32)
    slen = np.array([min(len(p[1]), S) for p in pairs], np.int32)
    return q, s, qlen, slen


# the fill's register design changes its warps and slots a lane at W =
# 64, 128, 256, 512 and 1,024 and gives way to the wide design above
# 2,048; W = 33, 65, 96, 511, 513, 1,025 and 2,049 leave slots idle or
# runs ragged
_EDGE_W = (33, 64, 65, 96, 511, 512, 513, 1025, 2048, 2049)


@pytest.mark.parametrize("W,mode,free_end,B", [
    (128, "diag", False, 16), (256, "diag", True, 16),
    (1024, "full", False, 16), (65, "full", True, 16),
    (8192, "full", False, 16)] + [
    (W, mode, fe, 16) for W in _EDGE_W for mode in ("diag", "full")
    for fe in (False, True)] + [
    (65, "full", False, 1), (512, "diag", True, 5), (96, "diag", False, 7),
    (2048, "full", True, 3), (4096, "diag", True, 4)])
def test_fill_and_traceback_kernels_equal_plain(dev, W, mode, free_end, B):
    """The int32 kernel against its plain version (every live direction
    byte, score, end cell, ok) and the traceback kernel on its bytes; where
    the int16 gate holds, the int16 kernel against its plain version too."""
    rng = np.random.default_rng(W + B)
    cfg = AlignConfig()
    q, s, qlen, slen = (torch.from_numpy(a).to(dev)
                        for a in _fill_batch(rng, W, mode, B=B))
    live = (torch.arange(q.shape[1] + 1, device=dev)[None, :, None]
            <= qlen[:, None, None])
    for i16 in (False, True):
        if i16 and not align_torch.i16_ok(q.shape[1], W, cfg):
            continue
        kd, ks, kei, keb, kok = align_torch.fill_cuda(
            q, s, qlen, slen, W, mode, cfg, free_end, i16=i16)
        pd, ps, pei, peb, pok = align_torch.banded_align_kernel(
            q, s, qlen, slen, W, mode, cfg, free_end, i16=i16)
        for a, b in ((ks, ps), (kei, pei), (keb, peb), (kok, pok)):
            assert torch.equal(a, b)
        assert not torch.where(live, kd != pd, False).any()
    kd, ks, kei, keb, kok = align_torch.fill_cuda(q, s, qlen, slen, W, mode,
                                                  cfg, free_end)
    T = q.shape[1] + 1 + W + 2
    kt = align_torch.traceback_cuda(kd, kei, keb, kok, W, mode, T)
    pt = align_torch.traceback_plain(kd, kei, keb, kok, W, mode, T)
    for a, b in zip(kt, pt):
        assert torch.equal(a, b)


@pytest.mark.parametrize("Q,W,mode,free_end,B", [
    (64, 65, "full", False, 128), (256, 512, "diag", False, 32),
    (256, 128, "diag", True, 32), (1024, 256, "diag", False, 16),
    # edges of the designs: idle slots, ragged runs, the wide design
    (64, 33, "diag", True, 9), (80, 65, "full", True, 16),
    (100, 96, "diag", False, 5), (300, 511, "full", True, 16),
    (256, 513, "diag", True, 16), (256, 1024, "full", True, 8),
    (256, 1025, "full", False, 8), (256, 1025, "diag", True, 8),
    (128, 64, "diag", False, 1),
    # the largest buckets of the fill launch histogram of `run`
    (64, 64, "full", False, 1024), (128, 128, "full", False, 1024),
    (256, 256, "full", False, 256), (512, 256, "diag", False, 256),
    (1024, 512, "diag", False, 64)])
def test_fill_i16_kernel_equals_plain_and_i32_kernel(dev, Q, W, mode,
                                                     free_end, B):
    """The int16 kernel: every live direction byte, score, end cell and
    ok equal its plain int16 version; score, end cell, ok and the ops of
    the traceback kernel equal the int32 kernel's.  Lanes 0 to 3 of a batch
    of 8 or more are the edges of ``_fill_batch``."""
    rng = np.random.default_rng(Q + W)
    cfg = AlignConfig()
    assert align_torch.i16_ok(Q, W, cfg)
    q, s, qlen, slen = (torch.from_numpy(a).to(dev) for a in _fill_batch(
        rng, W, mode, B=B, lo=Q // 3, hi=Q + Q // 4, Q=Q))
    before = dict(_ext.LAUNCHES)
    kd, ks, kei, keb, kok = align_torch.fill_cuda(q, s, qlen, slen, W, mode,
                                                  cfg, free_end, i16=True)
    assert _ext.LAUNCHES["fill_i16"] == before["fill_i16"] + 1
    assert _ext.LAUNCHES["fill"] == before["fill"]
    pd, ps, pei, peb, pok = align_torch.banded_align_kernel(
        q, s, qlen, slen, W, mode, cfg, free_end, i16=True)
    for a, b in ((ks, ps), (kei, pei), (keb, peb), (kok, pok)):
        assert torch.equal(a, b)
    live = (torch.arange(Q + 1, device=dev)[None, :, None]
            <= qlen[:, None, None])
    assert not torch.where(live, kd != pd, False).any()
    wd, ws, wei, web, wok = align_torch.fill_cuda(q, s, qlen, slen, W, mode,
                                                  cfg, free_end, i16=False)
    for a, b in ((ks, ws), (kei, wei), (keb, web), (kok, wok)):
        assert torch.equal(a, b)
    T = Q + 1 + W + 2
    for a, b in zip(align_torch.traceback_cuda(kd, kei, keb, kok, W, mode, T),
                    align_torch.traceback_cuda(wd, wei, web, wok, W, mode,
                                               T)):
        assert torch.equal(a, b)
    assert kok.any()


@pytest.mark.parametrize("W,mode,R", [
    (65, "full", 300), (65, "diag", 300), (512, "diag", 300),
    (4096, "full", 40), (8192, "full", 24), (8192, "diag", 24)])
def test_traceback_kernel_equals_plain_on_edge_lanes(dev, W, mode, R):
    """Random direction bytes through every exit of the walk: ok false,
    a path that leaves the band, an end cell outside it, a lane that walks
    until T runs out; 7 lanes, and T far longer than R + W + 2 (past the
    kernel's shared-memory op buffer on the widest bands)."""
    rng = np.random.default_rng(W + R)
    B = 7
    dirs, ei, eb, ok = (torch.from_numpy(a).to(dev)
                        for a in traceback_edge_case(rng, B, R, W))
    T = R + W + 2 + 9_001
    got = align_torch.traceback_cuda(dirs, ei, eb, ok, W, mode, T)
    want = align_torch.traceback_plain(dirs, ei, eb, ok, W, mode, T)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    n = want[1].cpu()
    assert n[0] == 0 and n[2] == 0
    assert n[1] == (T if mode == "full" else 0)


@pytest.mark.parametrize("mode", ["diag", "full"])
def test_traceback_kernel_equals_plain_far_past_the_last_row(dev, mode):
    """End rows up to 17,000 past R - 1: the walk steps in place on row
    R - 1 (diag M steps, full F1 steps with their extension flag) for more
    ops than the kernel's shared op buffer holds (16,384) before its row
    index comes down.  Below row R - 1 each row has its own pattern of M
    and F steps that leads to the origin, so a walk that left row R - 1
    too early would read other bytes."""
    B, R, W = 4, 40, 65
    r, c = np.mgrid[0 : R - 1, 0:W]
    turn = (7 * r + c) % 3 == 0
    if mode == "diag":  # F steps (slot + 1) up to slot W/2, M steps else
        rows = np.where(turn & (c < W // 2 - 1), 0x03, 0x00)
        row_last, eb = 0x00, 10
    else:  # M steps (slot - 1) keep the slot in 0..row, F steps else
        rows = np.where((c == 0) | (turn & (c < r)), 0x03, 0x00)
        row_last, eb = 0x23, 20
    dirs = np.empty((B, R, W), np.uint8)
    dirs[:, : R - 1] = rows
    dirs[:, R - 1] = row_last
    ei = (R - 1 + np.array([16_390, 17_000, 100, 0])).astype(np.int32)
    T = 17_000 + R + W + 2
    dirs, ei, eb, ok = (torch.from_numpy(a).to(dev) for a in (
        dirs, ei, np.full(B, eb, np.int32), np.ones(B, bool)))
    got = align_torch.traceback_cuda(dirs, ei, eb, ok, W, mode, T)
    want = align_torch.traceback_plain(dirs, ei, eb, ok, W, mode, T)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(want[2].all())
    assert want[1][1] > 17_000


# gap costs under which the int16 gate holds for fill_block's bands of
# 4,096 (queries up to 1,024)
_CHEAP = AlignConfig(match=1, mismatch=2, gap_open1=2, gap_ext1=1,
                     gap_open2=10, gap_ext2=1)


@pytest.mark.parametrize("C,W,mode,free_end,B,lo,hi,i16,scratch", [
    (2, 4096, "diag", False, 9, 1500, 3000, False, False),
    (2, 4097, "full", True, 9, 2000, 4096, False, False),
    (4, 8192, "diag", True, 8, 2500, 5000, False, False),
    (4, 8195, "full", False, 8, 4000, 8194, False, False),
    (8, 16384, "diag", False, 8, 3000, 6000, False, False),
    # CTAs of 704 threads, the last rank's run ragged
    (8, 16385, "full", True, 3, 9000, 16384, False, False),
    (16, 32768, "diag", True, 2, 4000, 8000, False, False),
    (16, 32769, "full", False, 2, 17000, 24000, False, False),
    # 16,384 slots a CTA: the row state in the global scratch
    (2, 32768, "diag", False, 2, 3000, 5000, False, True),
    (2, 32769, "full", True, 1, 12000, 20000, False, True),
    # int16 state
    (2, 4096, "full", True, 16, 300, 1000, True, False),
    (2, 4100, "diag", False, 16, 300, 1000, True, False)])
def test_split_fill_block_equals_one_cta_and_plain(
        dev, monkeypatch, C, W, mode, free_end, B, lo, hi, i16, scratch):
    """``fill_block`` with each lane's band split over a cluster of C CTAs
    (``cluster_split`` patched to C) against the same kernel at one CTA a
    lane and against the plain fill: every live direction byte, score,
    end cell and ok, on lanes of different query lengths (from 8 lanes on,
    lanes 0 to 3 the edges of ``_fill_batch``), in both modes and state
    types, the row state in shared memory or past ``SMEM_CAP``."""
    import ctypes

    if C > 8 and align_torch.cluster_limits(dev)[C] == 0:
        pytest.skip(f"the card refuses clusters of {C}")
    cfg = _CHEAP if i16 else AlignConfig()
    rng = np.random.default_rng(W + C + B)
    q, s, qlen, slen = (torch.from_numpy(a).to(dev) for a in _fill_batch(
        rng, W, mode, B=B, lo=lo, hi=hi, Q=1024 if i16 else None))
    assert len(set(qlen.tolist())) > 1 or B == 1
    assert align_torch.i16_ok(q.shape[1], W, cfg) == i16
    state = _ext.function("fill", "lesv_fill_state_bytes", [_ext.I] * 3,
                          ctypes.c_longlong)(W, C, 2 if i16 else 4)
    assert (state > align_torch.SMEM_CAP) == scratch
    outs = []
    for c in (C, 1):
        monkeypatch.setattr(align_torch, "cluster_split",
                            lambda B_, W_, lim, c=c: c)
        assert align_torch.fill_split(B, W, dev) == c
        before = _ext.LAUNCHES["fill_i16" if i16 else "fill"]
        outs.append(align_torch.fill_cuda(q, s, qlen, slen, W, mode, cfg,
                                          free_end, i16=i16))
        torch.cuda.synchronize()
        assert _ext.LAUNCHES["fill_i16" if i16 else "fill"] == before + 1
    plain = align_torch.banded_align_kernel(q, s, qlen, slen, W, mode, cfg,
                                            free_end, i16=i16)
    _outputs_equal(outs[0], outs[1], qlen)
    _outputs_equal(outs[0], plain, qlen)
    assert outs[0][4].any()


@pytest.mark.parametrize("C,W", [(3, 4096), (32, 65536), (2, 2048)])
def test_fill_refuses_a_cluster_size_it_cannot_run(dev, monkeypatch, C, W):
    """The launcher takes clusters of a power of two up to 16 CTAs, and
    more than one only in the wide design: anything else raises."""
    monkeypatch.setattr(align_torch, "cluster_split", lambda B, W_, lim: C)
    q, s, qlen, slen = (torch.from_numpy(a).to(dev) for a in _fill_batch(
        np.random.default_rng(3), W, "diag", B=2, lo=200, hi=400))
    with pytest.raises(RuntimeError, match="lesv_fill"):
        align_torch.fill_cuda(q, s, qlen, slen, W, "diag", AlignConfig())


def test_cluster_limits_of_the_card(dev):
    """The card holds clusters of 2, 4 and 8 CTAs of ``fill_block``, at
    least half its SMs' worth each, and as many or fewer of each larger
    size; 16 where it allows that size."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lim = align_torch.cluster_limits(dev)
    assert sorted(lim) == [2, 4, 8, 16]
    for C in (2, 4, 8):
        assert lim[C] * C >= sms // 2, lim
    assert lim[2] >= lim[4] >= lim[8] >= lim[16] >= 0


def test_fill_i16_kernel_refuses_a_closed_gate(dev):
    cfg = AlignConfig()
    q = torch.zeros((2, 4096), dtype=torch.uint8, device=dev)
    s = torch.zeros((2, 4096 + 512), dtype=torch.uint8, device=dev)
    ln = torch.full((2,), 100, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="i16_ok"):
        align_torch.fill_cuda(q, s, ln, ln, 512, "diag", cfg, i16=True)


@pytest.mark.parametrize("J", [32, 64, 128])
def test_chain_kernel_equals_plain(dev, J):
    rng = np.random.default_rng(J)
    B, M = 16, 700
    qoff = np.sort(rng.integers(0, 20_000, (B, M)), axis=1)
    soff = 3_000_000_000 + qoff + rng.integers(0, 1600, (B, M))
    valid = np.arange(M)[None, :] < rng.integers(1, M, B)[:, None]
    qs, ss, vs = chain_torch.sort_seeds_device(
        torch.from_numpy(qoff.astype(np.int32)).to(dev),
        torch.from_numpy(soff).to(dev), torch.from_numpy(valid).to(dev))
    args = dict(J=J, length=15, max_dq=5000, max_dr=5000, bw=1500)
    for a, b in zip(chain_torch.chain_scan_cuda(qs, ss, vs, **args),
                    chain_torch.chain_scan_plain(qs, ss, vs, **args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("J", [32, 64, 128])
@pytest.mark.parametrize("M", [700, 1025])
def test_chain_kernel_equals_plain_on_edge_lanes(dev, J, M):
    """Lanes of 0, 1, J-1, J, J+1 and M/2 valid seeds near 2^32 - 2 with
    tied predecessors, M not a multiple of the kernel's staging tile, and
    one lane whose invalid tail holds unsorted non-sentinel offsets."""
    rng = np.random.default_rng(J + M)
    qs, ss, vs = chain_torch.sort_seeds_device(
        *(torch.from_numpy(a).to(dev) for a in chain_edge_lanes(rng, J, M)))
    unsorted_invalid_tail(rng, qs, ss, vs, lane=3)
    args = dict(J=J, length=15, max_dq=5000, max_dr=5000, bw=1500)
    got = chain_torch.chain_scan_cuda(qs, ss, vs, **args)
    want = chain_torch.chain_scan_plain(qs, ss, vs, **args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (want[1] > 0).any()


def _outputs_equal(got, want, qlen):
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a.cpu(), b.cpu())
    live = (torch.arange(got[0].shape[1])[None, :, None]
            <= qlen.cpu()[:, None, None])
    assert not torch.where(live, got[0].cpu() != want[0].cpu(), False).any()


@pytest.mark.parametrize("Q,W,i16", [(256, 512, True), (3000, 256, False)])
def test_mesh_fill_on_the_cards_equals_one_card_and_plain(dev, Q, W, i16):
    """``mesh_fill`` over every visible card launches the fill kernel once
    per card, leaves each shard's outputs on its card, and equals
    ``fill_cuda`` on one card and the plain version."""
    from lesv_tpu_torch.parallel import mesh

    m = mesh.make_mesh()
    assert m.size == torch.cuda.device_count()
    rng = np.random.default_rng(Q)
    cfg = AlignConfig()
    B = 8 * m.size
    host = _fill_batch(rng, W, "diag", B=B, lo=Q // 3, hi=Q + Q // 4, Q=Q)
    name = "fill_i16" if i16 else "fill"
    before = _ext.LAUNCHES[name]
    fill = mesh.mesh_fill(m, *host, W, "diag", cfg, False)
    assert fill.i16 == i16 == align_torch.i16_ok(Q, W, cfg)
    assert _ext.LAUNCHES[name] == before + m.size
    for d, sh in zip(m.devices, fill.shards):
        assert all(t.device == d for t in sh)
    got = [torch.cat([sh[j].cpu() for sh in fill.shards]) for j in range(5)]
    q, s, qlen, slen = (torch.from_numpy(a).to(dev) for a in host)
    _outputs_equal(got, align_torch.fill_cuda(q, s, qlen, slen, W, "diag",
                                              cfg, False, i16=i16), qlen)
    _outputs_equal(got, align_torch.banded_align_kernel(
        q, s, qlen, slen, W, "diag", cfg, False, i16=i16), qlen)
    for a, b in zip(fill.small(), got[1:]):
        assert torch.equal(a, b)


def test_kernels_launch_on_the_highest_numbered_card(dev):
    """Fill, traceback and chain scan on tensors of the last visible card
    (the current device stays card 0) equal their plain versions; inputs
    on two different cards are refused."""
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    assert torch.cuda.current_device() == 0
    rng = np.random.default_rng(9)
    cfg = AlignConfig()
    W = 128
    q, s, qlen, slen = (torch.from_numpy(a).to(last)
                        for a in _fill_batch(rng, W, "diag"))
    kout = align_torch.banded_fill(q, s, qlen, slen, W, "diag", cfg)
    assert all(t.device == last for t in kout)
    i16 = align_torch.i16_ok(q.shape[1], W, cfg)
    _outputs_equal(kout, align_torch.banded_align_kernel(
        q, s, qlen, slen, W, "diag", cfg, i16=i16), qlen)
    kd, _, kei, keb, kok = kout
    T = q.shape[1] + 1 + W + 2
    for a, b in zip(align_torch.traceback_device(kd, kei, keb, kok, W,
                                                 "diag", T),
                    align_torch.traceback_plain(kd, kei, keb, kok, W, "diag",
                                                T)):
        assert a.device == last and torch.equal(a, b)
    M = 300
    qoff = np.sort(rng.integers(0, 20_000, (4, M)), axis=1)
    soff = 3_000_000_000 + qoff + rng.integers(0, 1600, (4, M))
    qs, ss, vs = chain_torch.sort_seeds_device(
        torch.from_numpy(qoff.astype(np.int32)).to(last),
        torch.from_numpy(soff).to(last),
        torch.ones((4, M), dtype=torch.bool, device=last))
    args = dict(J=64, length=15, max_dq=5000, max_dr=5000, bw=1500)
    for a, b in zip(chain_torch.chain_scan(qs, ss, vs, **args),
                    chain_torch.chain_scan_plain(qs, ss, vs, **args)):
        assert a.device == last and torch.equal(a, b)
    assert torch.cuda.current_device() == 0
    if last.index > 0:
        with pytest.raises(ValueError, match="different devices"):
            align_torch.fill_cuda(q.to("cuda:0"), s, qlen, slen, W, "diag",
                                  cfg)
    with pytest.raises(ValueError, match="CUDA"):
        align_torch.fill_cuda(q.cpu(), s.cpu(), qlen.cpu(), slen.cpu(), W,
                              "diag", cfg)


def test_map_on_cuda_equals_cpu(dev, monkeypatch):
    """The map stage on the GPU (all four kernels) equals the same map
    stage on CPU tensors (all plain versions).  Routing off: on, the map's
    small fills go to the host engine and no fill kernel need launch
    (test_routed_map_all_on_the_card holds the routing)."""
    from lesv_tpu_torch.pipeline.mapper import map_all

    monkeypatch.setenv("LESV_TORCH_HOST_SMALL", "0")

    rng = np.random.default_rng(4)
    genome = random_genome(rng, 200_000)
    store = SeqStore.from_records([("chr1", genome)])
    cfg = LesvConfig()
    index = KmerIndex.build(store, cfg.index)
    reads = []
    for i in range(6):
        st = int(rng.integers(0, 180_000))
        reads.append((f"r{i}", mutate_read(rng, genome[st : st + 12_000],
                                           err=0.1)))
    # a 1.6 kb stretch at 35% error holds no seed, so it becomes one
    # inter-anchor segment of the Q=2048 bucket, outside the int16 gate:
    # the int32 fill launches beside the int16 one
    st = 50_000
    reads.append(("noisy_mid", np.concatenate([
        mutate_read(rng, genome[st : st + 5_000], err=0.1),
        mutate_read(rng, genome[st + 5_000 : st + 6_600], err=0.35),
        mutate_read(rng, genome[st + 6_600 : st + 12_000], err=0.1)])))
    _ext.reset_launches()
    got, _ = map_all(reads, store, index, cfg, device=dev)
    assert all(v > 0 for v in _ext.LAUNCHES.values()), _ext.LAUNCHES
    want, _ = map_all(reads, store, index, cfg, device="cpu")
    key = lambda m: (m.qid, m.qdir, m.qoff, m.qend, m.soff, m.send, m.score)
    assert [key(m) for m in got] == [key(m) for m in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.ops, b.ops)


def _serial_workers(monkeypatch):
    from lesv_tpu_torch.ops import align_batch
    from lesv_tpu_torch.pipeline import mapper

    monkeypatch.setattr(align_batch, "_n_dispatch_workers", lambda d: 1)
    monkeypatch.setattr(mapper, "_map_overlap_depth", lambda d: 1)


def _counts():
    from lesv_tpu_torch.ops import align_batch

    return (dict(_ext.LAUNCHES), dict(_ext.FILL_SHAPES),
            dict(align_batch.FILL_STATS))


def _reset_counts():
    from lesv_tpu_torch.ops import align_batch

    _ext.reset_launches()
    align_batch.reset_fill_stats()


def _m4_key(m):
    return (m.qid, m.qdir, m.sid, m.qoff, m.qend, m.qsize, m.soff, m.send,
            m.ssize, m.score, m.dist, round(m.ident_perc, 9),
            m.ops.tobytes())


def test_overlapped_map_all_equals_serial(dev, monkeypatch):
    """Four map batches, two in flight, each align_pairs and
    batch_pair_chains call on 8 dispatch workers with a stream each: the
    same M4 records as the serial arm (worker counts 1), and the same
    launches per kernel and fill launches per shape.  Routing off, so that
    every kernel launches (test_routed_map_all_on_the_card holds the
    routed map, pooled and serial)."""
    from lesv_tpu_torch.pipeline import mapper

    monkeypatch.setenv("LESV_TORCH_HOST_SMALL", "0")
    rng = np.random.default_rng(12)
    genome = random_genome(rng, 300_000)
    store = SeqStore.from_records([("chr1", genome)])
    cfg = LesvConfig()
    cfg.map.batch_reads = 4
    index = KmerIndex.build(store, cfg.index)
    reads = []
    for i in range(12):
        st = int(rng.integers(0, 280_000))
        r = mutate_read(rng, genome[st : st + int(rng.integers(2_000,
                                                               15_000))],
                        err=0.1)
        reads.append((f"r{i}", r))
    # a 1.6 kb stretch at 35% error: one segment of the Q=2048 bucket,
    # outside the int16 gate, so the int32 fill launches too
    st = 100_000
    reads.append(("noisy_mid", np.concatenate([
        mutate_read(rng, genome[st : st + 5_000], err=0.1),
        mutate_read(rng, genome[st + 5_000 : st + 6_600], err=0.35),
        mutate_read(rng, genome[st + 6_600 : st + 12_000], err=0.1)])))
    assert mapper._map_overlap_depth(dev) == 2
    _reset_counts()
    got, _ = mapper.map_all(reads, store, index, cfg, device=dev)
    torch.cuda.synchronize()
    pooled = _counts()
    _serial_workers(monkeypatch)
    _reset_counts()
    want, _ = mapper.map_all(reads, store, index, cfg, device=dev)
    assert [_m4_key(m) for m in got] == [_m4_key(m) for m in want]
    assert pooled == _counts()
    assert all(v > 0 for v in pooled[0].values()), pooled[0]


def test_pooled_align_pairs_equals_serial(dev, monkeypatch):
    """align_pairs on the card with 8 dispatch workers, a monster chunk on
    the host pool and a band escape, global and free-end: the same
    Alignments, fills, launches and shapes as the serial arm, and the same
    Alignments as on CPU tensors."""
    from lesv_tpu_torch.ops import align_batch
    from torch_cases import MONSTER_DIRS_BYTES, align_pairs_world

    pairs = align_pairs_world(np.random.default_rng(31))
    monkeypatch.setattr(align_batch, "MONSTER_DIRS_BYTES", MONSTER_DIRS_BYTES)
    # the CPU arm routes nothing to the host: neither does the card here
    # (test_routed_align_pairs_on_the_card holds the routing)
    monkeypatch.setenv("LESV_TORCH_HOST_SMALL", "0")
    cfg = AlignConfig()
    aln = lambda a: None if a is None else (a.qb, a.qe, a.sb, a.se, a.score,
                                             a.ops.tobytes())
    for free_end in (False, True):
        assert align_batch._n_dispatch_workers(dev) == 8
        with monkeypatch.context() as mp:
            arms = []
            for serial in (False, True):
                if serial:
                    mp.setattr(align_batch, "_n_dispatch_workers",
                               lambda d: 1)
                _reset_counts()
                out = align_batch.align_pairs(pairs, cfg, free_end=free_end,
                                              device=dev)
                arms.append(([aln(a) for a in out], _counts()))
        assert arms[0] == arms[1]
        assert arms[0][1][2]["host_fills"] >= 5
        on_cpu = align_batch.align_pairs(pairs, cfg, free_end=free_end,
                                         device="cpu")
        assert arms[0][0] == [aln(a) for a in on_cpu]


def test_seed_budget_retry_on_the_card_equals_cpu(dev, monkeypatch):
    """The card-only retry of reads over the seed-match budget M at 2M:
    with M set so that some reads overflow M but not 2M and some overflow
    2M (among them a read of a tandem array), ``map_batch`` on the card,
    serial and with 8 dispatch workers, equals ``map_batch`` on the CPU,
    where every overflowing read goes straight to the host oracle."""
    from lesv_tpu_torch.ops import align_batch
    from lesv_tpu_torch.ops.seeding_torch import seed_matches_batch
    from lesv_tpu_torch.pipeline import mapper
    from lesv_tpu_torch.sim import repeat_genome

    rng = np.random.default_rng(8)
    genome, trf = repeat_genome(rng, 200_000, n_tandem=3,
                                array_range=(4_000, 6_000), n_dups=2)
    store = SeqStore.from_records([("chr1", genome)])
    cfg = LesvConfig()
    index = KmerIndex.build(store, cfg.index)
    batch = []
    for i in range(14):
        st = int(rng.integers(0, 185_000))
        n = int(rng.integers(1_500, 14_000))
        batch.append((i, mutate_read(rng, genome[st : st + n], err=0.1)))
    a, b = trf[0]
    batch.append((14, mutate_read(rng, genome[a:b], err=0.05)))
    reads = [r for _, r in batch]
    _, _, _, total = seed_matches_batch(reads, index, cfg.seeding,
                                        M=1 << 17, device="cpu")
    per_read = total.numpy()[: 2 * len(reads)].reshape(-1, 2).max(axis=1)
    M = int(np.sort(per_read)[len(reads) // 2])
    assert ((per_read > M) & (per_read <= 2 * M)).sum() >= 2
    assert (per_read > 2 * M).sum() >= 2
    assert per_read[14] > 2 * M
    cfg.map.seed_match_budget = M

    budgets = []
    chunk = mapper._seed_chain_chunk

    def spy(reads, index, cfg, M, Qmax, device):
        budgets.append(M)
        return chunk(reads, index, cfg, M, Qmax, device)

    monkeypatch.setattr(mapper, "_seed_chain_chunk", spy)
    want = [_m4_key(m) for m in mapper.map_batch(batch, store, index, cfg,
                                                  device="cpu")]
    assert 2 * M not in budgets
    assert len(want) > 0
    for workers in (8, 1):
        monkeypatch.setattr(align_batch, "_n_dispatch_workers",
                            lambda d, n=workers: n)
        budgets.clear()
        got = mapper.map_batch(batch, store, index, cfg, device=dev)
        assert 2 * M in budgets
        assert [_m4_key(m) for m in got] == want


def test_wide_fills_from_many_threads_at_once(dev):
    """The wide fill design (W above 2,048) raises its kernel's
    shared-memory cap to each launch's size.  Eight threads launching it
    at once at two widths (int32 state, one kernel, two cap values) all
    launch, and every result equals the one-thread result."""
    import concurrent.futures as cf

    rng = np.random.default_rng(21)
    cfg = AlignConfig()
    cases = []
    for W in (2049, 4096):
        t = tuple(torch.from_numpy(a).to(dev)
                  for a in _fill_batch(rng, W, "full", B=4, lo=300, hi=700))
        want = align_torch.banded_fill(*t, W, "full", cfg, force_i16=False)
        cases.append((t, W, want))

    def work(i):
        outs = []
        for k in range(16):
            t, W, _ = cases[(i + k) % 2]
            outs.append(((i + k) % 2, align_torch.banded_fill(
                *t, W, "full", cfg, force_i16=False)))
        torch.cuda.synchronize()
        return outs

    with cf.ThreadPoolExecutor(8) as pool:
        runs = list(pool.map(work, range(8)))
    for outs in runs:
        for c, got in outs:
            _outputs_equal(got, cases[c][2], cases[c][0][2])


def _aln_norm(a):
    """An Alignment as a key, a zero-score empty one read as None: the
    device path and the host engine give the two forms for a lane with
    nothing to align, and every caller treats them alike."""
    if a is None or (len(a.ops) == 0 and a.score <= 0):
        return None
    return (a.qb, a.qe, a.sb, a.se, a.score, a.ops.tobytes())


@pytest.mark.parametrize("free_end", [False, True])
def test_routed_align_pairs_on_the_card(dev, monkeypatch, free_end):
    """On the card, where routing is on by default: ``align_pairs`` routes
    pairs to the host (``FILL_STATS["host_routed"]``) while the large
    buckets still launch a fill kernel, and equals routing off up to the
    form of an empty alignment.  With the cost model kept from routing
    chunks (an infinitely slow host), the plan is the CPU's under
    ``LESV_TORCH_HOST_SMALL=1``, and the two are equal exactly."""
    from lesv_tpu_torch.ops import align_batch
    from torch_cases import align_pairs_world

    pairs = align_pairs_world(np.random.default_rng(31))
    cfg = AlignConfig()
    assert align_batch.host_small_on(dev)
    _reset_counts()
    on = align_batch.align_pairs(pairs, cfg, free_end=free_end, device=dev)
    launches, _, stats = _counts()
    assert stats["host_routed"] > 0
    assert launches["fill"] + launches["fill_i16"] > 0
    assert launches["traceback"] > 0
    monkeypatch.setenv("LESV_TORCH_HOST_SMALL", "0")
    off = align_batch.align_pairs(pairs, cfg, free_end=free_end, device=dev)
    assert [_aln_norm(a) for a in on] == [_aln_norm(a) for a in off]

    monkeypatch.setenv("LESV_TORCH_HOST_SMALL", "1")
    monkeypatch.setenv("LESV_TORCH_HOST_CELL_RATE", "1e-9")
    _reset_counts()
    got = align_batch.align_pairs(pairs, cfg, free_end=free_end, device=dev)
    assert _counts()[2]["chunks_to_host"] == 0
    want = align_batch.align_pairs(pairs, cfg, free_end=free_end,
                                   device="cpu")
    aln = lambda a: None if a is None else (a.qb, a.qe, a.sb, a.se, a.score,
                                             a.ops.tobytes())
    assert [aln(a) for a in got] == [aln(a) for a in want]


def test_round_robin_over_the_cards_equals_card_0(dev, monkeypatch):
    """On a host with several cards, ``LESV_TORCH_MESH=0``: ``align_pairs``
    and ``map_all`` on plain ``cuda`` deal their chunks to every card in
    turn and equal the same calls on ``cuda:0``.  Routing off, so that
    there are more device chunks than cards."""
    from lesv_tpu_torch.ops import align_batch
    from lesv_tpu_torch.pipeline import mapper
    from torch_cases import align_pairs_world

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    monkeypatch.setenv("LESV_TORCH_MESH", "0")
    monkeypatch.setenv("LESV_TORCH_HOST_SMALL", "0")
    sent = []
    dispatch = align_batch.banded_align_dispatch

    def spy(*a, device, **kw):
        sent.append(torch.device(device))
        return dispatch(*a, device=device, **kw)

    monkeypatch.setattr(align_batch, "banded_align_dispatch", spy)
    pairs = align_pairs_world(np.random.default_rng(31))
    cfg = AlignConfig()
    for free_end in (False, True):
        sent.clear()
        got = align_batch.align_pairs(pairs, cfg, free_end=free_end,
                                      device="cuda")
        assert {d.index for d in sent} == set(range(n))
        want = align_batch.align_pairs(pairs, cfg, free_end=free_end,
                                       device="cuda:0")
        assert [_aln_norm(a) for a in got] == [_aln_norm(a) for a in want]

    rng = np.random.default_rng(4)
    genome = random_genome(rng, 200_000)
    store = SeqStore.from_records([("chr1", genome)])
    lcfg = LesvConfig()
    index = KmerIndex.build(store, lcfg.index)
    reads = []
    for i in range(6):
        st = int(rng.integers(0, 180_000))
        reads.append((f"r{i}", mutate_read(rng, genome[st : st + 12_000],
                                           err=0.1)))
    sent.clear()
    got, _ = mapper.map_all(reads, store, index, lcfg, device="cuda")
    assert {d.index for d in sent} == set(range(n))
    want, _ = mapper.map_all(reads, store, index, lcfg, device="cuda:0")
    assert [_m4_key(m) for m in got] == [_m4_key(m) for m in want]


def test_routed_map_all_on_the_card(dev, monkeypatch):
    """``map_all`` on the card with routing on (the default), pooled and
    serial: the M4 records of routing off, and the same launches and fills
    in both arms; the routed fills are counted."""
    from lesv_tpu_torch.pipeline import mapper

    rng = np.random.default_rng(12)
    genome = random_genome(rng, 300_000)
    store = SeqStore.from_records([("chr1", genome)])
    cfg = LesvConfig()
    cfg.map.batch_reads = 4
    index = KmerIndex.build(store, cfg.index)
    reads = []
    for i in range(12):
        st = int(rng.integers(0, 280_000))
        r = mutate_read(rng, genome[st : st + int(rng.integers(2_000,
                                                               15_000))],
                        err=0.1)
        reads.append((f"r{i}", r))
    monkeypatch.setenv("LESV_TORCH_HOST_SMALL", "0")
    want, _ = mapper.map_all(reads, store, index, cfg, device=dev)
    monkeypatch.delenv("LESV_TORCH_HOST_SMALL")
    arms = []
    for serial in (False, True):
        if serial:
            _serial_workers(monkeypatch)
        _reset_counts()
        got, _ = mapper.map_all(reads, store, index, cfg, device=dev)
        torch.cuda.synchronize()
        assert [_m4_key(m) for m in got] == [_m4_key(m) for m in want]
        arms.append(_counts())
    assert arms[0] == arms[1]
    assert arms[0][2]["host_routed"] > 0
    assert arms[0][0]["chain"] > 0


def _budget_world():
    """The world of test_seed_budget_retry_on_the_card_equals_cpu: a
    200 kb genome with tandem arrays, 15 reads, and a seed budget M that
    some reads overflow at M but not 2M and some at 2M."""
    from lesv_tpu_torch.ops.seeding_torch import seed_matches_batch
    from lesv_tpu_torch.sim import repeat_genome

    rng = np.random.default_rng(8)
    genome, trf = repeat_genome(rng, 200_000, n_tandem=3,
                                array_range=(4_000, 6_000), n_dups=2)
    store = SeqStore.from_records([("chr1", genome)])
    cfg = LesvConfig()
    index = KmerIndex.build(store, cfg.index)
    batch = []
    for i in range(14):
        st = int(rng.integers(0, 185_000))
        n = int(rng.integers(1_500, 14_000))
        batch.append((i, mutate_read(rng, genome[st : st + n], err=0.1)))
    a, b = trf[0]
    batch.append((14, mutate_read(rng, genome[a:b], err=0.05)))
    _, _, _, total = seed_matches_batch([r for _, r in batch], index,
                                        cfg.seeding, M=1 << 17, device="cpu")
    per_read = total.numpy()[: 2 * len(batch)].reshape(-1, 2).max(axis=1)
    cfg.map.seed_match_budget = int(np.sort(per_read)[len(batch) // 2])
    return genome, store, index, cfg, batch


def _chains_key(by_read):
    return [{d: [(c.score, c.qbeg, c.qend, c.sbeg, c.send,
                  c.anchors.tobytes()) for c in cs] for d, cs in r.items()}
            for r in by_read]


def _full_fetch(qoff, soff, valid, total, M, length, cfg, J=64, q16=False,
                s16=False):
    """``chain_lanes_sliced``'s arguments, chained at the same live slots
    but fetched in full (``chain_lanes``)."""
    return chain_torch.chain_lanes(qoff, soff, valid, length, cfg, J=J,
                                   Mp=chain_torch._shrink_M(total, M))


def test_sliced_read_chains_on_the_card_equal_cpu(dev, monkeypatch):
    """On the card read seeding and chaining (at M and at 2M in the retry)
    fetch through ``fetch_chain_sliced``; their chains equal the CPU's and
    the full fetch's on the card, and ``map_batch`` with 8 dispatch
    workers gives the same records with either fetch."""
    from lesv_tpu_torch.ops import align_batch
    from lesv_tpu_torch.pipeline import mapper

    _, store, index, cfg, batch = _budget_world()
    M = cfg.map.seed_match_budget
    budgets = []
    chunk = mapper._seed_chain_chunk

    def spy(reads, index, cfg, M, Qmax, device):
        budgets.append(M)
        return chunk(reads, index, cfg, M, Qmax, device)

    monkeypatch.setattr(mapper, "_seed_chain_chunk", spy)
    got = _chains_key(mapper._chains_by_read_device(batch, index, cfg, dev))
    assert M in budgets and 2 * M in budgets
    want = _chains_key(mapper._chains_by_read_device(batch, index, cfg,
                                                     "cpu"))
    assert got == want
    assert align_batch._n_dispatch_workers(dev) == 8
    sliced = [_m4_key(m) for m in mapper.map_batch(batch, store, index, cfg,
                                                    device=dev)]
    monkeypatch.setattr(mapper, "chain_lanes_sliced", _full_fetch)
    assert _chains_key(mapper._chains_by_read_device(batch, index, cfg,
                                                     dev)) == want
    assert [_m4_key(m) for m in mapper.map_batch(batch, store, index, cfg,
                                                  device=dev)] == sliced


def test_sliced_pair_chains_on_the_card_equal_cpu(dev, monkeypatch):
    """``batch_pair_chains`` on the card, 8 dispatch workers, routing off,
    a pair budget that some pairs overflow: the sliced fetch (16-bit
    offsets) gives the chains of the CPU and of the full fetch."""
    from lesv_tpu_torch.pipeline import batch_align

    genome, _, _, cfg, batch = _budget_world()
    rng = np.random.default_rng(9)
    pairs = []
    for _, read in batch:
        a = int(rng.integers(0, len(genome) - 20_000))
        pairs.append((read, genome[a : a + len(read) + 3_000]))
        pairs.append((read[: len(read) // 2], read[len(read) // 4 :]))
    cfg.map.pair_match_budget = 2_048
    monkeypatch.setenv("LESV_TORCH_HOST_SMALL", "0")
    key = lambda out: [[(c.score, c.qbeg, c.qend, c.sbeg, c.send,
                         c.anchors.tobytes()) for c in cs] for cs in out]
    got = key(batch_align.batch_pair_chains(pairs, cfg, device=dev))
    want = key(batch_align.batch_pair_chains(pairs, cfg, device="cpu"))
    assert got == want and sum(1 for cs in got if cs) >= 10
    monkeypatch.setattr(batch_align, "chain_lanes_sliced", _full_fetch)
    assert key(batch_align.batch_pair_chains(pairs, cfg, device=dev)) == want


@pytest.mark.parametrize("q16,s16", [(True, False), (True, True),
                                     (False, False)])
def test_fetch_chain_sliced_on_the_card_equals_cpu(dev, q16, s16):
    """The sliced fetch's narrowing on the card (int32 -> int16 for 16-bit
    offsets, int64 -> int32 for subject offsets up to 2^32 - 2) keeps the
    low bits as on the CPU: every output equals the CPU's."""
    rng = np.random.default_rng(21)
    J, M = 64, 1025
    qoff, soff, valid = chain_edge_lanes(rng, J, M)
    if s16:
        soff = np.where(valid, soff - (0xFFFFFFFE - 60_000), soff)
    total = valid.sum(1)
    outs = []
    for d in (dev, "cpu"):
        f, p_rel, _, qs, ss, _ = chain_torch.sort_scan(
            *(torch.from_numpy(x).to(d) for x in (qoff, soff, valid)), J, 15,
            5000, 5000, 500)
        outs.append(chain_torch.fetch_chain_sliced(f, p_rel, qs, ss, total,
                                                   M, 1024, q16, s16))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_map_all_volumes_on_the_card_equals_cpu(dev, tmp_path):
    """The subject-volume loop on the card (5 chromosomes of 30 kb in 3
    volumes, 3 map batches a volume, two in flight) equals the CPU's, and
    so does its resume after one part file is removed.  Each volume's
    device index is freed once it is mapped: the bytes allocated after
    every volume are the same, and no more than before the call."""
    import os

    from lesv_tpu_torch.pipeline import mapper

    chroms, reads = volume_world(np.random.default_rng(11))
    store = SeqStore.from_records(chroms)
    cfg = LesvConfig()
    cfg.map.max_subject_vol_res = 65_000
    cfg.map.batch_reads = 3
    assert mapper._map_overlap_depth(dev) == 2
    want, _ = mapper.map_all_volumes(reads, store, cfg, device="cpu")
    ck = str(tmp_path / "parts")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    stats: list = []
    got, _ = mapper.map_all_volumes(reads, store, cfg, ckpt_dir=ck,
                                    device=dev, volume_stats=stats)
    assert [_m4_key(m) for m in got] == [_m4_key(m) for m in want]
    assert len(stats) == 3 and all(s["index_device_bytes"] > 0
                                   for s in stats)
    after = [s["device_allocated_after"] for s in stats]
    assert after == [after[0]] * 3 and after[0] <= before, (before, after)
    parts = sorted(os.listdir(ck))
    assert sum(p.startswith("map_v001") for p in parts) == 3
    os.remove(os.path.join(ck, "map_v001_00001.npz"))
    again, _ = mapper.map_all_volumes(reads, store, cfg, ckpt_dir=ck,
                                      device=dev)
    assert [_m4_key(m) for m in again] == [_m4_key(m) for m in want]
    assert sorted(os.listdir(ck)) == parts


def test_shifted_index_on_the_card_equals_cpu(dev):
    """Seeds and sliced chains against an index whose subject offsets are
    moved up by 2,200,000,000: the card's equal the CPU's, and map_batch
    on the card gives the unshifted index's records."""
    from lesv_tpu_torch import convert
    from lesv_tpu_torch.ops.seeding_torch import seed_matches_batch
    from lesv_tpu_torch.pipeline import mapper

    chroms, reads = volume_world(np.random.default_rng(11))
    store = SeqStore.from_records(chroms)
    cfg = LesvConfig()
    index = KmerIndex.build(store, cfg.index)
    shifted = convert.kmer_index_from_arrays(
        *shifted_index_arrays(index, GENOME_SCALE_SHIFT))
    batch = [r for _, r in reads]
    M, k = 2048, index.k
    outs = []
    for d in (dev, "cpu"):
        q, s, v, t = seed_matches_batch(batch, shifted, cfg.seeding, M=M,
                                        device=d)
        lanes = chain_torch.chain_lanes_sliced(q, s, v, t.cpu().numpy(), M,
                                               k, cfg.chain)
        outs.append(([x.cpu() for x in (q, s, v, t)],
                     [[(c.score, c.qbeg, c.qend, c.sbeg, c.send,
                        c.anchors.tobytes()) for c in cs] for cs in lanes]))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)
    assert outs[0][1] == outs[1][1]
    assert int(outs[0][0][1][outs[0][0][2]].max()) > 2**31
    qb = list(enumerate(batch))
    got = mapper.map_batch(qb, store, shifted, cfg, device=dev)
    want = mapper.map_batch(qb, store, index, cfg, device="cpu")
    assert got and [_m4_key(m) for m in got] == [_m4_key(m) for m in want]


def test_pinned_f1_case_on_the_card_equals_lesv_tpu(dev, tmp_path,
                                                    monkeypatch):
    """``chip_smoke.py``'s pinned diploid case (a het DEL, a hom INS in a
    tandem array) through ``tools/torch_f1_eval.py`` on the card with
    routing off: the calls, their digest, ``eval`` and the bytes of
    ``calls.vcf`` equal the constants that tests/test_torch_tools_pinned.py
    holds to lesv_tpu's ``tools/f1_eval.py``; fill_i16, chain and traceback
    launch."""
    import argparse
    import hashlib
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(repo)
    monkeypatch.syspath_prepend(os.path.join(repo, "tools"))
    import chip_smoke
    import torch_f1_eval

    monkeypatch.setenv("LESV_TORCH_HOST_SMALL", "0")
    args = argparse.Namespace(**chip_smoke.PINNED_ARGS, out=str(tmp_path),
                              seeds=[chip_smoke.PINNED_SEED], device="cuda")
    rep = torch_f1_eval.run_case(chip_smoke.PINNED_SEED, args, LesvConfig())
    with open(tmp_path / f"seed{chip_smoke.PINNED_SEED}" / "calls.vcf",
              "rb") as fh:
        vcf = fh.read()
    assert rep["eval"] == chip_smoke.PINNED_EVAL
    assert rep["call_keys"] == chip_smoke.PINNED_CALLS
    assert rep["calls_digest"] == chip_smoke.PINNED_CALLS_DIGEST
    assert len(vcf) == chip_smoke.PINNED_VCF_BYTES
    assert hashlib.sha256(vcf).hexdigest() == chip_smoke.PINNED_VCF_SHA256
    assert all(rep["launches"][k] > 0
               for k in ("fill_i16", "chain", "traceback")), rep["launches"]


def _chip_smoke(monkeypatch):
    import os

    monkeypatch.syspath_prepend(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


def test_global_fallback_nw_on_the_card_equals_host(dev, monkeypatch):
    """The global fallback's whole-span NW on the card's fill and
    traceback kernels (``global_align_pairs_device``) against the native
    host NW and lesv_tpu's answers on spans of the evidence cells' size
    (``chip_smoke.nw_spans``): an 18 kb read across a 2.5 kb DEL (diag,
    W 8,192), 53 kb and 50 kb reads across 13 kb and 10 kb INS on 40 kb of
    subject (diag, W 32,768, one launch), an 8 kb read across an 8.4 kb DEL
    (full, W 16,385), in one call: identical Alignments, the digest that
    tests/test_torch_global_fallback.py holds lesv_tpu's
    ``global_align_pairs_host`` to, every pair solved on the card, the same
    cells."""
    from lesv_tpu_torch.ops import align_batch

    cs = _chip_smoke(monkeypatch)
    pairs = cs.nw_spans()
    assert cs.nw_digest(pairs) == cs.NW_SPANS_SHA256
    bands = [align_batch._nw_band0(len(q), len(s)) for q, s in pairs]
    assert bands == [8_192, 32_768, 32_768, 16_385]
    assert [W < len(s) + 1 for W, (_, s) in zip(bands, pairs)] == \
        [True, True, True, False]
    cfg = AlignConfig()
    _reset_counts()
    got = align_batch.global_align_pairs_device(pairs, cfg, dev)
    card = dict(align_batch.FILL_STATS)
    launches = dict(_ext.LAUNCHES)
    align_batch.reset_fill_stats()
    want = align_batch.global_align_pairs_host(pairs, cfg)
    host = dict(align_batch.FILL_STATS)
    for g, w in zip(got, want):
        assert w is not None and g is not None
        assert (g.qb, g.qe, g.sb, g.se, g.score) == \
            (w.qb, w.qe, w.sb, w.se, w.score)
        np.testing.assert_array_equal(g.ops, w.ops)
    assert cs.nw_digest(pairs, got) == cs.NW_ANSWERS_SHA256
    assert card["fallback_device_fills"] == 4
    assert card["fallback_device_cells"] == card["fallback_cells"] == \
        host["fallback_cells"] > 0
    assert launches["fill"] == launches["traceback"] == 3
    assert launches.get("fill_i16", 0) == 0


def test_global_fallback_nw_over_a_small_cap_on_the_card(dev, monkeypatch):
    """The card's NW with ``FALLBACK_DIRS_BYTES`` patched small: a pair
    whose own direction bytes pass the cap runs on the host NW (its native
    calls seen), a bucket of three lanes is cut into launches of one lane
    that wait on the byte budget in the stream pool, and every answer
    equals the host NW's."""
    from lesv_tpu_torch import native
    from lesv_tpu_torch.ops import align_batch

    rng = np.random.default_rng(151)
    pairs = []
    for n in (3_000, 3_100, 3_200, 6_000):
        s = rng.integers(0, 4, n).astype(np.uint8)
        pairs.append((mutate_read(rng, s, err=0.1), s))
    own = [(len(q) + 1) * align_batch._nw_band0(len(q), len(s))
           for q, s in pairs]
    assert max(own[:3]) < own[3]
    monkeypatch.setattr(align_batch, "FALLBACK_DIRS_BYTES", max(own[:3]))
    calls = []
    real = native.banded_align_one

    def seen(q, s, *a):
        calls.append(len(q))
        return real(q, s, *a)

    monkeypatch.setattr(native, "banded_align_one", seen)
    cfg = AlignConfig()
    _reset_counts()
    got = align_batch.global_align_pairs_device(pairs, cfg, dev)
    card = dict(align_batch.FILL_STATS)
    launches = dict(_ext.LAUNCHES)
    assert calls == [len(pairs[3][0])]
    monkeypatch.setattr(native, "banded_align_one", real)
    want = align_batch.global_align_pairs_host(pairs, cfg)
    for g, w in zip(got, want):
        assert w is not None and g is not None
        assert (g.qb, g.qe, g.sb, g.se, g.score) == \
            (w.qb, w.qe, w.sb, w.se, w.score)
        np.testing.assert_array_equal(g.ops, w.ops)
    assert card["fallback_device_fills"] == 3
    assert launches["fill"] + launches.get("fill_i16", 0) == 3
    assert launches["traceback"] == 3


def test_global_fallback_nw_split_over_clusters_on_the_card(dev,
                                                            monkeypatch):
    """The card's NW on ``chip_smoke.nw_spans`` (bands 8,192 and 32,768
    diag, 16,385 full, each launch's lanes split over a cluster by the
    rule) counts every cell as split (``fallback_split_cells``), and gives
    the host NW's answers and lesv_tpu's digest, as it does with every lane
    on one CTA (``cluster_split`` patched to 1; no split cell)."""
    from lesv_tpu_torch.ops import align_batch

    cs = _chip_smoke(monkeypatch)
    pairs = cs.nw_spans()
    cfg = AlignConfig()
    want = align_batch.global_align_pairs_host(pairs, cfg)
    splits = [align_torch.fill_split(B, W, dev)
              for B, W in ((1, 8_192), (2, 32_768), (1, 16_385))]
    assert min(splits) > 1, splits
    stats = []
    for one in (False, True):
        if one:
            monkeypatch.setattr(align_torch, "cluster_split",
                                lambda B, W, lim: 1)
        _reset_counts()
        got = align_batch.global_align_pairs_device(pairs, cfg, dev)
        stats.append(dict(align_batch.FILL_STATS))
        for g, w in zip(got, want):
            assert w is not None and g is not None
            assert (g.qb, g.qe, g.sb, g.se, g.score) == \
                (w.qb, w.qe, w.sb, w.se, w.score)
            np.testing.assert_array_equal(g.ops, w.ops)
        assert cs.nw_digest(pairs, got) == cs.NW_ANSWERS_SHA256
    split, one = stats
    assert split["fallback_split_cells"] == split["fallback_device_cells"] \
        == one["fallback_device_cells"] > 0
    assert one["fallback_split_cells"] == 0
