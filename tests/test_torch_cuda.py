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
    pairs = []
    for _ in range(B):
        s = rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.uint8)
        pairs.append((mutate_read(rng, s, err=0.12)[:Q], s))
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


@pytest.mark.parametrize("W,mode,free_end", [
    (128, "diag", False), (256, "diag", True), (1024, "full", False),
    (65, "full", True), (8192, "full", False)])
def test_fill_and_traceback_kernels_equal_plain(dev, W, mode, free_end):
    rng = np.random.default_rng(W)
    cfg = AlignConfig()
    q, s, qlen, slen = (torch.from_numpy(a).to(dev)
                        for a in _fill_batch(rng, W, mode))
    kd, ks, kei, keb, kok = align_torch.fill_cuda(q, s, qlen, slen, W, mode,
                                                  cfg, free_end)
    pd, ps, pei, peb, pok = align_torch.banded_align_kernel(
        q, s, qlen, slen, W, mode, cfg, free_end)
    for a, b in ((ks, ps), (kei, pei), (keb, peb), (kok, pok)):
        assert torch.equal(a, b)
    live = (torch.arange(q.shape[1] + 1, device=dev)[None, :, None]
            <= qlen[:, None, None])
    assert not torch.where(live, kd != pd, False).any()
    T = q.shape[1] + 1 + W + 2
    kt = align_torch.traceback_cuda(kd, kei, keb, kok, W, mode, T)
    pt = align_torch.traceback_plain(kd, kei, keb, kok, W, mode, T)
    for a, b in zip(kt, pt):
        assert torch.equal(a, b)


@pytest.mark.parametrize("Q,W,mode,free_end,B", [
    (64, 65, "full", False, 128), (256, 512, "diag", False, 32),
    (256, 128, "diag", True, 32), (1024, 256, "diag", False, 16)])
def test_fill_i16_kernel_equals_plain_and_i32_kernel(dev, Q, W, mode,
                                                     free_end, B):
    """The int16 kernel: every live direction byte, score, end cell and
    ok equal its plain int16 version; score, end cell, ok and the ops of
    the traceback kernel equal the int32 kernel's."""
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


def test_map_on_cuda_equals_cpu(dev):
    """The map stage on the GPU (all four kernels) equals the same map
    stage on CPU tensors (all plain versions)."""
    from lesv_tpu_torch.pipeline.mapper import map_all

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
