"""The port's seed sort, plain chain scan and chain extraction against
lesv_tpu's sort_seeds_device, XLA scan kernel, Pallas kernel (interpret
mode) and chain_lanes: exact equality."""

import numpy as np
import pytest
import torch

from lesv_tpu.config import ChainConfig
from lesv_tpu_torch.config import ChainConfig as PortChainConfig
from lesv_tpu_torch.ops import chain_torch
from torch_cases import chain_edge_lanes

# one intra-op thread: the suite runs several workers at once, and the
# small CPU tensor ops of the plain versions gain nothing from more
torch.set_num_threads(1)


def _genome_scale_seeds(seed, B=8, M=512):
    """Sorted-chain-like seeds with u32 subject offsets up to 3e9, 20%
    noise, given in random (unsorted) slot order."""
    rng = np.random.default_rng(seed)
    qoff = np.zeros((B, M), np.int32)
    soff = np.zeros((B, M), np.uint32)
    valid = np.zeros((B, M), bool)
    for b in range(B):
        n = int(rng.integers(40, M))
        base = rng.integers(0, 3_000_000_000, dtype=np.uint64)
        q = np.sort(rng.integers(0, 20_000, n)).astype(np.int32)
        s = (base + q.astype(np.uint64)
             + rng.integers(0, 1600, n).astype(np.uint64))
        noise = rng.random(n) < 0.2
        s[noise] = base + rng.integers(0, 40_000, int(noise.sum()))
        perm = rng.permutation(n)
        qoff[b, :n] = q[perm]
        soff[b, :n] = s.astype(np.uint32)[perm]
        valid[b, :n] = True
    return qoff, soff, valid


def _t(qoff, soff, valid):
    return (torch.from_numpy(qoff), torch.from_numpy(soff.astype(np.int64)),
            torch.from_numpy(valid))


@pytest.mark.parametrize("seed", [3, 4])
def test_sort_and_scan_match_jax(seed):
    import jax.numpy as jnp

    from lesv_tpu.ops.chain_jax import _chain_scan_kernel, sort_seeds_device
    from lesv_tpu.ops.chain_pallas import chain_scan_pallas

    qoff, soff, valid = _genome_scale_seeds(seed)
    qoff[:, 5] = qoff[:, 4]          # duplicate keys: the sort is stable
    soff[:, 5] = soff[:, 4]
    jq, js, jv = sort_seeds_device(jnp.asarray(qoff), jnp.asarray(soff),
                                   jnp.asarray(valid))
    tq, ts, tv = chain_torch.sort_seeds_device(*_t(qoff, soff, valid))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    args = dict(J=64, length=15, max_dq=5000, max_dr=5000, bw=1500)
    f1, p1, v1 = _chain_scan_kernel(jq, js, jv, **args)
    f2, p2, v2 = chain_scan_pallas(jq, js, jv, interpret=True, **args)
    tf, tp, tvv = chain_torch.chain_scan_plain(tq, ts, tv, **args)
    live = np.asarray(jv)
    for got, xla, pal in ((tf, f1, f2), (tp, p1, p2), (tvv, v1, v2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
        np.testing.assert_array_equal(got.numpy()[live],
                                      np.asarray(pal)[live])
    assert (tp.numpy() > 0).sum() > 100     # predecessors were taken


@pytest.mark.parametrize("J", [32, 64, 128])
def test_scan_edge_lanes_match_jax(J):
    """Lanes of 0, 1, J-1, J, J+1 and 150 valid seeds, subject offsets near
    2^32 - 2, tied predecessors: the sorts agree, and the plain scan equals
    the XLA scan kernel and the Pallas kernel (interpret mode) on every
    slot."""
    import jax.numpy as jnp

    from lesv_tpu.ops.chain_jax import _chain_scan_kernel, sort_seeds_device
    from lesv_tpu.ops.chain_pallas import chain_scan_pallas

    qoff, soff, valid = chain_edge_lanes(np.random.default_rng(J), J, 300)
    soff = soff.astype(np.uint32)
    jq, js, jv = sort_seeds_device(jnp.asarray(qoff), jnp.asarray(soff),
                                   jnp.asarray(valid))
    tq, ts, tv = chain_torch.sort_seeds_device(*_t(qoff, soff, valid))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    args = dict(J=J, length=15, max_dq=5000, max_dr=5000, bw=1500)
    got = chain_torch.chain_scan_plain(tq, ts, tv, **args)
    xla = _chain_scan_kernel(jq, js, jv, **args)
    pal = chain_scan_pallas(jq, js, jv, interpret=True, **args)
    for g, x, p in zip(got, xla, pal):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))
    assert (got[1].numpy() > 0).sum() > 2 * J


def _lanes_case():
    rng = np.random.default_rng(7)
    lanes_q, lanes_s = [], []
    for _ in range(6):
        n1 = int(rng.integers(5, 40))
        q1 = np.sort(rng.choice(3000, n1, replace=False)).astype(np.int64)
        s1 = q1 + 100 + rng.integers(-20, 20, n1)
        nz = int(rng.integers(0, 30))
        lanes_q.append(np.concatenate([q1, rng.integers(0, 3000, nz)]))
        lanes_s.append(np.concatenate([np.maximum(s1, 0),
                                       rng.integers(0, 100_000, nz)]))
    return lanes_q, lanes_s, 64


def _sv_join_case():
    q1 = np.arange(0, 2000, 40, dtype=np.int64)
    q2 = np.arange(2100, 4100, 40, dtype=np.int64)
    return ([np.concatenate([q1, q2])],
            [np.concatenate([q1 + 500, q2 + 5500])], 128)


@pytest.mark.parametrize("case", ["colinear_noise", "sv_spanning_join"])
def test_chain_lanes_match_jax(case):
    import jax.numpy as jnp

    from lesv_tpu.ops.chain_jax import chain_lanes

    lanes_q, lanes_s, M = (_lanes_case() if case == "colinear_noise"
                           else _sv_join_case())
    B = len(lanes_q)
    qoff = np.full((B, M), 0x7FFFFFFF, np.int32)
    soff = np.full((B, M), 0xFFFFFFFF, np.uint32)
    valid = np.zeros((B, M), bool)
    for b in range(B):
        n = len(lanes_q[b])
        qoff[b, :n] = lanes_q[b]
        soff[b, :n] = lanes_s[b]
        valid[b, :n] = True
    cfg = ChainConfig()
    want = chain_lanes(jnp.asarray(qoff), jnp.asarray(soff),
                       jnp.asarray(valid), 15, cfg, J=M)
    got = chain_torch.chain_lanes(*_t(qoff, soff, valid), 15,
                                  PortChainConfig(), J=M)
    assert sum(map(len, want)) > 0
    for gl, wl in zip(got, want):
        assert len(gl) == len(wl)
        for cg, cw in zip(gl, wl):
            assert (cg.score, cg.qbeg, cg.qend, cg.sbeg, cg.send) == \
                   (cw.score, cw.qbeg, cw.qend, cw.sbeg, cw.send)
            np.testing.assert_array_equal(cg.anchors, cw.anchors)
    if case == "sv_spanning_join":
        assert len(got[0]) == 1      # joined across the 5 kb deletion


def test_extract_chains_from_fp_matches_jax():
    """The re-homed host extraction equals lesv_tpu's on the same arrays."""
    import jax.numpy as jnp

    from lesv_tpu.ops.chain_jax import (
        chain_batch_device,
        extract_chains_from_fp,
    )

    qoff, soff, valid = _genome_scale_seeds(9, B=4, M=256)
    arrs = chain_batch_device(jnp.asarray(qoff), jnp.asarray(soff),
                              jnp.asarray(valid), 15, ChainConfig())
    n = 0
    for b in range(4):
        lane = [a[b] for a in arrs]
        want = extract_chains_from_fp(*lane, 15, ChainConfig())
        got = chain_torch.extract_chains_from_fp(*lane, 15,
                                                 PortChainConfig())
        assert [(c.score, c.qbeg, c.send) for c in got] == \
               [(c.score, c.qbeg, c.send) for c in want]
        n += len(got)
    assert n > 0


def test_chain_scan_cuda_refuses_bad_lookback():
    q = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        chain_torch.chain_scan_cuda(q, q.long(), q.bool(), J=48, length=15,
                                    max_dq=5000, max_dr=5000, bw=1500)
