"""The int16 fill of the port (plain PyTorch version on CPU tensors)
against lesv_tpu's Pallas kernel in interpret mode with ``force_i16=True``
and against the port's own int32 plain fill: exact equality of scores, end
cells, ok flags and op strings (no tolerance; direction bytes of cells the
traceback cannot visit may differ between the two state types and are not
compared).  Also the gate: the port's ``i16_ok`` equals ``_i16_ok`` over a
grid of (Qmax, W, costs), forcing int16 outside it raises, and the default
routing follows it."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lesv_tpu.config import AlignConfig as JaxAlignConfig
from lesv_tpu.ops import align_jax
from lesv_tpu.ops.align_pallas import _i16_ok, pallas_banded_align_kernel
from lesv_tpu.sim import mutate_read
from lesv_tpu_torch import convert
from lesv_tpu_torch.ops import align_batch, align_torch

# one intra-op thread: the suite runs several workers at once, and the
# small CPU tensor ops of the plain versions gain nothing from more
torch.set_num_threads(1)


def _batch(pairs, Qmax, Smax):
    B = len(pairs)
    q = np.zeros((B, Qmax), np.uint8)
    s = np.zeros((B, Smax), np.uint8)
    qlen = np.zeros(B, np.int32)
    slen = np.zeros(B, np.int32)
    for i, (qi, si) in enumerate(pairs):
        si = si[:Smax]
        q[i, : len(qi)] = qi
        s[i, : len(si)] = si
        qlen[i] = len(qi)
        slen[i] = len(si)
    return q, s, qlen, slen


def _pairs(rng, n, lo, hi, err, cap=None, trunc=None, short=False):
    pairs = []
    for k in range(n):
        s = rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.uint8)
        q = mutate_read(rng, s, err=err)
        if k == trunc:      # truncated query: free_end stops early
            q = q[: len(q) // 2]
        if short and k < 2:  # query lengths 0 and 1
            q = q[:k]
        pairs.append((q[:cap] if cap else q, s))
    return pairs


# name -> (pair maker, Qmax, Smax, W, mode, free_end): the bucket shapes
# the pipeline makes where the gate holds
CASES = {
    "full_q64_w65": (lambda r: _pairs(r, 8, 20, 64, 0.2, cap=64),
                     64, 64, 65, "full", False),
    "diag_q256_w512": (lambda r: _pairs(r, 8, 150, 256, 0.15, cap=256),
                       256, 256 + 512, 512, "diag", False),
    "diag_q256_w128_free_end": (
        lambda r: _pairs(r, 8, 200, 320, 0.12, cap=256, trunc=2),
        256, 256 + 128, 128, "diag", True),
    "full_q128_w128_free_end": (
        lambda r: _pairs(r, 8, 40, 120, 0.15, trunc=3),
        128, 128, 128, "full", True),
    # the edges of the CUDA kernel's designs: idle slots (W = 33), the
    # wide design past W = 512 with free_end, lanes of query length 0 / 1
    "diag_q96_w33_short_lanes": (
        lambda r: _pairs(r, 8, 20, 90, 0.12, cap=96, short=True),
        96, 96 + 33, 33, "diag", False),
    "full_q300_w513_free_end": (
        lambda r: _pairs(r, 8, 200, 300, 0.1, cap=300, trunc=2, short=True),
        300, 513, 513, "full", True),
    "full_q64_w65_free_end": (lambda r: _pairs(r, 8, 20, 64, 0.2, cap=64),
                              64, 64, 65, "full", True),
    "diag_q1024_w256_deep_scores": (
        lambda r: _pairs(r, 8, 900, 1024, 0.35, cap=1024),
        1024, 1024 + 256, 256, "diag", False),
}


def _torch_fill(q, s, qlen, slen, W, mode, cfg, free_end, i16):
    t = [torch.from_numpy(x) for x in (q, s, qlen, slen)]
    d, sc, ei, eb, ok = align_torch.banded_align_kernel(
        *t, W, mode, cfg, free_end=free_end, i16=i16)
    T = d.shape[1] + W + 2
    ops, n, reached = align_torch.traceback_plain(d, ei, eb, ok, W, mode, T)
    return dict(score=sc.numpy(), end_i=ei.numpy(), end_b=eb.numpy(),
                ok=ok.numpy(), ops=ops.numpy(), nops=n.numpy(),
                reached=reached.numpy())


@pytest.mark.parametrize("name", list(CASES))
def test_plain_i16_matches_pallas_i16_and_plain_i32(name):
    make, Qmax, Smax, W, mode, free_end = CASES[name]
    jcfg = JaxAlignConfig()
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg), "align")
    assert align_torch.i16_ok(Qmax, W, cfg)
    q, s, qlen, slen = _batch(make(np.random.default_rng(7)), Qmax, Smax)

    got = _torch_fill(q, s, qlen, slen, W, mode, cfg, free_end, i16=True)
    assert got["ok"].any() and got["score"].dtype == np.int32

    pd, ps, pei, peb, pok = pallas_banded_align_kernel(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(qlen), jnp.asarray(slen),
        W, mode, jcfg, free_end=free_end, interpret=True, force_i16=True)
    for key, want in (("score", ps), ("end_i", pei), ("end_b", peb),
                      ("ok", pok)):
        np.testing.assert_array_equal(got[key], np.asarray(want),
                                      err_msg=key)
    pops, pn, preach = align_jax.traceback_batch(
        np.asarray(pd), np.asarray(pei), np.asarray(peb), np.asarray(pok),
        W, mode, layout="rwb")
    np.testing.assert_array_equal(got["reached"], preach)
    for i in np.flatnonzero(preach):
        np.testing.assert_array_equal(got["ops"][i][: got["nops"][i]],
                                      pops[i][: pn[i]])

    i32 = _torch_fill(q, s, qlen, slen, W, mode, cfg, free_end, i16=False)
    for key in ("score", "end_i", "end_b", "ok", "reached"):
        np.testing.assert_array_equal(got[key], i32[key], err_msg=key)
    for i in np.flatnonzero(i32["reached"]):
        np.testing.assert_array_equal(got["ops"][i][: got["nops"][i]],
                                      i32["ops"][i][: i32["nops"][i]])


def test_i16_gate_equals_jax_gate():
    costs = [(2, 5, 5, 4, 56, 1), (1, 4, 6, 2, 24, 1), (2, 8, 12, 6, 80, 2),
             (3, 3, 4, 3, 30, 1)]
    n_true = n_false = 0
    for match, mism, go1, ge1, go2, ge2 in costs:
        cfg = convert.config_from_dict(
            dict(match=match, mismatch=mism, gap_open1=go1, gap_ext1=ge1,
                 gap_open2=go2, gap_ext2=ge2), "align")
        for Q in (16, 64, 256, 1024, 2048, 4096, 16384):
            for W in (64, 65, 128, 512, 1024, 4096):
                want = _i16_ok(Q, W, match, mism, go1, ge1, go2, ge2)
                assert align_torch.i16_ok(Q, W, cfg) == want, (Q, W, cfg)
                n_true += want
                n_false += not want
    assert n_true > 10 and n_false > 10
    # the default costs at the pipeline's inter-anchor segment buckets
    dflt = convert.config_from_dict({}, "align")
    assert align_torch.i16_ok(64, 65, dflt)
    assert align_torch.i16_ok(256, 512, dflt)
    assert not align_torch.i16_ok(4096, 512, dflt)


def test_force_i16_outside_the_gate_raises():
    cfg = convert.config_from_dict({}, "align")
    q = torch.zeros((2, 4096), dtype=torch.uint8)
    s = torch.zeros((2, 4096 + 512), dtype=torch.uint8)
    ln = torch.full((2,), 100, dtype=torch.int32)
    with pytest.raises(ValueError, match="i16_ok"):
        align_torch.banded_fill(q, s, ln, ln, 512, "diag", cfg,
                                force_i16=True)
    with pytest.raises(ValueError, match="i16_ok"):
        align_batch.align_pairs(
            [(np.zeros(3000, np.uint8), np.zeros(3000, np.uint8))], cfg,
            device="cpu", force_i16=True)
    # pinned to int32 the same bucket runs
    out = align_torch.banded_fill(q, s, ln, ln, 512, "diag", cfg,
                                  force_i16=False)
    assert bool(out[4].all())


@pytest.mark.parametrize("force,Q,want", [(None, 64, True),
                                          (None, 4096, False),
                                          (False, 64, False),
                                          (True, 64, True)])
def test_fill_routing_follows_the_gate(monkeypatch, force, Q, want):
    """On CPU tensors banded_fill hands the plain fill the state type the
    gate (or force_i16) selects."""
    seen = []
    plain = align_torch.banded_align_kernel

    def spy(*a, i16=False, **kw):
        seen.append(i16)
        return plain(*a, i16=i16, **kw)

    monkeypatch.setattr(align_torch, "banded_align_kernel", spy)
    cfg = convert.config_from_dict({}, "align")
    q = torch.zeros((1, Q), dtype=torch.uint8)
    s = torch.zeros((1, Q + 64), dtype=torch.uint8)
    ln = torch.full((1,), 20, dtype=torch.int32)
    align_torch.banded_fill(q, s, ln, ln, 64, "diag", cfg, force_i16=force)
    assert seen == [want]
