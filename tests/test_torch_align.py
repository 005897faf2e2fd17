"""The port's banded alignment (plain fill + plain traceback on CPU
tensors) against lesv_tpu's XLA scan kernel and its Pallas kernel in
interpret mode: exact equality of scores, end cells, ok flags, op
strings and direction bytes on every live row."""

import numpy as np
import pytest
import torch

from lesv_tpu.config import AlignConfig
from lesv_tpu_torch.config import AlignConfig as PortAlignConfig
from lesv_tpu.ops import align_jax
from lesv_tpu.ops.align_pallas import pallas_banded_align_kernel
from lesv_tpu.sim import mutate_read
from lesv_tpu_torch.ops import align_torch

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
        q[i, : len(qi)] = qi
        s[i, : len(si)] = si
        qlen[i] = len(qi)
        slen[i] = len(si)
    return q, s, qlen, slen


def _pairs_w128(rng):
    pairs = []
    for k in range(8):
        n = int(rng.integers(40, 120))
        s = rng.integers(0, 4, n).astype(np.uint8)
        q = mutate_read(rng, s, err=0.15)
        if k == 3:  # truncated query: free_end stops early
            q = q[: len(q) // 2]
        pairs.append((q, s))
    return pairs


def _pairs_del(rng):
    pairs = []
    for _ in range(8):
        s = rng.integers(0, 4, 2100).astype(np.uint8)
        cut = int(rng.integers(30, 70))
        pairs.append((np.concatenate([s[:cut], s[cut + 2000 :]]), s))
    return pairs


def _pairs_odd(rng):
    pairs = []
    for _ in range(8):
        n = int(rng.integers(20, 64))
        s = rng.integers(0, 4, n).astype(np.uint8)
        pairs.append((mutate_read(rng, s, err=0.2)[:64], s))
    return pairs


def _pairs_short_lanes(rng, lo, hi, W):
    """Reads of lo to hi bases against their sources; lanes 0 and 1 have
    query lengths 0 and 1, lane 2 a subject shorter than W/2."""
    pairs = []
    for k in range(8):
        s = rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.uint8)
        q = mutate_read(rng, s, err=0.15)
        if k < 2:
            q = q[:k]
        if k == 2:
            s = s[: W // 3]
        pairs.append((q, s))
    return pairs


def _pairs_long(rng, lo, hi, err, cap=None):
    pairs = []
    for _ in range(8):
        s = rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.uint8)
        q = mutate_read(rng, s, err=err)
        pairs.append((q[:cap] if cap else q, s))
    return pairs


# (name, pair maker, W, mode, free_end, fixed (Qmax, Smax) or None,
#  also hold against the Pallas kernel in interpret mode)
CASES = [
    ("diag_w128", _pairs_w128, 128, "diag", False, None, True),
    ("diag_w128_free_end", _pairs_w128, 128, "diag", True, None, True),
    ("full_w128", _pairs_w128, 128, "full", False, None, True),
    ("full_w128_free_end", _pairs_w128, 128, "full", True, None, True),
    ("full_w4096_del", _pairs_del, 4096, "full", False, (128, 4096), False),
    ("full_w65_odd", _pairs_odd, 65, "full", False, (64, 64), True),
    ("full_w65_odd_free_end", _pairs_odd, 65, "full", True, (64, 64), True),
    ("diag_w33_short_lanes", lambda r: _pairs_short_lanes(r, 20, 90, 33),
     33, "diag", False, None, True),
    ("full_w33_short_lanes_free_end",
     lambda r: _pairs_short_lanes(r, 10, 32, 33), 33, "full", True,
     (40, 33), True),
    ("diag_w513_short_lanes", lambda r: _pairs_short_lanes(r, 150, 300, 513),
     513, "diag", False, None, True),
    ("full_w513_free_end", lambda r: _pairs_short_lanes(r, 200, 300, 513),
     513, "full", True, (320, 513), True),
    ("diag_w256_multi_row_tile",
     lambda r: _pairs_long(r, 1500, 2500, 0.12), 256, "diag", False, None,
     True),
    ("diag_w256_deep_scores",
     lambda r: _pairs_long(r, 900, 1024, 0.35, cap=1024), 256, "diag",
     False, None, False),
]


def _case(name):
    for c in CASES:
        if c[0] == name:
            return c
    raise KeyError(name)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_fill_and_traceback_match_jax(name):
    _, make, W, mode, free_end, shape, with_pallas = _case(name)
    rng = np.random.default_rng(7)
    cfg = AlignConfig()
    pairs = make(rng)
    if shape is None:
        shape = (max(len(q) for q, _ in pairs), max(len(s) for _, s in pairs))
    q, s, qlen, slen = _batch(pairs, *shape)

    got = align_torch.banded_align_batch(q, s, qlen, slen, W, mode,
                                         PortAlignConfig(),
                                         free_end=free_end, device="cpu")
    want = align_jax.banded_align_batch(q, s, qlen, slen, W, mode, cfg,
                                        free_end=free_end)
    for key in ("score", "ok", "qe", "se", "nops"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert want["ok"].any()
    for i in range(len(pairs)):
        np.testing.assert_array_equal(got["ops"][i][: got["nops"][i]],
                                      want["ops"][i][: want["nops"][i]])

    # direction bytes of every live row equal the XLA kernel's
    import jax.numpy as jnp

    jd, js_, jei, jeb, jok = align_jax.banded_align_kernel(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(qlen), jnp.asarray(slen),
        W, mode, cfg, free_end=free_end)
    td, ts, tei, teb, tok = align_torch.banded_align_kernel(
        torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(qlen),
        torch.from_numpy(slen), W, mode, PortAlignConfig(),
        free_end=free_end)
    jd = np.asarray(jd)
    for i in range(len(pairs)):
        np.testing.assert_array_equal(td[i, : qlen[i] + 1].numpy(),
                                      jd[i, : qlen[i] + 1])
    for a, b in ((ts, js_), (tei, jei), (teb, jeb), (tok, jok)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    if with_pallas:
        pd, ps, pei, peb, pok = pallas_banded_align_kernel(
            jnp.asarray(q), jnp.asarray(s), jnp.asarray(qlen),
            jnp.asarray(slen), W, mode, cfg, free_end=free_end,
            interpret=True, force_i16=False)
        for a, b in ((ts, ps), (tei, pei), (teb, peb), (tok, pok)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        pops, pn, preach = align_jax.traceback_batch(
            np.asarray(pd), np.asarray(pei), np.asarray(peb),
            np.asarray(pok), W, mode, layout="rwb")
        np.testing.assert_array_equal(got["ok"], np.asarray(pok) & preach)
        for i in range(len(pairs)):
            if got["ok"][i]:
                np.testing.assert_array_equal(
                    got["ops"][i][: got["nops"][i]], pops[i][: pn[i]])


@pytest.mark.parametrize("name", ["diag_w128", "full_w128_free_end",
                                  "full_w65_odd", "full_w4096_del",
                                  "diag_w256_multi_row_tile"])
def test_plain_traceback_matches_jax_traceback(name):
    """The plain traceback on the XLA kernel's direction bytes equals
    align_jax.traceback_batch on the same bytes (among them long runs of
    E steps along one row, full_w4096_del, and paths of thousands of
    steps, diag_w256_multi_row_tile)."""
    import jax.numpy as jnp

    _, make, W, mode, free_end, shape, _ = _case(name)
    rng = np.random.default_rng(5)
    cfg = AlignConfig()
    pairs = make(rng)
    if shape is None:
        shape = (max(len(q) for q, _ in pairs), max(len(s) for _, s in pairs))
    q, s, qlen, slen = _batch(pairs, *shape)
    d, _, ei, eb, ok = align_jax.banded_align_kernel(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(qlen), jnp.asarray(slen),
        W, mode, cfg, free_end=free_end)
    d, ei, eb, ok = map(np.asarray, (d, ei, eb, ok))
    wops, wn, wr = align_jax.traceback_batch(d, ei, eb, ok, W, mode,
                                             layout="lane")
    T = d.shape[1] + W + 2
    gops, gn, gr = align_torch.traceback_plain(
        torch.from_numpy(d.copy()), torch.from_numpy(ei.copy()),
        torch.from_numpy(eb.copy()),
        torch.from_numpy(ok.copy()), W, mode, T)
    np.testing.assert_array_equal(gr.numpy(), wr)
    np.testing.assert_array_equal(gn.numpy()[wr], wn[wr])
    assert wr.any()
    for i in np.flatnonzero(wr):
        np.testing.assert_array_equal(gops[i, : gn[i]].numpy(),
                                      wops[i, : wn[i]])
        assert (gops[i, gn[i]:] == align_torch.OP_PAD).all()


def test_dispatch_pads_dead_lanes():
    """Trailing lanes with qlen == 0 come back as failed, zero lanes."""
    rng = np.random.default_rng(1)
    pairs = _pairs_w128(rng)[:5]
    q, s, qlen, slen = _batch(pairs + [(np.zeros(0, np.uint8),) * 2] * 3,
                              128, 128)
    out = align_torch.banded_align_batch(q, s, qlen, slen, 128, "diag",
                                         device="cpu")
    assert not out["ok"][5:].any()
    assert (out["nops"][5:] == 0).all() and (out["ops"][5:] == 255).all()
    full = align_torch.banded_align_batch(q[:5], s[:5], qlen[:5], slen[:5],
                                          128, "diag", device="cpu")
    for key in ("score", "ok", "qe", "se", "nops"):
        np.testing.assert_array_equal(out[key][:5], full[key])


@pytest.mark.parametrize("free_end", [False, True])
def test_align_pairs_matches_jax(free_end):
    """The port's bucketed align_pairs against lesv_tpu's XLA path
    (_align_pairs_jax) on ragged pairs: equal Alignments, ops included."""
    from lesv_tpu.ops.align_batch import _align_pairs_jax
    from lesv_tpu_torch.ops import align_batch

    rng = np.random.default_rng(13)
    pairs = []
    for n in (30, 90, 200, 400):
        s = rng.integers(0, 4, n).astype(np.uint8)
        pairs.append((mutate_read(rng, s, err=0.1), s))
    s = rng.integers(0, 4, 400).astype(np.uint8)
    pairs.append((np.concatenate([s[:50], s[200:]]), s))  # 150 bp DEL
    pairs.append((np.zeros(0, np.uint8), s))              # empty: None
    cfg = AlignConfig()
    align_batch.reset_fill_stats()
    got = align_batch.align_pairs(pairs, PortAlignConfig(),
                                  free_end=free_end, device="cpu")
    want = _align_pairs_jax(pairs, cfg, free_end)
    assert got[-1] is None and want[-1] is None
    for g, w in zip(got[:-1], want[:-1]):
        assert w is not None and g is not None
        assert (g.qb, g.qe, g.sb, g.se, g.score) == \
               (w.qb, w.qe, w.sb, w.se, w.score)
        np.testing.assert_array_equal(g.ops, w.ops)
    st = align_batch.FILL_STATS
    assert st["device_fills"] == len(pairs) - 1
    assert st["device_cells"] > 0


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never fall back: CPU tensors are refused."""
    q = torch.zeros((1, 8), dtype=torch.uint8)
    ln = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        align_torch.fill_cuda(q, q, ln, ln, 8, "full", PortAlignConfig())
    with pytest.raises(ValueError):
        align_torch.traceback_cuda(torch.zeros((1, 9, 8), dtype=torch.uint8),
                                   ln, ln, ln.bool(), 8, "full", 20)
