"""The whole-span NW of the global fallback on the torch device
(``align_batch.global_align_pairs_device``: bucketed fill and traceback,
here their plain versions on CPU tensors) against lesv_tpu's
``global_align_pairs_host`` and the port's own, pair for pair with exact
equality, its ``FILL_STATS`` counts, the dirs cap that sends a pair to the
host, and the routing of ``batch_align._apply_global_fallback`` by
device."""

import numpy as np
import pytest
import torch

from lesv_tpu.config import AlignConfig as JaxAlignConfig
from lesv_tpu.ops import align_batch as jax_align_batch
from lesv_tpu.sim import mutate_read
from lesv_tpu_torch import native
from lesv_tpu_torch.config import AlignConfig, LesvConfig
from lesv_tpu_torch.ops import align_batch
from lesv_tpu_torch.pipeline import batch_align

# one intra-op thread: the suite runs several workers at once, and the
# small CPU tensor ops of the plain versions gain nothing from more
torch.set_num_threads(1)


def _seq(rng, n):
    return rng.integers(0, 4, n).astype(np.uint8)


def _planted_del(rng):
    """A read across a 100 bp deletion: 250 + 250 bp of read on 600 bp of
    subject (full width: the first band passes ls + 1)."""
    a, d, b = _seq(rng, 250), _seq(rng, 100), _seq(rng, 250)
    return mutate_read(rng, np.concatenate([a, b]), err=0.1), \
        np.concatenate([a, d, b])


def _planted_ins(rng):
    """A read across a 120 bp insertion on 480 bp of subject."""
    a, i, b = _seq(rng, 230), _seq(rng, 120), _seq(rng, 250)
    return mutate_read(rng, np.concatenate([a, i, b]), err=0.1), \
        np.concatenate([a, b])


def _diag_pair(rng):
    """Query and subject of one length, 1,100 bp: the first band (1,024)
    is narrower than ls + 1, so the fill runs the diagonal band."""
    s = _seq(rng, 1_100)
    q = mutate_read(rng, s, err=0.1)
    q = np.concatenate([q, _seq(rng, len(s))])[: len(s)]
    return q, s


def _cases():
    rng = np.random.default_rng(15)
    return dict(dele=_planted_del(rng), ins=_planted_ins(rng),
                diag=_diag_pair(rng), twin=_planted_del(rng))


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g is not None
        assert (g.qb, g.qe, g.sb, g.se, g.score) == \
            (w.qb, w.qe, w.sb, w.se, w.score)
        np.testing.assert_array_equal(g.ops, w.ops)


def _cells(pairs, bands):
    """The NW's cells of each pair over the bands it ran."""
    return sum(align_batch._nw_cells(len(q), len(s), W)
               for (q, s), ws in zip(pairs, bands) for W in ws)


@pytest.mark.parametrize("name", ["dele", "ins", "diag"])
def test_one_span_equals_lesv_tpu(name):
    """A planted DEL, a planted INS (both at full width) and a span on the
    diagonal band: the same Alignment as lesv_tpu's host NW, and the
    counts of one card pair."""
    q, s = _cases()[name]
    W = align_batch._nw_band0(len(q), len(s))
    assert (W < len(s) + 1) == (name == "diag")
    align_batch.reset_fill_stats()
    got = align_batch.global_align_pairs_device([(q, s)], AlignConfig(),
                                                device="cpu")
    want = jax_align_batch.global_align_pairs_host([(q, s)],
                                                   JaxAlignConfig())
    _assert_same(got, want)
    st = align_batch.FILL_STATS
    cells = _cells([(q, s)], [[W]])
    assert st["fallback_device_fills"] == 1
    assert st["fallback_device_cells"] == st["fallback_cells"] == cells


def test_mixed_buckets_and_empty_spans_equal_lesv_tpu():
    """One call over pairs of several buckets (diag and full, two query
    sizes), lanes that share a bucket (two copies of one pair and another
    read across a DEL of the same subject length) and empty
    spans: pair for pair lesv_tpu's answers, the port's host NW's
    answers and cells."""
    c = _cases()
    q, s = c["dele"]
    pairs = [c["dele"], (q[:0], s), c["diag"], c["ins"], (q, s[:0]),
             c["twin"], c["twin"]]
    align_batch.reset_fill_stats()
    got = align_batch.global_align_pairs_device(pairs, AlignConfig(),
                                                device="cpu")
    dev_stats = dict(align_batch.FILL_STATS)
    want = jax_align_batch.global_align_pairs_host(pairs, JaxAlignConfig())
    _assert_same(got, want)
    assert got[1] is None and got[4] is None
    align_batch.reset_fill_stats()
    _assert_same(align_batch.global_align_pairs_host(pairs, AlignConfig()),
                 got)
    host_stats = dict(align_batch.FILL_STATS)
    assert dev_stats["fallback_device_fills"] == 5
    assert dev_stats["fallback_cells"] == host_stats["fallback_cells"] == \
        dev_stats["fallback_device_cells"] > 0
    assert host_stats["fallback_device_fills"] == 0
    assert host_stats["fallback_device_cells"] == 0


def test_band_escape_goes_again_at_twice_the_band(monkeypatch):
    """With a first band of a quarter of the usual, the planted DEL's
    end (100 bp off the diagonal) lies outside the band: the lane escapes
    in diag mode, goes again at twice the band, and the answers and cells
    of every attempt equal the port's host NW under the same band."""
    c = _cases()
    pairs = [c["dele"], c["diag"]]
    monkeypatch.setattr(align_batch, "_nw_band0",
                        lambda lq, ls: min(ls + 1, 128))
    calls = []
    real = native.banded_align_one

    def seen(q, s, W, mode_diag, *a):
        calls.append((len(q), W, mode_diag))
        return real(q, s, W, mode_diag, *a)

    monkeypatch.setattr(native, "banded_align_one", seen)
    align_batch.reset_fill_stats()
    want = align_batch.global_align_pairs_host(pairs, AlignConfig())
    host_cells = align_batch.FILL_STATS["fallback_cells"]
    (q, s) = pairs[0]
    assert [(W, d) for lq, W, d in calls if lq == len(q)] == \
        [(128, True), (256, True)]
    align_batch.reset_fill_stats()
    got = align_batch.global_align_pairs_device(pairs, AlignConfig(),
                                                device="cpu")
    _assert_same(got, want)
    assert all(a is not None for a in got)
    st = align_batch.FILL_STATS
    assert st["fallback_device_cells"] == st["fallback_cells"] == host_cells
    assert st["fallback_device_fills"] == 2


def test_a_pair_over_the_dirs_cap_runs_on_the_host(monkeypatch):
    """A pair whose own direction bytes pass the cap goes to the host NW
    (seen by its native calls); the others stay on the device, and the
    answers are the same."""
    c = _cases()
    pairs = [c["dele"], c["diag"], c["ins"]]
    q, s = c["diag"]
    big = (len(q) + 1) * \
        align_batch._nw_band0(len(q), len(s))
    monkeypatch.setattr(align_batch, "FALLBACK_DIRS_BYTES", big - 1)
    calls = []
    real = native.banded_align_one

    def seen(qq, ss, *a):
        calls.append(len(qq))
        return real(qq, ss, *a)

    monkeypatch.setattr(native, "banded_align_one", seen)
    align_batch.reset_fill_stats()
    got = align_batch.global_align_pairs_device(pairs, AlignConfig(),
                                                device="cpu")
    assert calls == [len(q)]
    st = dict(align_batch.FILL_STATS)
    monkeypatch.setattr(native, "banded_align_one", real)
    _assert_same(got, align_batch.global_align_pairs_host(pairs,
                                                          AlignConfig()))
    assert st["fallback_device_fills"] == 2
    on_card = _cells([pairs[0], pairs[2]],
                     [[align_batch._nw_band0(len(a), len(b))]
                      for a, b in (pairs[0], pairs[2])])
    assert st["fallback_device_cells"] == on_card
    assert st["fallback_cells"] == on_card + _cells(
        [pairs[1]], [[align_batch._nw_band0(len(q), len(s))]])


def test_apply_global_fallback_on_the_cpu_takes_the_host_path(monkeypatch):
    """On a CPU device ``_apply_global_fallback`` runs the host NW: the
    device routine is never called and ``fallback_device_*`` stay 0."""
    c = _cases()
    pairs = [c["dele"], c["ins"]]

    def refuse(*a, **kw):
        raise AssertionError("the device NW ran on a CPU device")

    monkeypatch.setattr(align_batch, "global_align_pairs_device", refuse)
    align_batch.reset_fill_stats()
    res = [None, None]
    batch_align._apply_global_fallback(pairs, res, LesvConfig(), "cpu")
    _assert_same(res, align_batch.global_align_pairs_host(
        pairs, AlignConfig()))
    st = align_batch.FILL_STATS
    assert st["fallback_fills"] == 2 and st["fallback_kept"] == 2
    assert st["fallback_cells"] > 0
    assert st["fallback_device_fills"] == 0
    assert st["fallback_device_cells"] == 0


def test_pooled_launches_under_the_dirs_budget_equal_serial(monkeypatch):
    """With four dispatch workers (the card's stream pool, here threads)
    and a budget that holds one launch at a time, every launch waits for
    the bytes of the one before: the answers and counts equal the serial
    loop's."""
    c = _cases()
    pairs = [c["dele"], c["diag"], c["ins"], c["twin"]]
    biggest = max((len(q) + 1) * align_batch._nw_band0(len(q), len(s))
                  for q, s in pairs)
    monkeypatch.setattr(align_batch, "FALLBACK_DIRS_BYTES", biggest)
    arms = []
    for workers in (1, 4):
        monkeypatch.setattr(align_batch, "_n_dispatch_workers",
                            lambda d, n=workers: n)
        align_batch.reset_fill_stats()
        got = align_batch.global_align_pairs_device(pairs, AlignConfig(),
                                                    device="cpu")
        arms.append((got, dict(align_batch.FILL_STATS)))
    _assert_same(arms[1][0], arms[0][0])
    assert arms[1][1] == arms[0][1]
    assert arms[0][1]["fallback_device_fills"] == len(pairs)


def test_chip_smoke_nw_spans_equal_lesv_tpu():
    """The spans on which ``chip_smoke.py`` and tests/test_torch_cuda.py
    hold the card's NW (``chip_smoke.nw_spans``: 18 to 53 kb reads, bands
    8,192 to 32,768, one at full width 16,385): their inputs and
    lesv_tpu's ``global_align_pairs_host`` answers have the digests the
    card is held to, and so have the port's host NW answers."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    pairs = chip_smoke.nw_spans()
    assert chip_smoke.nw_digest(pairs) == chip_smoke.NW_SPANS_SHA256
    want = jax_align_batch.global_align_pairs_host(pairs, JaxAlignConfig())
    assert chip_smoke.nw_digest(pairs, want) == \
        chip_smoke.NW_ANSWERS_SHA256
    got = align_batch.global_align_pairs_host(pairs, AlignConfig())
    _assert_same(got, want)


@pytest.mark.parametrize("split_from", [None, 1_000, 0])
def test_split_cells_counted_on_a_patched_card_path(monkeypatch, split_from):
    """``fallback_split_cells``: the cells of every launch for which
    ``fill_split`` gives a cluster of CTAs (patched as a card would: lanes
    at bands from ``split_from`` on split in two, none where it is None),
    every band attempt; ``fill_split`` asked once a launch, with its lanes
    and band; the answers and the other counts unchanged, and 0 split
    cells unpatched on the CPU."""
    c = _cases()
    pairs = [c["dele"], c["diag"], c["ins"], c["twin"]]
    cfg = AlignConfig()
    align_batch.reset_fill_stats()
    want = align_batch.global_align_pairs_device(pairs, cfg, device="cpu")
    plain = dict(align_batch.FILL_STATS)
    assert plain["fallback_split_cells"] == 0
    asked = []

    def split(B, W, device):
        asked.append((B, W))
        return 2 if split_from is not None and W >= split_from else 1

    launched = []
    real = align_batch._align_lanes

    def lanes(ps, idxs, Qm, Sm, W, *a, **kw):
        launched.append((list(idxs), W))
        return real(ps, idxs, Qm, Sm, W, *a, **kw)

    monkeypatch.setattr(align_batch, "fill_split", split)
    monkeypatch.setattr(align_batch, "_align_lanes", lanes)
    align_batch.reset_fill_stats()
    got = align_batch.global_align_pairs_device(pairs, cfg, device="cpu")
    st = dict(align_batch.FILL_STATS)
    _assert_same(got, want)
    assert sorted(asked) == sorted((len(i), W) for i, W in launched)
    split_cells = sum(
        align_batch._nw_cells(len(pairs[i][0]), len(pairs[i][1]), W)
        for idxs, W in launched for i in idxs
        if split_from is not None and W >= split_from)
    assert st.pop("fallback_split_cells") == split_cells
    plain.pop("fallback_split_cells")
    assert st == plain
    if split_from is None:
        assert split_cells == 0
    elif split_from == 0:
        assert split_cells == st["fallback_device_cells"] > 0
    else:
        assert 0 < split_cells < st["fallback_device_cells"]
