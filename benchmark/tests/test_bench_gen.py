"""The traffic generator: one seed gives the same genome, SVs and reads;
the read lengths keep the configuration's mean and N50."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import gen

SIZES = [300_000, 200_000]


def _world(seed):
    starts = np.concatenate([[0], np.cumsum(SIZES)]).astype(np.int64)
    g = gen.genome(seed, int(starts[-1]), "cpu")
    truth = gen.plant_spectrum(seed, SIZES, 20, 40, 5000, 0.5, 0.1, 10_000,
                               8_000)
    L = gen.lognormal_lengths(30, 6000, 9000, 1000)
    reads = gen.draw_reads(seed, 0, g, starts, truth, L, 0.1, 50_000,
                           20_000, 1000)
    return g, truth, reads


@pytest.mark.parametrize("seed", [0, 2_200_000_123, 2**31 + 7])
def test_same_seed_same_world(seed):
    a, b = _world(seed), _world(seed)
    assert np.array_equal(a[0], b[0])
    assert [(s.kind, s.chrom, s.pos, s.length, s.haps) for s in a[1].svs] \
        == [(s.kind, s.chrom, s.pos, s.length, s.haps) for s in b[1].svs]
    assert len(a[2]) == len(b[2])
    for x, y in zip(a[2], b[2]):
        assert np.array_equal(x.codes, y.codes)
        assert (x.chrom, x.strand, x.ref_from, x.spans) == \
            (y.chrom, y.strand, y.ref_from, y.spans)


def test_seeds_differ_but_lengths_do_not():
    a, b = _world(1), _world(2)
    assert not np.array_equal(a[0], b[0])
    assert a[1].svs[0].pos != b[1].svs[0].pos
    L1 = gen.lognormal_lengths(1024, 12713, 18994, 1000)
    assert np.array_equal(L1, gen.lognormal_lengths(1024, 12713, 18994, 1000))


@pytest.mark.parametrize("mean,n50", [(12713, 18994), (16041, 23970)])
def test_length_fit_keeps_mean_and_n50(mean, n50):
    L = np.sort(gen.lognormal_lengths(4096, mean, n50, 1))[::-1]
    assert abs(L.mean() / mean - 1) < 0.03
    half = np.searchsorted(np.cumsum(L), L.sum() / 2)
    assert abs(L[half] / n50 - 1) < 0.03


def test_split_as_lesv():
    assert gen.split_sizes(40_000, 50_000, 20_000) == [(0, 40_000)]
    assert gen.split_sizes(60_000, 50_000, 20_000) == [(0, 60_000)]
    assert gen.split_sizes(75_000, 50_000, 20_000) == [(0, 50_000),
                                                       (50_000, 75_000)]


def test_reads_hold_their_svs():
    """A read that holds a planted SV whole carries it at its offset: the
    read without its errors equals the haplotype built around the SV."""
    rng = np.random.default_rng(0)
    seq = rng.integers(0, 4, 5000).astype(np.uint8)
    out, offs = gen.mutate(rng, seq, 0.0)
    assert np.array_equal(out, seq) and offs[-1] == 5000
    out, offs = gen.mutate(rng, seq, 0.1)
    assert len(offs) == 5001 and offs[-1] == len(out)
    assert abs(len(out) / 5000 - 1) < 0.05
    _, truth, reads = _world(5)
    held = [r for r in reads if r.spans]
    for r in held:
        for k, kind, ln in r.spans:
            sv = truth.svs[k]
            assert sv.kind == kind and sv.length == ln and r.hap in sv.haps


def test_spectrum_loci_stand_for_the_spectrum():
    loci = gen.spectrum_loci(4, 40, 30_000)
    assert [(x["kind"], x["length"], x["genotype"]) for x in loci] == [
        ("DEL", 91, "0/1"), ("INS", 478, "0/1"), ("DEL", 2505, "1/1"),
        ("INS", 13114, "1/1")]


@pytest.mark.parametrize("config,share", [("hg002_ont_45x", 0.0350),
                                          ("hg002_chr21", 0.0505)])
def test_sv_read_share_follows_the_config(config, share):
    from benchmark import harness
    from benchmark.drivers import evidence

    got = evidence.sv_read_share(harness.config_spec(config))
    assert got == pytest.approx(share, abs=5e-4)
