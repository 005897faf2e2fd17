"""Synthetic genome / SV / noisy-read simulator.

Used by tests and benches (the reference validates end-to-end against real
GIAB data, `install_lesv.md`; in this repo the CPU-runnable acceptance test
plants DEL/INS SVs in a random genome, simulates ONT-like noisy reads from
the donor haplotype, and checks the pipeline recovers the planted calls —
BASELINE.json config #1).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class PlantedSV:
    kind: str        # "DEL" | "INS"
    ref_pos: int     # position on the reference (post-normalized, 0-based)
    length: int
    seq: np.ndarray | None = None  # inserted sequence for INS
    genotype: str = "1/1"          # "1/1" hom | "0/1" het
    in_trf: bool = False           # planted inside a tandem-repeat array


@dataclass
class Truth:
    svs: list[PlantedSV] = field(default_factory=list)


def random_genome(rng: np.random.Generator, length: int) -> np.ndarray:
    return rng.integers(0, 4, length).astype(np.uint8)


def repeat_genome(
    rng: np.random.Generator,
    length: int,
    n_tandem: int = 6,
    unit_range: tuple[int, int] = (5, 200),
    array_range: tuple[int, int] = (500, 3_000),
    n_dups: int = 3,
    dup_range: tuple[int, int] = (2_000, 8_000),
    n_runs: int = 2,
    n_run_len: int = 300,
) -> tuple[np.ndarray, list[tuple[int, int]]]:
    """A repeat-rich genome: random background + tandem-repeat arrays +
    segmental duplications + N runs (code 4).

    The reference's occupancy caps / repeat-M4 removal / TRF masking
    exist for genomes like this (`trf_array.cpp:75-89`,
    `remove_repeat_m4s`).  Returns (genome, trf_intervals) where
    trf_intervals are the planted tandem arrays (a ready-made TRF bed).
    """
    g = random_genome(rng, length)
    trf: list[tuple[int, int]] = []
    for _ in range(n_tandem):
        unit_len = int(rng.integers(*unit_range))
        arr_len = int(rng.integers(*array_range))
        pos = int(rng.integers(0, length - arr_len))
        unit = rng.integers(0, 4, unit_len).astype(np.uint8)
        reps = -(-arr_len // unit_len)
        arr = np.tile(unit, reps)[:arr_len]
        # ~1% divergence between copies (real tandem arrays drift)
        mut = rng.random(arr_len) < 0.01
        arr[mut] = (arr[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        g[pos : pos + arr_len] = arr
        trf.append((pos, pos + arr_len))
    for _ in range(n_dups):
        dl = int(rng.integers(*dup_range))
        src = int(rng.integers(0, length - dl))
        dst = int(rng.integers(0, length - dl))
        g[dst : dst + dl] = g[src : src + dl]
    for _ in range(n_runs):
        pos = int(rng.integers(0, length - n_run_len))
        g[pos : pos + n_run_len] = 4          # ambiguous (N)
    return g, sorted(trf)


def plant_svs(
    rng: np.random.Generator,
    ref: np.ndarray,
    n_del: int = 3,
    n_ins: int = 3,
    min_len: int = 50,
    max_len: int = 500,
    margin: int = 5_000,
    min_gap: int = 8_000,
) -> tuple[np.ndarray, Truth]:
    """Plant homozygous DEL/INS into ``ref``; return (donor, truth).

    Positions are kept far apart and away from ends so events never overlap.
    """
    n = len(ref)
    k = n_del + n_ins
    # pick well-separated positions
    pos = []
    tries = 0
    while len(pos) < k and tries < 10_000:
        p = int(rng.integers(margin, n - margin))
        if all(abs(p - q) > min_gap + max_len for q in pos):
            pos.append(p)
        tries += 1
    assert len(pos) == k, "could not place SVs"
    pos.sort()
    kinds = ["DEL"] * n_del + ["INS"] * n_ins
    rng.shuffle(kinds)

    truth = Truth()
    pieces = []
    prev = 0
    for p, kind in zip(pos, kinds):
        L = int(rng.integers(min_len, max_len + 1))
        pieces.append(ref[prev:p])
        if kind == "DEL":
            truth.svs.append(PlantedSV("DEL", p, L))
            prev = p + L
        else:
            ins = rng.integers(0, 4, L).astype(np.uint8)
            truth.svs.append(PlantedSV("INS", p, L, seq=ins))
            pieces.append(ins)
            prev = p
    pieces.append(ref[prev:])
    donor = np.concatenate(pieces)
    return donor, truth


def _apply_svs(ref: np.ndarray, svs: list[PlantedSV]) -> np.ndarray:
    """Build a haplotype from ``ref`` and sorted non-overlapping SVs."""
    pieces = []
    prev = 0
    for sv in svs:
        pieces.append(ref[prev : sv.ref_pos])
        if sv.kind == "DEL":
            prev = sv.ref_pos + sv.length
        else:
            pieces.append(sv.seq)
            prev = sv.ref_pos
    pieces.append(ref[prev:])
    return np.concatenate(pieces)


def plant_svs_diploid(
    rng: np.random.Generator,
    ref: np.ndarray,
    n_sv: int = 40,
    min_len: int = 40,
    max_len: int = 30_000,
    het_frac: float = 0.5,
    trf_intervals: list[tuple[int, int]] | None = None,
    trf_frac: float = 0.0,
    cluster_frac: float = 0.1,
    margin: int = 20_000,
    min_gap: int = 8_000,
) -> tuple[np.ndarray, np.ndarray, Truth]:
    """Plant a het/hom DEL/INS spectrum on two haplotypes.

    The F1 measurement analogue of the reference's GIAB truth sets
    (`README.md:185-244`): lengths are log-uniform in [min_len, max_len],
    genotypes are het (one haplotype) with probability ``het_frac``,
    ``trf_frac`` of events land inside given tandem-repeat intervals, and
    ``cluster_frac`` of events get a nearby (~2-5kb) partner event.
    Returns (hap1, hap2, truth); truth SVs carry genotype + in_trf.
    """
    n = len(ref)
    lo, hi = np.log(min_len), np.log(max_len)

    def draw_len() -> int:
        return int(np.exp(rng.uniform(lo, hi)))

    # occupied reference intervals (pos, end) incl. DEL spans + padding
    occ: list[tuple[int, int]] = []

    def free(p: int, L: int, pad: int) -> bool:
        if p < margin or p + L > n - margin:
            return False
        return all(p + L + pad <= a or b + pad <= p for a, b in occ)

    planned: list[PlantedSV] = []
    trf_iv = [iv for iv in (trf_intervals or []) if iv[1] - iv[0] > 200]
    tries = 0
    while len(planned) < n_sv and tries < 100_000:
        tries += 1
        kind = "DEL" if rng.random() < 0.5 else "INS"
        L = draw_len()
        span = L if kind == "DEL" else 0
        in_trf = bool(trf_iv) and rng.random() < trf_frac
        if in_trf:
            a, b = trf_iv[int(rng.integers(len(trf_iv)))]
            if b - a <= span + 2:
                continue
            p = int(rng.integers(a, max(a + 1, b - span)))
        else:
            p = int(rng.integers(margin, n - margin - span))
        pad = min_gap if rng.random() >= cluster_frac or not planned else \
            int(rng.integers(2_000, 5_000))
        if pad < min_gap:
            # clustered partner: place near the most recent event
            prev = planned[-1]
            pspan = prev.length if prev.kind == "DEL" else 0
            p = prev.ref_pos + pspan + pad
            in_trf = any(a <= p < b for a, b in trf_iv)
        if not free(p, span, 2_000 if pad < min_gap else min_gap):
            continue
        seq = rng.integers(0, 4, L).astype(np.uint8) if kind == "INS" else None
        gt = "0/1" if rng.random() < het_frac else "1/1"
        planned.append(PlantedSV(kind, p, L, seq, gt, in_trf))
        occ.append((p, p + span))
    planned.sort(key=lambda s: s.ref_pos)
    truth = Truth(svs=planned)
    hap1_svs = [s for s in planned
                if s.genotype == "1/1" or rng.random() < 0.5]
    hap1_set = {id(s) for s in hap1_svs}
    hap2_svs = [s for s in planned
                if s.genotype == "1/1" or id(s) not in hap1_set]
    return _apply_svs(ref, hap1_svs), _apply_svs(ref, hap2_svs), truth


def mutate_read(rng: np.random.Generator, seq: np.ndarray,
                err: float = 0.1) -> np.ndarray:
    """Apply ONT-like noise: err split ~ 40% mismatch, 30% ins, 30% del."""
    if err <= 0:
        return seq.copy()
    n = len(seq)
    r = rng.random(n)
    out = []
    i = 0
    p_mm, p_ins = err * 0.4, err * 0.3
    # vectorized-ish: walk runs between events
    events = np.flatnonzero(r < err)
    prev = 0
    for i in events:
        out.append(seq[prev:i])
        u = r[i]
        if u < p_mm:  # mismatch
            out.append(np.array([(seq[i] + rng.integers(1, 4)) % 4], dtype=np.uint8))
        elif u < p_mm + p_ins:  # insertion (keep base + extra)
            out.append(np.array([seq[i], rng.integers(0, 4)], dtype=np.uint8))
        # else: deletion (skip base)
        prev = i + 1
    out.append(seq[prev:])
    return np.concatenate(out) if out else seq.copy()


def simulate_reads(
    rng: np.random.Generator,
    donor: np.ndarray,
    coverage: float = 20.0,
    mean_len: int = 12_000,
    min_len: int = 3_000,
    err: float = 0.1,
) -> list[tuple[str, np.ndarray]]:
    """Sample noisy reads uniformly from the donor, random strand."""
    from lesv_tpu_torch.io.fasta import revcomp

    n = len(donor)
    total = int(n * coverage)
    reads = []
    got = 0
    i = 0
    while got < total:
        L = max(min_len, int(rng.exponential(mean_len)))
        L = min(L, n)
        start = int(rng.integers(0, n - L + 1))
        frag = donor[start : start + L]
        read = mutate_read(rng, frag, err)
        if int(rng.integers(0, 2)):
            read = revcomp(read)
            name = f"sim{i}_rev_{start}_{start+L}"
        else:
            name = f"sim{i}_fwd_{start}_{start+L}"
        reads.append((name, read))
        got += L
        i += 1
    return reads
