"""Traffic generator of the benchmark: a random reference made from the
seed, a diploid DEL/INS spectrum planted on it, and noisy long reads drawn
from the two haplotypes with their truth.

A frozen copy of the port's simulator (``lesv_tpu_torch/sim.py``: random
genome, ``plant_svs_diploid``'s spectrum, ``mutate_read``'s error model)
with three changes that genome scale and steady runs need:

* the genome is drawn on the device from the seed (one ``torch.Generator``,
  blocks of 256 MiB) and copied to the host;
* no haplotype is ever built whole: each read applies the SVs of its own
  haplotype to the reference stretch it covers, so the donor exists only
  where reads are drawn, and one seed always gives the same donor;
* read lengths are a fixed set of quantiles of a log-normal fitted to the
  configuration's mean and N50 (the length-weighted log-normal is
  log-normal with mu + sigma^2, so N50 = exp(mu + sigma^2) and
  mean = exp(mu + sigma^2 / 2): sigma^2 = 2 ln(N50 / mean)); the seed
  shuffles them, so every seed maps the same read lengths.

Reads longer than the split size are cut as lesv's ``split`` stage cuts
them (``SplitConfig``: 50 kb pieces, a last piece under 20 kb merged into
the one before), since the evidence path starts after that stage.

Imports nothing of the program: the harness hands the same arrays to the
program and to the checks in :mod:`benchmark.reference`.
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field
from statistics import NormalDist

import numpy as np

BLOCK = 1 << 28


def stream(seed: int, *tag: int) -> np.random.Generator:
    """An independent numpy stream of ``seed`` for one purpose ``tag``."""
    return np.random.default_rng([int(seed) % (1 << 64), *tag])


def torch_seed(seed: int, tag: int) -> int:
    return int(np.random.SeedSequence([int(seed) % (1 << 64), tag])
               .generate_state(1, np.uint64)[0] >> 1)


def genome(seed: int, total: int, device) -> np.ndarray:
    """``total`` random bases (codes 0..3) drawn on ``device`` from the
    seed, in blocks, into one host array."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, 1))
    out = np.empty(total, np.uint8)
    host = torch.from_numpy(out)
    for a in range(0, total, BLOCK):
        b = min(total, a + BLOCK)
        t = torch.randint(0, 4, (b - a,), generator=g, device=device,
                          dtype=torch.uint8)
        host[a:b].copy_(t)
    return out


def revcomp(codes: np.ndarray) -> np.ndarray:
    rc = codes[::-1]
    return np.where(rc < 4, 3 - rc, rc).astype(np.uint8)


@dataclass
class SV:
    kind: str          # "DEL" | "INS"
    chrom: int
    pos: int           # reference position on the chromosome
    length: int
    genotype: str      # "0/1" | "1/1"
    haps: tuple        # haplotypes (0, 1) that carry it
    ins_tag: int = 0   # stream tag of the inserted sequence

    def ins_seq(self, seed: int) -> np.ndarray:
        return stream(seed, 7, self.ins_tag).integers(
            0, 4, self.length).astype(np.uint8)


@dataclass
class Truth:
    """Per chromosome and haplotype the SVs it carries, sorted by pos."""

    svs: list[SV] = field(default_factory=list)
    by_hap: dict = field(default_factory=dict)   # (chrom, hap) -> [SV]

    def index(self) -> "Truth":
        self.svs.sort(key=lambda s: (s.chrom, s.pos))
        self.by_hap = {}
        for sv in self.svs:
            for h in sv.haps:
                self.by_hap.setdefault((sv.chrom, h), []).append(sv)
        self._pos = {k: [s.pos for s in v] for k, v in self.by_hap.items()}
        return self

    def on(self, chrom: int, hap: int) -> tuple[list[SV], list[int]]:
        key = (chrom, hap)
        return self.by_hap.get(key, []), self._pos.get(key, [])


def _haps(rng, genotype: str) -> tuple:
    if genotype == "1/1":
        return (0, 1)
    return (int(rng.integers(0, 2)),)


def _frac(i: int, alpha: float) -> float:
    """A fixed low-discrepancy sequence in [0, 1)."""
    return (0.5 + i * alpha) % 1.0


def plant_spectrum(seed: int, sizes: list[int], n_sv: int, min_len: int,
                   max_len: int, het_frac: float, cluster_frac: float,
                   margin: int, min_gap: int) -> Truth:
    """``plant_svs_diploid``'s spectrum over chromosomes of ``sizes``, with
    the sizes fixed and only the places drawn: by fixed low-discrepancy
    patterns over i, SV i is a DEL or an INS with even shares, its length
    evenly spread over the log-uniform [min_len, max_len], het for a
    ``het_frac`` share, and ``cluster_frac`` of them 2 to 5 kb after SV
    i - 1.  The seed draws each SV's chromosome (by length), position
    (``min_gap`` from the others, ``margin`` from the ends) and the
    haplotype of a het SV."""
    rng = stream(seed, 2)
    lo, hi = math.log(min_len), math.log(max_len)
    w = np.asarray(sizes, np.float64) / float(sum(sizes))
    occ: dict[int, list[tuple[int, int]]] = {c: [] for c in range(len(sizes))}
    planted: list[SV] = []

    def free(c: int, p: int, span: int, pad: int) -> bool:
        if p < margin or p + span > sizes[c] - margin:
            return False
        iv = occ[c]
        i = bisect.bisect_left(iv, (p, p + span))
        for a, b in iv[max(0, i - 1): i + 1]:
            if not (p + span + pad <= a or b + pad <= p):
                return False
        return True

    for i in range(n_sv):
        kind = "DEL" if _frac(i, 0.618034) < 0.5 else "INS"
        L = int(math.exp(lo + (hi - lo) * _frac(i, 0.754878)))
        span = L if kind == "DEL" else 0
        gt = "0/1" if _frac(i, 0.414214) < het_frac else "1/1"
        clustered = i > 0 and _frac(i, 0.318310) < cluster_frac
        for _ in range(1000):
            if clustered:
                prev = planted[-1]
                c = prev.chrom
                p = prev.pos + (prev.length if prev.kind == "DEL" else 0) + \
                    int(rng.integers(2_000, 5_000))
                if free(c, p, span, 2_000):
                    break
                clustered = False
            c = int(rng.choice(len(sizes), p=w))
            p = int(rng.integers(margin,
                                 max(margin + 1, sizes[c] - margin - span)))
            if free(c, p, span, min_gap):
                break
        else:
            raise ValueError("plant_spectrum: no room for the SVs")
        planted.append(SV(kind, c, p, L, gt, _haps(rng, gt), ins_tag=i))
        bisect.insort(occ[c], (p, p + span))
    return Truth(svs=planted).index()


def spectrum_loci(n: int, min_len: int, max_len: int) -> list[dict]:
    """``n`` SVs that stand for the planter's spectrum, one per stratum:
    lengths at the quantiles (j + 0.5) / n of the log-uniform [min_len,
    max_len], DEL and INS in turn, two het then two hom (the spectrum's
    even shares of kinds and genotypes)."""
    lo, hi = math.log(min_len), math.log(max_len)
    return [dict(kind=("DEL", "INS")[j % 2],
                 length=int(math.exp(lo + (hi - lo) * (j + 0.5) / n)),
                 genotype=("0/1", "1/1")[(j // 2) % 2]) for j in range(n)]


def plant_loci(seed: int, size: int, loci: list[dict], spacing: int,
               margin: int) -> Truth:
    """A fixed list of SVs (``loci``: kind, length, genotype, in this order)
    at random positions of one chromosome, ``spacing`` + the DEL span
    apart; the seed draws the positions and the haplotype of each het
    event, never the sizes.  ``SV.ins_tag`` is the locus' index."""
    rng = stream(seed, 3)
    svs: list[SV] = []
    taken: list[tuple[int, int]] = []
    for tag, spec in enumerate(loci):
        span = spec["length"] if spec["kind"] == "DEL" else 0
        for _ in range(10_000):
            p = int(rng.integers(margin, size - margin - span))
            if all(p + span + spacing <= a or b + spacing <= p
                   for a, b in taken):
                break
        else:
            raise ValueError("plant_loci: no room for the loci")
        taken.append((p, p + span))
        svs.append(SV(spec["kind"], 0, p, int(spec["length"]),
                      spec["genotype"], _haps(rng, spec["genotype"]),
                      ins_tag=tag))
    return Truth(svs=svs).index()


def lognormal_lengths(n: int, mean: float, n50: float, min_len: int,
                      max_len: int | None = None) -> np.ndarray:
    """The ``n`` quantiles (i + 0.5) / n of the log-normal with this mean
    and N50, clipped to [min_len, max_len]."""
    s2 = 2.0 * math.log(n50 / mean)
    mu = math.log(mean) - s2 / 2.0
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    L = np.exp(mu + math.sqrt(s2) * z).astype(np.int64)
    return np.clip(L, min_len, max_len if max_len else L.max())


def split_sizes(n: int, max_size: int, min_last: int) -> list[tuple[int, int]]:
    """lesv's ``split`` pieces of a read of ``n`` bases: [from, to)."""
    out = []
    frm = 0
    while frm < n:
        to = min(frm + max_size, n)
        if n - to < min_last:
            to = n
        out.append((frm, to))
        frm = to
    return out


def mutate(rng: np.random.Generator, seq: np.ndarray, err: float,
           split=(0.4, 0.3, 0.3)) -> tuple[np.ndarray, np.ndarray]:
    """``mutate_read``'s model, vectorised: each base is an error with
    probability ``err``, of which ``split`` are mismatches, insertions
    (the base and a random one after it) and deletions.  Returns the read
    and, for each source offset o in [0, len], the read offset it maps to."""
    n = len(seq)
    r = rng.random(n)
    p_mm, p_ins = err * split[0], err * split[1]
    mm = r < p_mm
    ins = (r >= p_mm) & (r < p_mm + p_ins)
    dele = (r >= p_mm + p_ins) & (r < err)
    base = seq.copy()
    base[mm] = (base[mm] + rng.integers(1, 4, int(mm.sum()))) % 4
    counts = np.ones(n, np.int64)
    counts[ins] = 2
    counts[dele] = 0
    out = np.repeat(base, counts)
    ends = np.cumsum(counts)
    pos = ends[ins] - 1
    out[pos] = rng.integers(0, 4, len(pos))
    offs = np.concatenate([[0], ends])
    return out.astype(np.uint8), offs


@dataclass
class Read:
    codes: np.ndarray
    chrom: int
    hap: int
    strand: int        # 0 forward, 1 reverse complement
    ref_from: int      # reference interval the raw read came from
    ref_to: int
    spans: list        # (sv index in truth.svs, kind, length) spanned


def hap_stretch(ref: np.ndarray, size: int, truth: Truth, chrom: int,
                hap: int, p: int, need: int, seed: int,
                sv_ids: dict[int, int]):
    """``need`` bases of haplotype ``hap`` from reference position ``p``
    on: (codes, reference end, events), where an event is (sv index, kind,
    length, offset of the event in the stretch)."""
    svs, pos = truth.on(chrom, hap)
    i = bisect.bisect_left(pos, p)
    if i > 0 and svs[i - 1].kind == "DEL" and \
            svs[i - 1].pos + svs[i - 1].length > p:
        p = svs[i - 1].pos + svs[i - 1].length
    pieces: list[np.ndarray] = []
    got = 0
    events = []
    while got < need and p < size:
        nxt = svs[i].pos if i < len(svs) else size
        take = min(nxt - p, need - got)
        if take > 0:
            pieces.append(ref[p: p + take])
            got += take
            p += take
        if got >= need or i >= len(svs) or p < nxt:
            break
        sv = svs[i]
        events.append((sv_ids[id(sv)], sv.kind, sv.length, got))
        if sv.kind == "DEL":
            p = sv.pos + sv.length
        else:
            ins = sv.ins_seq(seed)[: need - got]
            pieces.append(ins)
            got += len(ins)
        i += 1
    codes = np.concatenate(pieces) if pieces else np.empty(0, np.uint8)
    return codes, p, events


def draw_reads(seed: int, tag: int, ref: np.ndarray, starts: np.ndarray,
               truth: Truth, lengths: np.ndarray, err: float,
               max_piece: int, min_last: int, flank: int,
               region: tuple[int, int, int] | None = None,
               sv_reads: int = 0, hap0: int = 0) -> list[Read]:
    """Reads of the given raw ``lengths``, each with a haplotype and a
    strand drawn evenly, split as lesv's ``split`` stage does.  ``spans``
    lists the SVs a piece holds whole with ``flank`` bases on each side.

    With ``region`` = (chrom, lo, hi) the k-th of the sorted lengths lies
    inside that stretch at a fixed low-discrepancy fraction of the room
    left, on haplotype ``hap0`` for even k and the other one for odd k:
    every seed gives the same reads' lengths, places and haplotypes around
    the stretch, and only the strands and the errors differ.  Otherwise ``sv_reads`` of them cross the start of a planted
    SV of their haplotype and the rest lie at uniform positions (a
    chromosome drawn by its length) that cross no SV.  The SVs crossed are
    one per stratum of the planted lengths, the crossing reads take every
    k-th of the sorted ``lengths`` and start a fixed fraction of their
    length before their SV: with :func:`plant_spectrum`'s fixed sizes,
    every seed gives the same reads' lengths, the same SVs crossed and the
    same offsets, in another order and at other places.  ``tag`` makes
    each call's draw its own."""
    rng = stream(seed, 4, tag)
    sizes = np.diff(starts)
    w = sizes / sizes.sum()
    sv_ids = {id(s): k for k, s in enumerate(truth.svs)}
    lengths = np.sort(np.asarray(lengths, np.int64))
    jobs: list = []
    if region is None and sv_reads:
        step = len(lengths) / sv_reads
        pick = (np.arange(sv_reads) * step + step / 2).astype(np.int64)
        by_len = sorted(range(len(truth.svs)),
                        key=lambda k: (truth.svs[k].length, k))
        u = _frac(tag, 0.618034)
        for i, L in enumerate(lengths[pick]):
            sv = truth.svs[by_len[int((i + u) / sv_reads * len(by_len))]]
            jobs.append((int(L), sv, _frac(i + 7 * tag, 0.569840)))
        lengths = np.delete(lengths, pick)
    jobs += [(int(L), None, 0.0) for L in lengths]
    out: list[Read] = []
    for j in rng.permutation(len(jobs)):
        L, sv, f = jobs[j]
        strand = int(rng.integers(0, 2))
        for _ in range(100):
            hap = int(rng.integers(0, 2))
            if region is not None:
                c, lo, hi = region
                L = min(L, hi - lo)
                p = lo + int(_frac(int(j), 0.569840) * (hi - lo - L))
                hap = (int(j) + hap0) % 2
            elif sv is not None:
                c = sv.chrom
                if hap not in sv.haps:
                    hap = sv.haps[0]
                p = max(0, sv.pos - 1 - int(f * (L - 1)))
            else:
                c = int(rng.choice(len(sizes), p=w))
                # room past the read for the DELs it may cross
                p = int(rng.integers(0, max(1, int(sizes[c]) - L - L // 2)))
            src, pend, events = hap_stretch(
                ref[starts[c]: starts[c + 1]], int(sizes[c]), truth, c, hap,
                p, L, seed, sv_ids)
            if region is not None or sv is not None or not events:
                break
        codes, offs = mutate(rng, src, err)
        n = len(codes)
        ev = [(k, kind, ln, int(offs[o]),
               int(offs[min(len(src), o + (ln if kind == "INS" else 0))]))
              for k, kind, ln, o in events]
        if strand:
            codes = revcomp(codes)
            ev = [(k, kind, ln, n - b, n - a) for k, kind, ln, a, b in ev]
        for a, b in split_sizes(n, max_piece, min_last):
            spans = [(k, kind, ln) for k, kind, ln, x, y in ev
                     if x - a >= flank and b - y >= flank]
            out.append(Read(np.ascontiguousarray(codes[a:b]), c, hap, strand,
                            p, pend, spans))
    return out
