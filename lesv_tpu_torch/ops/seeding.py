"""Query-side seeding: sparse windowed k-mer sampling + index lookup.

Reproduces the reference word finder (`algo/hbn_word_finder.c`): only 300bp
of every 500bp of a query is seeded (kSeedingSeqSize=300 / stride 200),
k-mers taken every ``kmer_window`` bases within a window; matches against
the sorted k-mer index via merge join, skipping query k-mers whose index
occupancy exceeds ``max_query_kmer_occ``.

Host (numpy) oracle here; the jit/device version lives in
:mod:`lesv_tpu.ops.seeding_jax` and is tested against this one.
"""

from __future__ import annotations

import numpy as np

from lesv_tpu_torch.config import IndexConfig, SeedingConfig
from lesv_tpu_torch.index.kmer_index import KmerIndex, kmer_hashes
from lesv_tpu_torch.io.fasta import revcomp


def sampled_offsets(length: int, k: int, window: int,
                    cfg: SeedingConfig | None = None) -> np.ndarray:
    """Sampled k-mer start offsets for a read of ``length``.

    Pattern (reference `collect_ddfkmer_subseq`, `hbn_word_finder.c:185-216`):
    windows of SL=300 every SL+SR=500 bases; within window [s, min(s+300, n)),
    k-mers at s + i*window while s + i*window + k <= window end.

    ``window`` is the QUERY stride — the reference hardcodes it to 1
    (`hbn_align_one_volume.c:125-130`); only the subject index is
    sparsified by -kmer_window.
    """
    cfg = cfg or SeedingConfig()
    SL, SR = cfg.seeding_seq_size, cfg.seeding_seq_stride
    out = []
    s = 0
    n = length
    while s < n:
        e = min(s + SL, n)
        m = e - s
        if m >= k:
            cnt = (m - k) // window + 1
            out.append(s + np.arange(cnt, dtype=np.int64) * window)
        s = e + SR
    if not out:
        return np.empty(0, np.int64)
    return np.concatenate(out)


def collect_seed_matches(
    index: KmerIndex,
    codes: np.ndarray,
    cfg: SeedingConfig | None = None,
) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    """Seed matches of one query (both strands) against the index.

    Returns {dir: (qoff, global_soff)} with dir 0=FWD, 1=REV; qoff is the
    offset in the strand-oriented query (reference context convention:
    `hbn_word_finder.c:237-252`).  Query k-mers with more than
    ``max_query_kmer_occ`` index positions are skipped.
    """
    cfg = cfg or SeedingConfig()
    out: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    for d in (0, 1):
        q = codes if d == 0 else revcomp(codes)
        offs = sampled_offsets(len(q), index.k, cfg.query_stride, cfg)
        if len(offs) == 0:
            out[d] = (np.empty(0, np.int64), np.empty(0, np.int64))
            continue
        _, h_all = kmer_hashes(q, index.k, stride=1)
        h = np.where(offs < len(h_all), h_all[np.minimum(offs, len(h_all) - 1)], -1)
        found, start, count = index.lookup_np(h)
        found &= count <= cfg.max_query_kmer_occ
        idx = np.flatnonzero(found)
        if len(idx) == 0:
            out[d] = (np.empty(0, np.int64), np.empty(0, np.int64))
            continue
        qoffs = np.repeat(offs[idx], count[idx])
        pos_idx = _expand(start[idx], count[idx])
        soffs = index.positions[pos_idx].astype(np.int64)
        out[d] = (qoffs, soffs)
    return out


def _expand(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    out = np.ones(total, dtype=np.int64)
    heads = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    out[heads] = starts
    out[heads[1:]] -= starts[:-1] + counts[:-1] - 1
    return np.cumsum(out)
