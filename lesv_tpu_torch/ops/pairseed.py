"""Dense pairwise seeding: all k-mer matches between two sequences.

Rebuild of the reference second-stage hit finder (`algo/init_hit_finder.c`):
query k-mers at stride ``q_stride`` (memsc_kmer_window=10), subject k-mers
at stride 1, matched by sorted-hash merge join with occupancy caps
(kMaxWordOcc = kMaxSeedOcc = 8, init_hit_finder.c:26-27), then chained with
the standard chain DP (min_cnt=1, min_score=30).

Used by: mapper window extension (replaces `memsc` re-seeding), consensus
read-vs-read overlap finding, SV-read realignment anchoring.
"""

from __future__ import annotations

import numpy as np

from lesv_tpu_torch.config import ChainConfig
from lesv_tpu_torch.index.kmer_index import kmer_hashes
from lesv_tpu_torch.ops.chain import Chain, extract_chains_np


def pair_seeds(
    q: np.ndarray,
    s: np.ndarray,
    k: int = 10,   # kDfltMemScKmerSize (cmdline_args.cpp:49)
    q_stride: int = 10,
    max_occ: int = 8,
) -> tuple[np.ndarray, np.ndarray]:
    """All (qoff, soff) k-mer matches between q (strided) and s (stride 1).

    A hash is skipped when its query-side or subject-side occupancy exceeds
    ``max_occ`` or the match product exceeds ``max_occ`` (reference
    s_collect_seeds, init_hit_finder.c:133-205).
    """
    qoffs, qh = kmer_hashes(q, k, stride=q_stride)
    soffs, sh = kmer_hashes(s, k, stride=1)
    qv = qh >= 0
    sv = sh >= 0
    qoffs, qh = qoffs[qv], qh[qv]
    soffs, sh = soffs[sv], sh[sv]
    if len(qh) == 0 or len(sh) == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    so_order = np.argsort(sh, kind="stable")
    sh_s, soffs_s = sh[so_order], soffs[so_order]
    # subject group bounds for each query kmer
    lo = np.searchsorted(sh_s, qh, side="left")
    hi = np.searchsorted(sh_s, qh, side="right")
    scount = hi - lo
    # query-side occupancy per hash
    qo_order = np.argsort(qh, kind="stable")
    qh_s = qh[qo_order]
    qlo = np.searchsorted(qh_s, qh, side="left")
    qhi = np.searchsorted(qh_s, qh, side="right")
    qcount = qhi - qlo
    ok = (scount > 0) & (qcount <= max_occ) & (scount <= max_occ) \
        & (scount * qcount <= max_occ)
    idx = np.flatnonzero(ok)
    if len(idx) == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    reps = scount[idx]
    qout = np.repeat(qoffs[idx], reps)
    pos_idx = _expand(lo[idx], reps)
    sout = soffs_s[pos_idx]
    return qout, sout


def _expand(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    out = np.ones(total, dtype=np.int64)
    heads = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    out[heads] = starts
    out[heads[1:]] -= starts[:-1] + counts[:-1] - 1
    return np.cumsum(out)


def mem_anchors(q: np.ndarray, s: np.ndarray, anchors: np.ndarray,
                k: int, mem_size: int = 15) -> np.ndarray:
    """Extend chain anchors to maximal exact runs and keep MEMs >=
    ``mem_size`` (the reference's `s_extract_mem`,
    `init_hit_finder.c:255-295`: only maximal matches >= memsc_mem_size
    anchor the traceback — raw k-mers only guide the chain).

    This is what keeps spurious k=10 matches (e.g. inside a long novel
    insertion) from forcing the alignment path through a wrong cell and
    fragmenting the SV gap run.  Returns (n, 3) runs (qoff, soff, len),
    ascending; falls back to the raw anchors when nothing survives (an
    alignment from weak anchors beats losing the read)."""
    a = np.asarray(anchors, np.int64)
    if a.size == 0:
        return np.empty((0, 3), np.int64)
    from lesv_tpu_torch import native

    qo, so, lens = native.extend_matches(q, s, k, a[:, 0], a[:, 1])
    keep = lens >= mem_size
    if not keep.any():
        return np.concatenate([a, np.full((len(a), 1), k, np.int64)],
                              axis=1)
    runs = np.stack([qo[keep], so[keep], lens[keep]], axis=1)
    return np.unique(runs, axis=0)   # row-sorted: ascending (qoff, soff)


def pair_chains(
    q: np.ndarray,
    s: np.ndarray,
    k: int = 10,   # kDfltMemScKmerSize (cmdline_args.cpp:49)
    q_stride: int = 10,
    max_occ: int = 8,
    min_score: int = 30,
    cfg: ChainConfig | None = None,
) -> list[Chain]:
    """Seed + chain a (query, subject) pair; returns score-sorted chains
    whose anchors are dense exact matches (every ~q_stride/err bases)."""
    cfg = cfg or ChainConfig()
    cfg = ChainConfig(**{**cfg.__dict__})
    cfg.min_seed_cnt = 1
    cfg.min_chain_score = min_score
    qo, so = pair_seeds(q, s, k=k, q_stride=q_stride, max_occ=max_occ)
    return extract_chains_np(qo, so, length=k, cfg=cfg)
