"""Anchor chaining: minimap2-style chain DP + chain joining.

Behavioral contract from the reference (`algo/chain_dp.c`):

* scoring (`scoring_chain_seeds`, chain_dp.c:109-170): for seed i over
  predecessors j with ``soff[j] + max_dist_ref >= soff[i]``:
  ``dq = qoff[i]-qoff[j] > 0``, ``dr = soff[i]-soff[j] > 0``, both <= 5000,
  ``dd = |dr-dq| <= 1500``; score contribution
  ``min(dq, dr, len) - dd*0.01*avg_len - (log2(dd)>>1)`` (DDF stage).
  (The reference's max_skip=25 early-break pruning is a speed heuristic and
  is intentionally not reproduced; omitting it only adds chains.)
* candidate extraction (`chaining_find_candidates`, :273-395): chain ends are
  seeds that are nobody's best predecessor; peaks resolved via the
  ``v`` running-max; chains claimed greedily best-score-first over unused
  seeds, min seed count / min score filters, containment dedup (eps 100),
  at most 40 chains.
* joining (`join_adjacent_chains`, :446-534): colinear chains with
  0 <= gaps, max gap <= 20kb, min gap <= 2kb, both flanks >= 1000bp and
  score >= 500 are merged — this preserves SV-spanning candidates.

This module is the host (numpy) oracle; the batched device version lives in
:mod:`lesv_tpu.ops.chain_jax`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from lesv_tpu_torch.config import ChainConfig


@dataclass
class Chain:
    """One chained candidate (reference HbnInitHit + its seed run)."""

    score: int
    qbeg: int
    qend: int
    sbeg: int
    send: int
    # anchors: (n, 2) array of (qoff, soff), ascending, exact k-mer matches
    anchors: np.ndarray = field(default_factory=lambda: np.empty((0, 2), np.int64))
    seed_len: int = 0  # anchor (k-mer) length


def chain_score_np(qoff: np.ndarray, soff: np.ndarray, length: int,
                   cfg: ChainConfig) -> tuple[np.ndarray, np.ndarray]:
    """Chain DP forward pass. Returns (f, p): best score ending at i, and
    best predecessor (or -1). Seeds must be sorted by (soff, qoff).

    The native C++ kernel (``native.chain_score``)."""
    from lesv_tpu_torch import native

    if len(qoff) == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    return native.chain_score(np.asarray(qoff, np.int64),
                              np.asarray(soff, np.int64), length,
                              cfg.max_dist_qry, cfg.max_dist_ref,
                              cfg.max_band_width)


def _is_contained(chains: list[Chain], c: Chain, eps: int = 100) -> bool:
    for a in chains:
        if (c.qbeg + eps >= a.qbeg and c.qend <= a.qend + eps
                and c.sbeg + eps >= a.sbeg and c.send <= a.send + eps):
            return True
    return False


def extract_chains_np(qoff: np.ndarray, soff: np.ndarray, length: int,
                      cfg: ChainConfig | None = None) -> list[Chain]:
    """Full host chaining: sort, score, extract, dedup, join."""
    cfg = cfg or ChainConfig()
    n = len(qoff)
    if n == 0:
        return []
    order = np.lexsort((qoff, soff))
    qoff = np.asarray(qoff, np.int64)[order]
    soff = np.asarray(soff, np.int64)[order]
    f, p = chain_score_np(qoff, soff, length, cfg)

    # v[i): peak score reachable from i backwards
    v = f.copy()
    for i in range(n):
        if p[i] >= 0:
            v[i] = max(v[p[i]], f[i])

    has_succ = np.zeros(n, dtype=bool)
    has_succ[p[p >= 0]] = True
    ends = np.flatnonzero(~has_succ & (v >= cfg.min_chain_score))
    if len(ends) == 0:
        return []
    # resolve each end to its peak seed
    peaks = []
    for i in ends:
        j = i
        while j >= 0 and f[j] < v[j]:
            j = p[j]
        if j < 0:
            j = i
        peaks.append((int(f[j]), int(j)))
    # highest scoring first (ties: lower index first)
    peaks.sort(key=lambda t: (-t[0], t[1]))

    used = np.zeros(n, dtype=bool)
    chains: list[Chain] = []
    for score, end in peaks:
        if len(chains) >= cfg.max_chains_per_context:
            break
        if used[end]:
            continue
        path = []
        j = end
        while j >= 0 and not used[j]:
            path.append(j)
            used[j] = True
            j = p[j]
        if j < 0:
            chain_score = score
        elif score - f[j] >= cfg.min_chain_score:
            chain_score = score - int(f[j])
        else:
            continue
        if len(path) < cfg.min_seed_cnt:
            continue
        path = path[::-1]  # ascending
        c = Chain(
            score=chain_score,
            qbeg=int(qoff[path[0]]),
            qend=int(qoff[path[-1]]) + length,
            sbeg=int(soff[path[0]]),
            send=int(soff[path[-1]]) + length,
            anchors=np.stack([qoff[path], soff[path]], axis=1),
            seed_len=length,
        )
        if not _is_contained(chains, c):
            chains.append(c)
    return join_adjacent_chains(chains, cfg)


def _chains_adjacent(left: Chain, right: Chain, cfg: ChainConfig) -> bool:
    """`two_chains_are_adjacent` (chain_dp.c:414-444)."""
    if left.qend > right.qbeg or left.send > right.sbeg:
        return False
    gap_q = right.qbeg - left.qend
    gap_r = right.sbeg - left.send
    if max(gap_q, gap_r) > cfg.max_join_long or min(gap_q, gap_r) > cfg.max_join_short:
        return False
    # note: the reference computes right_slen = right.send - LEFT.sbeg
    # (chain_dp.c:430) — an apparent typo that only loosens the check; we use
    # the intended right-flank length.
    if min(left.qend - left.qbeg, left.send - left.sbeg,
           right.qend - right.qbeg, right.send - right.sbeg) \
            < cfg.min_join_flank_len:
        return False
    if (left.score < cfg.min_join_flank_score
            or right.score < cfg.min_join_flank_score):
        return False
    return True


def join_adjacent_chains(chains: list[Chain], cfg: ChainConfig) -> list[Chain]:
    """Merge colinear chains separated by an SV-sized gap.

    Greedy best-score-first over the soff-sorted top-20 chains
    (`join_adjacent_chains`, chain_dp.c:446-534).
    """
    if len(chains) < 2:
        return chains
    kMaxExamine = 20
    order = sorted(range(len(chains)), key=lambda i: (chains[i].sbeg, chains[i].qbeg))
    arr = [chains[i] for i in order]
    by_score = sorted(range(len(arr)), key=lambda i: (-arr[i].score, i))
    consumed = [False] * len(arr)
    out: list[Chain] = []
    for ii in range(min(len(arr), kMaxExamine)):
        hit_idx = by_score[ii]
        if consumed[hit_idx]:
            continue
        consumed[hit_idx] = True
        base = arr[hit_idx]
        members = [base]
        cur = Chain(score=base.score, qbeg=base.qbeg, qend=base.qend,
                    sbeg=base.sbeg, send=base.send, seed_len=base.seed_len)
        # extend left
        for k in range(hit_idx - 1, -1, -1):
            if consumed[k]:
                continue
            if not _chains_adjacent(arr[k], cur, cfg):
                continue
            members.append(arr[k])
            cur.qbeg, cur.sbeg = arr[k].qbeg, arr[k].sbeg
            cur.score += arr[k].score
            consumed[k] = True
        # extend right
        for k in range(hit_idx + 1, len(arr)):
            if consumed[k]:
                continue
            if not _chains_adjacent(cur, arr[k], cfg):
                continue
            members.append(arr[k])
            cur.qend, cur.send = arr[k].qend, arr[k].send
            cur.score += arr[k].score
            consumed[k] = True
        members.sort(key=lambda c: (c.sbeg, c.qbeg))
        cur.anchors = (np.concatenate([m.anchors for m in members])
                       if members else np.empty((0, 2), np.int64))
        out.append(cur)
    out.sort(key=lambda c: -c.score)
    return out
