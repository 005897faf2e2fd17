"""SV-read selection (stage qx2svr).

Rebuild of `app/necat2sv/find_sv_reads.c`: per query, classify its M4
records —

* complete alignments (both overhangs <= 300): keep the unique one, or the
  best by *effective* identity if it beats the runner-up by > 10
  (`find_complete_m4`, :168-245);
* otherwise "dual" split alignments: a left-end + right-end pair on the same
  subject, overlapping or <= 30kb apart (`two_m4s_are_dual`, :253-276) —
  realign the union span and keep it if the effective identity is within 4
  of the parts' (`s_chain_dual_m4s`, :340-430);
* contained (eps 200) and repeat (eps 300) M4s removed first;
* tandem-repeat regions excluded (trf mask: interval all-but-2kb covered,
  `trf_array.cpp:75-89`).

Coordinates follow the reference convention: M4/SvRead qoff/qend are
strand-oriented; conversion to forward-read coordinates happens only at
sequence extraction.

Counterpart of :mod:`lesv_tpu.pipeline.sv_reads`; span realignments run
on the torch ``device`` handed down from :func:`select_sv_reads`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lesv_tpu_torch.config import LesvConfig
from lesv_tpu_torch.io.fasta import revcomp
from lesv_tpu_torch.io.seqstore import SeqStore
from lesv_tpu_torch.ops.anchored import anchored_extend
from lesv_tpu_torch.ops.cigar import effective_ident_perc, match_mask
from lesv_tpu_torch.ops.pairseed import mem_anchors, pair_chains
from lesv_tpu_torch.pipeline.batch_align import _apply_global_fallback
from lesv_tpu_torch.pipeline.mapper import FWD, REV, M4
from lesv_tpu_torch.utils import profiling


@dataclass
class SvRead:
    """One selected SV-evidence read span (reference `sv_reads.h:11-20`)."""

    query_id: int
    qdir: int
    qoff: int       # strand-oriented
    qend: int
    qsize: int
    subject_id: int
    soff: int
    send: int
    dist: int


class TrfMask:
    """Tandem-repeat mask with the reference's all-but-2kb test."""

    def __init__(self, store: SeqStore, intervals: dict[int, list[tuple[int, int]]]):
        self._cum: dict[int, np.ndarray] = {}
        for sid, ivs in intervals.items():
            n = store.seq_size(sid)
            mask = np.zeros(n, bool)
            for a, b in ivs:
                mask[max(0, a) : min(n, b)] = True
            c = np.zeros(n + 1, np.int64)
            np.cumsum(mask, out=c[1:])
            self._cum[sid] = c

    def fall_in(self, sid: int, frm: int, to: int, slack: int = 2000) -> bool:
        c = self._cum.get(sid)
        if c is None:
            return False
        frm = max(0, min(frm, len(c) - 1))
        to = max(0, min(to, len(c) - 1))
        covered = int(c[to] - c[frm])
        return (to - frm) - covered <= slack


def oriented_query(store: SeqStore, qid: int, qdir: int,
                   qoff: int, qend: int) -> np.ndarray:
    """Extract [qoff, qend) of the qdir-oriented read."""
    qsize = store.seq_size(qid)
    if qdir == FWD:
        return store.get(qid, qoff, qend)
    return store.get(qid, qsize - qend, qsize - qoff, rc=True)


def _eff_ident_of_m4(m4: M4, qstore: SeqStore, sstore: SeqStore,
                     cfg: LesvConfig, device) -> tuple[float, int] | None:
    """Effective identity (and dist) of an M4, realigning if ops missing.

    The in-memory / npz-checkpoint path carries the alignment ops, so no
    realignment happens; M4s parsed from the 12-column text format carry
    no ops and are realigned — which is exactly what the reference does
    with its text M4 round-trip (`align_and_refine_subseq_with_ksw`,
    app/necat2sv/align_subseqs.c:193)."""
    if m4.ops is not None:
        q = oriented_query(qstore, m4.qid, m4.qdir, m4.qoff, m4.qend)
        s = sstore.get(m4.sid, m4.soff, m4.send)
        eff = effective_ident_perc(m4.ops, q, s, 0, 0,
                                   cfg.align.eff_ident_gap_run)
        return eff, m4.dist
    aln = realign_span(qstore, sstore, m4.qid, m4.qdir, m4.qoff, m4.qend,
                       m4.sid, m4.soff, m4.send, cfg, device=device)
    if aln is None:
        return None
    q, s, a = aln
    eff = effective_ident_perc(a.ops, q, s, a.qb, a.sb,
                               cfg.align.eff_ident_gap_run)
    mm = int(match_mask(a.ops, q, s, a.qb, a.sb).sum())
    return eff, len(a.ops) - mm


def realign_span(qstore: SeqStore, sstore: SeqStore, qid: int, qdir: int,
                 qoff: int, qend: int, sid: int, soff: int, send: int,
                 cfg: LesvConfig, device="cuda"):
    """Anchored global realignment of an oriented query span vs a subject
    span (replaces `align_and_refine_subseq_with_ksw`)."""
    with profiling.trace("svr/realign"):
        q = oriented_query(qstore, qid, qdir, qoff, qend)
        s = sstore.get(sid, soff, send)
        mk = cfg.memsc.kmer_size
        chains = pair_chains(q, s, k=mk, q_stride=cfg.memsc.kmer_window,
                             max_occ=cfg.memsc.max_occ,
                             min_score=cfg.memsc.mem_score, cfg=cfg.chain)
        aln = None
        if chains:
            runs = mem_anchors(q, s, chains[0].anchors, mk,
                               cfg.memsc.mem_size)
            aln = anchored_extend(q, s, runs, k=mk, cfg=cfg.align,
                                  device=device)
        # whole-span NW fallback (the reference always full-DPs this span,
        # `align_subseqs.c:193-262`); see batch_align._apply_global_fallback
        res = [aln]
        _apply_global_fallback([(q, s)], res, cfg, device)
        aln = res[0]
    if aln is None:
        return None
    return q, s, aln


def _m4_complete(m4: M4, max_overhang: int) -> bool:
    return m4.qoff <= max_overhang and m4.qsize - m4.qend <= max_overhang


def remove_contained_m4s(m4s: list[M4], eps: int = 200) -> list[M4]:
    """Per subject, drop M4s contained (within eps) in another
    (`remove_contained_m4s`, find_sv_reads.c:491-543)."""
    dead = set()
    by_sid: dict[int, list[int]] = {}
    for i, m in enumerate(m4s):
        by_sid.setdefault(m.sid, []).append(i)
    for idxs in by_sid.values():
        for a_pos, i in enumerate(idxs):
            if i in dead:
                continue
            mi = m4s[i]
            for j in idxs[a_pos + 1 :]:
                if j in dead or m4s[j].qdir != mi.qdir:
                    continue
                mj = m4s[j]
                if (mj.qoff + eps >= mi.qoff and mj.qend <= mi.qend + eps
                        and mj.soff + eps >= mi.soff and mj.send <= mi.send + eps):
                    dead.add(j)
                elif (mi.qoff + eps >= mj.qoff and mi.qend <= mj.qend + eps
                        and mi.soff + eps >= mj.soff and mi.send <= mj.send + eps):
                    dead.add(i)
                    break
    return [m for i, m in enumerate(m4s) if i not in dead]


def remove_repeat_m4s(m4s: list[M4], eps: int = 300) -> list[M4]:
    """Drop pairs mapping the same query span to different places
    (`remove_repeat_m4s`, find_sv_reads.c:546-583)."""
    dead = set()
    for i, mi in enumerate(m4s):
        if i in dead:
            continue
        for j in range(i + 1, len(m4s)):
            if j in dead:
                continue
            mj = m4s[j]
            a, b = max(mi.qoff, mj.qoff), min(mi.qend, mj.qend)
            if a < b:
                x = abs(a - mi.qoff) + abs(b - mi.qend)
                u = abs(a - mj.qoff) + abs(b - mj.qend)
                if x <= eps and u <= eps:
                    dead.add(i)
                    dead.add(j)
    return [m for i, m in enumerate(m4s) if i not in dead]


def _sv_read_from_m4(m4: M4) -> SvRead:
    return SvRead(m4.qid, m4.qdir, m4.qoff, m4.qend, m4.qsize,
                  m4.sid, m4.soff, m4.send, m4.dist)


def _find_complete(m4s: list[M4], qstore: SeqStore, sstore: SeqStore,
                   trf: TrfMask | None, cfg: LesvConfig,
                   out: list[SvRead], device) -> bool:
    scfg = cfg.sv_read
    comp = [m for m in m4s if _m4_complete(m, scfg.max_overhang)]
    if not comp:
        return False
    if len(comp) == 1 and comp[0].ident_perc >= scfg.min_ident_perc:
        m = comp[0]
        if not (trf and trf.fall_in(m.sid, m.soff, m.send)):
            out.append(_sv_read_from_m4(m))
        return True
    scored: list[tuple[float, M4]] = []
    for m in comp:
        r = _eff_ident_of_m4(m, qstore, sstore, cfg, device)
        if r is None:
            continue
        eff, dist = r
        if eff < scfg.min_ident_perc:
            continue
        m.ident_perc = eff
        m.dist = dist
        scored.append((eff, m))
    if not scored:
        return True
    scored.sort(key=lambda t: -t[0])
    if len(scored) == 1 or scored[0][0] - scored[1][0] > scfg.best_ident_margin:
        m = scored[0][1]
        if not (trf and trf.fall_in(m.sid, m.soff, m.send)):
            out.append(_sv_read_from_m4(m))
    return True


def _find_dual(m4s: list[M4], qstore: SeqStore, sstore: SeqStore,
               trf: TrfMask | None, cfg: LesvConfig,
               out: list[SvRead], device) -> bool:
    scfg = cfg.sv_read
    pairs: list[tuple[M4, M4]] = []
    by_sid: dict[int, list[M4]] = {}
    for m in m4s:
        by_sid.setdefault(m.sid, []).append(m)
    for sid, ms in by_sid.items():
        lm, rm = [], []
        for m in ms:
            if _m4_complete(m, scfg.max_overhang):
                continue
            if trf and trf.fall_in(m.sid, m.soff, m.send):
                continue
            if m.qoff <= scfg.max_overhang:
                lm.append(m)
            if m.qsize - m.qend <= scfg.max_overhang:
                rm.append(m)
        lm = [m for m in lm if _passes_eff(m, qstore, sstore, cfg, device)]
        if not lm:
            continue
        rm = [m for m in rm if _passes_eff(m, qstore, sstore, cfg, device)]
        if not rm:
            continue
        for left in lm:
            for right in rm:
                if _are_dual(left, right, scfg.dual_max_subject_gap):
                    pairs.append((left, right))
    if len(pairs) == 1:
        _chain_dual(pairs[0][0], pairs[0][1], qstore, sstore, cfg, out,
                    device)
    return len(pairs) > 0


def _passes_eff(m: M4, qstore, sstore, cfg, device) -> bool:
    if m.ident_perc >= cfg.sv_read.min_ident_perc:
        return True
    r = _eff_ident_of_m4(m, qstore, sstore, cfg, device)
    if r is None:
        return False
    eff, dist = r
    m.ident_perc = eff
    m.dist = dist
    return eff >= cfg.sv_read.min_ident_perc


def _are_dual(a: M4, b: M4, max_gap: int) -> bool:
    lo, hi = (a, b) if a.soff < b.soff else (b, a)
    if hi.soff <= lo.send:
        return True
    return hi.soff - lo.send <= max_gap


def _chain_dual(m1: M4, m2: M4, qstore: SeqStore, sstore: SeqStore,
                cfg: LesvConfig, out: list[SvRead], device) -> bool:
    """`s_chain_dual_m4s` (find_sv_reads.c:340-430): realign the union span
    and accept if effective identity survives."""
    if m1.qdir != m2.qdir:
        return False
    # union span in strand-oriented coordinates
    if m1.soff > m2.soff and m1.qoff > m2.qoff:
        m1, m2 = m2, m1
    if not (m1.soff <= m2.soff and m1.qoff <= m2.qoff):
        return False
    qoff = min(m1.qoff, m2.qoff)
    qend = max(m1.qend, m2.qend)
    soff = min(m1.soff, m2.soff)
    send = max(m1.send, m2.send)
    r = realign_span(qstore, sstore, m1.qid, m1.qdir, qoff, qend,
                     m1.sid, soff, send, cfg, device=device)
    if r is None:
        return False
    q, s, aln = r
    eff = effective_ident_perc(aln.ops, q, s, aln.qb, aln.sb,
                               cfg.align.eff_ident_gap_run)
    if (eff > m1.ident_perc - cfg.sv_read.dual_ident_margin
            or eff > m2.ident_perc - cfg.sv_read.dual_ident_margin):
        mm = int(match_mask(aln.ops, q, s, aln.qb, aln.sb).sum())
        out.append(SvRead(
            query_id=m1.qid, qdir=m1.qdir,
            qoff=qoff + aln.qb, qend=qoff + aln.qe, qsize=m1.qsize,
            subject_id=m1.sid, soff=soff + aln.sb, send=soff + aln.se,
            dist=len(aln.ops) - mm,
        ))
    return True


def select_sv_reads(
    m4s: list[M4],
    qstore: SeqStore,
    sstore: SeqStore,
    cfg: LesvConfig | None = None,
    trf: TrfMask | None = None,
    device="cuda",
) -> list[SvRead]:
    """Run SV-read selection over all M4 records (grouped by query);
    span realignments run on ``device``."""
    cfg = cfg or LesvConfig()
    with profiling.trace("svr/select"):
        by_qid: dict[int, list[M4]] = {}
        for m in m4s:
            by_qid.setdefault(m.qid, []).append(m)
        out: list[SvRead] = []
        for qid in sorted(by_qid):
            ms = by_qid[qid]
            if ms[0].qsize < cfg.sv_read.min_seq_size:
                continue
            ms = remove_contained_m4s(ms, cfg.sv_read.contained_eps)
            if not ms:
                continue
            if _find_complete(ms, qstore, sstore, trf, cfg, out, device):
                continue
            ms = remove_repeat_m4s(ms, cfg.sv_read.repeat_eps)
            if not ms:
                continue
            _find_dual(ms, qstore, sstore, trf, cfg, out, device)
    return out
