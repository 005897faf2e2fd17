"""Remap corrected SV reads to the reference (stage qx2asvr).

Rebuild of `app/necat2sv/map_cns_sv_read.c`: each corrected read (oriented
by its fsqdir) is globally aligned against the subject window encoded in
its metadata (band 0.2 x len, full-band rescue in the reference), the
alignment is clipped to the consensus-corrected subsequence
(`s_dump_sv_read_info`, :57-170), kept only at effective identity >= 85,
and emitted as an alignment record (SAM downstream).

Counterpart of :mod:`lesv_tpu.pipeline.remap`; the realignments run on
the torch ``device`` given to :func:`remap_all`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lesv_tpu_torch.config import LesvConfig
from lesv_tpu_torch.io.fasta import revcomp
from lesv_tpu_torch.io.seqstore import SeqStore
from lesv_tpu_torch.ops.align_batch import align_pairs_host
from lesv_tpu_torch.ops.align_np import OP_D, OP_I, OP_M, Alignment
from lesv_tpu_torch.ops.cigar import effective_ident_perc, ident_perc
from lesv_tpu_torch.pipeline.batch_align import chain_and_align_many
from lesv_tpu_torch.pipeline.cns import CorrectedRead


@dataclass
class RemapResult:
    """One remapped consensus read (feeds SAM emission + the caller)."""

    name: str
    global_id: int
    rev: bool
    subject_id: int
    pos: int          # 0-based subject start (full-reference coords)
    end: int
    ops: np.ndarray   # clipped alignment ops
    seq: np.ndarray   # the aligned oriented read subsequence
    ident_perc: float
    eff_ident_perc: float
    group_id: int
    kind: str


def _remap_finish(
    cr: CorrectedRead,
    read: np.ndarray,
    subject: np.ndarray,
    aln,
    cfg: LesvConfig,
) -> RemapResult | None:
    n = len(read)
    if cr.fsqdir == 0:
        cns_qb, cns_qe = cr.cns_from, cr.cns_to
    else:
        cns_qb, cns_qe = n - cr.cns_to, n - cr.cns_from
    # clip alignment columns to the consensus subsequence [cns_qb, cns_qe)
    isq = aln.ops != OP_D
    ist = aln.ops != OP_I
    qpos = aln.qb + np.cumsum(isq)   # query consumed *after* each column
    a = int(np.searchsorted(qpos, cns_qb + 1)) if cns_qb > aln.qb else 0
    b = int(np.searchsorted(qpos, cns_qe, side="right")) if cns_qe < aln.qe else len(aln.ops)
    if a >= b:
        return None
    ops = aln.ops[a:b]
    qif = aln.qb + int(isq[:a].sum())
    sif = aln.sb + int(ist[:a].sum())
    qie = qif + int((ops != OP_D).sum())
    sie = sif + int((ops != OP_I).sum())
    pid = ident_perc(ops, read, subject, qif, sif)
    eff = effective_ident_perc(ops, read, subject, qif, sif,
                               cfg.align.eff_ident_gap_run)
    if eff < cfg.remap.min_eff_ident_perc:
        return None
    return RemapResult(
        name=f"{cr.name}_svr:{cr.fsqdir}:{cr.subject_id}:{cr.group_id}:"
             f"{cr.fsfrom}:{cr.fsto}_cns:{cr.cns_from}:{cr.cns_to}",
        global_id=cr.global_id,
        rev=cr.fsqdir == 1,
        subject_id=cr.subject_id,
        pos=cr.fsfrom + sif,
        end=cr.fsfrom + sie,
        ops=ops,
        seq=read[qif:qie],
        ident_perc=pid,
        eff_ident_perc=eff,
        group_id=cr.group_id,
        kind=cr.kind,
    )


def _split_gap_windows(ops: np.ndarray, min_run: int,
                       join_cols: int, margin: int) -> list[list[int]]:
    """Column windows holding >= 2 same-kind gap runs within
    ``join_cols`` columns (the split-indel signature)."""
    n = len(ops)
    runs: list[tuple[int, int, int]] = []
    i = 0
    while i < n:
        op = int(ops[i])
        j = i
        while j < n and ops[j] == op:
            j += 1
        if op != OP_M and j - i >= min_run:
            runs.append((op, i, j))
        i = j
    wins: list[list[int]] = []
    k = 0
    while k < len(runs):
        grp = [runs[k]]
        k2 = k + 1
        while (k2 < len(runs) and runs[k2][0] == grp[0][0]
               and runs[k2][1] - grp[-1][2] <= join_cols):
            grp.append(runs[k2])
            k2 += 1
        if len(grp) >= 2:
            a = max(0, grp[0][1] - margin)
            b = min(n, grp[-1][2] + margin)
            if wins and a <= wins[-1][1]:
                wins[-1][1] = max(wins[-1][1], b)
            else:
                wins.append([a, b])
        k = k2
    return wins


def repair_split_gaps_batch(alns, pairs, cfg: LesvConfig,
                            min_run: int = 20, join_cols: int = 2000,
                            margin: int = 300):
    """Re-solve windows holding multiple same-kind gap runs with an
    exact local DP between fixed anchor columns, batched across all
    alignments (ONE native host sweep).

    A chain-anchored alignment can split one indel across a tandem
    repeat (a MEM between repeat copies pins the path; two gap-opens).
    The reference's unanchored global ksw2 (`map_cns_sv_read.c:145`)
    merges such gaps whenever merging wins the affine score; replacing
    the local window with the segment-optimal DP (endpoints fixed)
    reproduces that outcome at a tiny fraction of a full unanchored
    realign (measured: a 1614 bp TRF DEL otherwise emitted as 894+719)."""
    plans = []                      # (idx, wins)
    seg_pairs = []
    owners = []                     # parallel to seg_pairs: (idx, win#)
    for idx, (aln, (q, s)) in enumerate(zip(alns, pairs)):
        if aln is None or len(aln.ops) == 0:
            continue
        wins = _split_gap_windows(aln.ops, min_run, join_cols, margin)
        if not wins:
            continue
        ops = aln.ops
        qpre = np.concatenate([[0], np.cumsum(ops != OP_D)])
        spre = np.concatenate([[0], np.cumsum(ops != OP_I)])
        for w, (a, b) in enumerate(wins):
            q0, q1 = aln.qb + qpre[a], aln.qb + qpre[b]
            s0, s1 = aln.sb + spre[a], aln.sb + spre[b]
            seg_pairs.append((q[q0:q1], s[s0:s1]))
            owners.append((idx, w))
        plans.append((idx, wins))
    if not seg_pairs:
        return alns
    segs = align_pairs_host(seg_pairs, cfg.align, free_end=False)
    seg_of: dict[tuple[int, int], object] = dict(zip(owners, segs))
    out = list(alns)
    for idx, wins in plans:
        aln = alns[idx]
        ops = aln.ops
        parts = []
        prev = 0
        changed = False
        for w, (a, b) in enumerate(wins):
            sa = seg_of.get((idx, w))
            parts.append(ops[prev:a])
            if sa is not None and len(sa.ops):
                parts.append(sa.ops)
                changed = True
            else:
                parts.append(ops[a:b])
            prev = b
        parts.append(ops[prev:])
        if changed:
            out[idx] = Alignment(aln.qb, aln.qe, aln.sb, aln.se,
                                 np.concatenate(parts), score=aln.score)
    return out


def remap_all(
    corrected: list[CorrectedRead],
    sstore: SeqStore,
    cfg: LesvConfig | None = None,
    device="cuda",
) -> list[RemapResult]:
    cfg = cfg or LesvConfig()
    pairs = []
    reads = []
    for cr in corrected:
        read = cr.seq if cr.fsqdir == 0 else revcomp(cr.seq)
        subject = sstore.get(cr.subject_id, cr.fsfrom, cr.fsto)
        pairs.append((read, subject))
        reads.append(read)
    alns = chain_and_align_many(pairs, cfg, global_fallback=True,
                                device=device)
    alns = repair_split_gaps_batch(alns, pairs, cfg)
    out = []
    for cr, (read, subject), aln in zip(corrected, pairs, alns):
        if aln is None or len(aln.ops) == 0:
            continue
        r = _remap_finish(cr, read, subject, aln, cfg)
        if r is not None:
            out.append(r)
    out.sort(key=lambda r: (r.subject_id, r.pos))
    return out
