"""Indel-signature extraction (stage qx2svsig).

Rebuild of `app/necat2sv/find_sv_signature.c`: each selected SV read is
globally realigned against its subject window (reference: ksw2 with
band = dist*1.2, full-band rescue; here: the anchored banded engine),
bad ends are truncated, TRF windows skipped, effective identity must be
>= 70, and gap runs >= min_indel_size (40) become SvSignature records
carrying both window-local and full-reference coordinates.

Counterpart of :mod:`lesv_tpu.pipeline.signatures`; the realignments run
on the torch ``device`` given to :func:`extract_signatures`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lesv_tpu_torch.config import LesvConfig
from lesv_tpu_torch.io.seqstore import SeqStore
from lesv_tpu_torch.ops.cigar import (
    effective_ident_perc,
    scan_indel_signatures,
)
from lesv_tpu_torch.pipeline.batch_align import chain_and_align_many
from lesv_tpu_torch.pipeline.sv_reads import SvRead, TrfMask, oriented_query
from lesv_tpu_torch.utils import profiling


@dataclass
class SvSignature:
    """One INS/DEL signature (reference `sv_signature.h` semantics)."""

    kind: str        # "INS" | "DEL"
    qid: int
    qdir: int
    qfrom: int       # oriented-query position of the event
    qto: int
    sfrom: int       # subject position of the event (full-reference coords)
    sto: int
    subject_id: int
    length: int      # indel length
    # the whole SV-read alignment span (reference fqfrom/fqto/fsfrom/fsto):
    # remap realigns corrected reads against subject [aln_sb, aln_se)
    aln_qb: int = 0
    aln_qe: int = 0
    aln_sb: int = 0
    aln_se: int = 0


def extract_signatures(
    sv_reads: list[SvRead],
    qstore: SeqStore,
    sstore: SeqStore,
    cfg: LesvConfig | None = None,
    trf: TrfMask | None = None,
    device="cuda",
) -> list[SvSignature]:
    cfg = cfg or LesvConfig()
    with profiling.trace("svsig/extract"):
        sigs: list[SvSignature] = []
        pairs = [
            (oriented_query(qstore, svr.query_id, svr.qdir, svr.qoff,
                            svr.qend),
             sstore.get(svr.subject_id, svr.soff, svr.send))
            for svr in sv_reads
        ]
        with profiling.trace("svsig/align"):
            alns = chain_and_align_many(pairs, cfg, global_fallback=True,
                                        device=device)
        # reference semantics are an UNANCHORED global ksw2: re-solve any
        # window where anchoring split one indel into several gap runs
        # (pipeline.remap.repair_split_gaps_batch; imported here because
        # remap imports cns, which imports this module)
        from lesv_tpu_torch.pipeline.remap import repair_split_gaps_batch

        with profiling.trace("svsig/repair"):
            alns = repair_split_gaps_batch(alns, pairs, cfg)
        for svr, (q, s), aln in zip(sv_reads, pairs, alns):
            if aln is None:
                continue
            # full-reference coordinates of the (trimmed) alignment
            fsb = svr.soff + aln.sb
            fse = svr.soff + aln.se
            if trf and trf.fall_in(svr.subject_id, fsb, fse):
                continue
            eff = effective_ident_perc(aln.ops, q, s, aln.qb, aln.sb,
                                       cfg.align.eff_ident_gap_run)
            if eff < cfg.sv_sig.min_eff_ident_perc:
                continue
            events = scan_indel_signatures(aln.ops, aln.qb, aln.sb,
                                           cfg.sv_sig.min_indel_size)
            fqb = svr.qoff + aln.qb
            fqe = svr.qoff + aln.qe
            for kind, qpos, spos, length in events:
                # positions: qpos relative to the extracted span; convert to
                # oriented-read coords; spos to full-reference coords
                fq = svr.qoff + qpos
                fs = svr.soff + spos
                if kind == "DEL":
                    sigs.append(SvSignature("DEL", svr.query_id, svr.qdir,
                                            fq, fq + 1, fs, fs + length,
                                            svr.subject_id, length,
                                            fqb, fqe, fsb, fse))
                else:
                    sigs.append(SvSignature("INS", svr.query_id, svr.qdir,
                                            fq, fq + length, fs, fs + 1,
                                            svr.subject_id, length,
                                            fqb, fqe, fsb, fse))
        sigs.sort(key=lambda g: (g.subject_id, g.sfrom))
    return sigs
