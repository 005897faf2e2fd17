"""Native DEL/INS caller over remapped consensus reads.

Replaces the reference's external `pbsv discover -l 20` + `pbsv call -t
INS,DEL --max-ins-length 30k` (`scripts/x_hqx2callsv.sh:91,110`): indel
events >= min_sig_len are extracted from the remapped alignments, clustered
per subject by position and length similarity, and clusters with enough
support become VCF calls (position/length = cluster medians; genotype by
supporting-read fraction).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lesv_tpu_torch.config import LesvConfig
from lesv_tpu_torch.io.fasta import decode_seq
from lesv_tpu_torch.io.seqstore import SeqStore
from lesv_tpu_torch.io.vcf import VcfCall
from lesv_tpu_torch.ops.cigar import scan_indel_signatures
from lesv_tpu_torch.pipeline.remap import RemapResult


@dataclass
class CallEvent:
    kind: str
    subject_id: int
    spos: int
    length: int
    read_name: str
    group_id: int
    ins_seq: np.ndarray | None = None


def discover_events(
    results: list[RemapResult],
    cfg: LesvConfig | None = None,
) -> list[CallEvent]:
    """Per remapped read, extract indel events >= min_sig_len."""
    cfg = cfg or LesvConfig()
    out: list[CallEvent] = []
    for r in results:
        events = scan_indel_signatures(r.ops, 0, r.pos, cfg.call.min_sig_len)
        for kind, qpos, spos, length in events:
            if kind == "INS" and length > cfg.call.max_ins_length:
                continue
            ins = r.seq[qpos : qpos + length].copy() if kind == "INS" else None
            out.append(CallEvent(kind, r.subject_id, spos, length,
                                 r.name, r.group_id, ins))
    return out


def _group_by(items, key):
    out: dict = {}
    for it in items:
        out.setdefault(key(it), []).append(it)
    return out


def _cluster(events: list[CallEvent], cfg: LesvConfig) -> list[list[CallEvent]]:
    """Greedy single-linkage by position; split by length dissimilarity."""
    ccfg = cfg.call
    events = sorted(events, key=lambda e: e.spos)
    clusters: list[list[CallEvent]] = []
    for e in events:
        placed = False
        for cl in reversed(clusters):
            last = cl[-1]
            if e.spos - last.spos > ccfg.cluster_dist:
                break
            med = float(np.median([x.length for x in cl]))
            if abs(e.length - med) <= max(ccfg.cluster_len_ratio * max(e.length, med), 25):
                cl.append(e)
                placed = True
                break
        if not placed:
            clusters.append([e])
    return clusters


def call_svs(
    results: list[RemapResult],
    sstore: SeqStore,
    cfg: LesvConfig | None = None,
    raw_spans: list[tuple[int, int, int]] | None = None,
) -> list[VcfCall]:
    """``raw_spans``: (sid, soff, send) alignment spans of ALL mapped
    raw reads (one per read).  With them, depth at a site is true local
    read depth and heterozygous events genotype 0/1; without them the
    remapped consensus reads stand in (they cover only SV groups, so
    every call looks homozygous — the information pbsv gets from the
    reference's SV-read-only SAM, `x_hqx2callsv.sh:58-122`)."""
    cfg = cfg or LesvConfig()
    events = discover_events(results, cfg)
    # depth(pos) = #reads overlapping = #(starts <= pos) - #(ends <= pos)
    spans = (raw_spans if raw_spans is not None
             else [(r.subject_id, r.pos, r.end) for r in results])
    starts: dict[int, np.ndarray] = {}
    ends: dict[int, np.ndarray] = {}
    for sid, grp in _group_by(spans, key=lambda t: t[0]).items():
        starts[sid] = np.sort(np.array([t[1] for t in grp]))
        ends[sid] = np.sort(np.array([t[2] for t in grp]))

    def depth_at(sid: int, pos: int) -> int:
        if sid not in starts:
            return 0
        return int(np.searchsorted(starts[sid], pos, "right")
                   - np.searchsorted(ends[sid], pos, "right"))

    calls: list[VcfCall] = []
    by_key: dict[tuple[int, str], list[CallEvent]] = {}
    for e in events:
        by_key.setdefault((e.subject_id, e.kind), []).append(e)
    for (sid, kind), evs in sorted(by_key.items()):
        for cl in _cluster(evs, cfg):
            # one vote per read
            by_read: dict[str, CallEvent] = {}
            for e in cl:
                by_read.setdefault(e.read_name, e)
            support = len(by_read)
            if support < cfg.call.min_support:
                continue
            uniq = list(by_read.values())
            pos = int(np.median([e.spos for e in uniq]))
            length = int(np.median([e.length for e in uniq]))
            if length < cfg.call.min_sv_len:
                continue
            depth = depth_at(sid, pos)
            if support < cfg.call.min_support_frac * depth:
                continue
            gt = ("1/1" if support
                  >= cfg.call.hom_genotype_frac * max(depth, 1)
                  else "0/1")
            ssize = sstore.seq_size(sid)
            p = max(1, min(pos, ssize - 2))
            anchor = decode_seq(sstore.get(sid, p - 1, p))
            if kind == "DEL":
                ref = anchor + decode_seq(sstore.get(sid, p, min(p + length, ssize)))
                alt = anchor
            else:
                # representative insertion closest to the median length
                rep = min(uniq, key=lambda e: abs(e.length - length))
                ins = rep.ins_seq if rep.ins_seq is not None else np.empty(0, np.uint8)
                ref = anchor
                alt = anchor + decode_seq(ins)
            calls.append(VcfCall(
                subject_id=sid, pos=p - 1, kind=kind, length=length,
                ref=ref, alt=alt, support=support, depth=depth, genotype=gt,
            ))
    calls.sort(key=lambda c: (c.subject_id, c.pos))
    return calls
