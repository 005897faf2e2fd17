"""Signature clustering into SV read groups (stage qx2msvrg).

Rebuild of `app/necat2sv/make_sv_read_groups.c` + `find_one_sv_group.cpp`:
per (subject, kind), signatures sorted by reference position are scanned
with

* a strict pass: sliding 10bp window mode-finding, group = all signatures
  within +-20bp of the mode center, >= 4 signatures
  (`find_next_{ins,del}_group`, find_one_sv_group.cpp:100-164);
* a relaxed pass over the leftovers: 50bp chained windows with indel-length
  similarity (diff <= 50bp and <= 10% of the longer,
  `find_next_*_group_relax`, :36-98).

Each group gets an id; a query joins at most one group per pass (the
reference marks added qids in a set and invalidates grouped signatures).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from lesv_tpu_torch.config import GroupConfig, LesvConfig
from lesv_tpu_torch.pipeline.signatures import SvSignature


@dataclass
class SvGroup:
    group_id: int
    subject_id: int
    kind: str
    sigs: list[SvSignature] = field(default_factory=list)


def _sig_len(sig: SvSignature) -> int:
    return sig.length


def _strict_pass(sigs: list[SvSignature], cfg: GroupConfig,
                 next_gid: int, subject_id: int, kind: str,
                 used: list[bool]) -> tuple[list[SvGroup], int]:
    """Sliding-window mode finding (reference find_next_*_group)."""
    groups: list[SvGroup] = []
    n = len(sigs)
    i = 0
    while i < n:
        # initial window [soff, soff + W)
        soff = sigs[i].sfrom
        send = soff + cfg.window
        j = i + 1
        while j < n and sigs[j].sfrom < send:
            j += 1
        cnt = j - i
        max_cnt = cnt
        max_i = i + cnt // 2
        ii, jj = i, j
        while jj < n:
            reduced = sum(1 for k in range(ii, jj) if sigs[k].sfrom == soff)
            k = jj
            added = 0
            while k < n and sigs[k].sfrom == send + 1:
                added += 1
                k += 1
            if added == 0:
                break
            cnt = cnt - reduced + added
            soff += 1
            send += 1
            ii += reduced
            jj = k
            if cnt > max_cnt:
                max_cnt = cnt
                max_i = ii + cnt // 2
        gi_from = max_i
        while gi_from > i and sigs[max_i].sfrom - sigs[gi_from - 1].sfrom <= cfg.max_dist:
            gi_from -= 1
        gi_to = max_i + 1
        while gi_to < n and sigs[gi_to].sfrom - sigs[max_i].sfrom <= cfg.max_dist:
            gi_to += 1
        if gi_to - gi_from >= cfg.min_cnt:
            g = SvGroup(next_gid, subject_id, kind, sigs[gi_from:gi_to])
            next_gid += 1
            groups.append(g)
            for k in range(gi_from, gi_to):
                used[k] = True
        i = gi_to
    return groups, next_gid


def _relax_pass(sigs: list[SvSignature], cfg: GroupConfig,
                next_gid: int, subject_id: int, kind: str,
                used: list[bool]) -> tuple[list[SvGroup], int]:
    """Chained 50bp windows with length-similarity (find_next_*_group_relax)."""
    groups: list[SvGroup] = []
    idxs = [k for k in range(len(sigs)) if not used[k]]
    n = len(idxs)
    i = 0
    while i < n:
        last = i
        last_send = sigs[idxs[last]].sfrom + cfg.window_relax
        members = []
        j = i + 1
        while j < n:
            sj = sigs[idxs[j]]
            if sj.sfrom > last_send:
                break
            a = _sig_len(sigs[idxs[last]])
            b = _sig_len(sj)
            mx, mn = max(a, b), min(a, b)
            if (mx - mn) <= mx * cfg.max_len_diff_ratio and mx - mn <= cfg.max_len_diff:
                last = j
                last_send = sj.sfrom + cfg.window_relax
                members.append(idxs[j])
            j += 1
        if len(members) < cfg.min_cnt_relax:
            i += 1
            continue
        members.append(idxs[i])
        g = SvGroup(next_gid, subject_id, kind,
                    sorted((sigs[k] for k in members), key=lambda s: s.sfrom))
        next_gid += 1
        groups.append(g)
        for k in members:
            used[k] = True
        i = last + 1
    return groups, next_gid


def group_signatures(
    sigs: list[SvSignature],
    cfg: LesvConfig | None = None,
) -> list[SvGroup]:
    """Cluster signatures into groups, per (subject, kind), strict then
    relaxed pass; group ids are global and increasing."""
    cfg = cfg or LesvConfig()
    gcfg = cfg.group
    groups: list[SvGroup] = []
    gid = 0
    keys = sorted({(s.subject_id, s.kind) for s in sigs})
    for subject_id, kind in keys:
        sub = sorted((s for s in sigs
                      if s.subject_id == subject_id and s.kind == kind),
                     key=lambda s: s.sfrom)
        used = [False] * len(sub)
        gs, gid = _strict_pass(sub, gcfg, gid, subject_id, kind, used)
        groups.extend(gs)
        gs, gid = _relax_pass(sub, gcfg, gid, subject_id, kind, used)
        groups.extend(gs)
    # a query may appear multiple times in one group (same read, several
    # signatures); consensus wants unique reads — dedupe by (qid, qdir)
    for g in groups:
        seen = set()
        uniq = []
        for s in g.sigs:
            if (s.qid, s.qdir) in seen:
                continue
            seen.add((s.qid, s.qdir))
            uniq.append(s)
        g.sigs = uniq
    return groups
