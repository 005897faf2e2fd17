"""Group consensus (stage qx2csvrg): error-correct SV reads per group.

Rebuild of `app/cns_sv_read_group/cns_one_group.c`:

* groups capped at 50 signatures by a pairwise length-similarity outlier
  filter (`s_filter_outlier_svsig`, sv_read_group.c:37-90);
* each group member (the full raw read, FWD orientation) is used in turn as
  the template; all other members are overlapped against it (either
  strand), with coverage capped at 15x (`MAX_CNS_COV`);
* two rounds: round 1 accepts overlaps at >= 65% identity, round 2 re-runs
  on the round-1 output at >= 85% (`correct_one_sv_read`, :302-517);
* align tags from accepted overlaps feed the fccns backbone DP; only the
  longest >= min_cov(3)-covered segment of >= min_size(2000) is replaced by
  consensus; flanks are kept raw.

Counterpart of :mod:`lesv_tpu.pipeline.cns`; overlap chains and overlap
alignments run on the torch ``device`` given to :func:`cns_groups`.  The
fccns weights stay float64 numpy on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lesv_tpu_torch.config import LesvConfig
from lesv_tpu_torch.io.fasta import revcomp
from lesv_tpu_torch.io.seqstore import SeqStore
from lesv_tpu_torch.ops.anchored import anchored_align_many
from lesv_tpu_torch.ops.cigar import match_mask
from lesv_tpu_torch.ops.pairseed import mem_anchors
from lesv_tpu_torch.ops.consensus import (
    consensus_from_tags,
    coverage_from_tags,
    tags_from_ops,
)
from lesv_tpu_torch.pipeline.batch_align import batch_pair_chains
from lesv_tpu_torch.pipeline.grouping import SvGroup
from lesv_tpu_torch.pipeline.signatures import SvSignature
from lesv_tpu_torch.utils import profiling


@dataclass
class GroupRead:
    """One group member (reference SvReadInfo)."""

    global_id: int
    name: str
    seq: np.ndarray          # forward-oriented full read (or corrected read)
    raw_seq_from: int = 0    # consensus-replaced segment bounds
    raw_seq_to: int = 0
    fsqdir: int = 0          # orientation of the read's subject-window aln
    fsfrom: int = 0          # subject window (full-reference coords)
    fsto: int = 0


@dataclass
class CorrectedRead:
    global_id: int
    name: str
    seq: np.ndarray          # corrected, forward-oriented
    cns_from: int            # consensus segment within `seq`
    cns_to: int
    fsqdir: int
    subject_id: int
    fsfrom: int
    fsto: int
    group_id: int
    kind: str


def filter_outlier_sigs(sigs: list[SvSignature], cap: int = 50) -> list[SvSignature]:
    """Keep the `cap` signatures most length-consistent with the others."""
    if len(sigs) <= cap:
        return sigs
    lens = np.array([s.length for s in sigs], np.int64)
    mx = np.maximum.outer(lens, lens)
    mn = np.minimum.outer(lens, lens)
    sim = (mx - mn) <= mx * 0.2
    np.fill_diagonal(sim, False)
    score = sim.sum(axis=1)
    order = np.argsort(-score, kind="stable")[:cap]
    return [sigs[i] for i in sorted(order)]


def _group_reads(group: SvGroup, qstore: SeqStore) -> list[GroupRead]:
    out = []
    for s in filter_outlier_sigs(group.sigs):
        seq = qstore.get(s.qid)
        # fsfrom/fsto: the whole SV-read alignment window on the subject
        out.append(GroupRead(
            global_id=s.qid, name=qstore.name_of(s.qid), seq=seq,
            fsqdir=s.qdir, fsfrom=s.aln_sb, fsto=s.aln_se,
        ))
    return out


def _all_overlap_cands(
    read_lists: list[list[GroupRead]],
    cfg: LesvConfig,
    device,
) -> list[list[list[tuple]]]:
    """Best-strand overlap chains for every (group, template, other)
    triple, computed in two global batched sweeps.

    Reproduces `_best_overlap` semantics per triple (the reference's
    `cns_one_group.c:337-339` orientation search): the expected relative
    orientation (fsqdir XOR) is chained first; the other strand is only
    consulted when the expected one scores < 1000, and wins only on a
    strictly greater score.  Returns cands[g][i] = ordered list of
    (j, chain, sdir, oriented_query)."""
    triples: list[tuple[int, int, int]] = []   # (g, tmpl i, other j)
    for g, reads in enumerate(read_lists):
        for i, tmpl in enumerate(reads):
            if len(tmpl.seq) == 0:
                continue
            for j, other in enumerate(reads):
                if j == i or len(other.seq) == 0:
                    continue
                triples.append((g, i, j))

    # oriented query cache: (g, j, sdir) -> seq
    oq: dict[tuple[int, int, int], np.ndarray] = {}

    def oriented(g: int, j: int, sdir: int) -> np.ndarray:
        key = (g, j, sdir)
        if key not in oq:
            seq = read_lists[g][j].seq
            oq[key] = seq if sdir == 0 else revcomp(seq)
        return oq[key]

    # sweep 1: expected strand for every triple
    exp_dirs = [read_lists[g][j].fsqdir ^ read_lists[g][i].fsqdir
                for g, i, j in triples]
    pairs = [(oriented(g, j, d), read_lists[g][i].seq)
             for (g, i, j), d in zip(triples, exp_dirs)]
    exp_chains = batch_pair_chains(pairs, cfg, device=device)

    # sweep 2: the other strand where the expected one isn't decisive
    need2 = [t for t, ch in enumerate(exp_chains)
             if not ch or ch[0].score < 1000]
    pairs2 = [(oriented(triples[t][0], triples[t][2], 1 - exp_dirs[t]),
               read_lists[triples[t][0]][triples[t][1]].seq)
              for t in need2]
    alt_chains = (batch_pair_chains(pairs2, cfg, device=device)
                  if pairs2 else [])
    alt_of = dict(zip(need2, alt_chains))

    cands: list[list[list[tuple]]] = [
        [[] for _ in reads] for reads in read_lists]
    for t, (g, i, j) in enumerate(triples):
        d = exp_dirs[t]
        best = (exp_chains[t][0], d) if exp_chains[t] else None
        alt = alt_of.get(t)
        if alt:
            if best is None or alt[0].score > best[0].score:
                best = (alt[0], 1 - d)
        if best is None:
            continue
        chain, sdir = best
        cands[g][i].append((j, chain, sdir, oriented(g, j, sdir)))
    return cands


class _TemplateState:
    """Per-template admission state (reference correct_one_sv_read's
    in-order coverage-capped accumulation, `cns_one_group.c:302-441`)."""

    __slots__ = ("g", "i", "cands", "pos", "cov", "tags", "num_added",
                 "full")

    def __init__(self, g: int, i: int, cands: list, T: int):
        self.g = g
        self.i = i
        self.cands = cands
        self.pos = 0
        self.cov = np.zeros(T, np.int64)
        self.tags: list[np.ndarray] = []
        self.num_added = 0
        self.full = False

    def done(self) -> bool:
        return self.full or self.pos >= len(self.cands)


def _run_round(
    read_lists: list[list[GroupRead]],
    cfg: LesvConfig,
    min_ident: float,
    device,
) -> list[list[GroupRead]]:
    """One correction round over every group at once.

    All overlap chains run in two global sweeps; overlap alignments run
    in global waves (every unfinished template contributes its next
    candidate chunk); admission is then replayed per template in
    reference order, so accepted overlaps / coverage caps / tag sets are
    identical to the sequential per-template loop."""
    ccfg = cfg.cns
    with profiling.trace("cns/overlap_cands"):
        cands = _all_overlap_cands(read_lists, cfg, device)
    states: list[_TemplateState] = []
    for g, reads in enumerate(read_lists):
        for i, tmpl in enumerate(reads):
            if len(tmpl.seq) == 0:
                continue
            states.append(_TemplateState(g, i, cands[g][i], len(tmpl.seq)))

    # global alignment waves: first chunk covers the coverage cap with
    # slack (identity failures are rare), later chunks top up stragglers
    first_chunk = ccfg.max_cns_cov + 5
    next_chunk = 8
    pending = [st for st in states if not st.done()]
    while pending:
        tasks = []
        owners: list[tuple[_TemplateState, int]] = []
        with profiling.trace("cns/mem_anchors"):
            for st in pending:
                tmpl_seq = read_lists[st.g][st.i].seq
                chunk = first_chunk if st.pos == 0 else next_chunk
                for idx in range(st.pos,
                                 min(st.pos + chunk, len(st.cands))):
                    j, chain, sdir, q = st.cands[idx]
                    runs = mem_anchors(q, tmpl_seq, chain.anchors,
                                       cfg.memsc.kmer_size,
                                       cfg.memsc.mem_size)
                    tasks.append((q, tmpl_seq, runs, cfg.memsc.kmer_size))
                    owners.append((st, idx))
        with profiling.trace("cns/align_wave"):
            alns = anchored_align_many(tasks, cfg.align, device=device)
        by_state: dict[int, dict[int, object]] = {}
        for (st, idx), aln in zip(owners, alns):
            by_state.setdefault(id(st), {})[idx] = aln
        with profiling.trace("cns/admission"):
            _admit(pending, by_state, read_lists, ccfg, min_ident)
        pending = [st for st in pending if not st.done()]

    # consensus DP per template (host, tiny)
    out: list[list[GroupRead]] = [[] for _ in read_lists]
    with profiling.trace("cns/finish"):
        for st in states:
            r = _finish_template(read_lists[st.g][st.i], st, ccfg)
            if r is not None:
                out[st.g].append(r)
    return out


def _admit(pending, by_state, read_lists, ccfg, min_ident):
    """Reference-order admission replay over one wave's alignments
    (`correct_one_sv_read`'s coverage-capped accumulation)."""
    for st in pending:
        got = by_state.get(id(st), {})
        tmpl_seq = read_lists[st.g][st.i].seq
        while st.pos < len(st.cands) and not st.full:
            if st.pos not in got:
                break
            j, chain, sdir, q = st.cands[st.pos]
            aln = got[st.pos]
            st.pos += 1
            sb, se = chain.sbeg, chain.send
            if (j >= ccfg.max_cns_cov
                    and (st.cov[sb:se] >= ccfg.max_cns_cov).all()):
                continue
            if aln is None or len(aln.ops) == 0:
                continue
            mm = match_mask(aln.ops, q, tmpl_seq, aln.qb, aln.sb)
            pid = 100.0 * mm.sum() / len(aln.ops)
            if pid < min_ident:
                continue
            st.cov[aln.sb : aln.se] += 1
            st.num_added += 1
            st.tags.append(tags_from_ops(aln.ops, q, aln.qb, aln.sb))
            if (st.num_added >= ccfg.max_cns_cov
                    and (st.cov >= ccfg.max_cns_cov).all()):
                st.full = True


def _finish_template(src: GroupRead, st: _TemplateState,
                     ccfg) -> GroupRead | None:
    template = src.seq
    T = len(template)
    # longest >= min_cov covered segment
    ok = st.cov >= ccfg.min_cov
    frm = to = 0
    best_len = 0
    i = 0
    while i < T:
        if not ok[i]:
            i += 1
            continue
        j = i
        while j < T and ok[j]:
            j += 1
        if j - i > best_len:
            best_len, frm, to = j - i, i, j
        i = j
    if best_len < ccfg.min_size:
        return None
    tags = (np.concatenate(st.tags) if st.tags
            else np.empty((0, 6), np.int32))
    if len(tags) == 0:
        return None
    weights = np.full(len(tags), ccfg.cns_weight)
    full_cov = coverage_from_tags(tags, T)
    cns_seq, frm2, to2 = consensus_from_tags(
        tags, weights, full_cov, frm, to, ccfg.indel_cov_factor)
    if len(cns_seq) < ccfg.min_size:
        return None
    new_seq = np.concatenate([template[:frm2], cns_seq, template[to2:]])
    return GroupRead(
        global_id=src.global_id, name=src.name, seq=new_seq,
        raw_seq_from=frm2, raw_seq_to=frm2 + len(cns_seq),
        fsqdir=src.fsqdir, fsfrom=src.fsfrom, fsto=src.fsto,
    )


def cns_groups(
    groups: list[SvGroup],
    qstore: SeqStore,
    cfg: LesvConfig | None = None,
    device="cuda",
) -> list[CorrectedRead]:
    """Two consensus rounds over ALL groups, globally batched."""
    cfg = cfg or LesvConfig()
    read_lists = [_group_reads(g, qstore) for g in groups]
    round1 = _run_round(read_lists, cfg, cfg.cns.cns1_perc_identity, device)
    round2 = _run_round(round1, cfg, cfg.cns.cns2_perc_identity, device)
    out: list[CorrectedRead] = []
    for g, group in enumerate(groups):
        for r in round2[g]:
            out.append(CorrectedRead(
                global_id=r.global_id, name=r.name, seq=r.seq,
                cns_from=r.raw_seq_from, cns_to=r.raw_seq_to,
                fsqdir=r.fsqdir, subject_id=group.subject_id,
                fsfrom=r.fsfrom, fsto=r.fsto,
                group_id=group.group_id, kind=group.kind,
            ))
    return out
