"""The plain reference that decides ``correct``: numpy only, nothing of the
program.

It judges what the timed path produced by what each answer says, against
the inputs the benchmark made and the truth it planted:

* an M4 record's alignment is re-read column by column against the read
  and the reference: its spans, matches, identity, distance and sizes
  follow from its ops exactly, it begins and ends with 8 exact matches
  (lesv's trim invariant), and its score is re-scored under the stated
  costs (two-piece affine gaps, as ksw2's extd2);
* each read's best record lies on the read's own strand and stretch;
* each read that holds a planted SV whole has a signature of that kind,
  place and length, and each signature lies at a planted SV;
* a corrected read belongs to its group, keeps the group's coordinates,
  and its consensus stretch is the donor's sequence: few of its 15-mers
  are missing from the haplotypes around its locus.
"""

from __future__ import annotations

import bisect

import numpy as np

from benchmark.gen import revcomp

OP_M, OP_I, OP_D = 0, 1, 2
END_MATCH = 8
POS_TOL = 500          # bp between a signature and its planted SV
LEN_TOL = 0.3          # relative length difference allowed
K = 15                 # k-mer of the consensus check


def gap_cost(lens: np.ndarray, costs: dict) -> np.ndarray:
    return np.minimum(costs["gap_open1"] + costs["gap_ext1"] * lens,
                      costs["gap_open2"] + costs["gap_ext2"] * lens)


def read_alignment(ops: np.ndarray, q: np.ndarray, s: np.ndarray, qb: int,
                   sb: int, costs: dict, dtype=np.int64) -> dict | None:
    """Walk the columns of ``ops`` over q[qb:] and s[sb:]: spans, matches,
    the score under ``costs`` (summed in ``dtype``) and whether both ends
    are END_MATCH exact matches.  None where the ops run off either
    sequence."""
    ops = np.asarray(ops, np.uint8)
    n = len(ops)
    on_q = ops != OP_D
    on_s = ops != OP_I
    qspan, sspan = int(on_q.sum()), int(on_s.sum())
    if qb < 0 or sb < 0 or qb + qspan > len(q) or sb + sspan > len(s):
        return None
    qi = qb + np.cumsum(on_q) - on_q
    si = sb + np.cumsum(on_s) - on_s
    m = ops == OP_M
    eq = np.zeros(n, bool)
    eq[m] = q[qi[m]] == s[si[m]]
    n_match = int(eq.sum())
    n_mis = int(m.sum()) - n_match
    gaps = np.flatnonzero(~m)
    cost = 0
    if len(gaps):
        # gap runs: maximal runs of one op kind (I then D are two gaps)
        brk = np.flatnonzero((np.diff(gaps) != 1)
                             | (ops[gaps[1:]] != ops[gaps[:-1]])) + 1
        lens = np.diff(np.concatenate([[0], brk, [len(gaps)]]))
        cost = int(gap_cost(lens.astype(np.int64), costs).sum())
    # a narrower ``dtype`` wraps the sum as its own arithmetic would
    score = np.int64(costs["match"] * n_match - costs["mismatch"] * n_mis
                     - cost).astype(dtype)
    ends = n >= END_MATCH and bool(eq[:END_MATCH].all()) \
        and bool(eq[-END_MATCH:].all())
    return dict(columns=n, qspan=qspan, sspan=sspan, n_match=n_match,
                score=int(score), ends=ends)


def check_m4s(m4s, idents, read_codes: list[np.ndarray], subject,
              costs: dict):
    """(records whose fields disagree with their own ops, the widest gap
    between a record's score and its ops' score, the reads of the former)
    over ``m4s``, whose identities as the mapper gave them are ``idents``.
    ``subject(sid, a, b)`` returns reference bases [a, b)."""
    bad = 0
    widest = 0
    bad_qids = set()
    for m, ident in zip(m4s, idents):
        read = read_codes[m.qid]
        q = read if m.qdir == 0 else revcomp(read)
        ops = m.ops if m.ops is not None else np.empty(0, np.uint8)
        ok = (m.qsize == len(read) and 0 <= m.qoff < m.qend <= m.qsize
              and 0 <= m.soff < m.send <= m.ssize
              and m.ssize == subject.size(m.sid))
        r = None
        if ok:
            s = subject(m.sid, m.soff, m.send)
            r = read_alignment(ops, q, s, m.qoff, 0, costs)
        if r is not None:
            ok = (r["qspan"] == m.qend - m.qoff
                  and r["sspan"] == m.send - m.soff and r["ends"]
                  and m.dist == r["columns"] - r["n_match"]
                  and ident == 100.0 * r["n_match"] / r["columns"])
            widest = max(widest, abs(int(m.score) - r["score"]))
        if not ok or r is None:
            bad += 1
            bad_qids.add(m.qid)
    return bad, widest, bad_qids


def misplaced(m4s, reads) -> int:
    """Reads whose best record (the first of the read's records, which the
    program orders by score) is missing or off the read's strand and
    reference stretch."""
    first: dict[int, object] = {}
    for m in m4s:
        first.setdefault(m.qid, m)
    out = 0
    for qid, rd in enumerate(reads):
        m = first.get(qid)
        if (m is None or m.sid != rd.chrom or m.qdir != rd.strand
                or m.send <= rd.ref_from or m.soff >= rd.ref_to):
            out += 1
    return out


def _near(kind: str, pos: int, length: int, sv) -> bool:
    return (kind == sv.kind and abs(pos - sv.pos) <= POS_TOL
            and abs(length - sv.length) <= max(LEN_TOL * sv.length, 20))


def sv_missed(sigs, reads, truth) -> tuple[int, int]:
    """(reads that hold a planted SV whole, those of them without a
    signature of its kind, place and length)."""
    by_qid: dict[int, list] = {}
    for g in sigs:
        by_qid.setdefault(g.qid, []).append(g)
    held = missed = 0
    for qid, rd in enumerate(reads):
        for k, _, _ in rd.spans:
            sv = truth.svs[k]
            held += 1
            if not any(g.subject_id == sv.chrom
                       and _near(g.kind, g.sfrom, g.length, sv)
                       for g in by_qid.get(qid, [])):
                missed += 1
    return held, missed


def sigs_off_truth(sigs, truth) -> int:
    """Signatures with no planted SV of their kind within POS_TOL."""
    pos: dict[tuple, list] = {}
    for sv in truth.svs:
        pos.setdefault((sv.chrom, sv.kind), []).append(sv.pos)
    for v in pos.values():
        v.sort()
    off = 0
    for g in sigs:
        p = pos.get((g.subject_id, g.kind), [])
        i = bisect.bisect_left(p, g.sfrom - POS_TOL)
        if not (i < len(p) and p[i] <= g.sfrom + POS_TOL):
            off += 1
    return off


def kmer_codes(codes: np.ndarray, k: int = K) -> np.ndarray:
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, np.int64)
    c = codes.astype(np.int64) & 3
    h = np.zeros(n, np.int64)
    for j in range(k):
        h = (h << 2) | c[j: j + n]
    return h


def kmer_miss(seq: np.ndarray, donor: list[np.ndarray]) -> float:
    """Share of ``seq``'s k-mers found on neither strand of any of the
    ``donor`` stretches."""
    ks = kmer_codes(seq)
    if len(ks) == 0:
        return 1.0
    have = np.unique(np.concatenate(
        [kmer_codes(d) for d in donor] + [kmer_codes(revcomp(d))
                                           for d in donor]))
    return float(1.0 - np.isin(ks, have).mean())


def check_corrected(out, groups, read_codes, min_size: int):
    """Corrected reads that do not belong to their group or do not keep
    its coordinates and kind, or whose consensus stretch is shorter than
    ``min_size`` or out of the read."""
    by_gid = {g.group_id: g for g in groups}
    bad = 0
    for r in out:
        g = by_gid.get(r.group_id)
        ok = g is not None and r.kind == g.kind and \
            r.subject_id == g.subject_id
        if ok:
            ok = any(s.qid == r.global_id and s.aln_sb == r.fsfrom
                     and s.aln_se == r.fsto and s.qdir == r.fsqdir
                     for s in g.sigs)
        ok = ok and 0 <= r.cns_from and r.cns_to <= len(r.seq) and \
            r.cns_to - r.cns_from >= min_size and \
            len(r.seq) > 0 and r.global_id < len(read_codes)
        bad += not ok
    return bad
