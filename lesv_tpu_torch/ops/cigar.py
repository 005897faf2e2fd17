"""Operations on alignment op arrays: runs, identity metrics, trimming,
SV-signature scans.

Implements the reference's alignment-string analytics on compact op/match
arrays instead of per-character strings:

* raw identity (`calc_ident_perc`, hbn_traceback_aux.c:3-19)
* effective identity — gap runs >= 20 excluded (`calc_effective_ident_perc`,
  hbn_traceback_aux.c:21-95): the key SV-aware metric
* end trimming back to an 8bp exact match (`truncate_align_bad_ends`,
  hbn_traceback.c:547-605)
* gap-run scan for INS/DEL signatures (`find_sv_signature`,
  find_sv_signature.c:125-219)

All functions are vectorized numpy; the same logic exists as jnp in the
device pipeline where needed.
"""

from __future__ import annotations

import numpy as np

from lesv_tpu_torch.ops.align_np import OP_D, OP_I, OP_M, Alignment


def op_runs(ops: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Run-length encode: (op, run_len) arrays."""
    n = len(ops)
    if n == 0:
        return np.empty(0, np.uint8), np.empty(0, np.int64)
    change = np.empty(n, bool)
    change[0] = True
    np.not_equal(ops[1:], ops[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    lens = np.diff(np.concatenate([starts, [n]]))
    return ops[starts], lens


def match_mask(ops: np.ndarray, q: np.ndarray, s: np.ndarray,
               qb: int, sb: int) -> np.ndarray:
    """Per-column bool: True where op==M and bases equal."""
    qi = qb + np.cumsum(ops != OP_D) - (ops != OP_D)
    si = sb + np.cumsum(ops != OP_I) - (ops != OP_I)
    m = ops == OP_M
    out = np.zeros(len(ops), bool)
    if m.any():
        out[m] = q[qi[m]] == s[si[m]]
    return out


def ident_perc(ops: np.ndarray, q: np.ndarray, s: np.ndarray,
               qb: int, sb: int) -> float:
    """Raw identity percent: matches / alignment columns."""
    n = len(ops)
    if n == 0:
        return 0.0
    return 100.0 * match_mask(ops, q, s, qb, sb).sum() / n


def effective_ident_perc(ops: np.ndarray, q: np.ndarray, s: np.ndarray,
                         qb: int, sb: int, gap_run: int = 20) -> float:
    """Identity excluding long gap runs (>= gap_run columns)."""
    mm = match_mask(ops, q, s, qb, sb)
    opv, lens = op_runs(ops)
    long_gap = (opv != OP_M) & (lens >= gap_run)
    if not long_gap.any():
        eff_len = len(ops)
        eff_mat = int(mm.sum())
    else:
        col_excl = np.repeat(long_gap, lens)
        keep = ~col_excl
        eff_len = int(keep.sum())
        eff_mat = int(mm[keep].sum())
    if eff_len == 0:
        return 0.0
    return 100.0 * eff_mat / eff_len


def trim_to_exact_match(aln: Alignment, q: np.ndarray, s: np.ndarray,
                        mat_len: int = 8) -> Alignment | None:
    """Trim both ends back to the first run of ``mat_len`` consecutive
    matching M columns.  Returns None if no such run exists.

    Mirrors `truncate_align_bad_ends` (hbn_traceback.c:547-605).
    """
    ops = aln.ops
    n = len(ops)
    if n == 0:
        return None
    mm = match_mask(ops, q, s, aln.qb, aln.sb)
    # run of >= mat_len consecutive True
    c = np.zeros(n + 1, np.int64)
    np.cumsum(mm.astype(np.int64), out=c[1:])
    if n >= mat_len:
        win = c[mat_len:] - c[:-mat_len]
        full = np.flatnonzero(win == mat_len)  # start cols of 8-match runs
    else:
        full = np.empty(0, np.int64)
    if len(full) == 0:
        return None
    a = int(full[0])
    b = int(full[-1]) + mat_len  # end (exclusive) of last full-match window
    if a >= b:
        return None
    dq_a = int((ops[:a] != OP_D).sum())
    ds_a = int((ops[:a] != OP_I).sum())
    dq_b = int((ops[b:] != OP_D).sum())
    ds_b = int((ops[b:] != OP_I).sum())
    return Alignment(
        qb=aln.qb + dq_a, qe=aln.qe - dq_b,
        sb=aln.sb + ds_a, se=aln.se - ds_b,
        ops=ops[a:b], score=aln.score,
    )


def scan_indel_signatures(ops: np.ndarray, qb: int, sb: int,
                          min_size: int = 40) -> list[tuple[str, int, int, int]]:
    """Find gap runs >= min_size.

    Returns list of (kind, qpos, spos, length) where positions are the
    query/subject offsets at the start of the run (reference semantics:
    DEL -> sfrom=si, sto=si+n, qfrom=qi, qto=qi+1; INS -> qfrom=qi,
    qto=qi+n, sfrom=si, sto=si+1; find_sv_signature.c:150-214).
    """
    opv, lens = op_runs(ops)
    # query/subject position at the start of each run
    dq = np.where(opv != OP_D, lens, 0)
    ds = np.where(opv != OP_I, lens, 0)
    qpos = qb + np.concatenate([[0], np.cumsum(dq)[:-1]])
    spos = sb + np.concatenate([[0], np.cumsum(ds)[:-1]])
    out = []
    sel = (opv != OP_M) & (lens >= min_size)
    for k in np.flatnonzero(sel):
        kind = "INS" if opv[k] == OP_I else "DEL"
        out.append((kind, int(qpos[k]), int(spos[k]), int(lens[k])))
    return out
