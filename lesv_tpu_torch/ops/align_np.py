"""Alignment engine — host (numpy) oracle.

Replaces the reference's edlib/ksw2/DALIGNER stack (`algo/edlib*.c`,
`algo/ksw2_*.c`, `algo/hbn_traceback.c`) with one model: banded dual-affine
gap DP (ksw2-extd2 scoring: match 2, mismatch -5, gaps 5+4k || 56+1k,
`ksw2_wrapper.c:72-95`).

The device version (:mod:`lesv_tpu.ops.align_jax`) implements the identical
recurrences with batched row scans; tests compare the two cell-for-cell.

Op codes: 0 = M (match/mismatch, consumes both), 1 = I (consumes query),
2 = D (consumes subject).  All APIs return op run arrays; alignment strings
exist only for tests/debugging.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lesv_tpu_torch.config import AlignConfig

NEG = -(10**9)

OP_M, OP_I, OP_D = 0, 1, 2


@dataclass
class Alignment:
    """A gapped alignment of q[qb:qe) to s[sb:se)."""

    qb: int
    qe: int
    sb: int
    se: int
    ops: np.ndarray  # uint8 op codes, len = alignment columns
    score: int = 0

    def validate(self, q: np.ndarray, s: np.ndarray) -> None:
        """Reference `validate_aligned_string`: ops must consume exactly
        q[qb:qe) and s[sb:se)."""
        nq = int((self.ops != OP_D).sum())
        ns = int((self.ops != OP_I).sum())
        assert self.qe - self.qb == nq, (self.qb, self.qe, nq)
        assert self.se - self.sb == ns, (self.sb, self.se, ns)


def expand_ops(ops: np.ndarray, q: np.ndarray, s: np.ndarray,
               qb: int, sb: int) -> tuple[str, str]:
    """Alignment strings (query row, subject row) with '-' for gaps."""
    from lesv_tpu_torch.io.fasta import decode_seq

    qi, si = qb, sb
    qs, ss = [], []
    for op in ops:
        if op == OP_M:
            qs.append(q[qi]); ss.append(s[si]); qi += 1; si += 1
        elif op == OP_I:
            qs.append(q[qi]); ss.append(255); qi += 1
        else:
            qs.append(255); ss.append(s[si]); si += 1
    dq = "".join("-" if c == 255 else decode_seq(np.array([c], np.uint8)) for c in qs)
    ds = "".join("-" if c == 255 else decode_seq(np.array([c], np.uint8)) for c in ss)
    return dq, ds


# ---------------------------------------------------------------------------
# brute-force global dual-affine aligner (gold standard for tests)
# ---------------------------------------------------------------------------

def global_align_bruteforce(q: np.ndarray, s: np.ndarray,
                            cfg: AlignConfig | None = None) -> Alignment:
    """O(QS) full-matrix dual-affine global alignment with traceback."""
    cfg = cfg or AlignConfig()
    Q, S = len(q), len(s)
    go1, ge1, go2, ge2 = cfg.gap_open1, cfg.gap_ext1, cfg.gap_open2, cfg.gap_ext2
    H = np.full((Q + 1, S + 1), NEG, np.int64)
    E1 = np.full((Q + 1, S + 1), NEG, np.int64)  # gap in query (D)
    E2 = np.full((Q + 1, S + 1), NEG, np.int64)
    F1 = np.full((Q + 1, S + 1), NEG, np.int64)  # gap in subject (I)
    F2 = np.full((Q + 1, S + 1), NEG, np.int64)
    H[0, 0] = 0
    for j in range(1, S + 1):
        E1[0, j] = max(H[0, j - 1] - go1 - ge1, E1[0, j - 1] - ge1)
        E2[0, j] = max(H[0, j - 1] - go2 - ge2, E2[0, j - 1] - ge2)
        H[0, j] = max(E1[0, j], E2[0, j])
    for i in range(1, Q + 1):
        F1[i, 0] = max(H[i - 1, 0] - go1 - ge1, F1[i - 1, 0] - ge1)
        F2[i, 0] = max(H[i - 1, 0] - go2 - ge2, F2[i - 1, 0] - ge2)
        H[i, 0] = max(F1[i, 0], F2[i, 0])
        for j in range(1, S + 1):
            sub = cfg.match if q[i - 1] == s[j - 1] else -cfg.mismatch
            E1[i, j] = max(H[i, j - 1] - go1 - ge1, E1[i, j - 1] - ge1)
            E2[i, j] = max(H[i, j - 1] - go2 - ge2, E2[i, j - 1] - ge2)
            F1[i, j] = max(H[i - 1, j] - go1 - ge1, F1[i - 1, j] - ge1)
            F2[i, j] = max(H[i - 1, j] - go2 - ge2, F2[i - 1, j] - ge2)
            H[i, j] = max(H[i - 1, j - 1] + sub, E1[i, j], E2[i, j],
                          F1[i, j], F2[i, j])
    # traceback
    ops = []
    i, j = Q, S
    state = "H"
    while i > 0 or j > 0:
        if state == "H":
            h = H[i, j]
            if i > 0 and j > 0 and h == H[i - 1, j - 1] + (
                    cfg.match if q[i - 1] == s[j - 1] else -cfg.mismatch):
                ops.append(OP_M); i -= 1; j -= 1
            elif h == E1[i, j]:
                state = "E1"
            elif h == E2[i, j]:
                state = "E2"
            elif h == F1[i, j]:
                state = "F1"
            else:
                state = "F2"
        elif state in ("E1", "E2"):
            go, ge, E = (go1, ge1, E1) if state == "E1" else (go2, ge2, E2)
            ops.append(OP_D)
            if E[i, j] == H[i, j - 1] - go - ge:
                state = "H"
            j -= 1
        else:
            go, ge, F = (go1, ge1, F1) if state == "F1" else (go2, ge2, F2)
            ops.append(OP_I)
            if F[i, j] == H[i - 1, j] - go - ge:
                state = "H"
            i -= 1
    ops = np.array(ops[::-1], dtype=np.uint8)
    return Alignment(0, Q, 0, S, ops, score=int(H[Q, S]))


# ---------------------------------------------------------------------------
# banded global aligner with per-row guide (the production algorithm)
# ---------------------------------------------------------------------------

def banded_global_align(q: np.ndarray, s: np.ndarray, band: int,
                        guide: np.ndarray | None = None,
                        cfg: AlignConfig | None = None) -> Alignment | None:
    """Banded dual-affine global alignment with traceback.

    Row i's band covers subject columns [guide[i], guide[i] + band); guide
    defaults to the linear interpolation of (0,0)->(Q,S).  This is the exact
    algorithm of the device kernel: within-row gap dependencies are resolved
    with running maxima over (value + j*ge), direction flags are re-derived
    by comparison (see align_jax).

    Returns None when the optimum leaves the band (end cell unreachable).
    """
    cfg = cfg or AlignConfig()
    Q, S = len(q), len(s)
    go1, ge1, go2, ge2 = cfg.gap_open1, cfg.gap_ext1, cfg.gap_open2, cfg.gap_ext2
    W = min(band, S + 1)
    if guide is None:
        guide = np.minimum(
            np.maximum((np.arange(Q + 1) * S) // max(Q, 1) - W // 2, 0),
            S + 1 - W)
    guide = np.asarray(guide, dtype=np.int64)

    # band rows: H[i] covers j = guide[i] + b for b in [0, W)
    Hrow = np.full(W, NEG, np.int64)
    E1row = np.full(W, NEG, np.int64)
    E2row = np.full(W, NEG, np.int64)
    F1row = np.full(W, NEG, np.int64)
    F2row = np.full(W, NEG, np.int64)
    # dir byte layout: bits 0-2 Hsrc (0=diag,1=E1,2=E2,3=F1,4=F2),
    # bit 3 E1ext, bit 4 E2ext, bit 5 F1ext, bit 6 F2ext
    dirs = np.zeros((Q + 1, W), np.uint8)

    js = guide[0] + np.arange(W)
    inb = js <= S
    # row 0: leading subject gaps
    with np.errstate(over="ignore"):
        E1row = np.where(js > 0, -go1 - js * ge1, NEG)
        E2row = np.where(js > 0, -go2 - js * ge2, NEG)
        Hrow = np.where(js == 0, 0, np.maximum(E1row, E2row))
        Hrow = np.where(inb, Hrow, NEG)
        E1row = np.where(inb, E1row, NEG)
        E2row = np.where(inb, E2row, NEG)
    d0 = np.zeros(W, np.uint8)
    d0 |= np.where(E1row >= E2row, 1, 2).astype(np.uint8)
    d0 |= 0x08  # E1 ext within row 0
    d0 |= 0x10
    dirs[0] = d0

    def shifted(row, d):
        """prev-row value at band position b+d (same absolute j+offset)."""
        out = np.full(W, NEG, np.int64)
        if d >= W:
            return out
        if d >= 0:
            out[: W - d if d else W] = row[d:] if d else row
        else:
            out[-d:] = row[: W + d]
        return out

    for i in range(1, Q + 1):
        d = int(guide[i] - guide[i - 1])
        js = guide[i] + np.arange(W)
        inb = js <= S
        Hd = shifted(Hrow, d - 1)   # H[i-1, j-1]
        Hu = shifted(Hrow, d)       # H[i-1, j]
        F1u = shifted(F1row, d)
        F2u = shifted(F2row, d)
        qc = q[i - 1]
        sj = np.where((js >= 1) & (js <= S), s[np.clip(js - 1, 0, S - 1)], 255)
        sub = np.where(sj == qc, cfg.match, -cfg.mismatch).astype(np.int64)
        diag = np.where(js >= 1, Hd + sub, NEG)
        # j == 0 diag means aligning q[i-1] before any subject: invalid
        F1row = np.maximum(Hu - go1 - ge1, F1u - ge1)
        F2row = np.maximum(Hu - go2 - ge2, F2u - ge2)
        F1ext = F1row == F1u - ge1
        F2ext = F2row == F2u - ge2
        Hpre = np.maximum(diag, np.maximum(F1row, F2row))
        # within-row E via running max of Hpre + j*ge
        E1row = _row_gap(Hpre, js, go1, ge1, W)
        E2row = _row_gap(Hpre, js, go2, ge2, W)
        E1ext = np.empty(W, bool)
        E1ext[0] = True
        E1ext[1:] = E1row[1:] == E1row[:-1] - ge1
        E2ext = np.empty(W, bool)
        E2ext[0] = True
        E2ext[1:] = E2row[1:] == E2row[:-1] - ge2
        Hrow = np.maximum(Hpre, np.maximum(E1row, E2row))
        Hrow = np.where(inb, Hrow, NEG)
        src = np.zeros(W, np.uint8)  # 0 = diag
        src = np.where(Hrow == diag, 0,
              np.where(Hrow == E1row, 1,
              np.where(Hrow == E2row, 2,
              np.where(Hrow == F1row, 3, 4)))).astype(np.uint8)
        dirs[i] = (src | (E1ext << 3) | (E2ext << 4)
                   | (F1ext << 5) | (F2ext << 6)).astype(np.uint8)

    # end cell
    bS = S - guide[Q]
    if bS < 0 or bS >= W or Hrow[bS] <= NEG // 2:
        return None
    score = int(Hrow[bS])

    # traceback over dir bytes
    ops = []
    i, b = Q, int(bS)
    state = 0  # 0=H, 1=E1, 2=E2, 3=F1, 4=F2
    while i > 0 or guide[i] + b > 0:
        byte = int(dirs[i, b])
        if state == 0:
            state = byte & 7
            if state == 0:
                ops.append(OP_M)
                d = int(guide[i] - guide[i - 1]) if i > 0 else 0
                i -= 1
                b = b + d - 1
        elif state in (1, 2):
            ops.append(OP_D)
            ext = byte & (0x08 if state == 1 else 0x10)
            b -= 1
            if not ext:
                state = 0
        else:
            ops.append(OP_I)
            ext = byte & (0x20 if state == 3 else 0x40)
            d = int(guide[i] - guide[i - 1])
            i -= 1
            b = b + d
            if not ext:
                state = 0
        if b < 0 or b >= W or i < 0:
            return None  # traceback left the band: caller must widen
    ops = np.array(ops[::-1], dtype=np.uint8)
    return Alignment(0, Q, 0, S, ops, score=score)


def extension_align(q: np.ndarray, s: np.ndarray, band: int,
                    cfg: AlignConfig | None = None) -> Alignment | None:
    """Extension alignment from (0,0): best-scoring path to any (i, j).

    The oracle for the blockwise end-extension (reference
    `edlib_extend` / `left_extend/right_extend`, hbn_traceback.c:211-310):
    fill the banded DP, find the best-scoring cell, trace back to the
    origin.  Returns an Alignment with qe/se at the best cell.
    """
    cfg = cfg or AlignConfig()
    Q, S = len(q), len(s)
    if Q == 0 or S == 0:
        return Alignment(0, 0, 0, 0, np.empty(0, np.uint8), 0)
    go1, ge1, go2, ge2 = cfg.gap_open1, cfg.gap_ext1, cfg.gap_open2, cfg.gap_ext2
    W = min(band, S + 1)
    # extension paths run near the main diagonal (slope 1), regardless of
    # how much longer the subject window is
    guide = np.minimum(np.maximum(np.arange(Q + 1) - W // 2, 0), S + 1 - W)

    Hrow = np.full(W, NEG, np.int64)
    E1row = np.full(W, NEG, np.int64)
    E2row = np.full(W, NEG, np.int64)
    F1row = np.full(W, NEG, np.int64)
    F2row = np.full(W, NEG, np.int64)
    dirs = np.zeros((Q + 1, W), np.uint8)

    js = guide[0] + np.arange(W)
    E1row = np.where(js > 0, -go1 - js * ge1, NEG)
    E2row = np.where(js > 0, -go2 - js * ge2, NEG)
    Hrow = np.where(js == 0, 0, np.maximum(E1row, E2row))
    Hrow = np.where(js <= S, Hrow, NEG)
    d0 = np.where(E1row >= E2row, 1, 2).astype(np.uint8) | 0x18
    dirs[0] = d0

    best = (int(Hrow[0]), 0, 0)  # (score, i, b)

    def shifted(row, d):
        out = np.full(W, NEG, np.int64)
        if d >= W:
            return out
        if d >= 0:
            out[: W - d if d else W] = row[d:] if d else row
        else:
            out[-d:] = row[: W + d]
        return out

    for i in range(1, Q + 1):
        d = int(guide[i] - guide[i - 1])
        js = guide[i] + np.arange(W)
        inb = js <= S
        Hd = shifted(Hrow, d - 1)
        Hu = shifted(Hrow, d)
        F1u = shifted(F1row, d)
        F2u = shifted(F2row, d)
        qc = q[i - 1]
        sj = np.where((js >= 1) & (js <= S), s[np.clip(js - 1, 0, S - 1)], 255)
        sub = np.where(sj == qc, cfg.match, -cfg.mismatch).astype(np.int64)
        diag = np.where(js >= 1, Hd + sub, NEG)
        F1row = np.maximum(Hu - go1 - ge1, F1u - ge1)
        F2row = np.maximum(Hu - go2 - ge2, F2u - ge2)
        F1ext = F1row == F1u - ge1
        F2ext = F2row == F2u - ge2
        Hpre = np.maximum(diag, np.maximum(F1row, F2row))
        E1row = _row_gap(Hpre, js, go1, ge1, W)
        E2row = _row_gap(Hpre, js, go2, ge2, W)
        E1ext = np.empty(W, bool)
        E1ext[0] = True
        E1ext[1:] = E1row[1:] == E1row[:-1] - ge1
        E2ext = np.empty(W, bool)
        E2ext[0] = True
        E2ext[1:] = E2row[1:] == E2row[:-1] - ge2
        Hrow = np.maximum(Hpre, np.maximum(E1row, E2row))
        Hrow = np.where(inb, Hrow, NEG)
        src = np.where(Hrow == diag, 0,
              np.where(Hrow == E1row, 1,
              np.where(Hrow == E2row, 2,
              np.where(Hrow == F1row, 3, 4)))).astype(np.uint8)
        dirs[i] = (src | (E1ext << 3) | (E2ext << 4)
                   | (F1ext << 5) | (F2ext << 6)).astype(np.uint8)
        bmax = int(np.argmax(Hrow))
        if int(Hrow[bmax]) > best[0]:
            best = (int(Hrow[bmax]), i, bmax)

    score, iE, bE = best
    if score <= NEG // 2:
        return None
    ops = []
    i, b = iE, bE
    state = 0
    while i > 0 or guide[i] + b > 0:
        byte = int(dirs[i, b])
        if state == 0:
            state = byte & 7
            if state == 0:
                ops.append(OP_M)
                d = int(guide[i] - guide[i - 1]) if i > 0 else 0
                i -= 1
                b = b + d - 1
        elif state in (1, 2):
            ops.append(OP_D)
            ext = byte & (0x08 if state == 1 else 0x10)
            b -= 1
            if not ext:
                state = 0
        else:
            ops.append(OP_I)
            ext = byte & (0x20 if state == 3 else 0x40)
            d = int(guide[i] - guide[i - 1])
            i -= 1
            b = b + d
            if not ext:
                state = 0
        if b < 0 or b >= W or i < 0:
            return None
    ops = np.array(ops[::-1], dtype=np.uint8)
    return Alignment(0, iE, 0, int(guide[iE] + bE), ops, score=score)


def _row_gap(Hpre: np.ndarray, js: np.ndarray, go: int, ge: int, W: int) -> np.ndarray:
    """E[j] = max_{k<j} (Hpre[k] - go - (j-k)*ge) via running max."""
    base = Hpre + js * ge
    run = np.maximum.accumulate(base)
    E = np.full(W, NEG, np.int64)
    E[1:] = run[:-1] - go - js[1:] * ge
    E[E < NEG // 2] = NEG
    return E
