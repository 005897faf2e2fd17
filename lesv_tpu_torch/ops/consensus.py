"""FALCON-style align-tag consensus (fccns).

Rebuild of `algo/fccns/`: every aligned column of every overlap emits an
AlignTag (t_pos on the template, delta = position within an insertion run,
q_base in {0..3, 4=gap}) with its predecessor column; tags are grouped per
(t_pos, delta, base) into link lists (`build_backbone`, fccns_aux.c:87-112)
and a weighted best-predecessor DP with indel penalty
``indel_cov_factor * coverage[t_pos]`` picks the best base chain
(`consensus_backbone_segment`, fccns_aux.c:128-220).

Tags are produced from op arrays (`tags_from_ops` mirrors
`make_align_tags_from_ovlp`, fccns_align_tag.c:22-120) and the DP is
vectorized with numpy groupbys (one pass over sorted unique columns).
"""

from __future__ import annotations

import numpy as np

from lesv_tpu_torch.ops.align_np import OP_D, OP_I, OP_M

GAP = 4  # q_base code for deletion columns


def tags_from_ops(ops: np.ndarray, q: np.ndarray, qb: int, tb: int,
                  max_delta: int = 65_535) -> np.ndarray:
    """Columns of one overlap as an (n, 6) int32 array:
    (t_pos, delta, q_base, p_t_pos, p_delta, p_q_base).

    q is the oriented query sequence; qb/tb the alignment start offsets.
    The first column's predecessor is (-1, 0, GAP).
    """
    n = len(ops)
    if n == 0:
        return np.empty((0, 6), np.int32)
    isq = ops != OP_D  # consumes query
    ist = ops != OP_I  # consumes template
    qi = qb + np.cumsum(isq) - 1          # query index at column (valid when isq)
    tj = tb + np.cumsum(ist) - 1          # template pos after this column
    # delta: for query-consuming columns, #query chars since last template char
    # compute: jj increments on query char, resets to 0 on template char
    # (reference order: ++jj then reset)
    grp = np.cumsum(ist)                  # insertion-run group id
    # within-run counter of query chars
    jj = np.zeros(n, np.int64)
    csq = np.cumsum(isq)
    # for columns with ist: delta = 0; for I columns in run after template
    # char at run boundary: count of I's so far in run
    run_start = np.concatenate([[0], np.flatnonzero(np.diff(grp)) + 1])
    base_at_run = np.zeros(n, np.int64)
    base_at_run[run_start[1:]] = csq[run_start[1:] - 1]
    base = np.maximum.accumulate(base_at_run)
    jj = np.where(ist, 0, csq - base)
    qbase = np.where(isq, q[np.clip(qi, 0, len(q) - 1)], GAP).astype(np.int32)
    t_pos = np.where(tj >= tb, tj, tb).astype(np.int32)  # first I-cols before any t char
    cols = np.stack([
        t_pos,
        jj.astype(np.int32),
        qbase,
        np.concatenate([[-1], t_pos[:-1]]).astype(np.int32),
        np.concatenate([[0], jj[:-1]]).astype(np.int32),
        np.concatenate([[GAP], qbase[:-1]]).astype(np.int32),
    ], axis=1)
    keep = jj < max_delta
    return cols[keep]


def consensus_from_tags(
    tags: np.ndarray,
    weights: np.ndarray,
    coverage: np.ndarray,
    frm: int,
    to: int,
    indel_cov_factor: float = 0.4,
) -> tuple[np.ndarray, int, int]:
    """Run the backbone DP over tag columns with t_pos in [frm, to).

    Returns (consensus codes, cns_from, cns_to) — cns_from/to are template
    positions bounding the consensus walk (reference semantics).
    """
    sel = (tags[:, 0] >= frm) & (tags[:, 0] < to)
    tags = tags[sel]
    weights = weights[sel]
    if len(tags) == 0:
        return np.empty(0, np.uint8), frm, frm
    # canonical column ids: sort by (t,d,b, pt,pd,pb)
    order = np.lexsort(tuple(tags[:, i] for i in (5, 4, 3, 2, 1, 0)))
    tags = tags[order]
    weights = weights[order]
    # unique (t,d,b) columns
    col_key = tags[:, :3]
    col_change = np.ones(len(tags), bool)
    col_change[1:] = (np.diff(col_key, axis=0) != 0).any(axis=1)
    col_id = np.cumsum(col_change) - 1
    n_cols = int(col_id[-1]) + 1
    col_tdb = col_key[col_change]
    # unique links within columns: (col, pt,pd,pb)
    link_key = tags[:, 3:6]
    link_change = col_change.copy()
    link_change[1:] |= (np.diff(link_key, axis=0) != 0).any(axis=1)
    link_id = np.cumsum(link_change) - 1
    n_links = int(link_id[-1]) + 1
    link_col = col_id[link_change]
    link_ptdb = link_key[link_change]
    link_w = np.zeros(n_links)
    np.add.at(link_w, link_id, weights)

    # map each link's predecessor (pt,pd,pb) to a column id (or -1)
    # columns are sorted by (t,d,b): binary search
    def find_cols(keys: np.ndarray) -> np.ndarray:
        # encode (t,d,b) into a single int64 for searchsorted:
        # t < 2^40, d < 2^16, b < 2^3
        enc = (col_tdb[:, 0].astype(np.int64) << 19) \
            | (col_tdb[:, 1].astype(np.int64) << 3) | col_tdb[:, 2]
        kenc = (keys[:, 0].astype(np.int64) << 19) \
            | (keys[:, 1].astype(np.int64) << 3) | keys[:, 2]
        pos = np.searchsorted(enc, kenc)
        pos_c = np.minimum(pos, len(enc) - 1)
        ok = enc[pos_c] == kenc
        return np.where(ok, pos_c, -1).astype(np.int64)

    pred_col = find_cols(link_ptdb)
    pred_col[link_ptdb[:, 0] < 0] = -1

    # DP over columns in sorted order (predecessors always sort before
    # successors: p_t < t, or p_t == t with p_delta < delta)
    cov_pen = indel_cov_factor * coverage[np.clip(col_tdb[:, 0], 0,
                                                  len(coverage) - 1)]
    # iterate links grouped by column (link_col ascending; predecessors
    # always have a strictly smaller column index)
    from lesv_tpu_torch import native

    score, best_pred = native.fccns_link_dp(link_col, pred_col, link_w,
                                            cov_pen, n_cols)
    g = int(np.argmax(score))
    # traceback (native walk)
    cns_to = int(col_tdb[g, 0]) + 1
    codes, cns_from = native.fccns_walk(g, best_pred, col_tdb[:, 2],
                                        col_tdb[:, 0], GAP)
    return codes, cns_from, cns_to


def coverage_from_tags(tags: np.ndarray, template_size: int) -> np.ndarray:
    """coverage[t] = number of delta==0 tags at t (reference
    build_backbaone_item cov_array update)."""
    cov = np.zeros(template_size, np.int64)
    d0 = tags[tags[:, 1] == 0]
    np.add.at(cov, np.clip(d0[:, 0], 0, template_size - 1), 1)
    return cov
