"""Anchored pairwise alignment: chain anchors -> full gapped alignment.

Counterpart of :mod:`lesv_tpu.ops.anchored`: the anchored core of every
task is stitched on the host by ``native.stitch_core`` (sanitize, M/D/I
emission, tiny-gap micro-DP); every larger inter-anchor segment, then
every end-extension block, goes through the port's :func:`align_pairs`
on the given device.  Each result is trimmed back to the 8bp
exact-match invariant by ``_stitch_and_trim``.
"""

from __future__ import annotations

import numpy as np

from lesv_tpu_torch import native as _nat
from lesv_tpu_torch.config import AlignConfig
from lesv_tpu_torch.ops.align_batch import TINY_SEG, align_pairs
from lesv_tpu_torch.ops.align_np import Alignment
from lesv_tpu_torch.ops.cigar import trim_to_exact_match
from lesv_tpu_torch.utils import profiling


def sanitize_anchors(anchors: np.ndarray, k: int) -> np.ndarray:
    """Turn chain anchors into non-overlapping exact runs (qoff, soff, len).

    ``anchors`` is (n, 2) k-mer starts (each of length ``k``) or (n, 3)
    variable-length runs (MEMs from :func:`ops.pairseed.mem_anchors`).
    Same-diagonal overlapping/adjacent anchors merge into one maximal run;
    an anchor overlapping the previous run in either coordinate on a
    different diagonal is dropped (the banded DP resolves the region).
    """
    a = np.asarray(anchors, np.int64)
    if a.size == 0:
        return np.empty((0, 3), np.int64)
    if a.shape[1] == 2:
        a = np.concatenate([a, np.full((len(a), 1), k, np.int64)], axis=1)
    out: list[list[int]] = []
    for qo, so, ln in a:
        if not out:
            out.append([qo, so, ln])
            continue
        pq, ps, pl = out[-1]
        if qo - pq == so - ps:  # same diagonal
            if qo <= pq + pl:   # overlap/adjacent: extend run
                out[-1][2] = max(pl, qo + ln - pq)
                continue
        if qo < pq + pl or so < ps + pl:  # conflicting overlap: drop
            continue
        out.append([qo, so, ln])
    return np.asarray(out, np.int64)


def anchored_align_many(
    tasks: list[tuple[np.ndarray, np.ndarray, np.ndarray, int]],
    cfg: AlignConfig | None = None,
    extend: bool = True,
    device="cuda",
) -> list[Alignment | None]:
    """Align many (q, s, anchors, k) tasks, batching all inter-anchor
    segments (and then all end-extension blocks) across tasks into
    bucketed fills on ``device``."""
    cfg = cfg or AlignConfig()
    n = len(tasks)
    stitched: list[list | None] = []
    seg_pairs: list[tuple[np.ndarray, np.ndarray]] = []
    seg_owner: list[tuple[int, int]] = []
    with profiling.trace("anchored/stitch_native"):
        for ti, (q, s, anchors, k) in enumerate(tasks):
            a = np.asarray(anchors, np.int64)
            if a.size == 0:
                stitched.append(None)
                continue
            if a.shape[1] == 2:
                a = np.concatenate(
                    [a, np.full((len(a), 1), k, np.int64)], axis=1)
            r = _nat.stitch_core(q, s, a, TINY_SEG, cfg.match,
                                 cfg.mismatch, cfg.gap_open1,
                                 cfg.gap_ext1, cfg.gap_open2,
                                 cfg.gap_ext2)
            if r is None:
                stitched.append(None)
                continue
            ops, score, bounds, bigs = r
            for qa, qb2, sa, sb2, pos in bigs:
                seg_pairs.append((q[qa:qb2], s[sa:sb2]))
                seg_owner.append((ti, int(pos)))
            stitched.append([ops, score, bounds, []])
    with profiling.trace("anchored/segments"):
        outs = align_pairs(seg_pairs, cfg, free_end=False, device=device)
    for (ti, pos), a in zip(seg_owner, outs):
        if stitched[ti] is None:
            continue
        if a is None:
            stitched[ti] = None
            continue
        stitched[ti][3].append((pos, a))
    cores: list[Alignment | None] = []
    with profiling.trace("anchored/splice"):
        for st in stitched:
            if st is None:
                cores.append(None)
                continue
            ops, score, (qb, qe, sb, se), inserts = st
            if inserts:
                parts = []
                prev = 0
                for pos, a in sorted(inserts, key=lambda t: t[0]):
                    parts.append(ops[prev:pos])
                    parts.append(a.ops)
                    score += a.score
                    prev = pos
                parts.append(ops[prev:])
                ops = np.concatenate(parts)
            cores.append(Alignment(int(qb), int(qe), int(sb), int(se),
                                   np.ascontiguousarray(ops),
                                   score=int(score)))
    lefts = [Alignment(0, 0, 0, 0, np.empty(0, np.uint8), 0)
             for _ in range(n)]
    rights = [Alignment(0, 0, 0, 0, np.empty(0, np.uint8), 0)
              for _ in range(n)]
    if extend:
        with profiling.trace("anchored/extend_ends"):
            _extend_ends(tasks, cores, lefts, rights, cfg, device)
    with profiling.trace("anchored/stitch_trim"):
        return _stitch_and_trim(tasks, cores, lefts, rights, extend, cfg)


def _extend_ends(tasks, cores, lefts, rights, cfg, device):
    """Blockwise end extension (256, 1024, then 2048 bp blocks), batched
    across tasks per side and iteration; a task continues while its block
    extends to (nearly) its end."""
    BLOCKS = (256, 1024, 2048)
    n = len(tasks)
    for side in ("L", "R"):
        active = [ti for ti in range(n) if cores[ti] is not None]
        cursors = {ti: (0, 0, 0) for ti in active}
        while active:
            batch_pairs = []
            for ti in active:
                q, s, _, _ = tasks[ti]
                core = cores[ti]
                qi, si, it = cursors[ti]
                if side == "L":
                    qt = q[: core.qb][::-1]
                    st = s[: core.sb][::-1]
                else:
                    qt = q[core.qe :]
                    st = s[core.se :]
                block = BLOCKS[min(it, len(BLOCKS) - 1)]
                batch_pairs.append((qt[qi : qi + block],
                                    st[si : si + int(block * 1.25) + 64]))
            exts = align_pairs(batch_pairs, cfg, free_end=True,
                               device=device)
            next_active = []
            for ti, ext, (qb_, _) in zip(active, exts, batch_pairs):
                acc = lefts[ti] if side == "L" else rights[ti]
                qi, si, it = cursors[ti]
                block = BLOCKS[min(it, len(BLOCKS) - 1)]
                if ext is None or len(ext.ops) == 0 or ext.score <= 0:
                    continue
                acc.ops = np.concatenate([acc.ops, ext.ops])
                acc.qe += ext.qe
                acc.se += ext.se
                acc.score += ext.score
                cursors[ti] = (qi + ext.qe, si + ext.se, it + 1)
                if ext.qe >= len(qb_) - 8 and len(qb_) == block:
                    next_active.append(ti)
            active = next_active


def _stitch_and_trim(tasks, cores, lefts, rights, extend, cfg):
    n = len(tasks)
    out: list[Alignment | None] = []
    for ti in range(n):
        core = cores[ti]
        if core is None:
            out.append(None)
            continue
        q, s, _, _ = tasks[ti]
        parts = []
        qb, qe, sb, se = core.qb, core.qe, core.sb, core.se
        score = core.score
        left, right = lefts[ti], rights[ti]
        if extend and len(left.ops):
            parts.append(left.ops[::-1])
            qb -= left.qe
            sb -= left.se
            score += left.score
        parts.append(core.ops)
        if extend and len(right.ops):
            parts.append(right.ops)
            qe += right.qe
            se += right.se
            score += right.score
        aln = Alignment(qb, qe, sb, se, np.concatenate(parts), score=score)
        out.append(trim_to_exact_match(aln, q, s, cfg.end_match_len))
    return out


def anchored_extend(
    q: np.ndarray,
    s: np.ndarray,
    anchors: np.ndarray,
    k: int,
    cfg: AlignConfig | None = None,
    extend: bool = True,
    *,
    device,
) -> Alignment | None:
    """Full pairwise alignment: stitch anchors, extend to both ends, trim.

    ``s`` may be a window of a larger subject; anchors are in the
    coordinates of ``q``/``s`` as given.  The result is trimmed so it begins
    and ends with an ``end_match_len`` exact match.
    """
    return anchored_align_many([(q, s, anchors, k)], cfg, extend,
                               device=device)[0]
