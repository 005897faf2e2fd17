"""Anchored pairwise alignment: chain anchors -> full gapped alignment.

Counterpart of :mod:`lesv_tpu.ops.anchored`: the anchored core of every
task is stitched on the host by ``native.stitch_core`` (sanitize, M/D/I
emission, tiny-gap micro-DP); every larger inter-anchor segment, then
every end-extension block, goes through the port's :func:`align_pairs`
on the given device.  Each result is trimmed back to the 8bp
exact-match invariant by the JAX package's host ``_stitch_and_trim``.
"""

from __future__ import annotations

import numpy as np

from lesv_tpu import native as _nat
from lesv_tpu.config import AlignConfig
from lesv_tpu.ops.align_batch import TINY_SEG
from lesv_tpu.ops.align_np import Alignment
from lesv_tpu.ops.anchored import _stitch_and_trim
from lesv_tpu.utils import profiling
from lesv_tpu_torch.ops.align_batch import align_pairs


def anchored_align_many(
    tasks: list[tuple[np.ndarray, np.ndarray, np.ndarray, int]],
    cfg: AlignConfig | None = None,
    extend: bool = True,
    device="cpu",
) -> list[Alignment | None]:
    """Align many (q, s, anchors, k) tasks, batching all inter-anchor
    segments (and then all end-extension blocks) across tasks into
    bucketed fills on ``device``."""
    cfg = cfg or AlignConfig()
    if not _nat.available():
        raise RuntimeError("anchored_align_many needs the native host "
                           "library (lesv_tpu/native, built with make)")
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
