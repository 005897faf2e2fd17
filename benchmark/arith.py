"""The yardstick's arithmetic: the card's peaks, the least time of the fill
and chain kernels' work, and the union of the device's busy intervals.

Copied from the port's ``chip_smoke.py`` (``HBM_BYTES_S``, ``INT32_OPS_S``,
``FILL_OPS_PER_CELL``, ``CHAIN_OPS_PER_PAIR``, ``bound``, ``fill_bound``,
``busy_time``'s interval union), so that a later change to the program
cannot move the yardstick.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3.
HBM_BYTES_S = 3.35e12
# Derived, not published: 132 SMs x 64 int32 lanes x 1.98 GHz
# (chip_smoke.py's 67e12 / 4).  Both fill widths are held to it, so that
# a change from int32 to int16 state shows as a higher share.
INT32_OPS_S = 67e12 / 4
# One DP cell of the fill recurrence (chip_smoke.py's count): substitution
# 2, diagonal 1, F1/F2 6, E1/E2 6, H 4, band mask 3, extension flags 4,
# source 8, byte packing 8.
FILL_OPS_PER_CELL = 42
# One (seed, predecessor) pair of the chain scan: distances 9, gates 11,
# score 9, running best 5.
CHAIN_OPS_PER_PAIR = 34
# Chain scan traffic per slot: qs 4 + ss 8 + valid 1 bytes in, f/p/v 12 out.
CHAIN_BYTES_PER_SLOT = 25


def least_s(nbytes: float, ops: float) -> float:
    """The least time of the work: the larger of its bytes over the HBM
    rate and its operations over the int32 rate."""
    return max(nbytes / HBM_BYTES_S, ops / INT32_OPS_S)


def fill_work(qlen: np.ndarray, slen: np.ndarray, W: int) -> tuple[int, int]:
    """(bytes, operations) of one banded fill of the live lanes: q and s
    read once, one direction byte per cell of the rows 0..qlen written
    once, 8 bytes of lengths and 13 of results per lane;
    FILL_OPS_PER_CELL per cell of the rows 1..qlen."""
    qlen = np.asarray(qlen, np.int64)
    slen = np.asarray(slen, np.int64)
    live = qlen > 0
    rows = int(qlen[live].sum())
    B = int(live.sum())
    nbytes = rows + int(slen[live].sum()) + 8 * B + (rows + B) * W + 13 * B
    return nbytes, rows * W * FILL_OPS_PER_CELL


def chain_work(B: int, M: int, J: int, valid: int) -> tuple[int, int]:
    """(bytes, operations) of one chain scan: every slot's traffic, J
    predecessors scored for each valid seed."""
    return B * M * CHAIN_BYTES_PER_SLOT, valid * J * CHAIN_OPS_PER_PAIR


def union_s(spans: list[tuple[float, float]]) -> float:
    """Length of the union of [a, b) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def idle_gaps(spans: list[tuple[float, float]], lo: float,
              hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi) that no interval of ``spans`` covers."""
    out = []
    cur = lo
    for a, b in sorted(spans):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]
