"""Batched pair seeding as torch ops.

Counterpart of :mod:`lesv_tpu.ops.pairseed_jax`: all k-mer matches of a
batch of (query, subject-window) pairs -- query k-mers at ``q_stride``,
subject k-mers at stride 1, occupancy caps scount, qcount and
scount * qcount <= max_occ (``init_hit_finder.c:133-205``) -- expanded
into budgeted (qoff, soff, valid, total) slots in the slot order of
``pairseed_jax._pair_seed_kernel``.  The JAX merge-join by variadic sorts
becomes a stable ``torch.sort`` of the subject hashes plus
``torch.searchsorted`` group bounds.
"""

from __future__ import annotations

import numpy as np
import torch

from lesv_tpu_torch.ops.seeding_torch import (
    QOFF_INVALID,
    SOFF_INVALID,
    _hash_kmers,
)

_BIG = 1 << 62      # sorts after every 2k-bit hash


def _pad_pow2_dim(n: int, lo: int = 256) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def pack_codes(codes: np.ndarray):
    """Host-side 2-bit packing of a (B, L) uint8 code batch; L is padded
    to a multiple of 8 with ambiguous codes.  Returns (packed (B, L/4) u8,
    amb (B, L/8) u8 bitmask): the upload shrinks from 1 byte per base to
    0.375.  Ambiguous codes (>= 4) pack as 0 with their bit set."""
    B, L = codes.shape
    if L % 8:
        codes = np.concatenate(
            [codes, np.full((B, 8 - L % 8), 4, np.uint8)], axis=1)
    amb = codes >= 4
    c = np.where(amb, 0, codes).astype(np.uint8)
    b = c.reshape(B, -1, 4)
    packed = (b[:, :, 0] | (b[:, :, 1] << 2)
              | (b[:, :, 2] << 4) | (b[:, :, 3] << 6))
    ambbits = np.packbits(amb, axis=1, bitorder="little")
    return np.ascontiguousarray(packed), np.ascontiguousarray(ambbits)


def unpack_codes(packed: torch.Tensor, amb: torch.Tensor) -> torch.Tensor:
    """Device-side inverse of :func:`pack_codes`: (B, L) uint8 codes."""
    B = packed.shape[0]
    p = packed.to(torch.int32)
    c = torch.stack([p & 3, (p >> 2) & 3, (p >> 4) & 3, (p >> 6) & 3],
                    dim=2).reshape(B, -1)
    a = amb.to(torch.int32)
    bits = torch.stack([(a >> i) & 1 for i in range(8)],
                       dim=2).reshape(B, -1)
    return torch.where(bits == 1, 4, c).to(torch.uint8)


def expand_slots(cnt: torch.Tensor, M: int):
    """Budgeted ragged expansion: per-seed counts -> per-slot owner.

    For (B, nQ) counts, returns (seed_of (B, M) i64, r (B, M) i64, valid
    (B, M) bool, total (B,) i64): slot m of lane b is the r-th item of
    seed ``seed_of[b, m]``; slots past min(total, M) are invalid.  The
    owner is ``searchsorted(cumsum, m, right=True)``."""
    B, nQ = cnt.shape
    dev = cnt.device
    cnt = cnt.to(torch.int64)
    slots = torch.arange(M, dtype=torch.int64, device=dev)[None, :]
    if nQ == 0:
        z = torch.zeros((B, M), dtype=torch.int64, device=dev)
        return z, z, z.bool(), torch.zeros(B, dtype=torch.int64, device=dev)
    cums = cnt.cumsum(1)
    total = cums[:, -1]
    excl = cums - cnt
    seed_of = torch.searchsorted(cums, slots.expand(B, M).contiguous(),
                                 right=True).clamp(max=nQ - 1)
    r = slots - torch.gather(excl, 1, seed_of)
    g_c = torch.gather(cnt, 1, seed_of)
    valid = ((slots < torch.clamp(total, max=M)[:, None])
             & (r >= 0) & (r < g_c))
    return seed_of, r, valid, total


def _pair_seed_kernel(q, s, qlen, slen, k: int, q_stride: int,
                      max_occ: int, M: int):
    """(B, Qb) x (B, Sb) codes -> (qoff (B, M) i32, soff (B, M) i64,
    valid (B, M) bool, total (B,) i64)."""
    B, Qb = q.shape
    Sb = s.shape[1]
    dev = q.device
    qh, qok = _hash_kmers(q.to(torch.int64), k)
    sh, sok = _hash_kmers(s.to(torch.int64), k)
    q_offs = torch.arange(0, Qb - k + 1, q_stride, dtype=torch.int64,
                          device=dev)
    qh = qh[:, q_offs]
    qok = qok[:, q_offs] & (q_offs[None, :] + k <= qlen[:, None])
    s_pos = torch.arange(Sb, dtype=torch.int64, device=dev)
    sok = sok & (s_pos[None, :] + k <= slen[:, None])
    # subject k-mers in hash order (stable: positions ascending within a
    # hash), invalid ones last
    s_sorted, s_order = torch.sort(torch.where(sok, sh, _BIG), dim=1,
                                   stable=True)
    lo = torch.searchsorted(s_sorted, qh)
    scount = torch.searchsorted(s_sorted, qh, right=True) - lo
    # query-side occupancy among the valid query seeds
    q_sorted = torch.sort(torch.where(qok, qh, _BIG), dim=1).values
    qcount = (torch.searchsorted(q_sorted, qh, right=True)
              - torch.searchsorted(q_sorted, qh))
    ok = (qok & (scount > 0) & (qcount <= max_occ) & (scount <= max_occ)
          & (scount * qcount <= max_occ))
    cnt = torch.where(ok, scount, 0)
    seed_of, r, valid, total = expand_slots(cnt, M)
    g_lo = torch.gather(lo, 1, seed_of)
    soff = torch.gather(s_order, 1, (g_lo + r).clamp(0, Sb - 1))
    qoff = q_offs[seed_of]
    soff = torch.where(valid, soff, SOFF_INVALID)
    qoff = torch.where(valid, qoff, QOFF_INVALID).to(torch.int32)
    return qoff, soff, valid, total


def pair_matches_batch(
    pairs: list[tuple[np.ndarray, np.ndarray]],
    k: int = 10,
    q_stride: int = 10,
    max_occ: int = 8,
    M: int = 8192,
    Qb: int | None = None,
    Sb: int | None = None,
    device="cpu",
):
    """k-mer matching of many (query, subject) pairs on ``device``.

    Returns (qoff (B, M) i32, soff (B, M) i64 local offsets, valid (B, M)
    bool) torch tensors and total (B,) numpy; lanes past len(pairs) are
    empty padding."""
    B = 16 if len(pairs) <= 16 else 64
    if len(pairs) > 64:
        B = 1 << int(np.ceil(np.log2(len(pairs))))
    Qb = Qb or _pad_pow2_dim(max((len(q) for q, _ in pairs), default=1))
    Sb = Sb or _pad_pow2_dim(max((len(s) for _, s in pairs), default=1))
    q = np.full((B, Qb), 4, np.uint8)
    s = np.full((B, Sb), 4, np.uint8)
    qlen = np.zeros(B, np.int64)
    slen = np.zeros(B, np.int64)
    for i, (qi, si) in enumerate(pairs):
        q[i, : len(qi)] = qi
        s[i, : len(si)] = si
        qlen[i] = len(qi)
        slen[i] = len(si)
    dev = torch.device(device)

    def up(codes):
        packed, amb = pack_codes(codes)
        return unpack_codes(torch.from_numpy(packed).to(dev),
                            torch.from_numpy(amb).to(dev))[:, : codes.shape[1]]

    qoff, soff, valid, total = _pair_seed_kernel(
        up(q), up(s), torch.from_numpy(qlen).to(dev),
        torch.from_numpy(slen).to(dev), k=k, q_stride=q_stride,
        max_occ=max_occ, M=M)
    return qoff, soff, valid, total.cpu().numpy()
