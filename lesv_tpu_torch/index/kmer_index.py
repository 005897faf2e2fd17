"""Reference k-mer index.

TPU-native rebuild of the reference lookup table (`algo/lookup_table.c`):
k-mers sampled at ``kmer_window`` stride over the 2-bit packed subject,
sorted by hash, k-mers occurring more than ``max_kmer_occ`` times dropped,
stored as a sorted distinct-hash array + a position list grouped by hash
(lookup by binary search / merge join — not a direct-address table).

The build is host-side vectorized numpy (replaces the reference's
multithreaded radix sort, `algo/hash_list_bucket_sort.c`); the resulting
arrays are plain device-transferable tensors, replicated per host
(SURVEY.md §2.6).

Hash definition: MSB-first 2-bit pack of the k-mer,
``hash = sum(code[i] << 2*(k-1-i))``, int64 on the host; the device path
(ops.seeding_jax) splits it into two int32 limbs (lo = 19 bits, hi the
rest), supporting any k <= 25 — including the ultra-long preset's k=19
(`README.md:149-172`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lesv_tpu_torch.config import IndexConfig
from lesv_tpu_torch.io.seqstore import SeqStore


def kmer_hashes(codes: np.ndarray, k: int, stride: int = 1,
                start: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Hashes of k-mers of ``codes`` at ``start + i*stride``.

    Returns (offsets, hashes); k-mers containing ambiguous bases (code >= 4)
    get hash -1 (callers must mask them out).
    """
    n = len(codes)
    if n < k:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    offs = np.arange(start, n - k + 1, stride, dtype=np.int64)
    h = np.zeros(len(offs), dtype=np.int64)
    valid = np.ones(len(offs), dtype=bool)
    codes = np.ascontiguousarray(codes, np.uint8)
    buf = np.empty(len(offs), dtype=np.int64)
    for j in range(k):
        np.add(offs, j, out=buf)
        cj = codes[buf]                 # uint8 gather (no i64 blowup)
        valid &= cj < 4
        np.left_shift(h, 2, out=h)
        # codes are 0..4; the ambiguous code 4 must contribute 0 bits
        # (4 & 3 == 0), matching where(cj < 4, cj, 0)
        h |= (cj & 3)
    h[~valid] = -1
    return offs, h


@dataclass
class KmerIndex:
    """Sorted-hash k-mer index over a subject SeqStore."""

    k: int
    window: int
    # sorted distinct hashes that survived the occupancy filter
    uniq_hash: np.ndarray   # int64 (values < 2^(2k)), sorted ascending
    # positions grouped by hash: positions[start[i]:start[i+1]] belong to
    # uniq_hash[i]; global subject offsets, ascending within a group
    start: np.ndarray       # int64, len = len(uniq_hash) + 1
    positions: np.ndarray   # uint32 global subject offsets
    subject_starts: np.ndarray  # int64 per-subject global start offsets

    @classmethod
    def build(cls, store: SeqStore, cfg: IndexConfig | None = None,
              sid_range: tuple[int, int] | None = None) -> "KmerIndex":
        """Build over all subjects, or over subject ids [lo, hi) when
        ``sid_range`` is given (one reference *volume*,
        `app/hbndb/makehbndb.c:20-26`): positions and subject_starts are
        then volume-local (rebased to store.starts[lo]), bounding both
        RSS and the uint32 position range to the volume size."""
        cfg = cfg or IndexConfig()
        k, w, max_occ = cfg.kmer_size, cfg.kmer_window, cfg.max_kmer_occ
        from lesv_tpu_torch import native

        lo, hi = sid_range if sid_range else (0, store.num_seqs)
        base = int(store.starts[lo])
        all_h: list[np.ndarray] = []
        all_p: list[np.ndarray] = []
        for sid in range(lo, hi):
            codes = store.get(sid)
            hv, pv = native.kmer_scan(codes, k, w,
                                      int(store.starts[sid]) - base)
            all_h.append(hv)
            all_p.append(pv)
        h = np.concatenate(all_h) if all_h else np.empty(0, np.int64)
        p = np.concatenate(all_p) if all_p else np.empty(0, np.uint32)
        del all_h, all_p
        # sort by (hash, position): p is globally ascending here (subjects
        # appended in start order, offsets ascending within each), so a
        # STABLE sort by hash alone leaves positions ascending per group.
        native.radix_sort_hash_pos(h, p, nbits=2 * k)
        # group by hash; drop hashes with occupancy > max_occ
        uniq, start, counts = _run_lengths(h)
        keep = counts <= max_occ
        uniq_k = uniq[keep]
        counts_k = counts[keep]
        # compact the position list
        if not keep.all():
            p = p[np.repeat(keep, counts)]
        new_start = np.zeros(len(uniq_k) + 1, dtype=np.int64)
        np.cumsum(counts_k, out=new_start[1:])
        return cls(k=k, window=w, uniq_hash=uniq_k, start=new_start,
                   positions=p,
                   subject_starts=store.starts[lo : hi + 1] - base)

    @property
    def num_kmers(self) -> int:
        return len(self.uniq_hash)

    @property
    def num_positions(self) -> int:
        return len(self.positions)

    def lookup_np(self, hashes: np.ndarray):
        """Host lookup: for each query hash, (found, start, count)."""
        idx = np.searchsorted(self.uniq_hash, hashes)
        idx_c = np.minimum(idx, len(self.uniq_hash) - 1) if len(self.uniq_hash) else idx * 0
        found = (len(self.uniq_hash) > 0) & (self.uniq_hash[idx_c] == hashes) & (hashes >= 0)
        s = self.start[idx_c]
        c = self.start[idx_c + 1] - s
        return found, np.where(found, s, 0), np.where(found, c, 0)

    def global_to_local(self, gpos: np.ndarray):
        """Global subject offsets -> (sid, local offset)."""
        sid = np.searchsorted(self.subject_starts, gpos, side="right") - 1
        return sid, gpos - self.subject_starts[sid]


def _run_lengths(sorted_vals: np.ndarray):
    """(uniq, start, count) of runs in a sorted array."""
    n = len(sorted_vals)
    if n == 0:
        z = np.empty(0, np.int64)
        return z, z.copy(), z.copy()
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(sorted_vals[1:], sorted_vals[:-1], out=change[1:])
    start = np.flatnonzero(change).astype(np.int64)
    uniq = sorted_vals[start]
    count = np.diff(np.concatenate([start, [n]]))
    return uniq, start, count


def _expand_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate [s, s+c) ranges into one index array (vectorized)."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    out = np.ones(total, dtype=np.int64)
    heads = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    out[heads] = starts
    out[heads[1:]] -= starts[:-1] + counts[:-1] - 1
    return np.cumsum(out)
