"""Batched reference-index seeding as torch ops.

Counterpart of :mod:`lesv_tpu.ops.seeding_jax`: sampled k-mer hashes of a
padded batch of reads (both strands as separate lanes), looked up in the
sorted k-mer index, expanded into budgeted (qoff, soff, valid, total)
match arrays with the same slot order as ``_seed_match_kernel``.

With k <= 25 a hash fits int64, so the index lookup is one
``torch.searchsorted`` over the sorted distinct hashes; it returns the
same lower bound as the JAX prefix-table + limb binary search, so the
2^18 prefix table is not carried to the device.
"""

from __future__ import annotations

import numpy as np
import torch

from lesv_tpu_torch.config import SeedingConfig
from lesv_tpu_torch.index.kmer_index import KmerIndex
from lesv_tpu_torch.io.fasta import revcomp

QOFF_INVALID = 0x7FFFFFFF
SOFF_INVALID = 0xFFFFFFFF


def sampled_offsets_static(Qmax: int, k: int, window: int,
                           cfg: SeedingConfig) -> np.ndarray:
    """The sampled k-mer offsets of a Qmax-long read (shorter reads mask
    the tail with ``offs + k <= qlen``); see
    ``seeding_jax.sampled_offsets_static``."""
    period = cfg.seeding_seq_size + cfg.seeding_seq_stride
    o = np.arange(Qmax, dtype=np.int64)
    r = o % period
    keep = (r % window == 0) & (r + k <= cfg.seeding_seq_size)
    return o[keep].astype(np.int32)


class DeviceIndex:
    """Device-resident copy of a :class:`KmerIndex`: sorted distinct
    hashes, group starts and grouped positions (int64 tensors; positions
    hold the unsigned 32-bit subject offsets)."""

    def __init__(self, index: KmerIndex, device):
        dev = torch.device(device)
        self.k = index.k
        self.n = len(index.uniq_hash)
        self.device = dev
        self.hash = torch.from_numpy(
            np.ascontiguousarray(index.uniq_hash, np.int64)).to(dev)
        self.start = torch.from_numpy(
            np.ascontiguousarray(index.start, np.int64)).to(dev)
        self.positions = torch.from_numpy(
            index.positions.astype(np.int64)).to(dev)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.hash, self.start, self.positions))


# (host index, device copy) of the one live index.  The host index is
# held, not its id(): a freed index's id can be reused by the next
# subject volume's index, which may even have the same hash count.
_DEVICE_INDEX_CACHE: list = []


def device_index_of(index: KmerIndex, device) -> DeviceIndex:
    """The (cached) device copy of ``index``; one live index at a time."""
    dev = torch.device(device)
    if (_DEVICE_INDEX_CACHE and _DEVICE_INDEX_CACHE[0] is index
            and _DEVICE_INDEX_CACHE[1].device == dev):
        return _DEVICE_INDEX_CACHE[1]
    _DEVICE_INDEX_CACHE.clear()
    di = DeviceIndex(index, dev)
    _DEVICE_INDEX_CACHE.extend([index, di])
    return di


def _hash_kmers(codes: torch.Tensor, k: int):
    """(hash int64, ok bool) of the k-mer starting at every position of
    (B, Q) codes (values 0..3, >= 4 ambiguous): MSB-first 2-bit hash;
    ok is False when the window leaves the array or holds an ambiguous
    base (``seeding_jax._hash_limbs`` semantics, one int64 limb)."""
    if not 0 < k <= 31:
        raise ValueError(f"k-mer size {k}: a 2k-bit hash must fit int64 "
                         "below 2^62")
    B, Q = codes.shape
    cpad = torch.full((B, Q + k), 4, dtype=torch.int64, device=codes.device)
    cpad[:, :Q] = codes
    h = torch.zeros((B, Q), dtype=torch.int64, device=codes.device)
    amb = torch.zeros((B, Q), dtype=torch.bool, device=codes.device)
    for j in range(k):
        c = cpad[:, j : j + Q]
        bad = c >= 4
        amb |= bad
        h = (h << 2) | torch.where(bad, 0, c)
    return h, ~amb


def _seed_match_kernel(codes, qlen, offs, di: DeviceIndex, max_occ: int,
                       M: int):
    """(B, Qmax) codes -> (qoff (B, M) i32, soff (B, M) i64, valid (B, M)
    bool, total (B,) i64 pre-truncation match counts)."""
    from lesv_tpu_torch.ops.pairseed_torch import expand_slots

    k = di.k
    h, okp = _hash_kmers(codes.to(torch.int64), k)
    qh = h[:, offs]
    q_ok = okp[:, offs] & (offs[None, :] + k <= qlen[:, None])
    if di.n:
        idx = torch.searchsorted(di.hash, qh)
        idx_c = idx.clamp(max=di.n - 1)
        found = q_ok & (idx < di.n) & (di.hash[idx_c] == qh)
    else:
        idx_c = torch.zeros_like(qh)
        found = torch.zeros_like(q_ok)
    g_start = di.start[idx_c]
    g_count = di.start[idx_c + 1] - g_start
    g_count = torch.where(found & (g_count <= max_occ), g_count, 0)
    seed_of, r, valid, total = expand_slots(g_count, M)
    pos_idx = (torch.gather(g_start, 1, seed_of) + r).clamp(
        0, max(len(di.positions) - 1, 0))
    soff = (di.positions[pos_idx] if len(di.positions)
            else torch.zeros_like(pos_idx))
    qoff = offs[seed_of]
    soff = torch.where(valid, soff, SOFF_INVALID)
    qoff = torch.where(valid, qoff, QOFF_INVALID).to(torch.int32)
    return qoff, soff, valid, total


def seed_matches_batch(
    reads: list[np.ndarray],
    index: KmerIndex,
    cfg: SeedingConfig | None = None,
    M: int = 8192,
    Qmax: int | None = None,
    device="cuda",
):
    """Seeding of a batch of reads, both strands, on ``device``.

    Returns torch tensors (qoff (B, M) i32, soff (B, M) i64, valid (B, M)
    bool, total (B,) i64): lane 2*i is read i FWD, lane 2*i+1 read i REV
    (strand-oriented qoff); lanes past 2*len(reads) are empty padding."""
    from lesv_tpu_torch.ops.pairseed_torch import pack_codes, unpack_codes

    cfg = cfg or SeedingConfig()
    di = device_index_of(index, device)
    R = len(reads)
    if Qmax is None:
        Qmax = max((len(r) for r in reads), default=1)
        Qmax = max(64, 1 << int(np.ceil(np.log2(max(Qmax, 2)))))
    B = 16 if 2 * R <= 16 else 128
    if 2 * R > 128:
        B = 1 << int(np.ceil(np.log2(2 * R)))
    codes = np.full((B, Qmax), 4, np.uint8)
    qlen = np.zeros(B, np.int64)
    for i, r in enumerate(reads):
        codes[2 * i, : len(r)] = r
        codes[2 * i + 1, : len(r)] = revcomp(r)
        qlen[2 * i] = qlen[2 * i + 1] = len(r)
    dev = di.device
    offs = sampled_offsets_static(Qmax, di.k, cfg.query_stride, cfg)
    packed, amb = pack_codes(codes)
    codes_t = unpack_codes(torch.from_numpy(packed).to(dev),
                           torch.from_numpy(amb).to(dev))[:, :Qmax]
    return _seed_match_kernel(
        codes_t, torch.from_numpy(qlen).to(dev),
        torch.from_numpy(offs.astype(np.int64)).to(dev), di,
        cfg.max_query_kmer_occ, M)
