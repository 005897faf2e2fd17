"""Input generators shared by the port's CPU parity tests and its kernel
tests on the card (numpy only, so both can import it)."""

import numpy as np

U32_TOP = 0xFFFFFFFE      # the largest valid subject offset


def chain_edge_lanes(rng, J: int, M: int):
    """(qoff int32, soff int64, valid bool) of shape (6, M), valid slots in
    random order: lanes with 0, 1, J-1, J, J+1 and M//2 valid seeds (each
    capped at M), subject offsets just below 2^32 - 1, and every lane of
    four or more seeds holding duplicated seeds, so that a later seed sees
    two predecessors with the same total.  Invalid slots carry the
    sentinels of ``sort_seeds_device``."""
    counts = [min(n, M) for n in (0, 1, J - 1, J, J + 1, M // 2)]
    B = len(counts)
    qoff = np.full((B, M), 0x7FFFFFFF, np.int32)
    soff = np.full((B, M), 0xFFFFFFFF, np.int64)
    valid = np.zeros((B, M), bool)
    for b, n in enumerate(counts):
        q = np.sort(rng.integers(0, 4 * n + 50, n))
        s = U32_TOP - (4 * n + 2_000) + q + rng.integers(0, 300, n)
        for k in range(0, n - 1, max(4, n // 8)):
            q[k + 1], s[k + 1] = q[k], s[k]
        perm = rng.permutation(n)
        qoff[b, :n] = q[perm]
        soff[b, :n] = np.minimum(s, U32_TOP)[perm]
        valid[b, :n] = True
    return qoff, soff, valid


def unsorted_invalid_tail(rng, qs, ss, vs, lane: int):
    """Overwrite the invalid slots of ``lane`` in sorted (qs, ss, vs)
    tensors with random, unsorted, non-sentinel offsets (in place)."""
    import torch

    n = int(vs[lane].sum())
    k = qs.shape[1] - n
    qs[lane, n:] = torch.from_numpy(
        rng.integers(0, 5_000, k).astype(np.int32)).to(qs.device)
    ss[lane, n:] = torch.from_numpy(
        rng.integers(U32_TOP - 9_000, U32_TOP, k).astype(np.int64)).to(
            ss.device)


def traceback_edge_case(rng, B: int, R: int, W: int):
    """Direction bytes and end cells that drive every exit of the
    traceback: random bytes (sources 0 to 4, random extension flags), lane
    0 with ok false, lane 1 made of one byte of source 5 that repeats its
    own state (with the full band's d = 0 it walks in place until T runs
    out; with diag's d = 1 it leaves the band), lane 2 ending outside the
    band, lane 3 ending two rows past the last (the walk reads row R - 1
    until its row index comes down), the rest at random end cells.  Returns numpy (dirs (B, R, W) u8,
    end_i, end_b i32, ok bool)."""
    dirs = (rng.integers(0, 5, (B, R, W))
            | rng.integers(0, 16, (B, R, W)) << 3).astype(np.uint8)
    dirs[1] = 0x7D                      # source 5, bit 6 set
    end_i = rng.integers(0, R, B).astype(np.int32)
    end_b = rng.integers(0, W, B).astype(np.int32)
    end_i[1], end_b[1] = R - 1, W // 2
    end_b[2] = W + 1
    end_i[3] = R + 1
    ok = np.ones(B, bool)
    ok[0] = False
    return dirs, end_i, end_b, ok


N_MONSTER = 5
MONSTER_DIRS_BYTES = 20_000_000


def align_pairs_world(rng):
    """About 200 (q, s) pairs over many (Q, S, W, mode) buckets, none of
    more than 128 pairs: reads against their source at 10% error, 20 to
    250 bp, some with a deletion or an insertion (full-mode buckets); one
    pair with no base in common (free-end: its best cell is the origin, so
    the lane fails and is retried on the host); an empty query; and
    ``N_MONSTER`` long pairs (query 1,100, subject 3,000) at the end.  With
    ``align_batch.MONSTER_DIRS_BYTES`` set to ``MONSTER_DIRS_BYTES`` the
    long pairs' chunk (query rows 4,096, 8 lanes, W 4,096 full or 1,024
    diag) is a monster and every other chunk stays below."""
    from lesv_tpu_torch.sim import mutate_read

    pairs = []
    for k in range(195):
        n = int(rng.integers(20, 250))
        s = rng.integers(0, 4, n).astype(np.uint8)
        q = mutate_read(rng, s, err=0.1)[:250]
        if k % 7 == 0:
            cut = int(rng.integers(5, max(6, n // 2)))
            q = np.concatenate([q[:cut], q[cut + n // 3 :]])
        elif k % 11 == 0:
            q = np.concatenate([q[: n // 2],
                                rng.integers(0, 4, n // 3).astype(np.uint8),
                                q[n // 2 :]])[:250]
        pairs.append((q, s))
    pairs.append((np.zeros(120, np.uint8), np.ones(150, np.uint8)))
    pairs.append((np.zeros(0, np.uint8), pairs[0][1]))     # empty: None
    for _ in range(N_MONSTER):
        s = rng.integers(0, 4, 3_000).astype(np.uint8)
        pairs.append((mutate_read(rng, s[:1_100], err=0.1)[:1_100], s))
    return pairs


GENOME_SCALE_SHIFT = 2_200_000_000   # subject offsets past 2^31, below 2^32


def volume_world(rng, n_chroms: int = 5, chrom_len: int = 30_000,
                 n_reads: int = 8):
    """(chromosomes, reads): ``n_chroms`` random chromosomes and reads of 4
    to 9 kb at 5% error, each inside one chromosome (a read across two
    would chain differently in one index and in two volumes)."""
    from lesv_tpu_torch.sim import mutate_read, random_genome

    chroms = [(f"chr{i}", random_genome(rng, chrom_len))
              for i in range(n_chroms)]
    reads = []
    for i in range(n_reads):
        ci = int(rng.integers(0, n_chroms))
        start = int(rng.integers(0, chrom_len - 10_000))
        frag = chroms[ci][1][start : start + int(rng.integers(4_000, 9_000))]
        reads.append((f"r{i}", mutate_read(rng, frag, err=0.05)))
    return chroms, reads


def shifted_index_arrays(index, shift: int):
    """(k, window, uniq_hash, start, positions, subject_starts) of a k-mer
    index (either package's) with every subject offset moved up by
    ``shift``; the positions stay uint32."""
    return (index.k, index.window, index.uniq_hash, index.start,
            (index.positions.astype(np.int64) + shift).astype(np.uint32),
            index.subject_starts + shift)
