"""The mapper on a torch device: seed -> chain -> candidate windows ->
pair seed + chain -> anchored extension -> M4.

Counterpart of :mod:`lesv_tpu.pipeline.mapper` (the reference's
``qx2map``).  Read seeding, pair seeding and their chain scans run as
torch ops plus the chain-scan kernel; every alignment fill and traceback
runs on the fill and traceback kernels; candidate windows, chain
extraction and the M4 filters are host code.  The device is explicit:
every entry point takes ``device``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from lesv_tpu_torch import _ext
from lesv_tpu_torch.config import LesvConfig
from lesv_tpu_torch.index.kmer_index import KmerIndex
from lesv_tpu_torch.io.fasta import revcomp
from lesv_tpu_torch.io.seqstore import SeqStore
from lesv_tpu_torch.ops.anchored import anchored_align_many
from lesv_tpu_torch.ops.chain import Chain, extract_chains_np
from lesv_tpu_torch.ops.chain_torch import chain_lanes_sliced
from lesv_tpu_torch.ops.cigar import match_mask
from lesv_tpu_torch.ops.pairseed import mem_anchors
from lesv_tpu_torch.ops.pairseed_torch import _pad_pow2_dim
from lesv_tpu_torch.ops.seeding import collect_seed_matches
from lesv_tpu_torch.ops.seeding_torch import (
    device_index_of,
    release_device_index,
    seed_matches_batch,
)
from lesv_tpu_torch.parallel.streams import StreamPool
from lesv_tpu_torch.pipeline.batch_align import batch_pair_chains
from lesv_tpu_torch.utils import profiling
from lesv_tpu_torch.utils.logging import log

FWD, REV = 0, 1


@dataclass
class M4:
    """One mapping record (reference `corelib/m4_record.h`).

    qoff/qend are strand-oriented (coordinates on the qdir-oriented query),
    matching the reference convention (`find_sv_reads.c:131-141`).
    """

    qid: int
    qdir: int
    qoff: int
    qend: int
    qsize: int
    sid: int
    soff: int
    send: int
    ssize: int
    ident_perc: float
    score: int
    dist: int = 0   # edit-ish distance: alignment columns - matches
    # the alignment itself (kept in-memory; the reference round-trips
    # text M4 + re-alignment instead)
    ops: np.ndarray | None = field(default=None, repr=False)


@dataclass
class CandidateWindow:
    sid: int
    sfrom: int
    sto: int
    score: int
    qdir: int


def find_candidate_windows(
    chains_by_dir: dict[int, list[Chain]],
    index: KmerIndex,
    qlen: int,
    cfg: LesvConfig,
) -> list[CandidateWindow]:
    """Group DDF chains by subject, keep top max_target_seqs subjects, expand
    each chain to a subject window, merge near windows.

    Window expansion mirrors `adjust_init_hit_subject_offset`
    (`hbn_find_subseq_hit.c:119-156`): from the chain position extend by
    1.3x the flanking query length, capped at +30kb, clipped to the subject.
    """
    mcfg = cfg.map
    # collect (sid, window, score, qdir)
    raw: list[CandidateWindow] = []
    for qdir, chains in chains_by_dir.items():
        for c in chains:
            gpos = np.int64(c.sbeg)
            sid, loc = index.global_to_local(np.array([gpos]))
            sid, loc = int(sid[0]), int(loc[0])
            ssize = int(index.subject_starts[sid + 1] - index.subject_starts[sid])
            # chain midpoint anchor
            mid_q = (c.qbeg + c.qend) // 2
            mid_s = int((c.sbeg + c.send) // 2 - index.subject_starts[sid])
            ql = mid_q
            qr = qlen - mid_q
            x = min(int(qlen * mcfg.subseq_margin_factor), ql + mcfg.subseq_max_gap)
            sfrom = max(0, mid_s - min(x, mid_s))
            x = min(int(qlen * mcfg.subseq_margin_factor), qr + mcfg.subseq_max_gap)
            sto = min(ssize, mid_s + x)
            raw.append(CandidateWindow(sid, sfrom, sto, c.score, qdir))
    if not raw:
        return []
    # top subjects by best score
    best_by_sid: dict[int, int] = {}
    for w in raw:
        best_by_sid[w.sid] = max(best_by_sid.get(w.sid, 0), w.score)
    top_sids = sorted(best_by_sid, key=lambda s: -best_by_sid[s])[: mcfg.max_target_seqs]
    out: list[CandidateWindow] = []
    for sid in top_sids:
        for qdir in (FWD, REV):
            ws = sorted(
                (w for w in raw if w.sid == sid and w.qdir == qdir),
                key=lambda w: w.sfrom,
            )
            merged: list[CandidateWindow] = []
            for w in ws:
                if merged and w.sfrom - merged[-1].sto <= mcfg.max_subseq_gap_merge:
                    merged[-1].sto = max(merged[-1].sto, w.sto)
                    merged[-1].score = max(merged[-1].score, w.score)
                else:
                    merged.append(CandidateWindow(w.sid, w.sfrom, w.sto, w.score, qdir))
            out.extend(merged)
    return out


def _window_ddf_chains(chains: list[Chain], index: KmerIndex,
                       w: CandidateWindow) -> list[Chain]:
    """DDF chains whose anchors fall inside window ``w``, with subject
    offsets translated to window-local coordinates (the -skip_memsc
    path's anchor source)."""
    import dataclasses

    base = int(index.subject_starts[w.sid])
    lo, hi = base + w.sfrom, base + w.sto
    out: list[Chain] = []
    for c in chains:
        a = c.anchors
        keep = (a[:, 1] >= lo) & (a[:, 1] + index.k <= hi)
        if not keep.any():
            continue
        a2 = a[keep].copy()
        a2[:, 1] -= lo
        out.append(dataclasses.replace(c, anchors=a2))
    out.sort(key=lambda c: -c.score)
    return out


def _hsp_contained(kept: list[M4], m: M4, eps: int = 100) -> bool:
    for a in kept:
        if (a.qdir == m.qdir and a.sid == m.sid
                and m.qoff + eps >= a.qoff and m.qend <= a.qend + eps
                and m.soff + eps >= a.soff and m.send <= a.send + eps):
            return True
    return False


def _chains_by_read_host(read: np.ndarray, index: KmerIndex,
                         cfg: LesvConfig) -> dict[int, list[Chain]]:
    matches = collect_seed_matches(index, read, cfg.seeding)
    return {d: extract_chains_np(matches[d][0], matches[d][1],
                                 length=index.k, cfg=cfg.chain)
            for d in (FWD, REV)}


def _seed_chain_chunk(reads, index, cfg, M, Qmax, device):
    """Seeding + chaining of one read chunk (both strands); returns
    (chains per lane, total per lane)."""
    with profiling.trace("map/seed_device"):
        qoff, soff, valid, total = seed_matches_batch(
            reads, index, cfg.seeding, M=M, Qmax=Qmax, device=device)
    total = total.cpu().numpy()
    with profiling.trace("map/chain_device"):
        lanes = chain_lanes_sliced(qoff, soff, valid, total, M, index.k,
                                   cfg.chain, J=cfg.chain.lookback,
                                   q16=Qmax < 65536)
    return lanes, total


def _chains_by_read_device(
    batch: list[tuple[int, np.ndarray]],
    index: KmerIndex,
    cfg: LesvConfig,
    device="cuda",
) -> list[dict[int, list[Chain]]]:
    """Batched seeding + chain DP for every read of the batch (both
    strands), in pow2-length buckets of 64 reads.  On a GPU, reads whose
    match count overflows the per-lane budget are retried at twice the
    budget (chunks of 8); what still overflows falls back to the host
    oracle."""
    out: list[dict[int, list[Chain]]] = [{FWD: [], REV: []} for _ in batch]
    buckets: dict[int, list[int]] = {}
    for i, (_, read) in enumerate(batch):
        buckets.setdefault(_pad_pow2_dim(len(read)), []).append(i)
    M = cfg.map.seed_match_budget
    overflow: list[int] = []
    for Qmax, idxs in sorted(buckets.items()):
        for start in range(0, len(idxs), 64):
            cidx = idxs[start : start + 64]
            lanes, total = _seed_chain_chunk(
                [batch[i][1] for i in cidx], index, cfg, M, Qmax, device)
            for j, i in enumerate(cidx):
                if total[2 * j] > M or total[2 * j + 1] > M:
                    overflow.append(i)
                else:
                    out[i] = {FWD: lanes[2 * j], REV: lanes[2 * j + 1]}
    if overflow and torch.device(device).type != "cpu":
        M2x = 2 * M
        still: list[int] = []
        rebuck: dict[int, list[int]] = {}
        for i in overflow:
            rebuck.setdefault(_pad_pow2_dim(len(batch[i][1])), []).append(i)
        for Qmax, oidx in sorted(rebuck.items()):
            for start in range(0, len(oidx), 8):
                cidx = oidx[start : start + 8]
                lanes, total = _seed_chain_chunk(
                    [batch[i][1] for i in cidx], index, cfg, M2x, Qmax,
                    device)
                for j, i in enumerate(cidx):
                    if total[2 * j] > M2x or total[2 * j + 1] > M2x:
                        still.append(i)
                    else:
                        out[i] = {FWD: lanes[2 * j], REV: lanes[2 * j + 1]}
        overflow = still
    for i in overflow:
        out[i] = _chains_by_read_host(batch[i][1], index, cfg)
    return out


def map_batch(
    batch: list[tuple[int, np.ndarray]],
    store: SeqStore,
    index: KmerIndex,
    cfg: LesvConfig | None = None,
    device="cuda",
) -> list[M4]:
    """Map a batch of (qid, read) on ``device``: batched seeding + chain
    DP (cfg.map.engine == "device") or the per-read host oracle;
    candidate windows on the host; every window's pair chains and every
    extension in batched device sweeps."""
    cfg = cfg or LesvConfig()
    live = [(qid, read) for qid, read in batch
            if len(read) >= max(cfg.map.min_query_size, index.k)]
    with profiling.trace("map/read_chains"):
        if cfg.map.engine == "device":
            all_chains = _chains_by_read_device(live, index, cfg, device)
        else:
            all_chains = [_chains_by_read_host(read, index, cfg)
                          for _, read in live]

    wtasks: list[tuple[np.ndarray, np.ndarray]] = []
    wmeta: list[tuple[int, int, CandidateWindow]] = []
    wddf: list[list[Chain]] = []
    with profiling.trace("map/windows"):
        for (qid, read), chains_by_dir in zip(live, all_chains):
            qlen = len(read)
            for w in find_candidate_windows(chains_by_dir, index, qlen, cfg):
                sseq = store.get(w.sid, w.sfrom, w.sto)
                q = read if w.qdir == FWD else revcomp(read)
                wtasks.append((q, sseq))
                wmeta.append((qid, qlen, w))
                if cfg.memsc.skip_memsc:
                    wddf.append(_window_ddf_chains(
                        chains_by_dir[w.qdir], index, w))

    if cfg.memsc.skip_memsc:
        # -skip_memsc: extend straight from the DDF chain anchors
        wchains_all = wddf
        mk = index.k
    else:
        with profiling.trace("map/window_chains"):
            wchains_all = batch_pair_chains(wtasks, cfg, device=device)
        mk = cfg.memsc.kmer_size

    tasks = []   # (q, sseq, anchors, k)
    meta = []    # (qid, qlen, window)
    for (qid, qlen, w), (q, sseq), wchains in zip(wmeta, wtasks,
                                                  wchains_all):
        for c in wchains[: cfg.map.max_hsps]:
            if cfg.memsc.skip_memsc:
                runs = c.anchors
            else:
                runs = mem_anchors(q, sseq, c.anchors, mk,
                                   cfg.memsc.mem_size)
            tasks.append((q, sseq, runs, mk))
            meta.append((qid, qlen, w))
    with profiling.trace("map/extend"):
        alns = anchored_align_many(tasks, cfg.align, device=device)
    per_qid: dict[int, list[M4]] = {}
    with profiling.trace("map/filter"):
        for (qid, qlen, w), (q, sseq, _, _), aln in zip(meta, tasks, alns):
            if aln is None or aln.qe - aln.qb < cfg.map.qcov_hsp_res:
                continue
            n_match = int(match_mask(aln.ops, q, sseq, aln.qb, aln.sb).sum())
            pid = (100.0 * n_match / len(aln.ops)) if len(aln.ops) else 0.0
            if pid < cfg.map.perc_identity:
                continue
            m4 = M4(
                qid=qid, qdir=w.qdir, qoff=aln.qb, qend=aln.qe, qsize=qlen,
                sid=w.sid, soff=w.sfrom + aln.sb, send=w.sfrom + aln.se,
                ssize=store.seq_size(w.sid),
                ident_perc=pid, score=aln.score,
                dist=len(aln.ops) - n_match, ops=aln.ops,
            )
            lst = per_qid.setdefault(qid, [])
            if not _hsp_contained(lst, m4):
                lst.append(m4)
    out: list[M4] = []
    for qid in sorted(per_qid):
        lst = per_qid[qid]
        lst.sort(key=lambda m: -m.score)
        out.extend(lst)
    return out


def map_read(
    qid: int,
    read: np.ndarray,
    store: SeqStore,
    index: KmerIndex,
    cfg: LesvConfig | None = None,
    device="cuda",
) -> list[M4]:
    """Map one read against the indexed subject store on ``device``;
    return M4 records."""
    return map_batch([(qid, read)], store, index, cfg, device=device)


def query_volumes(sizes: list[int], max_res: int) -> list[list[int]]:
    """Greedy in-order packing of reads into query volumes of
    <= ``max_res`` residues (-max_query_vol_res; the reference's query
    DB volume partitioning, `makehbndb.c:20-26`).  Volumes are the
    resume/grid-striding granularity (`app/map/main.c:35,41,55`)."""
    vols: list[list[int]] = []
    cur: list[int] = []
    res = 0
    for qid, sz in enumerate(sizes):
        if cur and res + sz > max_res:
            vols.append(cur)
            cur, res = [], 0
        cur.append(qid)
        res += sz
    if cur:
        vols.append(cur)
    return vols


def _query_batches(qstore: SeqStore, cfg: LesvConfig):
    """Read batches bounded by count (batch_reads) AND residues
    (-query_batch_size, `hbn_align_one_volume.c:55-83`): bounds in-flight
    seed-match memory for long-read sets.  Batches never straddle a
    query-volume boundary (-max_query_vol_res), so batch checkpoints
    compose with volume-granular resume/striding."""
    B, R = cfg.map.batch_reads, cfg.map.query_batch_size
    sizes = [qstore.seq_size(q) for q in range(qstore.num_seqs)]
    for vol in query_volumes(sizes, cfg.map.max_query_vol_res):
        batch: list[int] = []
        res = 0
        for qid in vol:
            sz = sizes[qid]
            if batch and (len(batch) >= B or res + sz > R):
                yield batch
                batch, res = [], 0
            batch.append(qid)
            res += sz
        if batch:
            yield batch


class _VolStoreView:
    """Subject store restricted to one volume: volume-local subject ids
    delegate to the backing store (the mapper sees the volume as the
    whole world, `app/map/main.c:40-70`)."""

    def __init__(self, store: SeqStore, lo: int):
        self._store, self._lo = store, lo

    def get(self, sid: int, *a, **kw):
        return self._store.get(sid + self._lo, *a, **kw)

    def seq_size(self, sid: int) -> int:
        return self._store.seq_size(sid + self._lo)


def subject_volumes(store: SeqStore, max_res: int) -> list[tuple[int, int]]:
    """Partition subjects into volumes of <= max_res residues (whole
    subjects; a single over-sized subject gets its own volume), the
    reference's seqdb volume rule (`makehbndb.c:20-26`)."""
    vols: list[tuple[int, int]] = []
    lo = 0
    res = 0
    for sid in range(store.num_seqs):
        sz = store.seq_size(sid)
        if sid > lo and res + sz > max_res:
            vols.append((lo, sid))
            lo, res = sid, 0
        res += sz
    if lo < store.num_seqs:
        vols.append((lo, store.num_seqs))
    return vols


def map_all(
    reads: list[tuple[str, np.ndarray]],
    store: SeqStore,
    index: KmerIndex,
    cfg: LesvConfig | None = None,
    ckpt_dir: str | None = None,
    qstore: SeqStore | None = None,
    part_prefix: str = "map_part",
    sid_base: int = 0,
    device="cuda",
) -> tuple[list[M4], SeqStore]:
    """Map reads against one index on ``device``; returns (M4s, query
    store).  With ``ckpt_dir`` each read batch's M4s are checkpointed and
    a restarted run resumes after the completed batches.  ``sid_base``
    translates volume-local subject ids back to global ids.  On a card
    ``_map_overlap_depth`` batches are in flight at once, each on CUDA
    streams of its own; the M4s come back in batch order either way."""
    from lesv_tpu_torch.pipeline import stages_io as sio

    cfg = cfg or LesvConfig()
    if qstore is None:
        qstore = SeqStore.from_records(reads)
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
    vstore = store if sid_base == 0 else _VolStoreView(store, sid_base)

    def run_one(bi: int, qids: list[int]) -> list[M4]:
        part = (os.path.join(ckpt_dir, f"{part_prefix}_{bi:05d}.npz")
                if ckpt_dir else None)
        if part and os.path.exists(part):
            return sio.load_m4s(part)
        m4s = map_batch([(qid, qstore.get(qid)) for qid in qids], vstore,
                        index, cfg, device=device)
        for m in m4s:
            m.sid += sid_base
        if part:
            sio.save_m4s(part + ".tmp.npz", m4s)
            os.replace(part + ".tmp.npz", part)
        return m4s

    batches = list(enumerate(_query_batches(qstore, cfg)))
    out: list[M4] = []
    depth = _map_overlap_depth(device)
    if depth <= 1 or len(batches) <= 1:
        for bi, qids in batches:
            out.extend(run_one(bi, qids))
        return out, qstore
    # batches in flight: one batch's device seeding and fills run under
    # the host window and extension work of the other.  The device index
    # is built here, before any worker reads it from its own stream.
    if cfg.map.engine == "device":
        device_index_of(index, device)
    with StreamPool(depth, device) as pool:
        futs = [pool.submit(run_one, bi, qids) for bi, qids in batches]
        for f in futs:
            out.extend(f.result())
    return out, qstore


def _map_overlap_depth(device) -> int:
    """Map batches in flight: 2 on a card, 1 (one batch after the other)
    on the CPU, where the plain fills are compute-bound."""
    return 1 if torch.device(device).type == "cpu" else 2


def map_all_volumes(
    reads: list[tuple[str, np.ndarray]],
    store: SeqStore,
    cfg: LesvConfig | None = None,
    ckpt_dir: str | None = None,
    device="cuda",
    volume_stats: list | None = None,
) -> tuple[list[M4], SeqStore]:
    """Out-of-core mapping: subject volumes of <= max_subject_vol_res
    residues, each indexed and mapped in turn (checkpointed per (volume,
    batch)); M4s are merged per query, score-sorted within a query.  Each
    volume's index, host and device copy, is freed before the next one is
    built.  ``volume_stats``, where given, gets one dict a volume
    (:func:`_map_volume`)."""
    cfg = cfg or LesvConfig()
    vols = subject_volumes(store, cfg.map.max_subject_vol_res)
    qstore = SeqStore.from_records(reads)
    if len(vols) <= 1:
        m4s = _map_volume(reads, store, qstore, cfg, ckpt_dir, None,
                          "map_part", device, volume_stats)
        return m4s, qstore
    out: list[M4] = []
    for vi, (lo, hi) in enumerate(vols):
        vres = int(store.starts[hi] - store.starts[lo])
        log(f"[map] subject volume {vi + 1}/{len(vols)}: "
            f"subjects {lo}..{hi - 1} ({vres/1e6:.1f} Mres)")
        out.extend(_map_volume(reads, store, qstore, cfg, ckpt_dir,
                               (lo, hi), f"map_v{vi:03d}", device,
                               volume_stats))
    by_qid: dict[int, list[M4]] = {}
    for m in out:
        by_qid.setdefault(m.qid, []).append(m)
    merged: list[M4] = []
    for qid in sorted(by_qid):
        lst = by_qid[qid]
        lst.sort(key=lambda m: -m.score)
        merged.extend(lst)
    return merged, qstore


def _map_volume(reads, store, qstore, cfg, ckpt_dir, sid_range,
                part_prefix, device, volume_stats) -> list[M4]:
    """Index subjects ``sid_range`` (all of them where None), map every
    read against them (:func:`map_all`), then release the index's device
    copy so that the host index dies with this call.  Appends to
    ``volume_stats`` (where given) the volume's subjects, index build,
    upload and map seconds, the device copy's bytes, the kernel launches
    of the volume, and on a card the bytes still allocated once the copy
    is released."""
    dev = torch.device(device)
    launched = dict(_ext.LAUNCHES)
    t0 = time.time()
    index = KmerIndex.build(store, cfg.index, sid_range=sid_range)
    t1 = time.time()
    nbytes = 0
    if cfg.map.engine == "device":
        nbytes = device_index_of(index, dev).nbytes
    t2 = time.time()
    m4s, _ = map_all(reads, store, index, cfg, ckpt_dir=ckpt_dir,
                     qstore=qstore, part_prefix=part_prefix,
                     sid_base=sid_range[0] if sid_range else 0,
                     device=device)
    t3 = time.time()
    release_device_index(index)
    if volume_stats is not None:
        lo, hi = sid_range or (0, store.num_seqs)
        rec = dict(subjects=[lo, hi],
                   residues=int(store.starts[hi] - store.starts[lo]),
                   index_s=t1 - t0, index_device_bytes=nbytes,
                   upload_s=t2 - t1, map_s=t3 - t2, m4=len(m4s),
                   launches={k: n - launched[k]
                             for k, n in _ext.LAUNCHES.items()})
        if dev.type == "cuda":
            rec["device_allocated_after"] = torch.cuda.memory_allocated(dev)
        volume_stats.append(rec)
    return m4s
