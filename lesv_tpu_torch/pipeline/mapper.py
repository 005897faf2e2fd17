"""The mapper on a torch device: seed -> chain -> candidate windows ->
pair seed + chain -> anchored extension -> M4.

Counterpart of :mod:`lesv_tpu.pipeline.mapper` (the reference's
``qx2map``).  Read seeding, pair seeding and their chain scans run as
torch ops plus the chain-scan kernel; every alignment fill and traceback
runs on the fill and traceback kernels; candidate windows, chain
extraction and the M4 filters are the JAX package's host code.  The
device is explicit: every entry point takes ``device``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from lesv_tpu.config import LesvConfig
from lesv_tpu.index.kmer_index import KmerIndex
from lesv_tpu.io.fasta import revcomp
from lesv_tpu.io.seqstore import SeqStore
from lesv_tpu.ops.chain import Chain
from lesv_tpu.ops.cigar import match_mask
from lesv_tpu.ops.pairseed import mem_anchors
from lesv_tpu.pipeline.batch_align import _pad_pow2_dim, _shrink_M
from lesv_tpu.pipeline.mapper import (
    FWD,
    M4,
    REV,
    CandidateWindow,
    _chains_by_read_host,
    _hsp_contained,
    _query_batches,
    _VolStoreView,
    _window_ddf_chains,
    find_candidate_windows,
    subject_volumes,
)
from lesv_tpu.utils import profiling
from lesv_tpu_torch.ops.anchored import anchored_align_many
from lesv_tpu_torch.ops.chain_torch import chain_lanes
from lesv_tpu_torch.ops.seeding_torch import seed_matches_batch
from lesv_tpu_torch.pipeline.batch_align import batch_pair_chains


def _seed_chain_chunk(reads, index, cfg, M, Qmax, device):
    """Seeding + chaining of one read chunk (both strands); returns
    (chains per lane, total per lane)."""
    with profiling.trace("map/seed_device"):
        qoff, soff, valid, total = seed_matches_batch(
            reads, index, cfg.seeding, M=M, Qmax=Qmax, device=device)
    total = total.cpu().numpy()
    with profiling.trace("map/chain_device"):
        lanes = chain_lanes(qoff, soff, valid, index.k, cfg.chain,
                            J=cfg.chain.lookback, Mp=_shrink_M(total, M))
    return lanes, total


def _chains_by_read_device(
    batch: list[tuple[int, np.ndarray]],
    index: KmerIndex,
    cfg: LesvConfig,
    device="cpu",
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
    device="cpu",
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


def map_all(
    reads: list[tuple[str, np.ndarray]],
    store: SeqStore,
    index: KmerIndex,
    cfg: LesvConfig | None = None,
    ckpt_dir: str | None = None,
    qstore: SeqStore | None = None,
    part_prefix: str = "map_part",
    sid_base: int = 0,
    device="cpu",
) -> tuple[list[M4], SeqStore]:
    """Map reads against one index on ``device``; returns (M4s, query
    store).  With ``ckpt_dir`` each read batch's M4s are checkpointed and
    a restarted run resumes after the completed batches.  ``sid_base``
    translates volume-local subject ids back to global ids."""
    from lesv_tpu.pipeline import stages_io as sio

    cfg = cfg or LesvConfig()
    if qstore is None:
        qstore = SeqStore.from_records(reads)
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
    vstore = store if sid_base == 0 else _VolStoreView(store, sid_base)
    out: list[M4] = []
    for bi, qids in enumerate(_query_batches(qstore, cfg)):
        part = (os.path.join(ckpt_dir, f"{part_prefix}_{bi:05d}.npz")
                if ckpt_dir else None)
        if part and os.path.exists(part):
            out.extend(sio.load_m4s(part))
            continue
        m4s = map_batch([(qid, qstore.get(qid)) for qid in qids], vstore,
                        index, cfg, device=device)
        for m in m4s:
            m.sid += sid_base
        if part:
            sio.save_m4s(part + ".tmp.npz", m4s)
            os.replace(part + ".tmp.npz", part)
        out.extend(m4s)
    return out, qstore


def map_all_volumes(
    reads: list[tuple[str, np.ndarray]],
    store: SeqStore,
    cfg: LesvConfig | None = None,
    ckpt_dir: str | None = None,
    device="cpu",
) -> tuple[list[M4], SeqStore]:
    """Out-of-core mapping: subject volumes of <= max_subject_vol_res
    residues, each indexed and mapped in turn (checkpointed per (volume,
    batch)); M4s are merged per query, score-sorted within a query."""
    from lesv_tpu.utils.logging import log

    cfg = cfg or LesvConfig()
    vols = subject_volumes(store, cfg.map.max_subject_vol_res)
    qstore = SeqStore.from_records(reads)
    if len(vols) <= 1:
        index = KmerIndex.build(store, cfg.index)
        return map_all(reads, store, index, cfg, ckpt_dir=ckpt_dir,
                       qstore=qstore, device=device)
    out: list[M4] = []
    for vi, (lo, hi) in enumerate(vols):
        vres = int(store.starts[hi] - store.starts[lo])
        log(f"[map] subject volume {vi + 1}/{len(vols)}: "
            f"subjects {lo}..{hi - 1} ({vres/1e6:.1f} Mres)")
        index = KmerIndex.build(store, cfg.index, sid_range=(lo, hi))
        m4s, _ = map_all(reads, store, index, cfg, ckpt_dir=ckpt_dir,
                         qstore=qstore, part_prefix=f"map_v{vi:03d}",
                         sid_base=lo, device=device)
        out.extend(m4s)
        del index
    by_qid: dict[int, list[M4]] = {}
    for m in out:
        by_qid.setdefault(m.qid, []).append(m)
    merged: list[M4] = []
    for qid in sorted(by_qid):
        lst = by_qid[qid]
        lst.sort(key=lambda m: -m.score)
        merged.extend(lst)
    return merged, qstore
