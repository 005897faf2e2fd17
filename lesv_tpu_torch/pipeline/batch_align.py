"""Batched chain + align orchestration shared by pipeline stages.

Counterpart of :mod:`lesv_tpu.pipeline.batch_align`: dense pair seeding +
chaining of many (query, subject) pairs in device chunks, then one
bucketed anchored-alignment sweep.  As in lesv_tpu, the chunks of 256
pairs (pair seeding, chain scan, the host oracle for lanes over the match
budget) are tasks on a pool of ``align_batch._n_dispatch_workers``
threads, each issuing on CUDA streams of its own
(:class:`parallel.streams.StreamPool`); with one worker (the CPU default)
they run in a serial loop.  As in lesv_tpu, short pairs are seeded and
chained on the host instead (``_host_route_pairs``, under the switches
``LESV_TORCH_HOST_SMALL``, ``LESV_TORCH_HOST_PAIR_CAP`` and
``LESV_TORCH_HOST_PAIR_BUDGET``, read at call time): in sorted blocks of 64
on a pool of ``align_batch._n_host_workers`` threads beside the dispatch
pool.  The caps are lesv_tpu's; the host oracle and the device path give
the same chains.
"""

from __future__ import annotations

import concurrent.futures as _fut
import os

import numpy as np
import torch

from lesv_tpu_torch.config import LesvConfig
from lesv_tpu_torch.ops import align_batch
from lesv_tpu_torch.ops.align_batch import global_align_pairs_host
from lesv_tpu_torch.ops.align_np import Alignment
from lesv_tpu_torch.ops.anchored import anchored_align_many
from lesv_tpu_torch.ops.chain import Chain
from lesv_tpu_torch.ops.chain_torch import chain_lanes_sliced
from lesv_tpu_torch.ops.pairseed import mem_anchors, pair_chains
from lesv_tpu_torch.ops.pairseed_torch import (
    _pad_pow2_dim,
    pair_matches_batch,
)
from lesv_tpu_torch.parallel.streams import StreamPool
from lesv_tpu_torch.utils import profiling


def _pair_chain_cfg(cfg: LesvConfig):
    """ChainConfig with pair-seeding semantics (min_cnt=1,
    min_score=memsc_mem_score, `init_hit_finder.c:26-27`,
    `cmdline_args.cpp:56-57`)."""
    import dataclasses

    c = dataclasses.replace(cfg.chain)
    c.min_seed_cnt = 1
    c.min_chain_score = cfg.memsc.mem_score
    return c


def _host_route_pairs(pairs, device) -> set[int]:
    """Pairs to seed and chain on the host instead of the device (lesv_tpu's
    rule): those with ``len(q) + len(s)`` at most
    ``LESV_TORCH_HOST_PAIR_CAP``, shortest first, up to a total of
    ``LESV_TORCH_HOST_PAIR_BUDGET`` bases; none where
    :func:`align_batch.host_small_on` is false."""
    if not align_batch.host_small_on(device):
        return set()
    cap = int(os.environ.get("LESV_TORCH_HOST_PAIR_CAP", 16384))
    budget = float(os.environ.get("LESV_TORCH_HOST_PAIR_BUDGET", 2e8))
    costed = sorted((len(q) + len(s), i) for i, (q, s) in enumerate(pairs)
                    if 0 < len(q) + len(s) <= cap)
    out: set[int] = set()
    tot = 0.0
    for c, i in costed:
        if tot + c > budget:
            break
        tot += c
        out.add(i)
    return out


def batch_pair_chains(
    pairs: list[tuple[np.ndarray, np.ndarray]],
    cfg: LesvConfig,
    k: int | None = None,
    device="cuda",
) -> list[list[Chain]]:
    """Chains for many (q, s) pairs: seeding + sort + chain scan on
    ``device`` in (pow2 Q, pow2 S) buckets of up to 256 pairs when
    cfg.map.engine == "device", the per-pair host oracle otherwise.  Lanes
    whose true match count exceeds the budget are redone on the host
    (identical semantics either way)."""
    k = k or cfg.memsc.kmer_size
    stride, occ = cfg.memsc.kmer_window, cfg.memsc.max_occ

    def host_chains(q, s):
        return pair_chains(q, s, k=k, q_stride=stride, max_occ=occ,
                           min_score=cfg.memsc.mem_score, cfg=cfg.chain)

    if cfg.map.engine != "device":
        return [host_chains(q, s) for q, s in pairs]

    pcfg = _pair_chain_cfg(cfg)
    out: list[list[Chain]] = [[] for _ in pairs]
    hosted = _host_route_pairs(pairs, device)
    buckets: dict[tuple[int, int], list[int]] = {}
    for i, (q, s) in enumerate(pairs):
        if len(q) < k or len(s) < k or i in hosted:
            continue
        buckets.setdefault((_pad_pow2_dim(len(q)), _pad_pow2_dim(len(s))),
                           []).append(i)
    M = cfg.map.pair_match_budget

    def run_chunk(cidx: list[int], Qb: int, Sb: int) -> None:
        chunk = [pairs[i] for i in cidx]
        with profiling.trace("pairseed_device"):
            qoff, soff, valid, total = pair_matches_batch(
                chunk, k=k, q_stride=stride, max_occ=occ, M=M, Qb=Qb,
                Sb=Sb, device=device)
        with profiling.trace("pairchain_device"):
            lanes = chain_lanes_sliced(qoff, soff, valid, total, M, k,
                                       pcfg, J=cfg.chain.lookback,
                                       q16=Qb < 65536, s16=Sb < 65536)
        for j, i in enumerate(cidx):
            out[i] = host_chains(*pairs[i]) if total[j] > M else lanes[j]

    def run_host_block(idxs: list[int]) -> None:
        for i in idxs:
            out[i] = host_chains(*pairs[i])

    tasks = []
    for (Qb, Sb), idxs in sorted(buckets.items()):
        for start in range(0, len(idxs), 256):
            tasks.append((idxs[start : start + 256], Qb, Sb))
    hs = sorted(hosted)
    host_blocks = [hs[i : i + 64] for i in range(0, len(hs), 64)]
    nd = align_batch._n_dispatch_workers(device)
    if nd <= 1 and not host_blocks:
        for t in tasks:
            run_chunk(*t)
    else:
        with StreamPool(max(nd, 2), device) as dev_pool, \
                _fut.ThreadPoolExecutor(
                    max_workers=align_batch._n_host_workers()) as host_pool:
            with profiling.trace("pairchain/overlap"):
                futs = [dev_pool.submit(run_chunk, *t) for t in tasks]
                futs += [host_pool.submit(run_host_block, b)
                         for b in host_blocks]
                for f in futs:
                    f.result()
    return out


def chain_and_align_many(
    pairs: list[tuple[np.ndarray, np.ndarray]],
    cfg: LesvConfig,
    extend: bool = True,
    k: int | None = None,
    global_fallback: bool = False,
    device="cuda",
) -> list[Alignment | None]:
    """Best-chain anchored alignment for each (q, s) pair, batched; with
    ``global_fallback``, pairs whose anchored alignment leaves an end
    unaligned fall back to the whole-span global DP."""
    k = k or cfg.memsc.kmer_size
    all_chains = batch_pair_chains(pairs, cfg, k=k, device=device)
    tasks = []
    mapping = []
    for i, ((q, s), chains) in enumerate(zip(pairs, all_chains)):
        if chains:
            runs = mem_anchors(q, s, chains[0].anchors, k,
                               cfg.memsc.mem_size)
            tasks.append((q, s, runs, k))
            mapping.append(i)
    outs = anchored_align_many(tasks, cfg.align, extend, device=device)
    res: list[Alignment | None] = [None] * len(pairs)
    for i, a in zip(mapping, outs):
        res[i] = a
    if global_fallback:
        _apply_global_fallback(pairs, res, cfg, device)
    return res


def _apply_global_fallback(pairs, res, cfg: LesvConfig, device,
                           end_gap: int = 128) -> None:
    """Replace alignments that leave more than ``end_gap`` unaligned at
    any end with the whole-span NW when that covers more of the span
    (``lesv_tpu.pipeline.batch_align._apply_global_fallback``).  The NW
    runs on the card's fill and traceback kernels for a ``cuda`` device
    (``align_batch.global_align_pairs_device``) and on the native host
    library otherwise (``global_align_pairs_host``: the plain torch fill of
    whole spans would be far slower on the CPU); both give the same
    answers.  ``FILL_STATS`` counts the pairs sent to the NW
    (``fallback_fills``) and the answers kept (``fallback_kept``)."""
    idxs = []
    for i, ((q, s), a) in enumerate(zip(pairs, res)):
        if len(q) == 0 or len(s) == 0:
            continue
        if (a is None or a.qb > end_gap or len(q) - a.qe > end_gap
                or a.sb > end_gap or len(s) - a.se > end_gap):
            idxs.append(i)
    if not idxs:
        return
    with profiling.trace("align/global_fallback"):
        span_pairs = [pairs[i] for i in idxs]
        if torch.device(device).type == "cuda":
            galns = align_batch.global_align_pairs_device(
                span_pairs, cfg.align, device)
        else:
            galns = global_align_pairs_host(span_pairs, cfg.align)
    kept = 0
    for i, ga in zip(idxs, galns):
        if ga is None:
            continue
        old = res[i]
        if old is None or ((ga.qe - ga.qb) + (ga.se - ga.sb)
                           > (old.qe - old.qb) + (old.se - old.sb)):
            res[i] = ga
            kept += 1
    align_batch._count_fills(fallback_fills=len(idxs), fallback_kept=kept)
