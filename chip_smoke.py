"""Smoke run of the lesv_tpu_torch port on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``device``: the card (``nvidia-smi`` name and power limit); fails
   without CUDA;
2. ``build``: the CUDA kernels from ``lesv_tpu_torch/csrc`` (nvcc, sm_90a,
   one nvcc per source, all at once) and the native host library (g++);
3. ``fill``: the int32 fill kernel against its plain PyTorch version at the
   shapes the map stage gives it (diag W=512, full W=4096, full W=65, diag
   with free_end), and the traceback kernel against its plain version on
   the kernel's direction bytes; then the int16 fill kernel at shapes where
   its gate holds (full Q=64 W=65, diag Q=256 W=512, diag Q=256 W=128 with
   free_end) against its plain int16 version (every live direction byte,
   score, end cell, ok) and against the int32 kernel (score, end cell, ok
   and the ops of the traceback kernel), the traceback kernel against its
   plain version on the int16 kernel's direction bytes, the traceback
   kernel on two probes of made-up direction bytes (``TRACEBACK_PROBES``:
   a walk along one row, a walk straight up a new row a step), the fill at
   the largest buckets of phase run's fill launch histogram
   (``FILL_HIST_SHAPES``: the int16 full-mode buckets of 1,024 and 256
   lanes and the two widest int32 diag buckets, on inputs of their own
   generator) against its plain version and, int16, against the int32
   kernel, ``fill_block`` at the whole-span NW's launches of the global
   fallback (``nw_spans``: 18 to 53 kb reads, diag W 8,192 and 32,768 and
   full W 16,385, each lane split over a cluster of 8 or 16 CTAs by
   ``align_torch.cluster_split``) against its plain version, one launch
   each from a reset, and
   ``align_batch.global_align_pairs_device`` on them against the native
   host NW and lesv_tpu's answers (``NW_ANSWERS_SHA256``), and one shape
   outside the gate, which must raise.  Exact equality (tolerance 0: all values
   are integers).  Each kernel is timed three ways: ``ms``, CUDA events
   around back-to-back calls (``cuda_ms``: the wrapper's host cost counts
   where it exceeds the kernel's); ``device_ms``, the same calls queued
   behind a sleeping kernel (the kernel's own time); ``host_ms``, the host
   clock to issue a call meanwhile (the wrapper's and the launcher's host
   cost; ``device_host_ms``);
4. ``chain``: the chain-scan kernel against its plain version at B=128,
   J=64, M=16384 and M=8192 -- exact equality, timed the same three ways;
5. ``map``: the map stage at a size users run: a 64 Mb simulated reference
   with planted SVs, 512 reads of mean length 12 kb at 10% error, mapped on
   the GPU through ``lesv_tpu_torch.pipeline.mapper.map_all``; every kernel
   must have launched, and the M4 records of the first 32 reads must equal
   those of the port's host engine (host seeding and chaining, plain fills
   on CPU tensors);
6. ``mesh``: a mesh over every visible card
   (``lesv_tpu_torch.parallel.mesh``).  ``mesh_fill`` at diag B=256 Q=256
   W=512 (int16 gate open) and diag B=256 Q=4096 W=512 (int32) against
   ``fill_cuda`` on one card and the plain version (every live direction
   byte, score, end cell, ok), timed in turns beside ``fill_cuda`` on the
   host clock with every card synchronised; ``sharded_align_step`` and
   ``sharded_seed_chain_step`` against the host sums of their per-lane
   outputs and against a mesh of one card; then the map configuration of
   phase ``map`` again under ``use_mesh``: the M4 records must equal phase
   ``map``'s and every kernel must launch under the mesh;
7. ``overlap``: 1,536 reads (three production batches; ``OVERLAP_READS``)
   mapped against phase ``map``'s reference and index in turns serial (S:
   one dispatch worker, one batch at a time, as the tests patch it) and
   overlapped (O: the defaults on a card, 8 dispatch workers and 2
   batches in flight, each worker on CUDA streams of its own): S, O, S, O,
   the second S and O under ``torch.profiler`` for the card's busy share
   (summed kernel time, and the union of kernel, copy and memset
   intervals, over the arm's wall time).  Every arm prints its wall
   seconds, bases/s and peak device memory, and must give the same M4
   records, launches per kernel, fill launches per shape and fills;
8. ``route``: lesv_tpu's routing of small work to the host
   (``align_batch._host_route``, ``_chunk_prefers_host``,
   ``batch_align._host_route_pairs``).  First the rates of its cost model
   on this card (``route_rates``: the native host fill on one worker and on
   the host pool, the fill kernel per state type at ``FILL_HIST_SHAPES``
   and above W=2,048, a chunk's fixed cost, the traceback a lane-step, a
   finish's readback), printed on one line as ``align_batch.CostRates``
   keywords beside the rates in use; then phase ``map``'s 512 reads in
   turns routing off (R0) and on (R1): R0, R1, R0, R1, each printing wall
   seconds, bases/s, launches, ``FILL_STATS`` and peak device memory; the
   M4 records of every arm must be equal.  Then ``map_all`` on plain
   ``cuda`` with ``LESV_TORCH_MESH=0`` (whole chunks dealt to the cards in
   turn) must equal the map on ``cuda:0`` and under a mesh of every card,
   with the fill chunks each card took (one card: all on it);
9. ``paths`` (``phase_paths``): the chain fetch on phase ``map``'s 512
   reads, the sliced fetch (``chain_torch.chain_lanes_sliced``, the
   pipeline's) and the full one in turns (S, A, S, A, the second pair
   under ``torch.profiler`` for the bytes read back): read seeding and
   chaining, equal chains and totals; the same for ``batch_pair_chains``
   on the reads' candidate windows; then ``map_read`` of the first 8
   reads, each equal to ``map_batch``'s records for it;
10. ``volumes`` (``phase_volumes``): the subject-volume loop
   (``mapper.map_all_volumes``), from a generator of its own.  V1: 512
   reads (mean 12 kb, 10% error; one with a 1.6 kb stretch at 35% error,
   for the int32 fill) against 8 chromosomes of 8 Mb (20 DEL +
   20 INS) in 4 volumes of 16 Mb, map batches of 128 (two in flight): the
   M4 records equal ``map_all``'s against one index of the whole reference,
   every kernel launches, the device bytes allocated after each volume do
   not grow, and a resume after one part file is removed rewrites that
   part and gives the same records.  V2: one volume holding an all-N
   chromosome of 2.2 Gb and an 8 Mb one; 64 reads of the second map to the
   same records as against it alone (all fields but the subject id), and
   the index's largest position and the largest live seed offset lie past
   2^31.  Per volume: index, upload and map seconds, the device index's
   bytes;
11. ``dist``: ``lesv_tpu_torch.parallel.dist.distributed_call`` on the
   first half of a 4 Mb reference with 5 DEL + 5 INS planted and reads at
   coverage 10 (``first_half``: cut in a wide gap between SVs), once
   with ``LocalExchange`` in this process and once as two spawned
   processes joined by ``TorchExchange`` over gloo (a ``file://``
   rendezvous under ``build/smoke_dist``), both on the cards present: the call
   lists must be equal field for field, on every rank.  A rank that fails
   or outlasts ``DIST_JOIN_S`` fails the phase;
12. ``run``: reads to a VCF through
   ``lesv_tpu_torch.pipeline.driver.run_pipeline(device="cuda")`` on a
   6 Mb simulated reference with 10 DEL + 10 INS planted and reads at
   coverage 8 (mean 12 kb, 10% error; a generator of its own,
   ``RUN_SEED``): per-stage seconds and record
   counts, launches per kernel for the map stage and for the stages after
   it (every kernel must launch in both), the fill's launches by shape
   (``_ext.FILL_SHAPES``: the eight largest keys, the eight largest buckets
   summed over B, the four largest int32 buckets), recall and precision of
   the calls
   against the planted truth (both at least 0.9), ``calls.vcf`` parsed
   back, and a second call with ``resume=True`` that returns the same calls
   without launching a kernel.  The run is overlapped (the default); then
   the stages after map run again serially into their own directory from
   the overlapped run's map checkpoint, and ``calls.vcf``,
   ``remapped.sam``, every stage ``.npz``, the launches and the fill
   shapes after map must be equal.  Host-clock spans sum over the worker
   threads, so a span's total can exceed the wall time;
13. ``accuracy`` (``phase_accuracy``): the F1 harness
   ``tools/torch_f1_eval.py`` (``run_case``: the diploid simulation with
   its TRF bed as ``trf_intervals``, reads to calls, scored by truvari's
   matching rules) on the card.  (a) The pinned case (``PINNED_ARGS``,
   seed ``PINNED_SEED``: 60 kb, a het DEL and a hom INS inside a tandem
   array) with routing off: fill_i16, chain and traceback must launch, and
   its ``eval``, its calls (kind, pos, length, support, genotype) with
   their digest, and the bytes of ``calls.vcf`` must equal the constants
   ``PINNED_*``, which tests/test_torch_tools_pinned.py holds to
   lesv_tpu's own ``tools/f1_eval.py`` on the CPU.  (b) ACCURACY_r05.json's configuration
   (1 Mb, coverage 20, 30 SVs, het 0.4, TRF 0.15, cluster 0.1, error 0.08,
   mean read 12 kb), seed 0, at the default routing: its ``eval`` and call
   count must equal the record's "ours" (``ACCURACY_EVAL``).  Each prints
   wall seconds, stage seconds, bases/s, peak RSS and device memory,
   launches per kernel (the int32 fill, ``fill_block`` above W=2,048),
   fills to the card and to the host, and the fill launch histogram.  (c)
   ``recall_cached`` over (b)'s stage files at the default ``LesvConfig()``
   must give (b)'s ``eval``.

Phases ``map``, ``mesh``, ``overlap``, ``volumes``, ``dist`` and
``accuracy`` (a) run with the routing off (``host_routing(False)``), so
that they compare with the runs before it (and (a)'s fills launch on the
card); phases ``run`` and ``accuracy`` (b) run the default, routing on.

Then each phase's wall seconds (``phase="seconds"``), the card's
``nvidia-smi`` line, the kernel table (the traceback at
diag Q=4096 W=512 with diag Q=256 W=512 under ``other_shapes``, each fill
with its histogram buckets under ``other_shapes``) and
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero.

Bounds in the kernel table: ``bound_ms`` is the larger of the bytes the
function must move (inputs read once, outputs written once, counted from
this run's lengths) over 3.35 TB/s, and the integer operations of its
recurrence on this run's inputs, counted as a sequential walk of one lane
would do them (nothing of this kernel's two-phase scan), over the rate of
the CUDA cores for their type: 16.75 TOP/s in int32 (64 int32 lanes per SM
against 128 float32 lanes with a two-operation FMA, so a quarter of the
published 67 TFLOP/s float32 rate) and twice that, 33.5 TOP/s, for the
int16 fill, whose operations exist as packed two-values-per-lane
instructions.
No single PyTorch call computes any of these functions, so ``library_ms``
is null.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pickle
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# phase run: cut from 16 Mb / 20 + 20 SVs when the mesh and dist phases
# were added, and from 8 Mb at coverage 10 when phase accuracy was, so
# that the whole script stays near half its time limit.  Its world comes
# from a generator of its own: at the default routing its map stage
# launches every kernel only where some map batch holds more small fills
# than the host's budget (align_batch._host_route), which this world's
# do and some others of this size do not; at coverage 6 the calls fall
# below the phase's recall of 0.9
RUN_SEED = 11
RUN_GENOME_BP = 6_000_000
RUN_COVERAGE = 8.0
RUN_N_SV = 10               # of each kind, DEL and INS
# phase dist draws a 4 Mb world and runs on its first half, cut when phase
# accuracy was added
DIST_GENOME_BP = 4_000_000
DIST_N_SV = 5
DIST_JOIN_S = 600           # a rank still alive after this is killed
OVERLAP_READS = 1_536       # three production batches of 512, two in flight
PATHS_MAP_READ = 8          # reads phase paths maps one by one
# phase volumes: V1 8 chromosomes of 8 Mb in volumes of 16 Mb (4 volumes),
# 512 reads in map batches of 128 (two in flight); V2 an all-N chromosome
# of 2.2 Gb before an 8 Mb one, so that every position of the second lies
# past 2^31 in one volume
VOL_CHROMS = 8
VOL_CHROM_BP = 8_000_000
VOL_RES = 16_000_000
VOL_READS = 512
VOL_BATCH_READS = 128
VOL_N_BP = 2_200_000_000
VOL_FAR_READS = 64
VOL_FAR_EDGE = 20_000       # V2's reads start and end this far from the ends
# phase accuracy (a): the pinned diploid case of tools/torch_f1_eval.py
# (a het DEL and a hom INS inside a tandem array of the TRF bed), and what
# lesv_tpu's tools/f1_eval.py gives on it on the CPU
# (tests/test_torch_tools_pinned.py holds both tools to these constants)
PINNED_SEED = 6
PINNED_ARGS = dict(genome=60_000, coverage=10.0, err=0.08, mean_len=5_000,
                   n_sv=3, min_len=40, max_len=1_500, het_frac=0.5,
                   trf=True, trf_frac=0.5, cluster_frac=0.0)
PINNED_EVAL = dict(tp=2, fp=0, fn=0, precision=1.0, recall=1.0, f1=1.0,
                   recall_non_trf=1.0, f1_non_trf=1.0, gt_concordance=1.0)
PINNED_CALLS = [["DEL", 21253, 466, 4, "0/1"], ["INS", 32211, 110, 8, "1/1"]]
PINNED_CALLS_DIGEST = ("4d9e83dd83529db1dcd2b5a91df881a4"
                       "315f048278b8907728b3fe6cccd5409a")
PINNED_VCF_BYTES = 1_281
PINNED_VCF_SHA256 = ("a7a0a33ef4f23fc7445307190b5ab1aa"
                     "d0e121aed1e344dc949ae3cb14b1946d")
# phase accuracy (b): ACCURACY_r05.json's configuration, seed 0, and its
# "ours" record (lesv_tpu's tools/f1_eval.py)
ACCURACY_SEED = 0
ACCURACY_ARGS = dict(genome=1_000_000, coverage=20.0, err=0.08,
                     mean_len=12_000, n_sv=30, min_len=40, max_len=30_000,
                     het_frac=0.4, trf=True, trf_frac=0.15, cluster_frac=0.1)
ACCURACY_EVAL = dict(tp=27, fp=0, fn=3, precision=1.0, recall=0.9,
                     f1=0.9474, recall_non_trf=0.8929, f1_non_trf=0.9434,
                     gt_concordance=0.8148)
ACCURACY_CALLS = 27
# phase fill's whole-span NW spans (``nw_spans``, seed ``NW_SEED``): the
# global fallback's fills at the evidence cells' sizes, and the digests of
# their inputs and of lesv_tpu's ``global_align_pairs_host`` answers on
# them (tests/test_torch_global_fallback.py holds lesv_tpu to these on the
# CPU)
NW_SEED = 15
NW_SPANS_SHA256 = ("116d34f9e08f55d81dae8d43e734076e"
                   "52fc2e823254080de8ed8db6adaf39da")
NW_ANSWERS_SHA256 = ("d94772314092cd799a7a4cd1dc35472a"
                     "4b8297cc4f15eb6cdf6dea941afc5e7b")
SPANS_NOTE = ("span totals sum over the worker threads, so a total can "
              "exceed the wall time")

HBM_BYTES_S = 3.35e12
INT32_OPS_S = 67e12 / 4
INT16_OPS_S = 2 * INT32_OPS_S  # packed pairs of 16-bit values per lane
# integer operations of one DP cell of the fill recurrence, walked in
# sequence: substitution 2 (compare, select), diagonal 1 (add), F1/F2 6
# (extend, open, max, twice), E1/E2 6 (the same along the row), H 4 (max of
# five), band mask 3, extension flags 4 (compares), source 8 (four compares
# and selects), byte packing 8 (four shifts and ors)
FILL_OPS_PER_CELL = 42
# one (seed, predecessor) pair of the chain scan: distances 9, gates 11,
# score 9, running best 5
CHAIN_OPS_PER_PAIR = 34
# one traceback step: address 4, decode 8, state update 8
TRACEBACK_OPS_PER_STEP = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Time of one call: CUDA events around ``reps`` calls after a warm-up
    call.  Where the wrapper's host cost exceeds the kernel's time, the
    card idles between launches and that cost is counted too."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_host_ms(fn, reps: int) -> tuple[float, float]:
    """(device time, host time) of one call, both from ``reps`` calls that
    the host queues behind a sleeping kernel: CUDA events around them give
    the device time (the launches run back to back whatever the wrapper's
    host cost), the host clock around issuing them the host cost of a call
    (wrapper and launcher, none of the kernel's time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    busy_s = time.perf_counter() - t0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * busy_s * 2e9) + 100_000)  # cycles
    a.record()
    t1 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t1
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps, host_s / reps * 1e3


def once_ms(fn):
    import torch

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


def bound(nbytes: int, ops: int, ops_s: float = INT32_OPS_S) -> dict:
    by, op = nbytes / HBM_BYTES_S * 1e3, ops / ops_s * 1e3
    return dict(bound_ms=max(by, op),
                bound_by="bytes" if by >= op else "operations",
                bound_bytes=nbytes, bound_ops=ops)


def fill_case(rng, kind: str):
    """(q, s, qlen, slen, W, mode, free_end) numpy batch of one shape."""
    import numpy as np

    from lesv_tpu_torch.sim import mutate_read

    def rand(n):
        return rng.integers(0, 4, int(n)).astype(np.uint8)

    if kind == "diag_W512":
        B, Q, W, mode, fe = 256, 4096, 512, "diag", False
        pairs = []
        for _ in range(B):
            s = rand(rng.integers(3600, 4000))
            pairs.append((mutate_read(rng, s, err=0.1)[:Q], s))
        S = Q + W
    elif kind == "full_W4096_del":
        B, Q, W, mode, fe = 8, 128, 4096, "full", False
        pairs = []
        for _ in range(B):
            s = rand(2100)
            cut = int(rng.integers(30, 70))
            q = np.concatenate([s[:cut], s[cut + 2000 :]])
            pairs.append((mutate_read(rng, q, err=0.05)[:Q], s))
        S = W
    elif kind in ("full_W65", "i16_full_Q64_W65"):
        B, Q, W, mode, fe = 1024, 64, 65, "full", False
        pairs = []
        for _ in range(B):
            s = rand(rng.integers(20, 64))
            pairs.append((mutate_read(rng, s, err=0.2)[:Q], s))
        S = 64
    elif kind == "i16_diag_Q256_W512":
        B, Q, W, mode, fe = 256, 256, 512, "diag", False
        pairs = []
        for _ in range(B):
            s = rand(rng.integers(130, 256))
            pairs.append((mutate_read(rng, s, err=0.15)[:Q], s))
        S = Q + W
    elif kind == "i16_diag_Q256_W128_free_end":
        B, Q, W, mode, fe = 256, 256, 128, "diag", True
        pairs = []
        for _ in range(B):
            s = rand(384)
            n = int(rng.integers(60, 256))
            q = np.concatenate([mutate_read(rng, s[:n], err=0.1), rand(120)])
            pairs.append((q[:Q], s))
        S = Q + W
    else:  # "diag_W1024_free_end": end-extension blocks
        B, Q, W, mode, fe = 64, 2048, 1024, "diag", True
        pairs = []
        for _ in range(B):
            s = rand(2624)
            n = int(rng.integers(600, 1800))
            q = np.concatenate([mutate_read(rng, s[:n], err=0.1), rand(400)])
            pairs.append((q[:Q], s))
        S = Q + W
    q = np.zeros((B, Q), np.uint8)
    s = np.zeros((B, S), np.uint8)
    qlen = np.zeros(B, np.int32)
    slen = np.zeros(B, np.int32)
    for i, (qi, si) in enumerate(pairs):
        si = si[:S]
        q[i, : len(qi)] = qi
        s[i, : len(si)] = si
        qlen[i], slen[i] = len(qi), len(si)
    return q, s, qlen, slen, W, mode, fe


# the largest buckets of the fill launch histogram of phase run
# (``fill_buckets``), as (state type, mode, free_end, Qmax, W, B): B is the
# bucket's lane count (``align_batch._lanes_for``)
FILL_HIST_SHAPES = [("i16", "full", False, 64, 64, 1024),
                    ("i16", "full", False, 128, 128, 1024),
                    ("i16", "full", False, 256, 256, 256),
                    ("i32", "diag", False, 4096, 2048, 8),
                    ("i32", "diag", False, 2048, 1024, 64)]


# fill_block (W above 2,048) at the shapes tools/torch_kernel_ab.py times,
# as (mode, Qmax, W, B) of ``hist_case``, in the state type the gate picks:
# the map's full-mode buckets of W 4,096 and 8,192 at their lane counts
# (``align_batch._lanes_for``) and its diag bucket of Q 4,096, W 4,096; the
# NW's full W 2,049 (runs of three slots) at 64 lanes; one NW lane each,
# diag W 32,768 and full W 16,385 (the row state in the global scratch at
# one CTA a lane, in shared memory when split over a cluster of 16)
FILL_BLOCK_SHAPES = [("full", 128, 4096, 64), ("full", 1024, 4096, 8),
                     ("full", 256, 8192, 64), ("full", 2048, 8192, 8),
                     ("diag", 4096, 4096, 8), ("full", 2048, 2049, 64),
                     ("diag", 4096, 32768, 1), ("full", 8192, 16385, 1)]


def hist_case(rng, shape):
    """(q, s, qlen, slen, W, mode, free_end) numpy batch of one bucket of
    the histogram: B lanes of query lengths in (Qmax/2, Qmax], subjects of
    a length the bucketing puts in this band (full: W/2 to W - 1; diag:
    about the query's), reads at 10% error; free_end lanes end in 20%
    random bases."""
    import numpy as np

    from lesv_tpu_torch.sim import mutate_read

    _, mode, fe, Q, W, B = shape
    S = W if mode == "full" else Q + W
    q = np.zeros((B, Q), np.uint8)
    s = np.zeros((B, S), np.uint8)
    qlen = np.zeros(B, np.int32)
    slen = np.zeros(B, np.int32)
    for i in range(B):
        if mode == "full":
            ls = int(rng.integers(W // 2, W))
        else:
            ls = int(rng.integers(Q // 2 + 1, Q + 1))
        si = rng.integers(0, 4, ls).astype(np.uint8)
        qi = mutate_read(rng, si, err=0.1)
        if fe:
            cut = int(0.8 * len(qi))
            qi = np.concatenate([qi[:cut], rng.integers(0, 4, len(qi) - cut)
                                 .astype(np.uint8)])
        qi = qi[: Q] if len(qi) > Q // 2 else np.resize(qi, Q // 2 + 1)
        q[i, : len(qi)] = qi
        s[i, :ls] = si[:S]
        qlen[i], slen[i] = len(qi), min(ls, S)
    return q, s, qlen, slen, W, mode, fe


def fill_bound(qln, sln, W, ops_s: float = INT32_OPS_S) -> dict:
    """Least time of one fill: q and s read once, one direction byte per
    cell of the rows 0..qlen written once, the 13 bytes of results per
    lane; FILL_OPS_PER_CELL operations per cell of the rows 1..qlen, at
    ops_s operations a second."""
    rows = int(qln.sum())
    B = len(qln)
    return bound(rows + int(sln.sum()) + 8 * B + (rows + B) * W + 13 * B,
                 rows * W * FILL_OPS_PER_CELL, ops_s)


def _fill_outputs_equal(a, b, qlen, dirs: bool):
    """(all equal, dirs equal on live rows, max |difference| of the score,
    end cell and ok)."""
    import torch

    ad, asc, aei, aeb, aok = a
    bd, bsc, bei, beb, bok = b
    err = max(int((asc - bsc).abs().max()), int((aei - bei).abs().max()),
              int((aeb - beb).abs().max()),
              int((aok.int() - bok.int()).abs().max()))
    dirs_eq = True
    if dirs:
        live = (torch.arange(ad.shape[1], device=ad.device)[None, :, None]
                <= qlen[:, None, None])
        dirs_eq = not bool(torch.where(live, ad != bd, False).any())
    return err == 0 and dirs_eq, dirs_eq, err


# two traceback probes on made-up direction bytes, (B, R, W, mode, byte,
# end row, end slot): "erun" walks 8,191 E steps along row 0 of a full
# W=8192 band to the origin (the walk alone: one row staged), "mrun" 4,096
# M steps straight up a diag W=512 band of 4,097 rows (a new row every
# step, so the staging keeps pace or the walk waits)
TRACEBACK_PROBES = dict(erun=(132, 4, 8192, "full", 0x09, 0, 8191),
                        mrun=(256, 4097, 512, "diag", 0x00, 4096, 256))


def nw_spans():
    """The whole-span NW pairs of phase fill, (read, subject) at 10% read
    error: an 18 kb read across a 2.5 kb DEL (diag, W 8,192); a 53 kb and a
    50 kb read across a 13 kb and a 10 kb INS, each on 40 kb of subject
    (diag, W 32,768: one launch of two lanes); an 8 kb read across an 8.4 kb
    DEL (full, W 16,385: a width of no whole runs).  ``fill_block`` splits
    each lane over a cluster of 8 or 16 CTAs (``align_torch.cluster_split``),
    the row state in shared memory."""
    import numpy as np

    from lesv_tpu_torch.sim import mutate_read

    rng = np.random.default_rng(NW_SEED)
    pairs = []
    for flank, sv, kind in ((9_000, 2_500, "DEL"), (20_000, 13_000, "INS"),
                            (20_000, 10_000, "INS"), (4_000, 8_384, "DEL")):
        a, x, b = (rng.integers(0, 4, n).astype(np.uint8)
                   for n in (flank, sv, flank))
        read = np.concatenate([a, x, b] if kind == "INS" else [a, b])
        subject = np.concatenate([a, b] if kind == "INS" else [a, x, b])
        pairs.append((mutate_read(rng, read, err=0.1), subject))
    return pairs


def nw_digest(pairs, alns=None) -> str:
    """sha256 of NW pairs (``alns`` None) or of their Alignments: each
    one's (qb, qe, sb, se, score) and ops, ``none`` for a pair without
    one."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for k, (q, s) in enumerate(pairs):
        if alns is None:
            h.update(np.array([len(q), len(s)], np.int64).tobytes())
            h.update(np.ascontiguousarray(q, np.uint8).tobytes())
            h.update(np.ascontiguousarray(s, np.uint8).tobytes())
        elif alns[k] is None:
            h.update(b"none")
        else:
            a = alns[k]
            h.update(np.array([a.qb, a.qe, a.sb, a.se, a.score],
                              np.int64).tobytes())
            h.update(np.ascontiguousarray(a.ops, np.uint8).tobytes())
    return h.hexdigest()


def nw_span_cases(cfg, dev):
    """``fill_block`` at the whole-span NW's launches (``nw_spans``, one
    launch per band bucket, as ``align_batch.global_align_pairs_device``
    packs them): the int32 fill kernel against its plain version (every
    live direction byte, score, end cell, ok), one fill launch from a reset
    each; then ``global_align_pairs_device`` on the card against the
    port's native host NW and against lesv_tpu's answers
    (``NW_ANSWERS_SHA256``), with its launches, counts and seconds."""
    import ctypes

    import numpy as np
    import torch

    from lesv_tpu_torch import _ext
    from lesv_tpu_torch.ops import align_batch as ab
    from lesv_tpu_torch.ops import align_torch as at

    pairs = nw_spans()
    if nw_digest(pairs) != NW_SPANS_SHA256:
        raise AssertionError("nw_spans: the inputs differ from the pinned")
    launches = [([0], 8192, "diag"), ([2, 1], 32768, "diag"),
                ([3], 16385, "full")]
    for idxs, W, mode in launches:
        if [ab._nw_band0(len(pairs[i][0]), len(pairs[i][1]))
                for i in idxs] != [W] * len(idxs):
            raise AssertionError(f"nw_spans {idxs}: not at band {W}")
        Q = len(pairs[idxs[-1]][0])
        S = Q + W if mode == "diag" else W
        B = len(idxs)
        qn = np.zeros((B, Q), np.uint8)
        sn = np.zeros((B, S), np.uint8)
        qln = np.array([len(pairs[i][0]) for i in idxs], np.int32)
        sln = np.array([len(pairs[i][1]) for i in idxs], np.int32)
        for j, i in enumerate(idxs):
            qn[j, : qln[j]] = pairs[i][0]
            sn[j, : sln[j]] = pairs[i][1]
        q, s, ql, sl = (torch.from_numpy(x).to(dev)
                        for x in (qn, sn, qln, sln))
        if at.i16_ok(Q, W, cfg):
            raise AssertionError(f"nw_spans {idxs}: the int16 gate holds")
        _ext.reset_launches()
        k_ms, kout = once_ms(
            lambda: at.fill_cuda(q, s, ql, sl, W, mode, cfg, False))
        n_launched = dict(_ext.LAUNCHES)
        p_ms, pout = once_ms(lambda: at.banded_align_kernel(
            q, s, ql, sl, W, mode, cfg, False))
        eq, dirs_eq, err = _fill_outputs_equal(kout, pout, ql, dirs=True)
        split = at.fill_split(B, W, dev)
        state = _ext.function("fill", "lesv_fill_state_bytes",
                              [_ext.I] * 3, ctypes.c_longlong)(W, split, 4)
        cells = int(qln.sum()) * W
        emit(dict(phase="fill", kernel="fill", case="nw_span",
                  shape=f"{mode} B={B} Q={Q} W={W}", equal=eq,
                  dirs_equal=dirs_eq, max_abs_err=err, split=split,
                  global_scratch=state > at.SMEM_CAP,
                  fill_launches=n_launched["fill"], kernel_ms=k_ms,
                  plain_ms=p_ms, kernel_gcells_s=cells / k_ms / 1e6))
        if not eq or n_launched["fill"] != 1 or sum(n_launched.values()) != 1:
            raise AssertionError(f"nw_span fill {mode} W={W}: mismatch or "
                                 f"launches {n_launched}")
        del kout, pout, q, s
    _ext.reset_launches()
    ab.reset_fill_stats()
    t0 = time.time()
    got = ab.global_align_pairs_device(pairs, cfg, dev)
    card_s = time.time() - t0
    n_launched, card = dict(_ext.LAUNCHES), dict(ab.FILL_STATS)
    ab.reset_fill_stats()
    t0 = time.time()
    want = ab.global_align_pairs_host(pairs, cfg)
    host_s = time.time() - t0
    host = dict(ab.FILL_STATS)
    eq_host = nw_digest(pairs, got) == nw_digest(pairs, want)
    eq_jax = nw_digest(pairs, got) == NW_ANSWERS_SHA256
    emit(dict(phase="fill", kernel="fill", case="nw_global_align",
              pairs=len(pairs), equal_host=eq_host, equal_lesv_tpu=eq_jax,
              launches=n_launched, fallback_device_fills=card[
                  "fallback_device_fills"],
              fallback_cells=card["fallback_cells"], card_s=card_s,
              host_s=host_s))
    if not (eq_host and eq_jax and all(a is not None for a in got)
            and n_launched["fill"] == n_launched["traceback"] == 3
            and card["fallback_device_fills"] == len(pairs)
            and card["fallback_device_cells"] == card["fallback_cells"]
            == host["fallback_cells"]):
        raise AssertionError("nw_global_align: the card's NW differs")


def traceback_probe(name: str, dev):
    """(dirs, end_i, end_b, ok, W, mode, T) of a traceback probe on
    ``dev``: every lane the same walk, T = R + W + 2."""
    import torch

    B, R, W, mode, byte, ei, eb = TRACEBACK_PROBES[name]
    dirs = torch.full((B, R, W), byte, dtype=torch.uint8, device=dev)
    end_i = torch.full((B,), ei, dtype=torch.int32, device=dev)
    end_b = torch.full((B,), eb, dtype=torch.int32, device=dev)
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    return dirs, end_i, end_b, ok, W, mode, R + W + 2


def fill_hist_cases(stats, cfg, dev):
    """The fill kernel at the largest buckets of `run`'s launch histogram
    (``FILL_HIST_SHAPES``) against its plain version, int16 also against
    the int32 kernel; on inputs of their own generator, so that the world
    of the later phases stays as it was."""
    import numpy as np
    import torch

    from lesv_tpu_torch.ops import align_torch as at

    hrng = np.random.default_rng(1)
    for shape in FILL_HIST_SHAPES:
        qn, sn, qln, sln, W, mode, fe = hist_case(hrng, shape)
        q, s, ql, sl = (torch.from_numpy(x).to(dev)
                        for x in (qn, sn, qln, sln))
        i16 = shape[0] == "i16"
        B, Q = q.shape
        if i16 != at.i16_ok(Q, W, cfg):
            raise AssertionError(f"{shape}: the int16 gate disagrees")

        def kern():
            return at.fill_cuda(q, s, ql, sl, W, mode, cfg, fe, i16=i16)

        k_ms = cuda_ms(kern, 5)
        k_dev, k_host = device_host_ms(kern, 5)
        kout = kern()
        p_ms, pout = once_ms(lambda: at.banded_align_kernel(
            q, s, ql, sl, W, mode, cfg, fe, i16=i16))
        eq, dirs_eq, err = _fill_outputs_equal(kout, pout, ql, dirs=True)
        eq32 = ops_eq = True
        if i16:
            # int16 against the int32 kernel: score, end cell, ok, ops
            wout = at.fill_cuda(q, s, ql, sl, W, mode, cfg, fe, i16=False)
            eq32, _, err32 = _fill_outputs_equal(kout, wout, ql, dirs=False)
            err = max(err, err32)
            T = Q + 1 + W + 2
            ops_eq = all(torch.equal(a, b) for a, b in zip(
                at.traceback_cuda(kout[0], kout[2], kout[3], kout[4], W,
                                  mode, T),
                at.traceback_cuda(wout[0], wout[2], wout[3], wout[4], W,
                                  mode, T)))
        fb = fill_bound(qln, sln, W, INT16_OPS_S if i16 else INT32_OPS_S)
        name = "fill_i16" if i16 else "fill"
        row = dict(ms=k_ms, device_ms=k_dev, host_ms=k_host, plain_ms=p_ms,
                   max_abs_err=err,
                   shape=f"{mode}{' free_end' if fe else ''} B={B} Q={Q} "
                         f"W={W}", **fb)
        emit(dict(phase="fill", kernel=name, case="histogram", equal=eq,
                  dirs_equal=dirs_eq, equal_i32_kernel=eq32,
                  ops_equal_i32_kernel=ops_eq,
                  kernel_gcells_s=int(qln.sum()) * W / k_ms / 1e6, **row))
        if not (eq and eq32 and ops_eq):
            raise AssertionError(f"fill mismatch at histogram shape {shape}")
        stats.setdefault(f"{name}_hist", []).append(row)


def phase_fill(rng, stats):
    import torch

    from lesv_tpu_torch.config import AlignConfig
    from lesv_tpu_torch.ops import align_torch as at

    cfg = AlignConfig()
    dev = torch.device("cuda")

    def upload(kind):
        qn, sn, qln, sln, W, mode, fe = fill_case(rng, kind)
        t = [torch.from_numpy(x).to(dev) for x in (qn, sn, qln, sln)]
        return t, qln, sln, W, mode, fe

    for kind in ("diag_W512", "full_W4096_del", "full_W65",
                 "diag_W1024_free_end"):
        (q, s, ql, sl), qln, sln, W, mode, fe = upload(kind)
        B, Q = q.shape

        def kern():
            return at.fill_cuda(q, s, ql, sl, W, mode, cfg, fe)

        k_ms = cuda_ms(kern, 3)
        k_dev, k_host = device_host_ms(kern, 3)
        kout = kern()
        kd, ks, kei, keb, kok = kout
        p_ms, pout = once_ms(
            lambda: at.banded_align_kernel(q, s, ql, sl, W, mode, cfg, fe))
        eq, dirs_eq, err = _fill_outputs_equal(kout, pout, ql, dirs=True)
        # traceback on the kernel's direction bytes
        T = Q + 1 + W + 2

        def tb():
            return at.traceback_cuda(kd, kei, keb, kok, W, mode, T)

        t_ms = cuda_ms(tb, 3)
        t_dev, t_host = device_host_ms(tb, 3)
        kops, kn, kr = tb()
        tp_ms, (pops, pn, pr) = once_ms(
            lambda: at.traceback_plain(kd, kei, keb, kok, W, mode, T))
        tb_eq = (torch.equal(kops, pops) and torch.equal(kn, pn)
                 and torch.equal(kr, pr))
        cells = int(qln.sum()) * W
        steps = int(kn.sum())
        fb = fill_bound(qln, sln, W)
        # traceback: one direction byte read per step, T op bytes and 13
        # bytes of end cell / results per lane
        tbb = bound(steps + B * T + 13 * B, steps * TRACEBACK_OPS_PER_STEP)
        emit(dict(phase="fill", kernel="fill", case=kind, B=B, Q=Q, W=W,
                  mode=mode, free_end=fe, equal=eq, dirs_equal=dirs_eq,
                  max_abs_err=err, kernel_ms=k_ms, kernel_device_ms=k_dev,
                  kernel_host_ms=k_host, plain_ms=p_ms,
                  bound_ms=fb["bound_ms"], bound_by=fb["bound_by"],
                  kernel_gcells_s=cells / k_ms / 1e6,
                  plain_gcells_s=cells / p_ms / 1e6,
                  traceback_equal=tb_eq, traceback_ms=t_ms,
                  traceback_device_ms=t_dev, traceback_host_ms=t_host,
                  traceback_plain_ms=tp_ms,
                  traceback_bound_ms=tbb["bound_ms"],
                  traceback_steps=steps,
                  traceback_lanes_s=B / t_ms * 1e3,
                  reached=int(kr.sum())))
        if not (eq and tb_eq):
            raise AssertionError(f"fill/traceback mismatch in {kind}")
        if kind == "diag_W512":
            stats["fill"] = dict(ms=k_ms, device_ms=k_dev, host_ms=k_host,
                                 plain_ms=p_ms, max_abs_err=err,
                                 shape=f"diag B={B} Q={Q} W={W}", **fb)
            stats["traceback"] = dict(
                ms=t_ms, device_ms=t_dev, host_ms=t_host, plain_ms=tp_ms,
                max_abs_err=0,
                shape=f"diag B={B} R={Q + 1} W={W} T={T}", **tbb)

    for kind in ("i16_full_Q64_W65", "i16_diag_Q256_W512",
                 "i16_diag_Q256_W128_free_end"):
        (q, s, ql, sl), qln, sln, W, mode, fe = upload(kind)
        B, Q = q.shape
        if not at.i16_ok(Q, W, cfg):
            raise AssertionError(f"{kind}: the int16 gate should hold")

        def kern16():
            return at.fill_cuda(q, s, ql, sl, W, mode, cfg, fe, i16=True)

        def kern32():
            return at.fill_cuda(q, s, ql, sl, W, mode, cfg, fe, i16=False)

        # in turns: int32, int16, int16, int32
        a32 = cuda_ms(kern32, 5)
        a16 = cuda_ms(kern16, 5)
        b16 = cuda_ms(kern16, 5)
        b32 = cuda_ms(kern32, 5)
        k_ms, k32_ms = (a16 + b16) / 2, (a32 + b32) / 2
        k_dev, k_host = device_host_ms(kern16, 5)
        kout, wout = kern16(), kern32()
        p_ms, pout = once_ms(lambda: at.banded_align_kernel(
            q, s, ql, sl, W, mode, cfg, fe, i16=True))
        eq, dirs_eq, err = _fill_outputs_equal(kout, pout, ql, dirs=True)
        eq32, _, err32 = _fill_outputs_equal(kout, wout, ql, dirs=False)
        T = Q + 1 + W + 2

        def tb16():
            return at.traceback_cuda(kout[0], kout[2], kout[3], kout[4], W,
                                     mode, T)

        t_ms = cuda_ms(tb16, 5)
        t_dev, t_host = device_host_ms(tb16, 5)
        t16 = tb16()
        t32 = at.traceback_cuda(wout[0], wout[2], wout[3], wout[4], W, mode,
                                T)
        ops_eq = all(torch.equal(a, b) for a, b in zip(t16, t32))
        tp_ms, tplain = once_ms(lambda: at.traceback_plain(
            kout[0], kout[2], kout[3], kout[4], W, mode, T))
        tb_eq = all(torch.equal(a, b) for a, b in zip(t16, tplain))
        steps = int(t16[1].sum())
        tbb = bound(steps + B * T + 13 * B, steps * TRACEBACK_OPS_PER_STEP)
        cells = int(qln.sum()) * W
        fb = fill_bound(qln, sln, W, INT16_OPS_S)
        emit(dict(phase="fill", kernel="fill_i16", case=kind, B=B, Q=Q, W=W,
                  mode=mode, free_end=fe, equal_plain_i16=eq,
                  dirs_equal=dirs_eq, max_abs_err=err,
                  equal_i32_kernel=eq32, max_abs_err_vs_i32=err32,
                  ops_equal_i32_kernel=ops_eq, kernel_ms=k_ms,
                  kernel_device_ms=k_dev, kernel_host_ms=k_host,
                  i32_kernel_ms=k32_ms, plain_ms=p_ms,
                  bound_ms=fb["bound_ms"], bound_by=fb["bound_by"],
                  kernel_gcells_s=cells / k_ms / 1e6,
                  traceback_equal=tb_eq, traceback_ms=t_ms,
                  traceback_device_ms=t_dev, traceback_host_ms=t_host,
                  traceback_plain_ms=tp_ms,
                  traceback_bound_ms=tbb["bound_ms"],
                  traceback_steps=steps,
                  reached=int(t16[2].sum())))
        if not (eq and eq32 and ops_eq and tb_eq):
            raise AssertionError(f"int16 fill mismatch in {kind}")
        if not bool(t16[2].any()):
            raise AssertionError(f"{kind}: no lane traced back")
        if kind == "i16_diag_Q256_W512":
            stats["fill_i16"] = dict(ms=k_ms, device_ms=k_dev,
                                     host_ms=k_host, plain_ms=p_ms,
                                     max_abs_err=max(err, err32),
                                     i32_kernel_ms=k32_ms,
                                     shape=f"diag B={B} Q={Q} W={W}", **fb)
            # the traceback after the int16 fills of the table shape
            stats["traceback_q256"] = dict(
                ms=t_ms, device_ms=t_dev, host_ms=t_host, plain_ms=tp_ms,
                max_abs_err=0,
                shape=f"diag B={B} R={Q + 1} W={W} T={T}", **tbb)

    fill_hist_cases(stats, cfg, dev)
    nw_span_cases(cfg, dev)

    for name in TRACEBACK_PROBES:
        d, ei, eb, ok, W, mode, T = traceback_probe(name, dev)

        def tbp():
            return at.traceback_cuda(d, ei, eb, ok, W, mode, T)

        t_ms = cuda_ms(tbp, 5)
        t_dev, t_host = device_host_ms(tbp, 5)
        got = tbp()
        tp_ms, want = once_ms(
            lambda: at.traceback_plain(d, ei, eb, ok, W, mode, T))
        eq = all(torch.equal(a, b) for a, b in zip(got, want))
        steps = int(got[1].max())
        emit(dict(phase="fill", kernel="traceback", case=f"probe_{name}",
                  B=d.shape[0], R=d.shape[1], W=W, mode=mode, T=T,
                  equal=eq, traceback_ms=t_ms, traceback_device_ms=t_dev,
                  traceback_host_ms=t_host, traceback_plain_ms=tp_ms,
                  steps_per_lane=steps,
                  device_ns_per_step=t_dev / steps * 1e6))
        if not (eq and bool(got[2].all())):
            raise AssertionError(f"traceback probe {name}: mismatch or a "
                                 "lane that did not reach the origin")
        del d

    # outside the gate the int16 kernel is refused, not wrapped
    (q, s, ql, sl), _, _, W, mode, fe = upload("diag_W512")
    try:
        at.fill_cuda(q, s, ql, sl, W, mode, cfg, fe, i16=True)
    except ValueError as e:
        emit(dict(phase="fill", kernel="fill_i16", case="gate_closed_Q4096",
                  raised=str(e)))
    else:
        raise AssertionError("int16 fill outside its gate did not raise")


def chain_case(rng, M: int, B: int = 128):
    """(qoff, soff, valid) numpy seeds of B lanes of M slots: M/2 to M
    valid seeds a lane along one diagonal (30% noise) at a random subject
    offset below 2^32 - 1, invalid slots last with the sentinels."""
    import numpy as np

    qoff = np.full((B, M), 0x7FFFFFFF, np.int32)
    soff = np.full((B, M), 0xFFFFFFFF, np.int64)
    valid = np.zeros((B, M), bool)
    for b in range(B):
        n = int(rng.integers(M // 2, M + 1))
        base = int(rng.integers(0, 4_000_000_000))
        qq = np.sort(rng.integers(0, 50_000, n))
        ss = base + qq + rng.integers(0, 1600, n)
        noise = rng.random(n) < 0.3
        ss[noise] = base + rng.integers(0, 200_000, int(noise.sum()))
        qoff[b, :n] = qq
        soff[b, :n] = np.minimum(ss, 0xFFFFFFFE)
        valid[b, :n] = True
    return qoff, soff, valid


def phase_chain(rng, stats):
    import torch

    from lesv_tpu_torch.ops import chain_torch as ct

    dev = torch.device("cuda")
    args = dict(J=64, length=15, max_dq=5000, max_dr=5000, bw=1500)
    for M in (16384, 8192):
        B = 128
        qoff, soff, valid = chain_case(rng, M, B)
        qs, ss_, vs = ct.sort_seeds_device(
            torch.from_numpy(qoff).to(dev), torch.from_numpy(soff).to(dev),
            torch.from_numpy(valid).to(dev))

        def kern():
            return ct.chain_scan_cuda(qs, ss_, vs, **args)

        k_ms = cuda_ms(kern, 3)
        k_dev, k_host = device_host_ms(kern, 3)
        kf, kp, kv = kern()
        p_ms, (pf, pp, pv) = once_ms(
            lambda: ct.chain_scan_plain(qs, ss_, vs, **args))
        err = max(int((kf - pf).abs().max()), int((kp - pp).abs().max()),
                  int((kv - pv).abs().max()))
        # qs 4 + ss 8 + vs 1 bytes in, f/p/v 12 bytes out per slot; every
        # valid seed scores its J predecessors
        cb = bound(B * M * 25,
                   int(valid.sum()) * args["J"] * CHAIN_OPS_PER_PAIR)
        emit(dict(phase="chain", B=B, M=M, J=64, equal=err == 0,
                  max_abs_err=err, kernel_ms=k_ms, kernel_device_ms=k_dev,
                  kernel_host_ms=k_host, plain_ms=p_ms,
                  bound_ms=cb["bound_ms"], bound_by=cb["bound_by"],
                  kernel_seeds_s=B * M / k_ms * 1e3,
                  plain_seeds_s=B * M / p_ms * 1e3,
                  taken=int((kp > 0).sum())))
        if err:
            raise AssertionError(f"chain mismatch at M={M}")
        if M == 16384:
            stats["chain"] = dict(ms=k_ms, device_ms=k_dev, host_ms=k_host,
                                  plain_ms=p_ms, max_abs_err=err,
                                  shape=f"B={B} M={M} J=64", **cb)


def _require_launched(launches: dict, what: str) -> None:
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched {what}: {missing}")


def phase_map(rng):
    import numpy as np
    import torch

    from lesv_tpu_torch import _ext
    from lesv_tpu_torch.config import LesvConfig
    from lesv_tpu_torch.index.kmer_index import KmerIndex
    from lesv_tpu_torch.io.seqstore import SeqStore
    from lesv_tpu_torch.ops import align_batch
    from lesv_tpu_torch.ops.seeding_torch import device_index_of
    from lesv_tpu_torch.pipeline.mapper import map_all, map_batch
    from lesv_tpu_torch.sim import plant_svs, random_genome, simulate_reads
    from lesv_tpu_torch.utils import profiling

    t0 = time.time()
    genome = random_genome(rng, 64_000_000)
    donor, _ = plant_svs(rng, genome, n_del=20, n_ins=20)
    reads = simulate_reads(rng, donor, coverage=0.1, mean_len=12_000,
                           err=0.1)[:512]
    store = SeqStore.from_records([("chr20sim", genome)])
    cfg = LesvConfig()
    index = KmerIndex.build(store, cfg.index)
    setup_s = time.time() - t0
    bases = sum(len(r) for _, r in reads)

    _ext.reset_launches()
    align_batch.reset_fill_stats()
    profiling.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t1 = time.time()
    m4s, qstore = map_all(reads, store, index, cfg, device="cuda")
    torch.cuda.synchronize()
    map_s = time.time() - t1
    launches = dict(_ext.LAUNCHES)
    fills = dict(align_batch.FILL_STATS)
    idx_bytes = device_index_of(index, "cuda").nbytes
    spans = sorted(profiling.report().items(),
                   key=lambda kv: -kv[1]["total_s"])[:12]
    mapped = len({m.qid for m in m4s})
    emit(dict(phase="map", genome_bp=len(genome), reads=len(reads),
              read_bases=bases, setup_s=setup_s, map_s=map_s,
              bases_per_s=bases / map_s, m4=len(m4s), mapped_reads=mapped,
              index_device_bytes=idx_bytes,
              peak_device_bytes=torch.cuda.max_memory_allocated(),
              launches=launches, fills=fills,
              host_clock_spans={k: v["total_s"] for k, v in spans},
              spans_note=SPANS_NOTE))
    _require_launched(launches, "on the map path")
    for m in m4s:
        if not (0 <= m.qoff < m.qend <= m.qsize
                and 0 <= m.soff < m.send <= m.ssize
                and np.isfinite(m.ident_perc) and m.ops is not None):
            raise AssertionError(f"malformed M4 record {m}")
    if mapped < 0.9 * len(reads):
        raise AssertionError(f"only {mapped}/{len(reads)} reads mapped")

    # oracle: the port's host engine (host seeding and chaining through
    # the native library, plain fills on CPU tensors)
    cfg_h = LesvConfig()
    cfg_h.map.engine = "host"
    n_chk = 32
    t2 = time.time()
    want = map_batch([(q, qstore.get(q)) for q in range(n_chk)], store,
                     index, cfg_h, device="cpu")
    key = lambda m: (m.qid, m.qdir, m.qoff, m.qend, m.soff, m.send,
                     m.score, m.ops.tobytes())
    got = sorted(key(m) for m in m4s if m.qid < n_chk)
    want = sorted(key(m) for m in want)
    emit(dict(phase="map_oracle", reads_checked=n_chk, m4_port=len(got),
              m4_host_engine=len(want), equal=got == want,
              only_port=[list(k[:7]) for k in sorted(set(got) - set(want))][:5],
              only_host=[list(k[:7]) for k in sorted(set(want) - set(got))][:5],
              oracle_s=time.time() - t2))
    if got != want:
        raise AssertionError("M4 records differ from the host engine")
    return launches, dict(reads=reads, store=store, index=index, cfg=cfg,
                          m4s=m4s, bases=bases, donor=donor)


def sync_all() -> None:
    import torch

    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def wall_ms(fn, reps: int) -> float:
    """Host-clock time of one call, every card synchronised before and
    after: CUDA events of one card cannot see the others."""
    fn()
    sync_all()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync_all()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_mesh(rng, world):
    import numpy as np
    import torch

    from lesv_tpu_torch import _ext
    from lesv_tpu_torch.config import AlignConfig
    from lesv_tpu_torch.ops import align_torch as at
    from lesv_tpu_torch.parallel import mesh as pm
    from lesv_tpu_torch.pipeline.mapper import map_all

    cfg = AlignConfig()
    m = pm.make_mesh()
    n_dev = m.size
    if n_dev != torch.cuda.device_count():
        raise AssertionError("the mesh does not span every visible card")
    dev0 = torch.device("cuda", 0)
    launches = {k: 0 for k in _ext.LAUNCHES}

    # (a) mesh_fill against fill_cuda on one card and the plain version
    for kind, i16 in (("i16_diag_Q256_W512", True), ("diag_W512", False)):
        qn, sn, qln, sln, W, mode, fe = fill_case(rng, kind)
        q, s, ql, sl = (torch.from_numpy(x).to(dev0)
                        for x in (qn, sn, qln, sln))
        B, Q = q.shape
        name = "fill_i16" if i16 else "fill"
        _ext.reset_launches()
        fill = pm.mesh_fill(m, q, s, ql, sl, W, mode, cfg, fe)
        n_launched = _ext.LAUNCHES[name]
        launches[name] += n_launched
        placed = all(t.device == d for d, sh in zip(m.devices, fill.shards)
                     for t in sh)
        got = [torch.cat([sh[j].to(dev0) for sh in fill.shards])
               for j in range(5)]
        one = at.fill_cuda(q, s, ql, sl, W, mode, cfg, fe, i16=i16)
        plain = at.banded_align_kernel(q, s, ql, sl, W, mode, cfg, fe,
                                       i16=i16)
        eq1, d1, e1 = _fill_outputs_equal(got, one, ql, dirs=True)
        eqp, dp, ep = _fill_outputs_equal(got, plain, ql, dirs=True)
        small_eq = all(torch.equal(a, b.cpu())
                       for a, b in zip(fill.small(), got[1:]))

        def run_mesh():
            return pm.mesh_fill(m, q, s, ql, sl, W, mode, cfg, fe)

        def run_one():
            return at.fill_cuda(q, s, ql, sl, W, mode, cfg, fe, i16=i16)

        # in turns: one card, mesh, mesh, one card
        a1 = wall_ms(run_one, 5)
        am = wall_ms(run_mesh, 5)
        bm = wall_ms(run_mesh, 5)
        b1 = wall_ms(run_one, 5)
        fb = fill_bound(qln, sln, W, INT16_OPS_S if i16 else INT32_OPS_S)
        emit(dict(phase="mesh", part="mesh_fill", case=kind, devices=n_dev,
                  B=B, Q=Q, W=W, i16=fill.i16, launches=n_launched,
                  shards_on_their_cards=placed,
                  equal_fill_cuda=eq1, equal_plain=eqp, dirs_equal=d1 and dp,
                  max_abs_err=max(e1, ep), small_view_equal=small_eq,
                  mesh_fill_ms=(am + bm) / 2, fill_cuda_ms=(a1 + b1) / 2,
                  bound_ms=fb["bound_ms"] / n_dev, bound_by=fb["bound_by"],
                  clock="host, all cards synchronised"))
        if not (eq1 and eqp and small_eq and placed and fill.i16 == i16
                and n_launched == n_dev):
            raise AssertionError(f"mesh_fill mismatch in {kind}")

    # (b) the sharded steps: merged sums against the per-lane outputs
    qn, sn, qln, sln, W, mode, fe = fill_case(rng, "i16_diag_Q256_W512")
    _ext.reset_launches()
    score, end_b, ok, n_ok, total = pm.sharded_align_step(
        m, W, mode, cfg)(qn, sn, qln, sln)
    launches["fill_i16"] += _ext.LAUNCHES["fill_i16"]
    one = at.banded_fill(*(torch.from_numpy(x).to(dev0)
                           for x in (qn, sn, qln, sln)), W, mode, cfg, fe)
    align_ok = (n_ok == int(ok.sum())
                and total == int(torch.where(ok, score, 0).sum())
                and torch.equal(score, one[1].cpu())
                and torch.equal(end_b, one[3].cpu())
                and torch.equal(ok, one[4].cpu()))
    lcfg, index = world["cfg"], world["index"]
    from lesv_tpu_torch.io.fasta import revcomp

    # 32 reads cut to 16,384 bases, both strands as separate lanes
    Bs, Qmax, M = 64, 16384, lcfg.map.seed_match_budget
    codes = np.full((Bs, Qmax), 4, np.uint8)
    qlen = np.zeros(Bs, np.int64)
    for i, (_, r) in enumerate(world["reads"][: Bs // 2]):
        r = r[:Qmax]
        codes[2 * i, : len(r)] = r
        codes[2 * i + 1, : len(r)] = revcomp(r)
        qlen[2 * i] = qlen[2 * i + 1] = len(r)
    args = dict(k=index.k, M=M, J=lcfg.chain.lookback, seeding=lcfg.seeding,
                chain=lcfg.chain)
    _ext.reset_launches()
    t0 = time.time()
    f, best, n_chained, score_sum = pm.sharded_seed_chain_step(m, **args)(
        codes, qlen, index)
    sync_all()
    seed_chain_s = time.time() - t0
    chain_launched = _ext.LAUNCHES["chain"]
    launches["chain"] += chain_launched
    f1, best1, n1, sum1 = pm.sharded_seed_chain_step(pm.make_mesh(1), **args)(
        codes, qlen, index)
    chain_ok = (n_chained == int((best >= lcfg.chain.min_chain_score).sum())
                and score_sum == int(best.sum())
                and torch.equal(f, f1) and torch.equal(best, best1)
                and (n_chained, score_sum) == (n1, sum1))
    emit(dict(phase="mesh", part="sharded_steps", devices=n_dev,
              align_step_equal=align_ok, n_ok=n_ok, total_score=total,
              seed_chain_step_equal=chain_ok, lanes=Bs, Qmax=Qmax, M=M,
              n_chained=n_chained, score_sum=score_sum,
              chain_launches=chain_launched, seed_chain_s=seed_chain_s))
    if not (align_ok and chain_ok and n_chained >= 3 * Bs // 8
            and chain_launched == n_dev):
        raise AssertionError("a sharded step disagrees with its host sums")

    # (c) the map stage of phase map, every fill chunk shared over the
    # mesh; before it the same stage pinned to card 0, which no mesh takes
    sync_all()
    t1 = time.time()
    pinned, _ = map_all(world["reads"], world["store"], index, lcfg,
                        device="cuda:0")
    sync_all()
    pinned_s = time.time() - t1
    _ext.reset_launches()
    t1 = time.time()
    with pm.use_mesh(m):
        m4s, _ = map_all(world["reads"], world["store"], index, lcfg,
                         device="cuda")
    sync_all()
    map_s = time.time() - t1
    under_mesh = dict(_ext.LAUNCHES)
    key = lambda x: (x.qid, x.qdir, x.sid, x.qoff, x.qend, x.soff, x.send,
                     x.score, x.dist, x.ident_perc, x.ops.tobytes())
    same = ([key(x) for x in m4s] == [key(x) for x in world["m4s"]]
            == [key(x) for x in pinned])
    emit(dict(phase="mesh", part="map_under_mesh", devices=n_dev,
              reads=len(world["reads"]), read_bases=world["bases"],
              map_s=map_s, bases_per_s=world["bases"] / map_s, m4=len(m4s),
              map_on_card_0_s=pinned_s, equal_phase_map_and_card_0=same,
              launches=under_mesh))
    print(f"mesh: {n_dev} device(s), map under the mesh {map_s:.3f} s, "
          f"{world['bases'] / map_s:.0f} bases/s", flush=True)
    _require_launched(under_mesh, "by the map stage under the mesh")
    if not same:
        raise AssertionError("M4 records under the mesh, of phase map and "
                             "on card 0 differ")
    return {k: launches[k] + under_mesh[k] for k in launches}


@contextlib.contextmanager
def patched(obj, name: str, value):
    """``obj.name`` set to ``value`` for the block."""
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


@contextlib.contextmanager
def serial_workers():
    """The serial arm: one dispatch worker and one map batch at a time (the
    worker counts the tests patch the same way)."""
    from lesv_tpu_torch.ops import align_batch
    from lesv_tpu_torch.pipeline import mapper

    with patched(align_batch, "_n_dispatch_workers", lambda device: 1), \
            patched(mapper, "_map_overlap_depth", lambda device: 1):
        yield


@contextlib.contextmanager
def env_switch(name: str, value: str):
    """Set the switch ``name`` to ``value`` for the block (the port reads
    its switches at call time; spawned processes inherit it)."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def host_routing(on: bool):
    """Routing of small work to the host on (lesv_tpu's plan, the default
    on a card) or off (every fill and pair chain on the card but monster
    chunks and band escapes, as before the routing was ported)."""
    return env_switch("LESV_TORCH_HOST_SMALL", "1" if on else "0")


def busy_time(fn):
    """Run ``fn`` once under ``torch.profiler`` (CUDA activity); returns
    (its result, wall seconds, summed kernel seconds, seconds in which the
    card ran a kernel, copy or memset: the union of their intervals over
    every stream, bytes copied from the card to the host: the ``bytes`` of
    the trace's device-to-host copies, None if the trace has none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(REPO, "build", "smoke_overlap_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    os.remove(path)
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and "dur" in e)
    kernel_us = sum(e["dur"] for e in events
                    if e.get("cat") == "kernel" and "dur" in e)
    busy_us, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    d2h = [e["args"]["bytes"] for e in events
           if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")
           and "bytes" in e.get("args", {})]
    return (out, wall, kernel_us * 1e-6, busy_us * 1e-6,
            sum(d2h) if d2h else None)


def _m4_key(m):
    return (m.qid, m.qdir, m.sid, m.qoff, m.qend, m.qsize, m.soff, m.send,
            m.ssize, m.score, m.dist, round(m.ident_perc, 9),
            m.ops.tobytes())


def phase_overlap(world):
    """Map ``OVERLAP_READS`` reads (three production batches) against phase
    map's reference and index, in turns serial (S: one dispatch worker,
    one batch at a time) and overlapped (O: the defaults, 8 dispatch
    workers and 2 batches in flight, a CUDA stream each): S, O, S, O, the
    second S and O traced for the card's busy share.  Every arm must give
    the same M4 records, launches per kernel, fill launches per shape and
    fills.  Returns the launches of the first overlapped arm."""
    import numpy as np
    import torch

    from lesv_tpu_torch import _ext
    from lesv_tpu_torch.ops import align_batch
    from lesv_tpu_torch.pipeline.mapper import map_all
    from lesv_tpu_torch.sim import simulate_reads

    # coverage 0.35 of 64 Mb: about 1,870 reads of mean 12 kb, so that
    # the first 1,536 are always there
    rng = np.random.default_rng(7)
    reads = simulate_reads(rng, world["donor"], coverage=0.35,
                           mean_len=12_000, err=0.1)[:OVERLAP_READS]
    if len(reads) != OVERLAP_READS:
        raise AssertionError(f"only {len(reads)} reads simulated")
    bases = sum(len(r) for _, r in reads)
    store, index, cfg = world["store"], world["index"], world["cfg"]

    def map_arm():
        return map_all(reads, store, index, cfg, device="cuda")[0]

    arms = []
    for kind in ("S", "O", "S_traced", "O_traced"):
        _ext.reset_launches()
        align_batch.reset_fill_stats()
        torch.cuda.reset_peak_memory_stats()
        ctx = serial_workers() if kind[0] == "S" else contextlib.nullcontext()
        with ctx:
            if kind.endswith("traced"):
                m4s, wall, kernel_s, busy_s, _ = busy_time(map_arm)
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m4s = map_arm()
                torch.cuda.synchronize()
                wall, kernel_s, busy_s = time.perf_counter() - t0, None, None
        arm = dict(arm=kind, wall_s=wall, bases_per_s=bases / wall,
                   peak_device_bytes=torch.cuda.max_memory_allocated(),
                   m4=len(m4s), launches=dict(_ext.LAUNCHES),
                   fill_shape_keys=len(_ext.FILL_SHAPES),
                   fills=dict(align_batch.FILL_STATS))
        if kernel_s is not None:
            arm.update(kernel_s=kernel_s, busy_s=busy_s,
                       kernel_share=kernel_s / wall, busy_share=busy_s / wall)
        emit(dict(phase="overlap", reads=len(reads), read_bases=bases, **arm))
        arms.append((arm, [_m4_key(m) for m in m4s], dict(_ext.FILL_SHAPES)))
    first = arms[0]
    for arm, keys, shapes in arms[1:]:
        if keys != first[1]:
            raise AssertionError(f"arm {arm['arm']}: M4 records differ from "
                                 "the first serial arm's")
        if (arm["launches"], shapes, arm["fills"]) != (
                first[0]["launches"], first[2], first[0]["fills"]):
            raise AssertionError(f"arm {arm['arm']}: launches, fill shapes "
                                 "or fills differ from the first serial "
                                 "arm's")
    _require_launched(first[0]["launches"], "by the map of phase overlap")
    mean = lambda kind: sum(a["wall_s"] for a, _, _ in arms
                            if a["arm"][0] == kind) / 2
    print(f"overlap: {len(reads)} reads, serial {mean('S'):.3f} s, "
          f"overlapped {mean('O'):.3f} s (mean of two arms each)", flush=True)
    return arms[1][0]["launches"]


# a bucket of the wide fill design (W above csrc/fill.cu's REG_W = 2,048):
# `run`'s diag Q=8192 W=4096 launches
WIDE_SHAPE = ("i32", "diag", False, 8192, 4096, 8)


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def route_rates(cfg):
    """The rates of ``align_batch.CostRates`` on this card, measured: the
    native host fill (cells of ``_host_cost`` a second, one worker and the
    host pool's workers) and the fill kernel (cells of the cost model,
    longest query x W x lanes, a second of device time) at the buckets of
    ``FILL_HIST_SHAPES`` and ``WIDE_SHAPE``; the fixed cost of a chunk (host
    clock of ``banded_align_dispatch`` + ``banded_align_finish`` at one
    lane of full Q=64 W=64); the traceback kernel's device time a
    lane-step at full Q=64 W=64 B=1,024 and diag Q=4096 W=512 B=256; the
    bytes a second of a finish's readback at diag B=256 Q=4096 W=512.
    Returns (rates as CostRates keywords, the measurements)."""
    import concurrent.futures as cf

    import numpy as np
    import torch

    from lesv_tpu_torch.ops import align_batch as ab
    from lesv_tpu_torch.ops import align_torch as at

    hrng = np.random.default_rng(2)
    dev = torch.device("cuda")
    nw = ab._n_host_workers()
    host, fill, tb = [], [], []
    for shape in FILL_HIST_SHAPES + [WIDE_SHAPE]:
        qn, sn, qln, sln, W, mode, fe = hist_case(hrng, shape)
        B, Q = qn.shape
        pairs = [(qn[i, : qln[i]].copy(), sn[i, : sln[i]].copy())
                 for i in range(B)]
        cells = sum(ab._host_cost(len(q), len(s), fe) for q, s in pairs)
        saved = ab._n_host_workers
        ab._n_host_workers = lambda: 1
        try:
            one = []
            for _ in range(3):
                t0 = time.perf_counter()
                ab.align_pairs_host(pairs, cfg, fe)
                one.append(time.perf_counter() - t0)
        finally:
            ab._n_host_workers = saved
        step = -(-B // nw)
        blocks = [pairs[k : k + step] for k in range(0, B, step)]
        many = []
        with cf.ThreadPoolExecutor(nw) as pool:
            for _ in range(3):
                t0 = time.perf_counter()
                list(pool.map(lambda b: ab.align_pairs_host(b, cfg, fe),
                              blocks))
                many.append(time.perf_counter() - t0)
        host.append(dict(shape=list(shape), host_cells=cells,
                         one_worker_cells_s=cells / min(one),
                         workers=nw, workers_cells_s=cells / min(many)))
        q, s, ql, sl = (torch.from_numpy(x).to(dev)
                        for x in (qn, sn, qln, sln))
        i16 = at.i16_ok(Q, W, cfg)
        k_dev, k_host = device_host_ms(lambda: at.fill_cuda(
            q, s, ql, sl, W, mode, cfg, fe, i16=i16), 5)
        model_cells = int(qln.max()) * W * B
        fill.append(dict(shape=list(shape), i16=i16, device_ms=k_dev,
                         host_ms=k_host, cells=model_cells,
                         cells_s=model_cells / k_dev * 1e3))
        if shape[3:] in ((64, 64, 1024),):
            d, _, ei, eb, ok = at.fill_cuda(q, s, ql, sl, W, mode, cfg, fe,
                                            i16=i16)
            T = Q + 1 + W + 2
            t_dev, _ = device_host_ms(lambda: at.traceback_cuda(
                d, ei, eb, ok, W, mode, T), 5)
            tb.append(dict(shape=f"{mode} B={B} Q={Q} W={W} T={T}",
                           device_ms=t_dev, s_per_lane_step=t_dev * 1e-3
                           / (B * T)))
        del q, s, ql, sl

    # traceback and readback at diag B=256 Q=4096 W=512
    qn, sn, qln, sln, W, mode, fe = fill_case(hrng, "diag_W512")
    B, Q = qn.shape
    d, _, ei, eb, ok = at.fill_cuda(*(torch.from_numpy(x).to(dev)
                                      for x in (qn, sn, qln, sln)),
                                    W, mode, cfg, fe)
    T = Q + 1 + W + 2
    t_dev, _ = device_host_ms(lambda: at.traceback_cuda(
        d, ei, eb, ok, W, mode, T), 5)
    tb.append(dict(shape=f"{mode} B={B} Q={Q} W={W} T={T}", device_ms=t_dev,
                   s_per_lane_step=t_dev * 1e-3 / (B * T)))
    del d
    d2h = []
    for _ in range(5):
        pend = at.banded_align_dispatch(qn, sn, qln, sln, W, mode, cfg, fe,
                                        device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = at.banded_align_finish(pend)
        sec = time.perf_counter() - t0
        nbytes = sum(sh[k].numel() * sh[k].element_size()
                     for sh in pend["shards"]
                     for k in ("ops", "nops", "reached", "score", "end_i",
                               "end_b", "ok"))
        d2h.append((nbytes / sec, nbytes, sec))
        del pend, out
    d2h_bps, d2h_bytes, _ = _median(d2h)

    # the fixed cost of a chunk: one lane of full Q=64 W=64, host clock
    qb = np.zeros((1, 64), np.uint8)
    sb = np.zeros((1, 64), np.uint8)
    qb[0, :50] = hrng.integers(0, 4, 50)
    sb[0, :50] = qb[0, :50]
    one_lane = np.asarray([50], np.int32)
    chunk = []
    for k in range(41):
        t0 = time.perf_counter()
        at.banded_align_finish(at.banded_align_dispatch(
            qb, sb, one_lane, one_lane, 64, "full", cfg, device=dev))
        if k:
            chunk.append(time.perf_counter() - t0)
    by_type = lambda t: [f["cells_s"] for f in fill
                         if f["i16"] == (t == "i16") and f["shape"][4] <= 2048]
    rates = dict(
        host_cells_s=min(h["one_worker_cells_s"] for h in host),
        chunk_s=_median(chunk),
        fill_i32_cells_s=min(by_type("i32")),
        fill_i16_cells_s=min(by_type("i16")),
        fill_wide_cells_s=fill[-1]["cells_s"],
        traceback_s=max(t["s_per_lane_step"] for t in tb),
        d2h_bytes_s=d2h_bps)
    return rates, dict(host_fill=host, kernel_fill=fill, traceback=tb,
                       chunk_s_all=[min(chunk), _median(chunk), max(chunk)],
                       d2h=dict(bytes=d2h_bytes, bytes_s=d2h_bps))


def phase_route(world):
    """lesv_tpu's routing of small work to the host, on the card: the cost
    model's rates (``route_rates``), then phase map's 512 reads mapped in
    turns with routing off (R0) and on (R1): R0, R1, R0, R1.  Every arm
    prints its wall seconds, bases/s, launches, ``FILL_STATS`` and peak
    device memory, and every arm must give the same M4 records (each kind
    of arm also the same launches and fills).  Then the round-robin
    without a mesh: ``map_all`` on plain ``cuda`` with ``LESV_TORCH_MESH=0``
    against the map on ``cuda:0`` and under a mesh of every card, routing
    off, record for record, with the fill chunks each card took (on one
    card all on that card).  Returns the launches of the first R1 arm."""
    import collections

    import torch

    from lesv_tpu_torch import _ext
    from lesv_tpu_torch.config import AlignConfig
    from lesv_tpu_torch.ops import align_batch
    from lesv_tpu_torch.parallel import mesh as pm
    from lesv_tpu_torch.pipeline.mapper import map_all

    t0 = time.time()
    rates, measured = route_rates(AlignConfig())
    emit(dict(phase="route", part="rates", rates=rates, in_use=dataclasses
              .asdict(align_batch.cost_rates()), seconds=time.time() - t0,
              **measured))

    reads, store, index, cfg = (world["reads"], world["store"],
                                world["index"], world["cfg"])
    bases = world["bases"]
    arms = []
    for kind in ("R0", "R1", "R0", "R1"):
        _ext.reset_launches()
        align_batch.reset_fill_stats()
        torch.cuda.reset_peak_memory_stats()
        with host_routing(kind == "R1"):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            m4s, _ = map_all(reads, store, index, cfg, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        arm = dict(arm=kind, wall_s=wall, bases_per_s=bases / wall,
                   m4=len(m4s), launches=dict(_ext.LAUNCHES),
                   fills=dict(align_batch.FILL_STATS),
                   peak_device_bytes=torch.cuda.max_memory_allocated())
        emit(dict(phase="route", part="map", reads=len(reads),
                  read_bases=bases, **arm))
        arms.append((arm, [_m4_key(m) for m in m4s]))
    keys0 = arms[0][1]
    for arm, keys in arms[1:]:
        if keys != keys0:
            first = next((a, b) for a, b in zip(keys, keys0) if a != b) \
                if len(keys) == len(keys0) else None
            emit(dict(phase="route", part="differ", arm=arm["arm"],
                      m4=len(keys), m4_r0=len(keys0),
                      first_differing=None if first is None else
                      [list(first[0][:10]), list(first[1][:10])]))
            raise AssertionError(f"arm {arm['arm']}: M4 records differ "
                                 "from the first R0 arm's")
    for a, b in ((0, 2), (1, 3)):
        if (arms[a][0]["launches"], arms[a][0]["fills"]) != (
                arms[b][0]["launches"], arms[b][0]["fills"]):
            raise AssertionError(f"arm {arms[b][0]['arm']}: launches or "
                                 "fills differ from its first turn")
    _require_launched(arms[0][0]["launches"], "by the map of phase route, "
                      "routing off")
    if arms[1][0]["fills"]["host_routed"] == 0:
        raise AssertionError("routing on moved no pair to the host")
    mean = lambda kind: sum(a["wall_s"] for a, _ in arms
                            if a["arm"] == kind) / 2
    print(f"route: {len(reads)} reads, routing off {mean('R0'):.3f} s, on "
          f"{mean('R1'):.3f} s (mean of two arms each)", flush=True)

    # round-robin without a mesh, against card 0 and the mesh
    n_dev = torch.cuda.device_count()
    per_card: collections.Counter = collections.Counter()
    dispatch = align_batch.banded_align_dispatch

    def counting(*a, device, **kw):
        per_card[str(torch.device(device))] += 1
        return dispatch(*a, device=device, **kw)

    runs = {}
    with host_routing(False):
        for name in ("card_0", "round_robin", "mesh"):
            per_card.clear()
            align_batch.banded_align_dispatch = counting
            ctx = (env_switch("LESV_TORCH_MESH", "0")
                   if name == "round_robin" else
                   pm.use_mesh(pm.make_mesh()) if name == "mesh"
                   else contextlib.nullcontext())
            try:
                with ctx:
                    sync_all()
                    t1 = time.perf_counter()
                    m4s, _ = map_all(reads, store, index, cfg,
                                     device="cuda:0" if name == "card_0"
                                     else "cuda")
                    sync_all()
                    wall = time.perf_counter() - t1
            finally:
                align_batch.banded_align_dispatch = dispatch
            runs[name] = ([_m4_key(m) for m in m4s], wall, dict(per_card))
    same = runs["round_robin"][0] == runs["card_0"][0] == runs["mesh"][0] \
        == keys0
    rr_cards = runs["round_robin"][2]
    emit(dict(phase="route", part="round_robin", devices=n_dev,
              one_card=n_dev == 1,
              wall_s={k: v[1] for k, v in runs.items()},
              fill_chunks_per_card={k: v[2] for k, v in runs.items()},
              equal_card_0_and_mesh=same))
    if not same:
        raise AssertionError("M4 records of the round-robin, card 0 and "
                             "the mesh differ")
    want_cards = {f"cuda:{i}" for i in range(n_dev)} if n_dev > 1 \
        else {"cuda"}
    if set(rr_cards) != want_cards:
        raise AssertionError(f"round-robin chunks went to {rr_cards}, not "
                             f"to every card")
    return arms[1][0]["launches"]


def _chain_keys(lanes):
    return [[(c.score, c.qbeg, c.qend, c.sbeg, c.send, c.anchors.tobytes())
             for c in lane] for lane in lanes]


def _timed_arm(fn, traced: bool):
    """(result, wall seconds, bytes copied to the host or None): the card
    synchronised around ``fn``; traced arms run under ``busy_time``."""
    import torch

    if traced:
        out, wall, _, _, d2h = busy_time(fn)
        return out, wall, d2h
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, None


def full_fetch():
    """Context in which the pipeline's read and pair chaining fetch the
    chain outputs in full (``chain_lanes`` at the same live slots: six
    arrays at full width) instead of ``chain_lanes_sliced``'s one sliced,
    narrowed readback."""
    from lesv_tpu_torch.ops import chain_torch
    from lesv_tpu_torch.pipeline import batch_align, mapper

    def full(qoff, soff, valid, total, M, length, cfg, J=64, q16=False,
             s16=False):
        return chain_torch.chain_lanes(qoff, soff, valid, length, cfg, J=J,
                                       Mp=chain_torch._shrink_M(total, M))

    st = contextlib.ExitStack()
    st.enter_context(patched(mapper, "chain_lanes_sliced", full))
    st.enter_context(patched(batch_align, "chain_lanes_sliced", full))
    return st


def phase_paths(world):
    """The chain fetch on the card, on phase map's 512 reads:
    1. read seeding + chaining (``mapper._chains_by_read_device``) with the
       sliced fetch (S, the default) and the full fetch (A,
       :func:`full_fetch`) in turns S, A, S, A, the second pair traced for
       the bytes read back; equal chains lane for lane and equal totals;
    2. the same for ``batch_pair_chains`` on those reads' candidate
       windows, routing off;
    3. ``map_read`` of each of the first ``PATHS_MAP_READ`` reads: the
       records ``map_batch`` gives that read among them.
    Every arm prints its wall seconds, launches and (traced) bytes read
    back.  Returns the launches of the S arms and of part 3, summed."""
    import numpy as np

    from lesv_tpu_torch import _ext
    from lesv_tpu_torch.io.fasta import revcomp
    from lesv_tpu_torch.pipeline import batch_align, mapper

    reads, store, index, cfg = (world["reads"], world["store"],
                                world["index"], world["cfg"])
    batch = [(i, r) for i, (_, r) in enumerate(reads)]
    launches = {k: 0 for k in _ext.LAUNCHES}

    def in_turns(part, run, check):
        """Run the arms S, A, S, A (the last two traced) and hold every
        arm's result against the first's with ``check``."""
        results = []
        for t, kind in enumerate(("S", "A", "S", "A")):
            _ext.reset_launches()
            with (full_fetch() if kind == "A" else contextlib.nullcontext()):
                out, wall, d2h = _timed_arm(run, t >= 2)
            emit(dict(phase="paths", part=part, arm=kind, turn=t,
                      traced=t >= 2, wall_s=wall, d2h_bytes=d2h,
                      launches=dict(_ext.LAUNCHES)))
            if not _ext.LAUNCHES["chain"]:
                raise AssertionError(f"paths {part}: arm {kind} launched no "
                                     "chain kernel")
            if kind == "S":
                for k, n in _ext.LAUNCHES.items():
                    launches[k] += n
            results.append((kind, out, wall, d2h))
        for kind, out, _, _ in results[1:]:
            if not check(out, results[0][1]):
                raise AssertionError(f"paths {part}: arm {kind} differs "
                                     f"from arm {results[0][0]}")
        mean = {k: sum(w for a, _, w, _ in results if a == k) / 2
                for k in ("S", "A")}
        d2h = {a: b for a, _, _, b in results[2:]}
        print(f"paths: {part} sliced fetch {mean['S']:.3f} s, full fetch "
              f"{mean['A']:.3f} s (mean of two arms each); bytes read back "
              f"{d2h['S']} against {d2h['A']} (traced arms)", flush=True)
        return results

    def same_chunks(a, b):
        return (a[0] == b[0] and len(a[1]) == len(b[1])
                and all(np.array_equal(x, y) for x, y in zip(a[1], b[1])))

    def with_totals(mod, name, run):
        """``run()``'s result and the totals every call of ``mod.name``
        returned (its second output), in call order."""
        totals = []
        fn = getattr(mod, name)

        def spy(*a, **kw):
            out = fn(*a, **kw)
            totals.append(np.asarray(out[-1]).copy())
            return out

        with patched(mod, name, spy):
            return run(), totals

    # 1. read seeding + chaining
    def read_chains():
        by_read, totals = with_totals(
            mapper, "_seed_chain_chunk",
            lambda: mapper._chains_by_read_device(batch, index, cfg,
                                                  "cuda"))
        return [_chain_keys([r[0], r[1]]) for r in by_read], totals, by_read

    res = in_turns("read_chains", read_chains,
                   lambda a, b: same_chunks(a[:2], b[:2]))
    by_read = res[0][1][2]

    # 2. pair seeding + chaining on the reads' candidate windows
    wtasks = []
    for (_, read), cbd in zip(batch, by_read):
        for w in mapper.find_candidate_windows(cbd, index, len(read), cfg):
            wtasks.append((read if w.qdir == mapper.FWD else revcomp(read),
                           store.get(w.sid, w.sfrom, w.sto)))

    def pair_chains():
        with host_routing(False):
            out, totals = with_totals(
                batch_align, "pair_matches_batch",
                lambda: batch_align.batch_pair_chains(wtasks, cfg,
                                                      device="cuda"))
        return _chain_keys(out), sorted(totals, key=lambda t: t.tobytes())

    res = in_turns("pair_chains", pair_chains, same_chunks)
    emit(dict(phase="paths", part="pair_chains", pairs=len(wtasks),
              chunks=len(res[0][1][1])))

    # 3. map_read against map_batch
    _ext.reset_launches()
    with host_routing(False):
        head = batch[:PATHS_MAP_READ]
        want = [_m4_key(m) for m in mapper.map_batch(head, store, index, cfg,
                                                     device="cuda")]
        got = [_m4_key(m) for qid, r in head
               for m in mapper.map_read(qid, r, store, index, cfg,
                                        device="cuda")]
    for k, n in _ext.LAUNCHES.items():
        launches[k] += n
    emit(dict(phase="paths", part="map_read", reads=len(head), m4=len(got),
              equal_map_batch=sorted(got) == sorted(want),
              launches=dict(_ext.LAUNCHES)))
    if sorted(got) != sorted(want) or not got:
        raise AssertionError("paths map_read: records differ from "
                             "map_batch's")
    return launches


def _sans_sid(m):
    """An M4 record's fields but its subject id."""
    k = _m4_key(m)
    return k[:2] + k[3:]


def phase_volumes():
    """The subject-volume loop (``mapper.map_all_volumes``) on the card,
    with a generator of its own (seed 10), so that the phases after it
    see the data they saw before it was added:

    V1. ``VOL_CHROMS`` random chromosomes of ``VOL_CHROM_BP`` (20 DEL and
       20 INS planted over them), ``VOL_READS`` reads (mean 12 kb, 10%
       error, each inside one chromosome; the last with a 1.6 kb stretch
       at 35% error, so that the int32 fill launches) in map batches of
       ``VOL_BATCH_READS``: ``map_all`` against one index of the whole
       reference, then ``map_all_volumes`` in volumes of ``VOL_RES``
       (checkpointed); equal M4 records.  Every kernel must launch, and the
       device bytes allocated once a volume is released must not grow from
       one volume to the next.  Then one part file is removed and the call
       resumed: the same records, that part written again.
    V2. One volume of an all-N chromosome of ``VOL_N_BP`` (the store made
       from its fields: packed zeros and one ambiguous run) and an 8 Mb
       random one; ``VOL_FAR_READS`` reads at least ``VOL_FAR_EDGE`` from
       its ends, mapped against that store and against the 8 Mb
       chromosome alone: records equal in every field but the subject id.
       The index's largest position and the largest live seed offset must
       lie past 2^31.
    Returns the launches of both parts, summed."""
    import numpy as np
    import torch

    from lesv_tpu_torch import _ext, convert
    from lesv_tpu_torch.config import LesvConfig
    from lesv_tpu_torch.index.kmer_index import KmerIndex
    from lesv_tpu_torch.io.seqstore import SeqStore, pack_2bit
    from lesv_tpu_torch.ops.seeding_torch import (
        release_device_index,
        seed_matches_batch,
    )
    from lesv_tpu_torch.pipeline.mapper import map_all, map_all_volumes
    from lesv_tpu_torch.sim import (
        mutate_read,
        plant_svs,
        random_genome,
        simulate_reads,
    )

    rng = np.random.default_rng(10)
    t0 = time.time()
    chroms, reads = [], []
    for c in range(VOL_CHROMS):
        genome = random_genome(rng, VOL_CHROM_BP)
        n = 20 // VOL_CHROMS + (c < 20 % VOL_CHROMS)
        donor, _ = plant_svs(rng, genome, n_del=n, n_ins=n)
        chroms.append((f"chr{c + 1}", genome))
        reads += simulate_reads(rng, donor, coverage=0.15, mean_len=12_000,
                                err=0.1)[: VOL_READS // VOL_CHROMS]
    # the last read has a 1.6 kb stretch at 35% error, which holds no seed:
    # one inter-anchor segment of the Q=2048 bucket, outside the int16
    # gate, so that the int32 fill launches too
    a = int(rng.integers(0, VOL_CHROM_BP - 12_000))
    g = chroms[-1][1][a : a + 12_000]
    reads[-1] = ("noisy_mid", np.concatenate([
        mutate_read(rng, g[:5_000], err=0.1),
        mutate_read(rng, g[5_000:6_600], err=0.35),
        mutate_read(rng, g[6_600:], err=0.1)]))
    store = SeqStore.from_records(chroms)
    cfg = LesvConfig()
    cfg.map.batch_reads = VOL_BATCH_READS
    cfg.map.max_subject_vol_res = VOL_RES
    bases = sum(len(r) for _, r in reads)
    setup_s = time.time() - t0
    launches = {k: 0 for k in _ext.LAUNCHES}

    def add_launches():
        for k, n in _ext.LAUNCHES.items():
            launches[k] += n

    # one index of the whole reference
    t0 = time.time()
    index = KmerIndex.build(store, cfg.index)
    one_index_s = time.time() - t0
    _ext.reset_launches()
    t0 = time.time()
    want, _ = map_all(reads, store, index, cfg, device="cuda")
    one_map_s = time.time() - t0
    add_launches()
    release_device_index(index)
    del index

    ck = os.path.join(REPO, "build", "smoke_volumes")
    shutil.rmtree(ck, ignore_errors=True)
    stats: list = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    _ext.reset_launches()
    t0 = time.time()
    got, _ = map_all_volumes(reads, store, cfg, ckpt_dir=ck, device="cuda",
                             volume_stats=stats)
    vol_s = time.time() - t0
    vol_launches = dict(_ext.LAUNCHES)
    add_launches()
    after = [s["device_allocated_after"] for s in stats]
    same = sorted(map(_m4_key, got)) == sorted(map(_m4_key, want))
    mapped = len({m.qid for m in got})
    emit(dict(phase="volumes", part="V1", chroms=VOL_CHROMS,
              chrom_bp=VOL_CHROM_BP, vol_res=VOL_RES, volumes=len(stats),
              reads=len(reads), read_bases=bases,
              batch_reads=VOL_BATCH_READS, setup_s=setup_s,
              one_index_s=one_index_s, one_index_map_s=one_map_s,
              volumes_s=vol_s, per_volume=stats,
              device_allocated_before=allocated_before,
              peak_device_bytes=torch.cuda.max_memory_allocated(),
              m4=len(got), mapped_reads=mapped, equal_one_index=same,
              launches=vol_launches))
    _require_launched(vol_launches, "by the subject-volume loop")
    if len(stats) != 4 or not same or mapped < 0.9 * len(reads):
        raise AssertionError(f"volumes V1: {len(stats)} volumes, equal "
                             f"{same}, {mapped}/{len(reads)} reads mapped")
    if any(b > a for a, b in zip(after, after[1:])):
        raise AssertionError(f"volumes V1: device bytes allocated after "
                             f"each volume grew: {after}")

    part = "map_v001_00002.npz"
    os.remove(os.path.join(ck, part))
    stamps = {p: os.stat(os.path.join(ck, p)).st_mtime_ns
              for p in os.listdir(ck)}
    _ext.reset_launches()
    t0 = time.time()
    again, _ = map_all_volumes(reads, store, cfg, ckpt_dir=ck, device="cuda")
    resume_s = time.time() - t0
    add_launches()
    same_again = sorted(map(_m4_key, again)) == sorted(map(_m4_key, want))
    rewritten = os.path.exists(os.path.join(ck, part))
    untouched = stamps == {p: os.stat(os.path.join(ck, p)).st_mtime_ns
                           for p in os.listdir(ck) if p != part}
    emit(dict(phase="volumes", part="V1_resume", removed=part,
              resume_s=resume_s, rewritten=rewritten,
              others_untouched=untouched, equal=same_again,
              launches=dict(_ext.LAUNCHES)))
    shutil.rmtree(ck, ignore_errors=True)
    if not (same_again and rewritten and untouched):
        raise AssertionError(f"volumes V1 resume: equal {same_again}, part "
                             f"rewritten {rewritten}, others untouched "
                             f"{untouched}")
    del want, got, again, store, chroms, reads

    # V2: subject offsets past 2^31
    t0 = time.time()
    genome = random_genome(rng, VOL_CHROM_BP)
    far = []
    for i in range(VOL_FAR_READS):
        n = int(rng.integers(8_000, 16_000))
        a = int(rng.integers(VOL_FAR_EDGE, VOL_CHROM_BP - VOL_FAR_EDGE - n))
        far.append((f"far{i}", mutate_read(rng, genome[a : a + n], err=0.1)))
    big = convert.seqstore_from_arrays(
        ["chrN", "chr1"], [0, VOL_N_BP, VOL_N_BP + VOL_CHROM_BP],
        np.concatenate([np.zeros(VOL_N_BP // 4, np.uint8),
                        pack_2bit(genome)]),
        [[0, 0, VOL_N_BP]])
    alone = SeqStore.from_records([("chr1", genome)])
    cfg = LesvConfig()
    setup_s = time.time() - t0
    built: list = []
    build = KmerIndex.build.__func__

    def keep_build(cls, *a, **kw):
        built.append(build(cls, *a, **kw))
        return built[-1]

    stats_big: list = []
    _ext.reset_launches()
    with patched(KmerIndex, "build", classmethod(keep_build)):
        t0 = time.time()
        got, _ = map_all_volumes(far, big, cfg, device="cuda",
                                 volume_stats=stats_big)
        big_s = time.time() - t0
    big_launches = dict(_ext.LAUNCHES)
    add_launches()
    _ext.reset_launches()
    t0 = time.time()
    want, _ = map_all_volumes(far, alone, cfg, device="cuda")
    alone_s = time.time() - t0
    add_launches()
    (index,) = built
    pos_max = int(index.positions.max())
    soff_max = 0
    for i in range(0, len(far), 64):
        _, s, v, _ = seed_matches_batch([r for _, r in far[i : i + 64]],
                                        index, cfg.seeding,
                                        M=cfg.map.seed_match_budget,
                                        device="cuda")
        soff_max = max(soff_max, int(s[v].max()))
    release_device_index(index)
    same = (sorted(map(_sans_sid, got)) == sorted(map(_sans_sid, want))
            and {m.sid for m in got} == {1} and {m.sid for m in want} == {0})
    mapped = len({m.qid for m in got})
    emit(dict(phase="volumes", part="V2", n_bp=VOL_N_BP,
              chrom_bp=VOL_CHROM_BP, reads=len(far), setup_s=setup_s,
              per_volume=stats_big, map_big_s=big_s, map_alone_s=alone_s,
              index_positions=len(index.positions),
              index_position_max=pos_max, live_seed_soff_max=soff_max,
              m4=len(got), mapped_reads=mapped, equal_but_sid=same,
              launches=big_launches))
    if not same or mapped < 0.9 * len(far):
        raise AssertionError(f"volumes V2: records equal but sid {same}, "
                             f"{mapped}/{len(far)} reads mapped")
    if not (pos_max > 2**31 and soff_max > 2**31):
        raise AssertionError(f"volumes V2: largest position {pos_max}, "
                             f"largest live seed offset {soff_max}: not "
                             "past 2^31")
    return launches


def _dist_rank(rank: int, world_size: int, job: str) -> None:
    """One rank of phase dist (a spawned process): joins the gloo group,
    runs ``distributed_call`` over ``TorchExchange`` on the cards present
    and leaves its calls beside the job file."""
    import torch
    import torch.distributed as td

    sys.path.insert(0, REPO)
    from lesv_tpu_torch import _ext
    from lesv_tpu_torch.parallel.dist import TorchExchange, distributed_call

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with open(job, "rb") as fh:
        ref, reads, cfg = pickle.load(fh)
    td.init_process_group("gloo", init_method=f"file://{job}.group",
                          world_size=world_size, rank=rank)
    try:
        t0 = time.time()
        calls = distributed_call(ref, reads, cfg, exchange=TorchExchange(),
                                 device="cuda")
        torch.cuda.synchronize()
        out = dict(calls=calls, seconds=time.time() - t0,
                   launches=dict(_ext.LAUNCHES))
    finally:
        td.destroy_process_group()
    with open(f"{job}.rank{rank}.tmp", "wb") as fh:
        pickle.dump(out, fh)
    os.replace(f"{job}.rank{rank}.tmp", f"{job}.rank{rank}")


def first_half(genome, donor, truth, reads):
    """About the first half of a world of ``plant_svs`` and
    ``simulate_reads``: the reference up to a cut in the middle of a gap of
    at least 100 kb between planted SVs (the one nearest the reference's
    middle, so that reads across the cut, which are left out, lie far from
    every SV), the planted SVs before the cut, and the reads drawn wholly
    from the donor before it (a read's name ends with its donor
    interval)."""
    n = len(genome)
    svs = sorted(truth.svs, key=lambda sv: sv.ref_pos)
    ends = [sv.ref_pos + (sv.length if sv.kind == "DEL" else 0)
            for sv in svs]
    gaps = [(ends[i], svs[i + 1].ref_pos) for i in range(len(svs) - 1)
            if svs[i + 1].ref_pos - ends[i] >= 100_000]
    a, b = min(gaps, key=lambda g: abs((g[0] + g[1]) // 2 - n // 2))
    cut = (a + b) // 2
    before = [sv for sv in svs if sv.ref_pos < cut]
    dcut = cut + sum(sv.length if sv.kind == "INS" else -sv.length
                     for sv in before)
    kept = [(name, r) for name, r in reads
            if int(name.rsplit("_", 1)[1]) <= dcut]
    return genome[:cut], type(truth)(svs=before), kept


def phase_dist(rng):
    import torch
    import torch.multiprocessing as mp

    from lesv_tpu_torch import _ext
    from lesv_tpu_torch.config import LesvConfig
    from lesv_tpu_torch.parallel.dist import LocalExchange, distributed_call
    from lesv_tpu_torch.sim import plant_svs, random_genome, simulate_reads

    t0 = time.time()
    coverage = 10.0
    genome = random_genome(rng, DIST_GENOME_BP)
    donor, truth = plant_svs(rng, genome, n_del=DIST_N_SV, n_ins=DIST_N_SV)
    reads = simulate_reads(rng, donor, coverage=coverage, mean_len=12_000,
                           err=0.1)
    genome, truth, reads = first_half(genome, donor, truth, reads)
    ref = [("chrSim", genome)]
    cfg = LesvConfig()
    setup_s = time.time() - t0
    bases = sum(len(r) for _, r in reads)

    _ext.reset_launches()
    torch.cuda.synchronize()
    t1 = time.time()
    single = distributed_call(ref, reads, cfg, exchange=LocalExchange(),
                              device="cuda")
    torch.cuda.synchronize()
    single_s = time.time() - t1
    launches = dict(_ext.LAUNCHES)
    recall, precision, missed, false = score_calls(single, truth.svs)

    work = os.path.join(REPO, "build", "smoke_dist")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    job = os.path.join(work, "job.pkl")
    with open(job, "wb") as fh:
        pickle.dump((ref, reads, cfg), fh)
    n_ranks = 2
    ctx = mp.get_context("spawn")
    t2 = time.time()
    procs = [ctx.Process(target=_dist_rank, args=(r, n_ranks, job))
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    deadline = time.time() + DIST_JOIN_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.time()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        codes = [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ranks_s = time.time() - t2
    if hung or any(codes):
        raise AssertionError(f"dist ranks hung {hung}, exit codes {codes}")
    outs = []
    for r in range(n_ranks):
        with open(f"{job}.rank{r}", "rb") as fh:
            outs.append(pickle.load(fh))
    shutil.rmtree(work, ignore_errors=True)
    want = [dataclasses.asdict(c) for c in single]
    same = [[dataclasses.asdict(c) for c in o["calls"]] == want
            for o in outs]
    rank_launches = {k: sum(o["launches"][k] for o in outs)
                     for k in launches}
    emit(dict(phase="dist", genome_bp=len(genome), coverage=coverage,
              planted=len(truth.svs), reads=len(reads), read_bases=bases,
              setup_s=setup_s, devices=torch.cuda.device_count(),
              single_host_s=single_s, single_host_bases_per_s=bases / single_s,
              launches_single_host=launches, calls=len(single),
              recall=recall, precision=precision,
              missed=[[sv.kind, sv.ref_pos, sv.length] for sv in missed],
              false_calls=[[c.kind, c.pos, c.length] for c in false],
              ranks=n_ranks, exchange="TorchExchange over gloo",
              ranks_wall_s=ranks_s,
              rank_s=[o["seconds"] for o in outs],
              rank_launches=[o["launches"] for o in outs],
              ranks_equal_single_host=same))
    _require_launched(launches, "by distributed_call on one host")
    _require_launched(rank_launches, "by the two ranks together")
    if not single or recall < 0.9 or precision < 0.9:
        raise AssertionError(f"dist: {len(single)} calls, recall {recall}, "
                             f"precision {precision}")
    if not all(same):
        raise AssertionError("a rank's calls differ from the single host's")
    return launches


def score_calls(calls, svs):
    """Recall and precision by the rule of the end-to-end test: a planted
    SV is found by a call of its kind within 1000 bp whose length is
    within 25%; a call farther than 1000 bp from every planted SV is
    false."""
    missed = [sv for sv in svs if not any(
        c.kind == sv.kind and abs(c.pos - sv.ref_pos) <= 1_000
        and abs(c.length - sv.length) <= 0.25 * sv.length for c in calls)]
    false = [c for c in calls
             if all(abs(c.pos - sv.ref_pos) > 1_000 for sv in svs)]
    recall = 1.0 - len(missed) / len(svs)
    precision = 1.0 - len(false) / len(calls) if calls else 0.0
    return recall, precision, missed, false


def fill_histogram(shapes: dict, n: int = 8) -> list:
    """The ``n`` largest entries of a fill launch histogram
    (``_ext.FILL_SHAPES``), as [state type, mode, free_end, Qmax, W, B,
    launches]."""
    top = sorted(shapes.items(), key=lambda kv: (-kv[1], kv[0]))[:n]
    return [[*k, v] for k, v in top]


def fill_buckets(shapes: dict, n: int = 8, state: str | None = None) -> list:
    """The same histogram summed over B: the ``n`` largest buckets (of one
    state type, or of both) as [state type, mode, free_end, Qmax, W,
    launches, lanes, largest B]."""
    acc: dict = {}
    for k, v in shapes.items():
        if state and k[0] != state:
            continue
        a = acc.setdefault(k[:5], [0, 0, 0])
        a[0] += v
        a[1] += v * k[5]
        a[2] = max(a[2], k[5])
    top = sorted(acc.items(), key=lambda kv: (-kv[1][0], kv[0]))[:n]
    return [[*k, *v] for k, v in top]


def phase_run(rng):
    import torch

    from lesv_tpu_torch import _ext
    from lesv_tpu_torch.config import LesvConfig
    from lesv_tpu_torch.ops import align_batch
    from lesv_tpu_torch.pipeline import driver
    from lesv_tpu_torch.sim import plant_svs, random_genome, simulate_reads
    from lesv_tpu_torch.utils import profiling

    t0 = time.time()
    coverage = RUN_COVERAGE
    genome = random_genome(rng, RUN_GENOME_BP)
    donor, truth = plant_svs(rng, genome, n_del=RUN_N_SV, n_ins=RUN_N_SV)
    reads = simulate_reads(rng, donor, coverage=coverage, mean_len=12_000,
                           err=0.1)
    setup_s = time.time() - t0
    bases = sum(len(r) for _, r in reads)
    out_dir = os.path.join(REPO, "build", "smoke_run")
    shutil.rmtree(out_dir, ignore_errors=True)
    ref = [("chrSim", genome)]
    cfg = LesvConfig()

    # the launch counts of the map stage are read, and set back to 0, at
    # the moment the stage after it starts
    at_map_end: dict = {}
    shapes_map: dict = {}
    select_sv_reads = driver.select_sv_reads

    def first_stage_after_map(*a, **kw):
        at_map_end.update(_ext.LAUNCHES)
        shapes_map.update(_ext.FILL_SHAPES)
        _ext.reset_launches()
        return select_sv_reads(*a, **kw)

    _ext.reset_launches()
    align_batch.reset_fill_stats()
    profiling.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    driver.select_sv_reads = first_stage_after_map
    try:
        t1 = time.time()
        res = driver.run_pipeline(ref, reads, cfg, out_dir=out_dir,
                                  resume=True, device="cuda")
        torch.cuda.synchronize()
        run_s = time.time() - t1
    finally:
        driver.select_sv_reads = select_sv_reads
    after_map = dict(_ext.LAUNCHES)
    shapes_after = dict(_ext.FILL_SHAPES)
    shapes = dict(shapes_map)
    for k, v in _ext.FILL_SHAPES.items():
        shapes[k] = shapes.get(k, 0) + v
    recall, precision, missed, false = score_calls(res.calls, truth.svs)
    spans = sorted(profiling.report().items(),
                   key=lambda kv: -kv[1]["total_s"])[:16]

    vcf_path = os.path.join(out_dir, "calls.vcf")
    with open(vcf_path) as fh:
        rows = [ln.rstrip("\n").split("\t") for ln in fh
                if not ln.startswith("#")]
    vcf_ok = (len(rows) == len(res.calls)
              and all(len(r) == 10 and r[0] == "chrSim" and int(r[1]) > 0
                      and r[6] == "PASS" and "SVTYPE=" in r[7]
                      for r in rows))

    _ext.reset_launches()
    t2 = time.time()
    again = driver.run_pipeline(ref, reads, cfg, out_dir=out_dir,
                                resume=True, device="cuda")
    resume_s = time.time() - t2
    resume_launches = dict(_ext.LAUNCHES)
    key = lambda c: (c.subject_id, c.pos, c.kind, c.length, c.ref, c.alt,
                     c.support, c.depth, c.genotype)
    same = [key(c) for c in again.calls] == [key(c) for c in res.calls]

    emit(dict(phase="run", genome_bp=len(genome), coverage=coverage,
              planted=len(truth.svs), reads=len(reads), read_bases=bases,
              setup_s=setup_s, run_s=run_s, bases_per_s=bases / run_s,
              stage_s=res.timings, records=res.stats,
              launches_map_stage=at_map_end,
              launches_after_map=after_map,
              fill_shapes_top8=fill_histogram(shapes),
              fill_buckets_top8=fill_buckets(shapes),
              fill_buckets_i32_top4=fill_buckets(shapes, 4, "i32"),
              fill_shape_keys=len(shapes),
              fills=dict(align_batch.FILL_STATS),
              peak_device_bytes=torch.cuda.max_memory_allocated(),
              calls=len(res.calls), recall=recall, precision=precision,
              missed=[[sv.kind, sv.ref_pos, sv.length] for sv in missed],
              false_calls=[[c.kind, c.pos, c.length] for c in false],
              vcf_rows=len(rows), vcf_parses=vcf_ok,
              resume_s=resume_s, resume_same_calls=same,
              resume_launches=resume_launches,
              host_clock_spans={k: v["total_s"] for k, v in spans},
              spans_note=SPANS_NOTE))
    _require_launched(at_map_end, "in the map stage of run")
    _require_launched(after_map, "in the stages after map")
    if recall < 0.9 or precision < 0.9:
        raise AssertionError(f"recall {recall} / precision {precision} "
                             "below 0.9")
    if not vcf_ok:
        raise AssertionError("calls.vcf does not parse back to the calls")
    if not same or any(resume_launches.values()):
        raise AssertionError("resume changed the calls or launched a kernel")
    run_launches = {k: at_map_end[k] + after_map[k] for k in after_map}

    # the same world once more in the serial arm, into its own out_dir,
    # from the overlapped run's map checkpoint (phase overlap holds the
    # serial map against the overlapped one; this cut keeps the script
    # near half its time limit): the same bytes, stage records, launches
    # and fill shapes after map
    serial_dir = os.path.join(REPO, "build", "smoke_run_serial")
    shutil.rmtree(serial_dir, ignore_errors=True)
    os.makedirs(serial_dir)
    for name in ("map.npz", "map.done"):
        shutil.copy(os.path.join(out_dir, name), serial_dir)
    _ext.reset_launches()
    align_batch.reset_fill_stats()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with serial_workers():
        t3 = time.time()
        sres = driver.run_pipeline(ref, reads, cfg, out_dir=serial_dir,
                                   resume=True, device="cuda")
        torch.cuda.synchronize()
        serial_s = time.time() - t3
    differ = [name for name in ("calls.vcf", "remapped.sam")
              if _read(out_dir, name) != _read(serial_dir, name)]
    differ += [name for name in STAGE_FILES
               if not _npz_equal(os.path.join(out_dir, name),
                                 os.path.join(serial_dir, name))]
    if dict(_ext.LAUNCHES) != after_map or _ext.FILL_SHAPES != shapes_after:
        differ.append("launches")
    after_map_s = sum(v for k, v in res.timings.items() if k != "map")
    emit(dict(phase="run_serial", from_stage="sv_reads", run_s=serial_s,
              overlapped_run_s=run_s, overlapped_after_map_s=after_map_s,
              stage_s=sres.timings,
              peak_device_bytes=torch.cuda.max_memory_allocated(),
              launches=dict(_ext.LAUNCHES),
              fills=dict(align_batch.FILL_STATS), differ=differ))
    print(f"run after map: overlapped {after_map_s:.2f} s, serial "
          f"{serial_s:.2f} s", flush=True)
    if differ:
        raise AssertionError(f"the serial run differs from the overlapped "
                             f"one in {differ}")
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(serial_dir, ignore_errors=True)
    return run_launches, after_map


def f1_args(sim: dict, out: str, seeds: list):
    """The arguments of ``tools/torch_f1_eval.py`` for a case: ``sim``'s
    fields, ``--out``, ``--seeds`` and ``--device cuda``."""
    import argparse

    return argparse.Namespace(**sim, out=out, seeds=seeds, device="cuda")


def phase_accuracy():
    """The F1 harness (``tools/torch_f1_eval.py``) on the card: (a) the
    pinned case with routing off, held to ``PINNED_*``; (b) ACCURACY_r05's
    configuration, seed 0, at the default routing, held to its record; (c)
    ``recall_cached`` over (b)'s stage files, held to (b)'s ``eval``."""
    import hashlib

    from lesv_tpu_torch.config import LesvConfig

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_f1_eval as f1
    from lesv_tpu_torch import _ext

    root = os.path.join(REPO, "build", "smoke_accuracy")
    shutil.rmtree(root, ignore_errors=True)
    a_args = f1_args(PINNED_ARGS, os.path.join(root, "pinned"),
                     [PINNED_SEED])
    with host_routing(False):
        pin = f1.run_case(PINNED_SEED, a_args, LesvConfig())
    pin_shapes = dict(_ext.FILL_SHAPES)
    vcf = _read(os.path.join(a_args.out, f"seed{PINNED_SEED}"), "calls.vcf")
    pin_vcf_sha = hashlib.sha256(vcf).hexdigest()
    emit(dict(phase="accuracy_pinned", seed=PINNED_SEED, **PINNED_ARGS,
              report=pin, vcf_bytes=len(vcf), vcf_sha256=pin_vcf_sha,
              fill_shapes_top8=fill_histogram(pin_shapes),
              fill_buckets_i32_top4=fill_buckets(pin_shapes, 4, "i32")))
    _require_launched({k: pin["launches"][k]
                       for k in ("fill_i16", "chain", "traceback")},
                      "on the pinned case")
    differ = [name for name, got, want in (
        ("eval", pin["eval"], PINNED_EVAL),
        ("calls", pin["call_keys"], PINNED_CALLS),
        ("calls_digest", pin["calls_digest"], PINNED_CALLS_DIGEST),
        ("vcf_bytes", len(vcf), PINNED_VCF_BYTES),
        ("vcf_sha256", pin_vcf_sha, PINNED_VCF_SHA256)) if got != want]
    if differ:
        raise AssertionError(f"the pinned case differs from the constants "
                             f"in {differ}")

    b_args = f1_args(ACCURACY_ARGS, os.path.join(root, "r05"),
                     [ACCURACY_SEED])
    acc = f1.run_case(ACCURACY_SEED, b_args, LesvConfig())
    acc_shapes = dict(_ext.FILL_SHAPES)
    emit(dict(phase="accuracy_r05", seed=ACCURACY_SEED, **ACCURACY_ARGS,
              report=acc, fill_shapes_top8=fill_histogram(acc_shapes),
              fill_buckets_i32_top4=fill_buckets(acc_shapes, 4, "i32")))
    if acc["eval"] != ACCURACY_EVAL or acc["calls"] != ACCURACY_CALLS:
        raise AssertionError(f"ACCURACY_r05 seed {ACCURACY_SEED}: eval "
                             f"{acc['eval']}, {acc['calls']} calls; the "
                             f"record: {ACCURACY_EVAL}, {ACCURACY_CALLS}")

    t0 = time.time()
    ev, n = f1.recall_cached(ACCURACY_SEED, b_args, LesvConfig())
    emit(dict(phase="accuracy_recall_cached", eval=ev, calls=n,
              recall_s=time.time() - t0))
    if ev != acc["eval"] or n != acc["calls"]:
        raise AssertionError("recall_cached over the stage files differs "
                             "from the run's eval")
    shutil.rmtree(root, ignore_errors=True)
    return {k: pin["launches"][k] + acc["launches"][k]
            for k in pin["launches"]}


# the stage checkpoints of run_pipeline's out_dir
STAGE_FILES = ("map.npz", "sv_reads.npz", "signatures.npz",
               "consensus.npz", "remap.npz")


def _read(directory: str, name: str) -> bytes:
    with open(os.path.join(directory, name), "rb") as fh:
        return fh.read()


def _npz_equal(a: str, b: str) -> bool:
    """Two ``.npz`` files hold the same arrays: names, dtypes, shapes and
    every value."""
    import numpy as np

    with np.load(a, allow_pickle=False) as x, \
            np.load(b, allow_pickle=False) as y:
        return (sorted(x.files) == sorted(y.files)
                and all(x[k].dtype == y[k].dtype
                        and np.array_equal(x[k], y[k]) for k in x.files))


def main() -> int:
    import torch

    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from lesv_tpu_torch import _ext, native

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit(dict(phase="device", nvidia_smi=smi,
              torch=torch.__version__, cuda=torch.version.cuda,
              name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count()))
    t0 = time.time()
    _ext.build()
    t1 = time.time()
    native._load()
    emit(dict(phase="build", kernels_s=t1 - t0, native_s=time.time() - t1,
              kernels=list(_ext.KERNELS)))
    rng = np.random.default_rng(0)
    stats: dict = {}
    phase_s = {"build": time.time() - t0}

    def timed(name, fn, *args):
        t = time.time()
        out = fn(*args)
        phase_s[name] = time.time() - t
        return out

    timed("fill", phase_fill, rng, stats)
    timed("chain", phase_chain, rng, stats)
    # phases map, mesh, overlap and dist with routing off, as before it was
    # ported, so that their records, launches and times compare
    with host_routing(False):
        map_launches, map_world = timed("map", phase_map, rng)
        mesh_launches = timed("mesh", phase_mesh, rng, map_world)
        overlap_launches = timed("overlap", phase_overlap, map_world)
    route_launches = timed("route", phase_route, map_world)
    paths_launches = timed("paths", phase_paths, map_world)
    del map_world
    with host_routing(False):
        volumes_launches = timed("volumes", phase_volumes)
        dist_launches = timed("dist", phase_dist, rng)
    run_launches, after_map = timed("run", phase_run,
                                    np.random.default_rng(RUN_SEED))
    accuracy_launches = timed("accuracy", phase_accuracy)
    emit(dict(phase="seconds", phase_s=phase_s,
              total_s=time.time() - t_start))
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "jaxlib", "lesv_tpu")
                 or m.startswith(("jax.", "lesv_tpu.")))
    if bad:
        raise AssertionError(f"imported: {bad}")
    src = {"fill": ("lesv_tpu_torch/csrc/fill.cu",
                    "lesv_tpu/ops/align_pallas.py:141"),
           "fill_i16": ("lesv_tpu_torch/csrc/fill.cu",
                        "lesv_tpu/ops/align_pallas.py:145"),
           "chain": ("lesv_tpu_torch/csrc/chain.cu",
                     "lesv_tpu/ops/chain_pallas.py:44"),
           "traceback": ("lesv_tpu_torch/csrc/traceback.cu",
                         "lesv_tpu/ops/align_jax.py:271")}
    # the traceback after the int16 fills, beside Q=4096
    stats["traceback"]["other_shapes"] = [stats.pop("traceback_q256")]
    # the fills at the largest buckets of `run`'s launch histogram
    for k in ("fill", "fill_i16"):
        stats[k]["other_shapes"] = stats.pop(f"{k}_hist")
    print(smi, flush=True)
    emit({"kernels": [
        dict(name=k, route="cuda", source=src[k][0], replaces=src[k][1],
             launches=run_launches[k], launches_map_phase=map_launches[k],
             launches_run_after_map=after_map[k],
             launches_mesh_phase=mesh_launches[k],
             launches_overlap_phase=overlap_launches[k],
             launches_dist_phase=dist_launches[k],
             launches_route_phase=route_launches[k],
             launches_paths_phase=paths_launches[k],
             launches_volumes_phase=volumes_launches[k],
             launches_accuracy_phase=accuracy_launches[k], library_ms=None,
             **stats[k])
        for k in ("fill", "fill_i16", "chain", "traceback")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
