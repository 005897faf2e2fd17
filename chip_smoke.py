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
   and the ops of the traceback kernel), and one shape outside the gate,
   which must raise.  Exact equality (tolerance 0: all values are
   integers); timed with CUDA events;
4. ``chain``: the chain-scan kernel against its plain version at B=128,
   J=64, M=16384 and M=8192 -- exact equality, timed;
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
7. ``dist``: ``lesv_tpu_torch.parallel.dist.distributed_call`` on a 4 Mb
   reference with 5 DEL + 5 INS planted and reads at coverage 10, once
   with ``LocalExchange`` in this process and once as two spawned
   processes joined by ``TorchExchange`` over gloo (a ``file://``
   rendezvous under ``build/smoke_dist``), both on the cards present: the call
   lists must be equal field for field, on every rank.  A rank that fails
   or outlasts ``DIST_JOIN_S`` fails the phase;
8. ``run``: reads to a VCF through
   ``lesv_tpu_torch.pipeline.driver.run_pipeline(device="cuda")`` on an
   8 Mb simulated reference with 10 DEL + 10 INS planted and reads at
   coverage 10 (mean 12 kb, 10% error): per-stage seconds and record
   counts, launches per kernel for the map stage and for the stages after
   it (every kernel must launch in both), recall and precision of the calls
   against the planted truth (both at least 0.9), ``calls.vcf`` parsed
   back, and a second call with ``resume=True`` that returns the same calls
   without launching a kernel.

Then the card's ``nvidia-smi`` line, the kernel table and
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
# were added, so that the whole script stays near half its time limit
RUN_GENOME_BP = 8_000_000
RUN_N_SV = 10               # of each kind, DEL and INS
DIST_GENOME_BP = 4_000_000
DIST_N_SV = 5
DIST_JOIN_S = 600           # a rank still alive after this is killed

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
                  max_abs_err=err, kernel_ms=k_ms, plain_ms=p_ms,
                  bound_ms=fb["bound_ms"], bound_by=fb["bound_by"],
                  kernel_gcells_s=cells / k_ms / 1e6,
                  plain_gcells_s=cells / p_ms / 1e6,
                  traceback_equal=tb_eq, traceback_ms=t_ms,
                  traceback_plain_ms=tp_ms,
                  traceback_bound_ms=tbb["bound_ms"],
                  traceback_steps=steps,
                  traceback_lanes_s=B / t_ms * 1e3,
                  reached=int(kr.sum())))
        if not (eq and tb_eq):
            raise AssertionError(f"fill/traceback mismatch in {kind}")
        if kind == "diag_W512":
            stats["fill"] = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=err,
                                 shape=f"diag B={B} Q={Q} W={W}", **fb)
            stats["traceback"] = dict(
                ms=t_ms, plain_ms=tp_ms, max_abs_err=0,
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
        kout, wout = kern16(), kern32()
        p_ms, pout = once_ms(lambda: at.banded_align_kernel(
            q, s, ql, sl, W, mode, cfg, fe, i16=True))
        eq, dirs_eq, err = _fill_outputs_equal(kout, pout, ql, dirs=True)
        eq32, _, err32 = _fill_outputs_equal(kout, wout, ql, dirs=False)
        T = Q + 1 + W + 2
        t16 = at.traceback_cuda(kout[0], kout[2], kout[3], kout[4], W, mode,
                                T)
        t32 = at.traceback_cuda(wout[0], wout[2], wout[3], wout[4], W, mode,
                                T)
        ops_eq = all(torch.equal(a, b) for a, b in zip(t16, t32))
        cells = int(qln.sum()) * W
        fb = fill_bound(qln, sln, W, INT16_OPS_S)
        emit(dict(phase="fill", kernel="fill_i16", case=kind, B=B, Q=Q, W=W,
                  mode=mode, free_end=fe, equal_plain_i16=eq,
                  dirs_equal=dirs_eq, max_abs_err=err,
                  equal_i32_kernel=eq32, max_abs_err_vs_i32=err32,
                  ops_equal_i32_kernel=ops_eq, kernel_ms=k_ms,
                  i32_kernel_ms=k32_ms, plain_ms=p_ms,
                  bound_ms=fb["bound_ms"], bound_by=fb["bound_by"],
                  kernel_gcells_s=cells / k_ms / 1e6,
                  reached=int(t16[2].sum())))
        if not (eq and eq32 and ops_eq):
            raise AssertionError(f"int16 fill mismatch in {kind}")
        if not bool(t16[2].any()):
            raise AssertionError(f"{kind}: no lane traced back")
        if kind == "i16_diag_Q256_W512":
            stats["fill_i16"] = dict(ms=k_ms, plain_ms=p_ms,
                                     max_abs_err=max(err, err32),
                                     i32_kernel_ms=k32_ms,
                                     shape=f"diag B={B} Q={Q} W={W}", **fb)

    # outside the gate the int16 kernel is refused, not wrapped
    (q, s, ql, sl), _, _, W, mode, fe = upload("diag_W512")
    try:
        at.fill_cuda(q, s, ql, sl, W, mode, cfg, fe, i16=True)
    except ValueError as e:
        emit(dict(phase="fill", kernel="fill_i16", case="gate_closed_Q4096",
                  raised=str(e)))
    else:
        raise AssertionError("int16 fill outside its gate did not raise")


def phase_chain(rng, stats):
    import numpy as np
    import torch

    from lesv_tpu_torch.ops import chain_torch as ct

    dev = torch.device("cuda")
    args = dict(J=64, length=15, max_dq=5000, max_dr=5000, bw=1500)
    for M in (16384, 8192):
        B = 128
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
        qs, ss_, vs = ct.sort_seeds_device(
            torch.from_numpy(qoff).to(dev), torch.from_numpy(soff).to(dev),
            torch.from_numpy(valid).to(dev))

        def kern():
            return ct.chain_scan_cuda(qs, ss_, vs, **args)

        k_ms = cuda_ms(kern, 3)
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
                  max_abs_err=err, kernel_ms=k_ms, plain_ms=p_ms,
                  bound_ms=cb["bound_ms"], bound_by=cb["bound_by"],
                  kernel_seeds_s=B * M / k_ms * 1e3,
                  plain_seeds_s=B * M / p_ms * 1e3,
                  taken=int((kp > 0).sum())))
        if err:
            raise AssertionError(f"chain mismatch at M={M}")
        if M == 16384:
            stats["chain"] = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=err,
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
              host_clock_spans={k: v["total_s"] for k, v in spans}))
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
                          m4s=m4s, bases=bases)


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


def phase_run(rng):
    import torch

    from lesv_tpu_torch import _ext
    from lesv_tpu_torch.config import LesvConfig
    from lesv_tpu_torch.ops import align_batch
    from lesv_tpu_torch.pipeline import driver
    from lesv_tpu_torch.sim import plant_svs, random_genome, simulate_reads
    from lesv_tpu_torch.utils import profiling

    t0 = time.time()
    coverage = 10.0
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
    select_sv_reads = driver.select_sv_reads

    def first_stage_after_map(*a, **kw):
        at_map_end.update(_ext.LAUNCHES)
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
              fills=dict(align_batch.FILL_STATS),
              peak_device_bytes=torch.cuda.max_memory_allocated(),
              calls=len(res.calls), recall=recall, precision=precision,
              missed=[[sv.kind, sv.ref_pos, sv.length] for sv in missed],
              false_calls=[[c.kind, c.pos, c.length] for c in false],
              vcf_rows=len(rows), vcf_parses=vcf_ok,
              resume_s=resume_s, resume_same_calls=same,
              resume_launches=resume_launches,
              host_clock_spans={k: v["total_s"] for k, v in spans}))
    _require_launched(at_map_end, "in the map stage of run")
    _require_launched(after_map, "in the stages after map")
    if recall < 0.9 or precision < 0.9:
        raise AssertionError(f"recall {recall} / precision {precision} "
                             "below 0.9")
    if not vcf_ok:
        raise AssertionError("calls.vcf does not parse back to the calls")
    if not same or any(resume_launches.values()):
        raise AssertionError("resume changed the calls or launched a kernel")
    shutil.rmtree(out_dir, ignore_errors=True)
    return {k: at_map_end[k] + after_map[k] for k in after_map}, after_map


def main() -> int:
    import torch

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
    phase_fill(rng, stats)
    phase_chain(rng, stats)
    map_launches, map_world = phase_map(rng)
    mesh_launches = phase_mesh(rng, map_world)
    del map_world
    dist_launches = phase_dist(rng)
    run_launches, after_map = phase_run(rng)
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
    print(smi, flush=True)
    emit({"kernels": [
        dict(name=k, route="cuda", source=src[k][0], replaces=src[k][1],
             launches=run_launches[k], launches_map_phase=map_launches[k],
             launches_run_after_map=after_map[k],
             launches_mesh_phase=mesh_launches[k],
             launches_dist_phase=dist_launches[k], library_ms=None,
             **stats[k])
        for k in ("fill", "fill_i16", "chain", "traceback")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
