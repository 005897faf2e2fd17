"""Smoke run of the lesv_tpu_torch port on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. the card (``nvidia-smi`` name and power limit); fails without CUDA;
2. build the CUDA kernels from ``lesv_tpu_torch/csrc`` (nvcc, sm_90a);
3. the fill kernel against its plain PyTorch version at the shapes the
   map stage gives it (diag W=512, full W=4096, full W=65, diag with
   free_end), and the traceback kernel against its plain version on the
   kernel's direction bytes -- exact equality, timed with CUDA events;
4. the chain-scan kernel against its plain version at B=128, J=64,
   M=16384 and M=8192 -- exact equality, timed;
5. the map stage at a size users run: a 64 Mb simulated reference with
   planted SVs, 512 reads of mean length 12 kb at 10% error, mapped on
   the GPU through ``lesv_tpu_torch.pipeline.mapper.map_all``; every
   kernel must have launched, and the M4 records of the first 32 reads
   must equal those of lesv_tpu's JAX-free host engine.

The last two lines are the kernel table and
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


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


def fill_case(rng, kind: str):
    """(q, s, qlen, slen, W, mode, free_end) numpy batch of one shape."""
    import numpy as np

    from lesv_tpu.sim import mutate_read

    if kind == "diag_W512":
        B, Q, W, mode, fe = 256, 4096, 512, "diag", False
        pairs = []
        for _ in range(B):
            s = rng.integers(0, 4, int(rng.integers(3600, 4000))).astype(
                np.uint8)
            pairs.append((mutate_read(rng, s, err=0.1)[:Q], s))
        S = Q + W
    elif kind == "full_W4096_del":
        B, Q, W, mode, fe = 8, 128, 4096, "full", False
        pairs = []
        for _ in range(B):
            s = rng.integers(0, 4, 2100).astype(np.uint8)
            cut = int(rng.integers(30, 70))
            q = np.concatenate([s[:cut], s[cut + 2000 :]])
            pairs.append((mutate_read(rng, q, err=0.05)[:Q], s))
        S = W
    elif kind == "full_W65":
        B, Q, W, mode, fe = 1024, 64, 65, "full", False
        pairs = []
        for _ in range(B):
            s = rng.integers(0, 4, int(rng.integers(20, 64))).astype(np.uint8)
            pairs.append((mutate_read(rng, s, err=0.2)[:Q], s))
        S = 64
    else:  # "diag_W1024_free_end": end-extension blocks
        B, Q, W, mode, fe = 64, 2048, 1024, "diag", True
        pairs = []
        for _ in range(B):
            s = rng.integers(0, 4, 2624).astype(np.uint8)
            n = int(rng.integers(600, 1800))
            q = np.concatenate([mutate_read(rng, s[:n], err=0.1),
                                rng.integers(0, 4, 400).astype(np.uint8)])
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


def phase_fill(rng, stats):
    import torch

    from lesv_tpu.config import AlignConfig
    from lesv_tpu_torch.ops import align_torch as at

    cfg = AlignConfig()
    dev = torch.device("cuda")
    for kind in ("diag_W512", "full_W4096_del", "full_W65",
                 "diag_W1024_free_end"):
        qn, sn, qln, sln, W, mode, fe = fill_case(rng, kind)
        q, s = torch.from_numpy(qn).to(dev), torch.from_numpy(sn).to(dev)
        ql, sl = torch.from_numpy(qln).to(dev), torch.from_numpy(sln).to(dev)
        B, Q = q.shape

        def kern():
            return at.fill_cuda(q, s, ql, sl, W, mode, cfg, fe)

        k_ms = cuda_ms(kern, 3)
        kd, ks, kei, keb, kok = kern()
        p_ms, (pd, ps, pei, peb, pok) = once_ms(
            lambda: at.banded_align_kernel(q, s, ql, sl, W, mode, cfg, fe))
        live = (torch.arange(Q + 1, device=dev)[None, :, None]
                <= ql[:, None, None])
        dirs_eq = not bool(torch.where(live, kd != pd, False).any())
        err = max(int((ks - ps).abs().max()), int((kei - pei).abs().max()),
                  int((keb - peb).abs().max()),
                  int((kok.int() - pok.int()).abs().max()))
        eq = err == 0 and dirs_eq
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
        rec = dict(phase="fill", case=kind, B=B, Q=Q, W=W, mode=mode,
                   free_end=fe, equal=eq, dirs_equal=dirs_eq,
                   max_abs_err=err, kernel_ms=k_ms, plain_ms=p_ms,
                   kernel_gcells_s=cells / k_ms / 1e6,
                   plain_gcells_s=cells / p_ms / 1e6,
                   traceback_equal=tb_eq, traceback_ms=t_ms,
                   traceback_plain_ms=tp_ms,
                   traceback_lanes_s=B / t_ms * 1e3,
                   reached=int(kr.sum()))
        emit(rec)
        if not (eq and tb_eq):
            raise AssertionError(f"fill/traceback mismatch in {kind}")
        if kind == "diag_W512":
            stats["fill"] = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=err)
            stats["traceback"] = dict(ms=t_ms, plain_ms=tp_ms,
                                      max_abs_err=0)


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
        emit(dict(phase="chain", B=B, M=M, J=64, equal=err == 0,
                  max_abs_err=err, kernel_ms=k_ms, plain_ms=p_ms,
                  kernel_seeds_s=B * M / k_ms * 1e3,
                  plain_seeds_s=B * M / p_ms * 1e3,
                  taken=int((kp > 0).sum())))
        if err:
            raise AssertionError(f"chain mismatch at M={M}")
        if M == 16384:
            stats["chain"] = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=err)


def phase_map(rng):
    import numpy as np
    import torch

    from lesv_tpu.config import LesvConfig
    from lesv_tpu.index.kmer_index import KmerIndex
    from lesv_tpu.io.seqstore import SeqStore
    from lesv_tpu.sim import plant_svs, random_genome, simulate_reads
    from lesv_tpu.utils import profiling
    from lesv_tpu_torch import _ext
    from lesv_tpu_torch.ops import align_batch
    from lesv_tpu_torch.ops.seeding_torch import device_index_of
    from lesv_tpu_torch.pipeline.mapper import map_all

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
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the map path: "
                             f"{missing}")
    for m in m4s:
        if not (0 <= m.qoff < m.qend <= m.qsize
                and 0 <= m.soff < m.send <= m.ssize
                and np.isfinite(m.ident_perc) and m.ops is not None):
            raise AssertionError(f"malformed M4 record {m}")
    if mapped < 0.9 * len(reads):
        raise AssertionError(f"only {mapped}/{len(reads)} reads mapped")

    # oracle: lesv_tpu's host engine with the native host fills (no jax)
    os.environ["LESV_TPU_BACKEND"] = "native"
    from lesv_tpu.pipeline.mapper import map_batch

    cfg_h = LesvConfig()
    cfg_h.map.engine = "host"
    n_chk = 32
    t2 = time.time()
    want = map_batch([(q, qstore.get(q)) for q in range(n_chk)], store,
                     index, cfg_h)
    key = lambda m: (m.qid, m.qdir, m.qoff, m.qend, m.soff, m.send,
                     m.score)
    got = sorted(key(m) for m in m4s if m.qid < n_chk)
    want = sorted(key(m) for m in want)
    emit(dict(phase="map_oracle", reads_checked=n_chk, m4_port=len(got),
              m4_host_engine=len(want), equal=got == want,
              only_port=[list(k) for k in sorted(set(got) - set(want))][:5],
              only_host=[list(k) for k in sorted(set(want) - set(got))][:5],
              oracle_s=time.time() - t2))
    if got != want:
        raise AssertionError("M4 records differ from the host engine")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from lesv_tpu_torch import _ext

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(dict(phase="device", nvidia_smi=smi,
              torch=torch.__version__, cuda=torch.version.cuda,
              name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count()))
    t0 = time.time()
    _ext.build()
    emit(dict(phase="build", seconds=time.time() - t0,
              kernels=list(_ext.KERNELS)))
    rng = np.random.default_rng(0)
    stats: dict = {}
    phase_fill(rng, stats)
    phase_chain(rng, stats)
    launches = phase_map(rng)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    src = {"fill": ("lesv_tpu_torch/csrc/fill.cu",
                    "lesv_tpu/ops/align_pallas.py:141"),
           "chain": ("lesv_tpu_torch/csrc/chain.cu",
                     "lesv_tpu/ops/chain_pallas.py:44"),
           "traceback": ("lesv_tpu_torch/csrc/traceback.cu",
                         "lesv_tpu/ops/align_jax.py:271")}
    emit({"kernels": [
        dict(name=k, route="cuda", source=src[k][0], replaces=src[k][1],
             launches=launches[k], **stats[k])
        for k in ("fill", "chain", "traceback")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
