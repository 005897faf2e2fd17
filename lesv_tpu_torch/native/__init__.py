"""ctypes bindings to the native host kernels, built at first use.

The library (stitching, chain extraction, host fills, fccns DP) is
compiled with ``make -C lesv_tpu_torch/native`` into the git-ignored
``build/native/`` directory of the checkout the first time a binding is
called.  The port requires it: a binding raises ``RuntimeError`` when the
library cannot be built or loaded.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
_SO = os.path.join(BUILD_DIR, "liblesv_native.so")

_lib = None
_lock = threading.Lock()


def _build() -> None:
    """Compile into a private name, then rename: concurrent first users
    (test workers) never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    r = subprocess.run(["make", "-C", _DIR, "-s", f"SO={tmp}"],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError("lesv_tpu_torch.native: building the host "
                           f"library failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, _SO)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        src = os.path.join(_DIR, "lesv_native.cpp")
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(src)):
            _build()
        try:
            lib = ctypes.CDLL(_SO)
        except OSError as e:
            raise RuntimeError("lesv_tpu_torch.native: cannot load "
                               f"{_SO}: {e}") from e
        _bind(lib)
        _lib = lib
    return _lib


def _bind(lib) -> None:
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.chain_score.argtypes = [
        ctypes.c_int64, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, i64p, i64p]
    lib.extend_matches.argtypes = [
        ctypes.c_int64, u8p, ctypes.c_int64, u8p, ctypes.c_int64,
        ctypes.c_int64, i64p, i64p, i64p]
    lib.fccns_link_dp.argtypes = [
        ctypes.c_int64, i64p, i64p, f64p, f64p, ctypes.c_int64, f64p, i64p]
    lib.chain_extract.argtypes = [
        ctypes.c_int64, i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, i64p, i64p, i64p, i64p]
    lib.traceback_batch.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, u8p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i64p, i64p,
        u8p, ctypes.c_int64, ctypes.c_int64, u8p, i64p, u8p]
    i32p_ = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i16p_ = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    lib.chain_v_batch.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i32p_, i16p_, i32p_]
    lib.fccns_walk.argtypes = [
        ctypes.c_int64, i64p, i32p_, i32p_, ctypes.c_int64,
        ctypes.c_int64, u8p, i64p]
    lib.fccns_walk.restype = ctypes.c_int64
    lib.banded_align_batch_host.argtypes = [
        ctypes.c_int64, u8p, i64p, i64p, u8p, i64p, i64p, i64p, u8p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, u8p, i64p, i64p, i32p_, i64p,
        i64p, u8p]
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.kmer_scan.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, i64p, u32p]
    lib.kmer_scan.restype = ctypes.c_int64
    lib.radix_sort_hash_pos.argtypes = [
        ctypes.c_int64, i64p, u32p, ctypes.c_int64, ctypes.c_int64]
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.banded_fill.argtypes = [
        ctypes.c_int64, ctypes.c_int64, u8p, u8p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        u8p, i32p, i64p, i64p, u8p]
    lib.stitch_core.argtypes = [
        u8p, ctypes.c_int64, u8p, ctypes.c_int64, i64p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        u8p, ctypes.c_int64, i64p, i64p, i64p, i64p, ctypes.c_int64,
        i64p, i64p]


def chain_score(qoff: np.ndarray, soff: np.ndarray, length: int,
                max_dist_qry: int, max_dist_ref: int, band_width: int):
    """Native chain-DP scoring; returns (f, p)."""
    lib = _load()
    n = len(qoff)
    qoff = np.ascontiguousarray(qoff, np.int64)
    soff = np.ascontiguousarray(soff, np.int64)
    f = np.empty(n, np.int64)
    p = np.empty(n, np.int64)
    lib.chain_score(n, qoff, soff, length, max_dist_qry, max_dist_ref,
                    band_width, f, p)
    return f, p


def extend_matches(q: np.ndarray, s: np.ndarray, k: int,
                   qoff: np.ndarray, soff: np.ndarray):
    lib = _load()
    n = len(qoff)
    qoff = np.ascontiguousarray(qoff, np.int64).copy()
    soff = np.ascontiguousarray(soff, np.int64).copy()
    lens = np.empty(n, np.int64)
    lib.extend_matches(n, np.ascontiguousarray(q, np.uint8), len(q),
                       np.ascontiguousarray(s, np.uint8), len(s), k,
                       qoff, soff, lens)
    return qoff, soff, lens


def banded_align_one(q: np.ndarray, s: np.ndarray, W: int, mode_diag: bool,
                     match: int, mismatch: int, go1: int, ge1: int,
                     go2: int, ge2: int, free_end: bool):
    """Full native fill + traceback for one pair.

    Returns (ops forward uint8, score, qe, se) or None on band
    escape."""
    lib = _load()
    Q, S = len(q), len(s)
    dirs = np.empty(((Q + 1), W), np.uint8)
    score = np.zeros(1, np.int32)
    end_i = np.zeros(1, np.int64)
    end_b = np.zeros(1, np.int64)
    okf = np.zeros(1, np.uint8)
    lib.banded_fill(Q, S, np.ascontiguousarray(q, np.uint8),
                    np.ascontiguousarray(s, np.uint8), W,
                    1 if mode_diag else 0, match, mismatch,
                    go1, ge1, go2, ge2, 1 if free_end else 0,
                    dirs, score, end_i, end_b, okf)
    if not okf[0]:
        return None
    W2 = W // 2 if mode_diag else 0
    g = (end_i[0] - W2) if mode_diag else 0
    T = int(end_i[0] + max(g + end_b[0], 0)) + 2
    ops = np.full((1, T), 255, np.uint8)
    nops = np.zeros(1, np.int64)
    reached = np.zeros(1, np.uint8)
    lib.traceback_batch(1, Q + 1, W, dirs.reshape(1, Q + 1, W),
                        (Q + 1) * W, W, 1,
                        end_i, end_b, okf, 1 if mode_diag else 0, T,
                        ops, nops, reached)
    if not reached[0]:
        return None
    se = int(g + end_b[0]) if free_end else S
    qe = int(end_i[0]) if free_end else Q
    return ops[0, : int(nops[0])], int(score[0]), qe, se


def traceback_batch(dirs: np.ndarray, end_i: np.ndarray,
                    end_b: np.ndarray, ok: np.ndarray, W: int,
                    mode_diag: bool, T: int, layout: str = "lane"):
    """Native alignment traceback; dirs must be C-contiguous, one of:
    lane-major (B, R, W) (``layout="lane"``), row-major (R, B, W)
    (``layout="row"``), or band-major (R, W, B) (``layout="rwb"``, the
    Pallas fill's natural layout).

    Returns (ops (B,T) uint8 forward order, nops, reached)."""
    lib = _load()
    if layout == "lane":
        B, R, Wd = dirs.shape
        lane_stride, row_stride, band_stride = R * Wd, Wd, 1
    elif layout == "row":
        R, B, Wd = dirs.shape
        lane_stride, row_stride, band_stride = Wd, B * Wd, 1
    else:
        R, Wd, B = dirs.shape
        lane_stride, row_stride, band_stride = 1, Wd * B, B
    assert Wd == W
    ops = np.full((B, T), 255, np.uint8)
    nops = np.zeros(B, np.int64)
    reached = np.zeros(B, np.uint8)
    lib.traceback_batch(
        B, R, W,
        np.ascontiguousarray(dirs, np.uint8),
        lane_stride, row_stride, band_stride,
        np.ascontiguousarray(end_i, np.int64),
        np.ascontiguousarray(end_b, np.int64),
        np.ascontiguousarray(ok, np.uint8),
        1 if mode_diag else 0, T, ops, nops, reached)
    return ops, nops, reached.astype(bool)


def chain_extract(f: np.ndarray, p: np.ndarray, v: np.ndarray,
                  min_score: int, min_cnt: int, max_chains: int):
    """Native chain extraction over (f, p, v) DP arrays.

    Returns (paths, bounds, scores, n_chains);
    chain c's ascending seed indices are paths[bounds[c]:bounds[c+1]]."""
    lib = _load()
    n = len(f)
    paths = np.empty(max(n, 1), np.int64)
    bounds = np.zeros(max_chains + 1, np.int64)
    scores = np.empty(max(max_chains, 1), np.int64)
    nc = np.zeros(1, np.int64)
    lib.chain_extract(n, np.ascontiguousarray(f, np.int64),
                      np.ascontiguousarray(p, np.int64),
                      np.ascontiguousarray(v, np.int64),
                      min_score, min_cnt, max_chains,
                      paths, bounds, scores, nc)
    return paths, bounds, scores, int(nc[0])


def fccns_walk(start_col: int, best_pred: np.ndarray,
               col_base: np.ndarray, col_tpos: np.ndarray,
               gap_code: int):
    """Native consensus traceback walk.

    Returns (codes forward uint8, cns_from)."""
    lib = _load()
    n = len(best_pred)
    out = np.empty(max(n, 1), np.uint8)
    frm = np.zeros(1, np.int64)
    m = lib.fccns_walk(start_col,
                       np.ascontiguousarray(best_pred, np.int64),
                       np.ascontiguousarray(col_base, np.int32),
                       np.ascontiguousarray(col_tpos, np.int32),
                       n, gap_code, out, frm)
    return out[:m][::-1].copy(), int(frm[0])


def banded_align_batch_host(pairs, W0: np.ndarray, free_end: np.ndarray,
                            match: int, mismatch: int, go1: int,
                            ge1: int, go2: int, ge2: int):
    """Batched native fill + traceback (+ band-widening retries) for many
    (q, s) pairs in ONE ctypes call.

    Returns (ops_flat u8, ops_off i64, nops i64, score i32, qe, se,
    ok u8); pair i's ops
    are ops_flat[ops_off[i] : ops_off[i] + nops[i]]."""
    lib = _load()
    n = len(pairs)
    qlens = np.asarray([len(q) for q, _ in pairs], np.int64)
    slens = np.asarray([len(s) for _, s in pairs], np.int64)
    qoffs = np.zeros(n + 1, np.int64)
    soffs = np.zeros(n + 1, np.int64)
    np.cumsum(qlens, out=qoffs[1:])
    np.cumsum(slens, out=soffs[1:])
    qbuf = np.empty(max(int(qoffs[-1]), 1), np.uint8)
    sbuf = np.empty(max(int(soffs[-1]), 1), np.uint8)
    for i, (q, s) in enumerate(pairs):
        qbuf[qoffs[i] : qoffs[i + 1]] = q
        sbuf[soffs[i] : soffs[i + 1]] = s
    caps = qlens + slens + 2
    ops_off = np.zeros(n + 1, np.int64)
    np.cumsum(caps, out=ops_off[1:])
    ops_flat = np.full(max(int(ops_off[-1]), 1), 255, np.uint8)
    nops = np.zeros(n, np.int64)
    score = np.zeros(n, np.int32)
    qe = np.zeros(n, np.int64)
    se = np.zeros(n, np.int64)
    okv = np.zeros(n, np.uint8)
    lib.banded_align_batch_host(
        n, qbuf, qoffs[:n].copy(), qlens, sbuf, soffs[:n].copy(), slens,
        np.ascontiguousarray(W0, np.int64),
        np.ascontiguousarray(free_end, np.uint8),
        match, mismatch, go1, ge1, go2, ge2,
        ops_flat, ops_off, nops, score, qe, se, okv)
    return ops_flat, ops_off, nops, score, qe, se, okv


def chain_v_batch(f: np.ndarray, p_rel: np.ndarray):
    """Rebuild the chain-DP running-peak v from fetched (f, p_rel).

    f (B, n) int32, p_rel (B, n) int16 relative predecessors; returns
    v (B, n) int32."""
    lib = _load()
    B, n = f.shape
    f = np.ascontiguousarray(f, np.int32)
    p_rel = np.ascontiguousarray(p_rel, np.int16)
    v = np.empty((B, n), np.int32)
    lib.chain_v_batch(B, n, f, p_rel, v)
    return v


def kmer_scan(codes: np.ndarray, k: int, stride: int, base: int):
    """Native rolling-hash k-mer scan (valid windows only).

    Returns (hashes int64, global positions uint32)."""
    lib = _load()
    n = len(codes)
    cap = max(1, (max(n - k + 1, 0) + stride - 1) // stride)
    h = np.empty(cap, np.int64)
    p = np.empty(cap, np.uint32)
    m = lib.kmer_scan(np.ascontiguousarray(codes, np.uint8), n, k,
                      stride, base, h, p)
    return h[:m], p[:m]


def radix_sort_hash_pos(h: np.ndarray, p: np.ndarray, nbits: int,
                        nthreads: int = 0) -> None:
    """Stable MT radix sort of (h, p) by h, IN PLACE."""
    lib = _load()
    assert h.dtype == np.int64 and p.dtype == np.uint32
    assert h.flags.c_contiguous and p.flags.c_contiguous
    lib.radix_sort_hash_pos(len(h), h, p, nbits, nthreads)


def fccns_link_dp(link_col: np.ndarray, pred_col: np.ndarray,
                  link_w: np.ndarray, cov_pen: np.ndarray, n_cols: int):
    lib = _load()
    score = np.full(n_cols, -np.inf)
    best_pred = np.full(n_cols, -1, np.int64)
    lib.fccns_link_dp(
        len(link_col),
        np.ascontiguousarray(link_col, np.int64),
        np.ascontiguousarray(pred_col, np.int64),
        np.ascontiguousarray(link_w, np.float64),
        np.ascontiguousarray(cov_pen, np.float64),
        n_cols, score, best_pred)
    return score, best_pred


def stitch_core(q: np.ndarray, s: np.ndarray, runs: np.ndarray,
                tiny_cap: int, match: int, mismatch: int,
                go1: int, ge1: int, go2: int, ge2: int):
    """Native anchored-core stitch (sanitize + M/D/I emission + tiny-gap
    DP); returns (ops, score, (qb, qe, sb, se), bigs (n,5)) or None on
    failure.  bigs rows: (qa, qb, sa, sb, ops_pos)."""
    lib = _load()
    n = len(runs)
    if n == 0:
        return None
    cap = len(q) + len(s) + 8
    ops = np.empty(cap, np.uint8)
    nops = np.zeros(1, np.int64)
    score = np.zeros(1, np.int64)
    bounds = np.zeros(4, np.int64)
    max_big = 2 * n + 4
    bigs = np.zeros(5 * max_big, np.int64)
    nbig = np.zeros(1, np.int64)
    ok = np.zeros(1, np.int64)
    lib.stitch_core(
        np.ascontiguousarray(q, np.uint8), len(q),
        np.ascontiguousarray(s, np.uint8), len(s),
        np.ascontiguousarray(runs, np.int64).reshape(-1), n,
        tiny_cap, match, mismatch, go1, ge1, go2, ge2,
        ops, cap, nops, score, bounds, bigs, max_big, nbig, ok)
    if not ok[0]:
        return None
    nb = int(nbig[0])
    return (ops[: int(nops[0])], int(score[0]), tuple(bounds),
            bigs[: 5 * nb].reshape(nb, 5))
