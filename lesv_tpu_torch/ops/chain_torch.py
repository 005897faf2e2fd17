"""Batched chain DP: per-lane seed sort, chain scan, host chain extraction.

Counterpart of :mod:`lesv_tpu.ops.chain_jax` and
:mod:`lesv_tpu.ops.chain_pallas`.  The scan (:func:`chain_scan`) has a
plain PyTorch version (:func:`chain_scan_plain`, the J-lookback recurrence
of ``chain_jax._chain_scan_kernel`` over a sliding window of views) and a
hand-written CUDA kernel (``csrc/chain.cu``).  Seeds travel as qoff int32,
soff int64 holding unsigned 32-bit subject offsets, valid bool.

Two fetches bring the outputs to the host: :func:`fetch_chain_arrays`
(the six arrays at full width; :func:`chain_lanes`) and
:func:`fetch_chain_sliced` (cut to the live slots on the device, narrowed,
one readback; v and valid rebuilt on the host).  The pipeline's seeding
and chaining take the second, through :func:`chain_lanes_sliced`.
"""

from __future__ import annotations

import numpy as np
import torch

from lesv_tpu_torch import _ext, native
from lesv_tpu_torch.config import ChainConfig
from lesv_tpu_torch.ops.chain import (
    Chain,
    _is_contained,
    join_adjacent_chains,
)
from lesv_tpu_torch.utils import profiling

NEG = -(2**30)
QOFF_INVALID = 0x7FFFFFFF
SOFF_INVALID = 0xFFFFFFFF


def sort_seeds_device(qoff, soff, valid):
    """Per-lane (soff, qoff) order, stable, invalid slots last: one stable
    sort on the int64 key ``soff * 2^31 + qoff`` (soff < 2^32 and
    0 <= qoff < 2^31 keep it below 2^63).  Invalid slots carry the
    sentinels qoff 0x7FFFFFFF / soff 0xFFFFFFFF, as in the JAX sort."""
    qk = torch.where(valid, qoff.to(torch.int64), QOFF_INVALID)
    sk = torch.where(valid, soff.to(torch.int64), SOFF_INVALID)
    order = torch.sort(sk * (1 << 31) + qk, dim=1, stable=True).indices
    return (torch.gather(qk, 1, order).to(torch.int32),
            torch.gather(sk, 1, order),
            torch.gather(valid, 1, order))


def chain_scan_plain(qs, ss, vs, J: int, length: int, max_dq: int,
                     max_dr: int, bw: int):
    """Plain chain scan over sorted (B, M) seeds -> (f, p_rel, v) int32."""
    B, M = qs.shape
    dev = qs.device
    i64 = torch.int64
    qpad = torch.zeros((B, J + M), dtype=i64, device=dev)
    spad = torch.zeros((B, J + M), dtype=i64, device=dev)
    qpad[:, J:] = qs
    spad[:, J:] = ss
    fpad = torch.full((B, J + M), NEG, dtype=i64, device=dev)
    vpad = torch.full((B, J + M), NEG, dtype=i64, device=dev)
    p_out = torch.zeros((B, M), dtype=i64, device=dev)
    jidx = torch.arange(J, device=dev)[None, :]
    neg = torch.tensor(NEG, dtype=i64, device=dev)
    for m in range(M):
        qw, sw = qpad[:, m : m + J], spad[:, m : m + J]
        fw, vw = fpad[:, m : m + J], vpad[:, m : m + J]
        qi, si = qpad[:, J + m : J + m + 1], spad[:, J + m : J + m + 1]
        dq = qi - qw
        dr_ok = (sw <= si) & (si - sw <= max_dr)
        dr = torch.where(dr_ok, si - sw, 0)
        dd = (dr - dq).abs()
        okj = ((dq > 0) & (dq <= max_dq) & dr_ok & (dr > 0) & (dd <= bw)
               & (fw > NEG // 2))
        mind = torch.minimum(torch.minimum(dq, dr),
                             torch.tensor(length, device=dev))
        # floor(log2(dd)) from the binary exponent (exact)
        logdd = torch.where(dd > 0, torch.frexp(dd.double()).exponent - 1,
                            0).to(i64)
        sc = mind - (dd * length) // 100 - (logdd >> 1)
        tot = torch.where(okj, fw + sc, neg)
        best = tot.max(1, keepdim=True).values
        arg = torch.where(tot == best, jidx, J).min(1, keepdim=True).values
        take = best > length
        f_i = torch.where(take, best, length)
        v_arg = torch.gather(vw, 1, arg.clamp(max=J - 1))
        v_i = torch.where(take, torch.maximum(v_arg, f_i), f_i)
        ok_i = vs[:, m : m + 1]
        fpad[:, J + m : J + m + 1] = torch.where(ok_i, f_i, neg)
        vpad[:, J + m : J + m + 1] = torch.where(ok_i, v_i, neg)
        p_out[:, m : m + 1] = torch.where(take, J - arg, 0)
    i32 = torch.int32
    return (fpad[:, J:].to(i32).contiguous(), p_out.to(i32),
            vpad[:, J:].to(i32).contiguous())


def chain_scan_cuda(qs, ss, vs, J: int, length: int, max_dq: int,
                    max_dr: int, bw: int):
    """The chain-scan kernel (``csrc/chain.cu``) on CUDA tensors;
    J in {32, 64, 128}."""
    if J not in (32, 64, 128):
        raise ValueError(f"chain_scan_cuda: lookback J={J} not in "
                         "(32, 64, 128)")
    B, M = qs.shape
    on_dev = _ext.on_device_of(qs, ss, vs)
    qs = qs.to(torch.int32).contiguous()
    ss = ss.to(torch.int64).contiguous()
    vv = vs.to(torch.uint8).contiguous()
    f = torch.empty((B, M), dtype=torch.int32, device=qs.device)
    p = torch.empty_like(f)
    v = torch.empty_like(f)
    P, I = _ext.P, _ext.I
    fn = _ext.function("chain", "lesv_chain",
                       [P, P, P] + [I] * 7 + [P] * 4)
    with on_dev:
        err = fn(qs.data_ptr(), ss.data_ptr(), vv.data_ptr(), B, M, J // 32,
                 length, max_dq, max_dr, bw, f.data_ptr(), p.data_ptr(),
                 v.data_ptr(), _ext.stream_of(qs))
    _ext.check(err, "lesv_chain")
    _ext.count_launch("chain")
    return f, p, v


def chain_scan(qs, ss, vs, J: int, length: int, max_dq: int, max_dr: int,
               bw: int):
    """Chain scan on the device of ``qs``: plain on the CPU, the CUDA
    kernel on a GPU."""
    if qs.device.type == "cpu":
        return chain_scan_plain(qs, ss, vs, J, length, max_dq, max_dr, bw)
    if qs.device.type == "cuda":
        return chain_scan_cuda(qs, ss, vs, J, length, max_dq, max_dr, bw)
    raise ValueError(f"chain_scan: unsupported device {qs.device}")


def sort_scan(qoff, soff, valid, J: int, length: int, max_dq: int,
              max_dr: int, bw: int):
    """Per-lane seed sort + chain scan on the device of ``qoff``, nothing
    read back: (f, p_rel, v, qs, ss, vs)."""
    qs, ss, vs = sort_seeds_device(qoff, soff, valid)
    f, p_rel, v = chain_scan(qs, ss, vs, J, length, max_dq, max_dr, bw)
    return f, p_rel, v, qs, ss, vs


def fetch_chain_arrays(f, p_rel, v, qs, ss, vs):
    """Device -> host fetch of the chain-DP outputs; p as the absolute
    predecessor index (-1 = none)."""
    f = f.cpu().numpy()
    p_rel = p_rel.cpu().numpy().astype(np.int64)
    v = v.cpu().numpy()
    qs = qs.cpu().numpy().astype(np.int64)
    ss = ss.cpu().numpy().astype(np.int64)
    vs = vs.cpu().numpy()
    idx = np.arange(f.shape[1], dtype=np.int64)[None, :]
    p = np.where(p_rel > 0, idx - p_rel, -1)
    p = np.where(p >= 0, p, -1)
    return f, p, v, qs, ss, vs


def chain_batch_device(qoff, soff, valid, length: int,
                       cfg: ChainConfig | None = None, J: int = 64,
                       Mp: int | None = None):
    """Sort + chain scan of (B, M) seed tensors on their device, then the
    host arrays (f, p, v, qoff, soff, valid), p as the absolute predecessor
    index (-1 = none).  ``Mp`` keeps the first Mp slots (valid slots are a
    prefix of the seeding expansion)."""
    cfg = cfg or ChainConfig()
    if Mp is not None:
        qoff, soff, valid = qoff[:, :Mp], soff[:, :Mp], valid[:, :Mp]
    with profiling.trace("chain/sort_scan"):
        out = sort_scan(qoff, soff, valid, J, length, cfg.max_dist_qry,
                        cfg.max_dist_ref, cfg.max_band_width)
    with profiling.trace("chain/fetch"):
        return fetch_chain_arrays(*out)


def _shrink_M(total: np.ndarray, M: int, lo: int = 256) -> int:
    """x2-ladder slot count covering every lane's (budget-clamped) match
    count; match buffers beyond it hold only invalid slots.  Coarse
    steps keep the number of (remotely) compiled chain-scan shapes
    small while bounding fetched dead slots at 2x."""
    need = int(np.minimum(np.asarray(total), M).max(initial=0))
    Mp = lo
    while Mp < need:
        Mp *= 2
    return min(Mp, M)


def slice_chain(f, p_rel, qs, ss, Mp: int, q16: bool, s16: bool):
    """The chain-DP outputs cut to their first ``Mp`` slots on their device
    for the fetch (``chain_jax._slice_chain_jit`` without ``v``): f int32,
    p_rel int16 (|p_rel| <= J <= 128), qs and ss int16 where ``q16`` /
    ``s16`` say their valid values are below 2^16, else int32 (ss holds
    unsigned 32-bit offsets).  Narrowing keeps the low bits, so the host
    reads the 16-bit values as uint16 and the 32-bit ss as uint32."""
    qs = qs[:, :Mp].to(torch.int16 if q16 else torch.int32)
    ss = ss[:, :Mp].to(torch.int16 if s16 else torch.int32)
    return f[:, :Mp], p_rel[:, :Mp].to(torch.int16), qs, ss


_NP_OF = {torch.int32: np.int32, torch.int16: np.int16}


def _read_back(parts):
    """Several tensors of one device in ONE device -> host copy: their bytes
    packed on the device (widest type first, so every part stays aligned),
    split into numpy arrays of their types and shapes on the host."""
    order = sorted(range(len(parts)), key=lambda i: -parts[i].element_size())
    buf = torch.cat([parts[i].reshape(-1).view(torch.uint8)
                     for i in order]).cpu().numpy()
    out = [None] * len(parts)
    o = 0
    for i in order:
        t = parts[i]
        n = t.numel() * t.element_size()
        out[i] = buf[o : o + n].view(_NP_OF[t.dtype]).reshape(t.shape)
        o += n
    return out


def fetch_chain_sliced(f, p_rel, qs, ss, total: np.ndarray, M: int,
                       Mp: int, q16: bool = False, s16: bool = False):
    """The sliced fetch of ``chain_jax.fetch_chain_sliced``: the first
    ``Mp`` slots of (f, p_rel, qs, ss), narrowed by :func:`slice_chain`,
    in one readback; then on the host v by ``native.chain_v_batch`` (its
    invalid-tail values are never read) and valid from ``total``, since
    the sort puts a lane's min(total, M) valid slots first.  Returns host
    (f, p, v, qs, ss, valid), p as the absolute predecessor index."""
    f, p16, qs, ss = _read_back(slice_chain(f, p_rel, qs, ss, Mp, q16, s16))
    qs = (qs.view(np.uint16) if q16 else qs).astype(np.int64)
    ss = ss.view(np.uint16 if s16 else np.uint32).astype(np.int64)
    v = native.chain_v_batch(f, p16)
    idx = np.arange(Mp, dtype=np.int64)[None, :]
    p = np.where(p16 > 0, idx - p16, -1)
    p = np.where(p >= 0, p, -1)
    n = np.minimum(np.asarray(total)[: f.shape[0]], M)
    return f, p, v, qs, ss, idx < n[:, None]


def chain_lanes_sliced(qoff, soff, valid, total: np.ndarray, M: int,
                       length: int, cfg: ChainConfig, J: int = 64,
                       q16: bool = False, s16: bool = False
                       ) -> list[list[Chain]]:
    """Chaining of (B, M) seed tensors whose per-lane match counts
    ``total`` (host) are known: sort + chain scan on their device at the
    live slots Mp (:func:`_shrink_M`), one sliced readback
    (:func:`fetch_chain_sliced`), host extraction per lane."""
    Mp = _shrink_M(total, M)
    with profiling.trace("chain/sort_scan"):
        f, p_rel, _, qs, ss, _ = sort_scan(
            qoff[:, :Mp], soff[:, :Mp], valid[:, :Mp], J, length,
            cfg.max_dist_qry, cfg.max_dist_ref, cfg.max_band_width)
    with profiling.trace("chain/fetch"):
        out = fetch_chain_sliced(f, p_rel, qs, ss, total, M, Mp, q16, s16)
    return extract_lanes(*out, length, cfg)


def extract_lanes(f, p, v, qs, ss, vs, length: int,
                  cfg: ChainConfig) -> list[list[Chain]]:
    """Host chain extraction for every lane of fetched DP arrays."""
    with profiling.trace("chain/extract"):
        return [extract_chains_from_fp(f[b], p[b], v[b], qs[b], ss[b],
                                       vs[b], length, cfg)
                for b in range(f.shape[0])]


def extract_chains_from_fp(
    f: np.ndarray, p: np.ndarray, v: np.ndarray,
    qoff: np.ndarray, soff: np.ndarray, valid: np.ndarray,
    length: int, cfg: ChainConfig | None = None,
) -> list[Chain]:
    """Host chain extraction over one lane's (f, p, v) arrays (the
    `chaining_find_candidates` logic, `chain_dp.c:273-395`): ends are
    seeds that are nobody's best predecessor, peaks resolved via v,
    greedy best-first claiming (``native.chain_extract``), then
    containment dedup and chain join.  The native path of
    ``lesv_tpu.ops.chain_jax.extract_chains_from_fp``."""
    cfg = cfg or ChainConfig()
    n = int(valid.sum())
    if n == 0:
        return []
    # native claims with full capacity; the max-chains cap applies AFTER
    # containment dedup (extract_chains_np parity)
    paths, bounds, scores, nc = native.chain_extract(
        np.asarray(f[:n], np.int64), np.asarray(p[:n], np.int64),
        np.asarray(v[:n], np.int64), cfg.min_chain_score,
        cfg.min_seed_cnt, n)
    chains: list[Chain] = []
    for c in range(nc):
        if len(chains) >= cfg.max_chains_per_context:
            break
        path = paths[bounds[c]:bounds[c + 1]]
        ch = Chain(
            score=int(scores[c]),
            qbeg=int(qoff[path[0]]),
            qend=int(qoff[path[-1]]) + length,
            sbeg=int(soff[path[0]]),
            send=int(soff[path[-1]]) + length,
            anchors=np.stack([qoff[path], soff[path]], axis=1),
            seed_len=length,
        )
        if not _is_contained(chains, ch):
            chains.append(ch)
    return join_adjacent_chains(chains, cfg)


def chain_lanes(qoff, soff, valid, length: int,
                cfg: ChainConfig | None = None, J: int = 64,
                Mp: int | None = None) -> list[list[Chain]]:
    """Full batched chaining of (B, M) seed tensors: sort + chain scan on
    their device (:func:`chain_batch_device`), host extraction per lane."""
    cfg = cfg or ChainConfig()
    return extract_lanes(*chain_batch_device(qoff, soff, valid, length, cfg,
                                             J=J, Mp=Mp), length, cfg)
