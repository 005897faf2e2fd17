"""Batched banded dual-affine alignment: fill + traceback.

Counterpart of :mod:`lesv_tpu.ops.align_jax` and
:mod:`lesv_tpu.ops.align_pallas`.  Two functions carry the work, each with
a plain PyTorch version and a hand-written CUDA kernel:

* the fill (:func:`banded_fill`): plain :func:`banded_align_kernel`, the
  recurrences of ``align_jax.banded_align_kernel`` as a row loop of tensor
  ops; kernel ``csrc/fill.cu``.  Both come in two state types: int32, and
  int16 (``i16=True``, the ``i16`` variant of
  ``align_pallas._fill_kernel``), which :func:`banded_fill` picks per
  bucket when the gate :func:`i16_ok` proves it exact;
* the traceback (:func:`traceback_device`): plain :func:`traceback_plain`;
  kernel ``csrc/traceback.cu``.

A wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.  Direction bytes are lane-major
``(B, Qmax + 1, W)``; rows past a lane's query length are unspecified in
the kernel's output (the traceback never reads them).
"""

from __future__ import annotations

import numpy as np
import torch

from lesv_tpu_torch.config import AlignConfig
from lesv_tpu_torch import _ext

NEG = -(2**28)
NEG16 = -16384          # int16 sentinel (see i16_ok for the bound proof)
OP_M, OP_I, OP_D, OP_PAD = 0, 1, 2, 255
# row state above this many bytes per lane goes to a global scratch
# buffer instead of shared memory
SMEM_CAP = 200 * 1024


def i16_ok(Qmax: int, W: int, cfg: AlignConfig) -> bool:
    """True when the int16 fill is bit-identical to the int32 fill on
    score, end cell, ok and the decoded op path
    (``align_pallas._i16_ok``).

    The DP is a max over paths, so every valid in-band cell has
    H >= -(mism*Qmax + gpath) (all-mismatch diagonal plus one gap run of
    length <= Qmax + W at the cheaper of the two affine costs); E/F
    registers sit at most gmax_reg = max(go + ge*(W+1)) below an H value
    on any traceback-relevant chain.  Three conditions make int16 exact:

    1. THR separation: every traceback-relevant register value clears
       THR = NEG16 + gmax_reg + 16, so the mask tests agree with int32's
       NEG//2 tests wherever the traceback can look.
    2. No wraparound: masked F registers drift down ge per row from
       NEG16 (or from a real value that lost its H source), bounded by
       hmin + go + Qmax*ge + gmax_reg; that must stay above int16 min.
    3. Positive side: match*Qmax + ge*(W+1) within range.

    Cells the traceback cannot visit may hold different direction bytes
    than the int32 fill (deep drifted values clamp at THR differently)."""
    match, mism = cfg.match, cfg.mismatch
    go1, ge1, go2, ge2 = (cfg.gap_open1, cfg.gap_ext1, cfg.gap_open2,
                          cfg.gap_ext2)
    ge = max(ge1, ge2)
    gmax_reg = max(go1 + ge1 * (W + 1), go2 + ge2 * (W + 1))
    L = Qmax + W
    gpath = min(go1 + ge1 * L, go2 + ge2 * L)
    hmin = mism * Qmax + gpath
    real_reg_min = hmin + gmax_reg + max(go1 + ge1, go2 + ge2)
    if real_reg_min >= 16384 - gmax_reg - 64:       # THR separation
        return False
    if 16384 + go1 + go2 + Qmax * ge + gmax_reg + 128 >= 32768:
        return False                                # sentinel drift wrap
    if hmin + go1 + go2 + Qmax * ge + gmax_reg + 128 >= 32768:
        return False                                # real drift wrap
    if match * Qmax + ge * (W + 1) >= 16000:        # positive overflow
        return False
    return True


def i16_thr(W: int, cfg: AlignConfig) -> int:
    """Mask threshold of the int16 fill: NEG16 plus the deepest affine
    gap a band of W slots can hold, plus slack."""
    gmax = max(cfg.gap_open1 + cfg.gap_ext1 * (W + 1),
               cfg.gap_open2 + cfg.gap_ext2 * (W + 1))
    return NEG16 + gmax + 16


def _use_i16(Qmax: int, W: int, cfg: AlignConfig,
             force_i16: bool | None) -> bool:
    """The state type of one fill: the gate decides unless ``force_i16``
    pins it; forcing int16 where the gate fails raises (int16 arithmetic
    could wrap there)."""
    ok = i16_ok(Qmax, W, cfg)
    if force_i16 and not ok:
        raise ValueError(f"int16 fill forced on Qmax={Qmax}, W={W}: the "
                         "i16_ok gate does not hold for these costs")
    return ok if force_i16 is None else force_i16


def guide_of(mode: str, Qmax: int, W: int) -> np.ndarray:
    """The band start per row: g(i) such that band slot b holds subject
    column j = g(i) + b."""
    if mode == "full":
        return np.zeros(Qmax + 1, np.int64)
    return np.arange(Qmax + 1, dtype=np.int64) - W // 2


def banded_align_kernel(q: torch.Tensor, s: torch.Tensor,
                        qlen: torch.Tensor, slen: torch.Tensor, W: int,
                        mode: str, cfg: AlignConfig, free_end: bool = False,
                        i16: bool = False):
    """Plain fill.  q (B, Qmax) u8, s (B, Smax) u8, qlen/slen (B,) i32.

    ``i16`` keeps the DP state in ``torch.int16`` with the sentinel NEG16
    and the mask threshold :func:`i16_thr`, the arithmetic of the int16
    kernel; the caller checks :func:`i16_ok`.  The affine-gap scan bases
    are then rebased by the row constant (band slot instead of subject
    column; it cancels in E), which keeps them in range.

    Returns (dirs (B, Qmax+1, W) u8, score, end_i, end_b (B,) i32,
    ok (B,) bool); scores are int32 with the int32 sentinel either way."""
    assert mode in ("diag", "full")
    NEG_, THR = (NEG16, i16_thr(W, cfg)) if i16 else (NEG, NEG // 2)
    dt = torch.int16 if i16 else torch.int32
    dev = q.device
    B, Qmax = q.shape
    Smax = s.shape[1]
    go1, ge1, go2, ge2 = cfg.gap_open1, cfg.gap_ext1, cfg.gap_open2, \
        cfg.gap_ext2
    match, mism = cfg.match, cfg.mismatch
    W2 = W // 2
    diag_mode = mode == "diag"
    i32 = torch.int32
    qlen = qlen.to(i32)
    slen = slen.to(i32)
    sl = slen[:, None]
    br = torch.arange(W, dtype=i32, device=dev)[None, :]
    negcol = torch.full((B, 1), NEG_, dtype=dt, device=dev)
    neg = torch.tensor(NEG_, dtype=dt, device=dev)

    # row 0 in int32 (every value fits the state type), cut at the end
    neg0 = torch.tensor(NEG_, dtype=i32, device=dev)
    js0 = (br - W2) if diag_mode else br
    in0 = (js0 >= 0) & (js0 <= sl)
    E1 = torch.where(js0 > 0, -go1 - js0 * ge1, neg0).expand(B, W)
    E2 = torch.where(js0 > 0, -go2 - js0 * ge2, neg0).expand(B, W)
    H = torch.where(js0 == 0, torch.zeros_like(E1), torch.maximum(E1, E2))
    H = torch.where(in0, H, neg0).to(dt)
    E1 = torch.where(in0, E1, neg0).to(dt)
    E2 = torch.where(in0, E2, neg0).to(dt)
    F1 = torch.full((B, W), NEG_, dtype=dt, device=dev)
    F2 = F1.clone()
    dirs = torch.zeros((B, Qmax + 1, W), dtype=torch.uint8, device=dev)
    dirs[:, 0] = (torch.where(E1 >= E2, 1, 2) | 0x18).to(torch.uint8)

    # subject window of row i: s[js - 1] for every band slot (255 off the
    # ends), a view into a padded copy
    pad_l = W2 + 1 if diag_mode else 1
    s_pad = torch.full((B, pad_l + Smax + Qmax + W + 1), 255,
                       dtype=torch.uint8, device=dev)
    s_pad[:, pad_l : pad_l + Smax] = s
    s_pad = s_pad.to(i32)
    qi32 = q.to(i32)

    if free_end:
        best = (H[:, W2] if diag_mode else H[:, 0]).clone()
        best_i = torch.zeros(B, dtype=i32, device=dev)
        best_b = torch.zeros(B, dtype=i32, device=dev)
    rmax = int(qlen.max().item()) if B else 0
    for i in range(1, min(rmax, Qmax) + 1):
        js = (br + (i - W2)) if diag_mode else br
        inb = (js >= 0) & (js <= sl)
        # scan-base offset: the subject column, or (int16) the band slot
        jg = (br if i16 else js).to(dt)
        if diag_mode:
            Hd = H
            Hu = torch.cat([H[:, 1:], negcol], 1)
            F1u = torch.cat([F1[:, 1:], negcol], 1)
            F2u = torch.cat([F2[:, 1:], negcol], 1)
            sj = s_pad[:, i : i + W]
        else:
            Hd = torch.cat([negcol, H[:, :-1]], 1)
            Hu, F1u, F2u = H, F1, F2
            sj = s_pad[:, 0:W]
        sub = (sj == qi32[:, i - 1 : i]).to(dt) * (match + mism) - mism
        dg = torch.where((js >= 1) & (Hd > THR), Hd + sub, neg)
        F1e = F1u - ge1
        F2e = F2u - ge2
        F1n = torch.maximum(Hu - (go1 + ge1), F1e)
        F2n = torch.maximum(Hu - (go2 + ge2), F2e)
        Hpre = torch.maximum(dg, torch.maximum(F1n, F2n))
        ok_pre = Hpre > THR
        run1 = torch.cummax(torch.where(ok_pre, Hpre + jg * ge1, neg),
                            1).values
        run2 = torch.cummax(torch.where(ok_pre, Hpre + jg * ge2, neg),
                            1).values
        E1n = torch.cat([negcol, run1[:, :-1]], 1)
        E1n = torch.where(E1n > THR, E1n - go1 - jg * ge1, neg)
        E2n = torch.cat([negcol, run2[:, :-1]], 1)
        E2n = torch.where(E2n > THR, E2n - go2 - jg * ge2, neg)
        E1ext = torch.cat([torch.ones_like(negcol, dtype=torch.bool),
                           E1n[:, 1:] == E1n[:, :-1] - ge1], 1)
        E2ext = torch.cat([torch.ones_like(negcol, dtype=torch.bool),
                           E2n[:, 1:] == E2n[:, :-1] - ge2], 1)
        Hn = torch.maximum(Hpre, torch.maximum(E1n, E2n))
        Hn = torch.where(inb, Hn, neg)
        src = torch.where(Hn == dg, 0,
              torch.where(Hn == E1n, 1,
              torch.where(Hn == E2n, 2,
              torch.where(Hn == F1n, 3, 4))))
        dirs[:, i] = (src
                      | (E1ext.to(i32) << 3)
                      | (E2ext.to(i32) << 4)
                      | ((F1n == F1e).to(i32) << 5)
                      | ((F2n == F2e).to(i32) << 6)).to(torch.uint8)
        active = (i <= qlen)[:, None]
        H = torch.where(active, Hn, H)
        E1 = torch.where(active, E1n, E1)
        E2 = torch.where(active, E2n, E2)
        F1 = torch.where(active, F1n, F1)
        F2 = torch.where(active, F2n, F2)
        if free_end:
            Hv = torch.where(active & inb, Hn, neg)
            vm = Hv.max(1).values
            bm = torch.where(Hv == vm[:, None], br, W).min(1).values
            upd = active[:, 0] & (vm > best)
            best = torch.where(upd, vm, best)
            best_i = torch.where(upd, torch.full_like(best_i, i), best_i)
            best_b = torch.where(upd, bm, best_b)

    if free_end:
        # best starts at the origin's 0 and only grows: never a sentinel
        end_i, end_b, score = best_i, best_b, best.to(i32)
    else:
        end_i = qlen
        gq = (qlen - W2) if diag_mode else torch.zeros_like(qlen)
        end_b = slen - gq
        score = torch.gather(H, 1, end_b.clamp(0, W - 1)[:, None].long())[:, 0]
        score = score.to(i32)
        if i16:
            # widen: masked values become the int32 sentinel
            score = torch.where(score > THR, score,
                                torch.tensor(NEG, dtype=i32, device=dev))
    ok = (end_b >= 0) & (end_b < W) & (score > NEG // 2)
    return dirs, score, end_i, end_b, ok


def fill_state_bytes(W: int, free_end: bool, i16: bool) -> int:
    """Row state of one lane in bytes: 6 (8 with free_end) arrays of W
    values of the state type and W flag bytes, rounded up to 4."""
    return ((8 if free_end else 6) * W * (2 if i16 else 4) + W + 3) // 4 * 4


def fill_cuda(q, s, qlen, slen, W: int, mode: str, cfg: AlignConfig,
              free_end: bool = False, i16: bool = False):
    """The fill kernel (``csrc/fill.cu``) on CUDA tensors, with int32 or
    (``i16``) int16 state; same outputs as :func:`banded_align_kernel`
    with the same ``i16``, except that dirs rows past each lane's query
    length are left unwritten.  ``i16`` where :func:`i16_ok` fails
    raises."""
    B, Qmax = q.shape
    Smax = s.shape[1]
    for t, dt in ((q, torch.uint8), (s, torch.uint8), (qlen, torch.int32),
                  (slen, torch.int32)):
        if t.device.type != "cuda" or t.dtype != dt or not t.is_contiguous():
            raise ValueError("fill_cuda: expects contiguous CUDA tensors "
                             "q/s uint8 and qlen/slen int32")
    if mode not in ("diag", "full") or W < 1:
        raise ValueError(f"fill_cuda: bad band mode {mode!r} / W={W}")
    i16 = _use_i16(Qmax, W, cfg, i16)
    dev = q.device
    on_dev = _ext.on_device_of(q, s, qlen, slen)
    dirs = torch.empty((B, Qmax + 1, W), dtype=torch.uint8, device=dev)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    end_i = torch.empty_like(score)
    end_b = torch.empty_like(score)
    ok = torch.empty(B, dtype=torch.uint8, device=dev)
    state = fill_state_bytes(W, free_end, i16)
    scratch = None
    if state > SMEM_CAP:
        scratch = torch.empty(B * state, dtype=torch.uint8, device=dev)
    P, I = _ext.P, _ext.I
    fn = _ext.function("fill", "lesv_fill",
                       [P, P, P, P] + [I] * 13 + [P] * 7)
    with on_dev:
        err = fn(q.data_ptr(), s.data_ptr(), qlen.data_ptr(),
                 slen.data_ptr(), B, Qmax, Smax, W, int(mode == "diag"),
                 int(free_end), int(i16), cfg.match, cfg.mismatch,
                 cfg.gap_open1, cfg.gap_ext1, cfg.gap_open2, cfg.gap_ext2,
                 scratch.data_ptr() if scratch is not None else None,
                 dirs.data_ptr(), score.data_ptr(), end_i.data_ptr(),
                 end_b.data_ptr(), ok.data_ptr(), _ext.stream_of(q))
    _ext.check(err, "lesv_fill")
    _ext.LAUNCHES["fill_i16" if i16 else "fill"] += 1
    return dirs, score, end_i, end_b, ok.bool()


def banded_fill(q, s, qlen, slen, W: int, mode: str, cfg: AlignConfig,
                free_end: bool = False, force_i16: bool | None = None):
    """Fill on the device of ``q``: the plain version on the CPU, the
    CUDA kernel on a GPU.  The state type is int16 where :func:`i16_ok`
    holds for this (Qmax, W) and int32 otherwise; ``force_i16`` pins
    either, and raises ``ValueError`` for int16 outside the gate."""
    i16 = _use_i16(q.shape[1], W, cfg, force_i16)
    if q.device.type == "cpu":
        return banded_align_kernel(q, s, qlen, slen, W, mode, cfg, free_end,
                                   i16=i16)
    if q.device.type == "cuda":
        return fill_cuda(q, s, qlen, slen, W, mode, cfg, free_end, i16=i16)
    raise ValueError(f"banded_fill: unsupported device {q.device}")


def traceback_plain(dirs, end_i, end_b, ok, W: int, mode: str, T: int):
    """Plain traceback over lane-major dirs (B, R, W): the state machine
    of ``align_jax.traceback_device``, vectorized across lanes.  Returns
    (ops (B, T) u8 forward with OP_PAD tail, nops (B,) i32, reached (B,)
    bool)."""
    B, R, _ = dirs.shape
    dev = dirs.device
    W2 = W // 2
    d = 1 if mode == "diag" else 0
    diag_mode = mode == "diag"
    flat = dirs.reshape(-1)
    lane_base = torch.arange(B, device=dev, dtype=torch.int64) * (R * W)
    i = end_i.to(torch.int64)
    b = end_b.to(torch.int64)
    st = torch.zeros(B, dtype=torch.int64, device=dev)
    n = torch.zeros(B, dtype=torch.int64, device=dev)
    done = ~ok.bool()
    ops_rev = torch.full((B, max(T, 1)), OP_PAD, dtype=torch.uint8,
                         device=dev)
    lanes = torch.arange(B, device=dev)

    def at_origin(i, b):
        g = (i - W2) if diag_mode else torch.zeros_like(i)
        return (i <= 0) & (g + b <= 0)

    for _ in range(T):
        done = done | at_origin(i, b)
        if bool(done.all()):
            break
        byte = flat[lane_base + i.clamp(0, R - 1) * W
                    + b.clamp(0, W - 1)].to(torch.int64)
        src = byte & 7
        se = torch.where(st == 0, src, st)
        is_m = se == 0
        is_e = (se == 1) | (se == 2)
        is_f = (se == 3) | (se == 4)
        op = torch.where(is_m, OP_M, torch.where(is_e, OP_D, OP_I))
        act = ~done
        ops_rev[lanes[act], n[act]] = op[act].to(torch.uint8)
        eext = torch.where(se == 1, byte & 0x08, byte & 0x10) != 0
        fext = torch.where(se == 3, byte & 0x20, byte & 0x40) != 0
        ni = torch.where(is_m | is_f, i - 1, i)
        nb = torch.where(is_m, b + d - 1, torch.where(is_e, b - 1, b + d))
        nst = torch.where(is_m, 0,
                          torch.where(is_e, torch.where(eext, se, 0),
                                      torch.where(fext, se, 0)))
        oob = (nb < 0) | (nb >= W) | (ni < 0)
        i = torch.where(act, ni, i)
        b = torch.where(act, nb, b)
        st = torch.where(act, nst, st)
        n = torch.where(act, n + 1, n)
        bad = act & oob & ~at_origin(i, b)
        done = done | bad
        n = torch.where(bad, 0, n)
    reached = at_origin(i, b) & ok.bool() & (n > 0)
    t_idx = torch.arange(T, device=dev)[None, :]
    src_idx = (n[:, None] - 1 - t_idx).clamp(0, max(T - 1, 0))
    ops = torch.where(t_idx < n[:, None], torch.gather(ops_rev[:, :T], 1,
                                                       src_idx),
                      torch.tensor(OP_PAD, dtype=torch.uint8, device=dev))
    return ops, n.to(torch.int32), reached


def traceback_cuda(dirs, end_i, end_b, ok, W: int, mode: str, T: int):
    """The traceback kernel (``csrc/traceback.cu``) on CUDA tensors."""
    B, R, Wd = dirs.shape
    if Wd != W:
        raise ValueError(f"traceback_cuda: dirs band {Wd} != W {W}")
    if (dirs.device.type != "cuda" or dirs.dtype != torch.uint8
            or not dirs.is_contiguous()):
        raise ValueError("traceback_cuda: dirs must be contiguous CUDA u8")
    dev = dirs.device
    on_dev = _ext.on_device_of(dirs, end_i, end_b, ok)
    end_i = end_i.to(torch.int32).contiguous()
    end_b = end_b.to(torch.int32).contiguous()
    okv = ok.to(torch.uint8).contiguous()
    ops = torch.empty((B, T), dtype=torch.uint8, device=dev)
    nops = torch.empty(B, dtype=torch.int32, device=dev)
    reached = torch.empty(B, dtype=torch.uint8, device=dev)
    P, I = _ext.P, _ext.I
    fn = _ext.function("traceback", "lesv_traceback",
                       [P, I, I, I, P, P, P, I, I, P, P, P, P])
    with on_dev:
        err = fn(dirs.data_ptr(), B, R, W, end_i.data_ptr(),
                 end_b.data_ptr(), okv.data_ptr(), int(mode == "diag"), T,
                 ops.data_ptr(), nops.data_ptr(), reached.data_ptr(),
                 _ext.stream_of(dirs))
    _ext.check(err, "lesv_traceback")
    _ext.LAUNCHES["traceback"] += 1
    return ops, nops, reached.bool()


def traceback_device(dirs, end_i, end_b, ok, W: int, mode: str, T: int):
    """Traceback on the device of ``dirs``: plain on the CPU, the CUDA
    kernel on a GPU."""
    if dirs.device.type == "cpu":
        return traceback_plain(dirs, end_i, end_b, ok, W, mode, T)
    if dirs.device.type == "cuda":
        return traceback_cuda(dirs, end_i, end_b, ok, W, mode, T)
    raise ValueError(f"traceback_device: unsupported device {dirs.device}")


def banded_align_dispatch(q, s, qlen, slen, W: int, mode: str,
                          cfg: AlignConfig | None = None,
                          free_end: bool = False, device="cuda",
                          force_i16: bool | None = None):
    """Upload a padded batch, run fill + traceback on ``device``; returns
    a pending handle for :func:`banded_align_finish` (CUDA work is queued,
    not waited for).

    With a mesh active for ``device`` (:func:`parallel.mesh.active_mesh`)
    and at least one live lane per mesh device, the batch is filled and
    traced back shard by shard over the mesh instead."""
    from lesv_tpu_torch.parallel import mesh as meshmod

    cfg = cfg or AlignConfig()
    qlen = np.asarray(qlen, np.int32)
    slen = np.asarray(slen, np.int32)
    B = len(qlen)
    # live lanes are a prefix (padding lanes have qlen == 0)
    nz = np.flatnonzero(qlen > 0)
    n_live = int(nz[-1]) + 1 if len(nz) else 1
    dev = torch.device(device)

    def live(x, dt, pad=0, fill=0):
        x = np.ascontiguousarray(x[:n_live], dt)
        width = ((0, pad),) + ((0, 0),) * (x.ndim - 1)
        return np.pad(x, width, constant_values=fill) if pad else x

    mesh = meshmod.active_mesh(dev)
    if mesh is not None and n_live >= mesh.size:
        # lanes padded to a multiple of the mesh size with 1 x 1 fills
        # whose ok is masked below
        pad = -n_live % mesh.size
        fills = meshmod.mesh_fill(
            mesh, live(q, np.uint8, pad), live(s, np.uint8, pad),
            live(qlen, np.int32, pad, 1), live(slen, np.int32, pad, 1), W,
            mode, cfg, free_end, force_i16).shards
    else:
        pad = 0
        fills = [banded_fill(
            *(torch.from_numpy(live(x, dt)).to(dev)
              for x, dt in ((q, np.uint8), (s, np.uint8), (qlen, np.int32),
                            (slen, np.int32))),
            W, mode, cfg, free_end, force_i16)]
    # traceback per shard on the shard's device: the direction bytes
    # never leave their card
    per = (n_live + pad) // len(fills)
    shards = []
    for i, (dirs, score, end_i, end_b, ok) in enumerate(fills):
        if (i + 1) * per > n_live:
            ok = ok & (torch.arange(i * per, (i + 1) * per,
                                    device=ok.device) < n_live)
        ops, nops, reached = traceback_device(
            dirs, end_i, end_b, ok, W, mode, dirs.shape[1] + W + 2)
        shards.append(dict(ops=ops, nops=nops, reached=reached, score=score,
                           end_i=end_i, end_b=end_b, ok=ok))
    return dict(shards=shards, B=n_live, B_orig=B, W=W,
                Qmax=np.shape(q)[1], mode=mode, free_end=free_end,
                slen=slen[:n_live])


def banded_align_finish(pend: dict):
    """Read a pending fill back; the ``align_jax.banded_align_batch``
    result dict (numpy): score, ok, ops, nops, qe, se.  Only ops, nops,
    reached, score and the end cells cross to the host, shard by shard."""
    B, W, mode, free_end = (pend["B"], pend["W"], pend["mode"],
                            pend["free_end"])

    def fetch(key):
        return np.concatenate([sh[key].cpu().numpy()
                               for sh in pend["shards"]])[:B]

    ops = fetch("ops")
    nops = fetch("nops").astype(np.int64)
    reached = fetch("reached")
    score = fetch("score")
    end_i = fetch("end_i")
    end_b = fetch("end_b")
    ok = fetch("ok")
    # subject end: band start of the end row plus the end slot
    se = guide_of(mode, pend["Qmax"], W)[end_i] + end_b
    out = {
        "score": score,
        "ok": ok & reached,
        "ops": ops,
        "nops": nops,
        "qe": end_i,
        "se": np.where(free_end, se, pend["slen"][:B]),
    }
    Bo = pend["B_orig"]
    if Bo > B:
        pad = Bo - B
        out = {
            "score": np.pad(out["score"], (0, pad)),
            "ok": np.pad(out["ok"], (0, pad)),
            "ops": np.pad(out["ops"], ((0, pad), (0, 0)),
                          constant_values=OP_PAD),
            "nops": np.pad(out["nops"], (0, pad)),
            "qe": np.pad(out["qe"], (0, pad)),
            "se": np.pad(out["se"], (0, pad)),
        }
    return out


def banded_align_batch(q, s, qlen, slen, W: int, mode: str,
                       cfg: AlignConfig | None = None,
                       free_end: bool = False, device="cuda",
                       force_i16: bool | None = None):
    """numpy in, numpy out: fill and traceback on ``device``."""
    return banded_align_finish(banded_align_dispatch(
        q, s, qlen, slen, W, mode, cfg, free_end, device=device,
        force_i16=force_i16))
