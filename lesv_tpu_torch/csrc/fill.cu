// Banded dual-affine alignment fill (ksw2-extd2 costs) for Hopper.
//
// Replaces lesv_tpu/ops/align_pallas.py::_fill_kernel, both variants, and
// its XLA twin lesv_tpu/ops/align_jax.py::banded_align_kernel: the same
// recurrences, direction bytes (3-bit source + 4 extension flags) and
// free_end reduction (best value, then lowest row, then lowest band slot).
// The kernel is a template over the state type:
//   int   -- sentinel NEG = -2^28, mask threshold THR = NEG/2;
//   short -- the i16 variant: sentinel NEG16 = -16384 and
//            THR = NEG16 + max(go1 + ge1*(W+1), go2 + ge2*(W+1)) + 16,
//            computed by the launcher from W and the gap costs.  The
//            caller runs it only where the gate (align_torch.i16_ok)
//            proves that no value leaves the int16 range; every stored or
//            compared value is cut to the state type, so the arithmetic
//            is that of int16 tensors.  Scores leave the kernel as int32
//            with values at or below THR mapped to the int32 sentinel.
// The affine-gap scan bases are rebased by the row constant (band slot b
// instead of subject column js = i - W/2 + b); the constant cancels in
// E = scan - go - b*ge, so only b*ge enters, which is what keeps the
// short variant in range.
//
// Design.  One CTA per (query, subject) pair; the W band slots are spread
// over the CTA's threads, each thread owning a contiguous run of
// ceil(W / blockDim) slots, so every W the bucketing produces is taken
// (W = 65 full mode up to the 4096-wide and wider full-mode deletion
// bands).  The row loop is sequential.  The within-row affine-gap
// dependency (E1/E2) is an inclusive prefix-max across the band: a
// sequential max over each thread's run, a warp __shfl_up_sync scan of
// the run maxima and a cross-warp combine in shared memory.  Row state
// (H, E1, E2, F1, F2 and per-row temporaries) lives in shared memory when
// it fits (W up to ~5k) and in a per-lane global scratch otherwise.
// Row state is 2 or 4 bytes per value, so the short variant fits shared
// memory up to twice the band.  Direction bytes go out one row at a time
// in lane-major (B, Qmax+1, W) layout; rows past the lane's query length
// are not written.
//
// What bounds it on this card: each row needs five block barriers and the
// dependent scan, so a CTA is latency-bound on the row loop; throughput
// comes from many CTAs (one per lane) in flight on the 132 SMs.  The dirs
// stream (one byte per cell) is far below HBM bandwidth.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG32 (-(1 << 28))
#define NEG16 (-16384)
#define FULLMASK 0xffffffffu

// exclusive max-scan of (a, b) over the threads of the block, in thread
// order; thread 0 gets NEG
__device__ __forceinline__ void block_excl_max2(int a, int b, int& ea,
                                                int& eb, int* ws1,
                                                int* ws2, const int NEG) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int ia = a, ib = b;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int ya = __shfl_up_sync(FULLMASK, ia, d);
    int yb = __shfl_up_sync(FULLMASK, ib, d);
    if (lane >= d) {
      ia = max(ia, ya);
      ib = max(ib, yb);
    }
  }
  int xa = __shfl_up_sync(FULLMASK, ia, 1);
  int xb = __shfl_up_sync(FULLMASK, ib, 1);
  if (lane == 0) {
    xa = NEG;
    xb = NEG;
  }
  if (lane == 31) {
    ws1[wid] = ia;
    ws2[wid] = ib;
  }
  __syncthreads();
  int pa = NEG, pb = NEG;
  for (int w = 0; w < wid; ++w) {
    pa = max(pa, ws1[w]);
    pb = max(pb, ws2[w]);
  }
  ea = max(pa, xa);
  eb = max(pb, xb);
}

// bytes of row state per lane: (6 or 8) arrays of W values and W flag
// bytes, rounded up to a multiple of 4
__host__ __device__ inline size_t state_bytes(int W, int free_end,
                                              int esz) {
  return (((size_t)(free_end ? 8 : 6) * W * esz + W + 3) / 4) * 4;
}

// T is the state type (int or short); NEG / THR its sentinel and mask
// threshold.  Every value is cut to T where it is produced ((T)(...)), so
// T = short computes exactly what int16 tensor arithmetic computes.
template <typename T, bool DIAG, bool FREE_END>
__global__ void fill_kernel(const uint8_t* __restrict__ q,
                            const uint8_t* __restrict__ s,
                            const int* __restrict__ qlen,
                            const int* __restrict__ slen, int Qmax,
                            int Smax, int W, int match, int mism, int go1,
                            int ge1, int go2, int ge2, const int NEG,
                            const int THR, uint8_t* gscratch,
                            uint8_t* __restrict__ dirs, int* score,
                            int* end_i, int* end_b, uint8_t* okv) {
  extern __shared__ int smem[];
  __shared__ int ws1[32], ws2[32];
  const int lane = blockIdx.x;
  const int nA = FREE_END ? 8 : 6;
  uint8_t* base =
      gscratch ? gscratch + (size_t)lane * state_bytes(W, FREE_END, sizeof(T))
               : (uint8_t*)smem;
  T* H = (T*)base;
  T* E1 = H + W;
  T* E2 = E1 + W;
  T* F1 = E2 + W;
  T* F2 = F1 + W;
  T* DG = F2 + W;
  T* BV = DG + W;              // free_end only
  T* BR = BV + W;              // free_end only
  uint8_t* FL = base + (size_t)nA * W * sizeof(T);

  const int nt = blockDim.x, tid = threadIdx.x;
  const int spt = (W + nt - 1) / nt;
  const int b0 = min(tid * spt, W), b1 = min(b0 + spt, W);
  const int W2 = W / 2;
  const uint8_t* ql = q + (size_t)lane * Qmax;
  const uint8_t* sl = s + (size_t)lane * Smax;
  const int L = qlen[lane], SL = slen[lane];
  const int R = Qmax + 1;
  uint8_t* dl = dirs + (size_t)lane * R * W;

  // row 0: boundary H/E/F and the dir0 byte
  for (int b = b0; b < b1; ++b) {
    const int js = DIAG ? b - W2 : b;
    const bool in0 = js >= 0 && js <= SL;
    int e1 = js > 0 ? -go1 - js * ge1 : NEG;
    int e2 = js > 0 ? -go2 - js * ge2 : NEG;
    int h = js == 0 ? 0 : max(e1, e2);
    if (!in0) {
      h = NEG;
      e1 = NEG;
      e2 = NEG;
    }
    H[b] = (T)h;
    E1[b] = (T)e1;
    E2[b] = (T)e2;
    F1[b] = (T)NEG;
    F2[b] = (T)NEG;
    dl[b] = (uint8_t)((e1 >= e2 ? 1 : 2) | 0x18);
    if (FREE_END) {
      BV[b] = (T)NEG;
      BR[b] = 0;
    }
  }
  __syncthreads();

  for (int i = 1; i <= L; ++i) {
    // A1: the previous row's values at the slot just outside this
    // thread's run (read before anyone overwrites them)
    int nbH = NEG, nbF1 = NEG, nbF2 = NEG;
    if (b1 > b0) {
      if (DIAG) {
        if (b1 < W) {
          nbH = H[b1];
          nbF1 = F1[b1];
          nbF2 = F2[b1];
        }
      } else if (b0 > 0) {
        nbH = H[b0 - 1];
      }
    }
    __syncthreads();

    // A2: diagonal / vertical sources and the scan bases
    const int qc = ql[i - 1];
    int tmax1 = NEG, tmax2 = NEG;
    int prevH = nbH;  // full mode: old H[b-1]
    for (int b = b0; b < b1; ++b) {
      int Hd, Hu, F1u, F2u;
      if (DIAG) {
        Hd = H[b];
        const bool own = b + 1 < b1;
        Hu = own ? H[b + 1] : nbH;
        F1u = own ? F1[b + 1] : nbF1;
        F2u = own ? F2[b + 1] : nbF2;
      } else {
        Hd = prevH;
        Hu = H[b];
        prevH = Hu;
        F1u = F1[b];
        F2u = F2[b];
      }
      const int js = DIAG ? i - W2 + b : b;
      const int si = js - 1;
      const int sj = (si >= 0 && si < Smax) ? sl[si] : 255;
      const int sub = sj == qc ? match : -mism;
      const int dg = (js >= 1 && Hd > THR) ? (T)(Hd + sub) : NEG;
      const int f1e = (T)(F1u - ge1), f2e = (T)(F2u - ge2);
      const int f1n = max((int)(T)(Hu - (go1 + ge1)), f1e);
      const int f2n = max((int)(T)(Hu - (go2 + ge2)), f2e);
      const int hpre = max(dg, max(f1n, f2n));
      const int base1 = hpre > THR ? (T)(hpre + b * ge1) : NEG;
      const int base2 = hpre > THR ? (T)(hpre + b * ge2) : NEG;
      tmax1 = max(tmax1, base1);
      tmax2 = max(tmax2, base2);
      H[b] = (T)hpre;
      DG[b] = (T)dg;
      F1[b] = (T)f1n;
      F2[b] = (T)f2n;
      FL[b] = (uint8_t)(((f1n == f1e) << 5) | ((f2n == f2e) << 6));
    }

    // B: prefix max of the bases across the band
    int c1, c2;
    block_excl_max2(tmax1, tmax2, c1, c2, ws1, ws2, NEG);

    // C: E1/E2 from the running prefix max (shifted by one slot)
    for (int b = b0; b < b1; ++b) {
      const int hpre = H[b];
      E1[b] = c1 > THR ? (T)((T)(c1 - go1) - b * ge1) : (T)NEG;
      E2[b] = c2 > THR ? (T)((T)(c2 - go2) - b * ge2) : (T)NEG;
      if (hpre > THR) {
        c1 = max(c1, (int)(T)(hpre + b * ge1));
        c2 = max(c2, (int)(T)(hpre + b * ge2));
      }
    }
    __syncthreads();

    // D: H, source + extension flags, free_end bests
    uint8_t* drow = dl + (size_t)i * W;
    for (int b = b0; b < b1; ++b) {
      const int js = DIAG ? i - W2 + b : b;
      const int e1 = E1[b], e2 = E2[b];
      const bool e1x = b == 0 || e1 == (T)(E1[b - 1] - ge1);
      const bool e2x = b == 0 || e2 == (T)(E2[b - 1] - ge2);
      const int dg = DG[b];
      int hn = max(H[b], max(e1, e2));
      if (!(js >= 0 && js <= SL)) hn = NEG;
      const int src = hn == dg ? 0
                      : hn == e1 ? 1
                      : hn == e2 ? 2
                      : hn == F1[b] ? 3
                                    : 4;
      drow[b] = (uint8_t)(src | (e1x << 3) | (e2x << 4) | FL[b]);
      H[b] = (T)hn;
      if (FREE_END && hn > BV[b]) {
        BV[b] = (T)hn;
        BR[b] = (T)i;
      }
    }
    __syncthreads();
  }

  if (tid == 0) {
    int sc, ei, eb;
    if (FREE_END) {
      int best = NEG, bi = 0x7fffffff, bb = 0;
      for (int b = 0; b < W; ++b) {
        const int v = BV[b], r = BR[b];
        if (v > best || (v == best && r < bi)) {
          best = v;
          bi = r;
          bb = b;
        }
      }
      // nothing beats the origin: score 0 at (0, 0)
      if (best <= 0) {
        sc = 0;
        ei = 0;
        eb = 0;
      } else {
        sc = best;
        ei = bi;
        eb = bb;
      }
    } else {
      ei = L;
      eb = SL - (DIAG ? L - W2 : 0);
      sc = H[min(max(eb, 0), W - 1)];
      // short state: widen, masked values become the int32 sentinel
      if (sizeof(T) == 2 && sc <= THR) sc = NEG32;
    }
    score[lane] = sc;
    end_i[lane] = ei;
    end_b[lane] = eb;
    okv[lane] = (uint8_t)(eb >= 0 && eb < W && sc > NEG32 / 2);
  }
}

template <typename T, bool DIAG, bool FE>
static int launch(int B, int nt, size_t smem, const uint8_t* q,
                  const uint8_t* s, const int* qlen, const int* slen,
                  int Qmax, int Smax, int W, int match, int mism, int go1,
                  int ge1, int go2, int ge2, int neg, int thr,
                  uint8_t* scratch, uint8_t* dirs, int* score, int* end_i,
                  int* end_b, uint8_t* ok, cudaStream_t st) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fill_kernel<T, DIAG, FE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fill_kernel<T, DIAG, FE><<<B, nt, smem, st>>>(
      q, s, qlen, slen, Qmax, Smax, W, match, mism, go1, ge1, go2, ge2, neg,
      thr, scratch, dirs, score, end_i, end_b, ok);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(int diag, int free_end, int B, int nt, size_t smem,
                    const uint8_t* q, const uint8_t* s, const int* qlen,
                    const int* slen, int Qmax, int Smax, int W, int match,
                    int mism, int go1, int ge1, int go2, int ge2, int neg,
                    int thr, uint8_t* scratch, uint8_t* dirs, int* score,
                    int* end_i, int* end_b, uint8_t* ok, cudaStream_t st) {
#define LESV_FILL_GO(D, F)                                                  \
  return launch<T, D, F>(B, nt, smem, q, s, qlen, slen, Qmax, Smax, W,      \
                         match, mism, go1, ge1, go2, ge2, neg, thr, scratch, \
                         dirs, score, end_i, end_b, ok, st)
  if (diag) {
    if (free_end) LESV_FILL_GO(true, true);
    LESV_FILL_GO(true, false);
  }
  if (free_end) LESV_FILL_GO(false, true);
  LESV_FILL_GO(false, false);
#undef LESV_FILL_GO
}

extern "C" {

// Per-lane state size in bytes (shared memory or global scratch) for a
// state element of esz bytes (4: int, 2: short).
long long lesv_fill_state_bytes(int W, int free_end, int esz) {
  return (long long)state_bytes(W, free_end, esz);
}

// i16 != 0 runs the short-state variant.  scratch == NULL: row state in
// dynamic shared memory; otherwise a (B, lesv_fill_state_bytes) byte
// buffer in device memory.
int lesv_fill(const void* q, const void* s, const void* qlen,
              const void* slen, int B, int Qmax, int Smax, int W, int diag,
              int free_end, int i16, int match, int mism, int go1, int ge1,
              int go2, int ge2, void* scratch, void* dirs, void* score,
              void* end_i, void* end_b, void* ok, void* stream) {
  if (B <= 0) return 0;
  const int nt = W >= 1024 ? 1024 : ((W + 31) / 32) * 32;
  const size_t smem =
      scratch ? 0 : state_bytes(W, free_end, i16 ? 2 : 4);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* qq = (const uint8_t*)q;
  const uint8_t* ss = (const uint8_t*)s;
  const int* ql = (const int*)qlen;
  const int* sl = (const int*)slen;
  uint8_t* sc = (uint8_t*)scratch;
  uint8_t* d = (uint8_t*)dirs;
  int* o0 = (int*)score;
  int* o1 = (int*)end_i;
  int* o2 = (int*)end_b;
  uint8_t* o3 = (uint8_t*)ok;
  if (i16) {
    const int g1 = go1 + ge1 * (W + 1), g2 = go2 + ge2 * (W + 1);
    const int thr = NEG16 + (g1 > g2 ? g1 : g2) + 16;
    return dispatch<short>(diag, free_end, B, nt, smem, qq, ss, ql, sl, Qmax,
                           Smax, W, match, mism, go1, ge1, go2, ge2, NEG16,
                           thr, sc, d, o0, o1, o2, o3, st);
  }
  return dispatch<int>(diag, free_end, B, nt, smem, qq, ss, ql, sl, Qmax,
                       Smax, W, match, mism, go1, ge1, go2, ge2, NEG32,
                       NEG32 / 2, sc, d, o0, o1, o2, o3, st);
}

}  // extern "C"
