// Chain DP scan over per-lane sorted seeds: one warp per lane, seeds staged
// in shared memory ahead of the scan, the two newest predecessors off the
// warp reduction.
//
// Replaces lesv_tpu/ops/chain_pallas.py:44 _chain_kernel (and its XLA twin
// lesv_tpu/ops/chain_jax.py::_chain_scan_kernel): for each seed, in
// (soff, qoff) order, score it against the previous J seeds -- gates
// 0 < dq <= max_dq, 0 < dr <= max_dr, |dr - dq| <= bw, live predecessor;
// score min(dq, dr, k) - dd*k/100 - floor(log2 dd)/2 -- take the best
// predecessor only if best > k (ties to the lowest window slot, i.e. the
// farthest seed back), and carry the running peak v.  NEG = -2^30.
// Subject offsets are unsigned 32-bit, so genome-scale offsets need no
// 16-bit limbs (the TPU kernel's limbs existed only for i32 vector math).
//
// What bounds it on this card: the scan is sequential in the seeds, so a
// lane is M dependent steps, and lanes run as independent warps (B=128
// lanes leave most of the card idle).  A step is issue-bound on its one
// warp: about 160 instructions at J=64 (two slots a thread scored, the
// warp reduction, the two newest candidates, the window shift), at about
// two cycles each.
//
// Design.
// * Seeds staged ahead: the warp copies tiles of MT seeds (qoff, soff,
//   valid, plus LOOK seeds of overlap for the look-ahead) into a
//   two-stage ring in shared memory with cp.async while it scans the
//   previous tile.  qoff and soff go element by element (4 and 8 bytes,
//   always aligned); valid goes as the 4-byte-aligned words that cover
//   the tile, so a row start at any offset (M = 700, 1025, ...) takes the
//   same path.
// * The newest slots off the critical path.  Of seed m's J candidates only
//   the two newest (seeds m - 2 and m - 1) need f values of the last two
//   steps.  The reduction over the other J - 2 slots for seed m runs two
//   steps ahead, beside the steps before it, and step m is then: the two
//   newest candidates weighed one by one against that maximum (a newer
//   slot is a higher one, so it wins only when strictly greater: the
//   first-max rule), and f, v, p.
// * Short reduction: each thread's first maximum over its slots, then
//   __reduce_max_sync (one redux.sync), __ballot_sync + __ffs for the
//   lowest thread holding it (slots are thread-major, so its own first
//   maximum is the lowest slot), and one __shfl_sync each for the slot and
//   its v; the first half runs in step m - 2, the second in step m - 1.
// * f, p and v are kept in registers, lane m % 32 holding seed m, and
//   written with one coalesced 128-byte store per array every 32 seeds.
// * Not taken: stopping at a lane's invalid tail (exact, but the lanes of
//   a batch are as long as their longest).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define NEG (-(1 << 30))
#define FULLMASK 0xffffffffu
#define MT 512  // seeds a tile
#define LOOK 3  // look-ahead seeds staged with each tile

struct ChainArgs {
  int length, max_dq, max_dr, bw;
};

// score part of predecessor (qp, sp) for seed (qi, si): sets `gate` to all
// of the pair's gates except the predecessor's liveness
__device__ __forceinline__ int pair_score(int qp, unsigned sp, int qi,
                                          unsigned si, const ChainArgs& a,
                                          bool& gate) {
  const int dq = qi - qp;
  const bool dr_ok = sp <= si && si - sp <= (unsigned)a.max_dr;
  const int dr = dr_ok ? (int)(si - sp) : 0;
  const int dd = abs(dr - dq);
  gate = dq > 0 && dq <= a.max_dq && dr_ok && dr > 0 && dd <= a.bw;
  const int mind = min(min(dq, dr), a.length);
  const int logdd = dd > 0 ? 31 - __clz(dd) : 0;
  return mind - (dd * a.length) / 100 - (logdd >> 1);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

template <int SPT>
__global__ void __launch_bounds__(32)
    chain_kernel(const int* __restrict__ qoff,
                 const int64_t* __restrict__ soff,
                 const uint8_t* __restrict__ valid, int M, ChainArgs a,
                 int* __restrict__ f_out, int* __restrict__ p_out,
                 int* __restrict__ v_out) {
  constexpr int J = 32 * SPT;
  __shared__ int sq[2][MT + LOOK];
  __shared__ long long ss[2][MT + LOOK];
  __shared__ __align__(16) uint8_t sv[2][MT + 16];
  const int t = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * M;
  const int* qrow = qoff + row;
  const int64_t* srow = soff + row;
  const uint8_t* vrow = valid + row;
  const int ntiles = (M + MT - 1) / MT;
  // valid of tile k starts this many bytes into its stage
  auto vhead = [&](int k) { return (int)((uintptr_t)(vrow + k * MT) & 3); };

  // tile k -> stage k & 1: seeds [k*MT, min(k*MT + MT + LOOK, M))
  auto issue = [&](int k) {
    const int s = k & 1, e0 = k * MT, e1 = min(e0 + MT + LOOK, M);
    for (int e = e0 + t; e < e1; e += 32) {
      cp_async4(&sq[s][e - e0], qrow + e);
      cp_async8(&ss[s][e - e0], srow + e);
    }
    const uintptr_t v0 = (uintptr_t)(vrow + e0);
    const uintptr_t w0 = v0 & ~(uintptr_t)3;
    const int words = (int)((v0 - w0) + (e1 - e0) + 3) >> 2;
    for (int w = t; w < words; w += 32)
      cp_async4(&sv[s][4 * w], (const void*)(w0 + 4 * (uintptr_t)w));
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // Slot j of thread t is window slot w = t*SPT + j.  While step m runs
  // the registers hold the window of step m + 2: slot w is seed
  // m + 2 - J + w.  Its two newest slots (seeds m and m + 1, whose f is not
  // known yet) stay out of the reduction; their pair scores against seed
  // m + 2 go to every lane instead, and step m + 2 weighs them one by one.
  // The reduction itself spans two steps: the thread maxima and the
  // redux.sync in step m, the ballot and the shuffles in step m + 1.
  constexpr int W1 = J - 1, W2 = J - 2, W3 = J - 3;
  int F[SPT], Q[SPT], V[SPT];
  unsigned S[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    F[j] = NEG;
    Q[j] = 0;
    S[j] = 0u;
    V[j] = NEG;
  }
  issue(0);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncwarp();
  // seeds 0, 1, 2 (slots past M hold whatever the stage held: unused)
  const int q0 = sq[0][0], q1 = sq[0][1];
  const unsigned s0 = (unsigned)ss[0][0], s1 = (unsigned)ss[0][1];
  int qx = sq[0][2];
  unsigned sx = (unsigned)ss[0][2];
  bool okm = sv[0][vhead(0)] != 0;
  // the window of step 2: seed 0 at slot J-2, seed 1 at slot J-1
  if (t == W2 / SPT) {
    Q[W2 % SPT] = q0;
    S[W2 % SPT] = s0;
  }
  if (t == 31) {
    Q[SPT - 1] = q1;
    S[SPT - 1] = s1;
  }
  // step m's inputs (m = 0): the others' first maximum, the pair scores of
  // its two newest candidates (INT_MIN where a gate fails), and f, v of
  // seeds m - 2 and m - 1
  int ob = NEG, oarg = 0, ovarg = NEG;
  int P2 = INT_MIN, P1 = INT_MIN;
  int f2 = NEG, v2 = NEG, f1 = NEG, v1 = NEG;
  // the first half of step 1's reduction: nothing live among the others;
  // its newest pairs are (seed -1, seed 1), never live, and (0, 1)
  int wb = NEG, tb = NEG, tk = 0, tv = NEG, ps2 = INT_MIN, ps1;
  {
    bool g;
    const int sc = pair_score(q0, s0, q1, s1, a, g);
    ps1 = g ? sc : INT_MIN;
  }
  int rf = 0, rp = 0, rv = 0;

  for (int k = 0; k < ntiles; ++k) {
    const int s = k & 1;
    if (k > 0) {
      asm volatile("cp.async.wait_all;\n" ::);
      __syncwarp();
    }
    if (k + 1 < ntiles) issue(k + 1);
    const int e0 = k * MT, e1 = min(e0 + MT, M), vh = vhead(k);
    for (int m = e0; m < e1; ++m) {
      // ---- step m: the others' maximum, then slot J-2, then slot J-1;
      // a newer slot wins only when strictly greater (first-max rule)
      const int c2 = (P2 != INT_MIN && f2 > NEG / 2) ? f2 + P2 : NEG;
      const bool n2 = c2 > ob;
      const int b2 = n2 ? c2 : ob;
      const int a2 = n2 ? W2 : oarg;
      const int x2 = n2 ? v2 : ovarg;
      const int c1 = (P1 != INT_MIN && f1 > NEG / 2) ? f1 + P1 : NEG;
      const bool n1 = c1 > b2;
      const int best = n1 ? c1 : b2;
      const int arg = n1 ? W1 : a2;
      const int varg = n1 ? v1 : x2;
      const bool take = best > a.length;
      int fi = take ? best : a.length;
      int vi = take ? max(varg, fi) : fi;
      const int pi = take ? J - arg : 0;
      if (!okm) {
        fi = NEG;
        vi = NEG;
      }

      // ---- second half of step m + 1's reduction: the lowest thread
      // holding the maximum, its slot and v; the newest pairs' scores
      const int src = __ffs(__ballot_sync(FULLMASK, tb == wb)) - 1;
      const int nk = __shfl_sync(FULLMASK, tk, src);
      const int nv = __shfl_sync(FULLMASK, tv, src);
      const int nP2 = __shfl_sync(FULLMASK, ps2, W2 / SPT);
      const int nP1 = __shfl_sync(FULLMASK, ps1, 31);

      // ---- first half of step m + 2's reduction, against seed m + 2
      int ub = NEG, uk = 0, uv = V[0], u2 = INT_MIN, u1 = INT_MIN;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int w = t * SPT + j;
        bool g;
        const int sc = pair_score(Q[j], S[j], qx, sx, a, g);
        int tot = (g && F[j] > NEG / 2) ? F[j] + sc : NEG;
        if (w == W2) u2 = g ? sc : INT_MIN;
        if (w == W1) u1 = g ? sc : INT_MIN;
        if (w >= W2) tot = NEG;
        if (j == 0 || tot > ub) {
          ub = tot;
          uk = j;
          uv = V[j];
        }
      }
      const int uw = __reduce_max_sync(FULLMASK, ub);

      // ---- outputs: lane m % 32 keeps seed m, 32 seeds a store
      const int lm = m & 31;
      if (t == lm) {
        rf = fi;
        rp = pi;
        rv = vi;
      }
      if (lm == 31 || m == M - 1) {
        const int b0 = m - lm;
        if (t <= lm) {
          f_out[row + b0 + t] = rf;
          p_out[row + b0 + t] = rp;
          v_out[row + b0 + t] = rv;
        }
      }

      // ---- look-ahead loads: seed m + 3, valid of m + 1 (in stage s)
      const int i3 = m + 3 - e0, i1 = m + 1 - e0;
      const int qy = sq[s][i3];
      const unsigned sy = (unsigned)ss[s][i3];
      const bool ok1 = sv[s][vh + i1] != 0;

      // ---- the window of step m + 3: one slot toward slot 0, seed m + 2
      // enters at J-1, seed m (now with its f and v) sits at J-3
      const int nF = __shfl_down_sync(FULLMASK, F[0], 1);
      const int nQ = __shfl_down_sync(FULLMASK, Q[0], 1);
      const unsigned nS = __shfl_down_sync(FULLMASK, S[0], 1);
      const int nV = __shfl_down_sync(FULLMASK, V[0], 1);
#pragma unroll
      for (int j = 0; j + 1 < SPT; ++j) {
        F[j] = F[j + 1];
        Q[j] = Q[j + 1];
        S[j] = S[j + 1];
        V[j] = V[j + 1];
      }
      F[SPT - 1] = t == 31 ? NEG : nF;
      Q[SPT - 1] = t == 31 ? qx : nQ;
      S[SPT - 1] = t == 31 ? sx : nS;
      V[SPT - 1] = t == 31 ? NEG : nV;
      if (t == W3 / SPT) {
        F[W3 % SPT] = fi;
        V[W3 % SPT] = vi;
      }

      ob = wb;
      oarg = src * SPT + nk;
      ovarg = nv;
      P2 = nP2;
      P1 = nP1;
      wb = uw;
      tb = ub;
      tk = uk;
      tv = uv;
      ps2 = u2;
      ps1 = u1;
      f2 = f1;
      v2 = v1;
      f1 = fi;
      v1 = vi;
      qx = qy;
      sx = sy;
      okm = ok1;
    }
  }
}

extern "C" {

// J = 32 * spt, spt in {1, 2, 4}
int lesv_chain(const void* qoff, const void* soff, const void* valid, int B,
               int M, int spt, int length, int max_dq, int max_dr, int bw,
               void* f, void* p, void* v, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  const ChainArgs a{length, max_dq, max_dr, bw};
  cudaStream_t st = (cudaStream_t)stream;
  const int* q = (const int*)qoff;
  const int64_t* s = (const int64_t*)soff;
  const uint8_t* ok = (const uint8_t*)valid;
  int* fo = (int*)f;
  int* po = (int*)p;
  int* vo = (int*)v;
  switch (spt) {
    case 1:
      chain_kernel<1><<<B, 32, 0, st>>>(q, s, ok, M, a, fo, po, vo);
      break;
    case 2:
      chain_kernel<2><<<B, 32, 0, st>>>(q, s, ok, M, a, fo, po, vo);
      break;
    case 4:
      chain_kernel<4><<<B, 32, 0, st>>>(q, s, ok, M, a, fo, po, vo);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
