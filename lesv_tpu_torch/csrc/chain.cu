// Chain DP scan over per-lane sorted seeds, one warp per lane.
//
// Replaces lesv_tpu/ops/chain_pallas.py::_chain_kernel (and its XLA twin
// lesv_tpu/ops/chain_jax.py::_chain_scan_kernel): for each seed, in
// (soff, qoff) order, score it against the previous J seeds -- gates
// 0 < dq <= max_dq, 0 < dr <= max_dr, |dr - dq| <= bw, live predecessor;
// score min(dq, dr, k) - dd*k/100 - floor(log2 dd)/2 -- take the best
// predecessor only if best > k (ties to the lowest window slot, i.e. the
// farthest seed back), and carry the running peak v.  NEG = -2^30.
// Subject offsets are unsigned 32-bit, so genome-scale offsets need no
// 16-bit limbs (the TPU kernel's limbs existed only for i32 vector math).
//
// Design.  The J-seed window lives in the warp's registers, J/32 slots per
// thread; a step scores every slot in parallel, a butterfly max-reduce
// over (value, slot) picks the first maximum, and the window shifts by one
// slot with __shfl_down_sync.  Lane thread 0 writes (f, p_rel, v).
//
// What bounds it on this card: the scan is sequential in the seeds, so one
// lane is ~M dependent warp steps (latency-bound); lanes run as
// independent warps, so a batch of B lanes costs about one lane's time
// while B warps fit on the SMs.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG (-(1 << 30))
#define FULLMASK 0xffffffffu

template <int SPT>
__global__ void chain_kernel(const int* __restrict__ qoff,
                             const int64_t* __restrict__ soff,
                             const uint8_t* __restrict__ valid, int B, int M,
                             int length, int max_dq, int max_dr, int bw,
                             int* __restrict__ f_out, int* __restrict__ p_out,
                             int* __restrict__ v_out) {
  const int J = 32 * SPT;
  const int lane = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (lane >= B) return;  // whole warps exit together
  int F[SPT], Q[SPT], V[SPT];
  unsigned S[SPT];
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    F[k] = NEG;
    Q[k] = 0;
    S[k] = 0u;
    V[k] = NEG;
  }
  const size_t row = (size_t)lane * M;
  for (int m = 0; m < M; ++m) {
    const int qi = qoff[row + m];
    const unsigned si = (unsigned)soff[row + m];
    const bool oki = valid[row + m] != 0;
    // best over this thread's slots: first maximum in slot order
    int best = NEG, arg = t * SPT, varg = V[0];
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int dq = qi - Q[k];
      const bool dr_ok = S[k] <= si && si - S[k] <= (unsigned)max_dr;
      const int dr = dr_ok ? (int)(si - S[k]) : 0;
      const int dd = abs(dr - dq);
      const bool okj = dq > 0 && dq <= max_dq && dr_ok && dr > 0 &&
                       dd <= bw && F[k] > NEG / 2;
      int tot = NEG;
      if (okj) {
        const int mind = min(min(dq, dr), length);
        const int logdd = dd > 0 ? 31 - __clz(dd) : 0;
        tot = F[k] + mind - (dd * length) / 100 - (logdd >> 1);
      }
      if (k == 0 || tot > best) {
        best = tot;
        arg = t * SPT + k;
        varg = V[k];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int ob = __shfl_xor_sync(FULLMASK, best, o);
      const int oa = __shfl_xor_sync(FULLMASK, arg, o);
      const int ov = __shfl_xor_sync(FULLMASK, varg, o);
      if (ob > best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
        varg = ov;
      }
    }
    const bool take = best > length;
    int fi = take ? best : length;
    int vi = take ? max(varg, fi) : fi;
    const int pi = take ? J - arg : 0;
    if (!oki) {
      fi = NEG;
      vi = NEG;
    }
    if (t == 0) {
      f_out[row + m] = fi;
      p_out[row + m] = pi;
      v_out[row + m] = vi;
    }
    // shift the window one slot toward slot 0; the new seed enters at J-1
    const int nF = __shfl_down_sync(FULLMASK, F[0], 1);
    const int nQ = __shfl_down_sync(FULLMASK, Q[0], 1);
    const unsigned nS = __shfl_down_sync(FULLMASK, S[0], 1);
    const int nV = __shfl_down_sync(FULLMASK, V[0], 1);
#pragma unroll
    for (int k = 0; k + 1 < SPT; ++k) {
      F[k] = F[k + 1];
      Q[k] = Q[k + 1];
      S[k] = S[k + 1];
      V[k] = V[k + 1];
    }
    F[SPT - 1] = t == 31 ? fi : nF;
    Q[SPT - 1] = t == 31 ? qi : nQ;
    S[SPT - 1] = t == 31 ? si : nS;
    V[SPT - 1] = t == 31 ? vi : nV;
  }
}

extern "C" {

// J = 32 * spt, spt in {1, 2, 4}
int lesv_chain(const void* qoff, const void* soff, const void* valid, int B,
               int M, int spt, int length, int max_dq, int max_dr, int bw,
               void* f, void* p, void* v, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  const int warps = 4;
  const dim3 grid((B + warps - 1) / warps), block(32 * warps);
  cudaStream_t st = (cudaStream_t)stream;
  const int* q = (const int*)qoff;
  const int64_t* s = (const int64_t*)soff;
  const uint8_t* ok = (const uint8_t*)valid;
  int* fo = (int*)f;
  int* po = (int*)p;
  int* vo = (int*)v;
  switch (spt) {
    case 1:
      chain_kernel<1><<<grid, block, 0, st>>>(q, s, ok, B, M, length, max_dq,
                                              max_dr, bw, fo, po, vo);
      break;
    case 2:
      chain_kernel<2><<<grid, block, 0, st>>>(q, s, ok, B, M, length, max_dq,
                                              max_dr, bw, fo, po, vo);
      break;
    case 4:
      chain_kernel<4><<<grid, block, 0, st>>>(q, s, ok, B, M, length, max_dq,
                                              max_dr, bw, fo, po, vo);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
