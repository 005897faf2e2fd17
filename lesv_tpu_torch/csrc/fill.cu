// Banded dual-affine alignment fill (ksw2-extd2 costs) for Hopper.
//
// Replaces lesv_tpu/ops/align_pallas.py::_fill_kernel, both variants, and
// its XLA twin lesv_tpu/ops/align_jax.py::banded_align_kernel: the same
// recurrences, direction bytes (3-bit source + 4 extension flags) and
// free_end reduction (best value, then lowest row, then lowest band slot).
// Two state types:
//   int32 -- sentinel NEG = -2^28, mask threshold THR = NEG/2;
//   int16 -- sentinel NEG16 = -16384 and
//            THR = NEG16 + max(go1 + ge1*(W+1), go2 + ge2*(W+1)) + 16,
//            computed by the launcher from W and the gap costs.  The
//            caller runs it only where the gate (align_torch.i16_ok)
//            proves that no value leaves the int16 range, but the
//            arithmetic wraps exactly as int16 tensors do whatever the
//            values, so every byte equals the plain int16 version's.
//            Scores leave the kernel as int32 with values at or below THR
//            mapped to the int32 sentinel.
// The affine-gap scan bases are rebased by the row constant (band slot b
// instead of subject column js = i - W/2 + b); the constant cancels in
// E = scan - go - b*ge, so only b*ge enters, which keeps int16 in range.
//
// What bounds it on this card.  The row loop is a chain of dependent
// rows; within a row the E recurrence is a prefix max along the band.  The
// operations (~42 a cell) are far above the bytes (one direction byte a
// cell), so the card's integer issue rate bounds the work, and the row
// chain bounds each lane.  The kernel this one replaces (one CTA of up to
// 1,024 threads per lane, all row state in shared memory) spent its rows
// on four block barriers (not five, as its note said), a serial cross-warp
// combine and shared-memory round trips, and its int16 variant cut every
// value one at a time.
//
// Design.
//  * fill_warp, the register design, for W up to 2,048: a lane is NW
//    warps, each thread a run of S consecutive slots (template parameters,
//    from W alone: one warp of S = 2 or 4 up to W = 128, where the
//    1,024-lane buckets fill the 132 SMs with warps; 2 warps of S = 4 at
//    W = 256, 2 of S = 8 at 512, 8 of S = 4 at 1,024, 8 of S = 8 above).  A CTA holds 128 threads at least, so several lanes where
//    NW < 4.  H, F1, F2 and the subject window stay in registers across
//    rows; DG, the F flags and E live only within a row; no row state in
//    shared memory.  Neighbours at thread edges come by one shuffle per
//    carried array (diag: H, F1, F2 at b+1; full: H at b-1), the subject
//    window of diag mode moves one slot a row by one shuffle (the lane's
//    last thread loads the new byte a row ahead), the query byte is loaded
//    a row ahead.  The prefix max is a sequential max over the thread's
//    slots, a 5-step __shfl_up_sync scan of the thread totals (across the
//    lane's warps: their totals through shared memory, a loop over at most
//    three or a shuffle scan), and a second pass over the slots; the
//    E-extension flag of a thread's first slot takes E[b-1] by one more
//    shuffle after that pass.  With one warp a lane the row loop has no
//    barrier at all; with several, the warps meet twice a row at a named
//    barrier of their own (bar.sync of the lane's 32 NW threads): after the
//    warp totals, and after the edge values of the row (first-slot H, F1,
//    F2 and subject codes, last-slot H and E).  Direction bytes leave as
//    16-, 8-, 4- or 2-byte stores as the row offset allows, bytes
//    elsewhere.
//    int16 packs slots b and b + S/2 of the thread's run in one 32-bit
//    register and computes with the wrapping halfword intrinsics (__vadd2,
//    __vmaxs2, __vminu2; constants are subtracted by adding their
//    negation): the two halves are two runs of S/2 slots scanned side by
//    side, and the high half's carry is the low half's total, so a
//    register step does two cells.  This pairing keeps every step of a run
//    within one register half; pairing b with b+1 would need a shift inside
//    the register at every step of the scan.  On sm_90 the halfword add and
//    max are single instructions but a halfword compare is not; the masks
//    are built from xor, __vminu2 and one multiply (I16x2::ne), exact for
//    every pair of int16 values and shorter than the sequences sm_90 runs
//    for __vcmpeq2 / __vcmpgts2.
//    free_end keeps one best (value, row, slot) per thread and half, and
//    reduces them by shuffles (and across the lane's warps) at the end.
//  * fill_block, the wide design, for bands wider than 2,048 (the
//    full-mode deletion bands of 4,096 to 8,192, and the whole-span NW of
//    the global fallback at bands to 65,536 and more): a lane's band over
//    the C CTAs of one thread-block cluster (C a power of two up to 16,
//    chosen by the caller from the launch's lanes and band,
//    align_torch.cluster_split; C = 1 is one CTA a lane, launched without a
//    cluster), CTA rank k owning the slots [k nt spt, (k + 1) nt spt).  In
//    a CTA, up to 1,024 threads, each thread a run of spt slots,
//    H/F1/F2/DG and the F flags in shared memory (or in a global scratch
//    where they do not fit), E not kept.  The runs are stored interleaved
//    (slot k of every thread's run side by side), so that a warp's
//    accesses fall in consecutive elements: no bank conflicts, and whole
//    lines of the scratch (stored run after run, the accesses of a warp at
//    runs of 64 slots touched 32 lines, and the scratch bands ran 5 to 8
//    times slower).  Two barriers a row: one to publish the warp totals of
//    the scan (combined by a shuffle scan in every warp), one to publish
//    each thread's edge values (H, F1, F2 for the next row, E1/E2 for the
//    neighbour's extension flags).  With C > 1 both are cluster barriers
//    (barrier.cluster arrive.release / wait.acquire), and the values that
//    cross a CTA's edge go through distributed shared memory, twice a row:
//    after phase 1 each CTA sends its scan totals to every higher rank (the
//    carry into rank k is the max of ranks j < k: no chain over the ranks,
//    since phase 1's totals take no carry), after phase 2 its outer edges to
//    its neighbours (diag: H, F1, F2 of its first slot to rank k - 1; full:
//    H of its last slot to rank k + 1; E1, E2 of its last slot to rank k + 1
//    for the first slot's extension flags).  The second barrier is split:
//    a CTA arrives with its edges sent, fills the next row's slots that
//    need no neighbour, then waits; the first slot's direction byte of a
//    row is written after that wait.  free_end reduces each CTA's best cell
//    on rank 0 by the same order; a global end is read by the rank that
//    owns its slot.  The direction bytes keep one layout, each CTA writing
//    its own slots, so the traceback sees no difference.
//    A lane's rows set its time, and the row's instructions bound it, not
//    its memory traffic (loads issued four slots ahead, or whole lines for
//    the subject codes and direction bytes, did not make one CTA faster).
//    On an H100 a slot a thread costs a row about 1 us at runs of up to 4
//    slots (1.2 us at 16), and the cluster's barriers and exchanges about 2
//    to 3 us a row: one CTA fills 0.7e9 to 1.1e9 cells a second from W =
//    4,096 to 65,536; one lane split over 16 CTAs 4.5e9 at W = 16,384, 7.4e9
//    at 32,768 and 11.2e9 at 65,536 (a slot or two a thread).  So the
//    caller splits only where that takes at least 3 slots off each
//    thread's run and leaves a slot a thread, within the clusters the card
//    holds at once.
// The launcher picks the design from W and the state type, and takes
// fill_block's cluster size from its caller (lesv_fill's split).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

#define NEG32 (-(1 << 28))
#define NEG16 (-16384)
#define FULLMASK 0xffffffffu

// largest band of the register design (wider would need more warps a lane
// than leave each thread its registers)
#define REG_W 2048

// ---------------------------------------------------------------------------
// Value types of the register design.  V holds NPR slots; M is a mask; SV
// is the value of the scan (the thread totals of both gap costs).

struct I32 {
  typedef int V;
  typedef bool M;
  typedef int2 SV;
  static constexpr int NPR = 1;
  static constexpr bool I16 = false;
  __device__ __forceinline__ static V pk(int x) { return x; }
  __device__ __forceinline__ static V pair(int lo, int) { return lo; }
  __device__ __forceinline__ static int cut(int x) { return x; }
  __device__ __forceinline__ static V add(V a, V b) { return a + b; }
  __device__ __forceinline__ static V vmax(V a, V b) { return max(a, b); }
  __device__ __forceinline__ static M gt(V a, V b) { return a > b; }
  __device__ __forceinline__ static M ge(V a, V b) { return a >= b; }
  __device__ __forceinline__ static M le(V a, V b) { return a <= b; }
  __device__ __forceinline__ static M eq(V a, V b) { return a == b; }
  __device__ __forceinline__ static V sel(M m, V a, V b) { return m ? a : b; }
  __device__ __forceinline__ static M mand(M a, M b) { return a && b; }
  __device__ __forceinline__ static M mor(M a, M b) { return a || b; }
  __device__ __forceinline__ static V vor(V a, V b) { return a | b; }
  __device__ __forceinline__ static V bits(M m, int c) { return m ? c : 0; }
  // the mask of slot 0 of the band, on its thread
  __device__ __forceinline__ static M first(bool t0) { return t0; }
  // value of half h, sign-extended
  __device__ __forceinline__ static int get(V v, int) { return v; }
  __device__ __forceinline__ static uint32_t byte(V v, int) {
    return (uint32_t)v & 0xffu;
  }
  // neighbours across the thread edge: the slots after the thread's last
  // (x0: its register 0) and before its first (xl: its last register);
  // fill is the register of the thread past the warp's end (x0 of the next
  // warp's lane 0, xl of the previous warp's lane 31)
  __device__ __forceinline__ static V up_edge(V x0, V fill, int lane) {
    V n = __shfl_down_sync(FULLMASK, x0, 1);
    return lane == 31 ? fill : n;
  }
  __device__ __forceinline__ static V down_edge(V xl, V fill, int lane) {
    V p = __shfl_up_sync(FULLMASK, xl, 1);
    return lane == 0 ? fill : p;
  }
  // the scan: thread totals, their max, shuffles, the carries of the runs
  __device__ __forceinline__ static SV total(V ta, V tb) {
    return make_int2(ta, tb);
  }
  __device__ __forceinline__ static SV sneg(int neg) {
    return make_int2(neg, neg);
  }
  __device__ __forceinline__ static SV smax(SV a, SV b) {
    return make_int2(max(a.x, b.x), max(a.y, b.y));
  }
  __device__ __forceinline__ static SV shfl_up(SV a, int d) {
    return make_int2(__shfl_up_sync(FULLMASK, a.x, d),
                     __shfl_up_sync(FULLMASK, a.y, d));
  }
  __device__ __forceinline__ static SV shfl(SV a, int src) {
    return make_int2(__shfl_sync(FULLMASK, a.x, src),
                     __shfl_sync(FULLMASK, a.y, src));
  }
  __device__ __forceinline__ static void carry(SV e, V, V, V& ca, V& cb) {
    ca = e.x;
    cb = e.y;
  }
};

struct I16x2 {
  typedef uint32_t V;
  typedef uint32_t M;
  typedef uint32_t SV;
  static constexpr int NPR = 2;
  static constexpr bool I16 = true;
  __device__ __forceinline__ static V pk(int x) {
    return ((uint32_t)x & 0xffffu) * 0x10001u;
  }
  __device__ __forceinline__ static V pair(int lo, int hi) {
    return ((uint32_t)lo & 0xffffu) | ((uint32_t)hi << 16);
  }
  __device__ __forceinline__ static int cut(int x) { return (short)x; }
  // wrapping halfword add (one VIADD.16x2 on sm_90); constants are
  // subtracted by adding their negation, which wraps the same way
  __device__ __forceinline__ static V add(V a, V b) { return __vadd2(a, b); }
  __device__ __forceinline__ static V vmax(V a, V b) { return __vmaxs2(a, b); }
  // masks: 0xffff in a half where the relation holds.  Halves of a ^ b
  // are zero exactly where a == b; __vminu2(x, 1) maps them to 0 / 1 and
  // the product with 0xffff spreads that over the half (no carries).  A
  // signed a > b is max(a, b) != b.  Exact for every pair of int16 values.
  __device__ __forceinline__ static M ne(V a, V b) {
    return __vminu2(a ^ b, 0x00010001u) * 0xffffu;
  }
  __device__ __forceinline__ static M eq(V a, V b) { return ~ne(a, b); }
  __device__ __forceinline__ static M gt(V a, V b) {
    return ne(__vmaxs2(a, b), b);
  }
  __device__ __forceinline__ static M ge(V a, V b) {
    return eq(__vmaxs2(a, b), a);
  }
  __device__ __forceinline__ static M le(V a, V b) { return ge(b, a); }
  __device__ __forceinline__ static V sel(M m, V a, V b) {
    return (a & m) | (b & ~m);
  }
  __device__ __forceinline__ static M mand(M a, M b) { return a & b; }
  __device__ __forceinline__ static M mor(M a, M b) { return a | b; }
  __device__ __forceinline__ static V vor(V a, V b) { return a | b; }
  __device__ __forceinline__ static V bits(M m, int c) { return m & pk(c); }
  __device__ __forceinline__ static M first(bool t0) {
    return t0 ? 0x0000ffffu : 0u;
  }
  __device__ __forceinline__ static int get(V v, int h) {
    return (short)(v >> (16 * h));
  }
  __device__ __forceinline__ static uint32_t byte(V v, int h) {
    return (v >> (16 * h)) & 0xffu;
  }
  // the low half holds slot k of the run, the high half slot k + S/2: the
  // slot after the last (k = S - 1) is the next thread's low half of
  // register 0, the slot after S/2 - 1 is the own high half of register 0
  __device__ __forceinline__ static V up_edge(V x0, V fill, int lane) {
    V n = __shfl_down_sync(FULLMASK, x0, 1);
    if (lane == 31) n = fill;
    return __byte_perm(x0, n, 0x5432);
  }
  __device__ __forceinline__ static V down_edge(V xl, V fill, int lane) {
    V p = __shfl_up_sync(FULLMASK, xl, 1);
    if (lane == 0) p = fill;
    return __byte_perm(p, xl, 0x5432);
  }
  // the thread total of a gap cost is the max of its two halves; both gap
  // costs share one register in the scan.  The carry of the high half is
  // the max of the thread's carry and its low half's total.
  __device__ __forceinline__ static SV total(V ta, V tb) {
    return pair(max((int)(short)ta, (int)(short)(ta >> 16)),
                max((int)(short)tb, (int)(short)(tb >> 16)));
  }
  __device__ __forceinline__ static SV sneg(int neg) { return pk(neg); }
  __device__ __forceinline__ static SV smax(SV a, SV b) {
    return __vmaxs2(a, b);
  }
  __device__ __forceinline__ static SV shfl_up(SV a, int d) {
    return __shfl_up_sync(FULLMASK, a, d);
  }
  __device__ __forceinline__ static SV shfl(SV a, int src) {
    return __shfl_sync(FULLMASK, a, src);
  }
  __device__ __forceinline__ static void carry(SV e, V ta, V tb, V& ca,
                                               V& cb) {
    const int a = (short)e, b = (short)(e >> 16);
    ca = pair(a, max(a, (int)(short)ta));
    cb = pair(b, max(b, (int)(short)tb));
  }
};

// S direction bytes of one thread (slots tS .. tS + S - 1 of a row, packed
// four to a word in slot order) to the row: the widest stores the row
// offset allows, bytes where the run crosses W
template <int S>
__device__ __forceinline__ void store_run(uint8_t* row, const uint32_t* wd,
                                          int tS, int W) {
  uint8_t* p = row + tS;
  if (tS + S <= W) {
    const uintptr_t a = (uintptr_t)p;
    if constexpr (S % 16 == 0) {
      if ((a & 15) == 0) {
#pragma unroll
        for (int j = 0; j < S / 16; ++j)
          ((uint4*)p)[j] = make_uint4(wd[4 * j], wd[4 * j + 1],
                                      wd[4 * j + 2], wd[4 * j + 3]);
        return;
      }
    }
    if constexpr (S % 8 == 0) {
      if ((a & 7) == 0) {
#pragma unroll
        for (int j = 0; j < S / 8; ++j)
          ((uint2*)p)[j] = make_uint2(wd[2 * j], wd[2 * j + 1]);
        return;
      }
    }
    if constexpr (S % 4 == 0) {
      if ((a & 3) == 0) {
#pragma unroll
        for (int j = 0; j < S / 4; ++j) ((uint32_t*)p)[j] = wd[j];
        return;
      }
    }
    if constexpr (S % 2 == 0) {
      if ((a & 1) == 0) {
#pragma unroll
        for (int j = 0; j < S / 2; ++j)
          ((uint16_t*)p)[j] = (uint16_t)(wd[j >> 1] >> (16 * (j & 1)));
        return;
      }
    }
#pragma unroll
    for (int k = 0; k < S; ++k)
      p[k] = (uint8_t)(wd[k >> 2] >> (8 * (k & 3)));
  } else {
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (tS + k < W) p[k] = (uint8_t)(wd[k >> 2] >> (8 * (k & 3)));
  }
}

// the byte of slot k of the run into the packed words
__device__ __forceinline__ void put_byte(uint32_t* wd, int k, uint32_t d) {
  wd[k >> 2] |= d << (8 * (k & 3));
}

// subject code at column x, 255 off the ends
__device__ __forceinline__ int s_at(const uint8_t* sl, int x, int Smax) {
  return (x >= 0 && x < Smax) ? sl[x] : 255;
}

// better end cell: higher value, then lower row, then lower slot
__device__ __forceinline__ bool better(int v, int r, int b, int v0, int r0,
                                       int b0) {
  return v > v0 || (v == v0 && (r < r0 || (r == r0 && b < b0)));
}

// one warp's best (value, row, slot) to every lane of the warp
__device__ __forceinline__ void warp_best(int& v, int& r, int& b) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int v2 = __shfl_xor_sync(FULLMASK, v, d);
    const int r2 = __shfl_xor_sync(FULLMASK, r, d);
    const int b2 = __shfl_xor_sync(FULLMASK, b, d);
    if (better(v2, r2, b2, v, r, b)) {
      v = v2;
      r = r2;
      b = b2;
    }
  }
}

// the results of one lane: free_end from its best cell (nothing beats the
// origin: score 0 at (0, 0)), global from the end cell's H
__device__ __forceinline__ void write_end(int lane, int W, bool free_end,
                                          int best, int bi, int bb, int ei,
                                          int eb, int sc, int* score,
                                          int* end_i, int* end_b,
                                          uint8_t* okv) {
  if (free_end) {
    if (best <= 0) {
      sc = 0;
      ei = 0;
      eb = 0;
    } else {
      sc = best;
      ei = bi;
      eb = bb;
    }
  }
  score[lane] = sc;
  end_i[lane] = ei;
  end_b[lane] = eb;
  okv[lane] = (uint8_t)(eb >= 0 && eb < W && sc > NEG32 / 2);
}

// ---------------------------------------------------------------------------
// The register design: NW warps per lane, S slots per thread.

// lanes of one CTA: CTAs of at least 128 threads
template <int NW>
struct Group {
  static constexpr int LANES = NW >= 4 ? 1 : 4 / NW;
  static constexpr int THREADS = 32 * NW * LANES;
};

// the NW warps of one lane meet at a named barrier of their own (ids 1..)
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <class VT, bool DIAG, bool FREE_END, int S, int NW>
__global__ void __launch_bounds__(Group<NW>::THREADS, 1)
    fill_warp(const uint8_t* __restrict__ q, const uint8_t* __restrict__ s,
              const int* __restrict__ qlen, const int* __restrict__ slen,
              int B, int Qmax, int Smax, int W, int match, int mism, int go1,
              int ge1, int go2, int ge2, int negs, int thrs,
              uint8_t* __restrict__ dirs, int* __restrict__ score,
              int* __restrict__ end_i, int* __restrict__ end_b,
              uint8_t* __restrict__ okv) {
  typedef typename VT::V V;
  typedef typename VT::M M;
  typedef typename VT::SV SV;
  constexpr int NPR = VT::NPR;
  constexpr int NR = S / NPR;        // registers a carried array
  constexpr int NWD = (S + 3) / 4;   // words of direction bytes
  constexpr int LANES = Group<NW>::LANES;
  // edge values of each warp of a lane (NW > 1): of lane 0, the first
  // registers of H, F1, F2 and the subject window; of lane 31, the last of
  // H and of E1, E2; the warp totals of the scan; the free_end bests
  __shared__ V xH0[LANES][NW], xF10[LANES][NW], xF20[LANES][NW],
      xSQ0[LANES][NW], xHl[LANES][NW], xE1l[LANES][NW], xE2l[LANES][NW];
  __shared__ SV xTot[LANES][NW];
  __shared__ int xBest[LANES][NW][3];
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int g = warp / NW, w = warp % NW;
  const int lane = blockIdx.x * LANES + g;
  if (lane >= B) return;             // whole lanes only
  const int tS = (w * 32 + t) * S;
  const int W2 = W / 2;
  const int span = 32 * NW * S;      // slots of the lane's threads
  const uint8_t* ql = q + (size_t)lane * Qmax;
  const uint8_t* sl = s + (size_t)lane * Smax;
  const int Lq = qlen[lane], SL = slen[lane];
  const int L = min(Lq, Qmax);
  uint8_t* dl = dirs + (size_t)lane * (Qmax + 1) * W;
  const V NEG = VT::pk(negs), THR = VT::pk(thrs);
  const V ONE = VT::pk(1), NGE1 = VT::pk(-ge1), NGE2 = VT::pk(-ge2);
  const V NGOE1 = VT::pk(-(go1 + ge1)), NGOE2 = VT::pk(-(go2 + ge2));
  const V MATCH = VT::pk(match), MISM = VT::pk(-mism);
  // band slots of register 0 and their b * ge and -(go + b * ge);
  // register r adds r, ge, -ge
  const V B0 = VT::pair(tS, tS + NR);
  const V BG1 = VT::pair(tS * ge1, (tS + NR) * ge1);
  const V BG2 = VT::pair(tS * ge2, (tS + NR) * ge2);
  const V MG1 = VT::pair(-(go1 + tS * ge1), -(go1 + (tS + NR) * ge1));
  const V MG2 = VT::pair(-(go2 + tS * ge2), -(go2 + (tS + NR) * ge2));
  const int bar = 1 + g, nbar = 32 * NW;

  V H[NR], F1[NR], F2[NR], DG[NR], FL[NR], SQ[NR];
  uint32_t wd[NWD];

  // row 0: boundary H and the dir0 byte; F = NEG; the subject window of
  // row 1
#pragma unroll
  for (int k = 0; k < NWD; ++k) wd[k] = 0;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    int hv[2] = {0, 0}, sv[2] = {255, 255};
#pragma unroll
    for (int h = 0; h < NPR; ++h) {
      const int b = tS + r + h * NR;
      const int js = DIAG ? b - W2 : b;
      const bool in0 = b < W && js >= 0 && js <= SL;
      int e1 = js > 0 ? -go1 - js * ge1 : negs;
      int e2 = js > 0 ? -go2 - js * ge2 : negs;
      int hh = js == 0 ? 0 : max(e1, e2);
      if (!in0) {
        hh = negs;
        e1 = negs;
        e2 = negs;
      }
      hv[h] = VT::cut(hh);
      put_byte(wd, r + h * NR,
               (uint32_t)((VT::cut(e1) >= VT::cut(e2) ? 1 : 2) | 0x18));
      sv[h] = s_at(sl, DIAG ? b - W2 : b - 1, Smax);
    }
    H[r] = VT::pair(hv[0], hv[1]);
    F1[r] = NEG;
    F2[r] = NEG;
    SQ[r] = VT::pair(sv[0], sv[1]);
  }
  store_run<S>(dl, wd, tS, W);
  if constexpr (NW > 1) {
    if (t == 0) {
      xH0[g][w] = H[0];
      xF10[g][w] = NEG;
      xF20[g][w] = NEG;
    }
    if (t == 31) xHl[g][w] = H[NR - 1];
    group_sync(bar, nbar);
  }

  const bool ragged = W < span;
  const V WM1 = VT::pk(W - 1);
  V BV = NEG, BR = VT::pk(0), BB = VT::pk(0);
  int qn = L >= 1 ? ql[0] : 0;
  // the subject byte entering the window at slot span - 1 of row 2
  int snext = (DIAG && w == NW - 1 && t == 31)
                  ? s_at(sl, 2 - W2 + span - 2, Smax) : 255;
  for (int i = 1; i <= L; ++i) {
    const V QC = VT::pk(qn);
    if (i < L) qn = ql[i];
    // js >= 0 <=> b >= lo; js <= SL and b < W <=> b <= hi
    const int lo = DIAG ? W2 - i : 0;
    const V LO = VT::pk(lo);
    const V HI = VT::pk(min(DIAG ? SL + W2 - i : SL, W - 1));

    // the neighbours across the edges of the threads' runs
    V HuE = NEG, F1uE = NEG, F2uE = NEG, Hd = NEG;
    if (DIAG) {
      V nH = NEG, nF1 = NEG, nF2 = NEG, nSQ = VT::pk(snext);
      if constexpr (NW > 1) {
        if (w + 1 < NW) {
          nH = xH0[g][w + 1];
          nF1 = xF10[g][w + 1];
          nF2 = xF20[g][w + 1];
          nSQ = xSQ0[g][w + 1];
        }
      }
      if (i > 1) {
        // the window moves one slot a row
        const V e = VT::up_edge(SQ[0], nSQ, t);
#pragma unroll
        for (int r = 0; r + 1 < NR; ++r) SQ[r] = SQ[r + 1];
        SQ[NR - 1] = e;
        if (w == NW - 1 && t == 31 && i < L)
          snext = s_at(sl, i + 1 - W2 + span - 2, Smax);
      }
      HuE = VT::up_edge(H[0], nH, t);
      F1uE = VT::up_edge(F1[0], nF1, t);
      F2uE = VT::up_edge(F2[0], nF2, t);
    } else {
      V pH = NEG;
      if constexpr (NW > 1) {
        if (w > 0) pH = xHl[g][w - 1];
      }
      Hd = VT::down_edge(H[NR - 1], pH, t);
    }

    // phase 1: diagonal / vertical sources, H before E, the F flags, the
    // thread totals of the scan bases
    V bv = B0, o1 = BG1, o2 = BG2;
    V tot1 = NEG, tot2 = NEG;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      V Hu, F1u, F2u;
      if (DIAG) {
        Hd = H[r];
        Hu = r + 1 < NR ? H[r + 1] : HuE;
        F1u = r + 1 < NR ? F1[r + 1] : F1uE;
        F2u = r + 1 < NR ? F2[r + 1] : F2uE;
      } else {
        Hu = H[r];
        F1u = F1[r];
        F2u = F2[r];
      }
      const V sub = VT::sel(VT::eq(SQ[r], QC), MATCH, MISM);
      const V dg = VT::sel(VT::mand(VT::gt(bv, LO), VT::gt(Hd, THR)),
                           VT::add(Hd, sub), NEG);
      const V f1e = VT::add(F1u, NGE1), f2e = VT::add(F2u, NGE2);
      V f1n = VT::vmax(VT::add(Hu, NGOE1), f1e);
      V f2n = VT::vmax(VT::add(Hu, NGOE2), f2e);
      const V hpre = VT::vmax(dg, VT::vmax(f1n, f2n));
      FL[r] = VT::vor(VT::bits(VT::eq(f1n, f1e), 0x20),
                      VT::bits(VT::eq(f2n, f2e), 0x40));
      if (DIAG && ragged) {
        // slots past W stay NEG: slot W - 1 reads them as b + 1
        const M v = VT::le(bv, WM1);
        f1n = VT::sel(v, f1n, NEG);
        f2n = VT::sel(v, f2n, NEG);
      }
      const M okp = VT::gt(hpre, THR);
      tot1 = VT::vmax(tot1, VT::sel(okp, VT::add(hpre, o1), NEG));
      tot2 = VT::vmax(tot2, VT::sel(okp, VT::add(hpre, o2), NEG));
      if (!DIAG) Hd = Hu;
      H[r] = hpre;
      DG[r] = dg;
      F1[r] = f1n;
      F2[r] = f2n;
      bv = VT::add(bv, ONE);
      o1 = VT::add(o1, VT::pk(ge1));
      o2 = VT::add(o2, VT::pk(ge2));
    }

    // the scan: inclusive over the warp, then over the lane's warps
    V C1, C2;
    {
      SV x = VT::total(tot1, tot2);
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const SV y = VT::shfl_up(x, d);
        if (t >= d) x = VT::smax(x, y);
      }
      SV e = VT::shfl_up(x, 1);
      if (t == 0) e = VT::sneg(negs);
      if constexpr (NW > 1) {
        if (t == 31) xTot[g][w] = x;
        group_sync(bar, nbar);
        if constexpr (NW <= 4) {
          for (int v = 0; v < w; ++v) e = VT::smax(e, xTot[g][v]);
        } else {
          // a shuffle scan of the warp totals
          SV y = t < NW ? xTot[g][t] : VT::sneg(negs);
#pragma unroll
          for (int d = 1; d < NW; d <<= 1) {
            const SV z = VT::shfl_up(y, d);
            if (t >= d) y = VT::smax(y, z);
          }
          y = VT::shfl(y, (w + 31) & 31);
          if (w > 0) e = VT::smax(e, y);
        }
      }
      VT::carry(e, tot1, tot2, C1, C2);
    }

    // phase 2: E, H, the source and extension flags
#pragma unroll
    for (int k = 0; k < NWD; ++k) wd[k] = 0;
    V E1p = NEG, E2p = NEG, E1f = NEG, E2f = NEG, d0 = 0;
    const V IROW = VT::pk(i);
    bv = B0;
    o1 = BG1;
    o2 = BG2;
    V m1 = MG1, m2 = MG2;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const V hpre = H[r];
      const V E1 = VT::sel(VT::gt(C1, THR), VT::add(C1, m1), NEG);
      const V E2 = VT::sel(VT::gt(C2, THR), VT::add(C2, m2), NEG);
      const M okp = VT::gt(hpre, THR);
      C1 = VT::vmax(C1, VT::sel(okp, VT::add(hpre, o1), NEG));
      C2 = VT::vmax(C2, VT::sel(okp, VT::add(hpre, o2), NEG));
      V hn = VT::vmax(hpre, VT::vmax(E1, E2));
      hn = VT::sel(VT::mand(VT::ge(bv, LO), VT::le(bv, HI)), hn, NEG);
      const V src = VT::sel(
          VT::eq(hn, DG[r]), VT::pk(0),
          VT::sel(VT::eq(hn, E1), VT::pk(1),
                  VT::sel(VT::eq(hn, E2), VT::pk(2),
                          VT::sel(VT::eq(hn, F1[r]), VT::pk(3),
                                  VT::pk(4)))));
      V d = VT::vor(src, FL[r]);
      if (r == 0) {
        E1f = E1;
        E2f = E2;
        d0 = d;
      } else {
        d = VT::vor(d, VT::vor(VT::bits(VT::eq(E1, VT::add(E1p, NGE1)), 8),
                               VT::bits(VT::eq(E2, VT::add(E2p, NGE2)), 16)));
#pragma unroll
        for (int h = 0; h < NPR; ++h)
          put_byte(wd, r + h * NR, VT::byte(d, h));
      }
      E1p = E1;
      E2p = E2;
      H[r] = hn;
      if (FREE_END) {
        const M m = VT::gt(hn, BV);
        BV = VT::sel(m, hn, BV);
        BR = VT::sel(m, IROW, BR);
        BB = VT::sel(m, bv, BB);
      }
      bv = VT::add(bv, ONE);
      o1 = VT::add(o1, VT::pk(ge1));
      o2 = VT::add(o2, VT::pk(ge2));
      m1 = VT::add(m1, NGE1);
      m2 = VT::add(m2, NGE2);
    }
    // register 0's extension flags: E of the slots just before it
    V pE1 = NEG, pE2 = NEG;
    if constexpr (NW > 1) {
      // this row's edges for the neighbouring warps (the next row's
      // neighbours and this row's E before each warp's first slot)
      if (t == 0) {
        xH0[g][w] = H[0];
        xF10[g][w] = F1[0];
        xF20[g][w] = F2[0];
        xSQ0[g][w] = SQ[0];
      }
      if (t == 31) {
        xHl[g][w] = H[NR - 1];
        xE1l[g][w] = E1p;
        xE2l[g][w] = E2p;
      }
      group_sync(bar, nbar);
      if (w > 0) {
        pE1 = xE1l[g][w - 1];
        pE2 = xE2l[g][w - 1];
      }
    }
    {
      const V p1 = VT::down_edge(E1p, pE1, t);
      const V p2 = VT::down_edge(E2p, pE2, t);
      const M f = VT::first(w == 0 && t == 0);
      d0 = VT::vor(d0, VT::vor(
          VT::bits(VT::mor(VT::eq(E1f, VT::add(p1, NGE1)), f), 8),
          VT::bits(VT::mor(VT::eq(E2f, VT::add(p2, NGE2)), f), 16)));
#pragma unroll
      for (int h = 0; h < NPR; ++h) put_byte(wd, h * NR, VT::byte(d0, h));
    }
    store_run<S>(dl + (size_t)i * W, wd, tS, W);
  }

  const int ei = Lq, eb = SL - (DIAG ? Lq - W2 : 0);
  if (FREE_END) {
    int best = VT::get(BV, 0), bi = VT::get(BR, 0), bb = VT::get(BB, 0);
    if (NPR == 2 && better(VT::get(BV, 1), VT::get(BR, 1), VT::get(BB, 1),
                           best, bi, bb)) {
      best = VT::get(BV, 1);
      bi = VT::get(BR, 1);
      bb = VT::get(BB, 1);
    }
    warp_best(best, bi, bb);
    if constexpr (NW > 1) {
      if (t == 0) {
        xBest[g][w][0] = best;
        xBest[g][w][1] = bi;
        xBest[g][w][2] = bb;
      }
      group_sync(bar, nbar);
      if (w == 0 && t == 0)
        for (int v = 1; v < NW; ++v)
          if (better(xBest[g][v][0], xBest[g][v][1], xBest[g][v][2], best,
                     bi, bb)) {
            best = xBest[g][v][0];
            bi = xBest[g][v][1];
            bb = xBest[g][v][2];
          }
    }
    if (w == 0 && t == 0)
      write_end(lane, W, true, best, bi, bb, ei, eb, 0, score, end_i, end_b,
                okv);
  } else {
    // H of the end slot: its owner's warp reads it and writes the results
    const int c = min(max(eb, 0), W - 1);
    if (w == c / (32 * S)) {
      const int k = c % S;
      V mine = H[0];
#pragma unroll
      for (int r = 1; r < NR; ++r)
        if (r == k % NR) mine = H[r];
      const V got = __shfl_sync(FULLMASK, mine, (c / S) & 31);
      int sc = VT::get(got, k / NR);
      // int16 state: masked values become the int32 sentinel
      if (VT::I16 && sc <= thrs) sc = NEG32;
      if (t == 0)
        write_end(lane, W, false, 0, 0, 0, ei, eb, sc, score, end_i, end_b,
                  okv);
    }
  }
}

// ---------------------------------------------------------------------------
// The wide design: a lane's band over C CTAs of one thread-block cluster (C =
// 1: one CTA, no cluster), row state in shared memory (or a global scratch).

// halves of a barrier of every thread of the cluster: arrive publishes this
// thread's stores (to its own CTA's shared memory and to the other CTAs'),
// wait returns once every thread of the cluster has arrived
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the same shared variable in the cluster's CTA of rank r
template <class X>
__device__ __forceinline__ X* in_rank(X* p, int r) {
  return cg::this_cluster().map_shared_rank(p, r);
}

// largest cluster of the wide design
#define MAX_SPLIT 16

// threads of one of the C CTAs of a lane: for C = 1, 1,024 from W = 1,024
// on, else W in whole warps; for C > 1, as few threads of whole warps as
// give every CTA the same runs of ceil(W / (C * 1,024)) slots
__host__ __device__ inline int block_threads(int W, int C) {
  if (C == 1) return W >= 1024 ? 1024 : ((W + 31) / 32) * 32;
  const int spt = (W + C * 1024 - 1) / (C * 1024);
  return ((W + C * spt - 1) / (C * spt) + 31) / 32 * 32;
}

// slots of each row-state array of one CTA: its threads' runs of
// ceil(W / (C * threads)) slots
__host__ __device__ inline size_t block_slots(int W, int C) {
  const int nt = block_threads(W, C);
  return (size_t)((W + C * nt - 1) / (C * nt)) * nt;
}

// bytes of row state per CTA: H, F1, F2, DG of the state type and the F
// flag bytes, rounded up to a multiple of 16
__host__ __device__ inline size_t block_state_bytes(int W, int C, int esz) {
  const size_t sw = block_slots(W, C);
  return ((4 * sw * esz + sw + 15) / 16) * 16;
}

// T is the state type (int or short); every value is cut to T where it is
// produced ((T)(...)), so T = short computes what int16 tensors compute.
// CL: launched in clusters of C CTAs a lane (C > 1), cluster rank k owning
// slots [k * nt * spt, (k + 1) * nt * spt); !CL: one CTA a lane, C = 1.
template <typename T, bool DIAG, bool FREE_END, bool CL>
__global__ void __launch_bounds__(1024)
    fill_block(const uint8_t* __restrict__ q, const uint8_t* __restrict__ s,
               const int* __restrict__ qlen, const int* __restrict__ slen,
               int Qmax, int Smax, int W, int match, int mism, int go1,
               int ge1, int go2, int ge2, const int NEG, const int THR,
               int C, uint8_t* gscratch, uint8_t* __restrict__ dirs,
               int* score, int* end_i, int* end_b, uint8_t* okv) {
  extern __shared__ int4 smem[];
  // edge values of each thread's run: H, F1, F2 of its first slot (diag)
  // or H of its last (full) for the next row; E1, E2 of its last slot
  __shared__ int xH[1024], xF1[1024], xF2[1024], xE1[1024], xE2[1024];
  __shared__ int wt1[32], wt2[32], rb[3][32];
  // CL, written by the neighbour CTAs: cedge the edge values of the CTA's
  // runs' outer neighbours (H, F1, F2 of the next CTA's first slot in diag
  // mode, H of the previous CTA's last slot in full mode; E1, E2 of the
  // previous CTA's last slot), ctot the scan totals of the lower CTAs of
  // the row, cbest (rank 0) every CTA's best cell
  __shared__ int cedge[5];
  __shared__ int2 ctot[MAX_SPLIT];
  __shared__ int cbest[MAX_SPLIT][3];
  if (!CL) C = 1;
  const int rank = CL ? (int)cg::this_cluster().block_rank() : 0;
  const int lane = blockIdx.x / C;
  uint8_t* base =
      gscratch ? gscratch + ((size_t)lane * C + rank) *
                                block_state_bytes(W, C, sizeof(T))
               : (uint8_t*)smem;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int wl = tid & 31, wid = tid >> 5, nw = nt >> 5;
  const int spt = (W + C * nt - 1) / (C * nt);
  const int b0 = min((rank * nt + tid) * spt, W), b1 = min(b0 + spt, W);
  const bool own = b1 > b0;
  const size_t sw = (size_t)spt * nt;
  T* H = (T*)base;
  T* F1 = H + sw;
  T* F2 = F1 + sw;
  T* DG = F2 + sw;
  uint8_t* FL = (uint8_t*)(DG + sw);
  // the runs interleaved: slot b0 + k of this thread's run lies at
  // k * nt + tid, so that the threads of a warp touch consecutive elements
  // (no bank conflicts in shared memory, whole lines of the scratch)
  auto at = [&](int b) { return (b - b0) * nt + tid; };
  const int W2 = W / 2;
  const uint8_t* ql = q + (size_t)lane * Qmax;
  const uint8_t* sl = s + (size_t)lane * Smax;
  const int Lq = qlen[lane], SL = slen[lane];
  const int L = min(Lq, Qmax);
  uint8_t* dl = dirs + (size_t)lane * (Qmax + 1) * W;
  // every CTA of the cluster runs before any reaches another's memory
  if constexpr (CL) cluster_arrive();

  // row 0
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
    H[at(b)] = (T)h;
    F1[at(b)] = (T)NEG;
    F2[at(b)] = (T)NEG;
    dl[b] = (uint8_t)(((T)e1 >= (T)e2 ? 1 : 2) | 0x18);
  }
  xH[tid] = own ? (int)H[at(DIAG ? b0 : b1 - 1)] : NEG;
  xF1[tid] = NEG;
  xF2[tid] = NEG;
  if constexpr (CL) {
    cluster_wait();
    if (DIAG && tid == 0 && rank > 0) {
      int* e = in_rank(cedge, rank - 1);
      e[0] = xH[0];
      e[1] = NEG;
      e[2] = NEG;
    }
    if (!DIAG && tid == nt - 1 && rank + 1 < C)
      in_rank(cedge, rank + 1)[0] = xH[tid];
    cluster_arrive();
  } else {
    __syncthreads();
  }

  int best = NEG, bi = 0x7fffffff, bb = 0;
  // CL: the byte of the run's first slot of the row before, written once
  // the barrier after that row has brought its left neighbour's E
  int pe1f = NEG, pe2f = NEG, pd0 = 0;
  uint8_t* prow = dl;
  auto first_byte = [&](uint8_t* row, int d0, int e1f, int e2f) {
    if (own) {
      int p1, p2;
      if (tid > 0) {
        p1 = xE1[tid - 1];
        p2 = xE2[tid - 1];
      } else {
        p1 = cedge[3];
        p2 = cedge[4];
      }
      const bool x1 = b0 == 0 || e1f == (T)(p1 - ge1);
      const bool x2 = b0 == 0 || e2f == (T)(p2 - ge2);
      row[b0] = (uint8_t)(d0 | (x1 << 3) | (x2 << 4));
    }
  };
  for (int i = 1; i <= L; ++i) {
    const int qc = ql[i - 1];
    // phase 1: sources, H before E, F flags; thread totals of the bases
    int tmax1 = NEG, tmax2 = NEG;
    auto phase1 = [&](int b, int Hd, int Hu, int F1u, int F2u) {
      const int x = at(b);
      const int js = DIAG ? i - W2 + b : b;
      const int si = js - 1;
      const int sj = (si >= 0 && si < Smax) ? sl[si] : 255;
      const int sub = sj == qc ? match : -mism;
      const int dg = (js >= 1 && Hd > THR) ? (T)(Hd + sub) : NEG;
      const int f1e = (T)(F1u - ge1), f2e = (T)(F2u - ge2);
      const int f1n = max((int)(T)(Hu - (go1 + ge1)), f1e);
      const int f2n = max((int)(T)(Hu - (go2 + ge2)), f2e);
      const int hpre = max(dg, max(f1n, f2n));
      if (hpre > THR) {
        tmax1 = max(tmax1, (int)(T)(hpre + b * ge1));
        tmax2 = max(tmax2, (int)(T)(hpre + b * ge2));
      }
      H[x] = (T)hpre;
      DG[x] = (T)dg;
      F1[x] = (T)f1n;
      F2[x] = (T)f2n;
      FL[x] = (uint8_t)(((f1n == f1e) << 5) | ((f2n == f2e) << 6));
    };
    if constexpr (CL) {
      // the slots that need no neighbour's edge while the barrier after
      // the row before completes, then the edge slot (diag: the run's last,
      // full: its first)
      if (DIAG) {
        for (int b = b0; b + 1 < b1; ++b) {
          const int x = at(b);
          phase1(b, H[x], H[x + nt], F1[x + nt], F2[x + nt]);
        }
      } else if (own) {
        int prevH = H[at(b0)];
        for (int b = b0 + 1; b < b1; ++b) {
          const int Hu = H[at(b)];
          phase1(b, prevH, Hu, F1[at(b)], F2[at(b)]);
          prevH = Hu;
        }
      }
      cluster_wait();
      if (i > 1) first_byte(prow, pd0, pe1f, pe2f);
      if (own) {
        if (DIAG) {
          int nbH = NEG, nbF1 = NEG, nbF2 = NEG;
          if (tid + 1 < nt) {
            nbH = xH[tid + 1];
            nbF1 = xF1[tid + 1];
            nbF2 = xF2[tid + 1];
          } else if (rank + 1 < C) {
            nbH = cedge[0];
            nbF1 = cedge[1];
            nbF2 = cedge[2];
          }
          const int x = at(b1 - 1);
          phase1(b1 - 1, H[x], nbH, nbF1, nbF2);
        } else {
          const int nbH = tid > 0 ? xH[tid - 1] : rank > 0 ? cedge[0] : NEG;
          const int x = at(b0);
          phase1(b0, nbH, H[x], F1[x], F2[x]);
        }
      }
    } else {
      int nbH = NEG, nbF1 = NEG, nbF2 = NEG;
      if (DIAG) {
        if (tid + 1 < nt) {
          nbH = xH[tid + 1];
          nbF1 = xF1[tid + 1];
          nbF2 = xF2[tid + 1];
        }
      } else if (tid > 0) {
        nbH = xH[tid - 1];
      }
      int prevH = nbH;  // full mode: old H[b - 1]
      for (int b = b0; b < b1; ++b) {
        const int x = at(b);
        if (DIAG) {
          const bool in = b + 1 < b1;
          phase1(b, H[x], in ? (int)H[x + nt] : nbH,
                 in ? (int)F1[x + nt] : nbF1, in ? (int)F2[x + nt] : nbF2);
        } else {
          const int Hu = H[x];
          phase1(b, prevH, Hu, F1[x], F2[x]);
          prevH = Hu;
        }
      }
    }

    // the scan: inclusive within the warp, warp totals through shared
    // memory (barrier 1), a shuffle scan of them in every warp; CL: the
    // CTA's total to every higher rank (a cluster barrier), and the carry
    // of the lower ranks from theirs
    int ia = tmax1, ib = tmax2;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int ya = __shfl_up_sync(FULLMASK, ia, d);
      const int yb = __shfl_up_sync(FULLMASK, ib, d);
      if (wl >= d) {
        ia = max(ia, ya);
        ib = max(ib, yb);
      }
    }
    int c1 = __shfl_up_sync(FULLMASK, ia, 1);
    int c2 = __shfl_up_sync(FULLMASK, ib, 1);
    if (wl == 0) {
      c1 = NEG;
      c2 = NEG;
    }
    if (wl == 31) {
      wt1[wid] = ia;
      wt2[wid] = ib;
    }
    __syncthreads();
    int ga = wl < nw ? wt1[wl] : NEG, gb = wl < nw ? wt2[wl] : NEG;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int ya = __shfl_up_sync(FULLMASK, ga, d);
      const int yb = __shfl_up_sync(FULLMASK, gb, d);
      if (wl >= d) {
        ga = max(ga, ya);
        gb = max(gb, yb);
      }
    }
    if constexpr (CL) {
      // lane r of warp 0 sends the CTA's total to rank r
      const int ta = __shfl_sync(FULLMASK, ga, 31);
      const int tb = __shfl_sync(FULLMASK, gb, 31);
      if (wid == 0 && wl > rank && wl < C)
        *in_rank(&ctot[rank], wl) = make_int2(ta, tb);
      cluster_arrive();
    }
    ga = __shfl_sync(FULLMASK, ga, (wid + 31) & 31);
    gb = __shfl_sync(FULLMASK, gb, (wid + 31) & 31);
    if (wid > 0) {
      c1 = max(c1, ga);
      c2 = max(c2, gb);
    }
    if constexpr (CL) {
      cluster_wait();
      int2 r = wl < rank ? ctot[wl] : make_int2(NEG, NEG);
      for (int d = 1; d < C; d <<= 1) {
        r.x = max(r.x, __shfl_xor_sync(FULLMASK, r.x, d));
        r.y = max(r.y, __shfl_xor_sync(FULLMASK, r.y, d));
      }
      c1 = max(c1, __shfl_sync(FULLMASK, r.x, 0));
      c2 = max(c2, __shfl_sync(FULLMASK, r.y, 0));
    }

    // phase 2: E from the running prefix max, H, source and flags; the
    // byte of the run's first slot waits for its left neighbour's E
    uint8_t* drow = dl + (size_t)i * W;
    int e1p = NEG, e2p = NEG, e1f = NEG, e2f = NEG, d0 = 0;
    for (int b = b0; b < b1; ++b) {
      const int x = at(b);
      const int js = DIAG ? i - W2 + b : b;
      const int hpre = H[x];
      const int e1 = c1 > THR ? (T)((T)(c1 - go1) - b * ge1) : NEG;
      const int e2 = c2 > THR ? (T)((T)(c2 - go2) - b * ge2) : NEG;
      if (hpre > THR) {
        c1 = max(c1, (int)(T)(hpre + b * ge1));
        c2 = max(c2, (int)(T)(hpre + b * ge2));
      }
      int hn = max(hpre, max(e1, e2));
      if (!(js >= 0 && js <= SL)) hn = NEG;
      const int dg = DG[x];
      const int src = hn == dg ? 0
                      : hn == e1 ? 1
                      : hn == e2 ? 2
                      : hn == F1[x] ? 3
                                    : 4;
      const int d = src | FL[x];
      if (b == b0) {
        e1f = e1;
        e2f = e2;
        d0 = d;
      } else {
        drow[b] = (uint8_t)(d | ((e1 == (T)(e1p - ge1)) << 3) |
                            ((e2 == (T)(e2p - ge2)) << 4));
      }
      e1p = e1;
      e2p = e2;
      H[x] = (T)hn;
      if (FREE_END && hn > best) {
        best = hn;
        bi = i;
        bb = b;
      }
    }
    xH[tid] = own ? (int)H[at(DIAG ? b0 : b1 - 1)] : NEG;
    if (DIAG) {
      xF1[tid] = own ? (int)F1[at(b0)] : NEG;
      xF2[tid] = own ? (int)F2[at(b0)] : NEG;
    }
    xE1[tid] = e1p;
    xE2[tid] = e2p;
    if constexpr (CL) {
      // the CTA's outer edges to its neighbours (barrier 2, waited for in
      // the next row after its inner slots)
      if (DIAG && tid == 0 && rank > 0) {
        int* e = in_rank(cedge, rank - 1);
        e[0] = xH[0];
        e[1] = xF1[0];
        e[2] = xF2[0];
      }
      if (tid == nt - 1 && rank + 1 < C) {
        int* e = in_rank(cedge, rank + 1);
        if (!DIAG) e[0] = xH[tid];
        e[3] = e1p;
        e[4] = e2p;
      }
      cluster_arrive();
      pd0 = d0;
      pe1f = e1f;
      pe2f = e2f;
      prow = drow;
    } else {
      __syncthreads();
      first_byte(drow, d0, e1f, e2f);
    }
  }
  if constexpr (CL) {
    cluster_wait();
    if (L >= 1) first_byte(prow, pd0, pe1f, pe2f);
  }

  int sc = 0;
  const int ei = Lq, eb = SL - (DIAG ? Lq - W2 : 0);
  // the thread that writes the lane's results: thread 0 of rank 0 for
  // free_end, else thread 0 of the rank that owns the end slot
  bool writer = tid == 0 && rank == 0;
  if (FREE_END) {
    warp_best(best, bi, bb);
    if (wl == 0) {
      rb[0][wid] = best;
      rb[1][wid] = bi;
      rb[2][wid] = bb;
    }
    __syncthreads();
    if (tid == 0)
      for (int w = 1; w < nw; ++w)
        if (better(rb[0][w], rb[1][w], rb[2][w], best, bi, bb)) {
          best = rb[0][w];
          bi = rb[1][w];
          bb = rb[2][w];
        }
    if constexpr (CL) {
      // every rank's best to rank 0, reduced there in the same order
      if (tid == 0) {
        int* p = in_rank(&cbest[rank][0], 0);
        p[0] = best;
        p[1] = bi;
        p[2] = bb;
      }
      cluster_arrive();
      cluster_wait();
      if (writer)
        for (int k = 1; k < C; ++k)
          if (better(cbest[k][0], cbest[k][1], cbest[k][2], best, bi, bb)) {
            best = cbest[k][0];
            bi = cbest[k][1];
            bb = cbest[k][2];
          }
    }
  } else {
    // slot c is slot c % spt of thread (c / spt) % nt's run in rank
    // c / (spt * nt)
    const int c = min(max(eb, 0), W - 1);
    writer = tid == 0 && rank == c / (spt * nt);
    if (writer) {
      sc = H[(c % spt) * nt + (c / spt) % nt];
      if (sizeof(T) == 2 && sc <= THR) sc = NEG32;
    }
  }
  if (writer)
    write_end(lane, W, FREE_END, best, bi, bb, ei, eb, sc, score, end_i,
              end_b, okv);
}

// ---------------------------------------------------------------------------
// Launch.

struct Args {
  const uint8_t *q, *s;
  const int *qlen, *slen;
  int B, Qmax, Smax, W, split, match, mism, go1, ge1, go2, ge2, neg, thr;
  uint8_t *scratch, *dirs;
  int *score, *end_i, *end_b;
  uint8_t* ok;
  cudaStream_t st;
};

template <class VT, bool D, bool F, int S, int NW>
static int launch_warp(const Args& a) {
  typedef Group<NW> G;
  fill_warp<VT, D, F, S, NW>
      <<<(a.B + G::LANES - 1) / G::LANES, G::THREADS, 0, a.st>>>(
          a.q, a.s, a.qlen, a.slen, a.B, a.Qmax, a.Smax, a.W, a.match,
          a.mism, a.go1, a.ge1, a.go2, a.ge2, a.neg, a.thr, a.dirs, a.score,
          a.end_i, a.end_b, a.ok);
  return (int)cudaGetLastError();
}

// (S, NW) from W, chosen by timing the buckets of `run` in turns: one warp
// a lane up to W = 128 (the 1,024-lane buckets fill the card with warps),
// then 2 to 8 warps of 4 or 8 slots
template <class VT, bool D, bool F>
static int dispatch_warp(const Args& a) {
  if (a.W <= 64) return launch_warp<VT, D, F, 2, 1>(a);
  if (a.W <= 128) return launch_warp<VT, D, F, 4, 1>(a);
  if (a.W <= 256) return launch_warp<VT, D, F, 4, 2>(a);
  if (a.W <= 512) return launch_warp<VT, D, F, 8, 2>(a);
  if (a.W <= 1024) return launch_warp<VT, D, F, 4, 8>(a);
  return launch_warp<VT, D, F, 8, 8>(a);
}

// a cluster size the wide design runs: 1, or a power of two up to
// MAX_SPLIT (above 8 where the card allows clusters of that size)
static bool split_ok(int C) {
  return C >= 1 && C <= MAX_SPLIT && (C & (C - 1)) == 0;
}

// a launch of `blocks` CTAs of nt threads, in clusters of C CTAs where C > 1
// (attr holds the cluster's dimension)
static cudaLaunchConfig_t block_config(int blocks, int nt, size_t smem,
                                       cudaStream_t st, int C,
                                       cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  return cfg;
}

// the kernel's caps are shared by every host thread: each is set and the
// launch queued under one lock, so that another thread's smaller launch
// cannot lower the shared-memory cap in between
static std::mutex cap_mu;

template <typename T, bool D, bool F>
static int launch_block(const Args& a) {
  const int C = a.split;
  const int nt = block_threads(a.W, C);
  const size_t smem = a.scratch ? 0 : block_state_bytes(a.W, C, sizeof(T));
  auto k = C > 1 ? fill_block<T, D, F, true> : fill_block<T, D, F, false>;
  // with the static edge buffers this passes the 48 KB default, so the
  // kernel's cap is raised to this launch's size; clusters of more than 8
  // CTAs need the kernel's consent
  std::unique_lock<std::mutex> lk(cap_mu, std::defer_lock);
  cudaError_t e = cudaSuccess;
  if (smem > 16 * 1024 || C > 8) lk.lock();
  if (smem > 16 * 1024)
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(
        k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      block_config(a.B * C, nt, smem, a.st, C, &attr);
  e = cudaLaunchKernelEx(&cfg, k, a.q, a.s, a.qlen, a.slen, a.Qmax, a.Smax,
                         a.W, a.match, a.mism, a.go1, a.ge1, a.go2, a.ge2,
                         a.neg, a.thr, C, a.scratch, a.dirs, a.score,
                         a.end_i, a.end_b, a.ok);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, class VT, bool D, bool F>
static int dispatch(const Args& a) {
  if (a.W <= REG_W) return dispatch_warp<VT, D, F>(a);
  return launch_block<T, D, F>(a);
}

template <typename T, class VT>
static int dispatch_mode(int diag, int free_end, const Args& a) {
  if (diag)
    return free_end ? dispatch<T, VT, true, true>(a)
                    : dispatch<T, VT, true, false>(a);
  return free_end ? dispatch<T, VT, false, true>(a)
                  : dispatch<T, VT, false, false>(a);
}

extern "C" {

// Row state of one of the `split` CTAs of a lane in bytes, in shared memory
// or (above the caller's cap) in a global scratch, for a state element of
// esz bytes (4: int, 2: short); 0 where the register design runs (W up to
// REG_W), which keeps its state in registers.
long long lesv_fill_state_bytes(int W, int split, int esz) {
  if (W <= REG_W) return 0;
  return (long long)block_state_bytes(W, split, esz);
}

// Clusters of the wide design that the current device holds at once,
// as cudaOccupancyMaxActiveClusters reports them for CTAs of 1,024
// threads: out[k] for clusters of 2 << k CTAs (2, 4, 8, 16), 0 where the
// device refuses the size.  Returns the first CUDA error of the queries
// that are not a refusal of size 16.
int lesv_fill_cluster_limits(int* out) {
  auto k = fill_block<int, true, false, true>;
  std::lock_guard<std::mutex> lk(cap_mu);
  for (int j = 0; j < 4; ++j) {
    const int C = 2 << j;
    out[j] = 0;
    if (C > 8 && cudaFuncSetAttribute(
                     k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
                     cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = block_config(C, 1024, 0, 0, C, &attr);
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, (void*)k, &cfg);
    if (e != cudaSuccess) {
      cudaGetLastError();
      if (C > 8) continue;
      return (int)e;
    }
    out[j] = n;
  }
  return 0;
}

// i16 != 0 runs the short-state variant.  split: the CTAs of one cluster
// that fill one lane of the wide design (1: one CTA a lane, no cluster; a
// power of two up to MAX_SPLIT; more than 1 only above REG_W, else
// cudaErrorInvalidValue).  scratch == NULL: row state of the wide design in
// dynamic shared memory; otherwise a (B * split, lesv_fill_state_bytes)
// byte buffer in device memory.
int lesv_fill(const void* q, const void* s, const void* qlen,
              const void* slen, int B, int Qmax, int Smax, int W, int diag,
              int free_end, int i16, int split, int match, int mism, int go1,
              int ge1, int go2, int ge2, void* scratch, void* dirs,
              void* score, void* end_i, void* end_b, void* ok, void* stream) {
  if (!split_ok(split) || (split > 1 && W <= REG_W))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  Args a{(const uint8_t*)q, (const uint8_t*)s, (const int*)qlen,
         (const int*)slen, B, Qmax, Smax, W, split, match, mism, go1, ge1,
         go2, ge2, NEG32, NEG32 / 2, (uint8_t*)scratch, (uint8_t*)dirs,
         (int*)score, (int*)end_i, (int*)end_b, (uint8_t*)ok,
         (cudaStream_t)stream};
  if (i16) {
    const int g1 = go1 + ge1 * (W + 1), g2 = go2 + ge2 * (W + 1);
    a.neg = NEG16;
    a.thr = NEG16 + (g1 > g2 ? g1 : g2) + 16;
    return dispatch_mode<short, I16x2>(diag, free_end, a);
  }
  return dispatch_mode<int, I32>(diag, free_end, a);
}

}  // extern "C"
