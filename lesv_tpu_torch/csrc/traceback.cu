// Alignment traceback over the fill's direction bytes: one block per lane,
// the lane's direction rows staged in shared memory ahead of the walk.
//
// Replaces lesv_tpu/ops/align_jax.py:271 traceback_device (an XLA lax.scan
// of point gathers, T = rows + W + 2 steps).  The walk is the same state
// machine (3-bit source + E1/E2/F1/F2 extension flags) over the lane-major
// (B, R, W) dirs tensor; a lane that leaves the band without reaching the
// origin fails (nops = 0, reached = 0, an all-255 row).
//
// What bounds it on this card.  The walk is sequential: each step's
// address depends on the byte the step before read.  Read from device
// memory, that is a DRAM round trip a step (~0.8 us at Q=4096, where a
// chunk's dirs, 537 MB, far exceed the L2).  Here a step is two dependent
// shared-memory loads (the direction
// byte, then its entry in a step table) and two adds; behind the walk, the
// staged bytes (at most B x R x W, each read once) bound it at 3.35 TB/s.
//
// Design.
// * Staging.  The path's row index never increases, so the rows the walk
//   will need are known ahead of it: end row, end row - 1, ... down to
//   row 0.  Warps 1..3 copy tiles of K whole rows (K from W and a stage of
//   about 12 KB; a run of E steps can cross a whole row) into a ring of NS
//   stages with 16-byte cp.async, up to three tiles in flight.  A tile is
//   one contiguous span of the lane's rows, copied as the 16-byte-aligned
//   span that covers it, so any W (65, odd row starts) takes the same path.
//   Shared flags (tiles published, tiles the walker has left, walk done)
//   pass the stages between the stagers and the walker; staging stops when
//   the walk ends.
// * The walk (warp 0, one thread).  A step table in shared memory, built
//   per launch for this W and band mode, maps (extension state, byte) to
//   the op, the next state, the row and band steps and the shared-address
//   delta of the next cell; the walker keeps the shared address of its
//   cell and loads the next byte before testing the step's exits.  The
//   same loop, instantiated three times more, walks an end row past R - 1
//   (a row step stays on row R - 1 until the row index comes down, before
//   and past the end of the shared op buffer) and takes the ops past the
//   shared op buffer.
// * Output.  Ops go, in walk order, into a shared buffer of up to OPS_CAP
//   bytes (filled from its end) and past that into the lane's own output
//   row (also from its end).  After the walk the block writes the forward
//   ops and the 255 tail with 16-byte stores, in rounds separated by
//   barriers, so the in-place move of the spilled part never reads a byte
//   a round already overwrote.
// Shared memory: the step table (16 KB), NS <= 4 stages (fewer for very
// wide bands, at least one whole row) and the op buffer, so every W up to
// about 200,000 takes this kernel; the launcher refuses wider bands.

#include <cuda_runtime.h>
#include <stdint.h>

#define TB_THREADS 128
#define TB_STAGERS (TB_THREADS - 32)
#define STAGE_TARGET 12288
#define MAX_STAGES 4
#define OPS_CAP 16384
#define TAB_BYTES (8 * 256 * 8)  // the step table: 8 states x 256 bytes
#define TB_STATIC_SMEM 64        // the kernel's static shared flags
#define MAX_DEVICES 64

struct TbGeom {
  int K;     // rows per tile
  int SB;    // bytes per stage
  int NS;    // stages in the ring
  int OCAP;  // ops bytes kept in shared memory
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}
// wait until at most n of this thread's newest copy groups are pending
__device__ __forceinline__ void cp_async_wait_groups(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::);
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 2;\n" ::);
}
__device__ __forceinline__ void stagers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(TB_STAGERS));
}

__device__ __forceinline__ int lds_u8(unsigned a) {
  unsigned v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return (int)v;
}
__device__ __forceinline__ uint2 lds_u64(unsigned a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ void sts_u8(unsigned a, int v) {
  asm volatile("st.shared.u8 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

// The walker: its cell, extension state, ops so far, and where its row
// sits in the ring (tile t, whose first row is r0, at ring offset rowoff);
// byte is the direction byte of the current cell.
struct Walk {
  int i, b, st, n, t, r0, rowoff, byte;
};

struct WalkCtx {
  unsigned ring, ops_end;  // shared addresses: ring, last op-buffer byte
  unsigned tab, last;      // the step table, the last shared byte
  uint8_t* row_out;
  const uint8_t* dl;
  volatile int *filled, *consumed;
  int R, W, T, top, K, NS, SB;
};

// make tile w.t current, with `row` the walk's row, once the stagers have
// published it
__device__ __forceinline__ void enter_tile(Walk& w, const WalkCtx& c,
                                           int row) {
  while (*c.filled <= w.t) {
  }
  __threadfence_block();
  const int r1 = c.top - w.t * c.K;
  w.r0 = max(0, r1 - c.K + 1);
  const int head = (int)((uintptr_t)(c.dl + (size_t)w.r0 * c.W) & 15);
  w.rowoff = w.t % c.NS * c.SB + head + (row - w.r0) * c.W;
}

// One entry of the step table, for extension state st and direction byte
// `byte` (index st * 256 + byte): x = next state << 11 | op << 14 |
// row step << 16 | (band step + 1) << 17; y = the shared-address delta of
// the next cell (band step, minus W for a row step).  The state machine of
// align_jax.traceback_device.
template <bool DIAG>
__device__ __forceinline__ uint2 step_entry(int st, int byte, int W) {
  constexpr int d = DIAG ? 1 : 0;
  const int src = byte & 7;
  const int se = st == 0 ? src : st;
  const bool is_m = se == 0;
  const bool is_e = se == 1 || se == 2;
  const bool is_f = se == 3 || se == 4;
  const int op = is_m ? 0 : (is_e ? 2 : 1);
  const bool eext = (se == 1 ? (byte & 0x08) : (byte & 0x10)) != 0;
  const bool fext = (se == 3 ? (byte & 0x20) : (byte & 0x40)) != 0;
  const int vert = (is_m || is_f) ? 1 : 0;
  const int db = is_m ? d - 1 : (is_e ? -1 : d);
  const int nst = is_m ? 0 : (is_e ? (eext ? se : 0) : (fext ? se : 0));
  return make_uint2((unsigned)(nst << 11 | op << 14 | vert << 16 |
                               (db + 1) << 17),
                    (unsigned)(db - vert * W));
}

// Steps of the walk until it reaches the origin or T steps (returns 1),
// leaves the band (returns 2), or has made `limit` ops (returns 0).  Per
// step: one table load with the byte, the next cell's address from the
// entry, its byte loaded before the exit test.  PREFIX walks an end row
// past R - 1, where a row step stays on row R - 1, and stops (returns 0)
// once the row index is R - 1.  SPILL stores the ops into the lane's
// output row instead of the shared op buffer.
template <bool DIAG, bool PREFIX, bool SPILL>
__device__ __forceinline__ int walk(Walk& w, const WalkCtx& c, int limit) {
  if (w.n >= limit) return 0;
  const int W = c.W, W2 = c.W / 2, Rm1 = c.R - 1, T = c.T;
  const unsigned ring = c.ring, tab = c.tab, last = c.last;
  int i = w.i, b = w.b, n = w.n, r0 = w.r0, byte = w.byte, why;
  unsigned sto = (unsigned)w.st << 11;
  unsigned addr = ring + w.rowoff + b;
  while (true) {
    const uint2 e = lds_u64(tab + sto + ((unsigned)byte << 3));
    const int vert = (int)((e.x >> 16) & 1);
    const unsigned naddr = addr + e.y + (PREFIX && vert ? W : 0);
    const int ni = i - vert;
    const int nb = b + (int)((e.x >> 17) & 3) - 1;
    const int nbyte = lds_u8(min(naddr, last));
    const int op = (int)((e.x >> 14) & 3);
    if (SPILL)
      c.row_out[T - 1 - n] = (uint8_t)op;
    else
      sts_u8(c.ops_end - n, op);
    ++n;
    sto = e.x & 0x3800;
    const bool oob = (unsigned)nb >= (unsigned)W || ni < 0;
    const bool origin = ni <= 0 && (DIAG ? ni - W2 : 0) + nb <= 0;
    i = ni;
    b = nb;
    addr = naddr;
    byte = nbyte;
    if (oob || origin || ni < r0 || n >= limit || (PREFIX && ni <= Rm1)) {
      if (oob || origin) {
        why = origin ? 1 : 2;
        break;
      }
      if (ni < r0) {  // the step crossed into the next tile
        *c.consumed = ++w.t;
        enter_tile(w, c, ni);
        r0 = w.r0;
        addr = ring + w.rowoff + b;
        byte = lds_u8(addr);
      }
      if (n >= limit || PREFIX) {
        why = n >= T ? 1 : 0;
        break;
      }
    }
  }
  w.i = i;
  w.b = b;
  w.n = n;
  w.st = (int)(sto >> 11);
  w.r0 = r0;
  w.rowoff = (int)(addr - ring) - b;
  w.byte = byte;
  return why;
}

template <bool DIAG>
__global__ void __launch_bounds__(TB_THREADS)
    traceback_kernel(const uint8_t* __restrict__ dirs, int R, int W,
                     const int* __restrict__ end_i,
                     const int* __restrict__ end_b,
                     const uint8_t* __restrict__ okv, int T,
                     TbGeom g, uint8_t* __restrict__ ops,
                     int* __restrict__ nops, uint8_t* __restrict__ reached) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint2* tab = reinterpret_cast<uint2*>(smem);  // TAB_BYTES: the step table
  uint8_t* ring = smem + TAB_BYTES;             // NS stages of SB bytes
  uint8_t* sops = ring + (size_t)g.NS * g.SB;   // OCAP bytes
  __shared__ volatile int s_filled, s_consumed, s_done, s_stop, s_n;

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int W2 = W / 2;
  const uint8_t* dl = dirs + (size_t)lane * R * W;
  uint8_t* row_out = ops + (size_t)lane * T;
  const int i0 = end_i[lane], b0 = end_b[lane];
  const bool ok = okv[lane] != 0;
  const bool at0 = i0 <= 0 && (DIAG ? i0 - W2 : 0) + b0 <= 0;
  const bool active = ok && !at0 && T > 0;
  const int top = min(max(i0, 0), R - 1);
  const int ntiles = top / g.K + 1;
  for (int k = tid; k < 8 * 256; k += TB_THREADS)
    tab[k] = step_entry<DIAG>(k >> 8, k & 255, W);
  if (tid == 0) {
    s_filled = 0;
    s_consumed = 0;
    s_done = 0;
    s_stop = 0;
    s_n = 0;
  }
  __syncthreads();

  if (active && tid >= 32) {
    // ---- stagers: tiles of K rows, from the end row down ----
    // Up to L + 1 tiles in flight; tile t - L is published once tile t is
    // issued.  Every issued tile up to t - NS + 1 is published before the
    // stagers wait for the walker to leave stage (t - NS), so neither side
    // waits on the other (L <= NS - 1; L = NS - 2 keeps a landed tile from
    // waiting for the walker before it is published).
    const int stid = tid - 32;
    const int L = max(g.NS - 2, 0);
    int t = 0;
    for (; t < ntiles; ++t) {
      if (t >= g.NS) {
        if (stid == 0) {
          const int need = t - g.NS + 1;
          while (s_consumed < need && !s_done) __nanosleep(32);
          s_stop = s_done;
        }
        stagers_sync();
        if (s_stop) break;
      }
      const int r1 = top - t * g.K;
      const int r0 = max(0, r1 - g.K + 1);
      const uint8_t* src = dl + (size_t)r0 * W;
      const uintptr_t a0 = (uintptr_t)src & ~(uintptr_t)15;
      const int span = (int)((uintptr_t)src - a0) + (r1 - r0 + 1) * W;
      const int chunks = (span + 15) >> 4;
      uint8_t* dst = ring + (size_t)(t % g.NS) * g.SB;
      for (int c = stid; c < chunks; c += TB_STAGERS)
        cp_async16(dst + 16 * c, (const void*)(a0 + 16 * (uintptr_t)c));
      cp_async_commit();
      if (t >= L) {
        cp_async_wait_groups(L);
        __threadfence_block();
        stagers_sync();
        if (stid == 0) s_filled = t - L + 1;
      }
    }
    cp_async_wait_all();
    if (t == ntiles) {
      __threadfence_block();
      stagers_sync();
      if (stid == 0) s_filled = ntiles;
    }
  } else if (tid == 0) {
    // ---- the walker ----
    Walk w{i0, b0, 0, 0, 0, 0, 0, 0};
    if (active) {
      const unsigned ops_end =
          (unsigned)__cvta_generic_to_shared(sops) + g.OCAP - 1;
      const WalkCtx c{(unsigned)__cvta_generic_to_shared(ring), ops_end,
                      (unsigned)__cvta_generic_to_shared(tab), ops_end,
                      row_out, dl, &s_filled, &s_consumed, R, W, T, top,
                      g.K, g.NS, g.SB};
      enter_tile(w, c, top);
      w.byte = lds_u8(c.ring + w.rowoff + min(max(b0, 0), W - 1));
      // an end row past R - 1 walks on row R - 1 first; ops past the
      // shared buffer go to the output row
      const int lim = min(T, g.OCAP);
      int why = 0;
      if (i0 > R - 1) why = walk<DIAG, true, false>(w, c, lim);
      if (why == 0 && w.i > R - 1) why = walk<DIAG, true, true>(w, c, T);
      if (why == 0) why = walk<DIAG, false, false>(w, c, lim);
      if (why == 0) why = walk<DIAG, false, true>(w, c, T);
      if (why == 2) w.n = 0;
    }
    s_done = 1;
    const bool origin = w.i <= 0 && (DIAG ? w.i - W2 : 0) + w.b <= 0;
    reached[lane] = (uint8_t)(origin && ok && w.n > 0);
    nops[lane] = w.n;
    s_n = w.n;
  }
  __syncwarp();
  __syncthreads();

  // ---- forward ops and the 255 tail, 16 bytes a thread a round ----
  const int n = s_n;
  const int a = (int)((uintptr_t)row_out & 15);
  const int C = (a + T + 15) >> 4;
  for (int c0 = 0; c0 < C; c0 += TB_THREADS) {
    const int c = c0 + tid;
    const int p0 = 16 * c - a;
    union {
      uint4 v;
      uint8_t by[16];
    } u;
    if (c < C) {
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int k = p0 + q;
        uint8_t v = 255;
        if (k >= 0 && k < n) {
          const int j = n - 1 - k;  // walk-order index
          v = j < g.OCAP ? sops[g.OCAP - 1 - j] : row_out[T - 1 - j];
        }
        u.by[q] = v;
      }
    }
    __syncthreads();
    if (c < C) {
      if (p0 >= 0 && p0 + 16 <= T) {
        *reinterpret_cast<uint4*>(row_out + p0) = u.v;
      } else {
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int k = p0 + q;
          if (k >= 0 && k < T) row_out[k] = u.by[q];
        }
      }
    }
    __syncthreads();
  }
}

extern "C" {

int lesv_traceback(const void* dirs, int B, int R, int W, const void* end_i,
                   const void* end_b, const void* ok, int diag, int T,
                   void* ops, void* nops, void* reached, void* stream) {
  if (B <= 0) return 0;
  if (R < 1 || W < 1 || T < 0) return (int)cudaErrorInvalidValue;
  // the device's opt-in shared-memory limit, read and granted to both
  // kernels once per device (both stored values are the same whichever
  // host thread gets here first)
  static int optin_of[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int optin = dev < MAX_DEVICES ? __atomic_load_n(&optin_of[dev],
                                                  __ATOMIC_ACQUIRE)
                                : 0;
  if (optin == 0) {
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    const int dyn = optin - TB_STATIC_SMEM;
    e = cudaFuncSetAttribute(traceback_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(traceback_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dyn);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES)
      __atomic_store_n(&optin_of[dev], optin, __ATOMIC_RELEASE);
  }
  optin -= TB_STATIC_SMEM;
  TbGeom g;
  g.K = min(max(1, STAGE_TARGET / W), R);
  g.SB = ((g.K * W + 15) & ~15) + 16;  // the aligned span of K rows
  g.OCAP = min((max(T, 1) + 15) & ~15, OPS_CAP);
  g.NS = MAX_STAGES;
  optin -= TAB_BYTES;
  while (g.NS > 1 && (size_t)g.NS * g.SB + g.OCAP > (size_t)optin) --g.NS;
  while (g.OCAP > 16 && (size_t)g.NS * g.SB + g.OCAP > (size_t)optin)
    g.OCAP /= 2;
  if ((size_t)g.NS * g.SB + g.OCAP > (size_t)optin)
    return (int)cudaErrorInvalidValue;
  const size_t smem = TAB_BYTES + (size_t)g.NS * g.SB + g.OCAP;
  auto kern = diag ? traceback_kernel<true> : traceback_kernel<false>;
  kern<<<B, TB_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)dirs, R, W, (const int*)end_i, (const int*)end_b,
      (const uint8_t*)ok, T, g, (uint8_t*)ops, (int*)nops,
      (uint8_t*)reached);
  return (int)cudaGetLastError();
}

}  // extern "C"
