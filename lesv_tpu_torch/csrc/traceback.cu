// Alignment traceback over the fill's direction bytes, one thread per lane.
//
// Replaces lesv_tpu/ops/align_jax.py::traceback_device (an XLA lax.scan of
// point gathers, T = rows + W + 2 steps).  Written as torch ops it would be
// T launches per chunk; here each thread walks its lane's path through the
// lane-major (B, R, W) dirs tensor with the same state machine (3-bit
// source + E1/E2/F1/F2 extension flags), writes the ops in reverse and
// flips them into forward order with an OP_PAD (255) tail.  A lane that
// leaves the band without reaching the origin fails (nops = 0).
//
// What bounds it on this card: one dependent byte load per step (latency,
// not bandwidth); lanes run in parallel, so a chunk costs about one path
// length of dependent loads.  Paths stop as soon as they reach the origin.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void traceback_kernel(const uint8_t* __restrict__ dirs, int B,
                                 int R, int W, const int* __restrict__ end_i,
                                 const int* __restrict__ end_b,
                                 const uint8_t* __restrict__ okv, int diag,
                                 int T, uint8_t* __restrict__ ops,
                                 int* __restrict__ nops,
                                 uint8_t* __restrict__ reached) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int W2 = W / 2;
  const int d = diag ? 1 : 0;
  const uint8_t* dl = dirs + (size_t)lane * R * W;
  uint8_t* out = ops + (size_t)lane * T;
  int i = end_i[lane], b = end_b[lane], st = 0, n = 0;
  const bool ok = okv[lane] != 0;
  bool done = !ok;
  for (int t = 0; t < T; ++t) {
    const int g = diag ? i - W2 : 0;
    if (i <= 0 && g + b <= 0) done = true;
    if (done) break;
    const int ic = min(max(i, 0), R - 1);
    const int bc = min(max(b, 0), W - 1);
    const int byte = dl[(size_t)ic * W + bc];
    const int src = byte & 7;
    const int se = st == 0 ? src : st;
    const bool is_m = se == 0;
    const bool is_e = se == 1 || se == 2;
    const bool is_f = se == 3 || se == 4;
    out[n] = (uint8_t)(is_m ? 0 : (is_e ? 2 : 1));
    const bool eext = (se == 1 ? (byte & 0x08) : (byte & 0x10)) != 0;
    const bool fext = (se == 3 ? (byte & 0x20) : (byte & 0x40)) != 0;
    const int ni = (is_m || is_f) ? i - 1 : i;
    const int nb = is_m ? b + d - 1 : (is_e ? b - 1 : b + d);
    const int nst = is_m ? 0 : (is_e ? (eext ? se : 0) : (fext ? se : 0));
    const bool oob = nb < 0 || nb >= W || ni < 0;
    i = ni;
    b = nb;
    st = nst;
    ++n;
    const int g2 = diag ? i - W2 : 0;
    if (oob && !(i <= 0 && g2 + b <= 0)) {
      done = true;
      n = 0;
    }
  }
  const int g = diag ? i - W2 : 0;
  reached[lane] = (uint8_t)(i <= 0 && g + b <= 0 && ok && n > 0);
  nops[lane] = n;
  for (int a = 0, z = n - 1; a < z; ++a, --z) {
    const uint8_t x = out[a];
    out[a] = out[z];
    out[z] = x;
  }
  for (int t = n; t < T; ++t) out[t] = 255;
}

extern "C" {

int lesv_traceback(const void* dirs, int B, int R, int W, const void* end_i,
                   const void* end_b, const void* ok, int diag, int T,
                   void* ops, void* nops, void* reached, void* stream) {
  if (B <= 0) return 0;
  const int nt = 128;
  traceback_kernel<<<(B + nt - 1) / nt, nt, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)dirs, B, R, W, (const int*)end_i, (const int*)end_b,
      (const uint8_t*)ok, diag, T, (uint8_t*)ops, (int*)nops,
      (uint8_t*)reached);
  return (int)cudaGetLastError();
}

}  // extern "C"
