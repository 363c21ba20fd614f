// The halo probe, for Hopper (sm_90a): a 3x3 box sum with a 1-pixel zero
// halo over a float32 (H, W) array,
//
//   out[y, x] = sum over dy, dx in {-1, 0, 1} of x[y + dy, x + dx]  (0 outside),
//
// computed in 8 x 8 tiles, each block loading its tile and the halo under a
// mask into shared memory.
//
// Replaces the TPU kernel tools/prof/prof_pallas_halo.py:kernel, a probe of
// Pallas's `pl.Element` halo padding. That kernel's block index map and its
// `padding=(1, 1)` both shift the window, so in interpret mode it does not
// compute its own oracle (the zero-halo box sum, the conv with a ones kernel
// at the end of that script). This kernel computes the oracle.
//
// What bounds it: bytes (9 adds per 8 bytes moved); at the probe's 32 x 32
// size, the launch itself. The 9 terms are added in (dy, dx) order, as the
// plain version adds them.
//
// Plain C interface (bound with ctypes): launches on the given stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 8;         // tile side

__global__ void box3x3_kernel(const float* __restrict__ x, float* __restrict__ out,
                              int H, int W) {
  __shared__ float tile[T + 2][T + 2];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int y0 = blockIdx.y * T, x0 = blockIdx.x * T;
  for (int e = ty * T + tx; e < (T + 2) * (T + 2); e += T * T) {
    const int r = e / (T + 2), c = e % (T + 2);
    const int gy = y0 + r - 1, gx = x0 + c - 1;
    tile[r][c] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                     ? x[(int64_t)gy * W + gx] : 0.0f;
  }
  __syncthreads();
  const int gy = y0 + ty, gx = x0 + tx;
  if (gy >= H || gx >= W) return;
  float acc = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) acc = __fadd_rn(acc, tile[ty + dy][tx + dx]);
  out[(int64_t)gy * W + gx] = acc;
}

}  // namespace

// x, out: contiguous float32 (H, W). Returns cudaGetLastError() after the
// launch (0 = success); 1000 for an argument the kernel does not take.
extern "C" int ogi_box3x3(const void* x, void* out, int H, int W, void* stream) {
  if (H <= 0 || W <= 0 || (H + T - 1) / T > 65535) return 1000;
  const dim3 grid((W + T - 1) / T, (H + T - 1) / T);
  box3x3_kernel<<<grid, dim3(T, T), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), H, W);
  return (int)cudaGetLastError();
}
