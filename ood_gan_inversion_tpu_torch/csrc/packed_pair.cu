// One fused conv of the phase-packed generator layer pair, for Hopper (sm_90a):
//
//   out = lrelu(conv3x3(x * s_in) * d_out + noise4[phase(co)] + bias) * sqrt(2)
//
// NHWC x (B, H, W, Ci), HWIO k (3, 3, Ci, Co), zero padding 1; noise4
// (B, H, W, 4) is broadcast to the Co = 4 * Cmid packed channels by the
// phase co / Cmid; s_in (B, Ci), d_out (B, Co), bias (B, Co) per sample.
//
// Replaces the TPU kernel ops/pallas_kernels.py:_conv_band_kernel (called by
// fused_conv3x3_act, twice per fused_packed_pair). That kernel computes full
// rows in bands with x pre-scaled and pre-padded by an XLA pass, and
// broadcasts the noise with a one-hot matmul because the TPU compiler cannot
// lower the reshape. Here s_in is applied in float32 as the tile is loaded,
// the padding is a masked load, and the noise is read at index co / Cmid.
//
// What bounds it: operations. At the packed stages' shapes it does
// 2 * 9 * Ci * Co flops per pixel (Ci, Co 64-256) against 4 * (Ci + Co)
// bytes in float32, some 300-1000 flops per byte, far above the card's
// float32 balance point. The design keeps the multiply-adds fed from
// registers: a block computes an 8 x 16 pixel tile for 128 output channels
// (256 threads; each thread one pixel column of 8 rows times 8 channels, 64
// float32 sums in registers). Input channels go through shared memory in
// chunks of 8, the x chunk with its 1-pixel halo and the 3 x 3 x 8 x 128
// weight chunk; for each (channel, dx) a thread reads the 10 rows of its
// column once and reuses them for the three dy taps, so a shared-memory load
// feeds ~10 multiply-adds. Operands may be bfloat16; shared memory and all
// sums are float32. This is the simple version: CUDA cores, no tensor cores
// (wgmma), no asynchronous copies, and it computes the structural zeros of
// the packed conv2 kernel (3/4 of its blocks) like the TPU kernel does.
//
// Deterministic: each output is summed by one thread in a fixed order.
//
// Plain C interface (bound with ctypes): launches on the given stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;        // output tile rows
constexpr int TW = 16;       // output tile columns
constexpr int TN = 128;      // output channels per block
constexpr int KC = 8;        // input channels per shared-memory chunk
constexpr int THREADS = 256;
constexpr float SQRT2 = 1.41421356237309515f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Stores 4 consecutive channels (16 bytes in float32, 8 in bfloat16).
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const uint32_t*>(&a);
  q.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

// Block (tile, channel block, sample). Thread tid: tn = tid % 16 owns the
// channels n0 + tn*4 + {0..3} and n0 + 64 + tn*4 + {0..3}; tm = tid / 16 is
// the tile column it computes, all TH rows of it.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_act_kernel(const T* __restrict__ x, const float* __restrict__ noise4,
                   const T* __restrict__ k, const float* __restrict__ s_in,
                   const float* __restrict__ d_out, const float* __restrict__ bias,
                   T* __restrict__ out, int H, int W, int Ci, int Co, int tiles_w) {
  __shared__ float xs[KC][TH + 2][TW + 2];
  __shared__ __align__(16) float ws[3][3][KC][TN];

  const int tid = threadIdx.x;
  const int tn = tid % 16, tm = tid / 16;
  const int b = blockIdx.z;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * TN;

  float acc[TH][8];
#pragma unroll
  for (int r = 0; r < TH; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  for (int c0 = 0; c0 < Ci; c0 += KC) {
    // x * s_in over the tile and its 1-pixel halo; 0 outside the image
    for (int e = tid; e < (TH + 2) * (TW + 2) * KC; e += THREADS) {
      const int kc = e % KC, p = e / KC;
      const int r = p / (TW + 2), c = p % (TW + 2);
      const int gy = y0 + r - 1, gx = x0 + c - 1, ci = c0 + kc;
      float v = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && ci < Ci)
        v = to_f(x[(((int64_t)b * H + gy) * W + gx) * Ci + ci]) * s_in[b * Ci + ci];
      xs[kc][r][c] = v;
    }
    for (int e = tid; e < 9 * KC * TN; e += THREADS) {
      const int n = e % TN, kc = (e / TN) % KC, tap = e / (TN * KC);
      const int ci = c0 + kc, co = n0 + n;
      float v = 0.0f;
      if (ci < Ci && co < Co) v = to_f(k[((int64_t)tap * Ci + ci) * Co + co]);
      ws[tap / 3][tap % 3][kc][n] = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float xv[TH + 2];
#pragma unroll
        for (int r = 0; r < TH + 2; ++r) xv[r] = xs[kc][r][tm + dx];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float4 wa = *reinterpret_cast<const float4*>(&ws[dy][dx][kc][tn * 4]);
          const float4 wb = *reinterpret_cast<const float4*>(&ws[dy][dx][kc][64 + tn * 4]);
#pragma unroll
          for (int r = 0; r < TH; ++r) {
            const float v = xv[r + dy];
            acc[r][0] += v * wa.x; acc[r][1] += v * wa.y;
            acc[r][2] += v * wa.z; acc[r][3] += v * wa.w;
            acc[r][4] += v * wb.x; acc[r][5] += v * wb.y;
            acc[r][6] += v * wb.z; acc[r][7] += v * wb.w;
          }
        }
      }
    }
    __syncthreads();
  }

  const int cmid = Co / 4;
  const int gx = x0 + tm;
  if (gx >= W) return;
#pragma unroll
  for (int r = 0; r < TH; ++r) {
    const int gy = y0 + r;
    if (gy >= H) break;
    const int64_t pix = ((int64_t)b * H + gy) * W + gx;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int cb = n0 + g * 64 + tn * 4;
      if (cb >= Co) continue;          // Co % 4 == 0: a group is all in or all out
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int co = cb + q;
        const float z = acc[r][g * 4 + q] * d_out[b * Co + co]
                        + noise4[pix * 4 + co / cmid] + bias[b * Co + co];
        v[q] = (z >= 0.0f ? z : 0.2f * z) * SQRT2;
      }
      store4(out + pix * Co + cb, v);
    }
  }
}

template <typename T>
void launch(const void* x, const float* noise4, const void* k, const float* s_in,
            const float* d_out, const float* bias, void* out, int B, int H,
            int W, int Ci, int Co, cudaStream_t stream) {
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const dim3 grid(tiles_h * tiles_w, (Co + TN - 1) / TN, B);
  conv3x3_act_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), noise4, static_cast<const T*>(k), s_in, d_out,
      bias, static_cast<T*>(out), H, W, Ci, Co, tiles_w);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, k and out). All tensors contiguous:
// x (B, H, W, Ci), noise4 (B, H, W, 4) float32, k (3, 3, Ci, Co), s_in
// (B, Ci), d_out and bias (B, Co) float32, out (B, H, W, Co).
// Returns cudaGetLastError() after the launch (0 = success); 1000 for an
// argument the kernel does not take.
extern "C" int ogi_packed_conv3x3_act(const void* x, const void* noise4,
                                      const void* k, const void* s_in,
                                      const void* d_out, const void* bias,
                                      void* out, int B, int H, int W, int Ci,
                                      int Co, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 ||
      Co % 4 != 0 || (dtype != 0 && dtype != 1))
    return 1000;
  const float* n = static_cast<const float*>(noise4);
  const float* s = static_cast<const float*>(s_in);
  const float* d = static_cast<const float*>(d_out);
  const float* bb = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) launch<float>(x, n, k, s, d, bb, out, B, H, W, Ci, Co, st);
  else            launch<__nv_bfloat16>(x, n, k, s, d, bb, out, B, H, W, Ci, Co, st);
  return (int)cudaGetLastError();
}
