// A whole phase-packed generator stage in one kernel, for Hopper (sm_90a):
//
//   z   = lrelu(conv3x3(x * s1; k1) * d1 + n1[phase] + b1) * sqrt(2) * s2
//   z2  = lrelu(conv3x3(z; k2) * d2 + n2[phase] + b2) * sqrt(2)
//   rgb = z2 . k3sr[b] + b3 + conv3x3(skip; k4)
//
// NHWC x (B, H, W, C1), HWIO k1 (3, 3, C1, C4) and k2 (3, 3, C4, C4), zero
// padding 1 for each conv; n1, n2 (B, H, W, 4) broadcast to C4 = 4 * Cmid
// packed channels by the phase co / Cmid; per-sample s1 (B, C1), d1, b1,
// s2, d2, b2 (B, C4), k3sr (B, C4, 12) (toRGB kernel, style scale folded
// in), b3 (B, 12); k4 (3, 3, 3, 12) the packed skip upsample. Outputs rgb
// (B, H, W, 12) and z2 (B, H, W, C4).
//
// Replaces the TPU kernel ops/pallas_kernels.py:_stage_band_kernel (called
// by fused_packed_stage_pallas / fused_packed_stage). Like it, conv1's
// activation never goes to device memory, and toRGB reads z2 rounded to the
// operand dtype. Unlike it, x, n1 and skip are read in place with masked
// loads (no padded copies), and the noise is read at index co / Cmid (no
// one-hot matmul). The TPU kernel runs only at channel counts that are
// multiples of 128; this one takes any C4 whose activation tile fits in
// shared memory (C4 <= 469 in float32, <= 938 in bfloat16).
//
// What bounds it: operations, as for the pair kernel (packed_pair.cu), and
// more so: conv2 reads its input from shared memory. A block computes an
// 8 x 8 output tile. It first computes conv1 on the 10 x 10 region around
// the tile (the 1-pixel halo conv2 needs; conv1 reads x with a 2-pixel
// halo), applies the epilogue and s2, and keeps the result in shared memory
// in the operand dtype: 10 x 10 x C4 values, 100 KB at C4 = 256 in float32,
// the reason for the 8 x 8 tile. Activations outside the image are stored
// as 0 (conv2's zero padding), not as lrelu(bias + noise). Recomputing the
// halo costs (10 x 10) / (8 x 8) = 1.56x of conv1's work. Then conv2 runs
// from that tile, writes z2, and each thread's 8 channels of z2 are folded
// into toRGB partial sums, which a fixed butterfly of warp shuffles adds over
// the channels; the 3 -> 12 skip conv and the bias finish rgb. All sums in
// float32 registers, 256 threads, weights through shared memory in chunks of
// 8 input channels, CUDA cores only (no wgmma yet).
//
// Deterministic: every sum is taken in a fixed order, without atomics.
//
// Plain C interface (bound with ctypes): launches on the given stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int T = 8;             // output tile side
constexpr int ZT = T + 2;        // conv1 region (the tile and a 1-pixel halo)
constexpr int XT = T + 4;        // x region conv1 reads (a 2-pixel halo)
constexpr int TN = 128;          // output channels per pass
constexpr int KC = 8;            // input channels per shared-memory chunk
constexpr int THREADS = 256;
constexpr int SLOTS1 = (ZT * ZT + 15) / 16;   // conv1 pixels per thread: 7
constexpr int SMEM_FIXED = (9 * KC * TN + KC * XT * XT + T * T * 12) * 4;
constexpr int SMEM_MAX = 232448;
constexpr float SQRT2 = 1.41421356237309515f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename S> __device__ __forceinline__ S from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

__device__ __forceinline__ float lrelu(float z) { return (z >= 0.0f ? z : 0.2f * z) * SQRT2; }

// ws[tap][kc][n] = k[tap][c0 + kc][n0 + n], 0 past Cin or Cout.
template <typename S>
__device__ __forceinline__ void stage_weights(float* ws, const S* __restrict__ k,
                                              int c0, int n0, int Cin, int Cout) {
  for (int e = threadIdx.x; e < 9 * KC * TN; e += THREADS) {
    const int n = e % TN, kc = (e / TN) % KC, tap = e / (TN * KC);
    const int ci = c0 + kc, co = n0 + n;
    ws[e] = (ci < Cin && co < Cout) ? to_f(k[((int64_t)tap * Cin + ci) * Cout + co]) : 0.0f;
  }
}

// 8 multiply-adds: acc[0..7] += v * (wa, wb).
__device__ __forceinline__ void fma8(float acc[8], float v, float4 wa, float4 wb) {
  acc[0] += v * wa.x; acc[1] += v * wa.y; acc[2] += v * wa.z; acc[3] += v * wa.w;
  acc[4] += v * wb.x; acc[5] += v * wb.y; acc[6] += v * wb.z; acc[7] += v * wb.w;
}

// Block (tile, sample). Thread tid: tn = tid % 16 owns the channels
// n0 + tn*4 + {0..3} and n0 + 64 + tn*4 + {0..3} of each pass; tm = tid / 16
// picks its pixels (conv1: region pixels tm + 16 j; conv2: tile column
// tm % 8, rows (tm / 8) * 4 + {0..3}).
template <typename S>
__global__ void __launch_bounds__(THREADS, 2)
stage_kernel(const S* __restrict__ x, const float* __restrict__ n1,
             const float* __restrict__ n2, const S* __restrict__ skip,
             const S* __restrict__ k1, const float* __restrict__ s1,
             const float* __restrict__ d1, const float* __restrict__ b1,
             const S* __restrict__ k2, const float* __restrict__ s2,
             const float* __restrict__ d2, const float* __restrict__ b2,
             const S* __restrict__ k3sr, const float* __restrict__ b3,
             const S* __restrict__ k4, S* __restrict__ rgb, S* __restrict__ z2,
             int H, int W, int C1, int C4, int tiles_w) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                                  // [9][KC][TN]
  float* xs = ws + 9 * KC * TN;                      // [KC][XT * XT]
  float* rgbs = xs + KC * XT * XT;                   // [T * T][12]
  S* zs = reinterpret_cast<S*>(rgbs + T * T * 12);   // [C4][ZT * ZT]

  const int tid = threadIdx.x;
  const int tn = tid % 16, tm = tid / 16;
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_w) * T;
  const int x0 = (blockIdx.x % tiles_w) * T;
  const int cmid = C4 / 4;

  // ---- conv1 on the ZT x ZT region, pass by pass over 128 channels
  int off1[SLOTS1];
#pragma unroll
  for (int j = 0; j < SLOTS1; ++j) {
    const int p = min(tm + 16 * j, ZT * ZT - 1);      // slots past the region compute p = 99 again
    off1[j] = (p / ZT) * XT + p % ZT;
  }
  for (int n0 = 0; n0 < C4; n0 += TN) {
    float acc[SLOTS1][8];
#pragma unroll
    for (int j = 0; j < SLOTS1; ++j)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[j][c] = 0.0f;
    for (int c0 = 0; c0 < C1; c0 += KC) {
      for (int e = tid; e < XT * XT * KC; e += THREADS) {
        const int kc = e % KC, p = e / KC;
        const int gy = y0 + p / XT - 2, gx = x0 + p % XT - 2, ci = c0 + kc;
        float v = 0.0f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && ci < C1)
          v = to_f(x[(((int64_t)b * H + gy) * W + gx) * C1 + ci]) * s1[b * C1 + ci];
        xs[kc * XT * XT + p] = v;
      }
      stage_weights(ws, k1, c0, n0, C1, C4);
      __syncthreads();
      const int kmax = min(KC, C1 - c0);
      for (int kc = 0; kc < kmax; ++kc) {
        const float* xk = xs + kc * XT * XT;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const float* w = ws + (tap * KC + kc) * TN;
          const float4 wa = *reinterpret_cast<const float4*>(w + tn * 4);
          const float4 wb = *reinterpret_cast<const float4*>(w + 64 + tn * 4);
          const int o = (tap / 3) * XT + tap % 3;
#pragma unroll
          for (int j = 0; j < SLOTS1; ++j) fma8(acc[j], xk[off1[j] + o], wa, wb);
        }
      }
      __syncthreads();
    }
    // epilogue: z = lrelu(...) * s2 in the operand dtype; 0 outside the image
#pragma unroll
    for (int j = 0; j < SLOTS1; ++j) {
      const int p = tm + 16 * j;
      if (p >= ZT * ZT) break;
      const int zy = y0 + p / ZT - 1, zx = x0 + p % ZT - 1;
      const bool inside = zy >= 0 && zy < H && zx >= 0 && zx < W;
      const int64_t pix = ((int64_t)b * H + zy) * W + zx;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int co = n0 + (c / 4) * 64 + tn * 4 + c % 4;
        if (co >= C4) continue;
        float z = 0.0f;
        if (inside)
          z = lrelu(acc[j][c] * d1[b * C4 + co] + n1[pix * 4 + co / cmid]
                    + b1[b * C4 + co]) * s2[b * C4 + co];
        zs[co * (ZT * ZT) + p] = from_f<S>(z);
      }
    }
  }
  __syncthreads();

  // ---- conv2 on the T x T tile from zs, then z2 and the toRGB partial sums
  const int tx = tm % 8, ty0 = (tm / 8) * 4;
  for (int n0 = 0; n0 < C4; n0 += TN) {
    float acc[4][8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[j][c] = 0.0f;
    for (int c0 = 0; c0 < C4; c0 += KC) {
      stage_weights(ws, k2, c0, n0, C4, C4);
      __syncthreads();
      const int kmax = min(KC, C4 - c0);
      for (int kc = 0; kc < kmax; ++kc) {
        const S* zk = zs + (c0 + kc) * (ZT * ZT);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float zv[6];
#pragma unroll
          for (int r = 0; r < 6; ++r) zv[r] = to_f(zk[(ty0 + r) * ZT + tx + dx]);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const float* w = ws + ((dy * 3 + dx) * KC + kc) * TN;
            const float4 wa = *reinterpret_cast<const float4*>(w + tn * 4);
            const float4 wb = *reinterpret_cast<const float4*>(w + 64 + tn * 4);
#pragma unroll
            for (int j = 0; j < 4; ++j) fma8(acc[j], zv[j + dy], wa, wb);
          }
        }
      }
      __syncthreads();
    }
    const int gx = x0 + tx;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gy = y0 + ty0 + j;
      const bool inside = gy < H && gx < W;
      const int64_t pix = ((int64_t)b * H + gy) * W + gx;
      float part[12];
#pragma unroll
      for (int o = 0; o < 12; ++o) part[o] = 0.0f;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int cb = n0 + g * 64 + tn * 4;
        if (cb >= C4) continue;        // C4 % 4 == 0: a group is all in or all out
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int co = cb + q;
          const float nz = inside ? n2[pix * 4 + co / cmid] : 0.0f;
          const float z = lrelu(acc[j][g * 4 + q] * d2[b * C4 + co] + nz + b2[b * C4 + co]);
          v[q] = to_f(from_f<S>(z));     // toRGB reads z2 as stored
          const S* kr = k3sr + ((int64_t)b * C4 + co) * 12;
#pragma unroll
          for (int o = 0; o < 12; ++o) part[o] += v[q] * to_f(kr[o]);
        }
        if (inside) store4(z2 + pix * C4 + cb, v);
      }
      // sum over the 16 channel groups (lanes tn = 0..15 of a half warp);
      // every lane ends with the same sum
#pragma unroll
      for (int o = 0; o < 12; ++o)
#pragma unroll
        for (int m = 8; m >= 1; m /= 2) part[o] += __shfl_xor_sync(0xffffffffu, part[o], m);
      if (tn == 0) {
        float* rp = rgbs + ((ty0 + j) * T + tx) * 12;
#pragma unroll
        for (int o = 0; o < 12; ++o) rp[o] = (n0 == 0 ? 0.0f : rp[o]) + part[o];
      }
    }
  }
  __syncthreads();

  // ---- rgb = toRGB + b3 + the packed skip upsample (3 -> 12, 3x3, zero pad)
  for (int e = tid; e < T * T * 12; e += THREADS) {
    const int p = e / 12, o = e % 12;
    const int gy = y0 + p / T, gx = x0 + p % T;
    if (gy >= H || gx >= W) continue;
    float v = rgbs[e] + b3[b * 12 + o];
    for (int dy = 0; dy < 3; ++dy) {
      const int sy = gy + dy - 1;
      if (sy < 0 || sy >= H) continue;
      for (int dx = 0; dx < 3; ++dx) {
        const int sx = gx + dx - 1;
        if (sx < 0 || sx >= W) continue;
        const S* sp = skip + (((int64_t)b * H + sy) * W + sx) * 3;
        const S* kp = k4 + (dy * 3 + dx) * 36 + o;
        v += to_f(sp[0]) * to_f(kp[0]) + to_f(sp[1]) * to_f(kp[12])
             + to_f(sp[2]) * to_f(kp[24]);
      }
    }
    rgb[(((int64_t)b * H + gy) * W + gx) * 12 + o] = from_f<S>(v);
  }
}

template <typename S>
int launch(const void* const* p, int B, int H, int W, int C1, int C4,
           cudaStream_t stream) {
  const size_t smem = SMEM_FIXED + (size_t)C4 * ZT * ZT * sizeof(S);
  if (smem > SMEM_MAX) return 1001;
  cudaError_t err = cudaFuncSetAttribute(
      stage_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + T - 1) / T, tiles_h = (H + T - 1) / T;
  const dim3 grid(tiles_h * tiles_w, B);
  auto S_ = [&](int i) { return static_cast<const S*>(p[i]); };
  auto F_ = [&](int i) { return static_cast<const float*>(p[i]); };
  stage_kernel<S><<<grid, THREADS, smem, stream>>>(
      S_(0), F_(1), F_(2), S_(3), S_(4), F_(5), F_(6), F_(7), S_(8), F_(9),
      F_(10), F_(11), S_(12), F_(13), S_(14),
      static_cast<S*>(const_cast<void*>(p[15])), static_cast<S*>(const_cast<void*>(p[16])),
      H, W, C1, C4, tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, skip, k1, k2, k3sr, k4, rgb, z2; the
// rest float32). All tensors contiguous, shapes as in the note above.
// Returns cudaGetLastError() after the launch (0 = success); 1000 for an
// argument the kernel does not take, 1001 when the conv1 activation tile
// does not fit in shared memory.
extern "C" int ogi_packed_stage(const void* x, const void* n1, const void* n2,
                                const void* skip, const void* k1, const void* s1,
                                const void* d1, const void* b1, const void* k2,
                                const void* s2, const void* d2, const void* b2,
                                const void* k3sr, const void* b3, const void* k4,
                                void* rgb, void* z2, int B, int H, int W, int C1,
                                int C4, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C1 <= 0 || C4 <= 0 ||
      C4 % 4 != 0 || (dtype != 0 && dtype != 1))
    return 1000;
  const void* p[17] = {x, n1, n2, skip, k1, s1, d1, b1, k2, s2, d2, b2,
                       k3sr, b3, k4, rgb, z2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(p, B, H, W, C1, C4, st)
                    : launch<__nv_bfloat16>(p, B, H, W, C1, C4, st);
}
