// The SAMM AlignNet body0 convolutions, for Hopper (sm_90a). Three entry
// points share one direct 3x3 convolution core (NCHW activations, OIHW
// weights, zero padding 1, float32 sums):
//
//   ogi_conv3x3_act      out = act(conv3x3(x, k)), act: none, PReLU or
//                        lrelu * sqrt(2); out in x's type.
//   ogi_alignnet_conv1   z = prelu(conv3x3(x1, k1)) with
//                        x1 = [as*s + at*t + b1, ct*t + b2] built on chip
//                        from s, t (B, C, H, W) and the five per-(b, c)
//                        coefficients; x1 is 0 outside the image (conv1's
//                        padding applies to x1, not to s and t); z in s's
//                        type.
//   ogi_alignnet_conv2   y2 = conv3x3(z, k2) in float32, and the per-(b,
//                        channel) sums of y2 and y2^2 (norm2's moments),
//                        taken from the float32 sums before any rounding.
//
// Replaces the TPU kernels ops/pallas_kernels.py:_conv_act_band_kernel (via
// conv3x3_act), _an_conv1_kernel and _an_conv2_kernel (via
// fused_alignnet_body0). Those blocked the whole (3, 3, 2C, 2C) weight into
// VMEM, which limited them to 2C <= 512, pre-padded s, t and z with XLA
// passes, and accumulated the moments across the sequential band grid. Here
// the weights stream through shared memory in chunks, so 2C = 1024 runs; the
// halo is a masked load; and each block writes the moments of its own tile
// into a (B, n_tiles, 2, Co) scratch that a second, fixed-order pass sums, so
// no atomics are used and every sum runs in the same order on every call and
// in every batch slot.
//
// What bounds it: operations. At the SAMM scales a conv does 2 * 9 * Ci * Co
// flops per pixel (Ci = Co = 256 to 1024) against 4 * (Ci + Co) bytes in
// float32, thousands of flops per byte. The core is the scheme of
// csrc/packed_pair.cu: a block computes an 8 x 16 pixel tile for 128 output
// channels (256 threads; each thread one pixel column of 8 rows times 8
// channels, 64 float32 sums in registers); input channels go through shared
// memory in chunks of 8, the input chunk with its 1-pixel halo and the
// 3 x 3 x 8 x 128 weight chunk; for each (channel, dx) a thread reads the 10
// rows of its column once and reuses them for the three dy taps. Threads of
// a half warp hold neighbouring pixel columns, so NCHW loads and stores are
// contiguous along W. This is the simple version: CUDA cores, no tensor
// cores (wgmma), no asynchronous copies. Operands may be bfloat16; shared
// memory and all sums are float32.
//
// Plain C interface (bound with ctypes): launches on the given stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;        // output tile rows
constexpr int TW = 16;       // output tile columns: one half warp
constexpr int TN = 128;      // output channels per block
constexpr int KC = 8;        // input channels per shared-memory chunk
constexpr int THREADS = 256;
constexpr float SQRT2 = 1.41421356237309515f;
static_assert(TW == 16 && THREADS == TW * (TN / 8), "thread layout");

enum Mode { CONV = 0, CONV1 = 1, CONV2 = 2 };
enum Act { ACT_NONE = 0, ACT_PRELU = 1, ACT_LRELU = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Args {
  const void* x;          // CONV, CONV2: input (B, Ci, H, W); CONV1: s (B, Ci/2, H, W)
  const void* t;          // CONV1: t (B, Ci/2, H, W)
  const float* coeffs;    // CONV1: (B, 5, Ci/2) [as, at, b1, ct, b2]
  const void* k;          // (Co, Ci, 3, 3)
  const float* alpha;     // (Co,) PReLU slopes (CONV with ACT_PRELU, CONV1)
  void* out;              // (B, Co, H, W): x's type; float32 for CONV2
  float* tile_part;       // CONV2: (B, n_tiles, 2, Co)
  int H, W, Ci, Co, act, tiles_w, n_tiles;
};

// Block (pixel tile, channel block, sample). Thread tid: tm = tid % 16 is
// the tile column it computes, all TH rows of it; tn = tid / 16 owns the
// channels n0 + tn*4 + {0..3} and n0 + 64 + tn*4 + {0..3}.
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS, 2) conv_kernel(const Args a) {
  __shared__ float xs[KC][TH + 2][TW + 2];
  __shared__ __align__(16) float ws[9][KC][TN];

  const int tid = threadIdx.x;
  const int tm = tid % TW, tn = tid / TW;
  const int b = blockIdx.z;
  const int tile = blockIdx.x;
  const int y0 = (tile / a.tiles_w) * TH;
  const int x0 = (tile % a.tiles_w) * TW;
  const int n0 = blockIdx.y * TN;
  const int H = a.H, W = a.W, Ci = a.Ci, Co = a.Co;
  const T* x = static_cast<const T*>(a.x);
  const T* k = static_cast<const T*>(a.k);

  float acc[TH][8];
#pragma unroll
  for (int r = 0; r < TH; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  for (int c0 = 0; c0 < Ci; c0 += KC) {
    // the input chunk over the tile and its 1-pixel halo; 0 outside the image
    for (int e = tid; e < KC * (TH + 2) * (TW + 2); e += THREADS) {
      const int c = e % (TW + 2), r = (e / (TW + 2)) % (TH + 2);
      const int kc = e / ((TW + 2) * (TH + 2));
      const int gy = y0 + r - 1, gx = x0 + c - 1, ci = c0 + kc;
      float v = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && ci < Ci) {
        if (MODE == CONV1) {
          const int C = Ci / 2;
          const T* t = static_cast<const T*>(a.t);
          const float* cf = a.coeffs + (int64_t)b * 5 * C;
          const int cc = ci < C ? ci : ci - C;
          const int64_t i = (((int64_t)b * C + cc) * H + gy) * W + gx;
          if (ci < C)
            v = to_f(x[i]) * cf[cc] + to_f(t[i]) * cf[C + cc] + cf[2 * C + cc];
          else
            v = to_f(t[i]) * cf[3 * C + cc] + cf[4 * C + cc];
          v = to_f(from_f<T>(v));          // x1 in the operand type
        } else {
          v = to_f(x[(((int64_t)b * Ci + ci) * H + gy) * W + gx]);
        }
      }
      xs[kc][r][c] = v;
    }
    // the weight chunk: one thread reads the 9 contiguous taps of a
    // (co, ci) pair; a warp stores 32 neighbouring channels
    for (int p = tid; p < KC * TN; p += THREADS) {
      const int n = p % TN, kc = p / TN;
      const int co = n0 + n, ci = c0 + kc;
      if (co < Co && ci < Ci) {
        const T* kp = k + ((int64_t)co * Ci + ci) * 9;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) ws[tap][kc][n] = to_f(kp[tap]);
      } else {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) ws[tap][kc][n] = 0.0f;
      }
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
          const float4 wa = *reinterpret_cast<const float4*>(&ws[dy * 3 + dx][kc][tn * 4]);
          const float4 wb = *reinterpret_cast<const float4*>(&ws[dy * 3 + dx][kc][64 + tn * 4]);
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

  const int gx = x0 + tm;
  const int act = MODE == CONV1 ? ACT_PRELU : (MODE == CONV2 ? ACT_NONE : a.act);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = n0 + (j / 4) * 64 + tn * 4 + j % 4;
    if (co >= Co || gx >= W) continue;
    const float slope = act == ACT_PRELU ? a.alpha[co] : 0.2f;
#pragma unroll
    for (int r = 0; r < TH; ++r) {
      const int gy = y0 + r;
      if (gy >= H) break;
      float v = acc[r][j];
      if (act != ACT_NONE) v = v >= 0.0f ? v : slope * v;
      if (act == ACT_LRELU) v *= SQRT2;
      const int64_t o = (((int64_t)b * Co + co) * H + gy) * W + gx;
      if (MODE == CONV2) static_cast<float*>(a.out)[o] = v;
      else static_cast<T*>(a.out)[o] = from_f<T>(v);
    }
  }

  if (MODE == CONV2) {
    // the tile's moments: each thread sums its rows in order, then a fixed
    // butterfly over the 16 columns of the half warp; every lane takes part
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int r = 0; r < TH; ++r) {
        if (gx < W && y0 + r < H) {
          s1 += acc[r][j];
          s2 += acc[r][j] * acc[r][j];
        }
      }
#pragma unroll
      for (int m = TW / 2; m >= 1; m >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, m);
        s2 += __shfl_xor_sync(0xffffffffu, s2, m);
      }
      const int co = n0 + (j / 4) * 64 + tn * 4 + j % 4;
      if (tm == 0 && co < Co) {
        float* p = a.tile_part + ((int64_t)b * a.n_tiles + tile) * 2 * Co + co;
        p[0] = s1;
        p[Co] = s2;
      }
    }
  }
}

// part (B, 2, Co) = the tiles' moments summed in tile order.
__global__ void sum_tiles_kernel(const float* __restrict__ tile_part,
                                 float* __restrict__ part, int B, int n_tiles, int Co) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * 2 * Co) return;
  const int co = i % Co, m = (i / Co) % 2, b = i / (2 * Co);
  const float* p = tile_part + ((int64_t)b * n_tiles * 2 + m) * Co + co;
  float s = 0.0f;
  for (int tile = 0; tile < n_tiles; ++tile) s += p[(int64_t)tile * 2 * Co];
  part[i] = s;
}

int tiles_w(int W) { return (W + TW - 1) / TW; }
int n_tiles(int H, int W) { return tiles_w(W) * ((H + TH - 1) / TH); }

template <int MODE>
int launch(Args a, int B, int dtype, cudaStream_t stream) {
  a.tiles_w = tiles_w(a.W);
  a.n_tiles = n_tiles(a.H, a.W);
  const dim3 grid(a.n_tiles, (a.Co + TN - 1) / TN, B);
  if (dtype == 0) conv_kernel<float, MODE><<<grid, THREADS, 0, stream>>>(a);
  else            conv_kernel<__nv_bfloat16, MODE><<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int W, int Ci, int Co, int dtype) {
  return B <= 0 || B > 65535 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// The number of pixel tiles of an (H, W) image: the second axis of the
// moments scratch of ogi_alignnet_conv2.
extern "C" int ogi_samm_conv_tiles(int H, int W) { return n_tiles(H, W); }

// dtype: 0 = float32, 1 = bfloat16 (x, k and out). All tensors contiguous:
// x (B, Ci, H, W), k (Co, Ci, 3, 3), alpha (Co,) float32 (read only for
// act 1), out (B, Co, H, W). act: 0 none, 1 PReLU, 2 lrelu * sqrt(2).
// Returns cudaGetLastError() after the launch (0 = success); 1000 for an
// argument the kernel does not take.
extern "C" int ogi_conv3x3_act(const void* x, const void* k, const void* alpha,
                               void* out, int B, int H, int W, int Ci, int Co,
                               int act, int dtype, void* stream) {
  if (bad_shape(B, H, W, Ci, Co, dtype) || act < 0 || act > 2 ||
      (act == ACT_PRELU && alpha == nullptr))
    return 1000;
  Args a{x, nullptr, nullptr, k, static_cast<const float*>(alpha), out, nullptr,
         H, W, Ci, Co, act, 0, 0};
  return launch<CONV>(a, B, dtype, static_cast<cudaStream_t>(stream));
}

// s, t (B, C, H, W) and k1 (2C, 2C, 3, 3) in dtype; coeffs (B, 5, C) and
// alpha (2C,) float32; z (B, 2C, H, W) in dtype.
extern "C" int ogi_alignnet_conv1(const void* s, const void* t, const void* coeffs,
                                  const void* k1, const void* alpha, void* z,
                                  int B, int H, int W, int C, int dtype, void* stream) {
  if (bad_shape(B, H, W, C, C, dtype) || alpha == nullptr) return 1000;
  Args a{s, t, static_cast<const float*>(coeffs), k1, static_cast<const float*>(alpha),
         z, nullptr, H, W, 2 * C, 2 * C, ACT_PRELU, 0, 0};
  return launch<CONV1>(a, B, dtype, static_cast<cudaStream_t>(stream));
}

// z (B, C2, H, W) and k2 (C2, C2, 3, 3) in dtype; y2 (B, C2, H, W) float32;
// tile_part (B, ogi_samm_conv_tiles(H, W), 2, C2) float32 scratch; part
// (B, 2, C2) float32: [sum y2, sum y2^2] over H, W.
extern "C" int ogi_alignnet_conv2(const void* z, const void* k2, void* y2,
                                  void* tile_part, void* part, int B, int H, int W,
                                  int C2, int dtype, void* stream) {
  if (bad_shape(B, H, W, C2, C2, dtype)) return 1000;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{z, nullptr, nullptr, k2, nullptr, y2, static_cast<float*>(tile_part),
         H, W, C2, C2, ACT_NONE, 0, 0};
  const int err = launch<CONV2>(a, B, dtype, st);
  if (err != 0) return err;
  const int n = B * 2 * C2;
  sum_tiles_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(tile_part), static_cast<float*>(part), B,
      n_tiles(H, W), C2);
  return (int)cudaGetLastError();
}
