// SAMM warp-blend for Hopper (sm_90a):
//
//   out = bilinear(target, grid) * alpha + target * (1 - alpha)
//
// bilinear() is torch grid_sample with align_corners=False and zero padding:
// fx = ((gx + 1) * W - 1) / 2, fy = ((gy + 1) * H - 1) / 2, four taps at
// floor(f) and floor(f) + 1, a tap outside the image reads 0.
//
// Replaces the TPU kernel ops/pallas_warp.py:_warp_kernel (and its variants
// _v2/_v3/_v4, which compute the same function). That kernel turns the
// gather into MXU matmuls over a +-P row window because the TPU's gather is
// slow; it relies on the flow bound max_disp_px. On Hopper a gather is an
// ordinary load, so this kernel reads the four taps directly and masks each
// one: the result does not depend on any bound on the flow.
//
// What bounds it: memory. Per output element it does ~12 flops and moves at
// least 8 bytes (read target, write out), plus 12 bytes per pixel of grid
// and alpha -- far below the card's ~20 flops/byte fp32 balance point. On
// an H100 a launch takes ~1.1x a plain copy of the target at every launch
// shape of the 1024px model (chip_smoke.py times both): what remains over
// the bound is the rate at which HBM serves a copy and a fixed cost per
// launch, not the gather. The design spends as little as it can beside the
// copy:
//   * A block is a strip of 8 pixels of one row times one 512-byte slice of
//     their channels (grid: strips, slices, samples). Each of its 8 warps
//     takes one pixel and each lane one 16-byte vector of the pixel's slice
//     (4 float32 or 8 bfloat16 channels). So a pixel's grid and alpha are
//     read once per warp (a broadcast), and its coordinates and weights
//     computed once per warp instruction. Each warp's work is a chain:
//     grid load -> tap loads -> store. More warps in flight hide more of it,
//     so the kernel is built for 8 blocks (64 warps) per SM; 2-D tiles of
//     two or four pixels per warp and a build without the register cap were
//     slower on the card.
//   * Index math in 32 bits within one sample (H * W * C < 2^31); the
//     sample's base in 64.
//   * Taps and centre through the read-only path (ld.global.nc); the output
//     stored evict-first (st.global.cs), so the stream of `out` does not
//     push out of L2 the target lines that neighbouring strips still gather.
// The coordinate and blend arithmetic is rounded step by step (__fmul_rn,
// __fadd_rn, no fused multiply-add) in the plain version's order, so tap
// positions and weights are the plain version's bit for bit. Every output
// depends on its own pixel's inputs only, so a sample's output is the same
// bits in any batch slot.
//
// The bilinear sample of a bfloat16 target (dtype 1) is computed in
// bfloat16 arithmetic (TAPS_BF16), as its plain version and JAX's XLA
// grid sample compute it on a bfloat16 x: wx, wy, 1 - wx, 1 - wy, each
// weight, each product and each partial sum rounded to bfloat16 (round to
// nearest even), in the plain version's order; then the blend in float32
// (alpha is float32), rounded to bfloat16 once. A third instantiation
// serves the SAMM option samm_gather_bf16 (JAX's
// OGI_GRIDSAMPLE=gather4bf16): a float32 target and output, each tap
// rounded to bfloat16 and the same bfloat16 sample, then the float32 blend
// with the unrounded centre. Both are their plain versions bit for bit.
//
// Plain C interface (bound with ctypes): launches on the given stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// a block: a strip of PIXELS pixels of one row, one per warp, times a slice
// of SLICE 16-byte vectors of their channels, one per lane; ptxas is asked
// to fit 8 blocks (64 warps, 32 registers a thread) on an SM
constexpr int PIXELS = 8, THREADS = 32 * PIXELS, MIN_BLOCKS = 8;
constexpr int SLICE = 32;

// N values of T: one 16-byte vector (N = 16 / sizeof(T)) or one element
// (N = 1). load() reads the raw bits at p through the read-only path, at()
// gives value i as float32, store() rounds N floats to T and stores them
// evict-first. Raw bits keep a bfloat16 tap in half the registers.
template <typename T, int N> struct Vec;

__device__ __forceinline__ uint32_t word(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <> struct Vec<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ float at(const Raw& q, int i) { return __uint_as_float(word(q, i)); }
  static __device__ __forceinline__ void store(float* p, const float v[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <> struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ float at(const Raw& q, int i) {
    const uint32_t w = word(q, i >> 1);
    return __uint_as_float(i & 1 ? w & 0xffff0000u : w << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float v[8]) {
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                                                pack2(v[4], v[5]), pack2(v[6], v[7])));
  }
};

template <> struct Vec<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float at(const Raw& q, int) { return q; }
  static __device__ __forceinline__ void store(float* p, const float v[1]) { __stcs(p, v[0]); }
};

template <> struct Vec<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ float at(const Raw& q, int) {
    return __uint_as_float((uint32_t)q << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float v[1]) {
    __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16_rn(v[0])));
  }
};

// v rounded to bfloat16 (nearest even), as a float
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a * b and a + b on two bfloat16 pairs, each result rounded once to
// bfloat16 (nearest even): the plain version's float32 op rounded to
// bfloat16, since a product of two bfloat16 is exact in float32 and so is
// their sum, unless one term lies under 2^-16 of the other, which then
// leaves the bfloat16 result the larger term either way
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Block (strip, slice, sample): warp w takes pixel w of the strip, lane l
// the vector slice * 32 + l of that pixel.
template <typename T, int N, bool TAPS_BF16>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
warp_blend_kernel(const T* __restrict__ target, const float* __restrict__ grid,
                  const float* __restrict__ alpha, T* __restrict__ out, int H, int W,
                  int C, int strips_w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int v = blockIdx.y * SLICE + lane;
  const int y = blockIdx.x / strips_w, x = (blockIdx.x % strips_w) * PIXELS + warp;
  if (v * N >= C || x >= W) return;
  const int64_t first = (int64_t)blockIdx.z * H * W;      // the sample's first pixel
  const T* src = target + first * C + v * N;
  const int pix = y * W + x;
  const float2 g = __ldg(reinterpret_cast<const float2*>(grid) + first + pix);
  const float a = __ldg(alpha + first + pix);
  const float fx = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(g.x, 1.0f), (float)W), -1.0f), 0.5f);
  const float fy = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(g.y, 1.0f), (float)H), -1.0f), 0.5f);
  const float xf = floorf(fx), yf = floorf(fy);
  float wx = __fadd_rn(fx, -xf), wy = __fadd_rn(fy, -yf);
  if (TAPS_BF16) wx = bf16_round(wx), wy = bf16_round(wy);
  float ox = __fadd_rn(1.0f, -wx), oy = __fadd_rn(1.0f, -wy);
  if (TAPS_BF16) ox = bf16_round(ox), oy = bf16_round(oy);
  float w[4] = {__fmul_rn(ox, oy), __fmul_rn(wx, oy), __fmul_rn(ox, wy), __fmul_rn(wx, wy)};
  if (TAPS_BF16)
    for (int t = 0; t < 4; ++t) w[t] = bf16_round(w[t]);
  // which taps lie in the image, without forming x + 1 (xf may be huge)
  const int xi = (int)xf, yi = (int)yf;
  const bool in_x[2] = {xf >= 0.0f && xf < (float)W, xf >= -1.0f && xf < (float)(W - 1)};
  const bool in_y[2] = {yf >= 0.0f && yf < (float)H, yf >= -1.0f && yf < (float)(H - 1)};

  using V = Vec<T, N>;
  typename V::Raw tap[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int dy = t >> 1, dx = t & 1;
    tap[t] = in_y[dy] && in_x[dx] ? V::load(src + ((yi + dy) * W + xi + dx) * C)
                                  : typename V::Raw{};
  }
  const typename V::Raw cen = V::load(src + pix * C);
  const float ia = 1.0f - a;
  float o[N];
  if constexpr (TAPS_BF16 && sizeof(T) == 2 && N == 8) {
    // a bfloat16 target, 8 channels: the bilinear sample a channel pair
    // per instruction, then the float32 blend
    uint32_t w2[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) w2[t] = pack2(w[t], w[t]);     // exact: w is bfloat16
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t s = mul_bf16x2(word(tap[0], q), w2[0]);
#pragma unroll
      for (int t = 1; t < 4; ++t) s = add_bf16x2(s, mul_bf16x2(word(tap[t], q), w2[t]));
      const float s0 = __uint_as_float(s << 16), s1 = __uint_as_float(s & 0xffff0000u);
      o[2 * q] = __fadd_rn(__fmul_rn(s0, a), __fmul_rn(V::at(cen, 2 * q), ia));
      o[2 * q + 1] = __fadd_rn(__fmul_rn(s1, a), __fmul_rn(V::at(cen, 2 * q + 1), ia));
    }
    V::store(out + first * C + v * N + pix * C, o);
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s;
    if (TAPS_BF16) {
      s = bf16_round(__fmul_rn(bf16_round(V::at(tap[0], i)), w[0]));
#pragma unroll
      for (int t = 1; t < 4; ++t)
        s = bf16_round(__fadd_rn(s, bf16_round(__fmul_rn(bf16_round(V::at(tap[t], i)), w[t]))));
    } else {
      s = __fmul_rn(V::at(tap[0], i), w[0]);
      s = __fadd_rn(s, __fmul_rn(V::at(tap[1], i), w[1]));
      s = __fadd_rn(s, __fmul_rn(V::at(tap[2], i), w[2]));
      s = __fadd_rn(s, __fmul_rn(V::at(tap[3], i), w[3]));
    }
    o[i] = __fadd_rn(__fmul_rn(s, a), __fmul_rn(V::at(cen, i), ia));
  }
  V::store(out + first * C + v * N + pix * C, o);
}

template <typename T, int N, bool TAPS_BF16 = false>
void launch(const void* target, const float* grid, const float* alpha, void* out, int B,
            int H, int W, int C, cudaStream_t stream) {
  const int strips_w = (W + PIXELS - 1) / PIXELS;
  const int vectors = C / N;
  const dim3 blocks(strips_w * H, (vectors + SLICE - 1) / SLICE, B);
  warp_blend_kernel<T, N, TAPS_BF16><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(target), grid, alpha, static_cast<T*>(out), H, W, C, strips_w);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (sampled in bfloat16), 2 = float32
// sampled in bfloat16. All
// tensors NHWC-contiguous:
// target/out (B, H, W, C), grid (B, H, W, 2) float32, alpha (B, H, W, 1) float32.
// Returns cudaGetLastError() after the launch (0 = success); 1000 for an
// argument the kernel does not take (B > 65535, H * W * C >= 2^31, or a
// grid not 8-byte aligned: it is read as float2).
extern "C" int ogi_warp_blend(const void* target, const void* grid,
                              const void* alpha, void* out, int B, int H,
                              int W, int C, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 ||
      (int64_t)H * W * C >= ((int64_t)1 << 31) || reinterpret_cast<uintptr_t>(grid) % 8 != 0 ||
      dtype < 0 || dtype > 2)
    return 1000;
  const int esize = dtype == 1 ? 2 : 4, n16 = 16 / esize;
  const bool vec = C % n16 == 0 && reinterpret_cast<uintptr_t>(target) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const float* g = static_cast<const float*>(grid);
  const float* a = static_cast<const float*>(alpha);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vec) launch<float, 4>(target, g, a, out, B, H, W, C, s);
    else     launch<float, 1>(target, g, a, out, B, H, W, C, s);
  } else if (dtype == 2) {
    if (vec) launch<float, 4, true>(target, g, a, out, B, H, W, C, s);
    else     launch<float, 1, true>(target, g, a, out, B, H, W, C, s);
  } else {
    if (vec) launch<__nv_bfloat16, 8, true>(target, g, a, out, B, H, W, C, s);
    else     launch<__nv_bfloat16, 1, true>(target, g, a, out, B, H, W, C, s);
  }
  return (int)cudaGetLastError();
}
