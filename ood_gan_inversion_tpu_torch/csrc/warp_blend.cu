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
// and alpha -- far below the card's ~20 flops/byte fp32 balance point. The
// design therefore spends nothing on arithmetic and everything on access:
// threads run along C (NHWC), each thread owns 4 consecutive channels of
// one pixel so every tap is one 16-byte load and neighbouring threads read
// neighbouring addresses; the taps of a pixel are 2x2 neighbours whose rows
// mostly sit in L2 already. The alpha blend rides in the same pass, so the
// warped feature never goes to device memory.
//
// Plain C interface (bound with ctypes): launches on the given stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T, int VEC> struct Vec;

template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float v[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float v[1]) { v[0] = *p; }
  static __device__ __forceinline__ void store(float* p, const float v[1]) { *p = v[0]; }
};

template <> struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float v[4]) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
    v[0] = fa.x; v[1] = fa.y; v[2] = fb.x; v[3] = fb.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float v[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const uint32_t*>(&a);
    q.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = q;
  }
};

template <> struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float v[1]) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float v[1]) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

// Adds wt * target[y, x, c0:c0+VEC] to acc; a tap outside the image adds 0.
template <typename T, int VEC>
__device__ __forceinline__ void add_tap(const T* img, int y, int x, int H,
                                        int W, int C, float wt, float acc[VEC]) {
  if (x < 0 || x >= W || y < 0 || y >= H) return;
  float v[VEC];
  Vec<T, VEC>::load(img + ((int64_t)y * W + x) * C, v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] += v[i] * wt;
}

// One thread per (pixel, group of VEC channels); consecutive threads take
// consecutive channel groups of the same pixel.
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
warp_blend_kernel(const T* __restrict__ target, const float* __restrict__ grid,
                  const float* __restrict__ alpha, T* __restrict__ out,
                  int H, int W, int C, int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int groups = C / VEC;
  const int64_t pix = t / groups;                 // (b, y, x) flattened
  const int c0 = (int)(t - pix * groups) * VEC;
  const int64_t hw = (int64_t)H * W;
  const int64_t b = pix / hw;

  const float gx = __ldg(grid + 2 * pix);
  const float gy = __ldg(grid + 2 * pix + 1);
  const float a = __ldg(alpha + pix);
  // The coordinate math is rounded step by step (no fused multiply-add), so
  // the tap positions and weights are those of the plain version bit for bit.
  const float fx = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(gx, 1.0f), (float)W), -1.0f), 0.5f);
  const float fy = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(gy, 1.0f), (float)H), -1.0f), 0.5f);
  const float x0f = floorf(fx), y0f = floorf(fy);
  const float wx = __fadd_rn(fx, -x0f), wy = __fadd_rn(fy, -y0f);
  const int x0 = (int)x0f, y0 = (int)y0f;
  const float w00 = __fmul_rn(1.0f - wx, 1.0f - wy);
  const float w01 = __fmul_rn(wx, 1.0f - wy);
  const float w10 = __fmul_rn(1.0f - wx, wy);
  const float w11 = __fmul_rn(wx, wy);

  const T* img = target + b * hw * C + c0;
  float acc[VEC], v[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;

  add_tap<T, VEC>(img, y0, x0, H, W, C, w00, acc);
  add_tap<T, VEC>(img, y0, x0 + 1, H, W, C, w01, acc);
  add_tap<T, VEC>(img, y0 + 1, x0, H, W, C, w10, acc);
  add_tap<T, VEC>(img, y0 + 1, x0 + 1, H, W, C, w11, acc);

  Vec<T, VEC>::load(target + pix * C + c0, v);
  const float ia = 1.0f - a;
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = acc[i] * a + v[i] * ia;
  Vec<T, VEC>::store(out + pix * C + c0, acc);
}

template <typename T, int VEC>
void launch(const void* target, const float* grid, const float* alpha,
            void* out, int B, int H, int W, int C, cudaStream_t stream) {
  const int64_t total = (int64_t)B * H * W * (C / VEC);
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  warp_blend_kernel<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(target), grid, alpha, static_cast<T*>(out),
      H, W, C, total);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. All tensors NHWC-contiguous:
// target/out (B, H, W, C), grid (B, H, W, 2) float32, alpha (B, H, W, 1) float32.
// Returns cudaGetLastError() after the launch (0 = success); 1000 for an
// argument the kernel does not take.
extern "C" int ogi_warp_blend(const void* target, const void* grid,
                              const void* alpha, void* out, int B, int H,
                              int W, int C, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || (dtype != 0 && dtype != 1))
    return 1000;
  const int esize = dtype == 0 ? 4 : 2;
  const bool vec4 = C % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(target) % (4 * esize) == 0 &&
                    reinterpret_cast<uintptr_t>(out) % (4 * esize) == 0;
  const float* g = static_cast<const float*>(grid);
  const float* a = static_cast<const float*>(alpha);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vec4) launch<float, 4>(target, g, a, out, B, H, W, C, s);
    else      launch<float, 1>(target, g, a, out, B, H, W, C, s);
  } else {
    if (vec4) launch<__nv_bfloat16, 4>(target, g, a, out, B, H, W, C, s);
    else      launch<__nv_bfloat16, 1>(target, g, a, out, B, H, W, C, s);
  }
  return (int)cudaGetLastError();
}
