// The phase-packed generator stage's convolutions, for Hopper (sm_90a).
//
// B4, a whole packed stage (ogi_packed_stage):
//
//   z   = lrelu(conv3x3(x * s1; k1) * d1 + n1[phase] + b1) * sqrt(2) * s2
//   z2  = lrelu(conv3x3(z; k2) * d2 + n2[phase] + b2) * sqrt(2)
//   rgb = z2 . k3sr[b] + b3 + conv3x3(skip; k4)
//
// B3, one packed conv (ogi_packed_conv3x3_act), B4's conv1 without s2:
//
//   out = lrelu(conv3x3(x * s_in; k) * d_out + noise4[phase] + bias) * sqrt(2)
//
// NHWC x (B, H, W, C1), HWIO k1 (3, 3, C1, C4) and k2 (3, 3, C4, C4), zero
// padding 1 for each conv; n1, n2 (B, H, W, 4) broadcast to C4 = 4 * Cmid
// packed channels by the phase co / Cmid; per-sample s1 (B, C1), d1, b1,
// s2, d2, b2 (B, C4), k3sr (B, C4, 12) (toRGB kernel, style scale folded
// in), b3 (B, 12); k4 (3, 3, 3, 12) the packed skip upsample. Outputs rgb
// (B, H, W, 12) and z2 (B, H, W, C4), both in the operand dtype; B3's out
// (B, H, W, Co) likewise.
//
// Replaces the TPU kernels ops/pallas_kernels.py:_stage_band_kernel (called
// by fused_packed_stage_pallas / fused_packed_stage) and _conv_band_kernel
// (called by fused_conv3x3_act, twice per fused_packed_pair). Like them,
// x * s1 is rounded to the operand dtype before conv1 (s1 rounded first),
// conv1's activation z is rounded to it before conv2, and toRGB reads z2 as
// stored. Unlike them, the noise is read at index co / Cmid (no one-hot
// matmul), and any C4 that is a multiple of 4 runs (the TPU stage kernel
// takes multiples of 128 only).
//
// What bounds it: operations. The two convs do 2 * 9 * (C1 + C4) * C4
// flops per pixel against a few hundred bytes. Both run on the tensor
// cores, in this order (B3 is the first alone, with no s2):
//   1. conv1: z, as conv2's operand, to a scratch. Keeping z on chip
//      instead would recompute conv1 on each tile's halo (1.56x its work at
//      8 x 8 tiles) and cap C4 by shared memory.
//   2. conv2: reads z (the zeros outside the image are conv2's padding),
//      writes z2, and sums each pixel's toRGB partial over the block's 128
//      channels in channel order into a (B, n_cblocks, H, W, 12) float32
//      scratch.
//   3. rgb_kernel: the channel blocks' partials added in order, then b3 and
//      the 3 -> 12 skip conv.
// Every sum runs in a fixed order without atomics, and the grid and tiling
// depend on (H, W, C4) only, so a sample's outputs are the same bits in any
// batch slot.
//
// B4 and B3, in both operand types, run their convs on the TMA core of
// tma_conv.cuh (its notes say how), after one repack launch
// (stage_repack_kernel), elementwise since x is NHWC already:
//   * float32: x * s1 in float32 (s1 as given, one product, as the plain
//     version rounds it), split into hi and lo words, channels padded to a
//     multiple of 16; the weights from HWIO into the core's (3 [dx], 3 [dy],
//     Co, 2 Cp) words. The convs run 3xTF32 on the words, draining every
//     TF32_DRAIN_STAGES.
//   * bfloat16: x * s1 with s1 rounded to bfloat16 first and the product
//     rounded once, channels padded with zeros to a multiple of 8; the
//     weights into (3, 3, Co, Cp). The convs accumulate in the tensor cores
//     over the whole K (outputs rounded to bfloat16, held to 2^-7).
// B4's conv1 (STAGE1_TF32, STAGE1) writes z straight as conv2's operand --
// words (B, H, W, 2 Cp4) or bfloat16 (B, H, W, Cp4), the channels past C4
// zero (uninitialised pad words could hold NaN) -- so conv2 (STAGE2_TF32,
// STAGE2) reads it through TMA with no pass between; TMA's zero fill is
// conv2's padding. B3 (PACKED_TF32, PACKED) is the same repack with no k2,
// then conv1 writing its output in the operand type, so fused_packed_pair's
// second call repacks conv1's output times s2, as the plain version rounds
// it (s2 is not folded into conv1's epilogue: that single rounding of a *
// s2 is B4's function, not the pair's). ops/packed_conv.py:
// stage_input_words, stage_weight_words and stage_z_words are the plain
// versions of the operands in both types.
//
// Plain C interface (bound with ctypes): launches on the given stream and
// returns cudaGetLastError().

#include "tma_conv.cuh"

#include <type_traits>

namespace {

using tma::from_f;
using tma::to_f;
using BF = __nv_bfloat16;

// ------------------------------------------------------------- the rgb pass

// rgb = the toRGB partials of the channel blocks, added in order, + b3 + the
// packed skip upsample (3 -> 12, 3x3, zero padding); one thread per output.
template <typename T>
__global__ void rgb_kernel(const float* __restrict__ part, const T* __restrict__ skip,
                           const float* __restrict__ b3, const T* __restrict__ k4,
                           T* __restrict__ rgb, int B, int H, int W, int n_cblocks) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * H * W * 12) return;
  const int o = (int)(i % 12);
  const int64_t p = i / 12;
  const int gx = (int)(p % W), gy = (int)((p / W) % H), b = (int)(p / ((int64_t)H * W));
  float v = 0.0f;
  for (int cb = 0; cb < n_cblocks; ++cb)
    v += part[((((int64_t)b * n_cblocks + cb) * H + gy) * W + gx) * 12 + o];
  v += b3[b * 12 + o];
  for (int dy = 0; dy < 3; ++dy) {
    const int sy = gy + dy - 1;
    if (sy < 0 || sy >= H) continue;
    for (int dx = 0; dx < 3; ++dx) {
      const int sx = gx + dx - 1;
      if (sx < 0 || sx >= W) continue;
      const T* sp = skip + (((int64_t)b * H + sy) * W + sx) * 3;
      const T* kp = k4 + (dy * 3 + dx) * 36 + o;
      v += to_f(sp[0]) * to_f(kp[0]) + to_f(sp[1]) * to_f(kp[12]) + to_f(sp[2]) * to_f(kp[24]);
    }
  }
  rgb[i] = from_f<T>(v);
}

int n_cblocks(int C4) { return (C4 + tma::BM - 1) / tma::BM; }

// the operand pointers of a stage call, in the order of ogi_packed_stage
enum StageArg { X, N1, N2, SKIP, K1, S1, D1, B1, K2, S2, D2, B2, K3SR, B3, K4, RGB, Z2, Z, PART,
                XR, W1R, W2R, N_STAGE_ARGS };

// rgb_kernel on a stage call's pointers p
template <typename T>
int launch_rgb(const void* const* p, int B, int H, int W, int C4, cudaStream_t stream) {
  const int64_t n = (int64_t)B * H * W * 12;
  rgb_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(p[PART]), static_cast<const T*>(p[SKIP]),
      static_cast<const float*>(p[B3]), static_cast<const T*>(p[K4]),
      static_cast<T*>(const_cast<void*>(p[RGB])), B, H, W, n_cblocks(C4));
  return (int)cudaGetLastError();
}

// ---------------------------------------------- the repack of the TMA convs

// E = float (3xTF32 words) or BF (bfloat16): the x channels a thread of the
// repack takes, and the input channels of a weight block
template <typename E> constexpr bool WORDS = std::is_same<E, float>::value;
template <typename E> constexpr int XVEC = WORDS<E> ? 4 : 8;
template <typename E> constexpr int WGROUP = WORDS<E> ? tma::TF32_GROUP : 32;
// the TMA modes of B4's convs on E
template <typename E> constexpr int MODE1 = WORDS<E> ? tma::STAGE1_TF32 : tma::STAGE1;
template <typename E> constexpr int MODE2 = WORDS<E> ? tma::STAGE2_TF32 : tma::STAGE2;
// and of B3's conv
template <typename E> constexpr int MODE_B3 = WORDS<E> ? tma::PACKED_TF32 : tma::PACKED;

// 8 bfloat16 values (16 bytes), each multiplied by s[i] and rounded to
// bfloat16: x * s1 as the plain version computes it (s already rounded)
__device__ __forceinline__ uint32_t scale2(uint32_t w, float s0, float s1) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w);
  const __nv_bfloat162 p = __floats2bfloat162_rn(__low2float(v) * s0, __high2float(v) * s1);
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ uint4 scale16(uint4 q, const float* s) {
  return make_uint4(scale2(q.x, s[0], s[1]), scale2(q.y, s[2], s[3]),
                    scale2(q.z, s[4], s[5]), scale2(q.w, s[6], s[7]));
}

// The repack ahead of the TMA convs, one launch. Blocks [0, xblocks): xr,
// conv1's input x * s1 as the core's operand, a thread per XVEC<E>
// channels of a pixel: float32, the product's hi and lo words (B, H, W, 2
// Cp1), two 16-byte stores; bfloat16, the product rounded once (B, H, W,
// Cp1), one 16-byte store; the channels past C1 zero. The next w1blocks
// blocks, then the rest (B4 only: B3 has no k2): k1 and k2 (HWIO (3 [dy], 3
// [dx], Ci, C4)) into w1r and w2r ((3 [dx], 3 [dy], C4, Cp) in the
// operand's layout), a block per (tap, WGROUP<E> input channels, 32 output
// channels), transposed through shared memory so that reads run along co
// and writes along the input channels.
template <typename E> struct StageRepack {
  const E* x;
  const float* s1;
  const E *k1, *k2;
  E *xr, *w1r, *w2r;
  int64_t items;          // B * H * W * Cp1 / XVEC<E>
  int HW, C1, C4, Cp1, Cp4, xblocks, w1blocks;
  bool vec;               // x and s1 read XVEC<E> channels at a time (C1 % XVEC<E> == 0, aligned)
};

// blocks of the weight layout of a (Ci -> Co) kernel, Cp = Ci padded
template <typename E> int weight_blocks(int Cp, int Co) {
  return 9 * ((Cp + WGROUP<E> - 1) / WGROUP<E>) * ((Co + 31) / 32);
}

template <typename E>
__device__ __forceinline__ void weight_layout(const E* k, E* wr, int Ci, int Co, int Cp, int j,
                                              float (*sm)[33]) {
  constexpr int G = WGROUP<E>;
  const int nco = (Co + 31) / 32, ng = (Cp + G - 1) / G;
  const int co0 = j % nco * 32, ci0 = j / nco % ng * G, tap = j / (nco * ng);
  const int dx = tap / 3, dy = tap % 3;            // wr's tap dx * 3 + dy is k's dy * 3 + dx
  const E* src = k + (int64_t)(dy * 3 + dx) * Ci * Co;
  for (int e = threadIdx.x; e < G * 32; e += 256) {
    const int r = e / 32, ci = ci0 + r, co = co0 + e % 32;
    sm[r][e % 32] = ci < Ci && co < Co ? to_f(src[(int64_t)ci * Co + co]) : 0.0f;
  }
  __syncthreads();
  if constexpr (WORDS<E>) {
    // the group's 32 words start at word 2 ci0 of a row
    float* dst = wr + (int64_t)tap * Co * 2 * Cp + 2 * ci0;
    for (int e = threadIdx.x; e < 32 * 2 * G; e += 256) {
      const int c = e / (2 * G), wd = e % (2 * G);
      if (co0 + c < Co)
        dst[(int64_t)(co0 + c) * 2 * Cp + wd] = tma::tf32_word(sm[wd % G][c], wd);
    }
  } else {
    BF* dst = wr + (int64_t)tap * Co * Cp + ci0;
    for (int e = threadIdx.x; e < 32 * G; e += 256) {
      const int c = e / G, i = e % G;
      if (co0 + c < Co && ci0 + i < Cp)
        dst[(int64_t)(co0 + c) * Cp + i] = __float2bfloat16_rn(sm[i][c]);   // exact
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(256) stage_repack_kernel(const StageRepack<E> r) {
  __shared__ float sm[32][33];
  const int blk = blockIdx.x;
  if (blk >= r.xblocks) {
    if (blk < r.xblocks + r.w1blocks)
      weight_layout<E>(r.k1, r.w1r, r.C1, r.C4, r.Cp1, blk - r.xblocks, sm);
    else
      weight_layout<E>(r.k2, r.w2r, r.C4, r.C4, r.Cp4, blk - r.xblocks - r.w1blocks, sm);
    return;
  }
  constexpr int V = XVEC<E>;
  const int64_t idx = (int64_t)blk * 256 + threadIdx.x;
  if (idx >= r.items) return;
  const int64_t pix = idx / (r.Cp1 / V);
  const int c = (int)(idx % (r.Cp1 / V)) * V, b = (int)(pix / r.HW);
  const E* xp = r.x + pix * r.C1 + c;
  const float* sp = r.s1 + (int64_t)b * r.C1 + c;
  if constexpr (WORDS<E>) {
    float v[4];
    if (r.vec && c < r.C1) {
      const float4 x4 = *reinterpret_cast<const float4*>(xp);
      const float4 s4 = *reinterpret_cast<const float4*>(sp);
      v[0] = __fmul_rn(x4.x, s4.x);
      v[1] = __fmul_rn(x4.y, s4.y);
      v[2] = __fmul_rn(x4.z, s4.z);
      v[3] = __fmul_rn(x4.w, s4.w);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = c + u < r.C1 ? __fmul_rn(xp[u], sp[u]) : 0.0f;
    }
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) tma::split_tf32(v[u], hi[u], lo[u]);
    float* o = r.xr + pix * 2 * r.Cp1 + c / tma::TF32_GROUP * 2 * tma::TF32_GROUP +
               c % tma::TF32_GROUP;
    *reinterpret_cast<uint4*>(o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(o + tma::TF32_GROUP) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  } else {
    // s1 rounded to bfloat16, then the product (exact in float32) rounded
    float s[8];
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (r.vec && c < r.C1) {
      const float4 sa = *reinterpret_cast<const float4*>(sp);
      const float4 sb = *reinterpret_cast<const float4*>(sp + 4);
      const float s8[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
#pragma unroll
      for (int u = 0; u < 8; ++u) s[u] = to_f(from_f<BF>(s8[u]));
      q = *reinterpret_cast<const uint4*>(xp);
    } else {
      uint32_t wd[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t lo = c + 2 * u < r.C1 ? __bfloat16_as_ushort(xp[2 * u]) : 0u;
        const uint32_t hi = c + 2 * u + 1 < r.C1 ? __bfloat16_as_ushort(xp[2 * u + 1]) : 0u;
        wd[u] = lo | hi << 16;
      }
      q = make_uint4(wd[0], wd[1], wd[2], wd[3]);
#pragma unroll
      for (int u = 0; u < 8; ++u) s[u] = c + u < r.C1 ? to_f(from_f<BF>(sp[u])) : 0.0f;
    }
    *reinterpret_cast<uint4*>(r.xr + pix * r.Cp1 + c) = scale16(q, s);
  }
}

// The repack of x (B, H, W, C1) times s1 (B, C1) and k1 (3, 3, C1, C4), k2
// (3, 3, C4, C4) (null for B3) into xr, w1r, w2r, all in E's layout
template <typename E>
int stage_repack(const void* x, const void* s1, const void* k1, const void* k2, void* xr,
                 void* w1r, void* w2r, int B, int H, int W, int C1, int C4,
                 cudaStream_t stream) {
  const int Cp1 = tma::padded_channels<MODE1<E>>(C1), Cp4 = tma::padded_channels<MODE1<E>>(C4);
  StageRepack<E> r{static_cast<const E*>(x), static_cast<const float*>(s1),
                   static_cast<const E*>(k1), static_cast<const E*>(k2), static_cast<E*>(xr),
                   static_cast<E*>(w1r), static_cast<E*>(w2r),
                   (int64_t)B * H * W * (Cp1 / XVEC<E>), H * W, C1, C4, Cp1, Cp4, 0,
                   weight_blocks<E>(Cp1, C4), false};
  r.xblocks = (int)((r.items + 255) / 256);
  r.vec = C1 % XVEC<E> == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(s1) % 16 == 0;
  const int64_t blocks = (int64_t)r.xblocks + r.w1blocks + (k2 ? weight_blocks<E>(Cp4, C4) : 0);
  if (blocks > 0x7fffffff) return 1000;
  stage_repack_kernel<E><<<(unsigned)blocks, 256, 0, stream>>>(r);
  return (int)cudaGetLastError();
}

// ----------------------------------------------- B4 and B3 on the TMA core

// the steps of B4
enum Step { STEP_REPACK = 0, STEP_CONV1 = 1, STEP_CONV2 = 2, STEP_RGB = 3 };

// Step `step` of B4 on operands of type E (p as ogi_packed_stage's: z the
// conv1 operand scratch, xr, w1r, w2r the repack's)
template <typename E>
int stage_step(const void* const* p, int B, int H, int W, int C1, int C4, int step,
               cudaStream_t stream) {
  auto F_ = [&](int i) { return static_cast<const float*>(p[i]); };
  auto M_ = [&](int i) { return const_cast<void*>(p[i]); };
  constexpr int PER_CHANNEL = WORDS<E> ? 2 : 1;   // K elements per channel
  if (step == STEP_REPACK)
    return stage_repack<E>(p[X], p[S1], p[K1], p[K2], M_(XR), M_(W1R), M_(W2R), B, H, W, C1, C4,
                           stream);
  if (step == STEP_CONV1 || step == STEP_CONV2) {
    const bool one = step == STEP_CONV1;
    const int Cp4 = tma::padded_channels<MODE1<E>>(C4);
    tma::Args a{nullptr, M_(one ? Z : Z2), nullptr, H, W, C4, tma::ACT_NONE, 0, 0, 0,
                F_(one ? N1 : N2), F_(one ? D1 : D2), F_(one ? B1 : B2), one ? F_(S2) : nullptr,
                one ? nullptr : p[K3SR], one ? nullptr : static_cast<float*>(M_(PART)), Cp4};
    const void* xr = one ? p[XR] : p[Z];
    const void* wr = one ? p[W1R] : p[W2R];
    if (tma::bad_args(a, B, one ? C1 : C4, xr, wr)) return 1000;
    return one ? tma::conv_tiles<MODE1<E>>(
                     xr, wr, a, B, PER_CHANNEL * tma::padded_channels<MODE1<E>>(C1), stream)
               : tma::conv_tiles<MODE2<E>>(xr, wr, a, B, PER_CHANNEL * Cp4, stream);
  }
  if (step == STEP_RGB) return launch_rgb<E>(p, B, H, W, C4, stream);
  return 1000;
}

int stage_step_of(const void* const* p, int B, int H, int W, int C1, int C4, int dtype, int step,
                  cudaStream_t stream) {
  return dtype == 0 ? stage_step<float>(p, B, H, W, C1, C4, step, stream)
                    : stage_step<BF>(p, B, H, W, C1, C4, step, stream);
}

bool bad_stage(const void* const* p, int B, int H, int W, int C1, int C4, int dtype) {
  return B <= 0 || B > 65535 || H <= 0 || W <= 0 || C1 <= 0 || C4 <= 0 || C4 % 4 != 0 ||
         (dtype != 0 && dtype != 1) || !p[Z] || !p[XR] || !p[W1R] || !p[W2R];
}

// Step `step` of B3 on operands of type E: 0 the repack of x * s_in and k
// into xr (B, H, W, K) and wr (3, 3, Co, K), K = 2 Cp words (float32) or Cp
// (bfloat16), 1 the conv (PACKED_TF32, PACKED) into out
template <typename E>
int packed_conv_step(const void* x, const void* noise4, const void* k, const void* s_in,
                     const void* d_out, const void* bias, void* out, void* xr, void* wr, int B,
                     int H, int W, int Ci, int Co, int step, cudaStream_t stream) {
  if (step == 0)
    return stage_repack<E>(x, s_in, k, nullptr, xr, wr, nullptr, B, H, W, Ci, Co, stream);
  if (step != 1) return 1000;
  auto F_ = [](const void* v) { return static_cast<const float*>(v); };
  tma::Args a{nullptr, out, nullptr, H, W, Co, tma::ACT_NONE, 0, 0, 0, F_(noise4), F_(d_out),
              F_(bias), nullptr, nullptr, nullptr, 0};
  if (tma::bad_args(a, B, Ci, xr, wr)) return 1000;
  constexpr int PER_CHANNEL = WORDS<E> ? 2 : 1;   // K elements per channel
  return tma::conv_tiles<MODE_B3<E>>(
      xr, wr, a, B, PER_CHANNEL * tma::padded_channels<MODE_B3<E>>(Ci), stream);
}

int packed_conv_step_of(const void* x, const void* noise4, const void* k, const void* s_in,
                        const void* d_out, const void* bias, void* out, void* xr, void* wr, int B,
                        int H, int W, int Ci, int Co, int dtype, int step, cudaStream_t stream) {
  return dtype == 0 ? packed_conv_step<float>(x, noise4, k, s_in, d_out, bias, out, xr, wr, B, H,
                                              W, Ci, Co, step, stream)
                    : packed_conv_step<BF>(x, noise4, k, s_in, d_out, bias, out, xr, wr, B, H, W,
                                           Ci, Co, step, stream);
}

bool bad_conv(int B, int H, int W, int Ci, int Co, int dtype, const void* xr, const void* wr) {
  return B <= 0 || B > 65535 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 || Co % 4 != 0 ||
         (dtype != 0 && dtype != 1) || !xr || !wr;
}

}  // namespace

// The number of 128-channel blocks of ogi_packed_stage at C4 packed
// channels: the second axis of its toRGB scratch.
extern "C" int ogi_packed_stage_cblocks(int C4) { return n_cblocks(C4); }

// dtype: 0 = float32, 1 = bfloat16 (x, skip, k1, k2, k3sr, k4, rgb, z2 and
// the scratch z, xr, w1r, w2r; the rest float32). All tensors contiguous,
// shapes as in the note above; part (B, ogi_packed_stage_cblocks(C4), H, W,
// 12) float32 is scratch, and so are the TMA operands: z, conv1's
// activation as conv2's operand, (B, H, W, 2 Cp4) float32 words or (B, H,
// W, Cp4) bfloat16; xr (B, H, W, 2 Cp1 | Cp1), w1r (3, 3, C4, 2 Cp1 | Cp1)
// and w2r (3, 3, C4, 2 Cp4 | Cp4), Cp1 and Cp4 = C1 and C4 rounded up to a
// multiple of 16 (float32) or 8 (bfloat16). Four launches: the repack,
// conv1, conv2, rgb. Returns 0, a CUDA error, 1000 for an argument the
// kernels do not take, 1001/1002 if a tensor map cannot be encoded.
extern "C" int ogi_packed_stage(const void* x, const void* n1, const void* n2,
                                const void* skip, const void* k1, const void* s1,
                                const void* d1, const void* b1, const void* k2,
                                const void* s2, const void* d2, const void* b2,
                                const void* k3sr, const void* b3, const void* k4,
                                void* rgb, void* z2, void* z, void* part, void* xr, void* w1r,
                                void* w2r, int B, int H, int W, int C1, int C4, int dtype,
                                void* stream) {
  const void* p[N_STAGE_ARGS] = {x, n1, n2, skip, k1, s1, d1, b1, k2, s2, d2, b2,
                                 k3sr, b3, k4, rgb, z2, z, part, xr, w1r, w2r};
  if (bad_stage(p, B, H, W, C1, C4, dtype)) return 1000;
  for (int step = STEP_REPACK; step <= STEP_RGB; ++step) {
    const int err = stage_step_of(p, B, H, W, C1, C4, dtype, step,
                                  static_cast<cudaStream_t>(stream));
    if (err != 0) return err;
  }
  return 0;
}

// One step of ogi_packed_stage (arguments as there): 0 the repack, 1 conv1,
// 2 conv2, 3 the rgb pass; each reads what the steps before it wrote. For
// timing the steps apart.
extern "C" int ogi_packed_stage_step(const void* x, const void* n1, const void* n2,
                                     const void* skip, const void* k1, const void* s1,
                                     const void* d1, const void* b1, const void* k2,
                                     const void* s2, const void* d2, const void* b2,
                                     const void* k3sr, const void* b3, const void* k4,
                                     void* rgb, void* z2, void* z, void* part, void* xr,
                                     void* w1r, void* w2r, int B, int H, int W, int C1, int C4,
                                     int dtype, int step, void* stream) {
  const void* p[N_STAGE_ARGS] = {x, n1, n2, skip, k1, s1, d1, b1, k2, s2, d2, b2,
                                 k3sr, b3, k4, rgb, z2, z, part, xr, w1r, w2r};
  if (bad_stage(p, B, H, W, C1, C4, dtype)) return 1000;
  return stage_step_of(p, B, H, W, C1, C4, dtype, step, static_cast<cudaStream_t>(stream));
}

// B3: one packed conv, conv1 of the stage without s2. dtype: 0 = float32,
// 1 = bfloat16 (x, k, out and the scratch xr, wr). All tensors contiguous:
// x (B, H, W, Ci), noise4 (B, H, W, 4) float32, k (3, 3, Ci, Co), s_in (B,
// Ci), d_out and bias (B, Co) float32, out (B, H, W, Co); the scratch xr
// (B, H, W, 2 Cp | Cp) and wr (3, 3, Co, 2 Cp | Cp), Cp = Ci rounded up to
// a multiple of 16 (float32) or 8 (bfloat16). Two launches: the repack,
// then the conv on the TMA core. Returns 0, a CUDA error, 1000 for an
// argument the kernels do not take, 1001/1002 if a tensor map cannot be
// encoded.
extern "C" int ogi_packed_conv3x3_act(const void* x, const void* noise4, const void* k,
                                      const void* s_in, const void* d_out, const void* bias,
                                      void* out, void* xr, void* wr, int B, int H, int W, int Ci,
                                      int Co, int dtype, void* stream) {
  if (bad_conv(B, H, W, Ci, Co, dtype, xr, wr)) return 1000;
  for (int step = 0; step < 2; ++step) {
    const int err = packed_conv_step_of(x, noise4, k, s_in, d_out, bias, out, xr, wr, B, H, W,
                                        Ci, Co, dtype, step, static_cast<cudaStream_t>(stream));
    if (err != 0) return err;
  }
  return 0;
}

// One step of ogi_packed_conv3x3_act (arguments as there): 0 the repack, 1
// the conv, which reads what the repack wrote. For timing the steps apart.
extern "C" int ogi_packed_conv3x3_act_step(const void* x, const void* noise4, const void* k,
                                           const void* s_in, const void* d_out, const void* bias,
                                           void* out, void* xr, void* wr, int B, int H, int W,
                                           int Ci, int Co, int dtype, int step, void* stream) {
  if (bad_conv(B, H, W, Ci, Co, dtype, xr, wr)) return 1000;
  return packed_conv_step_of(x, noise4, k, s_in, d_out, bias, out, xr, wr, B, H, W, Ci, Co, dtype,
                             step, static_cast<cudaStream_t>(stream));
}
