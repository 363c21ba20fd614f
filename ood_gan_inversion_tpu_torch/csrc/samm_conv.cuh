// The SAMM AlignNet body0 convolutions, for Hopper (sm_90a): the kernel
// that samm_conv.cu, alignnet_conv1.cu and alignnet_conv2.cu instantiate,
// one source per mode so that nvcc builds them in parallel. Their three
// entry points compute a pad-1 3x3 convolution (NCHW activations, OIHW
// weights, zero padding 1, float32 sums):
//
//   ogi_conv3x3_act      out = act(conv3x3(x, k)), act: none, PReLU or
//                        lrelu * sqrt(2); out in x's type.
//   ogi_alignnet_conv2   y2 = conv3x3(z, k2) in float32, and the per-(b,
//                        channel) sums of y2 and y2^2 (norm2's moments),
//                        taken from the float32 sums before any rounding.
//   ogi_alignnet_conv1   z = prelu(conv3x3(x1, k1)) with
//                        x1 = [as*s + at*t + b1, ct*t + b2] built on chip
//                        from s, t (B, C, H, W) and the five per-(b, c)
//                        coefficients; x1 is 0 outside the image (conv1's
//                        padding applies to x1, not to s and t); z in s's
//                        type.
//
// Replaces the TPU kernels ops/pallas_kernels.py:_conv_act_band_kernel (via
// conv3x3_act), _an_conv2_kernel and _an_conv1_kernel (via
// fused_alignnet_body0). Those blocked the whole (3, 3, 2C, 2C) weight into
// VMEM, which limited them to 2C <= 512, pre-padded their inputs with XLA
// passes, and accumulated the moments across the sequential band grid. Here
// the weights stream through shared memory in chunks, so 2C = 1024 runs; the
// halo is a masked load; and each block writes the moments of its own tile
// into a (B, n_tiles, 2, Co) scratch that a second, fixed-order pass sums, so
// no atomics are used and every sum runs in the same order on every call and
// in every batch slot.
//
// What bounds it: operations. At the SAMM scales a conv does 2 * 9 * Ci * Co
// flops per pixel (Ci = Co = 256 to 1024) against 4 * (Ci + Co) bytes in
// float32, thousands of flops per byte.
//
// This kernel serves their float32 operands; their bfloat16 operands run
// the TMA kernel of tma_conv.cuh (their _tma entry points).
//
// All three run one kernel, tc_conv_kernel, on the tensor cores: the
// implicit GEMM of tc_conv.cuh (wgmma, 3xTF32; each chunk's products in
// fresh fragments), with a template mode for what differs. In OIHW a
// chunk's weight slab k[n0:n0+128, c0:c0+KC, :, :] is 128 rows of KC * 9
// contiguous values, copied as it lies; 16-byte copies where the row
// stride Ci * 9 * 4 bytes allows, else 8 or 4 bytes; rows beyond Co and
// channels beyond Ci are zero-filled. The
// input chunk with its 1-pixel halo is loaded one chunk ahead into
// registers while the current chunk computes, 0 outside the image and
// beyond Ci, then stored in wgmma's B layout.
//
// The modes differ only at the two ends. conv3x3_act and alignnet_conv2 read
// the input chunk as it lies. alignnet_conv1 reads s and t (per-sample
// offset b * C * HW, channel ci mod C) and builds x1 = cs*s + ct*t + cb,
// with (cs, ct, cb) = (as, at, b1) for ci < C and (0, ct, b2) beyond, taken
// per element, so a chunk that straddles the s/t boundary (C not a multiple
// of KC) is right; the coefficients of all 2C channels are loaded into
// shared memory once per block, and a thread reads those of its two
// channels once per chunk. x1 is computed with the plain version's
// roundings (two products, two sums), rounded to the operand type, and set
// to 0 outside the image and beyond 2C, before the float32 split. It is
// built as the chunk is stored, so the loads of s and t stay in flight while
// the chunk's wgmmas are issued.
//
// Grid: (pixel tiles, channel blocks, sample). Tiles of 4 x 32 pixels, with
// the rows halved while one sample's grid has fewer than 128 blocks (nearly
// one per SM): at 32px, 1024 -> 1024, tiles of 2 x 32 pixels and 128
// blocks. The choice depends on H, W and Co only, never on the batch size,
// so every batch slot runs the same sums in the same order.
//
// The epilogue stages the activated float32 tile through shared memory, so
// the NCHW stores run along W (a warp writes a row of 32 pixels), and
// alignnet_conv2 sums each channel's moments over the staged tile in a fixed
// order.

#pragma once

#include "tc_conv.cuh"

#include <type_traits>

namespace {

using namespace tc;

enum Act { ACT_NONE = 0, ACT_PRELU = 1, ACT_LRELU = 2 };
// what an instantiation of tc_conv_kernel computes
enum Mode { CONV_ACT = 0, AN_CONV2 = 1, AN_CONV1 = 2 };

__device__ __forceinline__ float activate(float v, int act, float slope) {
  if (act != ACT_NONE) v = v >= 0.0f ? v : slope * v;
  if (act == ACT_LRELU) v *= SQRT2;
  return v;
}

// x1 = (cs*s + ct*t) + cb with the plain version's roundings; f = (cs, ct, cb, 0)
__device__ __forceinline__ float x1_of(float4 f, float s, float t) {
  return __fadd_rn(__fadd_rn(__fmul_rn(f.x, s), __fmul_rn(f.y, t)), f.z);
}

struct Args {
  const void* x;          // input (B, Ci, H, W); conv1: s (B, Ci/2, H, W)
  const void* t;          // conv1: t (B, Ci/2, H, W)
  const float* coeffs;    // conv1: (B, 5, Ci/2) [as, at, b1, ct, b2]
  const void* k;          // (Co, Ci, 3, 3)
  const float* alpha;     // (Co,) PReLU slopes (ACT_PRELU)
  void* out;              // (B, Co, H, W): x's type; float32 for conv2
  float* tile_part;       // conv2: (B, n_tiles, 2, Co)
  int H, W, Ci, Co, act, tiles_w, n_tiles;
  int vec;                // bytes per weight copy (16, 8 or 4)
};

// The row stride of a weight slab in elements: the slab's KC * 9 values and
// a pad; a multiple of 16 bytes, and = 12 words mod 32, so that an
// A-fragment read, 8 rows x 4 channels at channel stride 9, hits 32 banks.
template <typename T> __host__ __device__ constexpr int slab_stride() { return sizeof(T) == 4 ? 76 : 152; }

template <typename T> __host__ __device__ constexpr int ring_bytes() {
  return NSTAGE * TN * slab_stride<T>() * (int)sizeof(T);
}
// the staged output tile: TN channels x (P + 4) pixels, float32
template <class C> __host__ __device__ constexpr int stage_stride() { return C::P + 4; }
template <typename T, class C> __host__ __device__ constexpr int xs_offset() {
  return ring_bytes<T>() > TN * stage_stride<C>() * 4 ? ring_bytes<T>() : TN * stage_stride<C>() * 4;
}
// conv1's coefficient table follows the input buffers
template <typename T, class C> __host__ __device__ constexpr int cf_offset() {
  return xs_offset<T, C>() + 2 * Op<T>::PLANES * C::PLANE;
}

// Block (pixel tile, channel block, sample); the main loop is conv_loop.
template <typename T, int MODE, class C>
__global__ void __launch_bounds__(THREADS, 1) tc_conv_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int KC = Op<T>::KC, WS = slab_stride<T>(), R = C::R, P = C::P, OS = stage_stride<C>();
  constexpr int XN = C::XN, TW = C::TW, XELEMS = KC * C::XPIX;
  constexpr int LD = (XELEMS + THREADS - 1) / THREADS;   // input values per thread
  constexpr int ND = C::N / 2;                            // accumulators
  constexpr bool CONV1 = MODE == AN_CONV1, CONV2 = MODE == AN_CONV2;
  static_assert(std::is_same<T, float>::value, "bfloat16 operands run tma_conv.cuh");
  static_assert(LD <= 32, "one bit per input value in `inside`");
  T* ws = reinterpret_cast<T*>(smem);
  unsigned char* xs = smem + xs_offset<T, C>();
  float4* cf = reinterpret_cast<float4*>(smem + cf_offset<T, C>());   // conv1: (cs, ct, cb, 0)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = (warp >> 2) * 64 + (warp & 3) * 16;      // the warp's first channel
  const int b = blockIdx.z, tile = blockIdx.x;
  const int y0 = (tile / a.tiles_w) * R, x0 = (tile % a.tiles_w) * TW;
  const int n0 = blockIdx.y * TN;
  const int H = a.H, W = a.W, Ci = a.Ci, Co = a.Co, HW = H * W;
  const int Cs = CONV1 ? Ci / 2 : Ci;                     // channels of each input tensor
  const T* x = static_cast<const T*>(a.x) + (int64_t)b * Cs * HW;
  const T* tx = CONV1 ? static_cast<const T*>(a.t) + (int64_t)b * Cs * HW : nullptr;
  const T* k = static_cast<const T*>(a.k);
  const int nchunks = (Ci + KC - 1) / KC;

  if constexpr (CONV1) {
    const float* co = a.coeffs + (int64_t)b * 5 * Cs;
    for (int ci = tid; ci < nchunks * KC; ci += THREADS) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (ci < Cs) v = make_float4(co[ci], co[Cs + ci], co[2 * Cs + ci], 0.0f);
      else if (ci < Ci) v = make_float4(0.0f, co[3 * Cs + ci - Cs], co[4 * Cs + ci - Cs], 0.0f);
      cf[ci] = v;
    }
    __syncthreads();
  }

  // the weight slab of `chunk` into ring buffer `stage`: TN rows of KC * 9
  // values, as they lie in OIHW
  auto load_w = [&](int chunk, int stage) {
    const int c0 = chunk * KC;
    const int len = min(KC, Ci - c0) * 9;
    T* dst = ws + stage * TN * WS;
    // a row is 18, 36 or 72 copies of 16, 8 or 4 bytes: loops with
    // constant divisors
    auto copies = [&](auto per_row_c) {
      constexpr int PER_ROW = decltype(per_row_c)::value, E_PER = KC * 9 / PER_ROW;
#pragma unroll 4
      for (int p = tid; p < TN * PER_ROW; p += THREADS) {
        const int n = p / PER_ROW, e = (p - n * PER_ROW) * E_PER;
        const int co = n0 + n;
        const int valid = co < Co ? max(0, min(E_PER, len - e)) : 0;
        const T* src = valid ? k + ((int64_t)co * Ci + c0) * 9 + e : k;
        cp_async(dst + n * WS + e, src, E_PER * (int)sizeof(T), valid * (int)sizeof(T));
      }
    };
    const int per_row = KC * 9 * (int)sizeof(T) / a.vec;
    if (per_row == 18) copies(std::integral_constant<int, 18>());
    else if (per_row == 36) copies(std::integral_constant<int, 36>());
    else copies(std::integral_constant<int, 72>());
  };

  // the input chunk with its halo: into registers, then into xs buffer
  // chunk % 2 in the B layout (float32: split into the hi and lo planes)
  // element e: channel q of a 16-byte half fastest, then the pixel, then
  // the half; so a warp stores 128 contiguous bytes
  constexpr int QK = KC / 2;
  static_assert(THREADS % QK == 0, "a thread stores one channel of each K half");
  T xr[CONV1 ? 1 : LD];
  float2 st2[CONV1 ? LD : 1];    // conv1: (s, t) of each value
  uint32_t inside = 0;       // conv1: bit j set where value j lies in the image and below Ci
  auto fetch_x = [&](int chunk) {
    const int c0 = chunk * KC;
    if constexpr (CONV1) inside = 0;
#pragma unroll
    for (int j = 0; j < LD; ++j) {
      const int e = tid + j * THREADS;
      const int q = e % QK, pix = (e / QK) % C::XPIX, kc = e / (QK * C::XPIX) * QK + q;
      const int r = pix / XN, c = pix - r * XN;
      const int gy = y0 + r - 1, gx = x0 + c - 1, ci = c0 + kc;
      const bool in = e < XELEMS && ci < Ci && gy >= 0 && gy < H && gx >= 0 && gx < W;
      if constexpr (CONV1) {
        const int64_t i = (int64_t)(ci < Cs ? ci : ci - Cs) * HW + gy * W + gx;
        const T sv = in && ci < Cs ? x[i] : from_f<T>(0.0f);
        const T tv = in ? tx[i] : from_f<T>(0.0f);
        st2[j] = make_float2(sv, tv);
        inside |= (uint32_t)in << j;
      } else {
        xr[j] = in ? x[(int64_t)ci * HW + gy * W + gx] : from_f<T>(0.0f);
      }
    }
  };
  auto put_x = [&](int chunk) {
    unsigned char* base = xs + (chunk & 1) * Op<T>::PLANES * C::PLANE;
    // conv1: the coefficients of the thread's channel in each K half, read
    // once per chunk (a thread's channel within a half, e % QK, is tid % QK)
    float4 cf0, cf1;
    if constexpr (CONV1) {
      cf0 = cf[chunk * KC + tid % QK];
      cf1 = cf[chunk * KC + QK + tid % QK];
    }
#pragma unroll
    for (int j = 0; j < LD; ++j) {
      const int e = tid + j * THREADS;
      if (e >= XELEMS) continue;
      const int q = e % QK, pix = (e / QK) % C::XPIX, half = e / (QK * C::XPIX);
      unsigned char* dst = base + half * C::HALF + pix * 16 + q * (int)sizeof(T);
      T v;
      if constexpr (CONV1) {
        const float x1 = x1_of(half ? cf1 : cf0, st2[j].x, st2[j].y);
        v = from_f<T>((inside >> j) & 1 ? x1 : 0.0f);
      } else {
        v = xr[j];
      }
      uint32_t hi, lo;
      split_tf32(to_f(v), hi, lo);
      *reinterpret_cast<uint32_t*>(dst) = hi;
      *reinterpret_cast<uint32_t*>(dst + C::PLANE) = lo;
    }
    // these generic-proxy stores are read by wgmma through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  // A-fragments from the OIHW slab: row = channel, k = input channel at
  // stride 9 within the row, the tap's column
  auto frag = [&](int stage, int tap, uint32_t (&w)[4]) {
    const float* fp = ws + stage * TN * WS + (m0 + gid) * WS + tap;
    w[0] = __float_as_uint(fp[tig * 9]);                  // (channel gid, k tig)
    w[1] = __float_as_uint(fp[8 * WS + tig * 9]);         // (gid + 8, tig)
    w[2] = __float_as_uint(fp[(tig + 4) * 9]);            // (gid, tig + 4)
    w[3] = __float_as_uint(fp[8 * WS + (tig + 4) * 9]);   // (gid + 8, tig + 4)
  };

  float acc[ND];
  conv_loop<T, C>(acc, nchunks, smem_addr(xs), load_w, fetch_x, put_x, frag);

  // epilogue: activate, stage the float32 tile st[n][pixel] in shared memory
  float* st = reinterpret_cast<float*>(smem);
  const int act = CONV2 ? ACT_NONE : a.act;
  float slope[2] = {0.2f, 0.2f};
  if (act == ACT_PRELU) {
    slope[0] = n0 + m0 + gid < Co ? a.alpha[n0 + m0 + gid] : 0.0f;
    slope[1] = n0 + m0 + gid + 8 < Co ? a.alpha[n0 + m0 + gid + 8] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    // fragment i: channel gid (+8 for i % 4 >= 2), flat pixel f = 8 (i / 4)
    // + 2 tig + i % 2 of the run, row f / 34, column f % 34
    const int n = m0 + gid + ((i >> 1) & 1) * 8;
    const int f = (i >> 2) * 8 + 2 * tig + (i & 1), r = f / XN, c = f % XN;
    if (r < R && c < TW) st[n * OS + r * TW + c] = activate(acc[i], act, slope[(i >> 1) & 1]);
  }
  __syncthreads();
  for (int idx = tid; idx < TN * P; idx += THREADS) {
    const int n = idx / P, px = idx - n * P;
    const int co = n0 + n, gy = y0 + px / TW, gx = x0 + px % TW;
    if (co >= Co || gy >= H || gx >= W) continue;
    const int64_t o = (((int64_t)b * Co + co) * H + gy) * W + gx;
    const float v = st[n * OS + px];
    if (CONV2) static_cast<float*>(a.out)[o] = v;
    else static_cast<T*>(a.out)[o] = from_f<T>(v);
  }
  if (CONV2) {
    // the tile's moments: one thread per channel, rows then columns in order
    for (int n = tid; n < TN; n += THREADS) {
      const int co = n0 + n;
      if (co >= Co) continue;
      float s1 = 0.0f, s2 = 0.0f;
      for (int r = 0; r < R && y0 + r < H; ++r)
        for (int m = 0; m < TW && x0 + m < W; ++m) {
          const float v = st[n * OS + r * TW + m];
          s1 += v;
          s2 += v * v;
        }
      float* p = a.tile_part + ((int64_t)b * a.n_tiles + tile) * 2 * Co + co;
      p[0] = s1;
      p[Co] = s2;
    }
  }
}

template <typename T, int MODE, class C>
int launch_tc_cfg(Args a, int B, cudaStream_t stream) {
  a.tiles_w = (a.W + C::TW - 1) / C::TW;
  a.n_tiles = a.tiles_w * ((a.H + C::R - 1) / C::R);
  a.vec = copy_width(a.k, (int64_t)a.Ci * 9 * sizeof(T), sizeof(T));
  const int padded_ci = (a.Ci + Op<T>::KC - 1) / Op<T>::KC * Op<T>::KC;
  const int bytes = cf_offset<T, C>() + (MODE == AN_CONV1 ? padded_ci * 16 : 0);
  if (bytes > SMEM_MAX) return 1000;
  cudaError_t err = cudaFuncSetAttribute(tc_conv_kernel<T, MODE, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.n_tiles, (a.Co + TN - 1) / TN, B);
  tc_conv_kernel<T, MODE, C><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int launch_tc_type(Args a, int B, cudaStream_t stream) {
  const int r = tile_rows(a.H, a.W, a.Co);
  if (r == 4) return launch_tc_cfg<T, MODE, Tile<4>>(a, B, stream);
  if (r == 2) return launch_tc_cfg<T, MODE, Tile<2>>(a, B, stream);
  return launch_tc_cfg<T, MODE, Tile<1>>(a, B, stream);
}

// the tensor-core core indexes one sample's input with 32-bit offsets
inline bool bad_shape(int B, int H, int W, int Ci, int Co, int dtype) {
  return B <= 0 || B > 65535 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 ||
         (int64_t)Ci * H * W >= (int64_t)1 << 31 || (dtype != 0 && dtype != 1);
}

}  // namespace
