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
// stored. Unlike them, x, z, n1 and skip are read in place with masked
// loads (no padded copies), the noise is read at index co / Cmid (no
// one-hot matmul), and any C4 that is a multiple of 4 runs (the TPU stage
// kernel takes multiples of 128 only).
//
// What bounds it: operations. The two convs do 2 * 9 * (C1 + C4) * C4
// flops per pixel against a few hundred bytes. Both run on the tensor cores
// as the implicit GEMM of tc_conv.cuh (wgmma; 3xTF32 for float32 operands,
// one bf16 pass for bfloat16; each chunk's products in fresh fragments), in
// three launches (B3 is the first alone, with no s_out):
//   1. conv1 (stage_conv_kernel<T, 1>): z, in the operand dtype, to a
//      (B, H, W, C4) scratch. Keeping z on chip instead would recompute
//      conv1 on each tile's halo (1.56x its work at 8 x 8 tiles) and cap C4
//      by shared memory; the round trip costs 2 * H * W * C4 * sizeof(T)
//      bytes, tens of microseconds at the packed stages.
//   2. conv2 (stage_conv_kernel<T, 2>): reads z with masked halo loads (the
//      zeros outside the image are conv2's padding), writes z2, and sums
//      each pixel's toRGB partial over the block's 128 channels in channel
//      order into a (B, n_cblocks, H, W, 12) float32 scratch.
//   3. rgb_kernel: the channel blocks' partials added in order, then b3 and
//      the 3 -> 12 skip conv.
// Every sum runs in a fixed order without atomics, and the grid and tiling
// depend on (H, W, C4) only, so a sample's outputs are the same bits in any
// batch slot.
//
// In NHWC a pixel's KC channels are contiguous, so each 16-byte K half of
// the B layout is one 16-byte load of the input (plain loads where C is not
// a multiple of the half). A chunk's HWIO slab, k[:, :, c0:c0+KC,
// n0:n0+128], is 9 * KC rows of 128 contiguous output channels, copied as
// it lies by cp.async into the ring; the A-fragments are gathered from it
// transposed (row = output channel, k = input channel), at a row stride of
// 136 elements, so that a gather hits all 32 banks.
//
// Plain C interface (bound with ctypes): launches on the given stream and
// returns cudaGetLastError().

#include "tc_conv.cuh"

#include <type_traits>

namespace {

using namespace tc;

using C = Tile<4>;                 // 4 x 32 pixels per block at every shape
constexpr int WSN = TN + 8;        // slab row stride, elements (= 8 words mod 32 in float32)
constexpr int SP = TN + 4;         // staged tile: pixel stride, floats
template <typename T> __host__ __device__ constexpr int slab_elems() { return 9 * Op<T>::KC * WSN; }
template <typename T> __host__ __device__ constexpr int ring_bytes() {
  return NSTAGE * slab_elems<T>() * (int)sizeof(T);
}
// the staged float32 tile (P pixels x SP) and conv2's toRGB weights (TN x 12)
// reuse the ring once the main loop is done
static_assert(C::P * SP * 4 + TN * 12 * 4 <= ring_bytes<float>(), "epilogue fits the ring");
static_assert(C::P * SP * 4 + TN * 12 * 4 <= ring_bytes<__nv_bfloat16>(), "epilogue fits the ring");
// conv1's table of s1 follows the input buffers
template <typename T> __host__ __device__ constexpr int s1_offset() {
  return ring_bytes<T>() + 2 * Op<T>::PLANES * C::PLANE;
}

__device__ __forceinline__ float lrelu(float z) { return (z >= 0.0f ? z : 0.2f * z) * SQRT2; }

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

__device__ __forceinline__ uint32_t scale2(uint32_t w, float s0, float s1) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w);
  return pack_bf16(__float2bfloat16_rn(__low2float(v) * s0),
                   __float2bfloat16_rn(__high2float(v) * s1));
}
// 16 bytes of T values (4 float32 or 8 bfloat16), each multiplied by s[i]
// and rounded to T: x * s1 as the plain version computes it
template <typename T> __device__ __forceinline__ uint4 scale16(uint4 q, const float* s) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(__uint_as_float(q.x) * a.x),
                      __float_as_uint(__uint_as_float(q.y) * a.y),
                      __float_as_uint(__uint_as_float(q.z) * a.z),
                      __float_as_uint(__uint_as_float(q.w) * a.w));
  } else {
    const float4 c = *reinterpret_cast<const float4*>(s + 4);
    return make_uint4(scale2(q.x, a.x, a.y), scale2(q.y, a.z, a.w),
                      scale2(q.z, c.x, c.y), scale2(q.w, c.z, c.w));
  }
}

struct Args {
  const void* x;          // conv1: x (B, H, W, C1); conv2: z (B, H, W, C4)
  const void* k;          // (3, 3, Cin, C4)
  const float* noise;     // n1 or n2 (B, H, W, 4)
  const float* s_in;      // conv1: s1 (B, C1)
  const float* d;         // d1 or d2 (B, C4)
  const float* bias;      // b1 or b2 (B, C4)
  const float* s_out;     // conv1: s2 (B, C4); null for B3
  const void* k3sr;       // conv2: (B, C4, 12)
  void* out;              // conv1: z; conv2: z2 (B, H, W, C4)
  float* part;            // conv2: toRGB partials (B, n_cblocks, H, W, 12)
  int H, W, Cin, Cout, tiles_w;
  int vec;                // bytes per weight copy (16, 8, 4; else plain loads)
  int vec_x;              // 1: the input's 16-byte halves are aligned 16-byte loads
};

// Block (pixel tile, channel block, sample): conv1 (STAGE 1) or conv2
// (STAGE 2) on TN output channels of a 4 x 32 tile; the main loop is
// conv_loop.
template <typename T, int STAGE>
__global__ void __launch_bounds__(THREADS, 1) stage_conv_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int KC = Op<T>::KC, R = C::R, P = C::P, XN = C::XN, TW = C::TW;
  constexpr int ND = C::N / 2;
  constexpr int VE = 16 / (int)sizeof(T);          // channels per K half: one 16-byte vector
  constexpr int NV = 2 * C::XPIX;                  // vectors of the halo chunk
  constexpr int LV = (NV + THREADS - 1) / THREADS;
  T* ws = reinterpret_cast<T*>(smem);
  unsigned char* xs = smem + ring_bytes<T>();
  float* s1s = reinterpret_cast<float*>(smem + s1_offset<T>());   // conv1: s1 rounded to T

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = (warp >> 2) * 64 + (warp & 3) * 16;      // the warp's first channel
  const int b = blockIdx.z, tile = blockIdx.x;
  const int y0 = (tile / a.tiles_w) * R, x0 = (tile % a.tiles_w) * TW;
  const int n0 = blockIdx.y * TN;
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const T* x = static_cast<const T*>(a.x) + (int64_t)b * H * W * Cin;
  const T* k = static_cast<const T*>(a.k);
  const int nchunks = (Cin + KC - 1) / KC;

  if constexpr (STAGE == 1) {
    for (int ci = tid; ci < nchunks * KC; ci += THREADS)
      s1s[ci] = ci < Cin ? to_f(from_f<T>(a.s_in[(int64_t)b * Cin + ci])) : 0.0f;
    __syncthreads();
  }

  // the HWIO slab of `chunk` into ring buffer `stage`: row (tap, kc) is
  // k[tap][c0 + kc][n0 .. n0 + 127], 0 past Cin and Cout
  auto load_w = [&](int chunk, int stage) {
    const int c0 = chunk * KC;
    T* dst = ws + stage * slab_elems<T>();
    auto copies = [&](auto per_row_c) {
      constexpr int PER_ROW = decltype(per_row_c)::value, E_PER = TN / PER_ROW;
#pragma unroll 3
      for (int p = tid; p < 9 * KC * PER_ROW; p += THREADS) {
        const int row = p / PER_ROW, e = (p - row * PER_ROW) * E_PER;
        const int tap = row / KC, ci = c0 + row - tap * KC, co = n0 + e;
        const int valid = ci < Cin ? max(0, min(E_PER, Cout - co)) : 0;
        const T* src = valid ? k + ((int64_t)tap * Cin + ci) * Cout + co : k;
        cp_async(dst + row * WSN + e, src, E_PER * (int)sizeof(T), valid * (int)sizeof(T));
      }
    };
    const int per_row = a.vec >= 4 ? TN * (int)sizeof(T) / a.vec : 0;
    if (per_row == 16) copies(std::integral_constant<int, 16>());
    else if (per_row == 32) copies(std::integral_constant<int, 32>());
    else if (per_row == 64) copies(std::integral_constant<int, 64>());
    else if (per_row == 128) copies(std::integral_constant<int, 128>());
    else {
      for (int p = tid; p < 9 * KC * TN; p += THREADS) {
        const int row = p / TN, e = p - row * TN;
        const int tap = row / KC, ci = c0 + row - tap * KC, co = n0 + e;
        dst[row * WSN + e] = ci < Cin && co < Cout ? k[((int64_t)tap * Cin + ci) * Cout + co]
                                                   : from_f<T>(0.0f);
      }
    }
  };

  // the input chunk with its halo, 16 bytes (one K half of a pixel) per
  // value: vector v is half v % 2 of halo pixel v / 2, so neighbouring
  // lanes read a pixel's two halves (32 contiguous bytes) and store into
  // different banks
  uint4 xr[LV];
  auto fetch_x = [&](int chunk) {
    const int c0 = chunk * KC;
#pragma unroll
    for (int j = 0; j < LV; ++j) {
      const int v = tid + j * THREADS, half = v & 1, pix = v >> 1;
      const int r = pix / XN, c = pix - r * XN;
      const int gy = y0 + r - 1, gx = x0 + c - 1, ci = c0 + half * VE;
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (v < NV && ci < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const T* p = x + ((int64_t)gy * W + gx) * Cin + ci;
        if (a.vec_x) {
          q = __ldg(reinterpret_cast<const uint4*>(p));
        } else {
          uint32_t wd[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if constexpr (sizeof(T) == 4) {
              wd[u] = ci + u < Cin ? __float_as_uint(to_f(p[u])) : 0u;
            } else {
              const uint32_t lo = ci + 2 * u < Cin ? __bfloat16_as_ushort(p[2 * u]) : 0u;
              const uint32_t hi = ci + 2 * u + 1 < Cin ? __bfloat16_as_ushort(p[2 * u + 1]) : 0u;
              wd[u] = lo | hi << 16;
            }
          }
          q = make_uint4(wd[0], wd[1], wd[2], wd[3]);
        }
      }
      xr[j] = q;
    }
  };
  auto put_x = [&](int chunk) {
    unsigned char* base = xs + (chunk & 1) * Op<T>::PLANES * C::PLANE;
#pragma unroll
    for (int j = 0; j < LV; ++j) {
      const int v = tid + j * THREADS, half = v & 1, pix = v >> 1;
      if (v >= NV) continue;
      unsigned char* dst = base + half * C::HALF + pix * 16;
      uint4 q = xr[j];
      if constexpr (STAGE == 1) q = scale16<T>(q, s1s + chunk * KC + half * VE);
      if constexpr (sizeof(T) == 4) {
        uint32_t h[4], l[4];
        split_tf32(__uint_as_float(q.x), h[0], l[0]);
        split_tf32(__uint_as_float(q.y), h[1], l[1]);
        split_tf32(__uint_as_float(q.z), h[2], l[2]);
        split_tf32(__uint_as_float(q.w), h[3], l[3]);
        *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(dst + C::PLANE) = make_uint4(l[0], l[1], l[2], l[3]);
      } else {
        *reinterpret_cast<uint4*>(dst) = q;
      }
    }
    // these generic-proxy stores are read by wgmma through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  // A-fragments from the HWIO slab, transposed: row = output channel (the
  // slab's column), k = input channel (the slab's row within the tap)
  auto frag = [&](int stage, int tap, uint32_t (&w)[4]) {
    const T* wp = ws + stage * slab_elems<T>() + tap * KC * WSN + m0 + gid;
    if constexpr (sizeof(T) == 4) {
      const float* fp = reinterpret_cast<const float*>(wp);
      w[0] = __float_as_uint(fp[tig * WSN]);              // (channel gid, k tig)
      w[1] = __float_as_uint(fp[tig * WSN + 8]);          // (gid + 8, tig)
      w[2] = __float_as_uint(fp[(tig + 4) * WSN]);        // (gid, tig + 4)
      w[3] = __float_as_uint(fp[(tig + 4) * WSN + 8]);    // (gid + 8, tig + 4)
    } else {
      w[0] = pack_bf16(wp[2 * tig * WSN], wp[(2 * tig + 1) * WSN]);
      w[1] = pack_bf16(wp[2 * tig * WSN + 8], wp[(2 * tig + 1) * WSN + 8]);
      w[2] = pack_bf16(wp[(2 * tig + 8) * WSN], wp[(2 * tig + 9) * WSN]);
      w[3] = pack_bf16(wp[(2 * tig + 8) * WSN + 8], wp[(2 * tig + 9) * WSN + 8]);
    }
  };

  float acc[ND];
  conv_loop<T, C>(acc, nchunks, smem_addr(xs), load_w, fetch_x, put_x, frag);

  // epilogue: stage the float32 sums st[pixel][channel] in shared memory
  float* st = reinterpret_cast<float*>(smem);
  float* k3s = st + P * SP;                                 // conv2: k3sr[b, n0 + n, :]
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    // fragment i: channel gid (+8 for i % 4 >= 2), flat pixel f = 8 (i / 4)
    // + 2 tig + i % 2 of the run, row f / 34, column f % 34
    const int n = m0 + gid + ((i >> 1) & 1) * 8;
    const int f = (i >> 2) * 8 + 2 * tig + (i & 1), r = f / XN, c = f % XN;
    if (r < R && c < TW) st[(r * TW + c) * SP + n] = acc[i];
  }
  if constexpr (STAGE == 2) {
    const T* k3 = static_cast<const T*>(a.k3sr) + ((int64_t)b * Cout + n0) * 12;
    for (int e = tid; e < TN * 12; e += THREADS)
      k3s[e] = n0 + e / 12 < Cout ? to_f(k3[e]) : 0.0f;
  }
  __syncthreads();

  // d, noise, bias, lrelu (B4's conv1: and s2), rounded to T and stored: 4
  // channels of a pixel per thread, a warp's stores 128 channels of a pixel
  const int cmid = Cout / 4;
  for (int idx = tid; idx < P * (TN / 4); idx += THREADS) {
    const int px = idx / (TN / 4), co = n0 + (idx % (TN / 4)) * 4;
    const int gy = y0 + px / TW, gx = x0 + px % TW;
    if (co >= Cout || gy >= H || gx >= W) continue;     // Cout % 4 == 0: all 4 or none
    const int64_t pix = ((int64_t)b * H + gy) * W + gx;
    float* sp = st + px * SP + co - n0;
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = co + u;
      float z = lrelu(sp[u] * a.d[b * Cout + c] + a.noise[pix * 4 + c / cmid] + a.bias[b * Cout + c]);
      if constexpr (STAGE == 1) {
        if (a.s_out) z *= a.s_out[b * Cout + c];
      }
      v[u] = to_f(from_f<T>(z));
    }
    store4(static_cast<T*>(a.out) + pix * Cout + co, v);
    if constexpr (STAGE == 2) {
#pragma unroll
      for (int u = 0; u < 4; ++u) sp[u] = v[u];           // toRGB reads z2 as stored
    }
  }
  if constexpr (STAGE == 2) {
    __syncthreads();
    // toRGB partials: per pixel, 6 of the 12 outputs per thread, summed over
    // the block's channels in channel order
    const int nc = min(TN, Cout - n0);
    for (int idx = tid; idx < P * 2; idx += THREADS) {
      const int px = idx >> 1, og = (idx & 1) * 6;
      const int gy = y0 + px / TW, gx = x0 + px % TW;
      if (gy >= H || gx >= W) continue;
      float s[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int n = 0; n < nc; n += 4) {
        const float4 z4 = *reinterpret_cast<const float4*>(st + px * SP + n);
        const float zz[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int o = 0; o < 6; ++o) s[o] += zz[u] * k3s[(n + u) * 12 + og + o];
      }
      float* p = a.part + ((((int64_t)b * gridDim.y + blockIdx.y) * H + gy) * W + gx) * 12 + og;
#pragma unroll
      for (int o = 0; o < 6; ++o) p[o] = s[o];
    }
  }
}

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

int n_cblocks(int C4) { return (C4 + TN - 1) / TN; }

template <typename T, int STAGE>
int launch_conv(Args a, int B, cudaStream_t stream) {
  a.tiles_w = (a.W + C::TW - 1) / C::TW;
  const int n_tiles = a.tiles_w * ((a.H + C::R - 1) / C::R);
  a.vec = copy_width(a.k, (int64_t)a.Cout * sizeof(T), sizeof(T));
  a.vec_x = a.Cin % (16 / (int)sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  const int padded_cin = (a.Cin + Op<T>::KC - 1) / Op<T>::KC * Op<T>::KC;
  const int bytes = s1_offset<T>() + (STAGE == 1 ? padded_cin * 4 : 0);
  if (bytes > SMEM_MAX) return 1000;
  cudaError_t err = cudaFuncSetAttribute(stage_conv_kernel<T, STAGE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, n_cblocks(a.Cout), B);
  stage_conv_kernel<T, STAGE><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* const* p, int B, int H, int W, int C1, int C4, cudaStream_t stream) {
  auto F_ = [&](int i) { return static_cast<const float*>(p[i]); };
  void* z = const_cast<void*>(p[17]);
  float* part = static_cast<float*>(const_cast<void*>(p[18]));
  const Args conv1{p[0], p[4], F_(1), F_(5), F_(6), F_(7), F_(9), nullptr, z, nullptr,
                   H, W, C1, C4, 0, 0, 0};
  int err = launch_conv<T, 1>(conv1, B, stream);
  if (err != 0) return err;
  const Args conv2{z, p[8], F_(2), nullptr, F_(10), F_(11), nullptr, p[12],
                   const_cast<void*>(p[16]), part, H, W, C4, C4, 0, 0, 0};
  err = launch_conv<T, 2>(conv2, B, stream);
  if (err != 0) return err;
  const int64_t n = (int64_t)B * H * W * 12;
  rgb_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, static_cast<const T*>(p[3]), F_(13), static_cast<const T*>(p[14]),
      static_cast<T*>(const_cast<void*>(p[15])), B, H, W, n_cblocks(C4));
  return (int)cudaGetLastError();
}

}  // namespace

// The number of 128-channel blocks of ogi_packed_stage at C4 packed
// channels: the second axis of its toRGB scratch.
extern "C" int ogi_packed_stage_cblocks(int C4) { return n_cblocks(C4); }

// dtype: 0 = float32, 1 = bfloat16 (x, skip, k1, k2, k3sr, k4, rgb, z2, z;
// the rest float32). All tensors contiguous, shapes as in the note above;
// z (B, H, W, C4) and part (B, ogi_packed_stage_cblocks(C4), H, W, 12)
// float32 are scratch. Returns cudaGetLastError() after the launches
// (0 = success); 1000 for an argument the kernels do not take.
extern "C" int ogi_packed_stage(const void* x, const void* n1, const void* n2,
                                const void* skip, const void* k1, const void* s1,
                                const void* d1, const void* b1, const void* k2,
                                const void* s2, const void* d2, const void* b2,
                                const void* k3sr, const void* b3, const void* k4,
                                void* rgb, void* z2, void* z, void* part, int B, int H,
                                int W, int C1, int C4, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C1 <= 0 || C4 <= 0 ||
      C4 % 4 != 0 || (dtype != 0 && dtype != 1))
    return 1000;
  const void* p[19] = {x, n1, n2, skip, k1, s1, d1, b1, k2, s2, d2, b2,
                       k3sr, b3, k4, rgb, z2, z, part};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(p, B, H, W, C1, C4, st)
                    : launch<__nv_bfloat16>(p, B, H, W, C1, C4, st);
}

// B3: one packed conv, conv1 of the stage without s2. dtype: 0 = float32,
// 1 = bfloat16 (x, k and out). All tensors contiguous: x (B, H, W, Ci),
// noise4 (B, H, W, 4) float32, k (3, 3, Ci, Co), s_in (B, Ci), d_out and
// bias (B, Co) float32, out (B, H, W, Co). Returns cudaGetLastError() after
// the launch (0 = success); 1000 for an argument the kernel does not take.
extern "C" int ogi_packed_conv3x3_act(const void* x, const void* noise4, const void* k,
                                      const void* s_in, const void* d_out,
                                      const void* bias, void* out, int B, int H, int W,
                                      int Ci, int Co, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 ||
      Co % 4 != 0 || (dtype != 0 && dtype != 1))
    return 1000;
  auto F_ = [](const void* p) { return static_cast<const float*>(p); };
  const Args a{x, k, F_(noise4), F_(s_in), F_(d_out), F_(bias), nullptr, nullptr, out,
               nullptr, H, W, Ci, Co, 0, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_conv<float, 1>(a, B, st) : launch_conv<__nv_bfloat16, 1>(a, B, st);
}
