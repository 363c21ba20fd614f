// The float32 path of B2b, AlignNet body0's second conv, for Hopper
// (sm_90a): the kernel of alignnet_conv2.cu's ogi_alignnet_conv2, y2 =
// conv3x3(z, k2) in float32 (NCHW activations, OIHW weights, zero padding
// 1) and the per-(b, channel) sums of y2 and y2^2 (norm2's moments), taken
// from the float32 sums before any rounding. B5 and B2a, and B2b's bfloat16
// operands, run the TMA kernel of tma_conv.cuh.
//
// Replaces, for float32 operands, the TPU kernel
// ops/pallas_kernels.py:_an_conv2_kernel (via fused_alignnet_body0). It
// blocked the whole (3, 3, 2C, 2C) weight into VMEM, which limited it to 2C
// <= 512, pre-padded its input with an XLA pass, and accumulated the moments
// across the sequential band grid. Here the weights stream through shared
// memory in chunks, so 2C = 1024 runs; the halo is a masked load; and each
// block writes the moments of its own tile into a (B, n_tiles, 2, Co)
// scratch that a second, fixed-order pass sums, so no atomics are used and
// every sum runs in the same order on every call and in every batch slot.
//
// What bounds it: operations. At the SAMM scales the conv does 2 * 9 * Ci *
// Co flops per pixel (Ci = Co = 256 to 1024) against 4 * (Ci + Co) bytes,
// thousands of flops per byte.
//
// It runs the implicit GEMM of tc_conv.cuh (wgmma, 3xTF32; each chunk's
// products in fresh fragments). In OIHW a chunk's weight slab k[n0:n0+128,
// c0:c0+KC, :, :] is 128 rows of KC * 9 contiguous values, copied as it
// lies; 16-byte copies where the row stride Ci * 9 * 4 bytes allows, else 8
// or 4 bytes; rows beyond Co and channels beyond Ci are zero-filled. The
// input chunk with its 1-pixel halo is loaded one chunk ahead into
// registers while the current chunk computes, 0 outside the image and
// beyond Ci, then stored in wgmma's B layout, split into hi and lo.
//
// Grid: (pixel tiles, channel blocks, sample). Tiles of 4 x 32 pixels, with
// the rows halved while one sample's grid has fewer than 128 blocks (nearly
// one per SM): at 32px, 1024 -> 1024, tiles of 2 x 32 pixels and 128
// blocks. The choice depends on H, W and Co only, never on the batch size,
// so every batch slot runs the same sums in the same order.
//
// The epilogue stages the float32 tile through shared memory, so the NCHW
// stores run along W (a warp writes a row of 32 pixels), and sums each
// channel's moments over the staged tile in a fixed order.

#pragma once

#include "tc_conv.cuh"

#include <type_traits>

namespace {

using namespace tc;

struct Args {
  const float* x;         // z (B, Ci, H, W)
  const float* k;         // (Co, Ci, 3, 3)
  float* out;             // y2 (B, Co, H, W)
  float* tile_part;       // (B, n_tiles, 2, Co)
  int H, W, Ci, Co, tiles_w, n_tiles;
  int vec;                // bytes per weight copy (16, 8 or 4)
};

// The row stride of a weight slab in elements: the slab's KC * 9 values and
// a pad; a multiple of 16 bytes, and = 12 words mod 32, so that an
// A-fragment read, 8 rows x 4 channels at channel stride 9, hits 32 banks.
constexpr int WS = 76;
constexpr int RING_BYTES = NSTAGE * TN * WS * 4;
// the staged output tile: TN channels x (P + 4) pixels, float32
template <class C> __host__ __device__ constexpr int stage_stride() { return C::P + 4; }
template <class C> __host__ __device__ constexpr int xs_offset() {
  return RING_BYTES > TN * stage_stride<C>() * 4 ? RING_BYTES : TN * stage_stride<C>() * 4;
}
// the shared memory of a block: the ring (or the staged tile), then the two
// input buffers
template <class C> __host__ __device__ constexpr int smem_bytes() {
  return xs_offset<C>() + 2 * Op<float>::PLANES * C::PLANE;
}

// Block (pixel tile, channel block, sample); the main loop is conv_loop.
template <class C>
__global__ void __launch_bounds__(THREADS, 1) conv2_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int KC = Op<float>::KC, R = C::R, P = C::P, OS = stage_stride<C>();
  constexpr int XN = C::XN, TW = C::TW, XELEMS = KC * C::XPIX;
  constexpr int LD = (XELEMS + THREADS - 1) / THREADS;   // input values per thread
  constexpr int ND = C::N / 2;                            // accumulators
  float* ws = reinterpret_cast<float*>(smem);
  unsigned char* xs = smem + xs_offset<C>();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = (warp >> 2) * 64 + (warp & 3) * 16;      // the warp's first channel
  const int b = blockIdx.z, tile = blockIdx.x;
  const int y0 = (tile / a.tiles_w) * R, x0 = (tile % a.tiles_w) * TW;
  const int n0 = blockIdx.y * TN;
  const int H = a.H, W = a.W, Ci = a.Ci, Co = a.Co, HW = H * W;
  const float* x = a.x + (int64_t)b * Ci * HW;
  const float* k = a.k;
  const int nchunks = (Ci + KC - 1) / KC;

  // the weight slab of `chunk` into ring buffer `stage`: TN rows of KC * 9
  // values, as they lie in OIHW
  auto load_w = [&](int chunk, int stage) {
    const int c0 = chunk * KC;
    const int len = min(KC, Ci - c0) * 9;
    float* dst = ws + stage * TN * WS;
    // a row is 18, 36 or 72 copies of 16, 8 or 4 bytes: loops with
    // constant divisors
    auto copies = [&](auto per_row_c) {
      constexpr int PER_ROW = decltype(per_row_c)::value, E_PER = KC * 9 / PER_ROW;
#pragma unroll 4
      for (int p = tid; p < TN * PER_ROW; p += THREADS) {
        const int n = p / PER_ROW, e = (p - n * PER_ROW) * E_PER;
        const int co = n0 + n;
        const int valid = co < Co ? max(0, min(E_PER, len - e)) : 0;
        const float* src = valid ? k + ((int64_t)co * Ci + c0) * 9 + e : k;
        cp_async(dst + n * WS + e, src, E_PER * (int)sizeof(float), valid * (int)sizeof(float));
      }
    };
    const int per_row = KC * 9 * (int)sizeof(float) / a.vec;
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
  float xr[LD];
  auto fetch_x = [&](int chunk) {
    const int c0 = chunk * KC;
#pragma unroll
    for (int j = 0; j < LD; ++j) {
      const int e = tid + j * THREADS;
      const int q = e % QK, pix = (e / QK) % C::XPIX, kc = e / (QK * C::XPIX) * QK + q;
      const int r = pix / XN, c = pix - r * XN;
      const int gy = y0 + r - 1, gx = x0 + c - 1, ci = c0 + kc;
      const bool in = e < XELEMS && ci < Ci && gy >= 0 && gy < H && gx >= 0 && gx < W;
      xr[j] = in ? x[(int64_t)ci * HW + gy * W + gx] : 0.0f;
    }
  };
  auto put_x = [&](int chunk) {
    unsigned char* base = xs + (chunk & 1) * Op<float>::PLANES * C::PLANE;
#pragma unroll
    for (int j = 0; j < LD; ++j) {
      const int e = tid + j * THREADS;
      if (e >= XELEMS) continue;
      const int q = e % QK, pix = (e / QK) % C::XPIX, half = e / (QK * C::XPIX);
      unsigned char* dst = base + half * C::HALF + pix * 16 + q * 4;
      uint32_t hi, lo;
      split_tf32(xr[j], hi, lo);
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
  conv_loop<float, C>(acc, nchunks, smem_addr(xs), load_w, fetch_x, put_x, frag);

  // epilogue: stage the float32 tile st[n][pixel] in shared memory
  float* st = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    // fragment i: channel gid (+8 for i % 4 >= 2), flat pixel f = 8 (i / 4)
    // + 2 tig + i % 2 of the run, row f / 34, column f % 34
    const int n = m0 + gid + ((i >> 1) & 1) * 8;
    const int f = (i >> 2) * 8 + 2 * tig + (i & 1), r = f / XN, c = f % XN;
    if (r < R && c < TW) st[n * OS + r * TW + c] = acc[i];
  }
  __syncthreads();
  for (int idx = tid; idx < TN * P; idx += THREADS) {
    const int n = idx / P, px = idx - n * P;
    const int co = n0 + n, gy = y0 + px / TW, gx = x0 + px % TW;
    if (co >= Co || gy >= H || gx >= W) continue;
    const int64_t o = (((int64_t)b * Co + co) * H + gy) * W + gx;
    a.out[o] = st[n * OS + px];
  }
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

template <class C>
int launch_conv2_cfg(Args a, int B, cudaStream_t stream) {
  a.tiles_w = (a.W + C::TW - 1) / C::TW;
  a.n_tiles = a.tiles_w * ((a.H + C::R - 1) / C::R);
  a.vec = copy_width(a.k, (int64_t)a.Ci * 9 * sizeof(float), sizeof(float));
  constexpr int bytes = smem_bytes<C>();
  static_assert(bytes <= SMEM_MAX, "the block's buffers fit in shared memory");
  cudaError_t err = cudaFuncSetAttribute(conv2_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.n_tiles, (a.Co + TN - 1) / TN, B);
  conv2_kernel<C><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// the conv at the tiles of tile_rows(H, W, Co)
inline int launch_conv2(Args a, int B, cudaStream_t stream) {
  const int r = tile_rows(a.H, a.W, a.Co);
  if (r == 4) return launch_conv2_cfg<Tile<4>>(a, B, stream);
  if (r == 2) return launch_conv2_cfg<Tile<2>>(a, B, stream);
  return launch_conv2_cfg<Tile<1>>(a, B, stream);
}

// the tensor-core core indexes one sample's input with 32-bit offsets
inline bool bad_shape(int B, int H, int W, int Ci, int Co) {
  return B <= 0 || B > 65535 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 ||
         (int64_t)Ci * H * W >= (int64_t)1 << 31;
}

}  // namespace
