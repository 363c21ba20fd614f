// The first tensor-core core of the port's 3x3 convolutions, for Hopper
// (sm_90a), now bfloat16 B3's alone (packed_stage.cu:stage_conv_kernel, NHWC
// / HWIO). Every other conv -- B5, B2a, B2b, both operand types of B4 and
// float32 B3 -- runs the TMA core of tma_conv.cuh, which also takes this
// header's helpers (split_tf32, pin, the wgmma fences, tile_rows). A block
// computes TN = 128 output channels (two warpgroups of 64, wgmma's M) for a
// tile of R rows x 32 columns of one sample (wgmma's N: the flat run of
// pixels through the halo rows, see Tile), as an implicit GEMM over K = Ci *
// 9, taken KC = 16 input channels at a time (one bfloat16 wgmma's K) and tap
// by tap.
//
// The weights are wgmma's A operand, from registers: for each tap a warp
// gathers its 16 channels x KC values from the chunk's slab, which cp.async
// copies into a ring of NSTAGE shared-memory buffers, two chunks ahead. The
// input is its B operand, from shared memory: the chunk's halo tile,
// (R + 2) x 34 pixels, stored K-major; the tap's shifted window is a
// descriptor start address, so nothing is rearranged and no im2col is
// built. wgmma groups run asynchronously, two in flight: the next
// A-fragments are gathered while the tensor cores work. The source supplies
// the layout-specific parts (the slab copy, the A gather, the input fetch
// and store) as lambdas to conv_loop.
//
// The tensor cores add into their float32 accumulator with truncation, not
// rounding to nearest. So each chunk's products go into fragments that
// start anew with the chunk, and those are added to the accumulator on the
// CUDA cores, rounded to nearest: the truncation acts on a sum of 144
// products (9 taps x KC) only.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

constexpr float SQRT2 = 1.41421356237309515f;
constexpr int NSTAGE = 3;          // weight slabs in flight
constexpr int THREADS = 256;       // two warpgroups
constexpr int TN = 128;            // output channels per block, 64 per warpgroup
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block may use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int KC = 16;             // input channels per chunk: one bfloat16 wgmma's K

// A pixel tile of R rows x 32 columns. The input chunk is held with its
// halo, (R + 2) x 34 pixels, as wgmma's K-major B operand without swizzle:
// each pixel's KC channels are 32 bytes, stored as two 16-byte halves
// (channels 0..7 and 8..15), each
// half the halo tile's pixels in row-major order, 16 bytes each. So 8
// neighbouring pixels are one 128-byte core matrix, and the B operand of a
// tap (dy, dx) is the flat run of N pixels that starts at pixel dy * 34 +
// dx: one wgmma covers all R rows. Its outputs at the two halo columns of a
// row (flat column 32, 33 of each 34) are computed and dropped.
template <int R_> struct Tile {
  static constexpr int R = R_, TW = 32, XN = TW + 2, P = R * TW;
  static constexpr int N = ((R - 1) * XN + TW + 7) / 8 * 8;   // the wgmma's N
  static constexpr int XPIX = (R + 2) * XN;
  // bytes of one K half: the halo tile and 8 pixels that the last tap's
  // run reads past its end (into the dropped outputs only)
  static constexpr int HALF = (XPIX + 8) * 16;
  static constexpr int PLANE = 2 * HALF;          // the chunk's two halves
  static_assert(2 * XN + 2 + N <= XPIX + 8, "the last tap's run stays in its half");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (16, 8 or 4) bytes, of which the first `src_bytes`
// come from src and the rest are zero
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, int src_bytes) {
  const uint32_t d = smem_addr(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// v = hi + lo: hi = v rounded to a 10-bit mantissa (half away from zero),
// lo = v - hi, exact in float32; the tensor cores read the top 19 bits of each
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// two bfloat16 in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  const __nv_bfloat162 p = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// wgmma's shared-memory matrix descriptor, no swizzle: start address,
// leading byte offset (between the two 16-byte K halves), stride byte
// offset (between groups of 8 rows along N)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of a register across the
// asynchronous wgmma that uses it
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r) :: "memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r) :: "memory"); }

// d (+)= a * b: m64nNk16 bf16, A (64 x K) from registers, B from shared
// memory through desc; d += unless scale_d == 0
__device__ __forceinline__ void wgmma_bf16_n32(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_bf16_n72(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35 "
      "}, {%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_bf16_n136(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67 "
      "}, {%68, %69, %70, %71}, %72, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  if constexpr (N == 32) wgmma_bf16_n32(d, a, desc, scale_d);
  else if constexpr (N == 72) wgmma_bf16_n72(d, a, desc, scale_d);
  else wgmma_bf16_n136(d, a, desc, scale_d);
}

// The main loop of a block: acc[i] = the block's sums over all Ci * 9
// products, in wgmma's accumulator layout (fragment i: channel gid, +8 for
// i % 4 >= 2, of the warp's 16; flat pixel 8 (i / 4) + 2 tig + i % 2 of
// the run). Warp w of warpgroup g holds channels 64 g + 16 (w % 4) + gid
// and + 8 (gid = lane / 4, tig = lane % 4). The source's parts:
//   load_w(chunk, stage)  cp.async of the chunk's weight slab into ring
//                         buffer `stage` (no commit);
//   fetch_x(chunk)        the chunk's input halo tile into registers;
//   put_x(chunk)          those registers into xs buffer chunk % 2 (at
//                         xs_base + (chunk % 2) * PLANE) in the B layout,
//                         then fence.proxy.async;
//   frag(stage, tap, w)   the warp's A-fragment of `tap` from ring buffer
//                         `stage`: bfloat16 pairs.
// Returns with every copy landed and the block synchronised, so shared
// memory is free for the epilogue.
template <class C, class LoadW, class FetchX, class PutX, class Frag>
__device__ __forceinline__ void conv_loop(float (&acc)[C::N / 2], int nchunks, uint32_t xs_base,
                                          LoadW& load_w, FetchX& fetch_x, PutX& put_x,
                                          Frag& frag) {
  constexpr int N = C::N, ND = N / 2, XN = C::XN;
  float t[ND];
  uint32_t ah[2][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nchunks) load_w(s, s);
    cp_async_commit();
  }
  fetch_x(0);
  put_x(0);

  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<NSTAGE - 2>();     // this thread's copies of chunk ch landed
    __syncthreads();                 // everyone's, and xs[ch % 2]; chunk ch - 1 is done
    if (ch + NSTAGE - 1 < nchunks) load_w(ch + NSTAGE - 1, (ch + NSTAGE - 1) % NSTAGE);
    cp_async_commit();
    if (ch + 1 < nchunks) fetch_x(ch + 1);

    const int stage = ch % NSTAGE;
    const uint32_t xb = xs_base + (ch & 1) * C::PLANE;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      // two sets of A-fragments: set tap % 2 is rewritten once the wgmma
      // group of tap - 2, which read it, has completed
      const int dy = tap / 3, dx = tap % 3, s = tap & 1;
      uint32_t w[4];
      frag(stage, tap, w);
      wgmma_wait<1>();
#pragma unroll
      for (int q = 0; q < 4; ++q) pin(ah[s][q]);
#pragma unroll
      for (int q = 0; q < 4; ++q) ah[s][q] = w[q];
      wgmma_fence();
      const uint32_t at = xb + (dy * XN + dx) * 16;
      wgmma<N>(t, ah[s], make_desc(at, C::HALF, 128), tap > 0);
      wgmma_commit();
    }
    // the next input chunk into xs[(ch + 1) % 2], while the last groups run:
    // chunk ch - 1's groups, which read that buffer, completed before tap 2
    if (ch + 1 < nchunks) put_x(ch + 1);
    // the chunk's sums into the accumulator, rounded to nearest
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      pin(t[i]);
      acc[i] += t[i];
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// the least grid per sample: a block on all but 4 of the H100's 132 SMs
constexpr int FILL_BLOCKS = 128;

// The rows of a TMA conv's pixel tile of 32 columns for an (H, W, Co)
// launch (tma_conv.cuh): 4, halved while the grid of one
// sample, in blocks of TN channels, has fewer than FILL_BLOCKS blocks. A
// function of the sample's shape alone, never of the batch size.
inline int tile_rows(int H, int W, int Co) {
  const int blocks_per_row = ((W + 31) / 32) * ((Co + TN - 1) / TN);
  int r = 4;
  while (r > 1 && blocks_per_row * ((H + r - 1) / r) < FILL_BLOCKS) r /= 2;
  return r;
}

// the pixel tiles of such a launch
inline int tc_n_tiles(int H, int W, int Co) {
  const int r = tile_rows(H, W, Co);
  return ((W + 31) / 32) * ((H + r - 1) / r);
}

// the widest copy (bytes: 16, 8 or 4; else the element size) that every
// row of `row_bytes` bytes from p allows
inline int copy_width(const void* p, int64_t row_bytes, int esize) {
  for (int v = 16; v >= 4; v /= 2)
    if (row_bytes % v == 0 && reinterpret_cast<uintptr_t>(p) % v == 0) return v;
  return esize;
}

}  // namespace tc
