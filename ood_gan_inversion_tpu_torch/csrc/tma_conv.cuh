// The bfloat16 path of the three SAMM AlignNet convolutions, for Hopper
// (sm_90a): B5 (samm_conv.cu: ogi_conv3x3_act_tma, out = act(conv3x3(x, k))
// in bfloat16), B2a (alignnet_conv1.cu: ogi_alignnet_conv1_tma, z =
// prelu(conv3x3(x1, k1)) in bfloat16, x1 built from s, t and the
// coefficients by the repack pass) and B2b (alignnet_conv2.cu:
// ogi_alignnet_conv2_tma, y2 = conv3x3(z, k2) in float32 and the tiles'
// moments of y2). Their float32 operands run the core of samm_conv.cuh /
// tc_conv.cuh.
//
// Replaces, for bfloat16 operands, the TPU kernels
// ops/pallas_kernels.py:_conv_act_band_kernel (via conv3x3_act),
// _an_conv1_kernel and _an_conv2_kernel (via fused_alignnet_body0). Bound by
// operations: 2 * 9 * Ci * Co flops per pixel against 2 * (Ci + Co) bytes.
//
// Operands. Both wgmma operands come from shared memory, K-major with the
// 128-byte swizzle, loaded by TMA. A K-block is one tap x 64 input channels,
// 128 bytes of bfloat16 per row: one swizzle atom row.
//   * A (M = output channels): the weights repacked to (3 [dx], 3 [dy], Co,
//     Ci), Ci contiguous. One TMA box {64 ci, 128 co, 3 taps} brings the
//     three taps of one dx: three 16 KB tiles.
//   * B (N = pixels): the input repacked to NHWC, (B, H, W, Ci). A block
//     computes a tile of TH rows x 32 columns; one TMA box {64 ci, 32
//     columns, TH + 2 rows} at (x0 + dx - 1, y0 - 1) holds the three taps
//     of one dx: the tap at dy is the run of TH * 32 pixel rows that starts
//     dy * 32 rows in, 4 KB apart, so every tap's descriptor starts on a
//     1024-byte swizzle atom and the base offset stays 0. TMA's
//     out-of-bounds zero fill supplies the halo, so no halo column is
//     computed. K-major NHWC was chosen over an MN-major B read straight
//     from NCHW: the row shift of a tap stays atom-aligned, and a 32-pixel
//     NCHW row is 64 bytes, half a 128-byte swizzle row.
//   * The repack is one small pass ahead of the conv (repack_kernel, both
//     layouts in one launch), into scratch that the wrapper allocates.
//     Its channels are padded with zeros to a multiple of 8, since a TMA
//     stride is a multiple of 16 bytes; channels and output channels past
//     the end of a box are TMA zero fill. ops/samm_conv.py:tma_operands is
//     its plain version. For B2a it writes x1 = [as*s + at*t + b1, ct*t +
//     b2] (its x1 mode): read from s and t, computed in float32 with the
//     plain version's roundings (two products, two sums, no FMA
//     contraction), rounded once; ops/alignnet.py:tma_x1_operands is that
//     mode's plain version. TMA's zero fill outside the image is then
//     conv1's padding of x1, as the TPU kernel masks it, and not the affine
//     image of zero-padded s and t. B2a then runs B5's mode, PReLU.
// A stage of the ring is one (64-channel chunk, dx): 3 K-blocks, 48 KB of
// weights and (TH + 2) * 4 KB of input, completed on one mbarrier. At Ci =
// 1024 the K loop has 16 * 3 stages and no block-wide barrier.
//
// Warps. One producer warp issues the TMA loads, up to 3 stages ahead; its
// warpgroup gives its registers up (setmaxnreg 40). Two consumer
// warpgroups (setmaxnreg 232) take 64 output channels each (M = 128 per
// block) and issue the stage's 12 wgmma m64nNk16 (N = TH * 32) as one
// group; each warpgroup frees a stage on its empty mbarrier once its group
// has completed.
//
// Accumulation. The tensor cores add into their float32 accumulator with
// truncation (tc_conv.cuh). B5 rounds its output to bfloat16 and is held to
// 2^-7 of max|ref|, so its accumulator stays in the tensor cores across
// the whole K, with the previous stage's group still running as it issues
// the next. B2b returns float32 y2 and pixel sums held to 1e-4, so it
// drains: the products of DRAIN_STAGES stages go into fresh fragments,
// which the CUDA cores add to the accumulator, rounded to nearest, once
// their groups have completed; meanwhile the other consumer warpgroup's
// group runs. tools/prof_tma_conv.py measures, at the SAMM scales, the
// error and the time of B2b with this period, with a drain every 16 stages
// and with none, against the plain version: on an H100 the three ran
// within 2% of each other, while the error on sum y2^2 grew from under
// 1.2e-6 of max|ref| (every stage) to 5.7e-6 (16) and 1.8e-5 (none, Ci =
// 1024), a bias toward zero that grows with K. So B2b drains every stage,
// the most accurate of the three at no measured cost. (Two fragment sets,
// drained while the next group runs, made ptxas serialise the wgmmas:
// C7514.)
//
// Tiling: M = 128 output channels, N = TH x 32 pixels, one sample per
// block; TH = 4, halved while one sample's grid has fewer than 128 blocks
// (at 32px, 1024 -> 1024: TH = 2, 128 blocks): tc_conv.cuh's tile_rows,
// the same tiles as the float32 core's. (TH = 8, N = 256 with a 2-stage ring, ran
// slower than TH = 4 at the SAMM scales.) A function of (H, W, Co) alone,
// never of the batch size, so every batch slot runs the same sums in the
// same order.
//
// Epilogue: B2b sums each channel's moments over its tile from the
// registers, in a fixed order, into the (B, n_tiles, 2, Co) scratch that
// sum_tiles_kernel sums in tile order (no atomics); then the consumers
// stage the float32 tile in the ring (B5 after its activation) and store
// it along W, 4 pixels a thread.
//
// The tensor maps are __grid_constant__ kernel arguments, encoded on the
// host at every launch by cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the build links nothing beyond the runtime.

#pragma once

#include "tc_conv.cuh"

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <chrono>
#include <type_traits>

namespace tma {

using tc::pin;
using tc::smem_addr;
using tc::tile_rows;
using tc::wgmma_commit;
using tc::wgmma_fence;
using tc::wgmma_wait;

constexpr int TW = 32;                 // pixel tile columns
constexpr int BM = 128;                // output channels per block
constexpr int KB = 64;                 // input channels per K-block
constexpr int ROW = KB * 2;            // bytes of a K-block row
constexpr int A_TAP = BM * ROW;        // one tap's weights: 16 KB
constexpr int A_BYTES = 3 * A_TAP;
constexpr int THREADS = 384;           // producer warpgroup + two consumer warpgroups
constexpr int ACT_NONE = 0, ACT_PRELU = 1;
enum Mode { CONV_ACT = 0, AN_CONV2 = 1 };
// B2b's drain period in stages (of 3 taps x 64 channels each); see the
// note on accumulation
constexpr int DRAIN_STAGES = 1;

template <int TH> struct Cfg {
  static constexpr int N = TH * TW, ND = N / 2;
  static constexpr int B_BYTES = (TH + 2) * TW * ROW;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int S = 3;                             // stages in the ring
  static constexpr int RING = S * STAGE;
  static constexpr int OS = N + 4;                        // staged row stride, floats
  static constexpr int SMEM = RING + 2 * S * 8 + 1024;    // + mbarriers + alignment
  static_assert(BM * OS * 4 <= RING, "the staged tile fits in the ring");
  static_assert(SMEM <= tc::SMEM_MAX, "the ring fits in shared memory");
};

struct Args {
  const float* alpha;     // (Co,) PReLU slopes (act 1)
  void* out;              // (B, Co, H, W): bfloat16 (B5) or float32 (B2b)
  float* tile_part;       // B2b: (B, n_tiles, 2, Co)
  int H, W, Co, act, tiles_w, n_tiles, iters;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%3, %4, %5}], [%2];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
                  "r"(c2) : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
                  "r"(c2), "r"(c3) : "memory");
}

// wgmma's shared-memory descriptor of a K-major operand with the 128-byte
// swizzle: start address, leading offset 1 (unused by this layout), stride
// 1024 bytes between groups of 8 rows, layout type 1 (128-byte swizzle),
// base offset 0 (every start lies 0, 32, 64 or 96 bytes into an atom row
// of a 1024-byte-aligned atom: the K step within the row)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (+)= A * B: m64nNk16, bfloat16 operands from shared memory through the
// descriptors da, db, float32 d; d += unless scale_d == 0
__device__ __forceinline__ void wgmma_n32(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 32) wgmma_n32(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_n64(d, da, db, scale_d);
  else wgmma_n128(d, da, db, scale_d);
}

__device__ __forceinline__ float activate(float v, int act, float slope) {
  if (act != ACT_NONE) v = v >= 0.0f ? v : slope * v;
  if (act == 2) v *= tc::SQRT2;
  return v;
}

// Block (pixel tile, channel block, sample). Threads 0..127: the producer
// warpgroup (thread 0 issues the loads); 128..383: the two consumer
// warpgroups. Accumulator fragment i of a consumer thread: channel gid (+8
// for i % 4 >= 2) of its warp's 16, pixel 8 (i / 4) + 2 tig + i % 2 of the
// tile (row-major, 32 per row).
template <int MODE, int TH>
__global__ void __launch_bounds__(THREADS, 1)
tma_conv_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
                const Args a) {
  using C = Cfg<TH>;
  constexpr int N = C::N, ND = C::ND, S = C::S;
  constexpr bool CONV2 = MODE == AN_CONV2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = ring + C::RING, empty = full + 8 * S;   // mbarriers, 8 bytes each
  const int tid = threadIdx.x;
  const int b = blockIdx.z, tile = blockIdx.x, n0 = blockIdx.y * BM;
  const int y0 = (tile / a.tiles_w) * TH, x0 = (tile % a.tiles_w) * TW;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);        // the producer's arrive, plus the TMA bytes
      mbar_init(empty + 8 * s, 2);       // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      for (int it = 0; it < a.iters; ++it) {
        const int s = it % S;
        if (it >= S) mbar_wait(empty + 8 * s, (it / S - 1) & 1);
        const uint32_t st = ring + s * C::STAGE, bar = full + 8 * s;
        const int c0 = it / 3 * KB, dx = it % 3;
        mbar_expect_tx(bar, C::STAGE);
        tma_load_3d(st, &wmap, c0, n0, 3 * dx, bar);
        tma_load_4d(st + A_BYTES, &xmap, c0, x0 + dx - 1, y0 - 1, b, bar);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = tid - 128, cw = ct >> 7, lane = ct & 31, warp = (ct >> 5) & 3;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = cw * 64 + warp * 16 + gid;       // the thread's first channel in the block
  const bool signals = (ct & 127) == 0;           // frees stages for its warpgroup

  // the 12 wgmmas of iteration it into d: taps dy = 0..2 x 4 steps of 16
  // channels; the first starts d anew unless `scale`
  auto issue = [&](int it, float* d, int scale) {
    const uint32_t st = ring + (it % S) * C::STAGE;
    const uint32_t a0 = st + cw * 64 * ROW, b0 = st + A_BYTES;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma<N>(d, sw128_desc(a0 + dy * A_TAP + kk * 32),
                 sw128_desc(b0 + dy * TW * ROW + kk * 32), dy + kk > 0 ? 1 : scale);
  };

  // The K loop, in periods: B2b's of DRAIN_STAGES stages, whose products go
  // into t, fresh, and are added to acc once their groups have completed
  // (the drain; while a warpgroup drains, the other one's wgmmas keep the
  // tensor cores busy); B5's of all stages, straight into acc. Within a
  // period the previous stage's group runs on as the next one is issued.
  float acc[ND], t[CONV2 ? ND : 1];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.0f;
  float* const d = CONV2 ? t : acc;
  const int period = CONV2 ? DRAIN_STAGES : a.iters;
  for (int p0 = 0; p0 < a.iters; p0 += period) {
    const int p1 = min(p0 + period, a.iters);
    for (int it = p0; it < p1; ++it) {
      mbar_wait(full + 8 * (it % S), (it / S) & 1);
      wgmma_fence();
      issue(it, d, it > p0);
      wgmma_commit();
      wgmma_wait<1>();                     // the group of it - 1 has read its stage
      if (it > p0 && signals) mbar_arrive(empty + 8 * ((it - 1) % S));
    }
    wgmma_wait<0>();
    if (signals) mbar_arrive(empty + 8 * ((p1 - 1) % S));
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      pin(d[i]);
      if constexpr (CONV2) acc[i] += t[i];
    }
  }

  const int H = a.H, W = a.W, Co = a.Co;
  if constexpr (CONV2) {
    // the tile's moments from the registers: each thread sums its pixels
    // of its two channels in fragment order, then the four threads of a
    // channel add theirs in a fixed butterfly (a + b == b + a, so all four
    // hold the same sums)
    float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int px = (i >> 2) * 8 + 2 * tig + (i & 1), h = (i >> 1) & 1;
      if (y0 + px / TW < H && x0 + px % TW < W) {
        s1[h] += acc[i];
        s2[h] += acc[i] * acc[i];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off *= 2) {
        s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], off);
        s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], off);
      }
      const int co = n0 + m0 + 8 * h;
      if (tig == 0 && co < Co) {
        float* p = a.tile_part + ((int64_t)b * a.n_tiles + tile) * 2 * Co + co;
        p[0] = s1[h];
        p[Co] = s2[h];
      }
    }
  }

  // epilogue: both consumer warpgroups are done with the ring; stage the
  // float32 tile st[channel][pixel] in it
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  float* st = reinterpret_cast<float*>(smem);
  const int act = CONV2 ? ACT_NONE : a.act;
  float slope[2] = {0.2f, 0.2f};
  if (act == ACT_PRELU) {
    slope[0] = n0 + m0 < Co ? a.alpha[n0 + m0] : 0.0f;
    slope[1] = n0 + m0 + 8 < Co ? a.alpha[n0 + m0 + 8] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const int n = m0 + ((i >> 1) & 1) * 8, px = (i >> 2) * 8 + 2 * tig + (i & 1);
    st[n * C::OS + px] = activate(acc[i], act, slope[(i >> 1) & 1]);
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  // NCHW stores along W, 4 pixels a thread: 16 bytes of float32 or 8 of
  // bfloat16 where W is a multiple of 4, else one value at a time
  const bool vec = W % 4 == 0;
  for (int idx = ct; idx < BM * N / 4; idx += 256) {
    const int n = idx / (N / 4), px = idx % (N / 4) * 4;
    const int co = n0 + n, gy = y0 + px / TW, gx = x0 + px % TW;
    if (co >= Co || gy >= H || gx >= W) continue;
    const int64_t o = (((int64_t)b * Co + co) * H + gy) * W + gx;
    const float4 v = *reinterpret_cast<const float4*>(st + n * C::OS + px);
    if (vec) {
      if constexpr (CONV2) {
        *reinterpret_cast<float4*>(static_cast<float*>(a.out) + o) = v;
      } else {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + o) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
      }
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
      for (int j = 0; j < 4 && gx + j < W; ++j) {
        if constexpr (CONV2) static_cast<float*>(a.out)[o + j] = e[j];
        else static_cast<__nv_bfloat16*>(a.out)[o + j] = __float2bfloat16_rn(e[j]);
      }
    }
  }
}

// The layout pass ahead of the conv: xr (B, H * W, Cp) from x (B, C, H * W)
// and wr (3 [dx], 3 [dy], Co, Cp) from k (Co, C, 3, 3), channels C..Cp-1
// zero. It moves bytes only, but in its x1 mode (X1, B2a) computes the
// input's values from s = x and t (B, C / 2, H * W) and the coefficients
// (x1_bits). Each transpose goes through shared memory so that reads and
// writes both run along contiguous rows, two bfloat16 (4 bytes) a thread
// where the layout allows. Blocks [0, xblocks) transpose 64 channels x 64
// pixels of x each (grid.y: the sample); blocks from xblocks on take 512
// channels of one output channel of k (grid.y 0).
struct Repack {
  const unsigned short* x;    // x, or s (X1)
  const unsigned short* t;    // X1: t
  const float* coeffs;        // X1: (B, 5, C / 2) [as, at, b1, ct, b2]
  const unsigned short* k;
  unsigned short* xr;
  unsigned short* wr;
  int C, HW, Cp, Co, xtiles_p, xblocks;
};

constexpr int WCHUNK = 512;      // channels of k per block

// x1 of one value, as bfloat16 bits: (as*s + at*t) + b1 in the s half,
// ct*t + b2 in the t half, each product and sum rounded to float32 as the
// plain version's (ops/alignnet.py:alignnet_x1), then rounded once. cf
// points at the channel's as, the other coefficients C apart (C = x1's
// channels / 2); s and t are float32 bit patterns.
__device__ __forceinline__ uint32_t x1_bits(const float* cf, int C, bool s_half, uint32_t s,
                                            uint32_t t) {
  const float sv = __uint_as_float(s), tv = __uint_as_float(t);
  const float v = s_half ? __fadd_rn(__fadd_rn(__fmul_rn(cf[0], sv), __fmul_rn(cf[C], tv)), cf[2 * C])
                         : __fadd_rn(__fmul_rn(cf[3 * C], tv), cf[4 * C]);
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// the input's channel c (< r.C) of sample b at pixels p and p + 1 (p even,
// H * W even) as two bfloat16 in one word, p's in the low half; X1: x1's
template <bool X1>
__device__ __forceinline__ uint32_t input_pair(const Repack& r, int b, int c, int p) {
  if constexpr (!X1) {
    return *reinterpret_cast<const uint32_t*>(r.x + ((int64_t)b * r.C + c) * r.HW + p);
  } else {
    const int C = r.C / 2, cs = c < C ? c : c - C;
    const float* cf = r.coeffs + (int64_t)b * 5 * C + cs;
    const int64_t i = ((int64_t)b * C + cs) * r.HW + p;
    const uint32_t t = *reinterpret_cast<const uint32_t*>(r.t + i);
    const uint32_t s = c < C ? *reinterpret_cast<const uint32_t*>(r.x + i) : 0u;
    return x1_bits(cf, C, c < C, s << 16, t << 16) |
           x1_bits(cf, C, c < C, s & 0xffff0000u, t & 0xffff0000u) << 16;
  }
}

// the same at one pixel p
template <bool X1>
__device__ __forceinline__ unsigned short input_at(const Repack& r, int b, int c, int p) {
  if constexpr (!X1) {
    return r.x[((int64_t)b * r.C + c) * r.HW + p];
  } else {
    const int C = r.C / 2, cs = c < C ? c : c - C;
    const int64_t i = ((int64_t)b * C + cs) * r.HW + p;
    const uint32_t s = c < C ? (uint32_t)r.x[i] << 16 : 0u;
    return (unsigned short)x1_bits(r.coeffs + (int64_t)b * 5 * C + cs, C, c < C, s,
                                   (uint32_t)r.t[i] << 16);
  }
}

template <bool X1>
__global__ void __launch_bounds__(256) repack_kernel(const Repack r) {
  __shared__ __align__(16) unsigned short sm[WCHUNK * 9];
  const int tid = threadIdx.x, lane = tid & 31, row = tid >> 5;
  if ((int)blockIdx.x < r.xblocks) {
    constexpr int LD = 66;       // tile row stride: [64 channels][64 pixels + 2]
    const int b = blockIdx.y, p0 = blockIdx.x % r.xtiles_p * 64, c0 = blockIdx.x / r.xtiles_p * 64;
    unsigned short* dst = r.xr + (int64_t)b * r.HW * r.Cp;
    if (r.HW % 2 == 0) {         // pixel pairs in, channel pairs out (Cp is even)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = c0 + row + 8 * i, p = p0 + 2 * lane;
        uint32_t v = 0;
        if (c < r.C && p < r.HW) v = input_pair<X1>(r, b, c, p);
        *reinterpret_cast<uint32_t*>(sm + (row + 8 * i) * LD + 2 * lane) = v;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = p0 + row + 8 * i, c = c0 + 2 * lane;
        if (p < r.HW && c < r.Cp) {
          const uint32_t v = sm[2 * lane * LD + row + 8 * i] |
                             (uint32_t)sm[(2 * lane + 1) * LD + row + 8 * i] << 16;
          *reinterpret_cast<uint32_t*>(dst + (int64_t)p * r.Cp + c) = v;
        }
      }
    } else {
      const int tx = tid & 63, ty = tid >> 6;
      for (int i = ty; i < 64; i += 4) {
        const int c = c0 + i, p = p0 + tx;
        sm[i * LD + tx] = c < r.C && p < r.HW ? input_at<X1>(r, b, c, p) : 0;
      }
      __syncthreads();
      for (int i = ty; i < 64; i += 4) {
        const int p = p0 + i, c = c0 + tx;
        if (p < r.HW && c < r.Cp) dst[(int64_t)p * r.Cp + c] = sm[tx * LD + i];
      }
    }
    return;
  }
  if (blockIdx.y != 0) return;
  const int j = blockIdx.x - r.xblocks, per_co = (r.Cp + WCHUNK - 1) / WCHUNK;
  const int co = j / per_co, c0 = j % per_co * WCHUNK;
  const unsigned short* src = r.k + ((int64_t)co * r.C + c0) * 9;
  const int n = max(0, min(WCHUNK, r.C - c0)) * 9;
  if (r.C % 8 == 0) {            // 16-byte rows: the chunk's start and length
    for (int i = tid; i < n / 8; i += 256)
      reinterpret_cast<uint4*>(sm)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else {
    for (int i = tid; i < n; i += 256) sm[i] = src[i];
  }
  __syncthreads();
  const int c = c0 + 2 * tid;    // two channels a thread (Cp is even)
  if (c >= r.Cp) return;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {     // wr's tap dx * 3 + dy is k's dy * 3 + dx
    const int t = tap % 3 * 3 + tap / 3;
    const uint32_t lo = c < r.C ? sm[2 * tid * 9 + t] : 0;
    const uint32_t hi = c + 1 < r.C ? sm[(2 * tid + 1) * 9 + t] : 0;
    *reinterpret_cast<uint32_t*>(r.wr + ((int64_t)tap * r.Co + co) * r.Cp + c) = lo | hi << 16;
  }
}

// ---------------------------------------------------------------- host

// the repack of x (B, C, H, W) and k (Co, C, 3, 3) into xr (B, H, W, Cp)
// and wr (3, 3, Co, Cp), all bfloat16; with t (nullptr otherwise), its x1
// mode: xr holds x1 built from s = x and t (B, C / 2, H, W) bfloat16 and
// coeffs (B, 5, C / 2) float32
inline int repack(const void* x, const void* t, const float* coeffs, const void* k, void* xr,
                  void* wr, int B, int C, int H, int W, int Co, int Cp, cudaStream_t stream) {
  using U = const unsigned short*;
  Repack r{static_cast<U>(x), static_cast<U>(t), coeffs, static_cast<U>(k),
           static_cast<unsigned short*>(xr), static_cast<unsigned short*>(wr), C, H * W, Cp, Co,
           (H * W + 63) / 64, 0};
  r.xblocks = r.xtiles_p * ((Cp + 63) / 64);
  const dim3 grid(r.xblocks + Co * ((Cp + WCHUNK - 1) / WCHUNK), B);
  if (t == nullptr) repack_kernel<false><<<grid, 256, 0, stream>>>(r);
  else repack_kernel<true><<<grid, 256, 0, stream>>>(r);
  return (int)cudaGetLastError();
}


using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once (nullptr if absent)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The two tensor maps of a launch: the weights w (3 [dx], 3 [dy], Co, Ci)
// as a 3-D map {Ci, Co, 9} with boxes {64, 128, 3}, the input x (B, H, W,
// Ci) as a 4-D map {Ci, W, H, B} with boxes {64, 32, TH + 2, 1}; both
// bfloat16, 128-byte swizzle, zeros out of bounds. 0, or 1001 (no
// cuTensorMapEncodeTiled), or 1002 (a map refused).
inline int encode_maps(CUtensorMap* wmap, CUtensorMap* xmap, const void* w, const void* x, int B,
                       int H, int W, int Ci, int Co, int TH) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return 1001;
  const cuuint64_t ci = Ci, e = 2;
  const cuuint64_t wdim[3] = {ci, (cuuint64_t)Co, 9};
  const cuuint64_t wstride[2] = {ci * e, (cuuint64_t)Co * ci * e};
  const cuuint32_t wbox[3] = {KB, BM, 3};
  const cuuint64_t xdim[4] = {ci, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstride[3] = {ci * e, (cuuint64_t)W * ci * e, (cuuint64_t)H * W * ci * e};
  const cuuint32_t xbox[4] = {KB, TW, (cuuint32_t)TH + 2, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (enc(wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), wdim, wstride, wbox,
          ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      enc(xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdim, xstride, xbox,
          ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return 1002;
  return 0;
}

// kernels launched by this library, read by ogi_tma_conv_launches
inline std::atomic<long long>& launches() {
  static std::atomic<long long> n{0};
  return n;
}

template <int MODE, int TH>
int launch_cfg(const void* x, const void* w, Args a, int B, int Ci, cudaStream_t stream) {
  using C = Cfg<TH>;
  CUtensorMap wmap, xmap;
  const int err = encode_maps(&wmap, &xmap, w, x, B, a.H, a.W, Ci, a.Co, TH);
  if (err != 0) return err;
  a.tiles_w = (a.W + TW - 1) / TW;
  a.n_tiles = a.tiles_w * ((a.H + TH - 1) / TH);
  a.iters = 3 * ((Ci + KB - 1) / KB);
  cudaError_t e = cudaFuncSetAttribute(tma_conv_kernel<MODE, TH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.n_tiles, (a.Co + BM - 1) / BM, B);
  tma_conv_kernel<MODE, TH><<<grid, THREADS, C::SMEM, stream>>>(wmap, xmap, a);
  e = cudaGetLastError();
  if (e == cudaSuccess) launches()++;
  return (int)e;
}

// the arguments a launch does not take (scratch not 16-byte aligned)
inline bool bad_args(const Args& a, int B, int Ci, const void* xr, const void* wr) {
  return B <= 0 || B > 65535 || a.H <= 0 || a.W <= 0 || Ci <= 0 || a.Co <= 0 ||
         reinterpret_cast<uintptr_t>(xr) % 16 != 0 || reinterpret_cast<uintptr_t>(wr) % 16 != 0;
}

// the repack (x1 mode with t), then the conv on xr, wr at the tiles of
// tile_rows(H, W, Co); Ci the conv's input channels, Cp = Ci rounded up to
// a multiple of 8
template <int MODE>
int repack_and_conv(const void* x, const void* t, const float* coeffs, const void* k, void* xr,
                    void* wr, Args a, int B, int Ci, cudaStream_t stream) {
  if (bad_args(a, B, Ci, xr, wr)) return 1000;
  const int Cp = (Ci + 7) / 8 * 8;
  const int err = repack(x, t, coeffs, k, xr, wr, B, Ci, a.H, a.W, a.Co, Cp, stream);
  if (err != 0) return err;
  const int r = tile_rows(a.H, a.W, a.Co);
  if (r == 4) return launch_cfg<MODE, 4>(xr, wr, a, B, Cp, stream);
  if (r == 2) return launch_cfg<MODE, 2>(xr, wr, a, B, Cp, stream);
  return launch_cfg<MODE, 1>(xr, wr, a, B, Cp, stream);
}

// The repack, then the conv (B5, B2b): x (B, Ci, H, W) and k (Co, Ci, 3, 3)
// bfloat16; xr (B, H, W, Cp) and wr (3, 3, Co, Cp) bfloat16 scratch, Cp =
// Ci rounded up to a multiple of 8, both 16-byte aligned; the rest of a as
// Args says.
template <int MODE>
int launch(const void* x, const void* k, void* xr, void* wr, Args a, int B, int Ci,
           cudaStream_t stream) {
  return repack_and_conv<MODE>(x, nullptr, nullptr, k, xr, wr, a, B, Ci, stream);
}

// B2a: the repack's x1 mode from s, t (B, C, H, W) bfloat16 and coeffs (B,
// 5, C) float32, then B5's conv (act as a says: PReLU) with Ci = Co = 2C =
// a.Co; k (2C, 2C, 3, 3), xr (B, H, W, Cp), wr (3, 3, 2C, Cp) as above.
inline int launch_x1(const void* s, const void* t, const float* coeffs, const void* k, void* xr,
                     void* wr, Args a, int B, cudaStream_t stream) {
  if (a.Co % 2 != 0 || t == nullptr || coeffs == nullptr) return 1000;
  return repack_and_conv<CONV_ACT>(s, t, coeffs, k, xr, wr, a, B, a.Co, stream);
}

// the mean host time in microseconds of encoding one launch's two tensor
// maps, over `reps` encodings; -1 if an encoding fails
inline double encode_us(const void* x, const void* w, int B, int H, int W, int Ci, int Co, int TH,
                        int reps) {
  CUtensorMap wmap, xmap;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (encode_maps(&wmap, &xmap, w, x, B, H, W, Ci, Co, TH) != 0) return -1.0;
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / reps;
}

}  // namespace tma

// The number of tma_conv_kernel launches this library has made.
extern "C" long long ogi_tma_conv_launches() { return tma::launches().load(); }

// The repack pass alone (tma::repack; arguments as there): 0 or a CUDA error.
extern "C" int ogi_tma_repack(const void* x, const void* k, void* xr, void* wr, int B, int C,
                              int H, int W, int Co, int Cp, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || Co <= 0 || Cp < C || Cp % 8 != 0) return 1000;
  return tma::repack(x, nullptr, nullptr, k, xr, wr, B, C, H, W, Co, Cp,
                     static_cast<cudaStream_t>(stream));
}

// The repack pass's x1 mode alone (B2a): s, t (B, C, H, W) bfloat16, coeffs
// (B, 5, C) float32, k (2C, 2C, 3, 3) bfloat16 into xr (B, H, W, Cp) and wr
// (3, 3, 2C, Cp); 0 or a CUDA error.
extern "C" int ogi_tma_repack_x1(const void* s, const void* t, const void* coeffs, const void* k,
                                 void* xr, void* wr, int B, int C, int H, int W, int Cp,
                                 void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || Cp < 2 * C || Cp % 8 != 0) return 1000;
  return tma::repack(s, t, static_cast<const float*>(coeffs), k, xr, wr, B, 2 * C, H, W, 2 * C,
                     Cp, static_cast<cudaStream_t>(stream));
}
