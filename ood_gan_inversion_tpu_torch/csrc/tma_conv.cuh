// The TMA core of the port's 3x3 convolutions, for Hopper (sm_90a): the three
// SAMM AlignNet convolutions in both operand types -- B5 (samm_conv.cu: out =
// act(conv3x3(x, k)) in x's type), B2a (alignnet_conv1.cu: z =
// prelu(conv3x3(x1, k1)) in s's type, x1 built from s, t and the
// coefficients by the repack pass) and B2b (alignnet_conv2.cu: y2 =
// conv3x3(z, k2) in float32 and the tiles' moments of y2) -- and the packed
// generator convs of packed_stage.cu with their NHWC epilogues: B4's conv1
// and conv2 and B3, all in both operand types. Every conv of the port runs
// this core.
//
// Replaces the TPU kernels ops/pallas_kernels.py:_conv_act_band_kernel (via
// conv3x3_act), _an_conv1_kernel (via fused_alignnet_body0), _an_conv2_kernel
// (via fused_alignnet_body0), the convs of _stage_band_kernel (via
// fused_packed_stage) and _conv_band_kernel (via fused_conv3x3_act). Bound
// by operations: 2 * 9 *
// Ci * Co flops per pixel against 2 * (Ci + Co) bytes in bfloat16; in
// float32 three TF32 products per product (3xTF32) against 4 * (Ci + Co)
// bytes.
//
// Operands. Both wgmma operands come from shared memory, K-major with the
// 128-byte swizzle, loaded by TMA. A K-block is one tap x one 128-byte row
// per matrix row (one swizzle atom row): 64 bfloat16 input channels, or in
// float32 (the *_TF32 modes) 16 channels as 32 words, their 16 hi words then
// their 16 lo words.
//   * A (M = output channels): the weights repacked to (3 [dx], 3 [dy], Co,
//     K), K contiguous. One TMA box {one row, 128 co, 3 taps} brings the
//     three taps of one dx: three 16 KB tiles.
//   * B (N = pixels): the input repacked to NHWC, (B, H, W, K). A block
//     computes a tile of TH rows x 32 columns; one TMA box {one row, 32
//     columns, TH + 2 rows} at (x0 + dx - 1, y0 - 1) holds the three taps
//     of one dx: the tap at dy is the run of TH * 32 pixel rows that starts
//     dy * 32 rows in, 4 KB apart, so every tap's descriptor starts on a
//     1024-byte swizzle atom and the base offset stays 0. TMA's
//     out-of-bounds zero fill supplies the halo, so no halo column is
//     computed. K-major NHWC was chosen over an MN-major B read straight
//     from NCHW: the row shift of a tap stays atom-aligned, and TF32 wgmma
//     reads K-major operands only.
//   * The SAMM convs' repack is one small pass ahead of the conv
//     (repack_kernel, or repack_tf32_kernel in float32; both layouts in one
//     launch), into scratch that the wrapper allocates.
//     ops/samm_conv.py:tma_operands is its plain version. bfloat16 channels
//     are padded with zeros to a multiple of 8, since a TMA stride is a
//     multiple of 16 bytes; channels and output channels past the end of a
//     box are TMA zero fill. float32 channels are padded to a multiple of 16
//     and each value v is split once per call into hi = v rounded to TF32
//     (half away from zero) and lo = v - hi, exact (split_tf32), where
//     splitting in the conv would split each weight again for every tap of
//     every pixel tile. For B2a it writes x1 = [as*s + at*t + b1, ct*t +
//     b2] (its x1 mode): read from s and t, computed in float32 with the
//     plain version's roundings (two products, two sums, no FMA
//     contraction), then rounded once to bfloat16 or split;
//     ops/alignnet.py:tma_x1_operands is that mode's plain version. TMA's
//     zero fill outside the image is then conv1's padding of x1, as the TPU
//     kernel masks it, and not the affine image of zero-padded s and t. B2a
//     then runs B5's mode, PReLU.
//   * The packed convs (B4, B3) are NHWC / HWIO already: their repack
//     (packed_stage.cu) only scales x by s1 and rounds it to bfloat16 or
//     splits it into words, elementwise, and lays the weights out. B4's
//     conv1 epilogue writes its activation z straight as conv2's operand
//     (STAGE1_TF32: words; STAGE1: bfloat16, channels C4.. zero), so conv2
//     reads z through TMA with no pass between. B3 (PACKED_TF32, PACKED) is
//     conv1 without s2, its output (B, H, W, Co) in the operand type.
// A stage of the ring is one (K-block, dx): 3 K-blocks, 48 KB of weights
// and (TH + 2) * 4 KB of input, completed on one mbarrier: 72 KB at TH = 4,
// three stages in 216 KB. At Ci = 1024 the K loop has 16 * 3 stages in
// bfloat16 and 64 * 3 in float32, and no block-wide barrier. (A float32
// stage of 32 channels in separate hi and lo planes would take 144 KB, one
// stage; interleaving the planes by 16 channels keeps the bfloat16 ring,
// one TMA box per operand, and the bfloat16 descriptors: the K steps of 32
// bytes at 0, 32, 64 and 96 bytes into a row.)
//
// Warps. One producer warp issues the TMA loads, up to 3 stages ahead; its
// warpgroup gives its registers up (setmaxnreg 40). Two consumer
// warpgroups (setmaxnreg 232) take 64 output channels each (M = 128 per
// block) and issue a stage's wgmmas (N = TH * 32) as one group: 12
// m64nNk16 in bfloat16, 18 m64nNk8 in float32 (3 taps x 2 steps of 8
// channels x the products lo*hi, hi*lo, hi*hi; lo*lo, ~2^-22 relative, is
// dropped); each warpgroup frees a stage on its empty mbarrier once its
// group has completed.
//
// Accumulation. The tensor cores add into their float32 accumulator with
// truncation, not rounding to nearest. bfloat16 B5 rounds its output to
// bfloat16 and is held to 2^-7 of max|ref|, so its accumulator stays in the
// tensor cores across the whole K, with the previous stage's group still
// running as it issues the next; so do bfloat16 B4's two convs (STAGE1,
// STAGE2) and bfloat16 B3 (PACKED), whose outputs are rounded to bfloat16
// and held to 2^-7 too. B2b returns float32 y2 and pixel sums, and the float32
// modes float32 outputs, held to 1e-4, so they drain: the products of a
// period of stages (drain_period) go into fresh fragments, which the CUDA
// cores add to the accumulator, rounded to nearest, once their groups have
// completed; meanwhile the other consumer warpgroup's group runs. In
// float32 the cross terms of a stage go in before its hi*hi products, so
// the truncated adds of the larger terms meet small sums.
// tools/prof_tma_conv.py measures, at the SAMM scales, the error and the
// time of B2b with its period, with a drain every 16 stages and with none,
// against the plain version: on an H100 the three ran within 2% of each
// other, while the error on sum y2^2 grew from under 1.2e-6 of max|ref|
// (every stage) to 5.7e-6 (16) and 1.8e-5 (none, Ci = 1024), a bias toward
// zero that grows with K. So B2b drains every stage, the most accurate of
// the three at no measured cost. (Two fragment sets, drained while the next
// group runs, made ptxas serialise the wgmmas: C7514.) For the float32 mode
// the same tool measured float32 B5 with a drain every 1, 2 and 4 stages
// and none, on an H100: with none the error grew tenfold (2.3e-4 of
// max|ref| on tf32_cancel_inputs at Ci = 1024, over the 1e-4 tolerance;
// 7.8e-5 on zero-mean inputs), while 1, 2 and 4 stages erred alike
// (2.0e-5-2.2e-5 on the cancelling inputs; 3.9e-6, 3.9e-6 and 4.1e-6 on
// zero-mean ones at 32px). A drain every stage cost 5% at 32px (TH = 2)
// and up to 1% elsewhere; every 2 stages ran as fast as none at all four
// scales. So the float32 conv modes (B5, B2a, B4's and B3's convs) drain every 2
// stages, the most accurate period at no measured cost. float32 B2b
// (AN_CONV2_TF32) drains every TF32_CONV2_DRAIN_STAGES: the same tool
// measured it with a drain every stage, every 2 stages and none, at the
// SAMM scales on an H100. On zero-mean inputs sum y2^2 erred by 5.6e-7 to
// 1.0e-6 of max|ref| (every stage), 1.1e-6 to 1.5e-6 (every 2) and 2.8e-5
// to 1.1e-4 (none, a bias toward zero: over the 1e-4 tolerance at 2C =
// 1024); on tf32_cancel_inputs y2 erred by 1.2e-5 to 2.2e-5 with a drain,
// 2.5e-4 without, and sum y2 -- a sum of a y2 that itself cancels -- by
// 1.9e-5 to 1.4e-4 (every stage), up to 7.7e-4 (every 2) and 2.3e-2
// (none). Every stage ran as fast as the others or faster (0.2015 ms
// against 0.2202 and 0.2211 at 32px, within 1% elsewhere). So float32 B2b
// drains every stage, the most accurate period at no measured cost.
//
// Tiling: M = 128 output channels, N = TH x 32 pixels, one sample per
// block; TH = 4, halved while one sample's grid has fewer than 128 blocks
// (at 32px, 1024 -> 1024: TH = 2, 128 blocks): tile_rows.
// (TH = 8, N = 256 with a 2-stage ring, ran slower than TH = 4 at the SAMM
// scales in bfloat16.) A function of (H, W, Co) alone, never of the batch
// size, so every batch slot runs the same sums in the same order.
//
// Epilogues. B2b sums each channel's moments over its tile from the
// registers, in a fixed order, into the (B, n_tiles, 2, Co) scratch that
// sum_tiles_kernel sums in tile order (no atomics); then the consumers
// stage the float32 tile st[channel][pixel] in the ring (B5 and B2a after
// their activation) and store it NCHW along W, 4 pixels a thread, in
// float32 or bfloat16. The packed convs store NHWC, so they stage the tile
// st[pixel][channel] instead, beside the block's d, bias, s2 and (conv2)
// toRGB weights, and store along channels, 4 channels a thread, a warp's
// 128 channels of one pixel (stage_epilogue).
//
// The tensor maps are __grid_constant__ kernel arguments, encoded on the
// host at every launch by cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the build links nothing beyond the runtime.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <chrono>
#include <type_traits>

namespace tma {

constexpr float SQRT2 = 1.41421356237309515f;
constexpr int SMEM_MAX = 232448;       // dynamic shared memory a block may use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// v = hi + lo: hi = v rounded to a 10-bit mantissa (half away from zero),
// lo = v - hi, exact in float32; the tensor cores read the top 19 bits of each
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
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

constexpr int TW = 32;                 // pixel tile columns
constexpr int BM = 128;                // output channels per block
constexpr int ROW = 128;               // bytes of a K-block row: one swizzle atom row
constexpr int A_TAP = BM * ROW;        // one tap's weights: 16 KB
constexpr int A_BYTES = 3 * A_TAP;
constexpr int THREADS = 384;           // producer warpgroup + two consumer warpgroups
constexpr int ACT_NONE = 0, ACT_PRELU = 1;
// CONV_ACT (B5, B2a) and AN_CONV2 (B2b) on bfloat16 operands; on float32
// ones (words) CONV_ACT_TF32 (B5, B2a) and AN_CONV2_TF32 (B2b). The packed
// convs, NHWC (stage_epilogue): B4's conv1, z out as conv2's operand
// (STAGE1_TF32 words, STAGE1 bfloat16), B4's conv2, z2 and the toRGB
// partials out (STAGE2_TF32, STAGE2), and B3, its output in the operand
// type (PACKED_TF32 float32, PACKED bfloat16). Each predicate below names
// its modes.
enum Mode { CONV_ACT = 0, AN_CONV2 = 1, CONV_ACT_TF32 = 2, AN_CONV2_TF32 = 3, STAGE1_TF32 = 4,
            STAGE2_TF32 = 5, STAGE1 = 6, STAGE2 = 7, PACKED_TF32 = 8, PACKED = 9 };
template <int MODE> constexpr bool is_tf32 = MODE == CONV_ACT_TF32 || MODE == AN_CONV2_TF32 ||
                                             MODE == STAGE1_TF32 || MODE == STAGE2_TF32 ||
                                             MODE == PACKED_TF32;
template <int MODE> constexpr bool is_conv2 = MODE == AN_CONV2 || MODE == AN_CONV2_TF32;
template <int MODE> constexpr bool writes_operand = MODE == STAGE1 || MODE == STAGE1_TF32;
template <int MODE> constexpr bool writes_rgb = MODE == STAGE2 || MODE == STAGE2_TF32;
template <int MODE> constexpr bool is_stage =
    writes_operand<MODE> || writes_rgb<MODE> || MODE == PACKED_TF32 || MODE == PACKED;
static_assert(!is_tf32<STAGE1> && !is_tf32<STAGE2> && is_tf32<STAGE1_TF32> &&
              is_tf32<PACKED_TF32> && !is_tf32<PACKED> && is_stage<PACKED> &&
              !writes_operand<PACKED> && !writes_rgb<PACKED> && !is_stage<AN_CONV2_TF32>,
              "each mode's operand type");
// the elements of a K-block row: 64 bfloat16 channels, or 32 float32 words
// (16 channels' hi words, then their lo words)
template <int MODE> constexpr int KE = is_tf32<MODE> ? 32 : 64;
constexpr int TF32_GROUP = 16;         // channels of a float32 K-block
// drain periods in stages (see the note on accumulation): bfloat16 B2b's of
// 3 taps x 64 channels, the float32 modes' of 3 taps x 16 channels
constexpr int DRAIN_STAGES = 1;
constexpr int TF32_DRAIN_STAGES = 2;
constexpr int TF32_CONV2_DRAIN_STAGES = 1;
// a mode's drain period in stages; 0: none (bfloat16 B5, B2a, B4 and B3)
template <int MODE> __host__ __device__ constexpr int drain_period() {
  return MODE == AN_CONV2 ? DRAIN_STAGES
         : MODE == AN_CONV2_TF32 ? TF32_CONV2_DRAIN_STAGES
         : is_tf32<MODE> ? TF32_DRAIN_STAGES : 0;
}
// the packed stage's staged tile: the pixel stride in floats, so that the
// fragment writes and a warp's float4 reads along channels hit every bank
// once; behind it the block's d, bias, s2 and toRGB weights (3 + 12 per
// channel) and the tile's noise (4 per pixel)
constexpr int STAGE_SP = BM + 4;
constexpr int STAGE_TABLES = 15 * BM;

template <int TH> struct Cfg {
  static constexpr int N = TH * TW, ND = N / 2;
  static constexpr int B_BYTES = (TH + 2) * TW * ROW;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int S = 3;                             // stages in the ring
  static constexpr int RING = S * STAGE;
  static constexpr int OS = N + 4;                        // staged row stride, floats
  static constexpr int SMEM = RING + 2 * S * 8 + 1024;    // + mbarriers + alignment
  static_assert(BM * OS * 4 <= RING, "the staged tile fits in the ring");
  static_assert((N * STAGE_SP + STAGE_TABLES + 4 * N) * 4 <= RING,
                "the stage epilogue fits in the ring");
  static_assert(SMEM <= SMEM_MAX, "the ring fits in shared memory");
};

struct Args {
  const float* alpha;     // (Co,) PReLU slopes (act 1)
  void* out;              // (B, Co, H, W): bfloat16 (CONV_ACT) or float32; the packed convs
                          // NHWC: STAGE1(_TF32) z (B, H, W, out_cp) bfloat16 or (B, H, W,
                          // 2 out_cp) words; STAGE2(_TF32) z2, PACKED(_TF32) out (B, H, W,
                          // Co) in the operand type
  float* tile_part;       // B2b: (B, n_tiles, 2, Co)
  int H, W, Co, act, tiles_w, n_tiles, iters;
  // the packed convs: noise (B, H, W, 4), read at phase co / (Co / 4); d
  // and bias (B, Co); STAGE1(_TF32): s_out (B, Co) and out_cp, Co padded
  // to the operand's granule; STAGE2(_TF32): k3sr (B, Co, 12) in the
  // operand type and the toRGB partials part (B, gridDim.y, H, W, 12)
  const float *noise, *d, *bias, *s_out;
  const void* k3sr;
  float* part;
  int out_cp;
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

// d (+)= A * B: m64nNk16 on bfloat16 or m64nNk8 on tf32 operands, both
// from shared memory through the descriptors da, db, float32 d; d += unless
// scale_d == 0. TF32 takes no transpose flags: both operands are K-major.
#define TMA_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                  "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TMA_D16 TMA_D8(0), TMA_D8(8)
#define TMA_D32 TMA_D16, TMA_D8(16), TMA_D8(24)
#define TMA_D64 TMA_D32, TMA_D8(32), TMA_D8(40), TMA_D8(48), TMA_D8(56)
#define TMA_R16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define TMA_R32 TMA_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
                "%28, %29, %30, %31"
#define TMA_R64 TMA_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
                "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
                "%58, %59, %60, %61, %62, %63"
// one wgmma INSTR (shape and types) whose accumulator is REGS (constraints
// DOUT), then da, db and scale_d as the operands DA, DB, SC; TAIL: the
// flags after scale-a and scale-b
#define TMA_WGMMA(INSTR, REGS, DOUT, DA, DB, SC, TAIL)                                       \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SC ", 0;\n"                                \
               "wgmma.mma_async.sync.aligned." INSTR " {" REGS "}, " DA ", " DB               \
               ", p, 1, 1" TAIL ";\n}\n"                                                      \
               : DOUT : "l"(da), "l"(db), "r"(scale_d))

template <int N, bool TF32>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (TF32) {
    if constexpr (N == 32)
      TMA_WGMMA("m64n32k8.f32.tf32.tf32", TMA_R16, TMA_D16, "%16", "%17", "%18", "");
    else if constexpr (N == 64)
      TMA_WGMMA("m64n64k8.f32.tf32.tf32", TMA_R32, TMA_D32, "%32", "%33", "%34", "");
    else
      TMA_WGMMA("m64n128k8.f32.tf32.tf32", TMA_R64, TMA_D64, "%64", "%65", "%66", "");
  } else {
    if constexpr (N == 32)
      TMA_WGMMA("m64n32k16.f32.bf16.bf16", TMA_R16, TMA_D16, "%16", "%17", "%18", ", 0, 0");
    else if constexpr (N == 64)
      TMA_WGMMA("m64n64k16.f32.bf16.bf16", TMA_R32, TMA_D32, "%32", "%33", "%34", ", 0, 0");
    else
      TMA_WGMMA("m64n128k16.f32.bf16.bf16", TMA_R64, TMA_D64, "%64", "%65", "%66", ", 0, 0");
  }
}

__device__ __forceinline__ float activate(float v, int act, float slope) {
  if (act != ACT_NONE) v = v >= 0.0f ? v : slope * v;
  if (act == 2) v *= SQRT2;
  return v;
}

// The packed convs' epilogues on a block's float32 sums acc (the
// accumulator layout of tma_conv_kernel), by its 256 consumer threads (ct),
// NHWC, with a = lrelu(acc * d + noise[phase] + bias) * sqrt(2):
//   STAGE1_TF32, STAGE1: z = a * s_out, stored as conv2's operand: words
//        (per 16 channels their hi words, then their lo words, split_tf32)
//        or one rounding to bfloat16; the channels from Co to out_cp zero;
//   STAGE2_TF32, STAGE2: z2 = a, stored in float32 or rounded once to
//        bfloat16, then each pixel's toRGB partial of z2 as stored over the
//        block's channels, in channel order, into part[b, blockIdx.y, y, x, :];
//   PACKED_TF32, PACKED: a, stored in float32 or rounded once to bfloat16.
// The tile is staged st[pixel][channel] in the ring, which both consumer
// warpgroups are done with, so that a warp stores the 128 channels of one
// pixel; the block's d, bias, s_out and toRGB weights and the tile's noise
// lie behind it, so that the stores' loop reads no global memory (the
// compiler could not move such reads ahead of the stores). A bfloat16 store
// is 8 bytes: Co and out_cp are multiples of 4, so every row and every
// 4-channel group starts on 8 bytes.
template <int MODE, int TH>
__device__ __forceinline__ void stage_epilogue(const float* acc, float* st, const Args& a, int ct,
                                               int m0, int tig, int b, int y0, int x0, int n0) {
  constexpr int N = Cfg<TH>::N, ND = Cfg<TH>::ND, SP = STAGE_SP;
  constexpr bool CONV1 = writes_operand<MODE>, RGB = writes_rgb<MODE>, BF16 = !is_tf32<MODE>;
  const int H = a.H, W = a.W, Co = a.Co, cmid = Co / 4;
  const int out_c = CONV1 ? a.out_cp : Co;     // channels of an output row
  float* cd = st + N * SP;
  float* cb = cd + BM;
  float* cs = cb + BM;
  float* k3 = cs + BM;
  float* nz = k3 + 12 * BM;
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  for (int n = ct; n < BM; n += 256) {
    const int64_t i = (int64_t)b * Co + n0 + n;
    const bool in = n0 + n < Co;
    cd[n] = in ? a.d[i] : 0.0f;
    cb[n] = in ? a.bias[i] : 0.0f;
    if constexpr (CONV1) cs[n] = in ? a.s_out[i] : 1.0f;
  }
  if constexpr (RGB) {
    const int64_t k0 = ((int64_t)b * Co + n0) * 12;
    for (int e = ct; e < BM * 12; e += 256) {
      float v = 0.0f;
      if (n0 + e / 12 < Co) {
        if constexpr (BF16) v = __bfloat162float(static_cast<const __nv_bfloat16*>(a.k3sr)[k0 + e]);
        else v = static_cast<const float*>(a.k3sr)[k0 + e];
      }
      k3[e] = v;
    }
  }
  for (int e = ct; e < N * 4; e += 256) {
    const int gy = y0 + e / 4 / TW, gx = x0 + e / 4 % TW;
    nz[e] = gy < H && gx < W ? a.noise[(((int64_t)b * H + gy) * W + gx) * 4 + e % 4] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const int n = m0 + ((i >> 1) & 1) * 8, px = (i >> 2) * 8 + 2 * tig + (i & 1);
    st[px * SP + n] = acc[i];
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  for (int idx = ct; idx < N * (BM / 4); idx += 256) {
    const int px = idx / (BM / 4), n = idx % (BM / 4) * 4, co = n0 + n;
    const int gy = y0 + px / TW, gx = x0 + px % TW;
    if (gy >= H || gx >= W || co >= out_c) continue;
    const int64_t pix = ((int64_t)b * H + gy) * W + gx;
    float* sp = st + px * SP + n;
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {          // Co % 4 == 0: all 4 channels or none
      float z = 0.0f;
      if (co < Co) {
        z = sp[u] * cd[n + u] + nz[px * 4 + (co + u) / cmid] + cb[n + u];
        z = (z >= 0.0f ? z : 0.2f * z) * SQRT2;
        if constexpr (CONV1) z *= cs[n + u];
      }
      v[u] = z;
    }
    if constexpr (BF16) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + pix * out_c + co) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
      if constexpr (RGB) {                 // toRGB reads z2 as stored
        sp[0] = __low2float(lo);
        sp[1] = __high2float(lo);
        sp[2] = __low2float(hi);
        sp[3] = __high2float(hi);
      }
    } else if constexpr (CONV1) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) split_tf32(v[u], hi[u], lo[u]);
      float* o = static_cast<float*>(a.out) + pix * 2 * a.out_cp +
                 co / TF32_GROUP * 2 * TF32_GROUP + co % TF32_GROUP;
      *reinterpret_cast<uint4*>(o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(o + TF32_GROUP) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + pix * Co + co) =
          make_float4(v[0], v[1], v[2], v[3]);
      if constexpr (RGB) {
#pragma unroll
        for (int u = 0; u < 4; ++u) sp[u] = v[u];   // toRGB reads z2 as stored
      }
    }
  }
  if constexpr (RGB) {
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    // per pixel, 6 of the 12 outputs a thread, summed over the block's
    // channels in channel order
    const int nc = min(BM, Co - n0);
    for (int idx = ct; idx < N * 2; idx += 256) {
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
          for (int o = 0; o < 6; ++o) s[o] += zz[u] * k3[(n + u) * 12 + og + o];
      }
      float* p = a.part + ((((int64_t)b * gridDim.y + blockIdx.y) * H + gy) * W + gx) * 12 + og;
#pragma unroll
      for (int o = 0; o < 6; ++o) p[o] = s[o];
    }
  }
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
  constexpr bool CONV2 = is_conv2<MODE>, TF32 = is_tf32<MODE>;
  constexpr bool F32_OUT = CONV2 || TF32;        // the NCHW modes' float32 outputs
  constexpr bool DRAIN = drain_period<MODE>() > 0;
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
        const int c0 = it / 3 * KE<MODE>, dx = it % 3;
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

  // the wgmmas of iteration it into d; the first starts d anew unless
  // `scale`. bfloat16: taps dy = 0..2 x 4 steps of 16 channels (12).
  // float32: the products lo*hi, then hi*lo, then hi*hi (the small cross
  // terms first, while the fresh sums are small), each over taps dy = 0..2
  // x 2 steps of 8 channels (18); a row's hi words are its first 64 bytes,
  // its lo words the next 64.
  auto issue = [&](int it, float* d, int scale) {
    const uint32_t st = ring + (it % S) * C::STAGE;
    const uint32_t a0 = st + cw * 64 * ROW, b0 = st + A_BYTES;
    if constexpr (TF32) {
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            wgmma<N, true>(d, sw128_desc(a0 + dy * A_TAP + (p == 0 ? 64 : 0) + kk * 32),
                           sw128_desc(b0 + dy * TW * ROW + (p == 1 ? 64 : 0) + kk * 32),
                           p + dy + kk > 0 ? 1 : scale);
    } else {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma<N, false>(d, sw128_desc(a0 + dy * A_TAP + kk * 32),
                          sw128_desc(b0 + dy * TW * ROW + kk * 32), dy + kk > 0 ? 1 : scale);
    }
  };

  // The K loop, in periods of drain_period<MODE>() stages, whose products
  // go into t, fresh, and are added to acc once their groups have completed
  // (the drain; while a warpgroup drains, the other one's wgmmas keep the
  // tensor cores busy); bfloat16 B5's, B2a's, B4's and B3's of all stages,
  // straight into acc.
  // Within a period the previous stage's group runs on as the next one is
  // issued.
  float acc[ND], t[DRAIN ? ND : 1];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.0f;
  float* const d = DRAIN ? t : acc;
  const int period = DRAIN ? drain_period<MODE>() : a.iters;
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
      if constexpr (DRAIN) acc[i] += t[i];
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

  if constexpr (is_stage<MODE>) {
    stage_epilogue<MODE, TH>(acc, reinterpret_cast<float*>(smem), a, ct, m0, tig, b, y0, x0, n0);
    return;
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
      if constexpr (F32_OUT) {
        *reinterpret_cast<float4*>(static_cast<float*>(a.out) + o) = v;
      } else {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + o) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
      }
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
      for (int j = 0; j < 4 && gx + j < W; ++j) {
        if constexpr (F32_OUT) static_cast<float*>(a.out)[o + j] = e[j];
        else static_cast<__nv_bfloat16*>(a.out)[o + j] = __float2bfloat16_rn(e[j]);
      }
    }
  }
}

// The layout pass ahead of the conv: xr (B, H * W, Cp) from x (B, C, H * W)
// and wr (3 [dx], 3 [dy], Co, Cp) from k (Co, C, 3, 3), channels C..Cp-1
// zero. It moves bytes only, but in its x1 mode (X1, B2a) computes the
// input's values from s = x and t (B, C / 2, H * W) and the coefficients
// (x1_value), and in its float32 form (repack_tf32_kernel) splits each
// value into its hi and lo words. Each transpose goes through shared memory
// so that reads and writes both run along contiguous rows. Blocks [0,
// xblocks) transpose 64 channels x 64 pixels of x each (grid.y: the
// sample); blocks from xblocks on take WCHUNK channels of one output
// channel of k (grid.y 0). E: the element's bits (bfloat16) or float32.
template <typename E> struct Repack {
  const E* x;                 // x, or s (X1)
  const E* t;                 // X1: t
  const float* coeffs;        // X1: (B, 5, C / 2) [as, at, b1, ct, b2]
  const E* k;
  E* xr;
  E* wr;
  int C, HW, Cp, Co, xtiles_p, xblocks;
};

constexpr int WCHUNK = 512;      // channels of k per block

// x1 of one value: (as*s + at*t) + b1 in the s half, ct*t + b2 in the t
// half, each product and sum rounded to float32 as the plain version's
// (ops/alignnet.py:alignnet_x1). cf points at the channel's as, the other
// coefficients C apart (C = x1's channels / 2).
__device__ __forceinline__ float x1_value(const float* cf, int C, bool s_half, float s, float t) {
  return s_half ? __fadd_rn(__fadd_rn(__fmul_rn(cf[0], s), __fmul_rn(cf[C], t)), cf[2 * C])
                : __fadd_rn(__fmul_rn(cf[3 * C], t), cf[4 * C]);
}

// the same from float32 bit patterns s, t, rounded once to bfloat16 bits
__device__ __forceinline__ uint32_t x1_bits(const float* cf, int C, bool s_half, uint32_t s,
                                            uint32_t t) {
  return __bfloat16_as_ushort(
      __float2bfloat16_rn(x1_value(cf, C, s_half, __uint_as_float(s), __uint_as_float(t))));
}

// the input's channel c (< r.C) of sample b at pixels p and p + 1 (p even,
// H * W even) as two bfloat16 in one word, p's in the low half; X1: x1's
template <bool X1>
__device__ __forceinline__ uint32_t input_pair(const Repack<unsigned short>& r, int b, int c,
                                               int p) {
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
__device__ __forceinline__ unsigned short input_at(const Repack<unsigned short>& r, int b, int c,
                                                   int p) {
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

// the bfloat16 form: two bfloat16 (4 bytes) a thread where the layout allows
template <bool X1>
__global__ void __launch_bounds__(256) repack_kernel(const Repack<unsigned short> r) {
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

// Word j of a float32 row (Cp channels as 2 Cp words, TF32_GROUP channels'
// hi words, then their lo words, for each group of channels): the channel
// of the row it holds, and whether it is the lo word
__device__ __forceinline__ int tf32_channel(int j) {
  return j / (2 * TF32_GROUP) * TF32_GROUP + j % TF32_GROUP;
}
__device__ __forceinline__ float tf32_word(float v, int j) {
  uint32_t hi, lo;
  split_tf32(v, hi, lo);
  return __uint_as_float(j / TF32_GROUP % 2 ? lo : hi);
}

// the input's channel c (< r.C) of sample b at pixel p; X1: x1's
template <bool X1>
__device__ __forceinline__ float input_f32(const Repack<float>& r, int b, int c, int p) {
  if constexpr (!X1) {
    return r.x[((int64_t)b * r.C + c) * r.HW + p];
  } else {
    const int C = r.C / 2, cs = c < C ? c : c - C;
    const int64_t i = ((int64_t)b * C + cs) * r.HW + p;
    return x1_value(r.coeffs + (int64_t)b * 5 * C + cs, C, c < C, c < C ? r.x[i] : 0.0f, r.t[i]);
  }
}

// the float32 form: xr (B, H * W, 2 Cp) and wr (3, 3, Co, 2 Cp) in words,
// Cp a multiple of TF32_GROUP; each value's hi and lo split once here
template <bool X1>
__global__ void __launch_bounds__(256) repack_tf32_kernel(const Repack<float> r) {
  __shared__ float sm[WCHUNK * 9];
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < r.xblocks) {
    constexpr int LD = 65;       // tile row stride: [64 channels][64 pixels + 1]
    const int b = blockIdx.y, p0 = blockIdx.x % r.xtiles_p * 64, c0 = blockIdx.x / r.xtiles_p * 64;
    const int tx = tid & 63, ty = tid >> 6;
    for (int i = ty; i < 64; i += 4) {
      const int c = c0 + i, p = p0 + tx;
      sm[i * LD + tx] = c < r.C && p < r.HW ? input_f32<X1>(r, b, c, p) : 0.0f;
    }
    __syncthreads();
    // a pixel's 64 channels are 128 consecutive words from word 2 c0
    float* dst = r.xr + (int64_t)b * r.HW * 2 * r.Cp + 2 * c0;
    for (int e = tid; e < 64 * 128; e += 256) {
      const int p = e / 128, j = e % 128, c = tf32_channel(j);
      if (p0 + p < r.HW && c0 + c < r.Cp)
        dst[(int64_t)(p0 + p) * 2 * r.Cp + j] = tf32_word(sm[c * LD + p], j);
    }
    return;
  }
  if (blockIdx.y != 0) return;
  const int j = blockIdx.x - r.xblocks, per_co = (r.Cp + WCHUNK - 1) / WCHUNK;
  const int co = j / per_co, c0 = j % per_co * WCHUNK;
  const float* src = r.k + ((int64_t)co * r.C + c0) * 9;
  const int n = max(0, min(WCHUNK, r.C - c0)) * 9;
  if (r.C % 4 == 0 && reinterpret_cast<uintptr_t>(r.k) % 16 == 0) {   // 16-byte rows
    for (int i = tid; i < n / 4; i += 256)
      reinterpret_cast<float4*>(sm)[i] = reinterpret_cast<const float4*>(src)[i];
  } else {
    for (int i = tid; i < n; i += 256) sm[i] = src[i];
  }
  __syncthreads();
  const int words = min(2 * WCHUNK, 2 * (r.Cp - c0));
  float* dst = r.wr + (int64_t)co * 2 * r.Cp + 2 * c0;
  for (int tap = 0; tap < 9; ++tap) {     // wr's tap dx * 3 + dy is k's dy * 3 + dx
    const int t = tap % 3 * 3 + tap / 3;
    for (int e = tid; e < words; e += 256) {
      const int c = tf32_channel(e);
      dst[(int64_t)tap * r.Co * 2 * r.Cp + e] = tf32_word(c0 + c < r.C ? sm[c * 9 + t] : 0.0f, e);
    }
  }
}

// ---------------------------------------------------------------- host

// the repack of x (B, C, H, W) and k (Co, C, 3, 3) into xr (B, H, W, Cp)
// and wr (3, 3, Co, Cp), all bfloat16 (E = unsigned short: Cp a multiple of
// 8), or into xr (B, H, W, 2 Cp) and wr (3, 3, Co, 2 Cp) float32 words from
// float32 (E = float: Cp a multiple of TF32_GROUP); with t (nullptr
// otherwise), its x1 mode: xr holds x1 built from s = x and t (B, C / 2, H,
// W) and coeffs (B, 5, C / 2) float32
template <typename E>
int repack(const void* x, const void* t, const float* coeffs, const void* k, void* xr, void* wr,
           int B, int C, int H, int W, int Co, int Cp, cudaStream_t stream) {
  Repack<E> r{static_cast<const E*>(x), static_cast<const E*>(t), coeffs, static_cast<const E*>(k),
              static_cast<E*>(xr), static_cast<E*>(wr), C, H * W, Cp, Co, (H * W + 63) / 64, 0};
  r.xblocks = r.xtiles_p * ((Cp + 63) / 64);
  const dim3 grid(r.xblocks + Co * ((Cp + WCHUNK - 1) / WCHUNK), B);
  if constexpr (std::is_same<E, float>::value) {
    if (t == nullptr) repack_tf32_kernel<false><<<grid, 256, 0, stream>>>(r);
    else repack_tf32_kernel<true><<<grid, 256, 0, stream>>>(r);
  } else {
    if (t == nullptr) repack_kernel<false><<<grid, 256, 0, stream>>>(r);
    else repack_kernel<true><<<grid, 256, 0, stream>>>(r);
  }
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

// The two tensor maps of a launch: the weights w (3 [dx], 3 [dy], Co, K)
// as a 3-D map {K, Co, 9} with boxes {KE, 128, 3}, the input x (B, H, W, K)
// as a 4-D map {K, W, H, B} with boxes {KE, 32, TH + 2, 1}; K elements of
// bfloat16 (KE 64), or of float32 words with f32 (KE 32), 128-byte swizzle,
// zeros out of bounds. 0, or 1001 (no cuTensorMapEncodeTiled), or 1002 (a
// map refused).
inline int encode_maps(CUtensorMap* wmap, CUtensorMap* xmap, const void* w, const void* x, int B,
                       int H, int W, int K, int Co, int TH, bool f32) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return 1001;
  const cuuint64_t k = K, e = f32 ? 4 : 2;
  const cuuint32_t ke = ROW / e;
  const CUtensorMapDataType type = f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t wdim[3] = {k, (cuuint64_t)Co, 9};
  const cuuint64_t wstride[2] = {k * e, (cuuint64_t)Co * k * e};
  const cuuint32_t wbox[3] = {ke, BM, 3};
  const cuuint64_t xdim[4] = {k, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstride[3] = {k * e, (cuuint64_t)W * k * e, (cuuint64_t)H * W * k * e};
  const cuuint32_t xbox[4] = {ke, TW, (cuuint32_t)TH + 2, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (enc(wmap, type, 3, const_cast<void*>(w), wdim, wstride, wbox, ones,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      enc(xmap, type, 4, const_cast<void*>(x), xdim, xstride, xbox, ones,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return 1002;
  return 0;
}

// the least grid per sample: a block on all but 4 of the H100's 132 SMs
constexpr int FILL_BLOCKS = 128;

// The rows TH of a launch's pixel tile of TW columns for an (H, W, Co)
// launch: 4, halved while the grid of one sample, in blocks of BM
// channels, has fewer than FILL_BLOCKS blocks. A function of the sample's
// shape alone, never of the batch size.
inline int tile_rows(int H, int W, int Co) {
  const int blocks_per_row = ((W + TW - 1) / TW) * ((Co + BM - 1) / BM);
  int r = 4;
  while (r > 1 && blocks_per_row * ((H + r - 1) / r) < FILL_BLOCKS) r /= 2;
  return r;
}

// the pixel tiles of such a launch
inline int pixel_tiles(int H, int W, int Co) {
  const int r = tile_rows(H, W, Co);
  return ((W + TW - 1) / TW) * ((H + r - 1) / r);
}

// kernels launched by this library, read by ogi_tma_conv_launches
inline std::atomic<long long>& launches() {
  static std::atomic<long long> n{0};
  return n;
}

// the conv on the repacked xr, wr, K elements a row (bfloat16 channels, or
// float32 words)
template <int MODE, int TH>
int launch_cfg(const void* x, const void* w, Args a, int B, int K, cudaStream_t stream) {
  using C = Cfg<TH>;
  CUtensorMap wmap, xmap;
  const int err = encode_maps(&wmap, &xmap, w, x, B, a.H, a.W, K, a.Co, TH, is_tf32<MODE>);
  if (err != 0) return err;
  a.tiles_w = (a.W + TW - 1) / TW;
  a.n_tiles = a.tiles_w * ((a.H + TH - 1) / TH);
  a.iters = 3 * ((K + KE<MODE> - 1) / KE<MODE>);
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

// the padded channels of a mode's repacked operands: Ci rounded up to a
// multiple of 8 (bfloat16: a TMA stride is a multiple of 16 bytes) or of
// TF32_GROUP (float32: one 128-byte row holds a group's hi and lo words)
template <int MODE> constexpr int padded_channels(int Ci) {
  return is_tf32<MODE> ? (Ci + TF32_GROUP - 1) / TF32_GROUP * TF32_GROUP : (Ci + 7) / 8 * 8;
}

// the conv on the repacked xr (B, H, W, K) and wr (3, 3, Co, K), K elements
// a row, at the tiles of tile_rows(H, W, Co)
template <int MODE>
int conv_tiles(const void* xr, const void* wr, Args a, int B, int K, cudaStream_t stream) {
  const int r = tile_rows(a.H, a.W, a.Co);
  if (r == 4) return launch_cfg<MODE, 4>(xr, wr, a, B, K, stream);
  if (r == 2) return launch_cfg<MODE, 2>(xr, wr, a, B, K, stream);
  return launch_cfg<MODE, 1>(xr, wr, a, B, K, stream);
}

// the repack (x1 mode with t), then the conv on xr, wr; Ci the conv's input
// channels
template <int MODE>
int repack_and_conv(const void* x, const void* t, const float* coeffs, const void* k, void* xr,
                    void* wr, Args a, int B, int Ci, cudaStream_t stream) {
  if (bad_args(a, B, Ci, xr, wr)) return 1000;
  constexpr bool F32 = is_tf32<MODE>;
  const int Cp = padded_channels<MODE>(Ci), K = F32 ? 2 * Cp : Cp;
  using E = std::conditional_t<F32, float, unsigned short>;
  const int err = repack<E>(x, t, coeffs, k, xr, wr, B, Ci, a.H, a.W, a.Co, Cp, stream);
  if (err != 0) return err;
  return conv_tiles<MODE>(xr, wr, a, B, K, stream);
}

// The repack, then the conv: x (B, Ci, H, W) and k (Co, Ci, 3, 3), bfloat16
// (CONV_ACT, AN_CONV2) or float32 (CONV_ACT_TF32, AN_CONV2_TF32); xr and wr scratch for
// their repacked copies, 16-byte aligned: bfloat16 (B, H, W, Cp) and (3, 3,
// Co, Cp), or float32 (B, H, W, 2 Cp) and (3, 3, Co, 2 Cp), Cp =
// padded_channels<MODE>(Ci); the rest of a as Args says.
template <int MODE>
int launch(const void* x, const void* k, void* xr, void* wr, Args a, int B, int Ci,
           cudaStream_t stream) {
  return repack_and_conv<MODE>(x, nullptr, nullptr, k, xr, wr, a, B, Ci, stream);
}

// B2a: the repack's x1 mode from s, t (B, C, H, W) and coeffs (B, 5, C)
// float32, then B5's conv (CONV_ACT or CONV_ACT_TF32; act as a says: PReLU)
// with Ci = Co = 2C = a.Co; k (2C, 2C, 3, 3), xr and wr as launch's.
template <int MODE>
int launch_x1(const void* s, const void* t, const float* coeffs, const void* k, void* xr,
              void* wr, Args a, int B, cudaStream_t stream) {
  if (a.Co % 2 != 0 || t == nullptr || coeffs == nullptr) return 1000;
  return repack_and_conv<MODE>(s, t, coeffs, k, xr, wr, a, B, a.Co, stream);
}

// the mean host time in microseconds of encoding one bfloat16 launch's two
// tensor maps, over `reps` encodings; -1 if an encoding fails
inline double encode_us(const void* x, const void* w, int B, int H, int W, int Ci, int Co, int TH,
                        int reps) {
  CUtensorMap wmap, xmap;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (encode_maps(&wmap, &xmap, w, x, B, H, W, Ci, Co, TH, false) != 0) return -1.0;
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / reps;
}

// the repack pass alone, with the checks of its C entries
template <typename E>
int repack_alone(const void* x, const void* t, const void* coeffs, const void* k, void* xr,
                 void* wr, int B, int C, int H, int W, int Co, int Cp, cudaStream_t stream) {
  const int granule = std::is_same<E, float>::value ? TF32_GROUP : 8;
  if (B <= 0 || B > 65535 || C <= 0 || Co <= 0 || Cp < C || Cp % granule != 0) return 1000;
  return repack<E>(x, t, static_cast<const float*>(coeffs), k, xr, wr, B, C, H, W, Co, Cp, stream);
}

}  // namespace tma

// The number of tma_conv_kernel launches this library has made.
extern "C" long long ogi_tma_conv_launches() { return tma::launches().load(); }

// The repack pass alone (tma::repack; arguments as there), bfloat16: 0 or a
// CUDA error.
extern "C" int ogi_tma_repack(const void* x, const void* k, void* xr, void* wr, int B, int C,
                              int H, int W, int Co, int Cp, void* stream) {
  return tma::repack_alone<unsigned short>(x, nullptr, nullptr, k, xr, wr, B, C, H, W, Co, Cp,
                                           static_cast<cudaStream_t>(stream));
}

// The same in float32: xr (B, H, W, 2 Cp) and wr (3, 3, Co, 2 Cp) float32
// words, Cp a multiple of 16.
extern "C" int ogi_tma_repack_tf32(const void* x, const void* k, void* xr, void* wr, int B, int C,
                                   int H, int W, int Co, int Cp, void* stream) {
  return tma::repack_alone<float>(x, nullptr, nullptr, k, xr, wr, B, C, H, W, Co, Cp,
                                  static_cast<cudaStream_t>(stream));
}

// The repack pass's x1 mode alone (B2a): s, t (B, C, H, W) bfloat16, coeffs
// (B, 5, C) float32, k (2C, 2C, 3, 3) bfloat16 into xr (B, H, W, Cp) and wr
// (3, 3, 2C, Cp); 0 or a CUDA error.
extern "C" int ogi_tma_repack_x1(const void* s, const void* t, const void* coeffs, const void* k,
                                 void* xr, void* wr, int B, int C, int H, int W, int Cp,
                                 void* stream) {
  if (C <= 0) return 1000;
  return tma::repack_alone<unsigned short>(s, t, coeffs, k, xr, wr, B, 2 * C, H, W, 2 * C, Cp,
                                           static_cast<cudaStream_t>(stream));
}

// The same in float32: s, t, k float32 into xr (B, H, W, 2 Cp) and wr (3,
// 3, 2C, 2 Cp) float32 words, Cp a multiple of 16.
extern "C" int ogi_tma_repack_x1_tf32(const void* s, const void* t, const void* coeffs,
                                      const void* k, void* xr, void* wr, int B, int C, int H,
                                      int W, int Cp, void* stream) {
  if (C <= 0) return 1000;
  return tma::repack_alone<float>(s, t, coeffs, k, xr, wr, B, 2 * C, H, W, 2 * C, Cp,
                                  static_cast<cudaStream_t>(stream));
}
