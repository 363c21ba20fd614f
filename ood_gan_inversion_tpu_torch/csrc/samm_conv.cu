// The SAMM AlignNet body0 convolutions, for Hopper (sm_90a). Three entry
// points compute a pad-1 3x3 convolution (NCHW activations, OIHW weights,
// zero padding 1, float32 sums):
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
// conv3x3_act and alignnet_conv2 run on the tensor cores (tc_conv_kernel),
// as an implicit GEMM per block with wgmma: M = 128 output channels (two
// warpgroups of 64), N = the output pixels of one sample's tile (R rows of
// 32 columns), K = Ci * 9, taken KC input channels at a time (8 for
// float32, 16 for bfloat16: one wgmma's K) and tap by tap. For one chunk a
// block holds
//   - the weight slab k[n0:n0+128, c0:c0+KC, :, :], which in OIHW is 128
//     rows of KC * 9 contiguous values, copied as it is with cp.async into
//     a ring of NSTAGE = 3 buffers, two chunks ahead; 16-byte copies where
//     the row stride Ci * 9 * sizeof(T) allows, else 8 or 4 bytes, else
//     (bfloat16 with an odd Ci) plain loads; rows beyond Co and channels
//     beyond Ci are zero-filled by the copy;
//   - the input chunk with its 1-pixel halo, (R + 2) x 34 pixels, 0 outside
//     the image and beyond Ci, loaded one chunk ahead into registers while
//     the current chunk computes, then stored in wgmma's K-major B layout
//     (see Tile).
// The weights are wgmma's A operand, from registers: for each tap a warp
// gathers its 16 channels x KC values from the slab. The input is its B
// operand, from shared memory: the tap's shifted window is a descriptor.
// A 3x3 conv is 9 such products per chunk, so nothing is rearranged in
// shared memory and no im2col is built. wgmma groups run asynchronously,
// two in flight: the next A-fragments are gathered and split while the
// tensor cores work.
//
// float32 operands run 3xTF32: each operand v is split into hi = v rounded
// to TF32 (10-bit mantissa) and lo = v - hi, and each product accumulates
// lo*hi + hi*lo + hi*hi in float32 (lo*lo, ~2^-22 relative, is dropped). The
// input is split once, as the chunk is stored (hi and lo planes); a weight
// is split in registers as its A-fragment is gathered. That is float32-grade
// accuracy, where a single TF32 pass would err by ~2^-11 per product.
// bfloat16 operands take one bf16 pass.
//
// The tensor cores add into their float32 accumulator with truncation, not
// rounding to nearest: 1152 such adds per output at Ci = 1024 (x3 for
// 3xTF32) bias the sums toward zero by ~1e-4 relative, which norm2's moments
// (a sum over the pixels) show in full. So each chunk's products go into
// fragments that start anew with the chunk, and those are added to the
// accumulator on the CUDA cores, rounded to nearest: the truncation acts on
// a sum of 72 products only. For float32 the small cross terms of all 9 taps
// go in first, so only the 9 hi*hi adds meet a large fragment sum. Both
// matter on the card test whose inputs are 1 + 0.1 noise: there a chunk's
// partial sum is the same at every pixel, so its truncation adds up over a
// moment's pixel sum.
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
//
// alignnet_conv1 runs a direct convolution on the CUDA cores (conv1_kernel):
// a block computes an 8 x 16 pixel tile for 128 output channels, each
// thread 8 rows x 8 channels in float32, with synchronous loads. Its x1
// prologue (the affine of s and t with a zero ring) is what a move onto
// tc_conv_kernel needs: it belongs where tc_conv_kernel loads the input
// chunk into registers, before the store into xs, and nothing else there
// changes.
//
// Plain C interface (bound with ctypes): launches on the given stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float SQRT2 = 1.41421356237309515f;

enum Act { ACT_NONE = 0, ACT_PRELU = 1, ACT_LRELU = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float activate(float v, int act, float slope) {
  if (act != ACT_NONE) v = v >= 0.0f ? v : slope * v;
  if (act == ACT_LRELU) v *= SQRT2;
  return v;
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
  int vec;                // tensor-core core: bytes per weight copy (16, 8, 4; 2 = plain loads)
};

// ------------------------------------------------- tensor-core core (B5, B2b)

constexpr int NSTAGE = 3;          // weight slabs in flight
// the least grid per sample: a block on all but 4 of the H100's 132 SMs
constexpr int FILL_BLOCKS = 128;
constexpr int THREADS = 256;       // two warpgroups
constexpr int TN = 128;            // output channels per block, 64 per warpgroup

// Per operand type: input channels per chunk (the K of one wgmma at one
// tap), planes of the input chunk in shared memory (float32: hi and lo),
// and the row stride of a weight slab in elements (the slab's KC * 9 values
// and a pad; a multiple of 16 bytes, and = 12 words mod 32, so that an
// A-fragment read, 8 rows x 4 channels at channel stride 9, hits 32 banks).
template <typename T> struct Op;
template <> struct Op<float> {
  static constexpr int KC = 8, PLANES = 2, WS = 76;
};
template <> struct Op<__nv_bfloat16> {
  static constexpr int KC = 16, PLANES = 1, WS = 152;
};

// A pixel tile of R rows x 32 columns. The input chunk is held with its
// halo, (R + 2) x 34 pixels, as wgmma's K-major B operand without swizzle:
// each pixel's KC channels are 32 bytes, stored as two 16-byte halves
// (channels 0..3 and 4..7 for float32, 0..7 and 8..15 for bfloat16), each
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
  static constexpr int PLANE = 2 * HALF;
  static constexpr int OS = P + 4;                   // channel stride of the staged output
  static_assert(2 * XN + 2 + N <= XPIX + 8, "the last tap's run stays in its half");
};

template <typename T, class C> __host__ __device__ constexpr int ring_bytes() {
  return NSTAGE * TN * Op<T>::WS * (int)sizeof(T);
}
template <typename T, class C> __host__ __device__ constexpr int xs_offset() {
  return ring_bytes<T, C>() > TN * C::OS * 4 ? ring_bytes<T, C>() : TN * C::OS * 4;
}
template <typename T, class C> __host__ __device__ constexpr int smem_bytes() {
  return xs_offset<T, C>() + 2 * Op<T>::PLANES * C::PLANE;
}

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

// d (+)= a * b: m64nNk8 tf32 or m64nNk16 bf16, A (64 x K) from registers,
// B from shared memory through desc; d += unless scale_d == 0
__device__ __forceinline__ void wgmma_tf32_n32(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32_n72(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35 "
      "}, {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32_n136(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67 "
      "}, {%68, %69, %70, %71}, %72, p, 1, 1;\n}\n"
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

template <typename T, int N>
__device__ __forceinline__ void wgmma(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (N == 32) wgmma_tf32_n32(d, a, desc, scale_d);
    else if constexpr (N == 72) wgmma_tf32_n72(d, a, desc, scale_d);
    else wgmma_tf32_n136(d, a, desc, scale_d);
  } else {
    if constexpr (N == 32) wgmma_bf16_n32(d, a, desc, scale_d);
    else if constexpr (N == 72) wgmma_bf16_n72(d, a, desc, scale_d);
    else wgmma_bf16_n136(d, a, desc, scale_d);
  }
}

// Block (pixel tile, channel block, sample): two warpgroups, warpgroup g
// computes the block's channels 64 g .. 64 g + 63 (wgmma's M) for the whole
// tile, the flat run of N pixels. Warp w of a warpgroup holds channels
// 16 w + gid and 16 w + gid + 8 of it (gid = lane / 4, tig = lane % 4): the
// rows of its A-fragments and of its accumulator fragments.
template <typename T, bool CONV2, class C>
__global__ void __launch_bounds__(THREADS, 1) tc_conv_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int KC = Op<T>::KC, WS = Op<T>::WS, N = C::N, R = C::R, P = C::P;
  constexpr int XN = C::XN, TW = C::TW, XELEMS = KC * C::XPIX;
  constexpr int LD = (XELEMS + THREADS - 1) / THREADS;   // input values per thread
  constexpr int ND = N / 2;                               // accumulators
  T* ws = reinterpret_cast<T*>(smem);
  unsigned char* xs = smem + xs_offset<T, C>();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = (warp >> 2) * 64 + (warp & 3) * 16;      // the warp's first channel
  const int b = blockIdx.z, tile = blockIdx.x;
  const int y0 = (tile / a.tiles_w) * R, x0 = (tile % a.tiles_w) * TW;
  const int n0 = blockIdx.y * TN;
  const int H = a.H, W = a.W, Ci = a.Ci, Co = a.Co, HW = H * W;
  const T* x = static_cast<const T*>(a.x) + (int64_t)b * Ci * HW;
  const T* k = static_cast<const T*>(a.k);
  const int nchunks = (Ci + KC - 1) / KC;

  // the weight slab of `chunk` into ring buffer `stage`: TN rows of KC * 9
  // values, as they lie in OIHW
  auto load_w = [&](int chunk, int stage) {
    const int c0 = chunk * KC;
    const int len = min(KC, Ci - c0) * 9;
    T* dst = ws + stage * TN * WS;
    // a row is 18, 36 or 72 copies for every width and type: loops with
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
    const int per_row = a.vec >= 4 ? KC * 9 * (int)sizeof(T) / a.vec : 0;
    if (per_row == 18) copies(std::integral_constant<int, 18>());
    else if (per_row == 36) copies(std::integral_constant<int, 36>());
    else if (per_row == 72) copies(std::integral_constant<int, 72>());
    else {
      for (int p = tid; p < TN * KC * 9; p += THREADS) {
        const int n = p / (KC * 9), e = p - n * (KC * 9);
        const int co = n0 + n;
        dst[n * WS + e] = co < Co && e < len ? k[((int64_t)co * Ci + c0) * 9 + e] : from_f<T>(0.0f);
      }
    }
  };

  // the input chunk with its halo: into registers, then into xs buffer buf
  // in the B layout (float32: split into the hi and lo planes)
  // element e: channel q of a 16-byte half fastest, then the pixel, then
  // the half; so a warp stores 128 contiguous bytes
  constexpr int QK = KC / 2;
  T xr[LD];
  auto fetch_x = [&](int chunk) {
    const int c0 = chunk * KC;
#pragma unroll
    for (int j = 0; j < LD; ++j) {
      const int e = tid + j * THREADS;
      const int q = e % QK, pix = (e / QK) % C::XPIX, kc = e / (QK * C::XPIX) * QK + q;
      const int r = pix / XN, c = pix - r * XN;
      const int gy = y0 + r - 1, gx = x0 + c - 1, ci = c0 + kc;
      T v = from_f<T>(0.0f);
      if (e < XELEMS && ci < Ci && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = x[(int64_t)ci * HW + gy * W + gx];
      xr[j] = v;
    }
  };
  auto put_x = [&](int buf) {
    unsigned char* base = xs + buf * Op<T>::PLANES * C::PLANE;
#pragma unroll
    for (int j = 0; j < LD; ++j) {
      const int e = tid + j * THREADS;
      if (e >= XELEMS) continue;
      const int q = e % QK, pix = (e / QK) % C::XPIX, half = e / (QK * C::XPIX);
      unsigned char* dst = base + half * C::HALF + pix * 16 + q * (int)sizeof(T);
      if constexpr (sizeof(T) == 4) {
        uint32_t hi, lo;
        split_tf32(xr[j], hi, lo);
        *reinterpret_cast<uint32_t*>(dst) = hi;
        *reinterpret_cast<uint32_t*>(dst + C::PLANE) = lo;
      } else {
        *reinterpret_cast<T*>(dst) = xr[j];
      }
    }
    // these generic-proxy stores are read by wgmma through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  float acc[ND], t[ND];
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nchunks) load_w(s, s);
    cp_async_commit();
  }
  fetch_x(0);
  put_x(0);

  const uint32_t xs_base = smem_addr(xs);
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<NSTAGE - 2>();     // this thread's copies of chunk ch landed
    __syncthreads();                 // everyone's, and xs[ch % 2]; chunk ch - 1 is done
    if (ch + NSTAGE - 1 < nchunks) load_w(ch + NSTAGE - 1, (ch + NSTAGE - 1) % NSTAGE);
    cp_async_commit();
    if (ch + 1 < nchunks) fetch_x(ch + 1);

    const T* wb = ws + (ch % NSTAGE) * TN * WS + (m0 + gid) * WS;
    const uint32_t xb = xs_base + (ch & 1) * Op<T>::PLANES * C::PLANE;
    // float32: the cross terms lo*hi + hi*lo of all 9 taps first, while the
    // fragment sums stay small, then the 9 hi*hi products (see the note on
    // truncation); bfloat16: one pass
    constexpr int STEPS = sizeof(T) == 4 ? 18 : 9;
#pragma unroll
    for (int step = 0; step < STEPS; ++step) {
      // two sets of A-fragments: set step % 2 is rewritten once the wgmma
      // group of step - 2, which read it, has completed
      const int tap = step % 9, dy = tap / 3, dx = tap % 3, s = step & 1;
      float w[4];
      uint32_t wbf[4];
      if constexpr (sizeof(T) == 4) {
        const float* wp = reinterpret_cast<const float*>(wb) + tap;
        w[0] = wp[tig * 9];                  // (channel gid, k tig)
        w[1] = wp[8 * WS + tig * 9];         // (gid + 8, tig)
        w[2] = wp[(tig + 4) * 9];            // (gid, tig + 4)
        w[3] = wp[8 * WS + (tig + 4) * 9];   // (gid + 8, tig + 4)
      } else {
        const T* wp = wb + tap;
        wbf[0] = pack_bf16(wp[2 * tig * 9], wp[(2 * tig + 1) * 9]);
        wbf[1] = pack_bf16(wp[8 * WS + 2 * tig * 9], wp[8 * WS + (2 * tig + 1) * 9]);
        wbf[2] = pack_bf16(wp[(2 * tig + 8) * 9], wp[(2 * tig + 9) * 9]);
        wbf[3] = pack_bf16(wp[8 * WS + (2 * tig + 8) * 9], wp[8 * WS + (2 * tig + 9) * 9]);
      }
      wgmma_wait<1>();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        pin(ah[s][q]);
        pin(al[s][q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (sizeof(T) == 4) split_tf32(w[q], ah[s][q], al[s][q]);
        else ah[s][q] = wbf[q];
      }
      wgmma_fence();
      const uint32_t at = xb + (dy * XN + dx) * 16;
      const uint64_t hi = make_desc(at, C::HALF, 128);
      if constexpr (sizeof(T) == 4) {
        if (step < 9) {
          const uint64_t lo = make_desc(at + C::PLANE, C::HALF, 128);
          wgmma<T, N>(t, al[s], hi, step > 0);     // t = products, from step 0 on
          wgmma<T, N>(t, ah[s], lo, 1);
        } else {
          wgmma<T, N>(t, ah[s], hi, 1);
        }
      } else {
        wgmma<T, N>(t, ah[s], hi, step > 0);
      }
      wgmma_commit();
    }
    // the next input chunk into xs[(ch + 1) % 2], while the last groups run:
    // chunk ch - 1's groups, which read that buffer, completed before tap 2
    if (ch + 1 < nchunks) put_x((ch + 1) & 1);
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
    if (r < R && c < TW) st[n * C::OS + r * TW + c] = activate(acc[i], act, slope[(i >> 1) & 1]);
  }
  __syncthreads();
  for (int idx = tid; idx < TN * P; idx += THREADS) {
    const int n = idx / P, px = idx - n * P;
    const int co = n0 + n, gy = y0 + px / TW, gx = x0 + px % TW;
    if (co >= Co || gy >= H || gx >= W) continue;
    const int64_t o = (((int64_t)b * Co + co) * H + gy) * W + gx;
    const float v = st[n * C::OS + px];
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
          const float v = st[n * C::OS + r * TW + m];
          s1 += v;
          s2 += v * v;
        }
      float* p = a.tile_part + ((int64_t)b * a.n_tiles + tile) * 2 * Co + co;
      p[0] = s1;
      p[Co] = s2;
    }
  }
}

// The tile's rows for an (H, W, Co) launch: 4, halved while the grid of one
// sample has fewer than FILL_BLOCKS blocks. A function of the sample's
// shape alone, never of the batch size.
int tile_rows(int H, int W, int Co) {
  const int blocks_per_row = ((W + 31) / 32) * ((Co + TN - 1) / TN);
  int r = 4;
  while (r > 1 && blocks_per_row * ((H + r - 1) / r) < FILL_BLOCKS) r /= 2;
  return r;
}

int tc_n_tiles(int H, int W, int Co) {
  const int r = tile_rows(H, W, Co);
  return ((W + 31) / 32) * ((H + r - 1) / r);
}

// the widest copy (bytes) that every row of the (Co, Ci * 9) weight allows
int copy_width(const void* k, int Ci, int esize) {
  const int64_t row = (int64_t)Ci * 9 * esize;
  for (int v = 16; v >= 4; v /= 2)
    if (row % v == 0 && reinterpret_cast<uintptr_t>(k) % v == 0) return v;
  return esize;
}

template <typename T, bool CONV2, class C>
int launch_tc_cfg(Args a, int B, cudaStream_t stream) {
  a.tiles_w = (a.W + C::TW - 1) / C::TW;
  a.n_tiles = a.tiles_w * ((a.H + C::R - 1) / C::R);
  a.vec = copy_width(a.k, a.Ci, sizeof(T));
  constexpr int bytes = smem_bytes<T, C>();
  cudaError_t err = cudaFuncSetAttribute(tc_conv_kernel<T, CONV2, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.n_tiles, (a.Co + TN - 1) / TN, B);
  tc_conv_kernel<T, CONV2, C><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool CONV2>
int launch_tc_type(Args a, int B, cudaStream_t stream) {
  const int r = tile_rows(a.H, a.W, a.Co);
  if (r == 4) return launch_tc_cfg<T, CONV2, Tile<4>>(a, B, stream);
  if (r == 2) return launch_tc_cfg<T, CONV2, Tile<2>>(a, B, stream);
  return launch_tc_cfg<T, CONV2, Tile<1>>(a, B, stream);
}

template <bool CONV2>
int launch_tc(Args a, int B, int dtype, cudaStream_t stream) {
  return dtype == 0 ? launch_tc_type<float, CONV2>(a, B, stream)
                    : launch_tc_type<__nv_bfloat16, CONV2>(a, B, stream);
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

// ------------------------------------------------ CUDA-core core (B2a)

constexpr int KC1 = 8;        // input channels per shared-memory chunk
constexpr int TH1 = 8;        // output tile rows
constexpr int TW1 = 16;       // output tile columns: one half warp
constexpr int TN1 = 128;      // output channels per block
constexpr int THREADS1 = 256;
static_assert(THREADS1 == TW1 * (TN1 / 8), "thread layout");

// Block (pixel tile, channel block, sample). Thread tid: tm = tid % 16 is
// the tile column it computes, all TH1 rows of it; tn = tid / 16 owns the
// channels n0 + tn*4 + {0..3} and n0 + 64 + tn*4 + {0..3}.
template <typename T>
__global__ void __launch_bounds__(THREADS1, 2) conv1_kernel(const Args a) {
  __shared__ float xs[KC1][TH1 + 2][TW1 + 2];
  __shared__ __align__(16) float ws[9][KC1][TN1];

  const int tid = threadIdx.x;
  const int tm = tid % TW1, tn = tid / TW1;
  const int b = blockIdx.z;
  const int tile = blockIdx.x;
  const int y0 = (tile / a.tiles_w) * TH1;
  const int x0 = (tile % a.tiles_w) * TW1;
  const int n0 = blockIdx.y * TN1;
  const int H = a.H, W = a.W, Ci = a.Ci, Co = a.Co;
  const T* x = static_cast<const T*>(a.x);
  const T* k = static_cast<const T*>(a.k);

  float acc[TH1][8];
#pragma unroll
  for (int r = 0; r < TH1; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  for (int c0 = 0; c0 < Ci; c0 += KC1) {
    // x1 over the tile and its 1-pixel halo; 0 outside the image
    for (int e = tid; e < KC1 * (TH1 + 2) * (TW1 + 2); e += THREADS1) {
      const int c = e % (TW1 + 2), r = (e / (TW1 + 2)) % (TH1 + 2);
      const int kc = e / ((TW1 + 2) * (TH1 + 2));
      const int gy = y0 + r - 1, gx = x0 + c - 1, ci = c0 + kc;
      float v = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && ci < Ci) {
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
      }
      xs[kc][r][c] = v;
    }
    // the weight chunk: one thread reads the 9 contiguous taps of a
    // (co, ci) pair; a warp stores 32 neighbouring channels
    for (int p = tid; p < KC1 * TN1; p += THREADS1) {
      const int n = p % TN1, kc = p / TN1;
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
    for (int kc = 0; kc < KC1; ++kc) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float xv[TH1 + 2];
#pragma unroll
        for (int r = 0; r < TH1 + 2; ++r) xv[r] = xs[kc][r][tm + dx];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float4 wa = *reinterpret_cast<const float4*>(&ws[dy * 3 + dx][kc][tn * 4]);
          const float4 wb = *reinterpret_cast<const float4*>(&ws[dy * 3 + dx][kc][64 + tn * 4]);
#pragma unroll
          for (int r = 0; r < TH1; ++r) {
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
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = n0 + (j / 4) * 64 + tn * 4 + j % 4;
    if (co >= Co || gx >= W) continue;
    const float slope = a.alpha[co];
#pragma unroll
    for (int r = 0; r < TH1; ++r) {
      const int gy = y0 + r;
      if (gy >= H) break;
      const int64_t o = (((int64_t)b * Co + co) * H + gy) * W + gx;
      static_cast<T*>(a.out)[o] = from_f<T>(activate(acc[r][j], ACT_PRELU, slope));
    }
  }
}

int launch_conv1(Args a, int B, int dtype, cudaStream_t stream) {
  a.tiles_w = (a.W + TW1 - 1) / TW1;
  a.n_tiles = a.tiles_w * ((a.H + TH1 - 1) / TH1);
  const dim3 grid(a.n_tiles, (a.Co + TN1 - 1) / TN1, B);
  if (dtype == 0) conv1_kernel<float><<<grid, THREADS1, 0, stream>>>(a);
  else            conv1_kernel<__nv_bfloat16><<<grid, THREADS1, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// the tensor-core core indexes one sample's input with 32-bit offsets
bool bad_shape(int B, int H, int W, int Ci, int Co, int dtype) {
  return B <= 0 || B > 65535 || H <= 0 || W <= 0 || Ci <= 0 || Co <= 0 ||
         (int64_t)Ci * H * W >= (int64_t)1 << 31 || (dtype != 0 && dtype != 1);
}

}  // namespace

// The number of pixel tiles of ogi_alignnet_conv2 for an (H, W) image and
// C2 channels: the second axis of its moments scratch.
extern "C" int ogi_samm_conv_tiles(int H, int W, int C2) { return tc_n_tiles(H, W, C2); }

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
         H, W, Ci, Co, act, 0, 0, 0};
  return launch_tc<false>(a, B, dtype, static_cast<cudaStream_t>(stream));
}

// s, t (B, C, H, W) and k1 (2C, 2C, 3, 3) in dtype; coeffs (B, 5, C) and
// alpha (2C,) float32; z (B, 2C, H, W) in dtype.
extern "C" int ogi_alignnet_conv1(const void* s, const void* t, const void* coeffs,
                                  const void* k1, const void* alpha, void* z,
                                  int B, int H, int W, int C, int dtype, void* stream) {
  if (bad_shape(B, H, W, C, C, dtype) || alpha == nullptr) return 1000;
  Args a{s, t, static_cast<const float*>(coeffs), k1, static_cast<const float*>(alpha),
         z, nullptr, H, W, 2 * C, 2 * C, ACT_PRELU, 0, 0, 0};
  return launch_conv1(a, B, dtype, static_cast<cudaStream_t>(stream));
}

// z (B, C2, H, W) and k2 (C2, C2, 3, 3) in dtype; y2 (B, C2, H, W) float32;
// tile_part (B, ogi_samm_conv_tiles(H, W, C2), 2, C2) float32 scratch; part
// (B, 2, C2) float32: [sum y2, sum y2^2] over H, W.
extern "C" int ogi_alignnet_conv2(const void* z, const void* k2, void* y2,
                                  void* tile_part, void* part, int B, int H, int W,
                                  int C2, int dtype, void* stream) {
  if (bad_shape(B, H, W, C2, C2, dtype)) return 1000;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{z, nullptr, nullptr, k2, nullptr, y2, static_cast<float*>(tile_part),
         H, W, C2, C2, ACT_NONE, 0, 0, 0};
  const int err = launch_tc<true>(a, B, dtype, st);
  if (err != 0) return err;
  const int n = B * 2 * C2;
  sum_tiles_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(tile_part), static_cast<float*>(part), B,
      tc_n_tiles(H, W, C2), C2);
  return (int)cudaGetLastError();
}
