// AlignNet body0's second conv (B2b) for Hopper (sm_90a): y2 =
// conv3x3(z, k2) in float32 and norm2's moments; replaces the TPU kernel
// ops/pallas_kernels.py:_an_conv2_kernel (via fused_alignnet_body0). Bound by
// operations. float32 operands run the tensor-core kernel of samm_conv.cuh
// (NCHW / OIHW, 3xTF32, the core of tc_conv.cuh), bfloat16 operands the TMA
// kernel of tma_conv.cuh (NHWC / tap-major weights), whose notes say how. Each block writes its
// tile's moments to a scratch that sum_tiles_kernel then sums in tile
// order: no atomics.
//
// Plain C interface (bound with ctypes): launches on the given stream and
// returns cudaGetLastError().

#include "samm_conv.cuh"
#include "tma_conv.cuh"

namespace {

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

int sum_tiles(const void* tile_part, void* part, int B, int n_tiles, int Co, cudaStream_t st) {
  const int n = B * 2 * Co;
  sum_tiles_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(tile_part), static_cast<float*>(part), B, n_tiles, Co);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of pixel tiles of ogi_alignnet_conv2 and ogi_alignnet_conv2_tma
// (the same tiles) for an (H, W) image and C2 output channels: the second
// axis of their moments scratch.
extern "C" int ogi_samm_conv_tiles(int H, int W, int C2) { return tc_n_tiles(H, W, C2); }

// float32 (bfloat16 operands take ogi_alignnet_conv2_tma): z (B, C2, H, W)
// and k2 (C2, C2, 3, 3); y2 (B, C2, H, W) float32; tile_part (B,
// ogi_samm_conv_tiles(H, W, C2), 2, C2) float32 scratch; part (B, 2, C2)
// float32: [sum y2, sum y2^2] over H, W.
extern "C" int ogi_alignnet_conv2(const void* z, const void* k2, void* y2,
                                  void* tile_part, void* part, int B, int H, int W,
                                  int C2, void* stream) {
  if (bad_shape(B, H, W, C2, C2)) return 1000;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{static_cast<const float*>(z), static_cast<const float*>(k2), static_cast<float*>(y2),
         static_cast<float*>(tile_part), H, W, C2, C2, 0, 0, 0};
  const int err = launch_conv2(a, B, st);
  if (err != 0) return err;
  return sum_tiles(tile_part, part, B, tc_n_tiles(H, W, C2), C2, st);
}

// bfloat16: z (B, C2, H, W) and k2 (C2, C2, 3, 3), contiguous; zr (B, H, W,
// Cp) and wr (3, 3, C2, Cp) scratch for their repacked copies
// (tma_conv.cuh), Cp = C2 rounded up to a multiple of 8; y2 (B, C2, H, W)
// float32; tile_part (B, ogi_samm_conv_tiles(H, W, C2), 2, C2) float32
// scratch; part (B, 2, C2) float32 as above. Three launches: the repack,
// the conv, the tile sums.
extern "C" int ogi_alignnet_conv2_tma(const void* z, const void* k2, void* zr, void* wr,
                                      void* y2, void* tile_part, void* part, int B, int H,
                                      int W, int C2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tma::Args a{nullptr, y2, static_cast<float*>(tile_part), H, W, C2, tma::ACT_NONE, 0, 0, 0};
  const int err = tma::launch<tma::AN_CONV2>(z, k2, zr, wr, a, B, C2, st);
  if (err != 0) return err;
  return sum_tiles(tile_part, part, B, tc_n_tiles(H, W, C2), C2, st);
}
