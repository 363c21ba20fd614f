// AlignNet body0's second conv (B2b) for Hopper (sm_90a): y2 =
// conv3x3(z, k2) in float32 and norm2's moments; replaces the TPU kernel
// ops/pallas_kernels.py:_an_conv2_kernel (via fused_alignnet_body0). Bound by
// operations. Both operand types run the TMA kernel of tma_conv.cuh after
// its repack pass (NHWC input, tap-major weights), whose notes say how:
// float32 as 3xTF32 on words split once in that pass (AN_CONV2_TF32),
// bfloat16 as one pass (AN_CONV2). The JAX kernel blocked the whole (3, 3,
// 2C, 2C) weight into VMEM, which limited it to 2C <= 512, and accumulated
// the moments across its sequential band grid; here the weights stream
// through the ring, so 2C = 1024 runs, and each block writes its tile's
// moments to a scratch that sum_tiles_kernel then sums in tile order: no
// atomics, so the moments are the same bits on every call and in every
// batch slot.
//
// Plain C interface (bound with ctypes): launches on the given stream and
// returns cudaGetLastError().

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

// The number of pixel tiles of ogi_alignnet_conv2 for an (H, W) image and C2
// output channels: the second axis of its moments scratch.
extern "C" int ogi_samm_conv_tiles(int H, int W, int C2) { return tma::pixel_tiles(H, W, C2); }

// dtype 0 = float32, 1 = bfloat16 (z, k2 and their repacked copies): z (B,
// C2, H, W) and k2 (C2, C2, 3, 3), contiguous; zr and wr scratch for their
// repacked copies (tma_conv.cuh): bfloat16 (B, H, W, Cp) and (3, 3, C2, Cp),
// Cp = C2 rounded up to a multiple of 8, or float32 hi and lo words (B, H,
// W, 2 Cp) and (3, 3, C2, 2 Cp), Cp = C2 rounded up to a multiple of 16; y2
// (B, C2, H, W) float32; tile_part (B, ogi_samm_conv_tiles(H, W, C2), 2, C2)
// float32 scratch; part (B, 2, C2) float32: [sum y2, sum y2^2] over H, W.
// Three launches: the repack, the conv, the tile sums. Returns 0, a CUDA
// error, 1000 for an argument the kernels do not take, 1001/1002 if a
// tensor map cannot be encoded.
extern "C" int ogi_alignnet_conv2(const void* z, const void* k2, void* zr, void* wr, void* y2,
                                  void* tile_part, void* part, int B, int H, int W, int C2,
                                  int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return 1000;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tma::Args a{nullptr, y2, static_cast<float*>(tile_part), H, W, C2, tma::ACT_NONE, 0, 0, 0};
  const int err = dtype == 0 ? tma::launch<tma::AN_CONV2_TF32>(z, k2, zr, wr, a, B, C2, st)
                             : tma::launch<tma::AN_CONV2>(z, k2, zr, wr, a, B, C2, st);
  if (err != 0) return err;
  return sum_tiles(tile_part, part, B, tma::pixel_tiles(H, W, C2), C2, st);
}
