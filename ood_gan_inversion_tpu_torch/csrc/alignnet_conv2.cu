// AlignNet body0's second conv (B2b) for Hopper (sm_90a): y2 =
// conv3x3(z, k2) in float32 and norm2's moments; replaces the TPU kernel
// ops/pallas_kernels.py:_an_conv2_kernel (via fused_alignnet_body0). Bound by
// operations; it runs the tensor-core kernel of samm_conv.cuh, which says
// how. Each block writes its tile's moments to a scratch that
// sum_tiles_kernel then sums in tile order: no atomics.
//
// Plain C interface (bound with ctypes): launches on the given stream and
// returns cudaGetLastError().

#include "samm_conv.cuh"

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

}  // namespace

// The number of pixel tiles of ogi_alignnet_conv2 for an (H, W) image and
// C2 channels: the second axis of its moments scratch.
extern "C" int ogi_samm_conv_tiles(int H, int W, int C2) { return tc_n_tiles(H, W, C2); }

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
  const int err = launch_tc<AN_CONV2>(a, B, dtype, st);
  if (err != 0) return err;
  const int n = B * 2 * C2;
  sum_tiles_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(tile_part), static_cast<float*>(part), B,
      tc_n_tiles(H, W, C2), C2);
  return (int)cudaGetLastError();
}
