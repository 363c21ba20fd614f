// AlignNet body0's first conv (B2a) for Hopper (sm_90a): z =
// prelu(conv3x3(x1, k1)) with x1 = [as*s + at*t + b1, ct*t + b2] built from
// s, t and the coefficients; replaces the TPU kernel
// ops/pallas_kernels.py:_an_conv1_kernel (via fused_alignnet_body0). Bound by
// operations. Both operand types run the TMA kernel of tma_conv.cuh in B5's
// mode (PReLU) after the repack pass's x1 mode, which builds x1 into the
// NHWC scratch that TMA reads: float32 as 3xTF32 (x1 split into hi and lo
// words there, z float32), bfloat16 as one pass (x1 rounded to bfloat16
// there, z bfloat16). Its note says how.
//
// Plain C interface (bound with ctypes): launches on the given stream and
// returns cudaGetLastError().

#include "tma_conv.cuh"

namespace {

template <int MODE>
int conv1(const void* s, const void* t, const void* coeffs, const void* k1, void* xr, void* wr,
          const void* alpha, void* z, int B, int H, int W, int C, void* stream) {
  if (alpha == nullptr || C <= 0) return 1000;
  tma::Args a{static_cast<const float*>(alpha), z, nullptr, H, W, 2 * C, tma::ACT_PRELU, 0, 0, 0};
  return tma::launch_x1<MODE>(s, t, static_cast<const float*>(coeffs), k1, xr, wr, a, B,
                              static_cast<cudaStream_t>(stream));
}

}  // namespace

// float32: s, t (B, C, H, W) and k1 (2C, 2C, 3, 3), contiguous; coeffs (B,
// 5, C) and alpha (2C,) float32; xr (B, H, W, 2 Cp) and wr (3, 3, 2C, 2 Cp)
// float32 scratch for the hi and lo words of x1 and k1 repacked
// (tma_conv.cuh), Cp = 2C rounded up to a multiple of 16; z (B, 2C, H, W)
// float32. Two launches: the repack, which builds x1, then the conv.
// Returns 0, a CUDA error, 1000 for an argument the kernel does not take,
// 1001/1002 if a tensor map cannot be encoded.
extern "C" int ogi_alignnet_conv1(const void* s, const void* t, const void* coeffs,
                                  const void* k1, void* xr, void* wr, const void* alpha, void* z,
                                  int B, int H, int W, int C, void* stream) {
  return conv1<tma::CONV_ACT_TF32>(s, t, coeffs, k1, xr, wr, alpha, z, B, H, W, C, stream);
}

// bfloat16: as ogi_alignnet_conv1, with s, t, k1 bfloat16, xr (B, H, W,
// Cp) and wr (3, 3, 2C, Cp) bfloat16, Cp = 2C rounded up to a multiple of
// 8, and z bfloat16.
extern "C" int ogi_alignnet_conv1_tma(const void* s, const void* t, const void* coeffs,
                                      const void* k1, void* xr, void* wr, const void* alpha,
                                      void* z, int B, int H, int W, int C, void* stream) {
  return conv1<tma::CONV_ACT>(s, t, coeffs, k1, xr, wr, alpha, z, B, H, W, C, stream);
}
