// AlignNet body0's first conv (B2a) for Hopper (sm_90a): z =
// prelu(conv3x3(x1, k1)) with x1 = [as*s + at*t + b1, ct*t + b2] built on
// chip; replaces the TPU kernel ops/pallas_kernels.py:_an_conv1_kernel (via
// fused_alignnet_body0). Bound by operations; it runs the tensor-core kernel
// of samm_conv.cuh, which says how, and how x1 is built.
//
// Plain C interface (bound with ctypes): launches on the given stream and
// returns cudaGetLastError().

#include "samm_conv.cuh"

// s, t (B, C, H, W) and k1 (2C, 2C, 3, 3) in dtype; coeffs (B, 5, C) and
// alpha (2C,) float32; z (B, 2C, H, W) in dtype.
extern "C" int ogi_alignnet_conv1(const void* s, const void* t, const void* coeffs,
                                  const void* k1, const void* alpha, void* z,
                                  int B, int H, int W, int C, int dtype, void* stream) {
  if (bad_shape(B, H, W, C, C, dtype) || alpha == nullptr) return 1000;
  Args a{s, t, static_cast<const float*>(coeffs), k1, static_cast<const float*>(alpha),
         z, nullptr, H, W, 2 * C, 2 * C, ACT_PRELU, 0, 0, 0};
  return launch_tc<AN_CONV1>(a, B, dtype, static_cast<cudaStream_t>(stream));
}
