// conv3x3 + activation (B5) for Hopper (sm_90a): out = act(conv3x3(x, k)),
// NCHW / OIHW, zero padding 1; replaces the TPU kernel
// ops/pallas_kernels.py:_conv_act_band_kernel (via conv3x3_act). Bound by
// operations; it runs the tensor-core kernel of samm_conv.cuh, which says
// how.
//
// Plain C interface (bound with ctypes): launches on the given stream and
// returns cudaGetLastError().

#include "samm_conv.cuh"

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
  return launch_tc<CONV_ACT>(a, B, dtype, static_cast<cudaStream_t>(stream));
}
