// conv3x3 + activation (B5) for Hopper (sm_90a): out = act(conv3x3(x, k)),
// zero padding 1; replaces the TPU kernel
// ops/pallas_kernels.py:_conv_act_band_kernel (via conv3x3_act). Bound by
// operations. float32 operands run the tensor-core kernel of samm_conv.cuh
// (NCHW / OIHW, 3xTF32), bfloat16 operands the TMA kernel of tma_conv.cuh
// (NHWC / tap-major weights), whose notes say how.
//
// Plain C interface (bound with ctypes): launches on the given stream and
// returns cudaGetLastError().

#include "samm_conv.cuh"
#include "tma_conv.cuh"

// float32 (bfloat16 operands take ogi_conv3x3_act_tma): x (B, Ci, H, W), k
// (Co, Ci, 3, 3), out (B, Co, H, W), all contiguous; alpha (Co,) float32
// (read only for act 1). act: 0 none, 1 PReLU, 2 lrelu * sqrt(2). Returns
// cudaGetLastError() after the launch (0 = success); 1000 for an argument
// the kernel does not take.
extern "C" int ogi_conv3x3_act(const void* x, const void* k, const void* alpha,
                               void* out, int B, int H, int W, int Ci, int Co,
                               int act, void* stream) {
  if (bad_shape(B, H, W, Ci, Co, 0) || act < 0 || act > 2 ||
      (act == ACT_PRELU && alpha == nullptr))
    return 1000;
  Args a{x, nullptr, nullptr, k, static_cast<const float*>(alpha), out, nullptr,
         H, W, Ci, Co, act, 0, 0, 0};
  return launch_tc_type<float, CONV_ACT>(a, B, static_cast<cudaStream_t>(stream));
}

// bfloat16: x (B, Ci, H, W), k (Co, Ci, 3, 3) and out (B, Co, H, W), all
// contiguous; xr (B, H, W, Cp) and wr (3, 3, Co, Cp) scratch for their
// repacked copies (tma_conv.cuh), Cp = Ci rounded up to a multiple of 8;
// alpha and act as above. Two launches: the repack, then the conv. Returns
// 0, a CUDA error, 1000 for an argument the kernel does not take, 1001/1002
// if a tensor map cannot be encoded.
extern "C" int ogi_conv3x3_act_tma(const void* x, const void* k, void* xr, void* wr,
                                   const void* alpha, void* out, int B, int H, int W, int Ci,
                                   int Co, int act, void* stream) {
  if (act < 0 || act > 2 || (act == ACT_PRELU && alpha == nullptr)) return 1000;
  tma::Args a{static_cast<const float*>(alpha), out, nullptr, H, W, Co, act, 0, 0, 0};
  return tma::launch<tma::CONV_ACT>(x, k, xr, wr, a, B, Ci, static_cast<cudaStream_t>(stream));
}

// The mean host time in microseconds of encoding the two tensor maps of one
// ogi_conv3x3_act_tma launch on its scratch xr, wr (Ci: the padded Cp),
// over `reps` encodings; -1 if an encoding fails.
extern "C" double ogi_tma_encode_us(const void* xr, const void* wr, int B, int H, int W,
                                    int Ci, int Co, int reps) {
  return tma::encode_us(xr, wr, B, H, W, Ci, Co, tma::tile_rows(H, W, Co), reps);
}
