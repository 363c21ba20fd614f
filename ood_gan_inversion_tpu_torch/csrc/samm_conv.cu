// conv3x3 + activation (B5) for Hopper (sm_90a): out = act(conv3x3(x, k)),
// zero padding 1; replaces the TPU kernel
// ops/pallas_kernels.py:_conv_act_band_kernel (via conv3x3_act). Bound by
// operations. Both operand types run the TMA kernel of tma_conv.cuh after
// its repack pass (NHWC input, tap-major weights): float32 as 3xTF32, the
// operands split into hi and lo words by the repack pass (CONV_ACT_TF32),
// bfloat16 as one bfloat16 pass (CONV_ACT). Its note says how.
//
// Plain C interface (bound with ctypes): launches on the given stream and
// returns cudaGetLastError().

#include "tma_conv.cuh"

namespace {

template <int MODE>
int conv_act(const void* x, const void* k, void* xr, void* wr, const void* alpha, void* out,
             int B, int H, int W, int Ci, int Co, int act, void* stream) {
  if (act < 0 || act > 2 || (act == tma::ACT_PRELU && alpha == nullptr)) return 1000;
  tma::Args a{static_cast<const float*>(alpha), out, nullptr, H, W, Co, act, 0, 0, 0};
  return tma::launch<MODE>(x, k, xr, wr, a, B, Ci, static_cast<cudaStream_t>(stream));
}

}  // namespace

// float32: x (B, Ci, H, W), k (Co, Ci, 3, 3) and out (B, Co, H, W), all
// contiguous; xr (B, H, W, 2 Cp) and wr (3, 3, Co, 2 Cp) float32 scratch
// for their repacked hi and lo words, Cp = Ci rounded up to a multiple of
// 16; alpha (Co,) float32 (read only for act 1). act: 0 none, 1 PReLU, 2
// lrelu * sqrt(2). Two launches: the repack, then the conv. Returns 0, a
// CUDA error, 1000 for an argument the kernel does not take, 1001/1002 if a
// tensor map cannot be encoded.
extern "C" int ogi_conv3x3_act(const void* x, const void* k, void* xr, void* wr,
                               const void* alpha, void* out, int B, int H, int W, int Ci, int Co,
                               int act, void* stream) {
  return conv_act<tma::CONV_ACT_TF32>(x, k, xr, wr, alpha, out, B, H, W, Ci, Co, act, stream);
}

// bfloat16: as ogi_conv3x3_act, with xr (B, H, W, Cp) and wr (3, 3, Co, Cp)
// bfloat16, Cp = Ci rounded up to a multiple of 8; out bfloat16.
extern "C" int ogi_conv3x3_act_tma(const void* x, const void* k, void* xr, void* wr,
                                   const void* alpha, void* out, int B, int H, int W, int Ci,
                                   int Co, int act, void* stream) {
  return conv_act<tma::CONV_ACT>(x, k, xr, wr, alpha, out, B, H, W, Ci, Co, act, stream);
}

// The mean host time in microseconds of encoding the two tensor maps of one
// ogi_conv3x3_act_tma launch on its scratch xr, wr (Ci: the padded Cp),
// over `reps` encodings; -1 if an encoding fails.
extern "C" double ogi_tma_encode_us(const void* xr, const void* wr, int B, int H, int W,
                                    int Ci, int Co, int reps) {
  return tma::encode_us(xr, wr, B, H, W, Ci, Co, tma::tile_rows(H, W, Co), reps);
}
