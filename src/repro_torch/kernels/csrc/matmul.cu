// CARLA dual-stationarity GEMM for Hopper (sm_90a): the paper's 1x1-mode
// operand swap, (M, C) @ (C, K) with the fused flush epilogue.
//
// Replaces: src/repro/kernels/matmul.py:_mm_act_stationary_kernel and
// src/repro/kernels/matmul.py:_mm_weight_stationary_kernel, the Pallas TPU
// kernels behind ResNet-50's 1x1 convolutions and projections.
//
// Both run the pipelined loop of gemm_pipe.cuh as a 1x1 conv (FH = FW = 1,
// P = 0; a plain matrix is B = M, H = W = 1): a 3-slot cp.async ring of
// 16-byte copies, 8x8 register tiles, G groups of threads, and splits of C
// combined in the same launch by the last block of each output tile. Both
// read the activation rows in place, so a strided 1x1 conv folds its stride
// into the row addressing: row m = pixel (b, oh, ow) reads x[b, oh*S, ow*S,
// :] and the subsampled view is never materialised. fp32 sums are exact
// fp32 FMAs on the CUDA cores (no TF32). What makes each stationarity is
// its plan (kernels/_build.py):
//
// mm_act_stationary (M >= 128 rows): the TPU kernel keeps a (128, C)
// activation block resident while weight tiles stream over a sequential C
// grid axis. Here blocks run in parallel in no order, so the C axis becomes
// the loop inside each block (plan_gemm: 128x64 or 64x64 tiles, C cut
// inside and across blocks where the output tiles do not fill the SMs).
// At batch 1 the 1x1s do 10-100 FLOP per byte of compulsory traffic, around
// the fp32 ridge of 20 FLOP/byte, so the big ones are bound by fp32
// operations and the small ones by bytes.
//
// mm_weight_stationary (M < 128 rows, ResNet-50's conv5 at batch 1, 49
// rows): the weights are most of the bytes (up to 8 MB fp32 against 0.2 MB
// of activation rows), and FLOPs and bytes are nearly balanced against the
// card's ridge. plan_weight_stationary holds all M rows in one row tile (64,
// or 128 for 64 < M <= 128), so every weight element is read from device
// memory by exactly one block, once, streamed through the ring in 16-byte
// copies beside the activation chunk of the same slot; the column slabs and
// splits of C put the blocks on the SMs, and the splits meet in the same
// launch: one kernel a call.
#include "gemm_pipe.cuh"

namespace {

// x is NHWC (B, H, W, C) read at stride S into M = B*OH*OW rows.
int mm_launch(int dtype, const void* x, const void* w, const void* scale,
              const void* bias, const void* res, void* out, void* ws,
              void* tickets, int M, int C, int K, int H, int W, int S, int OH,
              int OW, int tile, int vec, int splits, int k_per_split,
              int relu, void* stream) {
  if (OH <= 0 || OW <= 0 || M % (OH * OW) != 0)
    return (int)cudaErrorInvalidValue;
  const carla::Epi ep{static_cast<const float*>(scale),
                      static_cast<const float*>(bias), relu};
  const carla::ConvShape s{M / (OH * OW), H, W, C, K, 1, 1, S, 0, OH, OW};
  float* wsp = static_cast<float*>(ws);
  int* tk = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return carla::pipe_launch<float>(tile, vec, x, w, ep, res, out, wsp, tk,
                                     s, splits, k_per_split, st);
  if (dtype == 1)
    return carla::pipe_launch<__nv_bfloat16>(tile, vec, x, w, ep, res, out,
                                             wsp, tk, s, splits, k_per_split,
                                             st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Arguments of both. dtype: 0 = float32, 1 = bfloat16. x is NHWC
// (B, H, W, C) read at stride S into M = B*OH*OW rows (a plain (M, C)
// matrix is H = W = OH = OW = S = 1), w is (C, K), out and res (or null)
// are (M, K) in x's type, scale/bias are fp32 (K,) or null. tile, vec and
// relu as carla_conv2d (csrc/conv2d.cu). Split z reduces channels
// [z * k_per_split, (z + 1) * k_per_split); with splits > 1, ws holds
// splits * tiles * BM*BN
// fp32 values and tickets one int32 counter per output tile, 0 before the
// call and 0 again after it. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a plan the operands do not allow).
extern "C" int carla_mm_act_stationary(
    int dtype, const void* x, const void* w, const void* scale,
    const void* bias, const void* res, void* out, void* ws, void* tickets,
    int M, int C, int K, int H, int W, int S, int OH, int OW, int tile,
    int vec, int splits, int k_per_split, int relu, void* stream) {
  return mm_launch(dtype, x, w, scale, bias, res, out, ws, tickets, M, C, K,
                   H, W, S, OH, OW, tile, vec, splits, k_per_split, relu,
                   stream);
}

extern "C" int carla_mm_weight_stationary(
    int dtype, const void* x, const void* w, const void* scale,
    const void* bias, const void* res, void* out, void* ws, void* tickets,
    int M, int C, int K, int H, int W, int S, int OH, int OW, int tile,
    int vec, int splits, int k_per_split, int relu, void* stream) {
  return mm_launch(dtype, x, w, scale, bias, res, out, ws, tickets, M, C, K,
                   H, W, S, OH, OW, tile, vec, splits, k_per_split, relu,
                   stream);
}
