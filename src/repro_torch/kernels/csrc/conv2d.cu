// CARLA serial-accumulation convolution for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/conv2d.py:_conv2d_kernel, the Pallas TPU kernel
// behind the 7x7/2 stem and every 3x3 of ResNet-50 and VGG-16.
//
// What it computes: out[b, oh, ow, k] = flush(sum_{r, s, c}
//   x[b, oh*S - P + r, ow*S - P + s, c] * w[r, s, c, k]) for NHWC x, HWIO w,
// with fp32 accumulation and the fused flush (scale -> bias -> residual ->
// ReLU) applied on the accumulator before one store in the output type.
//
// Why not the Pallas blocking: that block holds a whole padded input plane
// and a whole (OH, OW, 128) fp32 accumulator in VMEM — about 13 MB each for
// VGG-16's second layer, against 227 KB of shared memory per block here.
// So this is an implicit GEMM instead: M = B*OH*OW output pixels, N = K,
// reduction R = FH*FW*C, with the input window gathered on the fly and zero
// padding a bounds check (a zero-filled copy) on the gathered address.
//
// Bound on this card: at the main path's shapes the layers do about 20 to
// 150 FLOP per byte of compulsory traffic, at or above the fp32 CUDA-core
// ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte), so they are bound by
// fp32 operations (VGG-16's first layer, C = 3, at 13 FLOP/byte, is bound
// by its output bytes). The design (gemm_pipe.cuh) answers that with a
// 3-slot cp.async ring of 16-byte copies, 8x8 register tiles in 128x64 or
// 64x64 blocks, a tap walk with no division in the gather, and, where the
// output tiles do not fill the SMs (ResNet-50's 3x3s at batch 1: 49 to 3136
// output pixels), the reduction cut inside the block (four groups of
// threads) and across blocks (splits combined in the same launch).
// Tensor cores are later work; fp32 here must meet 2e-4 * scale, which TF32
// would not.
//
// Paths on the main path (the wrapper picks them, kernels/conv2d.py): the
// C = 3 layers (ResNet-50's 7x7/2 stem, VGG-16's conv1_1) take the general
// path; every 3x3 of ResNet-50 (C = 64..512) and every other VGG-16 layer
// (C = 64..512) takes vec16, in fp32 and bf16.
#include "gemm_pipe.cuh"

// dtype: 0 = float32, 1 = bfloat16. scale/bias are fp32 (K,) or null;
// res is the output's shape and type, or null. tile: block tile code
// (0 = 128x64, 1 = 64x64, 2 = 64x64 in four groups); vec: 1 for the vec16
// path (C a multiple of 16, K * sizeof(T) a multiple of 16, x, w, res and
// out 16-byte aligned), 0 for the general path (k_per_split or R at most
// 2048). Split z
// reduces rows [z * k_per_split, (z + 1) * k_per_split) of R = FH*FW*C; with
// splits > 1, ws holds splits * tiles * BM*BN fp32 values and tickets one
// int32 counter per output tile, all 0 before the call and 0 again after it
// (calls that share them must be ordered on one stream). Returns
// cudaGetLastError() (cudaErrorInvalidValue for a plan the operands do not
// allow).
extern "C" int carla_conv2d(int dtype, const void* x, const void* w,
                            const void* scale, const void* bias,
                            const void* res, void* out, void* ws,
                            void* tickets, int B, int H, int W, int C, int K,
                            int FH, int FW, int S, int P, int OH, int OW,
                            int tile, int vec, int splits, int k_per_split,
                            int relu, void* stream) {
  const carla::Epi ep{static_cast<const float*>(scale),
                      static_cast<const float*>(bias), relu};
  const carla::ConvShape s{B, H, W, C, K, FH, FW, S, P, OH, OW};
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
