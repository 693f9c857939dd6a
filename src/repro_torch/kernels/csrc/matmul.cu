// CARLA dual-stationarity GEMM for Hopper (sm_90a): the paper's 1x1-mode
// operand swap, (M, C) @ (C, K) with the fused flush epilogue.
//
// Replaces: src/repro/kernels/matmul.py:_mm_act_stationary_kernel and
// src/repro/kernels/matmul.py:_mm_weight_stationary_kernel, the Pallas TPU
// kernels behind ResNet-50's 1x1 convolutions and projections.
//
// Both read the activation rows through RowLoader, so a strided 1x1 conv
// folds its stride into the row addressing: row m = pixel (b, oh, ow) reads
// x[b, oh*S, ow*S, :] in place and the subsampled view is never materialised.
// Both accumulate in fp32 on the CUDA cores (no TF32) and apply
// scale -> bias -> residual -> ReLU on the accumulator before one store.
//
// mm_act_stationary (M >= 128 rows): the TPU kernel keeps a (128, C)
// activation block resident while weight tiles stream over a sequential C
// grid axis. Here blocks run in parallel in no order, so the C axis becomes
// the loop inside each block: a 64x64 output tile per block, C in chunks of
// 16, both operand tiles staged in shared memory, a 4x4 register micro-tile
// per thread. Bound on this card: at batch 1 the 1x1s do 10-100 FLOP per
// byte of compulsory traffic, around the fp32 ridge of 20 FLOP/byte, so the
// big ones are bound by fp32 operations and the small ones by bytes; each
// activation value is reused 64 times from shared memory and each weight
// value by the tile's 64 rows. Where the output tiles are too few to fill
// the SMs (conv4's 196 rows: 4 x 4 tiles for 132 SMs), C is split over
// blocks as in tile_gemm.cuh.
//
// mm_weight_stationary (M < 128 rows, ResNet-50's conv5 at batch 1, 49 rows):
// the weights dominate the bytes (up to 8 MB fp32 against 0.4 MB of
// activations), so it is bound by reading them once. Each block owns all M
// rows (one row tile of 64, or 128 for 64 < M < 128) and a slab of 32 weight
// columns, so every weight element is read by exactly one block, once. The
// TPU's 128-column blocks would give K/128 = 4..16 blocks for 132 SMs; the
// 32-column slabs give 16..64, and the C range is split on top of that to
// put about two blocks on every SM (the split reduction of tile_gemm.cuh),
// still reading each weight element once.
#include "tile_gemm.cuh"

namespace carla {

using AsTile = Tile<64, 64, 16, 4, 4>;    // kernels/matmul.py: AS_BM, AS_BN
using WsTile64 = Tile<64, 32, 16, 2, 4>;  // kernels/matmul.py: WS_BN, BK
using WsTile128 = Tile<128, 32, 16, 4, 4>;

struct Rows {
  int M, H, W, S, OH, OW;
};

// One kernel body for both stationarities: they differ in the tile (and so
// in which operand a block keeps), not in the arithmetic.
template <typename T, class TL>
__global__ void __launch_bounds__(THREADS)
mm_kernel(const T* __restrict__ x, const T* __restrict__ w, Epi ep,
          const T* __restrict__ res, T* __restrict__ out,
          float* __restrict__ ws, Rows r, int C, int K, int k_per_split) {
  __shared__ __align__(16) float As[TL::SMEM_A];
  __shared__ __align__(16) float Bs[TL::SMEM_B];
  const int m0 = blockIdx.x * TL::BM, n0 = blockIdx.y * TL::BN;
  const Split sp(C, k_per_split);
  const RowLoader<T, TL> ld(x, m0, r.M, r.H, r.W, C, r.S, r.OH, r.OW);
  float acc[TL::TM][TL::TN] = {};
  mainloop<TL>(ld, w, K, n0, sp.begin, sp.end, acc, As, Bs);
  finish<TL>(acc, out, ws, ep, res, r.M, K, m0, n0);
}

template <typename T, class TL>
int launch(const void* x, const void* w, Epi ep, const void* res, void* out,
           float* ws, Rows r, int C, int K, int splits, int k_per_split,
           cudaStream_t stream) {
  auto first = [&](dim3 grid) {
    mm_kernel<T, TL><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), ep,
        static_cast<const T*>(res), static_cast<T*>(out), ws, r, C, K,
        k_per_split);
  };
  return launch_split<TL, T>(first, r.M, K, splits, ws, ep, res, out, stream);
}

template <typename T>
int launch_ws(const void* x, const void* w, Epi ep, const void* res,
              void* out, float* ws, Rows r, int C, int K, int splits,
              int k_per_split, cudaStream_t stream) {
  if (r.M <= WsTile64::BM)
    return launch<T, WsTile64>(x, w, ep, res, out, ws, r, C, K, splits,
                               k_per_split, stream);
  return launch<T, WsTile128>(x, w, ep, res, out, ws, r, C, K, splits,
                              k_per_split, stream);
}

}  // namespace carla

// Common arguments. dtype: 0 = float32, 1 = bfloat16. x is NHWC
// (B, H, W, C) read at stride S into M = B*OH*OW rows (a plain (M, C)
// matrix is H = W = OH = OW = S = 1), w is (C, K), out and res (or null)
// are (M, K) in x's type, scale/bias are fp32 (K,) or null. ws: fp32
// workspace of splits * M * K values (null when splits == 1); split z
// reduces channels [z * k_per_split, (z + 1) * k_per_split).
// Returns cudaGetLastError().
extern "C" int carla_mm_act_stationary(
    int dtype, const void* x, const void* w, const void* scale,
    const void* bias, const void* res, void* out, void* ws, int M, int C,
    int K, int H, int W, int S, int OH, int OW, int splits, int k_per_split,
    int relu, void* stream) {
  const carla::Epi ep{static_cast<const float*>(scale),
                      static_cast<const float*>(bias), relu};
  const carla::Rows r{M, H, W, S, OH, OW};
  float* wsp = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return carla::launch<float, carla::AsTile>(x, w, ep, res, out, wsp, r, C,
                                               K, splits, k_per_split, st);
  if (dtype == 1)
    return carla::launch<__nv_bfloat16, carla::AsTile>(
        x, w, ep, res, out, wsp, r, C, K, splits, k_per_split, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int carla_mm_weight_stationary(
    int dtype, const void* x, const void* w, const void* scale,
    const void* bias, const void* res, void* out, void* ws, int M, int C,
    int K, int H, int W, int S, int OH, int OW, int splits, int k_per_split,
    int relu, void* stream) {
  const carla::Epi ep{static_cast<const float*>(scale),
                      static_cast<const float*>(bias), relu};
  const carla::Rows r{M, H, W, S, OH, OW};
  float* wsp = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return carla::launch_ws<float>(x, w, ep, res, out, wsp, r, C, K, splits,
                                   k_per_split, st);
  if (dtype == 1)
    return carla::launch_ws<__nv_bfloat16>(x, w, ep, res, out, wsp, r, C, K,
                                           splits, k_per_split, st);
  return (int)cudaErrorInvalidValue;
}
