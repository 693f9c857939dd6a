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
// reduction R = FH*FW*C. The HWIO weights already are the row-major (R, K)
// matrix, and row q = (r*FW + s)*C + c of the reduction gathers its input
// on the fly (im2col without the copy). Zero padding is a bounds check on
// the gathered address, and the ragged C (the stem's C = 3 folds into the
// one flat reduction, wasting nothing) and ragged K are masked.
//
// Bound on this card: at the main path's shapes the layers do about 20 to
// 150 FLOP per byte of compulsory traffic, at or above the fp32 CUDA-core
// ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte), so they are bound by
// fp32 operations (VGG-16's first layer, C = 3, at 13 FLOP/byte, is bound
// by its output bytes). The design answers that with a 64x64 output tile per
// block and a 4x4 register micro-tile per thread (16 FMAs per 8
// shared-memory reads; each gathered input value is reused 64 times from
// shared memory), and with a split reduction where the output tiles are too
// few to fill the SMs: ResNet-50's conv5 3x3 at batch 1 has 49 output
// pixels, one row tile and 8 column tiles for 132 SMs, so its R = 4608 is
// split over blocks (see tile_gemm.cuh). Tensor cores (wgmma/TMA) are later
// work; fp32 here must meet 2e-4 * scale, which TF32 would not.
#include "tile_gemm.cuh"

namespace carla {

using ConvTile = Tile<64, 64, 16, 4, 4>;  // kernels/conv2d.py: BM, BN, BK

struct ConvShape {
  int B, H, W, C, K, FH, FW, S, P, OH, OW;
};

// The im2col gather: row m = (b, oh, ow), reduction index q = (r, s, c).
template <typename T, class TL>
struct WindowLoader {
  const T* __restrict__ x;
  ConvShape s;
  int64_t base[TL::A_PER];  // offset of x[b, 0, 0, 0]
  int ih0[TL::A_PER], iw0[TL::A_PER];
  bool valid[TL::A_PER];
  __device__ WindowLoader(const T* x_, const ConvShape& s_, int m0)
      : x(x_), s(s_) {
    const int M = s.B * s.OH * s.OW;
#pragma unroll
    for (int j = 0; j < TL::A_PER; ++j) {
      const int m = m0 + TL::a_row(threadIdx.x, j);
      valid[j] = m < M;
      const int b = m / (s.OH * s.OW), p = m % (s.OH * s.OW);
      base[j] = (int64_t)b * s.H * s.W * s.C;
      ih0[j] = (p / s.OW) * s.S - s.P;
      iw0[j] = (p % s.OW) * s.S - s.P;
    }
  }
  __device__ __forceinline__ float load(int j, int q) const {
    if (!valid[j]) return 0.f;
    const int c = q % s.C, rs = q / s.C;
    const int r = rs / s.FW, t = rs - r * s.FW;
    const int ih = ih0[j] + r, iw = iw0[j] + t;
    if (ih < 0 || ih >= s.H || iw < 0 || iw >= s.W) return 0.f;  // zero pad
    return to_f32(x[base[j] + ((int64_t)ih * s.W + iw) * s.C + c]);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w, Epi ep,
              const T* __restrict__ res, T* __restrict__ out,
              float* __restrict__ ws, ConvShape s, int k_per_split) {
  using TL = ConvTile;
  __shared__ __align__(16) float As[TL::SMEM_A];
  __shared__ __align__(16) float Bs[TL::SMEM_B];
  const int m0 = blockIdx.x * TL::BM, n0 = blockIdx.y * TL::BN;
  const Split sp(s.FH * s.FW * s.C, k_per_split);
  const WindowLoader<T, TL> ld(x, s, m0);
  float acc[TL::TM][TL::TN] = {};
  mainloop<TL>(ld, w, s.K, n0, sp.begin, sp.end, acc, As, Bs);
  finish<TL>(acc, out, ws, ep, res, s.B * s.OH * s.OW, s.K, m0, n0);
}

template <typename T>
int launch(const void* x, const void* w, Epi ep, const void* res, void* out,
           float* ws, const ConvShape& s, int splits, int k_per_split,
           cudaStream_t stream) {
  auto first = [&](dim3 grid) {
    conv2d_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), ep,
        static_cast<const T*>(res), static_cast<T*>(out), ws, s, k_per_split);
  };
  return launch_split<ConvTile, T>(first, s.B * s.OH * s.OW, s.K, splits, ws,
                                   ep, res, out, stream);
}

}  // namespace carla

// dtype: 0 = float32, 1 = bfloat16. scale/bias are fp32 (K,) or null;
// res is the output's shape and type, or null. ws: fp32 workspace of
// splits * B*OH*OW * K values (null when splits == 1); split z reduces
// rows [z * k_per_split, (z + 1) * k_per_split) of R = FH*FW*C.
// Returns cudaGetLastError().
extern "C" int carla_conv2d(int dtype, const void* x, const void* w,
                            const void* scale, const void* bias,
                            const void* res, void* out, void* ws, int B, int H,
                            int W, int C, int K, int FH, int FW, int S, int P,
                            int OH, int OW, int splits, int k_per_split,
                            int relu, void* stream) {
  const carla::Epi ep{static_cast<const float*>(scale),
                      static_cast<const float*>(bias), relu};
  const carla::ConvShape s{B, H, W, C, K, FH, FW, S, P, OH, OW};
  float* wsp = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return carla::launch<float>(x, w, ep, res, out, wsp, s, splits,
                                k_per_split, st);
  if (dtype == 1)
    return carla::launch<__nv_bfloat16>(x, w, ep, res, out, wsp, s, splits,
                                        k_per_split, st);
  return (int)cudaErrorInvalidValue;
}
