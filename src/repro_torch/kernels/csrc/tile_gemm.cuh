// Shared pieces of the CARLA CUDA kernels: an fp32 tiled GEMM main loop on
// the CUDA cores, the split reduction, and the fused flush epilogue.
//
// A block owns a BM x BN output tile and walks its share of the reduction in
// chunks of BK. Each chunk stages an A tile (BM x BK, gathered by a loader
// that knows the operand's addressing: an im2col window for conv2d, strided
// pixel rows for the 1x1 GEMMs) and a B tile (BK x BN, rows of a row-major
// (R, N) weight matrix) in shared memory as fp32. Every thread accumulates a
// TM x TN micro-tile in registers. Ragged edges (M, N and the reduction) are
// masked at load time by writing zeros, so no operand is ever padded in
// device memory. No tensor cores, hence no TF32: fp32 sums are fp32 FMAs.
//
// Split reduction: the grid is (M tiles, N tiles, splits). When the output
// tiles alone are too few to fill the card's SMs (batch-1 layers with 49 or
// 196 output pixels), split z reduces rows [z*k_per_split, (z+1)*k_per_split)
// of R and writes raw fp32 sums to workspace slice z; a second pass sums the
// slices in a fixed order (so results do not change from run to run) and
// applies the flush. With one split the flush is fused into the first pass.
//
// The flush applies scale -> bias -> residual -> ReLU on the fp32
// accumulator and converts to the output type once, at the store.
#pragma once

#include "numeric.cuh"

namespace carla {

constexpr int THREADS = 256;

// Per-output-channel fp32 scale/bias (either may be null) and the ReLU flag.
struct Epi {
  const float* scale;
  const float* bias;
  int relu;
};

// The fused flush on one fp32 value of output element idx = m*N + n; `res`
// is the residual (same shape and type as the output) or null.
template <typename T>
__device__ __forceinline__ float flush(float y, const Epi& ep, const T* res,
                                       int64_t idx, int n) {
  if (ep.scale) y *= ep.scale[n];
  if (ep.bias) y += ep.bias[n];
  if (res) y += to_f32(res[idx]);
  if (ep.relu) y = fmaxf(y, 0.f);
  return y;
}

// Tile geometry shared by the main loop and the store.
template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int APAD = 4;                 // breaks smem bank conflicts
  static constexpr int A_PER = BM * BK / THREADS;  // A loads per thread
  static constexpr int B_PER = BK * BN / THREADS;  // B loads per thread
  static_assert((BM / TM) * (BN / TN) == THREADS, "one micro-tile a thread");
  static_assert(A_PER * THREADS == BM * BK && B_PER * THREADS == BK * BN,
                "tiles must split evenly over the block");
  static constexpr int SMEM_A = BK * (BM + APAD);
  static constexpr int SMEM_B = BK * BN;
  // Row (within the tile) of the j-th A element this thread loads.
  __device__ static int a_row(int tid, int j) { return (tid + j * THREADS) / BK; }
};

// This block's share [begin, end) of a reduction of length R.
struct Split {
  int begin, end;
  __device__ Split(int R, int k_per_split)
      : begin(blockIdx.z * k_per_split),
        end(min(R, (int)(blockIdx.z + 1) * k_per_split)) {}
};

// acc += A[m0:m0+BM, k_begin:k_end] @ B[k_begin:k_end, n0:n0+BN].
// `aload.load(j, k)` returns A at (this thread's j-th row, k) as fp32, or 0
// outside the operand; the k < k_end mask is applied here.
template <class TL, typename T, class ALoader>
__device__ __forceinline__ void mainloop(const ALoader& aload,
                                         const T* __restrict__ B, int N,
                                         int n0, int k_begin, int k_end,
                                         float (&acc)[TL::TM][TL::TN],
                                         float* As, float* Bs) {
  const int tid = threadIdx.x;
  const int tx = tid % (TL::BN / TL::TN), ty = tid / (TL::BN / TL::TN);
  constexpr int LDA = TL::BM + TL::APAD;
  for (int k0 = k_begin; k0 < k_end; k0 += TL::BK) {
#pragma unroll
    for (int j = 0; j < TL::A_PER; ++j) {
      const int i = tid + j * THREADS;
      const int kk = i % TL::BK, m = i / TL::BK;
      const int k = k0 + kk;
      As[kk * LDA + m] = k < k_end ? aload.load(j, k) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < TL::B_PER; ++j) {
      const int i = tid + j * THREADS;
      const int n = i % TL::BN, kk = i / TL::BN;
      const int k = k0 + kk;
      Bs[kk * TL::BN + n] = (k < k_end && n0 + n < N)
          ? to_f32(B[(int64_t)k * N + n0 + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TL::BK; ++kk) {
      float a[TL::TM], b[TL::TN];
#pragma unroll
      for (int i = 0; i < TL::TM; ++i) a[i] = As[kk * LDA + ty * TL::TM + i];
#pragma unroll
      for (int j = 0; j < TL::TN; ++j) b[j] = Bs[kk * TL::BN + tx * TL::TN + j];
#pragma unroll
      for (int i = 0; i < TL::TM; ++i)
#pragma unroll
        for (int j = 0; j < TL::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Write the tile to a row-major (M, N) output through the fused flush.
// TO is the output type; T is the residual's type.
template <class TL, typename TO, typename T>
__device__ __forceinline__ void store_tile(const float (&acc)[TL::TM][TL::TN],
                                           TO* __restrict__ out, const Epi& ep,
                                           const T* __restrict__ res, int M,
                                           int N, int m0, int n0) {
  const int tid = threadIdx.x;
  const int tx = tid % (TL::BN / TL::TN), ty = tid / (TL::BN / TL::TN);
#pragma unroll
  for (int i = 0; i < TL::TM; ++i) {
    const int m = m0 + ty * TL::TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TL::TN; ++j) {
      const int n = n0 + tx * TL::TN + j;
      if (n >= N) continue;
      const int64_t idx = (int64_t)m * N + n;
      out[idx] = from_f32<TO>(flush(acc[i][j], ep, res, idx, n));
    }
  }
}

// The end of a block: the fused flush into `out` when there is one split,
// else this split's raw sums into its workspace slice.
template <class TL, typename T>
__device__ __forceinline__ void finish(const float (&acc)[TL::TM][TL::TN],
                                       T* __restrict__ out,
                                       float* __restrict__ ws, const Epi& ep,
                                       const T* __restrict__ res, int M,
                                       int N, int m0, int n0) {
  if (gridDim.z == 1) {
    store_tile<TL>(acc, out, ep, res, M, N, m0, n0);
  } else {
    const Epi none{nullptr, nullptr, 0};
    store_tile<TL>(acc, ws + (int64_t)blockIdx.z * M * N, none,
                   static_cast<const T*>(nullptr), M, N, m0, n0);
  }
}

// Second pass of a split reduction: fixed-order sum of the splits' partial
// sums, then the flush and the one store.
template <typename T>
__global__ void __launch_bounds__(THREADS)
split_flush_kernel(const float* __restrict__ ws, int splits, int64_t MN,
                   int N, Epi ep, const T* __restrict__ res,
                   T* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= MN) return;
  float y = 0.f;
  for (int z = 0; z < splits; ++z) y += ws[z * MN + idx];
  out[idx] = from_f32<T>(flush(y, ep, res, idx, (int)(idx % N)));
}

// Rows of a GEMM whose row m is pixel (b, oh, ow) of an NHWC tensor read at
// (b, oh*S, ow*S): a strided 1x1 conv reads its subsampled view in place.
// A plain (M, C) matrix is the case H = W = OH = OW = S = 1.
template <typename T, class TL>
struct RowLoader {
  const T* __restrict__ x;
  int64_t off[TL::A_PER];
  bool valid[TL::A_PER];
  __device__ RowLoader(const T* x_, int m0, int M, int H, int W, int C, int S,
                       int OH, int OW)
      : x(x_) {
#pragma unroll
    for (int j = 0; j < TL::A_PER; ++j) {
      const int m = m0 + TL::a_row(threadIdx.x, j);
      valid[j] = m < M;
      const int b = m / (OH * OW), p = m % (OH * OW);
      const int oh = p / OW, ow = p % OW;
      off[j] = (((int64_t)b * H + (int64_t)oh * S) * W + (int64_t)ow * S) * C;
    }
  }
  __device__ __forceinline__ float load(int j, int c) const {
    return valid[j] ? to_f32(x[off[j] + c]) : 0.f;
  }
};

// Host side: launch a tile kernel over (M tiles, N tiles, splits), then the
// second pass when there is more than one split. `kernel` is a functor that
// launches the first pass on the given grid. Returns cudaGetLastError().
template <class TL, typename T, class Launch>
int launch_split(Launch kernel, int M, int N, int splits, const float* ws,
                 Epi ep, const void* res, void* out, cudaStream_t stream) {
  if (M == 0 || N == 0) return 0;
  if (splits < 1 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  kernel(dim3(ceil_div(M, TL::BM), ceil_div(N, TL::BN), splits));
  int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  const int64_t MN = (int64_t)M * N;
  split_flush_kernel<T><<<(unsigned)((MN + THREADS - 1) / THREADS), THREADS,
                          0, stream>>>(ws, splits, MN, N, ep,
                                       static_cast<const T*>(res),
                                       static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace carla
