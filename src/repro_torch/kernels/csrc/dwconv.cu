// Depthwise convolution for Hopper (sm_90a): one k x k filter a channel,
// NHWC, with the fused flush and, when asked, the per-channel sums of its
// outputs that a squeeze-and-excitation mean reads.
//
// Replaces: no TPU kernel. The JAX package runs no depthwise 2-D conv; this
// kernel serves the MBConv blocks of EfficientNetV2-S (models/efficientnet.py,
// 30 3x3 depthwise convs a forward, stride 1 and 2), through carla_conv's
// depthwise route. Its nearest relative in csrc/ is conv1d.cu, Mamba2's 1-D
// depthwise conv.
//
// What it computes: out[b, oh, ow, c] = flush(sum_{r, t} x[b, oh*S - P + r,
// ow*S - P + t, c] * w[r, t, c]) for NHWC x and w of (k, k, 1, C), k odd,
// P = (k - 1) / 2 (zero padding, symmetric), fp32 sums, the flush scale ->
// bias -> activation (none, ReLU or SiLU) on the fp32 sum, one store in x's
// type. With `sums` non-null it also writes sums[b, tile, c], the fp32 sum of
// the flushed values of the tile's DW_TILE_PIX output pixels of image b (the
// pixels in row-major order, tile by tile): plain stores of sums added in a
// fixed order, no atomics, so a replay gives the same bits. se.cu adds the
// tiles in tile order for the mean.
//
// Bound on this card: k*k FMAs a channel and output pixel (18 FLOP at 3x3)
// against reading the input and writing the output once (8 bytes an output
// in fp32 at stride 1, 20 at stride 2): 1-2 FLOP a byte, far under the fp32
// ridge of 20, so bytes bound it. The design keeps every access a 16-byte
// vector of channels: each thread owns one output pixel and one vector of
// channels (4 fp32, 8 bf16), the 16 threads of a half warp hold 16
// neighbouring vectors of one pixel, so every tap's load is 256 contiguous
// bytes and the k*k taps of neighbouring pixels, which overlap, come from
// the L1; the weights (k*k vectors a thread) from the L1 too. A block is 16
// pixels x 16 vectors, so the batch-1 maps of EfficientNetV2-S (12x12 to
// 24x24, 256-1536 channels) give 72-540 blocks. The sums need one pass over
// shared memory a block. Channel counts that are no whole number of vectors,
// or operands not 16-byte aligned, take the scalar instance. It is a
// programmatic dependent launch: placed while the expansion before it
// finishes, each block waits (griddepcontrol.wait) before it reads
// anything; and every block lets the next launch be placed as it starts
// (griddepcontrol.launch_dependents), so that the SE gate after it asks the
// L2 for its weights meanwhile.
#include "numeric.cuh"
#include "ptx.cuh"

namespace {

constexpr int DW_THREADS = 256;
constexpr int DW_LANES = 16;                       // vectors a block
constexpr int DW_TILE_PIX = DW_THREADS / DW_LANES;  // output pixels a block
constexpr int ACT_RELU = 1, ACT_SILU = 2;

struct DwShape {
  int B, H, W, C, k, S, P, OH, OW, tiles;
};

template <typename T, int V>
__device__ __forceinline__ void load_v(const T* p, float (&f)[V]) {
  if constexpr (V == 1)
    f[0] = carla::to_f32(*p);
  else
    carla::load16(p, f);
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* p, const float (&f)[V]) {
  if constexpr (V == 1)
    *p = carla::from_f32<T>(f[0]);
  else
    carla::store16(p, f);
}

// V: channels a thread (a 16-byte vector, or 1); KS: k at compile time (3,
// 5), or 0 for any odd k given at run time.
template <typename T, int V, int KS>
__global__ void __launch_bounds__(DW_THREADS)
dwconv_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const float* __restrict__ scale, const float* __restrict__ bias,
              T* __restrict__ out, float* __restrict__ sums, DwShape s,
              int act) {
  __shared__ float red[DW_TILE_PIX][DW_LANES * V];
  // the next launch (an MBConv block's SE gate, se.cu) may be placed at
  // once: before its own wait it reads nothing this kernel writes; then
  // this block waits for the launch before it (its input's writer)
  carla::grid_dependents_launch();
  carla::grid_dependency_wait();
  const int k = KS ? KS : s.k;
  const int lane = threadIdx.x % DW_LANES, py = threadIdx.x / DW_LANES;
  const int c0 = (blockIdx.x * DW_LANES + lane) * V;
  const int b = blockIdx.z, tile = blockIdx.y;
  const int p = tile * DW_TILE_PIX + py;
  const bool live = c0 < s.C && p < s.OH * s.OW;
  float y[V];
#pragma unroll
  for (int e = 0; e < V; ++e) y[e] = 0.f;
  if (live) {
    const int oh = p / s.OW, ow = p - oh * s.OW;
    const int ih0 = oh * s.S - s.P, iw0 = ow * s.S - s.P;
    const T* xb = x + (int64_t)b * s.H * s.W * s.C + c0;
#pragma unroll
    for (int r = 0; r < k; ++r) {
      const int ih = ih0 + r;
      if ((unsigned)ih >= (unsigned)s.H) continue;
#pragma unroll
      for (int t = 0; t < k; ++t) {
        const int iw = iw0 + t;
        if ((unsigned)iw >= (unsigned)s.W) continue;
        float xv[V], wv[V];
        load_v<T, V>(xb + ((int64_t)ih * s.W + iw) * s.C, xv);
        load_v<T, V>(w + (r * k + t) * s.C + c0, wv);
#pragma unroll
        for (int e = 0; e < V; ++e) y[e] = fmaf(xv[e], wv[e], y[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (scale) y[e] *= scale[c0 + e];
      if (bias) y[e] += bias[c0 + e];
      if (act == ACT_SILU)
        y[e] = y[e] / (1.f + expf(-y[e]));
      else if (act == ACT_RELU)
        y[e] = fmaxf(y[e], 0.f);
    }
    store_v<T, V>(out + ((int64_t)b * s.OH * s.OW + p) * s.C + c0, y);
  }
  if (sums == nullptr) return;
  // the tile's sums: each pixel's flushed fp32 values (0 past the map), added
  // in pixel order
#pragma unroll
  for (int e = 0; e < V; ++e) red[py][lane * V + e] = live ? y[e] : 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < DW_LANES * V; i += DW_THREADS) {
    const int c = blockIdx.x * DW_LANES * V + i;
    if (c >= s.C) continue;
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < DW_TILE_PIX; ++q) acc += red[q][i];
    sums[((int64_t)b * s.tiles + tile) * s.C + c] = acc;
  }
}

template <typename T, int V>
int launch_k(const void* x, const void* w, const float* scale,
             const float* bias, void* out, float* sums, const DwShape& s,
             int act, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(carla::ceil_div(s.C, DW_LANES * V), s.tiles, s.B);
  cfg.blockDim = dim3(DW_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  cudaError_t err;
  switch (s.k) {
    case 3:
      err = cudaLaunchKernelEx(&cfg, dwconv_kernel<T, V, 3>, xp, wp, scale,
                               bias, op, sums, s, act);
      break;
    case 5:
      err = cudaLaunchKernelEx(&cfg, dwconv_kernel<T, V, 5>, xp, wp, scale,
                               bias, op, sums, s, act);
      break;
    default:
      err = cudaLaunchKernelEx(&cfg, dwconv_kernel<T, V, 0>, xp, wp, scale,
                               bias, op, sums, s, act);
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch_t(const void* x, const void* w, const float* scale,
             const float* bias, void* out, float* sums, const DwShape& s,
             int act, cudaStream_t st) {
  constexpr int V = carla::Vec16<T>::N;
  if (s.C % V == 0 && aligned16(x) && aligned16(w) && aligned16(out))
    return launch_k<T, V>(x, w, scale, bias, out, sums, s, act, st);
  return launch_k<T, 1>(x, w, scale, bias, out, sums, s, act, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x (B, H, W, C) and w (k, k, 1, C) in
// that type, out (B, OH, OW, C) too; scale/bias fp32 (C,) or null; act 0
// none, 1 ReLU, 2 SiLU; k odd, padding (k - 1) / 2, OH and OW the map that
// gives at stride S. sums, or null, is fp32 (B, tiles, C) with tiles =
// ceil(OH * OW / DW_TILE_PIX). Returns cudaGetLastError()
// (cudaErrorInvalidValue for operands the kernel does not take).
extern "C" int carla_dwconv(int dtype, const void* x, const void* w,
                            const void* scale, const void* bias, void* out,
                            void* sums, int B, int H, int W, int C, int k,
                            int S, int OH, int OW, int act, void* stream) {
  const int P = (k - 1) / 2;
  if (k < 1 || k % 2 == 0 || S < 1 || act < 0 || act > ACT_SILU ||
      OH != (H + 2 * P - k) / S + 1 || OW != (W + 2 * P - k) / S + 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0 || OH <= 0 || OW <= 0) return 0;
  const int tiles = carla::ceil_div(OH * OW, DW_TILE_PIX);
  if (B > 65535 || tiles > 65535) return (int)cudaErrorInvalidValue;
  const DwShape s{B, H, W, C, k, S, P, OH, OW, tiles};
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* su = static_cast<float*>(sums);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(x, w, sc, bi, out, su, s, act, st);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(x, w, sc, bi, out, su, s, act, st);
  return (int)cudaErrorInvalidValue;
}
