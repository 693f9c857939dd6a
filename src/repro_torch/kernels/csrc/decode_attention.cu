// Fused decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py:_decode_attn_kernel, the
// Pallas TPU kernel for one query token per sequence against its KV cache
// (zamba2's shared attention block in every decode step, 9 per step).
//
// What it computes, for q (B, H, DH), cache k and v (B, S, KH, DH) and
// pos (B,) int32, head h reading kv head h / G (G = H / KH):
//   s[j] = (q . k[j]) * scale, masked to NEG_INF unless j <= pos[b];
//   out = sum_j p[j] v[j] / max(l, 1e-30), p = exp(s - m) summed into l in
//   fp32 and rounded to v's type before the product (`p.astype(v.dtype)` in
//   the Pallas kernel), stored once in q's type. pos must lie in [0, S).
//
// Why not the Pallas grid: there the S axis is the sequential innermost grid
// dimension, carrying the online softmax in scratch. At zamba2's decode shape
// (B 4, KH 32) that leaves B * KH = 128 independent walks of 2080 rows for
// 132 SMs, each walk one long chain of dependent loads. So the cache is split
// into chunks of 128 rows: grid (chunks, KH, B), about 2200 blocks, each
// block reading its chunk once for all G query heads of its kv head and
// writing its chunk's max, sum and unnormalised output to a workspace. A
// second kernel combines the chunks per head in a fixed order (so the result
// does not change from run to run): M = max m_i, out = sum_i acc_i e^(m_i -
// M) / sum_i l_i e^(m_i - M). Chunks past pos[b] exit before reading
// anything, so a sequence reads only the rows it can see.
//
// Bound on this card: about 4 FLOP per cache byte, so device-memory bytes
// bound it: 85 MB of bf16 cache at zamba2's shape, 0.025 ms at 3.35 TB/s.
// Each thread of the first kernel owns one cache row of K and loads it with
// 16-byte vector loads, all issued before the dot products; the V pass gives
// each thread 16-byte slices of every (128 / (G * DH/VEC))-th row and sums
// the slices' partial outputs through shared memory in a fixed order.
#include "numeric.cuh"

namespace carla {

constexpr int DA_CH = 128;       // cache rows per block, one per thread
constexpr int DA_THREADS = 128;
constexpr float DA_NEG_INF = -2.3819763e38f;

struct DecodeShape {
  int B, S, H, KH, G, n_chunks;
  float scale;
};

// Workspace index of (b, kh, chunk, g).
__device__ __forceinline__ int64_t ws_index(const DecodeShape& s, int b,
                                            int kh, int chunk, int g) {
  return (((int64_t)b * s.KH + kh) * s.n_chunks + chunk) * s.G + g;
}

// The number of row groups of the V pass for G heads of DH (see the header).
template <typename T, int DH>
__host__ __device__ inline int row_groups(int G) {
  const int items = G * (DH / Vec16<T>::N);
  return items >= DA_THREADS ? 1 : DA_THREADS / items;
}

template <typename T, int DH>
__host__ __device__ inline size_t split_smem_bytes(int G) {
  return sizeof(float) * ((size_t)G * DH + (size_t)G * DA_CH +
                          (size_t)row_groups<T, DH>(G) * G * DH);
}

template <typename T, int DH>
__global__ void __launch_bounds__(DA_THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    float* __restrict__ ws_m, float* __restrict__ ws_l,
                    float* __restrict__ ws_acc, DecodeShape s) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int CHUNKS = DH / VEC;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [G][DH]
  float* ps = qs + s.G * DH;        // [G][DA_CH]: scores, then rounded p
  float* part = ps + s.G * DA_CH;   // [row group][G][DH]

  const int chunk = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int kmax = min(pos[b], s.S - 1);
  const int r0 = chunk * DA_CH;
  if (r0 > kmax) return;  // the whole chunk lies past pos
  const int tid = threadIdx.x;
  const int64_t row_stride = (int64_t)s.KH * DH;

  for (int i = tid; i < s.G * DH; i += DA_THREADS)
    qs[i] = to_f32(q[((int64_t)b * s.H + kh * s.G) * DH + i]);
  __syncthreads();

  // scores: thread tid owns row r0 + tid
  const int row = r0 + tid;
  if (row <= kmax) {
    const T* kp = k + ((int64_t)b * s.S + row) * row_stride +
                  (int64_t)kh * DH;
    float kr[DH];
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) load16(kp + c * VEC, kr + c * VEC);
    for (int g = 0; g < s.G; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) dot = fmaf(kr[d], qs[g * DH + d], dot);
      ps[g * DA_CH + tid] = dot * s.scale;
    }
  } else {
    for (int g = 0; g < s.G; ++g) ps[g * DA_CH + tid] = DA_NEG_INF;
  }
  __syncthreads();

  // the chunk's softmax, one warp per head
  const int warp = tid / 32, lane = tid % 32;
  for (int g = warp; g < s.G; g += DA_THREADS / 32) {
    float x[DA_CH / 32];
    float mx = DA_NEG_INF;
#pragma unroll
    for (int i = 0; i < DA_CH / 32; ++i) {
      x[i] = ps[g * DA_CH + lane + 32 * i];
      mx = fmaxf(mx, x[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < DA_CH / 32; ++i) {
      const float p = expf(x[i] - mx);
      sum += p;
      ps[g * DA_CH + lane + 32 * i] = round_to<T>(p);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      ws_m[ws_index(s, b, kh, chunk, g)] = mx;
      ws_l[ws_index(s, b, kh, chunk, g)] = sum;
    }
  }
  __syncthreads();

  // unnormalised output: item = (g, 16-byte slice), rows split over groups
  const int nrows = min(DA_CH, kmax - r0 + 1);
  const int items = s.G * CHUNKS;
  const int groups = row_groups<T, DH>(s.G);
  const T* vb = v + ((int64_t)b * s.S + r0) * row_stride + (int64_t)kh * DH;
  for (int o = tid; o < items * groups; o += DA_THREADS) {
    const int it = o % items, rg = o / items;
    const int g = it / CHUNKS, d0 = (it % CHUNKS) * VEC;
    float a[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) a[e] = 0.f;
    for (int r = rg; r < nrows; r += groups) {
      float f[VEC];
      load16(vb + (int64_t)r * row_stride + d0, f);
      const float p = ps[g * DA_CH + r];
#pragma unroll
      for (int e = 0; e < VEC; ++e) a[e] = fmaf(p, f[e], a[e]);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) part[(rg * s.G + g) * DH + d0 + e] = a[e];
  }
  __syncthreads();
  for (int o = tid; o < s.G * DH; o += DA_THREADS) {
    float a = 0.f;
    for (int rg = 0; rg < groups; ++rg) a += part[rg * s.G * DH + o];
    ws_acc[ws_index(s, b, kh, chunk, 0) * DH + o] = a;
  }
}

template <typename T>
__global__ void __launch_bounds__(DA_THREADS)
decode_combine_kernel(const float* __restrict__ ws_m,
                      const float* __restrict__ ws_l,
                      const float* __restrict__ ws_acc,
                      const int* __restrict__ pos, T* __restrict__ out,
                      DecodeShape s, int DH) {
  const int kh = blockIdx.x, b = blockIdx.y;
  const int kmax = min(pos[b], s.S - 1);
  const int n = kmax < 0 ? 0 : kmax / DA_CH + 1;  // chunks that ran
  for (int o = threadIdx.x; o < s.G * DH; o += blockDim.x) {
    const int g = o / DH;
    float M = DA_NEG_INF;
    for (int i = 0; i < n; ++i) M = fmaxf(M, ws_m[ws_index(s, b, kh, i, g)]);
    float L = 0.f, A = 0.f;
    for (int i = 0; i < n; ++i) {
      const int64_t w = ws_index(s, b, kh, i, g);
      const float scale = expf(ws_m[w] - M);
      L += ws_l[w] * scale;
      A += ws_acc[ws_index(s, b, kh, i, 0) * DH + o] * scale;
    }
    out[((int64_t)b * s.H + kh * s.G) * DH + o] =
        from_f32<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, const int* pos,
              void* out, float* ws, const DecodeShape& s,
              cudaStream_t stream) {
  const size_t bytes = split_smem_bytes<T, DH>(s.G);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t n_ws = (int64_t)s.B * s.KH * s.n_chunks * s.G;
  float* ws_m = ws;
  float* ws_l = ws + n_ws;
  float* ws_acc = ws + 2 * n_ws;
  decode_split_kernel<T, DH><<<dim3(s.n_chunks, s.KH, s.B), DA_THREADS,
                               bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, ws_m, ws_l, ws_acc, s);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  decode_combine_kernel<T><<<dim3(s.KH, s.B), DA_THREADS, 0, stream>>>(
      ws_m, ws_l, ws_acc, pos, static_cast<T*>(out), s, DH);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* out, float* ws, const DecodeShape& s, int dh,
           cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_dh<T, 16>(q, k, v, pos, out, ws, s, stream);
    case 64: return launch_dh<T, 64>(q, k, v, pos, out, ws, s, stream);
    case 80: return launch_dh<T, 80>(q, k, v, pos, out, ws, s, stream);
    case 128: return launch_dh<T, 128>(q, k, v, pos, out, ws, s, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace carla

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out, contiguous and 16-byte
// aligned). q and out are (B, H, DH); k and v are (B, S, KH, DH) with H a
// multiple of KH; pos is (B,) int32. ws: fp32 workspace of
// B * KH * n_chunks * H/KH * (2 + DH) values, n_chunks = ceil(S / 128).
// Returns cudaGetLastError() (or the error of the shared-memory opt-in).
extern "C" int carla_decode_attention(int dtype, const void* q, const void* k,
                                      const void* v, const void* pos,
                                      void* out, void* ws, int B, int S,
                                      int H, int KH, int DH, float scale,
                                      void* stream) {
  if (B == 0 || H == 0) return 0;
  if (S <= 0 || KH <= 0 || H % KH != 0) return (int)cudaErrorInvalidValue;
  const carla::DecodeShape s{B, S, H, KH, H / KH,
                             carla::ceil_div(S, carla::DA_CH), scale};
  const int* p = static_cast<const int*>(pos);
  float* w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return carla::launch<float>(q, k, v, p, out, w, s, DH, st);
  if (dtype == 1)
    return carla::launch<__nv_bfloat16>(q, k, v, p, out, w, s, DH, st);
  return (int)cudaErrorInvalidValue;
}
