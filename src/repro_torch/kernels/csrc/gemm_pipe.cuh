// The pipelined fp32 implicit-GEMM main loop of the CNN kernels: conv2d and
// both 1x1 GEMMs, act-stationary and weight-stationary (a 1x1 conv is the
// case FH = FW = 1, P = 0; a plain (M, C) matrix is B = M, H = W = OH = OW
// = S = 1). The two GEMMs differ only in their plan (kernels/_build.py):
// weight-stationary holds all M rows in one row tile, so each weight
// element is read by one block, once.
//
// out[m, n] = flush(sum_q A[m, q] * B[q, n]) with row m = output pixel
// (b, oh, ow), q = (r, t, c) a filter tap and input channel, A gathered from
// the NHWC input on the fly (im2col without the copy) and B the HWIO weights
// read as the row-major (R, K) matrix they already are.
//
// What bounds it: at the main path's batch-1 shapes the layers need 20-150
// FLOP per compulsory byte, at or above the fp32 ridge of this card (67
// TFLOP/s over 3.35 TB/s), so they are bound by fp32 FMAs on the CUDA cores.
// fp32 stays exact fp32 (no TF32), so the work is to keep the FMA pipes fed:
//
// * A ring of PIPE_STAGES slots in dynamic shared memory, each holding G
//   chunks of BK = 16 reduction indices. The 16-byte cp.async copies of
//   slot i + STAGES - 1 are in flight while slot i is multiplied; one
//   barrier per slot.
// * Two gather paths, picked by the wrapper (the launch refuses a path that
//   the operands do not allow):
//   - vec16: C a multiple of BK, K a whole number of 16-byte vectors, every
//     pointer 16-byte aligned. A chunk then lies inside one filter tap and
//     is BK contiguous channels, so every copy is a 16-byte cp.async (zero
//     fill for spatial padding and ragged edges). The tap (r, t) and the
//     channel offset are walked once per chunk for the whole block: no
//     division in the loop, one address add and two bounds checks a copy.
//   - general: any C and K, any alignment (the C = 3 stems). Each thread
//     owns one column kk of the A chunk; a table built once per block in
//     shared memory gives each reduction index of the split its input
//     offset and tap (and a row table each row's pixel), so the gather
//     divides nothing per element. Element loads, stored into the ring
//     before the chunk is multiplied.
// * 8x8 outputs a thread: per 4 k, 8 A and 8 B 4-vectors from shared
//   memory feed 256 FMAs. A lands pixel-major (cp.async cannot transpose):
//   a thread's rows are ty + i * BM/8, so the threads that read one A vector
//   at a time (a quarter warp for 16 bytes, a half warp for 8) share ty
//   (a broadcast) or hold neighbouring rows (other banks), and its columns
//   are tx*4.. and BN/2 + tx*4.., so each B read is contiguous across them.
//   Neither tile needs padding to be free of bank conflicts.
// * At batch 1 most layers have few output tiles, and an 8x8 tile makes
//   each thread's chain of FMAs long, so the reduction is cut two ways:
//   - inside the block: G groups of threads each multiply one chunk of a
//     slot into their own 8x8 sums, which are added through shared memory
//     in group order at the end (G = 4 on the 64x64 tile for small layers);
//   - across blocks: split z of the grid reduces [z * k_per_split,
//     (z+1) * k_per_split), writes its raw fp32 sums to its workspace
//     slice, and the last block of each output tile to take a ticket
//     (__threadfence, atomicAdd) sums the slices in split order and applies
//     the flush, in the same launch. The counters belong to the wrapper:
//     zero before the launch, reset by the last block, so repeats give
//     identical bits.
// * bf16 operands are copied as bf16 (half the bytes) and converted to fp32
//   when a fragment is read; the sums are fp32.
//
// The flush applies scale -> bias -> residual -> ReLU on the fp32 sum and
// converts to the output type once, at the store.
#pragma once

#include <algorithm>
#include <type_traits>

#include "numeric.cuh"
#include "ptx.cuh"

namespace carla {

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

constexpr int PIPE_BK = 16;          // reduction indices a chunk
constexpr int PIPE_STAGES = 3;       // slots in the shared-memory ring
constexpr int PIPE_TABLE_MAX = 2048; // general path: indices of one split

struct ConvShape {
  int B, H, W, C, K, FH, FW, S, P, OH, OW;
};

// Block tile BM x BN, 8x8 outputs a thread, G groups of threads splitting
// each slot's chunks. MIN_BLOCKS blocks share an SM's 64K registers: at most
// 170 a thread (255 for 256 threads), which the 64 sums, the operand
// vectors and the addressing fit without spilling (at 128 they spill).
template <int BM_, int BN_, int G_>
struct Pipe {
  static constexpr int BM = BM_, BN = BN_, BK = PIPE_BK, G = G_;
  static constexpr int TT = (BM / 8) * (BN / 8);  // threads of one group
  static constexpr int THREADS = G * TT;
  static constexpr int TX = BN / 8;       // threads along n
  static constexpr int ROWSTEP = BM / 8;  // a thread's rows: ty + i*ROWSTEP
  static constexpr int MIN_BLOCKS = 384 / THREADS > 0 ? 384 / THREADS : 1;
  static constexpr int STAGE = BM * BK + BK * BN;  // elements of one chunk
  static constexpr int SLOT = G * STAGE;           // elements of a slot
  static_assert(THREADS % BK == 0 && BN % 8 == 0, "tile shape");
};

// Four consecutive T at p (16-byte aligned for fp32, 8 for bf16) as fp32.
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&f)[4]) {
  uint2 u;
  u.x = pack_bf16(f[0], f[1]);
  u.y = pack_bf16(f[2], f[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

// Pixel of row m: its input offset at tap (0, 0) and the tap's (ih, iw).
// Rows past M get an ih that no tap brings into the image.
__device__ __forceinline__ void pixel_of(const ConvShape& s, int m,
                                         int64_t& pix, int& ih0, int& iw0) {
  if (m >= s.B * s.OH * s.OW) {
    pix = 0;
    ih0 = -0x40000000;
    iw0 = 0;
    return;
  }
  const int b = m / (s.OH * s.OW), p = m - b * (s.OH * s.OW);
  const int oh = p / s.OW, ow = p - oh * s.OW;
  ih0 = oh * s.S - s.P;
  iw0 = ow * s.S - s.P;
  pix = (((int64_t)b * s.H + ih0) * s.W + iw0) * s.C;
}

__device__ __forceinline__ bool in_image(const ConvShape& s, int ih, int iw) {
  return (unsigned)ih < (unsigned)s.H && (unsigned)iw < (unsigned)s.W;
}

// One row of the block's tile: its pixel's input offset at tap (0, 0), and
// the tap's (ih, iw). Built once per block in shared memory.
struct Row {
  long long pix;
  int ih0, iw0;
};

__device__ __forceinline__ void build_rows(const ConvShape& s, int m0,
                                           int bm, Row* rows) {
  for (int i = threadIdx.x; i < bm; i += blockDim.x) {
    int64_t pix;
    pixel_of(s, m0 + i, pix, rows[i].ih0, rows[i].iw0);
    rows[i].pix = pix;
  }
}

// The ring's bytes: PIPE_STAGES slots, which with G > 1 also hold the
// groups' fp32 sums at the end.
template <class P, typename T>
__host__ __device__ constexpr size_t pipe_ring_bytes() {
  const size_t ring = (size_t)PIPE_STAGES * P::SLOT * sizeof(T);
  const size_t sums = P::G > 1 ? (size_t)P::G * P::BM * P::BN * 4 : 0;
  return ring > sums ? ring : sums;
}

// vec16: every copy 16 bytes by cp.async, the tap walked once per chunk.
template <typename T, class P>
struct VecLoader {
  static constexpr int V = 16 / sizeof(T);   // elements a copy
  static constexpr int A_KC = P::BK / V;     // copies along k
  static constexpr int A_ALL = P::BM * A_KC; // A copies of a chunk
  static constexpr int B_NC = P::BN / V;     // copies along n
  static constexpr int B_ALL = P::BK * B_NC; // B copies of a chunk
  static constexpr int A_N = (A_ALL + P::THREADS - 1) / P::THREADS;
  static constexpr int B_N = (B_ALL + P::THREADS - 1) / P::THREADS;
  const T* __restrict__ x;
  const T* __restrict__ w;
  const ConvShape s;
  const Row* rows;
  int n0, k0, k_end;
  int r, t, c0;  // the tap walk: chunk k0 is tap (r, t), channels c0..+BK

  __device__ VecLoader(const T* x_, const T* w_, const ConvShape& s_,
                       const Row* rows_, int n0_, int k_begin, int k_end_,
                       unsigned char*)
      : x(x_), w(w_), s(s_), rows(rows_), n0(n0_), k0(k_begin),
        k_end(k_end_) {
    const int tap = k_begin / s.C;
    c0 = k_begin - tap * s.C;
    r = tap / s.FW;
    t = tap - r * s.FW;
  }

  // Issue the copies of the next chunk into (As, Bs); advance the walk.
  __device__ __forceinline__ void fetch(T* As, T* Bs) {
    const int tap_off = (r * s.W + t) * s.C + c0;
#pragma unroll
    for (int j = 0; j < A_N; ++j) {
      const int i = threadIdx.x + j * P::THREADS;
      if (A_ALL % P::THREADS == 0 || i < A_ALL) {
        const Row rw = rows[i / A_KC];
        const bool ok = in_image(s, rw.ih0 + r, rw.iw0 + t);
        cp_async16(As + (i / A_KC) * P::BK + (i % A_KC) * V,
                   ok ? x + rw.pix + tap_off + (i % A_KC) * V : x, ok);
      }
    }
#pragma unroll
    for (int j = 0; j < B_N; ++j) {
      const int i = threadIdx.x + j * P::THREADS;
      if (B_ALL % P::THREADS == 0 || i < B_ALL) {
        const int kk = i / B_NC, n = n0 + (i % B_NC) * V;
        const bool ok = k0 + kk < k_end && n < s.K;
        cp_async16(Bs + kk * P::BN + (i % B_NC) * V,
                   ok ? w + (int64_t)(k0 + kk) * s.K + n : w, ok);
      }
    }
    k0 += P::BK;
    c0 += P::BK;
    if (c0 == s.C) {
      c0 = 0;
      if (++t == s.FW) { t = 0; ++r; }
    }
  }
};

// general: element loads stored straight into the ring (no registers held
// across the multiply), offsets from per-block tables.
template <typename T, class P>
struct ElemLoader {
  static constexpr int A_N = P::BM * P::BK / P::THREADS;  // A values a thread
  static constexpr int A_STEP = P::THREADS / P::BK;       // ... rows apart
  static constexpr int B_N = P::BK * P::BN / P::THREADS;  // B values a thread
  static constexpr int NO_TAP = 0x4000;  // a tap row no pixel reaches
  static_assert(A_N * P::THREADS == P::BM * P::BK &&
                B_N * P::THREADS == P::BK * P::BN, "loads split evenly");
  const T* __restrict__ x;
  const T* __restrict__ w;
  const ConvShape s;
  int n0, k0, k_begin, k_end;
  const Row* rows;  // [BM]
  const int2* tab;  // [split length]: input offset, (tap row << 16) | col

  __device__ ElemLoader(const T* x_, const T* w_, const ConvShape& s_,
                        const Row* rows_, int n0_, int k_begin_, int k_end_,
                        unsigned char* scratch)
      : x(x_), w(w_), s(s_), n0(n0_), k0(k_begin_), k_begin(k_begin_),
        k_end(k_end_), rows(rows_) {
    int2* tb = reinterpret_cast<int2*>(scratch);
    for (int q = threadIdx.x; q < k_end - k_begin; q += P::THREADS) {
      const int tap = (k_begin + q) / s.C, c = k_begin + q - tap * s.C;
      const int rr = tap / s.FW, tt = tap - rr * s.FW;
      tb[q] = make_int2((rr * s.W + tt) * s.C + c, (rr << 16) | tt);
    }
    tab = tb;
  }

  // Load the next chunk into (As, Bs).
  __device__ __forceinline__ void fetch(T* As, T* Bs) {
    const int kk = threadIdx.x % P::BK, q = k0 + kk;
    int off = 0, dr = NO_TAP, dt = 0;
    if (q < k_end) {
      const int2 e = tab[q - k_begin];
      off = e.x;
      dr = e.y >> 16;
      dt = e.y & 0xffff;
    }
    T a[A_N], b[B_N];
#pragma unroll
    for (int j = 0; j < A_N; ++j) {
      const Row& rw = rows[threadIdx.x / P::BK + j * A_STEP];
      a[j] = in_image(s, rw.ih0 + dr, rw.iw0 + dt) ? x[rw.pix + off]
                                                    : from_f32<T>(0.f);
    }
#pragma unroll
    for (int j = 0; j < B_N; ++j) {
      const int i = threadIdx.x + j * P::THREADS;
      const int k = k0 + i / P::BN, n = n0 + i % P::BN;
      b[j] = k < k_end && n < s.K ? w[(int64_t)k * s.K + n]
                                  : from_f32<T>(0.f);
    }
#pragma unroll
    for (int j = 0; j < A_N; ++j)
      As[(threadIdx.x / P::BK + j * A_STEP) * P::BK + kk] = a[j];
#pragma unroll
    for (int j = 0; j < B_N; ++j) Bs[threadIdx.x + j * P::THREADS] = b[j];
    k0 += P::BK;
  }
};

// acc += As (BM x BK, pixel-major) @ Bs (BK x BN) for one thread's 8x8
// (tx, ty within its group).
template <typename T, class P>
__device__ __forceinline__ void chunk_fma(const T* As, const T* Bs, int tx,
                                          int ty, float (&acc)[8][8]) {
#pragma unroll
  for (int kq = 0; kq < P::BK; kq += 4) {
    float a[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      load4(As + (ty + i * P::ROWSTEP) * P::BK + kq, a[i]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float b0[4], b1[4];
      load4(Bs + (kq + k) * P::BN + tx * 4, b0);
      load4(Bs + (kq + k) * P::BN + P::BN / 2 + tx * 4, b1);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a[i][k], b0[j], acc[i][j]);
          acc[i][4 + j] = fmaf(a[i][k], b1[j], acc[i][4 + j]);
        }
      }
    }
  }
}

// Four outputs of one row, columns n..n+3, through the flush. VEC: N is a
// multiple of 4 and the row start aligned, so the four are stored (and the
// residual read) as one vector.
template <typename T, bool VEC>
__device__ __forceinline__ void flush_store4(const float* v, T* out,
                                             const T* res, const Epi& ep,
                                             int64_t row, int n, int N) {
  if (VEC) {
    if (n >= N) return;
    float y[4], rv[4];
    if (res) load4(res + row + n, rv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      y[e] = v[e];
      if (ep.scale) y[e] *= ep.scale[n + e];
      if (ep.bias) y[e] += ep.bias[n + e];
      if (res) y[e] += rv[e];
      if (ep.relu) y[e] = fmaxf(y[e], 0.f);
    }
    store4(out + row + n, y);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n + e < N)
        out[row + n + e] =
            from_f32<T>(flush(v[e], ep, res, row + n + e, n + e));
  }
}

template <typename T, class P, bool VEC>
__global__ void __launch_bounds__(P::THREADS, P::MIN_BLOCKS)
pipe_conv_kernel(const T* __restrict__ x, const T* __restrict__ w, Epi ep,
                 const T* __restrict__ res, T* __restrict__ out,
                 float* __restrict__ ws, int* __restrict__ tickets,
                 ConvShape s, int k_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  T* ring = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x, group = tid / P::TT, gt = tid % P::TT;
  const int tx = gt % P::TX, ty = gt / P::TX;
  const int M = s.B * s.OH * s.OW, R = s.FH * s.FW * s.C;
  const int m0 = blockIdx.x * P::BM, n0 = blockIdx.y * P::BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(R, k_begin + k_per_split);
  const int n_chunks = ceil_div(k_end - k_begin, P::BK);
  const int n_slots = ceil_div(n_chunks, P::G);
  using Loader = typename std::conditional<VEC, VecLoader<T, P>,
                                           ElemLoader<T, P>>::type;
  Row* rows = reinterpret_cast<Row*>(smem + pipe_ring_bytes<P, T>());
  build_rows(s, m0, P::BM, rows);
  Loader ld(x, w, s, rows, n0, k_begin, k_end,
            reinterpret_cast<unsigned char*>(rows + P::BM));
  __syncthreads();  // the row table, and the general path's index table

  // the ring: slot i (chunks i*G .. i*G + G-1) sits in ring slot i % STAGES
  auto fetch_slot = [&](int i) {
    T* slot = ring + (i % PIPE_STAGES) * P::SLOT;
#pragma unroll
    for (int g = 0; g < P::G; ++g)
      if (i * P::G + g < n_chunks)
        ld.fetch(slot + g * P::STAGE, slot + g * P::STAGE + P::BM * P::BK);
  };
#pragma unroll
  for (int st = 0; st < PIPE_STAGES - 1; ++st) {
    if (st < n_slots) fetch_slot(st);
    cp_async_commit();
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int i = 0; i < n_slots; ++i) {
    cp_async_wait<PIPE_STAGES - 2>();
    __syncthreads();  // slot i landed; every thread is done with i - 1
    if (i + PIPE_STAGES - 1 < n_slots) fetch_slot(i + PIPE_STAGES - 1);
    cp_async_commit();
    if (i * P::G + group < n_chunks) {
      const T* chunk = ring + (i % PIPE_STAGES) * P::SLOT + group * P::STAGE;
      chunk_fma<T, P>(chunk, chunk + P::BM * P::BK, tx, ty, acc);
    }
  }
  cp_async_wait<0>();

  // From here each group owns rows i of the 8x8 with i / (8 / G) == group:
  // it adds the groups' sums for them (in group order, through shared
  // memory), and the split combine and the store are shared the same way.
  constexpr int TILE = P::BM * P::BN;
  constexpr int IPG = 8 / P::G;
  static_assert(IPG * P::G == 8, "G divides the 8 rows of a thread");
  if (P::G > 1) {
    float4* red = reinterpret_cast<float4*>(smem);
    __syncthreads();  // every group is done with the ring
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        red[(group * 16 + i * 2 + h) * P::TT + gt] =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i / IPG != group) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 v = red[(i * 2 + h) * P::TT + gt];
        for (int g = 1; g < P::G; ++g) {
          const float4 p = red[(g * 16 + i * 2 + h) * P::TT + gt];
          v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
        }
        acc[i][4 * h] = v.x; acc[i][4 * h + 1] = v.y;
        acc[i][4 * h + 2] = v.z; acc[i][4 * h + 3] = v.w;
      }
    }
  }

  if (gridDim.z > 1) {
    // this split's sums, coalesced, into its slice of the workspace
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const int64_t n_tiles = (int64_t)gridDim.x * gridDim.y;
    float4* part = reinterpret_cast<float4*>(
        ws + (blockIdx.z * n_tiles + tile) * TILE);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i / IPG != group) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        __stcg(part + (i * 2 + h) * P::TT + gt,
               make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                           acc[i][4 * h + 2], acc[i][4 * h + 3]));
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(tickets + tile, 1) == (int)gridDim.z - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // the last block: every split's sums, added in split order; G splits'
    // loads in flight at a time (16 vectors a thread)
    const float4* src = reinterpret_cast<const float4*>(ws + tile * TILE) +
                        (group * IPG * 2) * P::TT + gt;
    const int64_t zstep = n_tiles * TILE / 4;
    const int n_split = gridDim.z;
    float4 sum[IPG * 2];
#pragma unroll
    for (int u = 0; u < IPG * 2; ++u) sum[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z0 = 0; z0 < n_split; z0 += P::G) {
      float4 p[P::G][IPG * 2];
#pragma unroll
      for (int zz = 0; zz < P::G; ++zz)
        if (z0 + zz < n_split)
#pragma unroll
          for (int u = 0; u < IPG * 2; ++u)
            p[zz][u] = __ldcg(src + (z0 + zz) * zstep + u * P::TT);
#pragma unroll
      for (int zz = 0; zz < P::G; ++zz)
        if (z0 + zz < n_split)
#pragma unroll
          for (int u = 0; u < IPG * 2; ++u) {
            sum[u].x += p[zz][u].x; sum[u].y += p[zz][u].y;
            sum[u].z += p[zz][u].z; sum[u].w += p[zz][u].w;
          }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i / IPG != group) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = sum[(i - group * IPG) * 2 + h];
        acc[i][4 * h] = v.x; acc[i][4 * h + 1] = v.y;
        acc[i][4 * h + 2] = v.z; acc[i][4 * h + 3] = v.w;
      }
    }
    if (tid == 0) tickets[tile] = 0;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + i * P::ROWSTEP;
    if (i / IPG != group || m >= M) continue;
    const int64_t row = (int64_t)m * s.K;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      flush_store4<T, VEC>(&acc[i][4 * h], out, res, ep, row,
                           n0 + h * (P::BN / 2) + tx * 4, s.K);
  }
}

// Dynamic shared memory of a launch: the ring, the row table, and on the
// general path the index table of one split.
template <typename T, class P, bool VEC>
size_t pipe_smem_bytes(int table_len) {
  const size_t fixed = pipe_ring_bytes<P, T>() + P::BM * sizeof(Row);
  return VEC ? fixed : fixed + (size_t)table_len * sizeof(int2);
}

template <typename T, class P, bool VEC>
int pipe_launch_tile(const void* x, const void* w, Epi ep, const void* res,
                     void* out, float* ws, int* tickets, const ConvShape& s,
                     int splits, int k_per_split, cudaStream_t stream) {
  const int R = s.FH * s.FW * s.C;
  const size_t bytes = pipe_smem_bytes<T, P, VEC>(std::min(k_per_split, R));
  auto kernel = pipe_conv_kernel<T, P, VEC>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(ceil_div(s.B * s.OH * s.OW, P::BM), ceil_div(s.K, P::BN),
                  splits);
  kernel<<<grid, P::THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), ep,
      static_cast<const T*>(res), static_cast<T*>(out), ws, tickets, s,
      k_per_split);
  return (int)cudaGetLastError();
}

// The block tiles, by the wrapper's tile code (kernels/_build.py:PIPE_TILES):
// 128x64 for layers with many output tiles, 64x64 for fewer, and 64x64
// with four groups for the few-tile layers of batch 1. Weight-stationary
// takes one of those whose rows hold all of M. (128x128 blocks ran
// at half 128x64's rate on the H100: 255 registers, one block an SM.)
using PipeM = Pipe<128, 64, 1>;
using PipeS = Pipe<64, 64, 1>;
using PipeG = Pipe<64, 64, 4>;

template <typename T, bool VEC>
int pipe_launch_vec(int tile, const void* x, const void* w, Epi ep,
                    const void* res, void* out, float* ws, int* tickets,
                    const ConvShape& s, int splits, int k_per_split,
                    cudaStream_t st) {
  switch (tile) {
    case 0: return pipe_launch_tile<T, PipeM, VEC>(
        x, w, ep, res, out, ws, tickets, s, splits, k_per_split, st);
    case 1: return pipe_launch_tile<T, PipeS, VEC>(
        x, w, ep, res, out, ws, tickets, s, splits, k_per_split, st);
    case 2: return pipe_launch_tile<T, PipeG, VEC>(
        x, w, ep, res, out, ws, tickets, s, splits, k_per_split, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Checks the plan against the operands (a path they do not allow, a split
// that does not cover R = FH*FW*C exactly once) and launches.
template <typename T>
int pipe_launch(int tile, int vec, const void* x, const void* w, Epi ep,
                const void* res, void* out, float* ws, int* tickets,
                const ConvShape& s, int splits, int k_per_split,
                cudaStream_t st) {
  const int M = s.B * s.OH * s.OW, R = s.FH * s.FW * s.C;
  if (M == 0 || s.K == 0) return 0;
  if (splits < 1 || k_per_split <= 0 || k_per_split % PIPE_BK != 0 ||
      (int64_t)splits * k_per_split < R ||
      (splits > 1 && ((int64_t)(splits - 1) * k_per_split >= R ||
                      ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (vec) {
    if (s.C % PIPE_BK != 0 || (s.K * sizeof(T)) % 16 != 0 || !aligned16(x) ||
        !aligned16(w) || !aligned16(out) || (res && !aligned16(res)))
      return (int)cudaErrorInvalidValue;
    return pipe_launch_vec<T, true>(tile, x, w, ep, res, out, ws, tickets, s,
                                    splits, k_per_split, st);
  }
  if (std::min(k_per_split, R) > PIPE_TABLE_MAX)
    return (int)cudaErrorInvalidValue;
  return pipe_launch_vec<T, false>(tile, x, w, ep, res, out, ws, tickets, s,
                                   splits, k_per_split, st);
}

}  // namespace carla
