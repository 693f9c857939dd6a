// Fused decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py:_decode_attn_kernel, the
// Pallas TPU kernel for one query token per sequence against its KV cache
// (zamba2's shared attention block in every decode step, 9 per step; every
// attention layer of the attention archs, gemma2's and mixtral's windowed
// and soft-capped layers included).
//
// What it computes, for q (B, H, DH), cache k and v (B, S, KH, DH) and
// pos (B,) int32, head h reading kv head h / G (G = H / KH):
//   s[j] = (q . k[j]) * scale, then softcap * tanh(s / softcap) when
//   softcap > 0; masked to NEG_INF unless j <= pos[b] and (window <= 0 or
//   j > pos[b] - window);
//   out = sum_j p[j] v[j] / max(l, 1e-30), p = exp(s - m) summed into l in
//   fp32 and rounded to v's type before the product (`p.astype(v.dtype)` in
//   the Pallas kernel), stored once in q's type. pos must be >= 0.
// The Pallas kernel takes only the causal mask; the reference applies the
// soft-cap and the window in jnp around it (repro/models/attention.py,
// attention_decode), and this kernel takes both.
//
// Rolling caches (a sliding-window layer keeps a ring of W = min(window,
// max_seq) slots, the token at position p in slot p % W): slot j then holds
// position pos - ((pos - j) mod W), which is a real token exactly when
// j <= min(pos, W - 1). That is this kernel's causal mask at the position
// min(pos, W - 1), with no window, and softmax does not depend on the order
// of its keys. So the ring needs nothing here: the wrapper
// (models/attention.py, attention_decode) writes the new k/v at pos % W and
// passes min(pos, W - 1) as pos.
//
// Cache shards (decode over a cache whose S axis is sharded over a mesh):
// a shard holds rows k_offset .. k_offset + S - 1 of the cache, so row j
// is key k_offset + j and the mask above reads j + k_offset for j. A shard
// may see no key at all (all its rows past pos, or all before the window):
// then one split runs no tile and the combine writes a zero output and, if
// asked, a log-sum-exp of -inf, never a NaN. With lse given, the combine
// also writes each head's log-sum-exp M + log(L) (fp32, natural log, in
// the units of the soft-capped, scaled scores), from which the caller
// combines the shards' outputs: out = sum_i out_i e^(lse_i - M*) / sum_i
// e^(lse_i - M*), M* = max_i lse_i. k_offset 0 and no lse is the unsharded
// call; the splits, the tickets and the combine are unchanged.
//
// Why not the Pallas grid: there the S axis is the sequential innermost grid
// dimension, carrying the online softmax in scratch. At zamba2's decode shape
// (B 4, KH 32) that leaves B * KH = 128 independent walks of 2080 rows for
// 132 SMs, each walk one long chain of dependent loads.
//
// Bound on this card: about 4 FLOP per cache byte, so device-memory bytes
// bound it: 85 MB of bf16 cache at zamba2's shape, 0.025 ms at 3.35 TB/s.
// What reaches that rate is bytes kept in flight without pause (about 25 KB
// per SM at a microsecond of latency), so the design is split-KV in one
// launch, with every block streaming:
// * The cache of each (b, kh) is cut into n_splits splits of split_tiles
//   tiles of DA_CH = 64 rows; grid (n_splits, KH, B), one block of 128
//   threads per split, reading its rows once for all G query heads of its
//   kv head. The wrapper asks CUDA how many blocks an SM holds
//   (carla_decode_occupancy) and takes as many splits per (b, kh) as one
//   wave of them holds, so no small last wave trails: 4 splits of 9 tiles,
//   512 blocks at 4 per SM, at zamba2's shape. Splits past pos[b], and
//   with a window the splits wholly before its first key, exit before
//   reading; a split reads only the tiles from that key's to pos[b]'s.
// * A block walks its tiles through a two-stage shared-memory ring filled
//   by 16-byte cp.async copies: while one tile's K and V are computed on,
//   the next tile's are in flight. No row is held in registers. A row of
//   one kv head (160 bytes at DH 80) ends inside a 128-byte line whose
//   rest the block of the next kv head reads at about the same time, so
//   the copies ask the L2 for whole lines (cp_async16_line). Scores are
//   one (head, row) dot product a thread from shared memory, the online
//   softmax (running max, sum and rescale per head, fp32) is one warp per
//   head, and the V pass gives each thread fixed (head, 16-byte piece,
//   row group) units whose partial outputs stay in registers across tiles
//   and are summed over row groups in a fixed order at the end. Shared rows
//   are padded by 16 bytes, so threads reading neighbouring rows hit
//   distinct banks.
// * The splits are combined in the same launch: each block writes its
//   split's max, sum and unnormalised output to an fp32 workspace, and the
//   last block of each (b, kh) to finish (a ticket counter, atomicAdd after
//   __threadfence) combines all splits in split order, M = max m_i, out =
//   sum_i acc_i e^(m_i - M) / sum_i l_i e^(m_i - M), so the result does not
//   depend on which block finishes last, and resets its counter to 0 for
//   the next call. The counters belong to the caller, zeroed once. With a
//   few splits per (b, kh) the fence, the ticket and the combine are paid
//   a few times per sequence, not once per 64 rows.
//
// DH 256 (gemma2-9b, G = 2): the bf16 ring's two stages of 64-row K and V
// tiles take 135,168 bytes, 141,848 with the fp32 q, scores and partials,
// under the 227 KB opt-in. In fp32 two stages would take 266,240 bytes, more
// than an SM has, so that instance (the fp32 wiring checks) streams through
// a ring of one stage, 137,752 bytes at G = 2: a tile's copy then waits for
// the last tile's readers and is not overlapped with its compute.
#include "numeric.cuh"
#include "ptx.cuh"

namespace carla {

constexpr int DA_CH = 64;        // cache rows of a tile
constexpr int DA_THREADS = 128;
constexpr int DA_STAGES = 2;     // tiles of a block's ring, where two fit
constexpr int DA_SLOTS = 4;      // V-pass items a thread may own
constexpr float DA_NEG_INF = -2.3819763e38f;

struct DecodeShape {
  int B, S, H, KH, G, n_splits, split_tiles, window, k_offset;
  float scale, softcap;
};

// Workspace index of (b, kh, split, g).
__device__ __forceinline__ int64_t ws_index(const DecodeShape& s, int b,
                                            int kh, int split, int g) {
  return (((int64_t)b * s.KH + kh) * s.n_splits + split) * s.G + g;
}

// Shared memory: STAGES stages of K rows [DA_CH][LD] and V rows
// [DA_CH][LD] of T, then fp32 q [G][DH], scores / rounded p [G][DA_CH], the
// running max, sum and rescale factor [3][G], and the row groups' partial
// outputs [row group][G][DH].
template <typename T, int DH>
struct DecodeSmem {
  static constexpr int LD = DH + 16 / sizeof(T);  // a 16-byte pad per row
  static constexpr int PIECES = DH / Vec16<T>::N; // 16-byte pieces per row
  static constexpr int STAGE = 2 * DA_CH * LD;    // K then V, elements
  // DA_STAGES stages where their bytes leave room beside them (the largest
  // today, bf16 at DH 256, take 135,168), else one (fp32 at DH 256)
  static constexpr int STAGES =
      (size_t)DA_STAGES * STAGE * sizeof(T) <= 160 * 1024 ? DA_STAGES : 1;

  // The V pass's work: (head, 16-byte piece) items, the rows of a tile
  // split over this many groups of them; thread t owns units t + j *
  // DA_THREADS, j < DA_SLOTS, unit u being row group u / items of item
  // u % items.
  __host__ __device__ static int row_groups(int G) {
    const int items = G * PIECES;
    return items >= DA_THREADS ? 1 : DA_THREADS / items;
  }
  __host__ __device__ static size_t bytes(int G) {
    return (size_t)STAGES * STAGE * sizeof(T) +
           sizeof(float) * ((size_t)G * DH + (size_t)G * DA_CH + 3 * G +
                            (size_t)row_groups(G) * G * DH);
  }
};

template <typename T, int DH>
__global__ void __launch_bounds__(DA_THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ pos,
              T* __restrict__ out, float* __restrict__ lse,
              float* __restrict__ ws_m,
              float* __restrict__ ws_l, float* __restrict__ ws_acc,
              int* __restrict__ tickets, DecodeShape s) {
  using SM = DecodeSmem<T, DH>;
  constexpr int VEC = Vec16<T>::N, LD = SM::LD, PIECES = SM::PIECES;
  constexpr int STAGES = SM::STAGES;
  extern __shared__ __align__(16) unsigned char da_smem[];
  T* ring = reinterpret_cast<T*>(da_smem);
  float* qs = reinterpret_cast<float*>(ring + STAGES * SM::STAGE);
  float* ps = qs + s.G * DH;
  float* m_s = ps + s.G * DA_CH;
  float* l_s = m_s + s.G;
  float* alpha_s = l_s + s.G;
  float* part = alpha_s + s.G;
  __shared__ int last;

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int p = pos[b] - s.k_offset;   // pos as a row of this cache
  int kmax = min(p, s.S - 1);
  // the window's first visible key (0 without a window)
  int kmin = s.window > 0 ? max(0, p - s.window + 1) : 0;
  // no visible row: one split, no tile (kmax / split_rows is 0 at -1)
  if (kmin > kmax) kmin = 0, kmax = -1;
  const int split_rows = s.split_tiles * DA_CH;
  // splits that hold a key: [first_run, n_run); the others read nothing
  const int first_run = kmin / split_rows;
  const int n_run = max(1, kmax / split_rows + 1);
  if (split >= n_run || split < first_run) return;
  // from the tile that holds kmin on
  const int r_begin = max(split * split_rows, kmin - kmin % DA_CH);
  const int r_end = min(split * split_rows + split_rows, kmax + 1);
  const int n_tiles = max(0, r_end - r_begin + DA_CH - 1) / DA_CH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t row_stride = (int64_t)s.KH * DH;
  const int64_t base = (int64_t)b * s.S * row_stride + (int64_t)kh * DH;

  // tile `it` (rows r_begin + 64 it ..) into stage it % STAGES
  auto load_tile = [&](int it) {
    if (it >= n_tiles) return;
    const int r0 = r_begin + it * DA_CH;
    const int nrows = min(DA_CH, r_end - r0);
    T* ks = ring + (it % STAGES) * SM::STAGE;
    T* vs = ks + DA_CH * LD;
    for (int i = tid; i < nrows * PIECES; i += DA_THREADS) {
      const int r = i / PIECES, c = (i % PIECES) * VEC;
      const int64_t off = base + (int64_t)(r0 + r) * row_stride + c;
      cp_async16_line(ks + r * LD + c, k + off);
      cp_async16_line(vs + r * LD + c, v + off);
    }
  };
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) {
    load_tile(it);
    cp_async_commit();
  }
  for (int i = tid; i < s.G * DH; i += DA_THREADS)
    qs[i] = to_f32(q[((int64_t)b * s.H + kh * s.G) * DH + i]);
  for (int g = tid; g < s.G; g += DA_THREADS) {
    m_s[g] = DA_NEG_INF;
    l_s[g] = 0.f;
  }

  // the V pass's units of this thread, accumulated across tiles in
  // registers
  const int items = s.G * PIECES;
  const int groups = SM::row_groups(s.G);
  const int units = items * groups;
  float a[DA_SLOTS][VEC];
#pragma unroll
  for (int j = 0; j < DA_SLOTS; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) a[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if constexpr (STAGES == 1) {
      __syncthreads();  // tile it - 1 is consumed
      load_tile(it);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();  // tile it has landed for every thread
    } else {
      cp_async_wait<STAGES - 2>();  // tile it has landed
      __syncthreads();  // ... for every thread; tile it - 1 is consumed
      load_tile(it + STAGES - 1);
      cp_async_commit();
    }
    const T* ks = ring + (it % STAGES) * SM::STAGE;
    const T* vs = ks + DA_CH * LD;
    const int r0 = r_begin + it * DA_CH;
    const int nrows = min(DA_CH, r_end - r0);

    // scores: one (head, row) dot product a thread; rows before the
    // window's first key stay masked
    for (int i = tid; i < s.G * DA_CH; i += DA_THREADS) {
      const int r = i % DA_CH, g = i / DA_CH;
      float x = DA_NEG_INF;
      if (r < nrows && r0 + r >= kmin) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < PIECES; ++c) {
          float f[VEC];
          load16(ks + r * LD + c * VEC, f);
          const float4* qv =
              reinterpret_cast<const float4*>(qs + g * DH + c * VEC);
#pragma unroll
          for (int e4 = 0; e4 < VEC / 4; ++e4) {
            const float4 qq = qv[e4];
            dot = fmaf(f[4 * e4], qq.x, dot);
            dot = fmaf(f[4 * e4 + 1], qq.y, dot);
            dot = fmaf(f[4 * e4 + 2], qq.z, dot);
            dot = fmaf(f[4 * e4 + 3], qq.w, dot);
          }
        }
        x = dot * s.scale;
        if (s.softcap > 0.f) x = s.softcap * tanhf(x / s.softcap);
      }
      ps[g * DA_CH + r] = x;
    }
    __syncthreads();

    // the online softmax, one warp per head
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
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < DA_CH / 32; ++i) {
        const float p = expf(x[i] - m_new);
        sum += p;
        ps[g * DA_CH + lane + 32 * i] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // the unnormalised output, rescaled to the new max
#pragma unroll
    for (int j = 0; j < DA_SLOTS; ++j) {
      const int u = tid + j * DA_THREADS;
      if (u < units) {
        const int item = u % items, g = item / PIECES;
        const int d0 = (item % PIECES) * VEC;
        const float alpha = alpha_s[g];
#pragma unroll
        for (int e = 0; e < VEC; ++e) a[j][e] *= alpha;
        for (int r = u / items; r < nrows; r += groups) {
          float f[VEC];
          load16(vs + r * LD + d0, f);
          const float p = ps[g * DA_CH + r];
#pragma unroll
          for (int e = 0; e < VEC; ++e) a[j][e] = fmaf(p, f[e], a[j][e]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the split's partial: the row groups' sums added in a fixed order
  // (part[u * VEC + e] is part[row group][head][column])
#pragma unroll
  for (int j = 0; j < DA_SLOTS; ++j) {
    const int u = tid + j * DA_THREADS;
    if (u < units) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) part[u * VEC + e] = a[j][e];
    }
  }
  __syncthreads();
  float* acc_out = ws_acc + ws_index(s, b, kh, split, 0) * DH;
  for (int o = tid; o < s.G * DH; o += DA_THREADS) {
    float sum = 0.f;
    for (int r = 0; r < groups; ++r) sum += part[r * s.G * DH + o];
    acc_out[o] = sum;
  }
  for (int g = tid; g < s.G; g += DA_THREADS) {
    ws_m[ws_index(s, b, kh, split, g)] = m_s[g];
    ws_l[ws_index(s, b, kh, split, g)] = l_s[g];
  }

  // the last split of (b, kh) to finish combines them all, in order
  __threadfence();
  __syncthreads();
  int* ticket = tickets + (int64_t)b * s.KH + kh;
  if (tid == 0) last = atomicAdd(ticket, 1) == n_run - first_run - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int o = tid; o < s.G * DH; o += DA_THREADS) {
    const int g = o / DH;
    float M = DA_NEG_INF;
    for (int i = first_run; i < n_run; ++i)
      M = fmaxf(M, __ldcg(ws_m + ws_index(s, b, kh, i, g)));
    float L = 0.f, A = 0.f;
    for (int i = first_run; i < n_run; ++i) {
      const int64_t w = ws_index(s, b, kh, i, g);
      const float scale = expf(__ldcg(ws_m + w) - M);
      L += __ldcg(ws_l + w) * scale;
      A += __ldcg(ws_acc + ws_index(s, b, kh, i, 0) * DH + o) * scale;
    }
    out[((int64_t)b * s.H + kh * s.G) * DH + o] =
        from_f32<T>(A / fmaxf(L, 1e-30f));
    // log(0) is -inf: a cache with no visible row
    if (lse && o % DH == 0)
      lse[(int64_t)b * s.H + kh * s.G + g] = M + logf(L);
  }
  if (tid == 0) *ticket = 0;
}

// Launches the kernel; or, with blocks_per_sm given, launches nothing and
// writes there how many of its blocks an SM holds at once.
template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, const int* pos,
              void* out, float* lse, float* ws, int* tickets,
              const DecodeShape& s, cudaStream_t stream, int* blocks_per_sm) {
  const size_t bytes = DecodeSmem<T, DH>::bytes(s.G);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  if (blocks_per_sm)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, decode_kernel<T, DH>, DA_THREADS, bytes);
  const int64_t n_ws = (int64_t)s.B * s.KH * s.n_splits * s.G;
  decode_kernel<T, DH><<<dim3(s.n_splits, s.KH, s.B), DA_THREADS, bytes,
                         stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(out), lse, ws,
      ws + n_ws,
      ws + 2 * n_ws, tickets, s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* out, float* lse, float* ws, int* tickets,
           const DecodeShape& s, int dh, cudaStream_t stream,
           int* blocks_per_sm = nullptr) {
  switch (dh) {
    case 16: return launch_dh<T, 16>(q, k, v, pos, out, lse, ws, tickets, s,
                                     stream, blocks_per_sm);
    case 64: return launch_dh<T, 64>(q, k, v, pos, out, lse, ws, tickets, s,
                                     stream, blocks_per_sm);
    case 80: return launch_dh<T, 80>(q, k, v, pos, out, lse, ws, tickets, s,
                                     stream, blocks_per_sm);
    case 128: return launch_dh<T, 128>(q, k, v, pos, out, lse, ws, tickets,
                                       s, stream, blocks_per_sm);
    case 256: return launch_dh<T, 256>(q, k, v, pos, out, lse, ws, tickets,
                                       s, stream, blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace carla

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out, contiguous and 16-byte
// aligned). q and out are (B, H, DH); k and v are (B, S, KH, DH) with H a
// multiple of KH; pos is (B,) int32, >= 0. window <= 0 and softcap <= 0
// turn those off. k_offset >= 0 is the key of the cache's row 0 (a shard's
// first row; 0 unsharded). lse: nullptr, or (B, H) fp32 for each head's
// log-sum-exp (-inf where no row is visible). The cache is read in
// n_splits splits of split_tiles tiles of 64 rows, which must cover S with
// no split left empty. ws: fp32 workspace
// of B * KH * n_splits * H/KH * (2 + DH) values.
// tickets: B * KH int32 counters, all 0 before the call and 0 again after it
// (calls that share them must be ordered on one stream). Returns
// cudaGetLastError() (or the error of the shared-memory opt-in).
extern "C" int carla_decode_attention(int dtype, const void* q, const void* k,
                                      const void* v, const void* pos,
                                      void* out, void* lse, void* ws,
                                      void* tickets, int B, int S, int H,
                                      int KH, int DH, int n_splits,
                                      int split_tiles, int window,
                                      int k_offset, float scale,
                                      float softcap, void* stream) {
  if (B == 0 || H == 0) return 0;
  const int64_t split_rows = (int64_t)split_tiles * carla::DA_CH;
  if (S <= 0 || KH <= 0 || H % KH != 0 || n_splits <= 0 ||
      H / KH * DH > carla::DA_SLOTS * carla::DA_THREADS * 4 ||
      split_tiles <= 0 || n_splits * split_rows < S ||
      (n_splits - 1) * split_rows >= S || k_offset < 0)
    return (int)cudaErrorInvalidValue;
  const carla::DecodeShape s{B,      S,           H,      KH,       H / KH,
                             n_splits, split_tiles, window, k_offset, scale,
                             softcap};
  const int* p = static_cast<const int*>(pos);
  float* l = static_cast<float*>(lse);
  float* w = static_cast<float*>(ws);
  int* t = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return carla::launch<float>(q, k, v, p, out, l, w, t, s, DH, st);
  if (dtype == 1)
    return carla::launch<__nv_bfloat16>(q, k, v, p, out, l, w, t, s, DH, st);
  return (int)cudaErrorInvalidValue;
}

// How many blocks of the launch for H heads over KH kv heads of DH an SM
// holds at once, written to *blocks_per_sm (an int); the wrapper sizes the
// splits by it. Returns the CUDA error of the query.
extern "C" int carla_decode_occupancy(int dtype, int H, int KH, int DH,
                                      void* blocks_per_sm) {
  if (H <= 0 || KH <= 0 || H % KH != 0) return (int)cudaErrorInvalidValue;
  carla::DecodeShape s{};
  s.G = H / KH;
  int* n = static_cast<int*>(blocks_per_sm);
  if (dtype == 0)
    return carla::launch<float>(nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr, nullptr, nullptr, s, DH, nullptr, n);
  if (dtype == 1)
    return carla::launch<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr,
                                        nullptr, nullptr, nullptr, nullptr, s,
                                        DH, nullptr, n);
  return (int)cudaErrorInvalidValue;
}
