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
//
// Head dims above 256 (no config has one; the Pallas kernel takes any dh):
// decode_wide_kernel, dh a runtime argument up to DA_WIDE_MAX_DH, fp32 and
// bf16, with the same splits, workspace, tickets and combine as above and
// every option (a position per row, window, soft-cap, rings through pos,
// k_offset, the log-sum-exp). Bound by bytes as the narrow kernel is (at B
// 4, S 2048, 8 heads over 4 of dh 512: 67 MB of bf16 cache, 0.020 ms). As
// the narrow kernel, one block per (split, kv head, batch), grid
// (n_splits, KH, B), scores all G query heads of the group against each row
// it streams, so each byte of K and V is read once per kv head. A block
// holds GH heads, a template parameter (1, 2, 4 or DW_HEADS = 8: the
// fewest that cover the group; heads past the group's have zero q and are
// never written), so every loop over heads is straight-line code; a group
// of more than 8 heads (no config has one above dh 256) takes ceil(G / 8)
// blocks per (split, kv head), each reading the split's rows for its heads,
// and the tickets count them. The rows go through a ring of DW_SLOTS tiles
// in shared memory, as many rows a tile as DW_SMEM leaves room for (32 at
// dh 512 in bf16, 64 KB of K and V; 8 at dh 2048), filled by Hopper's bulk
// copies (cp.async.bulk, the Tensor Memory Accelerator): a lane of warp 0
// copies one K and one V row in one instruction each, and the tile's bytes
// complete a transaction barrier (mbarrier) that the block waits on (the
// rows marked evict-first in the L2: each is read once a step), so
// DW_SLOTS - 1 tiles (128 KB at dh 512) are in flight while one is computed
// and no thread spends registers or issue slots on the copy. Where dh is
// no multiple of 16 bytes (301) every thread copies elements instead,
// zero-filled to the next piece. Scores: a warp takes two rows at a time,
// its lanes the rows' 16-byte pieces, each piece read once from shared
// memory for all GH heads (q in shared memory as fp32), the sums reduced by
// shuffles. The online softmax is one warp per head, in shared memory. The
// V pass gives each thread one 16-byte piece (two in fp32 at dh above 1024)
// of a group of rows, read once for all heads, and keeps the GH partial
// outputs of that piece in registers across tiles; the row groups'
// partials are summed in a fixed order at the end. The last block of a
// (b, kh) combines the splits as the narrow kernel does, but takes each
// head's max and split weights once, in shared memory, instead of once per
// output column.
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
  __host__ __device__ static constexpr int row_groups(int G) {
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

constexpr int DA_WIDE_MAX_DH = 2048;  // the widest head dim it takes
constexpr int DW_THREADS = 256;       // threads of a wide block
constexpr int DW_WARPS = DW_THREADS / 32;
constexpr int DW_HEADS = 8;           // heads of the group a block holds
constexpr int DW_SLOTS = 3;           // tiles of the ring
constexpr int DW_SMEM = 220 * 1024;   // shared memory a block may take
constexpr int DW_MAX_ROWS = 32;       // rows of a tile (a lane each)

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The 32 lanes' x added in lane order (lane 0 first), on lane 0: a sum
// that does not depend on how the values were spread over the lanes.
__device__ __forceinline__ float warp_sum_ordered(float x) {
  float sum = 0.f;
  for (int i = 0; i < 32; ++i) sum += __shfl_sync(0xffffffffu, x, i);
  return sum;
}

// Hopper's bulk copies (the Tensor Memory Accelerator) and transaction
// barriers, for the wide kernel's ring: one instruction moves a whole row
// from device memory to shared memory and counts its bytes on an mbarrier
// in shared memory, so no thread holds the copy.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}
// Makes the barriers' initialisation visible to the bulk copies.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// The one arrival of a phase, which also expects `bytes` of copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// Waits until the phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// bytes (a multiple of 16, both ends 16-byte aligned) from src to dst,
// counted on bar. The cache is read once a step, so its lines are the L2's
// first to go (evict_first), not the lines other work left there.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// The wide kernel's layout for T, GH heads held (a power of 2, the
// group's heads or DW_HEADS), at head dim dh: rows of DP elements (dh
// rounded up to whole 16-byte pieces); shared memory: fp32 q [GH][DP]
// (zero rows past the group's heads), scores / rounded p [GH][R], max,
// sum and rescale [3][GH], then the ring [DW_SLOTS][K, V][R][DP] of T
// (after the walk, the row groups' partial outputs, fp32), its tiles of R
// rows as many as DW_SMEM leaves room for (a multiple of 8 where 8 fit, at
// most DW_MAX_ROWS).
template <typename T, int GH>
struct DecodeWide {
  static constexpr int VEC = Vec16<T>::N;
  // 16-byte pieces of a row a thread holds in the V pass: 1 (bf16), 2 (fp32)
  static constexpr int PSLOTS = DA_WIDE_MAX_DH / VEC / DW_THREADS;
  __host__ __device__ static constexpr int row_elems(int dh) {
    return (dh + VEC - 1) / VEC * VEC;
  }
  // bytes before the ring, rounded up to 16 for its 16-byte copies
  __host__ __device__ static constexpr int head_bytes(int dh) {
    return ((int)sizeof(float) * GH * (row_elems(dh) + DW_MAX_ROWS + 3) +
            15) / 16 * 16;
  }
  __host__ __device__ static constexpr int tile_rows(int dh) {
    const int r = (DW_SMEM - head_bytes(dh)) /
                  (DW_SLOTS * 2 * row_elems(dh) * (int)sizeof(T));
    return r >= DW_MAX_ROWS ? DW_MAX_ROWS : r >= 8 ? r / 8 * 8 : r;
  }
  // row groups of the V pass: threads over the row's pieces
  __host__ __device__ static constexpr int row_groups(int dh) {
    const int pieces = row_elems(dh) / VEC;
    return pieces >= DW_THREADS ? 1 : DW_THREADS / pieces;
  }
  __host__ __device__ static constexpr int ring_bytes(int dh) {
    const int ring =
        DW_SLOTS * 2 * tile_rows(dh) * row_elems(dh) * (int)sizeof(T);
    const int part =
        (int)sizeof(float) * row_groups(dh) * GH * row_elems(dh);
    return ring > part ? ring : part;
  }
  __host__ __device__ static constexpr size_t bytes(int dh) {
    return (size_t)head_bytes(dh) + ring_bytes(dh);
  }
};

// the softmax takes a tile's rows one a lane, all 32 lanes writing
static_assert(DW_MAX_ROWS == 32);
// the widest rows leave room for a tile of at least one row
static_assert(DecodeWide<float, DW_HEADS>::tile_rows(DA_WIDE_MAX_DH) >= 1);

template <typename T, int GH>
__global__ void __launch_bounds__(DW_THREADS, 1)
decode_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ pos,
                   T* __restrict__ out, float* __restrict__ lse,
                   float* __restrict__ ws_m, float* __restrict__ ws_l,
                   float* __restrict__ ws_acc, int* __restrict__ tickets,
                   DecodeShape s, int DH) {
  using W = DecodeWide<T, GH>;
  constexpr int VEC = W::VEC, PSLOTS = W::PSLOTS;
  const int DP = W::row_elems(DH), PIECES = DP / VEC, R = W::tile_rows(DH);
  const int n_chunks = ceil_div(s.G, GH);
  extern __shared__ __align__(16) unsigned char dw_smem[];
  float* qs = reinterpret_cast<float*>(dw_smem);
  float* ps = qs + GH * DP;
  float* m_s = ps + GH * DW_MAX_ROWS;
  float* l_s = m_s + GH;
  float* alpha_s = l_s + GH;
  T* ring = reinterpret_cast<T*>(dw_smem + W::head_bytes(DH));
  __shared__ int last;

  const int split = blockIdx.x, b = blockIdx.z;
  const int kh = blockIdx.y / n_chunks;
  const int g0 = (blockIdx.y - kh * n_chunks) * GH;   // the block's heads
  const int ng = min(GH, s.G - g0);
  const int p = pos[b] - s.k_offset;   // pos as a row of this cache
  int kmax = min(p, s.S - 1);
  int kmin = s.window > 0 ? max(0, p - s.window + 1) : 0;
  if (kmin > kmax) kmin = 0, kmax = -1;   // no visible row
  const int split_rows = s.split_tiles * DA_CH;
  const int first_run = kmin / split_rows;
  const int n_run = max(1, kmax / split_rows + 1);
  if (split >= n_run || split < first_run) return;
  // every row in [r_begin, r_end) is visible
  const int r_begin = max(split * split_rows, kmin);
  const int r_end = min(split * split_rows + split_rows, kmax + 1);
  const int n_tiles = ceil_div(max(0, r_end - r_begin), R);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t row_stride = (int64_t)s.KH * DH;
  const int64_t base = (int64_t)b * s.S * row_stride + (int64_t)kh * DH;
  const bool vec = DH % VEC == 0;

  // the ring's barriers: tile it has landed in slot it % DW_SLOTS when
  // phase it / DW_SLOTS of full[it % DW_SLOTS] completes
  __shared__ __align__(8) uint64_t full[DW_SLOTS];
  if (tid == 0) {
    for (int i = 0; i < DW_SLOTS; ++i) mbar_init(full + i);
    mbar_init_fence();
  }
  __syncthreads();

  // tile `it` (rows r_begin + R it ..) into slot it % DW_SLOTS: K rows,
  // then V rows, of DP elements. Rows of whole 16-byte pieces: warp 0's
  // lanes each copy a row of K and of V in one bulk copy; otherwise every
  // thread copies elements (zeros past dh), seen after the next barrier.
  auto load_tile = [&](int it) {
    if (it >= n_tiles) return;
    const int r0 = r_begin + it * R;
    const int nrows = min(R, r_end - r0);
    T* ks = ring + (it % DW_SLOTS) * 2 * R * DP;
    T* vs = ks + R * DP;
    if (vec) {
      if (warp != 0) return;
      uint64_t* bar = full + it % DW_SLOTS;
      const uint32_t row_bytes = DH * sizeof(T);
      if (lane == 0) mbar_expect(bar, 2 * nrows * row_bytes);
      __syncwarp();
      for (int r = lane; r < nrows; r += 32) {
        const int64_t off = base + (int64_t)(r0 + r) * row_stride;
        bulk_copy(ks + r * DP, k + off, row_bytes, bar);
        bulk_copy(vs + r * DP, v + off, row_bytes, bar);
      }
    } else {
      for (int i = tid; i < nrows * DP; i += DW_THREADS) {
        const int r = i / DP, c = i - r * DP;
        const int64_t off = base + (int64_t)(r0 + r) * row_stride + c;
        ks[i] = c < DH ? k[off] : from_f32<T>(0.f);
        vs[i] = c < DH ? v[off] : from_f32<T>(0.f);
      }
    }
  };
#pragma unroll
  for (int it = 0; it < DW_SLOTS - 1; ++it) load_tile(it);
  // q of the block's heads; heads past the group's are zeros, scored and
  // summed like the others but never written
  for (int i = tid; i < GH * DP; i += DW_THREADS) {
    const int g = i / DP, d = i - g * DP;
    qs[i] = g < ng && d < DH
                ? to_f32(q[((int64_t)b * s.H + kh * s.G + g0 + g) * DH + d])
                : 0.f;
  }
  if (tid < GH) {
    m_s[tid] = DA_NEG_INF;
    l_s[tid] = 0.f;
  }

  // the V pass's units of this thread: piece u % PIECES of row group
  // u / PIECES, its heads' partial outputs kept in registers across tiles
  const int groups = W::row_groups(DH);
  float a[PSLOTS][GH][VEC];
#pragma unroll
  for (int j = 0; j < PSLOTS; ++j)
#pragma unroll
    for (int g = 0; g < GH; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e) a[j][g][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (vec) mbar_wait(full + it % DW_SLOTS, (it / DW_SLOTS) & 1);
    __syncthreads();   // tile it has landed; tile it - 1 is consumed
    load_tile(it + DW_SLOTS - 1);   // into tile it - 1's slot
    const T* ks = ring + (it % DW_SLOTS) * 2 * R * DP;
    const T* vs = ks + R * DP;
    const int nrows = min(R, r_end - (r_begin + it * R));

    // scores: a warp takes rows r and r + DW_WARPS, its lanes their
    // pieces; each piece of K is read once for all GH heads
    for (int r = warp; r < nrows; r += 2 * DW_WARPS) {
      const int r2 = min(r + DW_WARPS, nrows - 1);   // r again past the tile
      float dot[2][GH];
#pragma unroll
      for (int g = 0; g < GH; ++g) dot[0][g] = dot[1][g] = 0.f;
      for (int c = lane; c < PIECES; c += 32) {
        float f[2][VEC];
        load16(ks + r * DP + c * VEC, f[0]);
        load16(ks + r2 * DP + c * VEC, f[1]);
#pragma unroll
        for (int g = 0; g < GH; ++g) {
#pragma unroll
          for (int e4 = 0; e4 < VEC; e4 += 4) {
            const float4 qq =
                *reinterpret_cast<const float4*>(qs + g * DP + c * VEC + e4);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              dot[i][g] = fmaf(f[i][e4], qq.x, dot[i][g]);
              dot[i][g] = fmaf(f[i][e4 + 1], qq.y, dot[i][g]);
              dot[i][g] = fmaf(f[i][e4 + 2], qq.z, dot[i][g]);
              dot[i][g] = fmaf(f[i][e4 + 3], qq.w, dot[i][g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GH; ++g) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float x = warp_sum(dot[i][g]) * s.scale;
          if (s.softcap > 0.f) x = s.softcap * tanhf(x / s.softcap);
          if (lane == 0) ps[g * DW_MAX_ROWS + (i ? r2 : r)] = x;
        }
      }
    }
    __syncthreads();

    // the online softmax, one warp per head (a lane per row)
    for (int g = warp; g < GH; g += DW_WARPS) {
      const float x = lane < nrows ? ps[g * DW_MAX_ROWS + lane] : DA_NEG_INF;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);   // the tile has a row: finite
      const float pr = lane < nrows ? expf(x - m_new) : 0.f;
      const float sum = warp_sum(pr);
      ps[g * DW_MAX_ROWS + lane] = round_to<T>(pr);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // the unnormalised outputs, rescaled to the new max; each row's piece
    // read once for all heads
#pragma unroll
    for (int j = 0; j < PSLOTS; ++j) {
      const int u = tid + j * DW_THREADS;
      if (u < PIECES * groups) {
        const int c = (u % PIECES) * VEC;
#pragma unroll
        for (int g = 0; g < GH; ++g) {
          const float alpha = alpha_s[g];
#pragma unroll
          for (int e = 0; e < VEC; ++e) a[j][g][e] *= alpha;
        }
        for (int r = u / PIECES; r < nrows; r += groups) {
          float f[VEC];
          load16(vs + r * DP + c, f);
#pragma unroll
          for (int g = 0; g < GH; ++g) {
            const float pg = ps[g * DW_MAX_ROWS + r];
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              a[j][g][e] = fmaf(pg, f[e], a[j][g][e]);
          }
        }
      }
    }
  }
  __syncthreads();   // the ring is free (every tile it copied was waited)

  // the split's partials: the row groups' sums added in a fixed order
  // (part[(row group * GH + head) * DP + column])
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < PSLOTS; ++j) {
    const int u = tid + j * DW_THREADS;
    if (u < PIECES * groups) {
      const int grp = u / PIECES, c = (u % PIECES) * VEC;
#pragma unroll
      for (int g = 0; g < GH; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          part[(grp * GH + g) * DP + c + e] = a[j][g][e];
    }
  }
  __syncthreads();
  for (int o = tid; o < ng * DH; o += DW_THREADS) {
    const int g = o / DH, d = o - g * DH;
    float sum = 0.f;
    for (int r = 0; r < groups; ++r) sum += part[(r * GH + g) * DP + d];
    ws_acc[ws_index(s, b, kh, split, g0 + g) * DH + d] = sum;
  }
  if (tid < ng) {
    ws_m[ws_index(s, b, kh, split, g0 + tid)] = m_s[tid];
    ws_l[ws_index(s, b, kh, split, g0 + tid)] = l_s[tid];
  }

  // the last of the (b, kh)'s blocks (splits x head chunks) combines all
  // G heads, splits in order: each head's max M and weights e^(m_i - M)
  // once, in the freed ring (launch_wide_gh checks that they fit), then
  // out = sum_i acc_i w_i / sum_i l_i w_i
  __threadfence();
  __syncthreads();
  int* ticket = tickets + (int64_t)b * s.KH + kh;
  if (tid == 0)
    last = atomicAdd(ticket, 1) == (n_run - first_run) * n_chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int n_sp = n_run - first_run;
  float* wts = part;               // [G][n_sp]
  float* den = wts + s.G * n_sp;   // [G]: sum_i l_i w_i
  for (int g = warp; g < s.G; g += DW_WARPS) {
    float M = DA_NEG_INF;
    for (int i = lane; i < n_sp; i += 32)
      M = fmaxf(M, __ldcg(ws_m + ws_index(s, b, kh, first_run + i, g)));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float L = 0.f;
    for (int i = lane; i < n_sp; i += 32) {
      const int64_t w = ws_index(s, b, kh, first_run + i, g);
      const float sc = expf(__ldcg(ws_m + w) - M);
      wts[g * n_sp + i] = sc;
      L += __ldcg(ws_l + w) * sc;
    }
    // the lanes' sums in a fixed order: lane 0 adds the 32 in lane order
    L = warp_sum_ordered(L);
    if (lane == 0) {
      den[g] = L;
      // log(0) is -inf: a cache with no visible row
      if (lse) lse[(int64_t)b * s.H + kh * s.G + g] = M + logf(L);
    }
  }
  __syncthreads();
  for (int o = tid; o < s.G * DH; o += DW_THREADS) {
    const int g = o / DH;
    const float* acc = ws_acc + ws_index(s, b, kh, first_run, 0) * DH + o;
    const int64_t step = (int64_t)s.G * DH;   // one split on
    float A = 0.f;
#pragma unroll 4
    for (int i = 0; i < n_sp; ++i)
      A += __ldcg(acc + i * step) * wts[g * n_sp + i];
    out[((int64_t)b * s.H + kh * s.G) * DH + o] =
        from_f32<T>(A / fmaxf(den[g], 1e-30f));
  }
  if (tid == 0) *ticket = 0;
}

// The wide kernel holding GH heads: launches it, or writes how many
// (b, kh, split) units an SM holds at once (its blocks per SM over the
// head chunks, at least 1: a unit is one block unless the group has more
// than DW_HEADS heads).
template <typename T, int GH>
int launch_wide_gh(const void* q, const void* k, const void* v,
                   const int* pos, void* out, float* lse, float* ws,
                   int* tickets, const DecodeShape& s, int dh,
                   cudaStream_t stream, int* blocks_per_sm) {
  const int n_chunks = ceil_div(s.G, GH);
  const size_t bytes = DecodeWide<T, GH>::bytes(dh);
  // the combine's weights and sums, (n_splits + 1) G floats, in the ring
  if (!blocks_per_sm && (size_t)(s.n_splits + 1) * s.G * sizeof(float) >
                            (size_t)DecodeWide<T, GH>::ring_bytes(dh))
    return (int)cudaErrorInvalidValue;
  auto kernel = decode_wide_kernel<T, GH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (blocks_per_sm) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                        DW_THREADS, bytes);
    *blocks_per_sm = max(1, n / n_chunks);
    return (int)err;
  }
  const int64_t n_ws = (int64_t)s.B * s.KH * s.n_splits * s.G;
  kernel<<<dim3(s.n_splits, s.KH * n_chunks, s.B), DW_THREADS, bytes,
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), pos, static_cast<T*>(out), lse,
                     ws, ws + n_ws, ws + 2 * n_ws, tickets, s, dh);
  return (int)cudaGetLastError();
}

// Head dims above 256: the instance holding the fewest heads (1, 2, 4 or
// DW_HEADS) that covers the group, or DW_HEADS a block.
template <typename T>
int launch_wide(const void* q, const void* k, const void* v, const int* pos,
                void* out, float* lse, float* ws, int* tickets,
                const DecodeShape& s, int dh, cudaStream_t stream,
                int* blocks_per_sm) {
  if (dh <= 256 || dh > DA_WIDE_MAX_DH) return (int)cudaErrorInvalidValue;
  if (s.G == 1)
    return launch_wide_gh<T, 1>(q, k, v, pos, out, lse, ws, tickets, s, dh,
                                stream, blocks_per_sm);
  if (s.G == 2)
    return launch_wide_gh<T, 2>(q, k, v, pos, out, lse, ws, tickets, s, dh,
                                stream, blocks_per_sm);
  if (s.G <= 4)
    return launch_wide_gh<T, 4>(q, k, v, pos, out, lse, ws, tickets, s, dh,
                                stream, blocks_per_sm);
  return launch_wide_gh<T, DW_HEADS>(q, k, v, pos, out, lse, ws, tickets, s,
                                     dh, stream, blocks_per_sm);
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
    default: return launch_wide<T>(q, k, v, pos, out, lse, ws, tickets, s,
                                   dh, stream, blocks_per_sm);
  }
}

}  // namespace carla

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out, contiguous and 16-byte
// aligned). q and out are (B, H, DH); k and v are (B, S, KH, DH) with H a
// multiple of KH; DH is 16, 64, 80, 128 or 256 (H / KH * DH at most 2048),
// or any DH in 257 .. DA_WIDE_MAX_DH (the wide kernel); pos is (B,) int32, >= 0. window <= 0 and softcap <= 0
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
      (DH <= 256 &&
       H / KH * DH > carla::DA_SLOTS * carla::DA_THREADS * 4) ||
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
// splits by it. For DH above 256, how many (b, kh, split) units of H / KH
// blocks each (at least 1). Returns the CUDA error of the query.
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
