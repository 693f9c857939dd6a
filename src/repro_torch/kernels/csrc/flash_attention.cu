// Fused causal flash attention (prefill) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:_flash_kernel, the Pallas
// TPU kernel for causal GQA attention over a whole prompt (zamba2's shared
// attention block in prefill, 9 applications per forward).
//
// What it computes, for q (B, T, H, DH), k and v (B, S, KH, DH), all
// contiguous, head h reading kv head h / (H / KH):
//   s[t, j] = (q[t] . k[j]) * scale, then softcap * tanh(s / softcap) when
//   softcap > 0; masked to NEG_INF unless j <= t, j < S and (window <= 0 or
//   j > t - window); out[t] = sum_j p[t, j] v[j] / l[t] with the online
//   softmax of the Pallas kernel: per KV tile m_new = max(m, max_j s),
//   p = exp(s - m_new), l = l * exp(m - m_new) + sum_j p (fp32, before
//   rounding), acc = acc * exp(m - m_new) + round_to_v_type(p) @ v, and
//   out = acc / max(l, 1e-30), stored once in q's type. Rounding p to v's
//   type before the product mirrors `p.astype(v.dtype)` in the Pallas kernel.
//
// Why not the Pallas grid: on the TPU the KV axis is the innermost grid
// dimension and acc/m/l live in scratch across its sequential steps. Blocks
// here run in parallel and in no order, so one block owns a query tile of
// one head and loops over the 64-key tiles itself, with m, l and the fp32
// accumulator in registers. KV tiles past the diagonal (and, with a window,
// before it) are never loaded. Ragged T and S are bounds checks (the Pallas
// wrapper asserts T % bq == 0); DH is a template parameter, instantiated for
// the head dims the configs use: 16 (the smoke configs), 64, 80 (zamba2's,
// not a power of two), 128 and 256 (gemma2's). Query tiles are handed out
// longest first (the causal work grows with the tile index), so the last
// wave is short.
//
// Bound on this card: 4 * DH FLOP per (query, key) pair over the causal
// half, 8.6e10 FLOP at zamba2's prefill shape (B 4, T 2048, H 32, DH 80),
// against 168 MB of bf16 q, k, v and out: about 500 FLOP per byte, so bound
// by operations, 0.087 ms at the bf16 tensor-core peak. Two instances:
//
// * bf16 (the serving path): flash_mma_kernel, FlashAttention-2's layout on
//   the tensor cores. A block owns 128 query rows of one head. Up to DH 80
//   it has 4 warps of 32 rows (two m16 tiles, so every K and V fragment read
//   from shared memory feeds two products); at DH 128 and 256, 8 warps of
//   16 rows (two tiles' accumulators would not fit in 255 registers). Q
//   stays in shared memory and its fragments are read by ldmatrix at each
//   k-step (held in registers they would spill). 64-key K and V tiles go
//   through a two-stage shared-memory ring filled by 16-byte cp.async copies
//   (zero-filled past S): one barrier per tile, after which the next tile's copy
//   goes into the stage the last tile used and is in flight while this tile
//   is computed. S = Q K^T and O += P V are mma.sync m16n8k16 bf16 products
//   accumulating in fp32, K and V fragments read by ldmatrix (V with
//   .trans). The online softmax runs on the fp32 accumulator in registers
//   (row max and sum across the 4 lanes of a quad; p = 2^(s c - m c) in one
//   multiply-add and one MUFU instruction), 16 keys at a time between the
//   P V products, so P is never held whole. The tile's work is compiled
//   twice, with and without the mask, and the soft-cap is a template
//   parameter, so the common tile is straight-line code: only tiles that
//   cross the diagonal, the window's edge or S evaluate the mask, and a warp
//   skips a tile none of its rows can see. p is rounded to bf16 in registers
//   and reused as the A fragment of the PV product (the m16n8 accumulator
//   layout is the m16k16 A layout). Shared rows are padded by 16 bytes
//   (DH + 8 elements), which makes ldmatrix free of bank conflicts at DH
//   80's 160-byte rows. The output goes through shared memory and leaves in
//   16-byte stores. Heads sharing a kv head are adjacent in the grid.
// * fp32 (exact fp32, the wiring checks): flash_kernel on the fp32 CUDA
//   cores, 64-row query tiles, 256 threads, each with a 4 x 4 micro-tile of
//   the 64 x 64 score tile and a 4 x DH/16 slice of the output tile; Q, K
//   (both transposed), V and the rounded P tile sit in shared memory as
//   fp32. The tensor cores' TF32 would not give fp32's result.
//
// Query offset (sequence-parallel prefill and training): with the tokens of a
// sequence sharded over a mesh axis, a shard holds query rows q_offset ..
// q_offset + T - 1 of the sequence against keys from 0, so row t of q is
// position q_offset + t. The mask, the first and last KV tiles a block
// walks and the skip of tiles past the diagonal all use that position; the
// loads and stores use t. The caller passes only the keys the shard can
// see (S = q_offset + T). Offset 0 is the unsharded call, at the cost of
// one add per position.
//
// DH 256 (gemma2-9b prefill: B 1, T 6144, H 16, KH 8, soft-cap 50, windows
// 4096 and 0): 4 * 256 FLOP per visible pair, 3.1e11 FLOP for a global
// layer against 151 MB of bf16 q, k, v and out, so bound by operations, 0.31
// ms at the bf16 peak. What bounds the two instances on this card is their
// footprint. The bf16 block (8 warps of 16 rows, MT = 1) keeps a 16 x 256
// fp32 output tile per warp in registers, 128 a thread before the 32 of a
// score tile, under the 255 that a block of 256 threads allows; its shared
// memory is the Q tile and two K/V stages at LD = 264, 202,752 bytes, one
// block per SM. The fp32 block needs 223,232 bytes (Q and K transposed, V
// and P), 9 KB under the 227 KB opt-in. launch_dh returns the opt-in's
// error if the card refuses it.
//
// Head dims above 256 (no config has one; the Pallas kernel takes any dh),
// dh a runtime argument up to FA_WIDE_MAX_DH. The work per (query, key) pair
// grows with dh as the narrow instances' does, so it is bound by operations
// as they are (at B 1, T 2048, 8 heads over 4 of dh 512: 3.4e10 FLOP against
// 8.4 MB, 0.035 ms at the bf16 peak). Two instances:
//
// * bf16: flash_wide_mma_kernel, the narrow bf16 kernel's mma.sync m16n8k16
//   products with the output's columns split over warps. An fp32 output
//   row of 512-2048 values does not fit one warp's registers, so a block's
//   CS x RG warps hold RG groups of 16 query rows, each group's output
//   split into CS column slices of at most FW_DC = 256 columns (128 fp32
//   accumulators a thread, as the dh 256 instance holds). The rows of a
//   block are consecutive (position, head of the group) rows of one kv
//   head, row r being position r / G of head kh G + r % G, so every K and V
//   tile serves all G heads; each row is masked by its own position. The
//   warps of a row group share its scores: each computes the partial
//   S = Q K^T over its own slice of dh (the Q slice read by ldmatrix from
//   the Q tile in shared memory) and stores it in shared memory, and after
//   one barrier each sums the CS partials in slice order, so every warp of
//   the group holds the same fp32 scores and runs the same online softmax.
//   Recomputing S in full in every warp would repeat Q K^T CS times (8 at
//   dh 2048) to save one exchange of 16 x KT floats a warp. P is rounded to
//   bf16 and held whole as the A fragments of each warp's P V over its
//   column slice. K and V tiles of KT keys go through a ring of NSLOT
//   shared-memory slots that alternate K and V (K of tile i, V of tile i, K
//   of tile i + 1, ...), filled by 16-byte cp.async copies where dh is a
//   multiple of 8 (element by element, zero-filled, otherwise): a slot's
//   copy is issued NSLOT - 1 half-tiles ahead, so the K of tile i + 1 is in
//   flight while tile i's P V runs, and with 4 slots the whole of tile i + 1.
//   Q and K columns past dh are zero up to the next multiple of 16, so an
//   odd dh (301) stays exact. Rows are padded by 16 bytes (LD = dh rounded
//   up to 16, plus 8): ldmatrix is free of bank conflicts at any dh. Per
//   instance (dh ceiling 512, 1024, 2048): 64, 32 and 16 query rows a block,
//   16 keys a tile, 2, 4 and 2 slots, 108,032, 206,336 and 205,568 bytes of
//   shared memory at the ceiling, and 240-250 registers a thread with no
//   spill (32 keys a tile spill at 512): one block of 256 threads an SM at
//   every ceiling, its registers alone 61,440-64,000 of the SM's 65,536.
//   A tile a row group cannot see is skipped by that group (its barriers
//   still kept); the mask is evaluated only on tiles that cross one of the
//   group's rows' diagonal, window edge or S.
// * fp32 (exact fp32, the wiring checks): flash_wide_kernel on the CUDA
//   cores. One warp owns one query row: a block of FA_WIDE_WARPS warps
//   takes FA_WIDE_WARPS consecutive (position, head) rows of one kv head. A
//   lane holds dims lane + 32 i (i < NJ; NJ 16, 32 and 64 take dh up to
//   512, 1024 and 2048) of the row's q and of its output; the lanes'
//   partial products of a tile's keys are summed across the warp by halving
//   exchanges. K and V go through shared memory in tiles of FlashWide::KT
//   keys (32, 16 or 8), one tile at a time.
// Past dh 2048 a warp's output slice would pass 256 columns (bf16) and a
// lane's q and output 64 registers each (fp32): the entry point refuses it.
#include "numeric.cuh"
#include "ptx.cuh"

#include <type_traits>

namespace carla {

constexpr int FA_BQ = 64, FA_BK = 64, FA_THREADS = 256;  // fp32 kernel
constexpr int FA_MMA_BQ = 128;   // bf16 kernel: query rows of a block
constexpr int FA_MMA_BK = 64;    // ... and keys of a K/V tile
constexpr int FA_STAGES = 2;     // K/V tiles in the bf16 kernel's ring
constexpr float FA_NEG_INF = -2.3819763e38f;
constexpr float FA_LOG2E = 1.4426950408889634f;

struct FlashShape {
  int B, T, S, H, KH, window, q_offset;
  float scale, softcap;
};

// Shared-memory layout (fp32): Qs[d][row], Ks[d][key], Vs[key][d], Ps[key][row].
template <int DH>
struct FlashSmem {
  static constexpr int LDQ = FA_BQ + 4;  // rows + pad: 16-byte aligned rows
  static constexpr int LDK = FA_BK + 4;
  static constexpr int LDV = DH + 4;     // conflict-free 16-byte stores
  static constexpr int Q = 0, K = Q + DH * LDQ, V = K + DH * LDK,
                       P = V + FA_BK * LDV, FLOATS = P + FA_BK * LDQ;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <typename T, int DH>
__global__ void __launch_bounds__(FA_THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, FlashShape s) {
  using SM = FlashSmem<DH>;
  constexpr int VEC = Vec16<T>::N;   // elements per 16-byte load
  constexpr int CHUNKS = DH / VEC;   // 16-byte chunks per row
  constexpr int DJ = DH / 16;        // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem + SM::Q;
  float* Ks = smem + SM::K;
  float* Vs = smem + SM::V;
  float* Ps = smem + SM::P;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_BQ;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (s.H / s.KH);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  // Q tile, transposed. Neighbouring threads take neighbouring rows, so the
  // transposed stores hit neighbouring banks.
  for (int i = tid; i < FA_BQ * CHUNKS; i += FA_THREADS) {
    const int r = i % FA_BQ, d0 = (i / FA_BQ) * VEC;
    const int t = q0 + r;
    float f[VEC];
    if (t < s.T) {
      load16(q + (((int64_t)b * s.T + t) * s.H + h) * DH + d0, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) Qs[(d0 + e) * SM::LDQ + r] = f[e];
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // positions of the tile's rows in the sequence
  const int q_last = s.q_offset + min(q0 + FA_BQ, s.T) - 1;
  const int k_last = min(q_last, s.S - 1);
  const int k_first =
      s.window > 0 ? max(0, s.q_offset + q0 - s.window + 1) : 0;
  for (int k0 = (k_first / FA_BK) * FA_BK; k0 <= k_last; k0 += FA_BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < FA_BK * CHUNKS; i += FA_THREADS) {
      const int c = i % FA_BK, d0 = (i / FA_BK) * VEC;
      const int j = k0 + c;
      float fk[VEC], fv[VEC];
      if (j < s.S) {
        const int64_t off = (((int64_t)b * s.S + j) * s.KH + kh) * DH + d0;
        load16(k + off, fk);
        load16(v + off, fv);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) fk[e] = fv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) Ks[(d0 + e) * SM::LDK + c] = fk[e];
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(Vs + c * SM::LDV + d0 + e) =
            make_float4(fv[e], fv[e + 1], fv[e + 2], fv[e + 3]);
    }
    __syncthreads();

    // scores of rows ty*4 + i, keys tx*4 + j
    float sc[4][4] = {};
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qs + d * SM::LDQ +
                                                        ty * 4);
      const float4 bb = *reinterpret_cast<const float4*>(Ks + d * SM::LDK +
                                                         tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], bv[j], sc[i][j]);
    }

    // online softmax; a row's 64 keys live on the 16 lanes of one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = s.q_offset + q0 + ty * 4 + i;
      float mt = FA_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        float x = sc[i][j] * s.scale;
        if (s.softcap > 0.f) x = s.softcap * tanhf(x / s.softcap);
        const bool ok = key <= t && key < s.S &&
                        (s.window <= 0 || key > t - s.window);
        sc[i][j] = ok ? x : FA_NEG_INF;
        mt = fmaxf(mt, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        Ps[(tx * 4 + j) * SM::LDQ + ty * 4 + i] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V: rows ty*4 + i, columns tx + 16*j
#pragma unroll 4
    for (int c = 0; c < FA_BK; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(Ps + c * SM::LDQ +
                                                         ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * SM::LDV + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= s.T) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + (((int64_t)b * s.T + t) * s.H + h) * DH;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[tx + 16 * j] = from_f32<T>(acc[i][j] / den);
  }
}

// The bf16 kernel's shape for one head dim: each warp owns MT m16 tiles
// (16 MT query rows), so every K and V fragment read from shared memory
// feeds MT products. MT = 2 up to DH 80 (4 warps); at DH 128 and 256 the
// output accumulators of two tiles would not fit in 255 registers, so MT = 1
// (8 warps).
//
// Shared memory (bf16 elements): the Q tile [FA_MMA_BQ][LD], then
// FA_STAGES stages of a K tile [FA_MMA_BK][LD] and a V tile
// [FA_MMA_BK][LD]. Rows are padded to LD = DH + 8 elements: 16-byte aligned
// rows whose ldmatrix phases (8 rows of 16 bytes) hit 32 distinct banks.
template <int DH>
struct FlashMma {
  static constexpr int MT = DH <= 80 ? 2 : 1;
  static constexpr int WARPS = FA_MMA_BQ / (16 * MT);
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LD = DH + 8;
  static constexpr int KV = FA_MMA_BQ * LD;       // first stage
  static constexpr int STAGE = 2 * FA_MMA_BK * LD;    // K then V
  static constexpr size_t SMEM_BYTES =
      (size_t)(KV + FA_STAGES * STAGE) * sizeof(__nv_bfloat16);
};

template <int DH, bool SOFTCAP>
__global__ void __launch_bounds__(FlashMma<DH>::THREADS)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, FlashShape s) {
  using F = FlashMma<DH>;
  constexpr int MT = F::MT, THREADS = F::THREADS, LD = F::LD;
  constexpr int PIECES = DH / 8;  // 16-byte pieces of a row
  constexpr int KSTEPS = DH / 16; // k-steps of Q K^T
  constexpr int NT = FA_MMA_BK / 8;   // n-tiles of 8 keys in a score tile
  constexpr int DT = DH / 8;      // n-tiles of 8 output columns
  extern __shared__ __align__(16) __nv_bfloat16 mma_smem[];
  __nv_bfloat16* Qs = mma_smem;

  // heads of one kv head adjacent; query tiles longest first
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * FA_MMA_BQ;
  const int kh = h / (s.H / s.KH);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t q_row = (int64_t)s.H * DH, kv_row = (int64_t)s.KH * DH;

  for (int i = tid; i < FA_MMA_BQ * PIECES; i += THREADS) {
    const int r = i / PIECES, c = (i % PIECES) * 8;
    const bool ok = q0 + r < s.T;
    cp_async16(Qs + r * LD + c,
               q + ((int64_t)b * s.T + (ok ? q0 + r : 0)) * q_row +
                   (int64_t)h * DH + c,
               ok);
  }

  // positions of the block's rows in the sequence
  const int q_last = s.q_offset + min(q0 + FA_MMA_BQ, s.T) - 1;
  const int k_last = min(q_last, s.S - 1);
  const int k_first =
      s.window > 0 ? max(0, s.q_offset + q0 - s.window + 1) : 0;
  const int tile0 = k_first / FA_MMA_BK;
  const int n_tiles = k_last < 0 ? 0 : max(0, k_last / FA_MMA_BK - tile0 + 1);

  // K and V tile `it` into stage it % FA_STAGES; rows past S read as zeros
  auto load_kv = [&](int it) {
    if (it >= n_tiles) return;
    const int k0 = (tile0 + it) * FA_MMA_BK;
    __nv_bfloat16* Ks = mma_smem + F::KV + (it % FA_STAGES) * F::STAGE;
    __nv_bfloat16* Vs = Ks + FA_MMA_BK * LD;
    for (int i = tid; i < FA_MMA_BK * PIECES; i += THREADS) {
      const int r = i / PIECES, c = (i % PIECES) * 8;
      const bool ok = k0 + r < s.S;
      const int64_t off =
          ((int64_t)b * s.S + (ok ? k0 + r : 0)) * kv_row + (int64_t)kh * DH +
          c;
      cp_async16(Ks + r * LD + c, k + off, ok);
      cp_async16(Vs + r * LD + c, v + off, ok);
    }
  };
  // one commit group per tile; the first also carries the Q tile
#pragma unroll
  for (int it = 0; it < FA_STAGES - 1; ++it) {
    load_kv(it);
    cp_async_commit();
  }

  // The warp's rows are w0 .. w0 + 16 MT - 1; this thread holds rows
  // w0 + 16 mt + lane / 4 (elements 0, 1 of an accumulator n-tile) and
  // that + 8 (elements 2, 3), at columns col, col + 1 of each n-tile.
  const int w0 = q0 + warp * 16 * MT;
  const int a0 = s.q_offset + w0;   // the position of row w0
  const int col = 2 * (lane % 4);
  // p = 2^(s c - m c): c folds the scale (without a soft-cap) and log2(e)
  // into one multiply-add; m is kept in the units of s
  const float c = SOFTCAP ? FA_LOG2E : s.scale * FA_LOG2E;
  float o[MT][DT][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int d = 0; d < DT; ++d)
      o[mt][d][0] = o[mt][d][1] = o[mt][d][2] = o[mt][d][3] = 0.f;
    m[mt][0] = m[mt][1] = FA_NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<FA_STAGES - 2>();  // tile it (at it 0, and Q) has landed
    __syncthreads();  // ... for every thread; and tile it - 1 is consumed
    load_kv(it + FA_STAGES - 1);     // into the stage tile it - 1 used
    cp_async_commit();
    const int k0 = (tile0 + it) * FA_MMA_BK;
    const __nv_bfloat16* Ks = mma_smem + F::KV + (it % FA_STAGES) * F::STAGE;
    const __nv_bfloat16* Vs = Ks + FA_MMA_BK * LD;
    // a tile none of the warp's rows can see: all past the diagonal, or
    // all before the window
    const int w_last = a0 + 16 * MT - 1;
    if (k0 > w_last || (s.window > 0 && k0 + FA_MMA_BK - 1 <= a0 - s.window))
      continue;

    // The tile's work, compiled twice: with the mask, for tiles that cross
    // the diagonal, the window's edge or S, and without it for the rest.
    auto tile = [&](auto masked) {
      // S = Q K^T; a B fragment pair covers keys 16 np .. 16 np + 15
      float sc[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n)
          sc[mt][n][0] = sc[mt][n][1] = sc[mt][n][2] = sc[mt][n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t qa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(qa[mt], smem_addr(Qs + (w0 - q0 + mt * 16 + lane % 16) *
                                        LD + kk * 16 + (lane / 16) * 8));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kf[4];
          ldmatrix_x4(kf, smem_addr(Ks + (np * 16 + (lane / 16) * 8 +
                                           lane % 8) * LD +
                                    kk * 16 + ((lane / 8) % 2) * 8));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16_16816(sc[mt][2 * np], qa[mt], kf[0], kf[1]);
            mma_bf16_16816(sc[mt][2 * np + 1], qa[mt], kf[2], kf[3]);
          }
        }
      }
      if constexpr (SOFTCAP) {
        const float k_in = s.scale / s.softcap;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[mt][n][e] = s.softcap * tanhf(sc[mt][n][e] * k_in);
      }
      if constexpr (decltype(masked)::value) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int t0 = a0 + mt * 16 + lane / 4;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + n * 8 + col + (e & 1);
              const int t = t0 + (e >> 1) * 8;
              const bool ok = key <= t && key < s.S &&
                              (s.window <= 0 || key > t - s.window);
              if (!ok) sc[mt][n][e] = FA_NEG_INF;
            }
          }
        }
      }
      // online softmax; row r of an m-tile is in elements 2r, 2r + 1 of each
      // n-tile, spread over the 4 lanes of a quad. First the new row max,
      // and the old sums and outputs rescaled to it.
      float mc[MT][2], rs[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = fmaxf(sc[mt][0][2 * r], sc[mt][0][2 * r + 1]);
#pragma unroll
          for (int n = 1; n < NT; ++n)
            mx = fmaxf(mx, fmaxf(sc[mt][n][2 * r], sc[mt][n][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[mt][r], mx);
          const float alpha = ex2_approx((m[mt][r] - m_new) * c);
          m[mt][r] = m_new;
          // a row that sees no key yet gets p = 0 (fmaf(NEG_INF, c, -m c)
          // would leave the rounding error of m c, not 0)
          mc[mt][r] = m_new == FA_NEG_INF ? 0.f : m_new * c;
          l[mt][r] *= alpha;
          rs[mt][r] = 0.f;
#pragma unroll
          for (int d = 0; d < DT; ++d) {
            o[mt][d][2 * r] *= alpha;
            o[mt][d][2 * r + 1] *= alpha;
          }
        }
      }
      // Then, 16 keys at a time, p (fp32 into the row sums; rounded to bf16
      // as the A fragment) and O += P V, a transposed B fragment pair of V
      // covering columns 16 dp .. 16 dp + 15.
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t pf[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float* x = sc[mt][2 * j + h2];
            const float p0 = ex2_approx(fmaf(x[0], c, -mc[mt][0]));
            const float p1 = ex2_approx(fmaf(x[1], c, -mc[mt][0]));
            const float p2 = ex2_approx(fmaf(x[2], c, -mc[mt][1]));
            const float p3 = ex2_approx(fmaf(x[3], c, -mc[mt][1]));
            rs[mt][0] += p0 + p1;
            rs[mt][1] += p2 + p3;
            pf[mt][2 * h2] = pack_bf16(p0, p1);
            pf[mt][2 * h2 + 1] = pack_bf16(p2, p3);
          }
        }
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, smem_addr(Vs + (j * 16 + ((lane / 8) % 2) * 8 +
                                                lane % 8) * LD +
                                          dp * 16 + (lane / 16) * 8));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16_16816(o[mt][2 * dp], pf[mt], vf[0], vf[1]);
            mma_bf16_16816(o[mt][2 * dp + 1], pf[mt], vf[2], vf[3]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float sum = rs[mt][r];
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          l[mt][r] += sum;
        }
    };
    if (k0 + FA_MMA_BK - 1 > a0 || k0 + FA_MMA_BK > s.S ||
        (s.window > 0 && k0 <= w_last - s.window))
      tile(std::true_type{});
    else
      tile(std::false_type{});
  }
  cp_async_wait<0>();
  __syncthreads();

  // out = acc / max(l, 1e-30): the warp's rows through its own rows of the
  // Q tile, then 16-byte stores
  __nv_bfloat16* Os = Qs + (w0 - q0) * LD;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float den0 = fmaxf(l[mt][0], 1e-30f);
    const float den1 = fmaxf(l[mt][1], 1e-30f);
    const int r = mt * 16 + lane / 4;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<uint32_t*>(Os + r * LD + d * 8 + col) =
          pack_bf16(o[mt][d][0] / den0, o[mt][d][1] / den0);
      *reinterpret_cast<uint32_t*>(Os + (r + 8) * LD + d * 8 + col) =
          pack_bf16(o[mt][d][2] / den1, o[mt][d][3] / den1);
    }
  }
  __syncwarp();
  for (int i = lane; i < 16 * MT * PIECES; i += 32) {
    const int r = i / PIECES, c8 = (i % PIECES) * 8;
    if (w0 + r < s.T)
      *reinterpret_cast<uint4*>(out + ((int64_t)b * s.T + w0 + r) * q_row +
                                (int64_t)h * DH + c8) =
          *reinterpret_cast<const uint4*>(Os + r * LD + c8);
  }
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, void* out,
              const FlashShape& s, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr size_t bytes = FlashMma<DH>::SMEM_BYTES;
    auto kernel = s.softcap > 0.f ? flash_mma_kernel<DH, true>
                                  : flash_mma_kernel<DH, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(s.H, s.B, ceil_div(s.T, FA_MMA_BQ));
    kernel<<<grid, FlashMma<DH>::THREADS, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), s);
  } else {
    constexpr size_t bytes = FlashSmem<DH>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(ceil_div(s.T, FA_BQ), s.H, s.B);
    flash_kernel<T, DH><<<grid, FA_THREADS, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), s);
  }
  return (int)cudaGetLastError();
}

constexpr int FA_WIDE_WARPS = 8;       // fp32: query rows of a block
constexpr int FA_WIDE_MAX_DH = 2048;   // the widest head dim it takes

// The fp32 wide instance for dims-per-lane NJ: KT keys a tile, the largest
// of 32, 16 and 8 whose K and V tiles of KT x 32 NJ floats fit 160 KB.
template <int NJ>
struct FlashWide {
  static constexpr int ROW = 32 * NJ;   // the widest dh of the instance
  static constexpr int KT =
      2 * 32 * ROW * sizeof(float) <= 160 * 1024   ? 32
      : 2 * 16 * ROW * sizeof(float) <= 160 * 1024 ? 16
                                                    : 8;
};

template <int NJ>
__global__ void __launch_bounds__(32 * FA_WIDE_WARPS, 1)
flash_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  FlashShape s, int DH) {
  constexpr int KT = FlashWide<NJ>::KT;
  constexpr int DUP = 32 / KT;           // lanes that end with one key's score
  constexpr int VEC = Vec16<float>::N;
  constexpr int THREADS = 32 * FA_WIDE_WARPS;
  extern __shared__ __align__(16) unsigned char fw_smem[];
  float* Ks = reinterpret_cast<float*>(fw_smem);   // [KT][DH]
  float* Vs = Ks + KT * DH;                        // [KT][DH]

  const int G = s.H / s.KH;
  const int kh = blockIdx.y, b = blockIdx.z;
  // rows (position, head of the group), longest first
  const int row0 = (gridDim.x - 1 - blockIdx.x) * FA_WIDE_WARPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = row0 + warp;
  const int t = row / G, h = kh * G + row % G;
  const bool live = t < s.T;
  const int apos = s.q_offset + t;   // the row's position in the sequence

  // the keys the block's rows can see
  const int t_lo = row0 / G;
  const int t_hi = min(s.T - 1, (row0 + FA_WIDE_WARPS - 1) / G);
  const int k_last = min(s.q_offset + t_hi, s.S - 1);
  const int k_first =
      s.window > 0 ? max(0, s.q_offset + t_lo - s.window + 1) : 0;

  float qr[NJ], acc[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    const int d = lane + 32 * i;
    qr[i] = live && d < DH ? q[(((int64_t)b * s.T + t) * s.H + h) * DH + d]
                           : 0.f;
    acc[i] = 0.f;
  }
  float m = FA_NEG_INF, l = 0.f;

  const int64_t kv_row = (int64_t)s.KH * DH;
  const float* kb = k + (int64_t)b * s.S * kv_row + (int64_t)kh * DH;
  const float* vb = v + (int64_t)b * s.S * kv_row + (int64_t)kh * DH;
  const int pieces = DH / VEC;   // 16-byte pieces of a row, if DH allows
  for (int k0 = (k_first / KT) * KT; k0 <= k_last; k0 += KT) {
    __syncthreads();  // the previous tile's readers are done
    if (DH % VEC == 0) {
      // 16-byte copies, zeros past S
      for (int e = threadIdx.x; e < KT * pieces; e += THREADS) {
        const int j = e / pieces, c = (e - j * pieces) * VEC;
        const bool ok = k0 + j < s.S;
        const int64_t off = (int64_t)(ok ? k0 + j : 0) * kv_row + c;
        cp_async16(Ks + j * DH + c, kb + off, ok);
        cp_async16(Vs + j * DH + c, vb + off, ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      for (int e = threadIdx.x; e < KT * DH; e += THREADS) {
        const int j = e / DH, d = e - j * DH;
        const bool ok = k0 + j < s.S;
        const int64_t off = (int64_t)(k0 + j) * kv_row + d;
        Ks[e] = ok ? kb[off] : 0.f;
        Vs[e] = ok ? vb[off] : 0.f;
      }
    }
    __syncthreads();
    // a tile the row cannot see: all past it, or all before its window
    if (!live || k0 > apos ||
        (s.window > 0 && k0 + KT - 1 <= apos - s.window))
      continue;

    // the lane's partial products for each key of the tile ...
    float sc[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const int d = lane + 32 * i;
        if (d < DH) dot = fmaf(qr[i], Ks[j * DH + d], dot);
      }
      sc[j] = dot;
    }
    // ... summed across the warp so that lane l holds the score of key
    // l / DUP: each step sends half of the lane's sums to its partner and
    // adds the other half of the partner's (KT - 1 shuffles in all), then
    // the DUP lanes of a key add theirs
#pragma unroll
    for (int n = KT, mask = 16; n > 1; n >>= 1, mask >>= 1) {
      const bool upper = lane & mask;
#pragma unroll
      for (int i = 0; i < n / 2; ++i) {
        const float send = upper ? sc[i] : sc[i + n / 2];
        const float keep = upper ? sc[i + n / 2] : sc[i];
        sc[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
      }
    }
    float x = sc[0];
#pragma unroll
    for (int mask = DUP / 2; mask > 0; mask >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, mask);
    x *= s.scale;
    if (s.softcap > 0.f) x = s.softcap * tanhf(x / s.softcap);
    const int key = k0 + lane / DUP;
    const bool seen = key <= apos && key < s.S &&
                      (s.window <= 0 || key > apos - s.window);
    x = seen ? x : FA_NEG_INF;
    float mx = x;
#pragma unroll
    for (int mask = 16; mask > 0; mask >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, mask));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    // a masked key weighs 0, also while the row has seen none
    const float p = seen ? expf(x - m_new) : 0.f;
    // the tile's sum over its KT keys (the DUP copies of a key left out)
    float rs = p;
#pragma unroll
    for (int mask = 16; mask >= DUP; mask >>= 1)
      rs += __shfl_xor_sync(0xffffffffu, rs, mask);
#pragma unroll
    for (int i = 0; i < NJ; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j * DUP);
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const int d = lane + 32 * i;
        if (d < DH) acc[i] = fmaf(pj, Vs[j * DH + d], acc[i]);
      }
    }
    l = l * alpha + rs;
    m = m_new;
  }
  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
  float* o = out + (((int64_t)b * s.T + t) * s.H + h) * DH;
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    const int d = lane + 32 * i;
    if (d < DH) o[d] = acc[i] / den;
  }
}

template <int NJ>
int launch_wide_nj(const void* q, const void* k, const void* v, void* out,
                   const FlashShape& s, int dh, cudaStream_t stream) {
  const size_t bytes = (size_t)2 * FlashWide<NJ>::KT * dh * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_wide_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ceil_div(s.T * (s.H / s.KH), FA_WIDE_WARPS), s.KH, s.B);
  flash_wide_kernel<NJ><<<grid, 32 * FA_WIDE_WARPS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s, dh);
  return (int)cudaGetLastError();
}

constexpr int FW_DC = 256;   // bf16: most output columns of a warp

// The bf16 wide instance: CS column slices of at most FW_DC columns x RG
// groups of 16 query rows (CS x RG warps), KT keys a tile, NSLOT slots in
// the K/V ring. Shared
// memory: the partial scores [RG][CS][KT / 8 n-tiles][32 lanes] of float4,
// then the Q tile [16 RG][LD] and the ring [NSLOT][KT][LD] of bf16.
template <int CS, int RG, int KT, int NSLOT>
struct FlashWideMma {
  static constexpr int MAX_DH = CS * FW_DC;   // the instance's ceiling
  static constexpr int THREADS = 32 * CS * RG;
  static constexpr int BQ = 16 * RG;          // query rows of a block
  static constexpr int SP_FLOATS = RG * CS * KT * 16;
  // the row pitch of Q, K and V in elements at head dim dh
  __host__ __device__ static int pitch(int dh) {
    return ((dh + 15) & ~15) + 8;
  }
  __host__ __device__ static size_t smem_bytes(int dh) {
    return (size_t)(BQ + NSLOT * KT) * pitch(dh) * sizeof(__nv_bfloat16) +
           SP_FLOATS * sizeof(float);
  }
};

template <int CS, int RG, int KT, int NSLOT>
__global__ void __launch_bounds__(32 * CS * RG, 1)
flash_wide_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, FlashShape s, int DH) {
  using F = FlashWideMma<CS, RG, KT, NSLOT>;
  constexpr int THREADS = F::THREADS, BQ = F::BQ;
  constexpr int NT = KT / 8;       // n-tiles of 8 keys in a score tile
  constexpr int DT = FW_DC / 8;    // n-tiles of 8 columns a warp may hold
  extern __shared__ __align__(16) unsigned char fwm_smem[];
  float4* Sp = reinterpret_cast<float4*>(fwm_smem);
  __nv_bfloat16* Qs =
      reinterpret_cast<__nv_bfloat16*>(fwm_smem + F::SP_FLOATS * 4);
  const int DHP = (DH + 15) & ~15;   // dh in whole k-steps of 16
  const int LD = F::pitch(DH);
  __nv_bfloat16* ring = Qs + BQ * LD;

  // blocks of one row tile adjacent; row tiles longest first
  const int G = s.H / s.KH;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int n_rows = s.T * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = warp / CS, cs = warp % CS;
  const bool vec = DH % 8 == 0;    // rows of whole 16-byte pieces
  const int64_t kv_row = (int64_t)s.KH * DH;

  // q's element (block row r, column c); r = t G + g is head kh G + g at t
  auto q_at = [&](int r, int c) {
    const int R = row0 + r, t = R / G;
    return q + (((int64_t)b * s.T + t) * s.H + kh * G + R - t * G) * DH + c;
  };
  if (vec) {
    for (int i = tid; i < BQ * (DHP / 8); i += THREADS) {
      const int r = i / (DHP / 8), c = (i - r * (DHP / 8)) * 8;
      const bool ok = row0 + r < n_rows && c < DH;
      cp_async16(Qs + r * LD + c, ok ? q_at(r, c) : q, ok);
    }
  } else {
    for (int i = tid; i < BQ * DHP; i += THREADS) {
      const int r = i / DHP, c = i - r * DHP;
      Qs[r * LD + c] = row0 + r < n_rows && c < DH ? *q_at(r, c)
                                                   : __float2bfloat16(0.f);
    }
  }

  // the keys the block's rows can see
  const int t_lo = row0 / G;
  const int t_hi = min(s.T - 1, (row0 + BQ - 1) / G);
  const int k_last = min(s.q_offset + t_hi, s.S - 1);
  const int k_first =
      s.window > 0 ? max(0, s.q_offset + t_lo - s.window + 1) : 0;
  const int tile0 = k_first / KT;
  const int n_tiles = k_last < 0 ? 0 : max(0, k_last / KT - tile0 + 1);

  // half-tile u: K (u even) or V (u odd) of tile u / 2, into slot
  // u % NSLOT; rows past S and columns past dh read as zeros
  auto load = [&](int u) {
    if (u / 2 >= n_tiles) return;
    const int k0 = (tile0 + u / 2) * KT;
    const __nv_bfloat16* src =
        (u % 2 ? v : k) + (int64_t)b * s.S * kv_row + (int64_t)kh * DH;
    __nv_bfloat16* dst = ring + (u % NSLOT) * KT * LD;
    if (vec) {
      for (int i = tid; i < KT * (DHP / 8); i += THREADS) {
        const int r = i / (DHP / 8), c = (i - r * (DHP / 8)) * 8;
        const bool ok = k0 + r < s.S && c < DH;
        cp_async16(dst + r * LD + c,
                   ok ? src + (int64_t)(k0 + r) * kv_row + c : src, ok);
      }
    } else {
      for (int i = tid; i < KT * DHP; i += THREADS) {
        const int r = i / DHP, c = i - r * DHP;
        dst[r * LD + c] = k0 + r < s.S && c < DH
                              ? src[(int64_t)(k0 + r) * kv_row + c]
                              : __float2bfloat16(0.f);
      }
    }
  };
  // one commit group per half-tile; the first also carries the Q tile
#pragma unroll
  for (int u = 0; u < NSLOT - 1; ++u) {
    load(u);
    cp_async_commit();
  }

  // the warp's columns: slices of whole k-steps, as even as they come
  const int dc = (ceil_div(DHP, CS) + 15) & ~15;
  const int c_lo = cs * dc, c_hi = min(DHP, c_lo + dc);
  // the row group's rows R0 .. R0 + 15; this thread holds rows R0 + lane / 4
  // (elements 0, 1 of an accumulator n-tile) and that + 8 (elements 2, 3)
  const int R0 = row0 + rg * 16;
  const bool group_live = R0 < n_rows;
  const int a_lo = s.q_offset + R0 / G;    // the group's first position
  const int a_hi = s.q_offset + min(s.T - 1, (R0 + 15) / G);
  const int apos[2] = {s.q_offset + (R0 + lane / 4) / G,
                       s.q_offset + (R0 + lane / 4 + 8) / G};
  const int col = 2 * (lane % 4);
  // p = 2^(s c - m c): c folds the scale (without a soft-cap) and log2(e)
  const float c = s.softcap > 0.f ? FA_LOG2E : s.scale * FA_LOG2E;
  // 32-bit shared addresses of this lane's ldmatrix rows: the Q fragment
  // (rows lane % 16, k-half lane / 16), a K fragment pair (keys lane % 8
  // and + 8 lane / 16, k-half (lane / 8) % 2), a transposed V fragment
  // pair (keys lane % 8 + 8 ((lane / 8) % 2), columns + 8 (lane / 16))
  const uint32_t q_addr = smem_addr(Qs + (rg * 16 + lane % 16) * LD +
                                    (lane / 16) * 8);
  const uint32_t ring_addr = smem_addr(ring);
  const int k_lane = ((lane / 16) * 8 + lane % 8) * LD + ((lane / 8) % 2) * 8;
  const int v_lane =
      (((lane / 8) % 2) * 8 + lane % 8) * LD + c_lo + (lane / 16) * 8;
  const int ndp = (c_hi - c_lo) / 16;   // the warp's 16-column pieces
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {FA_NEG_INF, FA_NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (tile0 + it) * KT;
    // the K half: K of tile it has landed, slot of half-tile 2 it - 1 free
    cp_async_wait<NSLOT - 2>();
    __syncthreads();
    load(2 * it + NSLOT - 1);
    cp_async_commit();
    // a tile none of the group's rows can see
    const bool seen_by_group =
        group_live && k0 <= a_hi &&
        (s.window <= 0 || k0 + KT - 1 > a_lo - s.window);
    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    if (seen_by_group) {
      // the partial S over this warp's columns of dh
      const uint32_t ks = ring_addr +
          2 * (((2 * it) % NSLOT) * KT * LD + k_lane);
      for (int c0 = c_lo; c0 < c_hi; c0 += 16) {
        uint32_t qa[4];
        ldmatrix_x4(qa, q_addr + 2 * c0);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kf[4];
          ldmatrix_x4(kf, ks + 2 * (np * 16 * LD + c0));
          mma_bf16_16816(sc[2 * np], qa, kf[0], kf[1]);
          mma_bf16_16816(sc[2 * np + 1], qa, kf[2], kf[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
        Sp[((rg * CS + cs) * NT + n) * 32 + lane] =
            make_float4(sc[n][0], sc[n][1], sc[n][2], sc[n][3]);
    }
    // the V half: V of tile it has landed, the partials are stored
    cp_async_wait<NSLOT - 2>();
    __syncthreads();
    load(2 * it + NSLOT);
    cp_async_commit();
    if (!seen_by_group) continue;

    // the group's scores: the CS partials summed in slice order, the same
    // sum in every warp of the group
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float4 x = Sp[(rg * CS * NT + n) * 32 + lane];
      for (int j = 1; j < CS; ++j) {
        const float4 y = Sp[((rg * CS + j) * NT + n) * 32 + lane];
        x.x += y.x;
        x.y += y.y;
        x.z += y.z;
        x.w += y.w;
      }
      sc[n][0] = x.x;
      sc[n][1] = x.y;
      sc[n][2] = x.z;
      sc[n][3] = x.w;
    }
    if (s.softcap > 0.f) {
      const float k_in = s.scale / s.softcap;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[n][e] = s.softcap * tanhf(sc[n][e] * k_in);
    }
    // the mask, on tiles that cross a row's diagonal, window edge or S
    if (k0 + KT - 1 > a_lo || k0 + KT > s.S ||
        (s.window > 0 && k0 <= a_hi - s.window)) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + col + (e & 1), a = apos[e >> 1];
          if (key > a || key >= s.S || (s.window > 0 && key <= a - s.window))
            sc[n][e] = FA_NEG_INF;
        }
    }
    // online softmax; row r's scores are elements 2r, 2r + 1 of each
    // n-tile over the 4 lanes of a quad
    float mc[2], rs[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(sc[0][2 * r], sc[0][2 * r + 1]);
#pragma unroll
      for (int n = 1; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = ex2_approx((m[r] - m_new) * c);
      m[r] = m_new;
      // a row that sees no key yet gets p = 0
      mc[r] = m_new == FA_NEG_INF ? 0.f : m_new * c;
      l[r] = l[r] * alpha;
      rs[r] = 0.f;
      // the output rescaled to the new max (columns past the warp's slice
      // hold zeros)
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][2 * r] *= alpha;
        o[d][2 * r + 1] *= alpha;
      }
    }
    // P: p in fp32 into the row sums, rounded to bf16 as the A fragments
    // (held whole, 2 KT / 16 registers, so the scores are dead before P V)
    uint32_t pf[NT / 2][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float p0 = ex2_approx(fmaf(sc[n][0], c, -mc[0]));
      const float p1 = ex2_approx(fmaf(sc[n][1], c, -mc[0]));
      const float p2 = ex2_approx(fmaf(sc[n][2], c, -mc[1]));
      const float p3 = ex2_approx(fmaf(sc[n][3], c, -mc[1]));
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[n / 2][2 * (n % 2)] = pack_bf16(p0, p1);
      pf[n / 2][2 * (n % 2) + 1] = pack_bf16(p2, p3);
    }
    // O += P V over the warp's columns, 16 keys at a time
    const uint32_t vs = ring_addr +
        2 * (((2 * it + 1) % NSLOT) * KT * LD + v_lane);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        if (dp < ndp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vs + 2 * (j * 16 * LD + dp * 16));
          mma_bf16_16816(o[2 * dp], pf[j], vf[0], vf[1]);
          mma_bf16_16816(o[2 * dp + 1], pf[j], vf[2], vf[3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = rs[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] += sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // out = o / max(l, 1e-30): each warp's slice through the Q tile, then
  // 16-byte stores (element stores where dh is no multiple of 8)
  const float den0 = fmaxf(l[0], 1e-30f), den1 = fmaxf(l[1], 1e-30f);
  __nv_bfloat16* Os = Qs + (rg * 16 + lane / 4) * LD + c_lo + col;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    if (c_lo + d * 8 < c_hi) {
      *reinterpret_cast<uint32_t*>(Os + d * 8) =
          pack_bf16(o[d][0] / den0, o[d][1] / den0);
      *reinterpret_cast<uint32_t*>(Os + 8 * LD + d * 8) =
          pack_bf16(o[d][2] / den1, o[d][3] / den1);
    }
  }
  __syncthreads();
  auto out_at = [&](int r, int c) {
    const int R = row0 + r, t = R / G;
    return out + (((int64_t)b * s.T + t) * s.H + kh * G + R - t * G) * DH + c;
  };
  if (vec) {
    for (int i = tid; i < BQ * (DH / 8); i += THREADS) {
      const int r = i / (DH / 8), c8 = (i - r * (DH / 8)) * 8;
      if (row0 + r < n_rows)
        *reinterpret_cast<uint4*>(out_at(r, c8)) =
            *reinterpret_cast<const uint4*>(Qs + r * LD + c8);
    }
  } else {
    for (int i = tid; i < BQ * DH; i += THREADS) {
      const int r = i / DH, cc = i - r * DH;
      if (row0 + r < n_rows) *out_at(r, cc) = Qs[r * LD + cc];
    }
  }
}

template <int CS, int RG, int KT, int NSLOT>
int launch_wide_mma(const void* q, const void* k, const void* v, void* out,
                    const FlashShape& s, int dh, cudaStream_t stream) {
  using F = FlashWideMma<CS, RG, KT, NSLOT>;
  // a warp holds at most FW_DC output columns
  if (dh > F::MAX_DH) return (int)cudaErrorInvalidValue;
  const size_t bytes = F::smem_bytes(dh);
  auto kernel = flash_wide_mma_kernel<CS, RG, KT, NSLOT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(s.KH, s.B, ceil_div(s.T * (s.H / s.KH), F::BQ));
  kernel<<<grid, F::THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), s, dh);
  return (int)cudaGetLastError();
}

// Head dims above the built ones: the wide instance whose ceiling holds dh.
template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* out,
                const FlashShape& s, int dh, cudaStream_t stream) {
  if (dh <= 256 || dh > FA_WIDE_MAX_DH) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (dh <= 512)
      return launch_wide_mma<2, 4, 16, 2>(q, k, v, out, s, dh, stream);
    if (dh <= 1024)
      return launch_wide_mma<4, 2, 16, 4>(q, k, v, out, s, dh, stream);
    return launch_wide_mma<8, 1, 16, 2>(q, k, v, out, s, dh, stream);
  } else {
    if (dh <= 512) return launch_wide_nj<16>(q, k, v, out, s, dh, stream);
    if (dh <= 1024) return launch_wide_nj<32>(q, k, v, out, s, dh, stream);
    return launch_wide_nj<64>(q, k, v, out, s, dh, stream);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           const FlashShape& s, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_dh<T, 16>(q, k, v, out, s, stream);
    case 64: return launch_dh<T, 64>(q, k, v, out, s, stream);
    case 80: return launch_dh<T, 80>(q, k, v, out, s, stream);
    case 128: return launch_dh<T, 128>(q, k, v, out, s, stream);
    case 256: return launch_dh<T, 256>(q, k, v, out, s, stream);
    default: return launch_wide<T>(q, k, v, out, s, dh, stream);
  }
}

}  // namespace carla

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out, all contiguous and
// 16-byte aligned). q and out are (B, T, H, DH); k and v are (B, S, KH, DH)
// with H a multiple of KH. DH is 16, 64, 80, 128 or 256, or any DH in 257
// .. FA_WIDE_MAX_DH (the wide kernel). window <= 0 and softcap <= 0 turn those off.
// q_offset >= 0 is the position of q's first row (0 unsharded).
// Returns cudaGetLastError() (or the error of the shared-memory opt-in).
extern "C" int carla_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, int B, int T,
                                     int S, int H, int KH, int DH, int window,
                                     int q_offset, float scale, float softcap,
                                     void* stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  if (KH <= 0 || H % KH != 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const carla::FlashShape s{B, T, S, H, KH, window, q_offset, scale,
                            softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return carla::launch<float>(q, k, v, out, s, DH, st);
  if (dtype == 1)
    return carla::launch<__nv_bfloat16>(q, k, v, out, s, DH, st);
  return (int)cudaErrorInvalidValue;
}
