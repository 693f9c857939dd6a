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

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           const FlashShape& s, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_dh<T, 16>(q, k, v, out, s, stream);
    case 64: return launch_dh<T, 64>(q, k, v, out, s, stream);
    case 80: return launch_dh<T, 80>(q, k, v, out, s, stream);
    case 128: return launch_dh<T, 128>(q, k, v, out, s, stream);
    case 256: return launch_dh<T, 256>(q, k, v, out, s, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace carla

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out, all contiguous and
// 16-byte aligned). q and out are (B, T, H, DH); k and v are (B, S, KH, DH)
// with H a multiple of KH. window <= 0 and softcap <= 0 turn those off.
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
