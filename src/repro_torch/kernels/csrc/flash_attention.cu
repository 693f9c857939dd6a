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
// here run in parallel and in no order, so one block owns a 64-row query
// tile of one head and loops over the 64-key tiles itself, with m, l and the
// fp32 accumulator in registers. KV tiles past the diagonal (and, with a
// window, before it) are never loaded. Ragged T and S are bounds checks
// (the Pallas wrapper asserts T % bq == 0); DH is a template parameter,
// instantiated for the head dims the configs use: 16 (the smoke configs),
// 64, 80 (zamba2's, not a power of two) and 128.
//
// Bound on this card: 4 * DH FLOP per (query, key) pair over the causal
// half, 8.6e10 FLOP at zamba2's prefill shape (B 4, T 2048, H 32, DH 80),
// against 168 MB of bf16 q, k, v and out: about 500 FLOP per byte, so bound by
// operations (0.087 ms at the bf16 tensor-core peak). This first version
// runs on the fp32 CUDA cores (67 TFLOP/s), which also gives the fp32 inputs
// an exact fp32 result: 256 threads, each with a 4 x 4 micro-tile of the
// 64 x 64 score tile (16 FMAs per two 16-byte shared-memory reads) and a
// 4 x DH/16 slice of the output tile; Q, K (both transposed), V and the
// rounded P tile sit in shared memory as fp32. The query tiles are handed
// out longest first (the causal work grows with the tile index), so the
// last wave is short. Tensor cores (mma/wgmma on the bf16 inputs) are later
// work.
#include "numeric.cuh"

namespace carla {

constexpr int FA_BQ = 64, FA_BK = 64, FA_THREADS = 256;
constexpr float FA_NEG_INF = -2.3819763e38f;

struct FlashShape {
  int B, T, S, H, KH, window;
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

  const int q_last = min(q0 + FA_BQ, s.T) - 1;
  const int k_last = min(q_last, s.S - 1);
  const int k_first = s.window > 0 ? max(0, q0 - s.window + 1) : 0;
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
      const int t = q0 + ty * 4 + i;
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

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, void* out,
              const FlashShape& s, cudaStream_t stream) {
  constexpr size_t bytes = FlashSmem<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ceil_div(s.T, FA_BQ), s.H, s.B);
  flash_kernel<T, DH><<<grid, FA_THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s);
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
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace carla

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out, all contiguous and
// 16-byte aligned). q and out are (B, T, H, DH); k and v are (B, S, KH, DH)
// with H a multiple of KH. window <= 0 and softcap <= 0 turn those off.
// Returns cudaGetLastError() (or the error of the shared-memory opt-in).
extern "C" int carla_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, int B, int T,
                                     int S, int H, int KH, int DH, int window,
                                     float scale, float softcap,
                                     void* stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  if (KH <= 0 || H % KH != 0) return (int)cudaErrorInvalidValue;
  const carla::FlashShape s{B, T, S, H, KH, window, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return carla::launch<float>(q, k, v, out, s, DH, st);
  if (dtype == 1)
    return carla::launch<__nv_bfloat16>(q, k, v, out, s, DH, st);
  return (int)cudaErrorInvalidValue;
}
