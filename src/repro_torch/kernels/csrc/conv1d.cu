// Depthwise causal 1-D convolution for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/conv1d.py:_conv1d_kernel, the Pallas TPU kernel
// for Mamba2's short conv (d_conv = 4, on every Mamba2 block of zamba2) and
// RWKV6's 2-tap token shift.
//
// What it computes: out[b, t, c] = sum_{r < FL} x[b, t - FL + 1 + r, c] *
// w[r, c] for any FL >= 1, with x[t < 0] = 0 (the causal left pad), summed
// in fp32 in the order r = 0, 1, ... and stored once in x's type. FL 1 to 4
// (the configs' d_conv of 4 and the token shift's 2 taps among them) are
// template instances that keep their window in registers; any other FL runs
// conv1d_any_kernel, FL a runtime argument (below). w is fp32 whatever x's
// type is (Mamba2 keeps conv_w in fp32; the Pallas kernel casts both to fp32).
//
// Why not the Pallas blocking: that block holds a whole (T + FL - 1, 512)
// padded sequence slab in VMEM and a (T, 512) fp32 accumulator, and the pad
// is a copy of x in HBM. Here nothing is padded: a t < 0 tap is a bounds
// check, and x may be a strided view (Mamba2's conv input is a column slice
// of the in_proj output), read in place through its batch and time strides.
//
// Bound on this card: 2 * FL FLOP per output element against 2 (or 4) bytes
// read and 2 (or 4) written, under 2 FLOP per byte, so device-memory bytes
// bound it. At zamba2's prefill shape (4, 2048, 5248) bf16 that is 172 MB,
// 0.051 ms at 3.35 TB/s. The design reads each input element from memory
// once: a thread owns VEC neighbouring channels (16 bytes, one vector load
// per time step) and a run of TT time steps, and keeps the last FL inputs in
// registers, so each step loads one new vector and stores one. The FL - 1
// inputs before the run are the only ones read twice (3 of every 35 at
// TT = 32, FL = 4). Neighbouring threads take neighbouring channels, so a
// warp's loads are contiguous.
//
// FL other than 1-4 (no config has one; the Pallas kernel takes any FL):
// conv1d_any_kernel, FL a runtime argument. Bound: 2 FL FLOP per element
// against 4 bytes (bf16) or 8 (fp32), so bytes bound it up to FL 40 (bf16)
// or 80 (fp32) on the CUDA cores' 67 TFLOP/s, operations above; at FL 7 and
// zamba2's prefill shape it is the same 0.051 ms (bf16), 0.103 ms (fp32).
// A window of FL registers can't be indexed at a runtime FL, so the input
// is staged in shared memory instead. A block owns a tile of C1A_TB = 128
// steps of 64 channels (32 at one channel a thread; 5248 splits into 82
// whole tiles, so no lane idles) and copies the tile's TB + FL - 1 input
// rows into a slab by 16-byte cp.async copies (zero-filled for t < 0, past
// T and past C), its FL x 64 fp32 taps beside them: every copy of the slab
// is in flight at once, and x is read from device memory once plus the
// (FL - 1) / TB halo. Each thread then sums TT outputs of one 16-byte
// vector (32 fp32 sums) tap by tap from the slab, each tap's weights read
// once, in the order r = 0, 1, ... of the instances. For FL <= C1A_FC = 64
// a block walks C1A_NT = 2 tiles, the second tile's slab copied in while
// the first is summed. Longer filters take one tile a block and walk the
// taps in chunks of 64 through a ring of 256 rows, the next chunk's rows
// and taps copied in under the current chunk's sums; each row is copied
// once.
//
// Measured on an H100 SXM (700 W) at FL 7 and zamba2's prefill shape, bf16,
// cold L2 (chip_smoke.py's phase wide_paths and kernel_bench's
// --conv1d-against): the version this replaces kept 8 outputs a thread and
// walked the taps over them, re-reading inputs through L1 with each tap's 8
// loads in flight behind its bounds checks (0.127 ms). Of what held it
// back, the halo was not it: with 16 outputs a thread (half the halo) it
// took 0.180 ms, with 4 (twice the halo) 0.118. Latency was: the loads a
// thread and a warp could keep in flight. The slab puts a whole tile's
// copies in flight before any sum; idle lanes go with the 64-channel
// tiles. It takes 0.067 ms: the slabs' copies and stores alone take 0.065
// (2.6 TB/s; a clone of a contiguous x 0.063), so the sums add 0.002 that
// the second tile's copies do not hide (one tile a block: 0.074). In fp32
// (0.122 ms) the copies alone take as long as the kernel.
#include "numeric.cuh"
#include "ptx.cuh"

namespace carla {

constexpr int CONV1D_THREADS = 128;
constexpr int CONV1D_TT = 32;   // time steps per thread
// conv1d_any_kernel (FL a runtime argument): threads and time steps of a
// tile, taps a chunk, the rows of the ring that longer filters walk, and
// the tiles a block walks at FL <= C1A_FC
constexpr int C1A_THREADS = 256;
constexpr int C1A_TB = 128;
constexpr int C1A_FC = 64;
constexpr int C1A_RING = 256;
constexpr int C1A_NT = 2;
static_assert(C1A_RING >= C1A_TB + 2 * C1A_FC - 1 &&
                  (C1A_RING & (C1A_RING - 1)) == 0,
              "the ring holds two chunks' rows beside the tile's");

struct Conv1dShape {
  int B, T, C, xbs, xts;  // x[b, t, c] = x[b * xbs + t * xts + c]
};

template <typename T, int FL, int VEC>
__global__ void __launch_bounds__(CONV1D_THREADS)
conv1d_kernel(const T* __restrict__ x, const float* __restrict__ w,
              T* __restrict__ out, Conv1dShape s) {
  const int c0 = (blockIdx.x * CONV1D_THREADS + threadIdx.x) * VEC;
  if (c0 >= s.C) return;
  const int t0 = blockIdx.y * CONV1D_TT;
  const int t1 = min(s.T, t0 + CONV1D_TT);
  const int b = blockIdx.z;
  const T* xb = x + (int64_t)b * s.xbs + c0;
  T* ob = out + ((int64_t)b * s.T) * s.C + c0;

  float wr[FL][VEC];
#pragma unroll
  for (int r = 0; r < FL; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) wr[r][e] = w[(int64_t)r * s.C + c0 + e];

  // win[j] holds x[t - FL + 1 + j]; the first FL - 1 come before the run.
  float win[FL][VEC];
#pragma unroll
  for (int j = 0; j < FL - 1; ++j) {
    const int t = t0 - FL + 1 + j;
    if (t < 0) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) win[j][e] = 0.f;
    } else if constexpr (VEC == 1) {
      win[j][0] = to_f32(xb[(int64_t)t * s.xts]);
    } else {
      load16(xb + (int64_t)t * s.xts, win[j]);
    }
  }
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
    if constexpr (VEC == 1) {
      win[FL - 1][0] = to_f32(xb[(int64_t)t * s.xts]);
    } else {
      load16(xb + (int64_t)t * s.xts, win[FL - 1]);
    }
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      acc[e] = 0.f;
#pragma unroll
      for (int r = 0; r < FL; ++r) acc[e] += win[r][e] * wr[r][e];
    }
    if constexpr (VEC == 1) {
      ob[(int64_t)t * s.C] = from_f32<T>(acc[0]);
    } else {
      store16(ob + (int64_t)t * s.C, acc);
    }
#pragma unroll
    for (int j = 0; j < FL - 1; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) win[j][e] = win[j + 1][e];
  }
}

// A runtime-FL block's tile: C1A_TB time steps of CH channels. Each thread
// owns VEC neighbouring channels (one 16-byte vector, or one channel) and a
// run of TT time steps, TT * VEC = 32 fp32 sums (16 at VEC 1); RUNS runs of
// CB vectors fill the C1A_THREADS threads. One slab row, CB vectors of x,
// is RB bytes.
template <typename T, int VEC>
struct AnyTile {
  static constexpr int TT = VEC == 1 ? 16 : 32 / VEC;
  static constexpr int RUNS = C1A_TB / TT;
  static constexpr int CB = C1A_THREADS / RUNS;
  static constexpr int CH = CB * VEC;
  static constexpr int RB = CH * (int)sizeof(T);
  static_assert(RUNS * CB == C1A_THREADS && RUNS * TT == C1A_TB, "tile");
  static_assert(RB % 16 == 0, "slab rows hold whole 16-byte vectors");
  // Dynamic shared memory: the slab (FL <= C1A_FC: its TB + FL - 1 rows;
  // else the ring's C1A_RING) and the taps (FL; else two chunks of C1A_FC).
  static size_t bytes(int fl) {
    return fl <= C1A_FC
               ? (size_t)2 * (C1A_TB + fl - 1) * RB + (size_t)fl * CH * 4
               : (size_t)C1A_RING * RB + (size_t)2 * C1A_FC * CH * 4;
  }
};

// Copies 4 bytes from src to dst without holding a register; with valid
// false it reads nothing and writes 4 zero bytes.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Slab rows [j0, j1) of a block, row j holding x[b, base + j, c0 : c0 + CH]
// (zero outside 0 <= t < T and past C: the causal pad and the ragged
// edges), at ring slot j mod C1A_RING when RING. 16-byte vectors and fp32
// channels go by cp.async; bf16 channels (no 2-byte cp.async) by plain
// loads.
template <typename T, int VEC, bool RING>
__device__ __forceinline__ void load_rows(char* xs, const T* xb, int base,
                                          int j0, int j1, int c0,
                                          const Conv1dShape& s) {
  using A = AnyTile<T, VEC>;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < (j1 - j0) * A::CB; idx += C1A_THREADS) {
    const int j = j0 + idx / A::CB, v = idx % A::CB;
    const int t = base + j, c = c0 + v * VEC;
    const bool ok = t >= 0 && t < s.T && c < s.C;
    T* dst = reinterpret_cast<T*>(
                 xs + (RING ? j & (C1A_RING - 1) : j) * A::RB) + v * VEC;
    const T* src = xb + (ok ? (int64_t)t * s.xts + c : 0);
    if constexpr (VEC > 1) {
      cp_async16(dst, src, ok);
    } else if constexpr (sizeof(T) == 4) {
      cp_async4(dst, src, ok);
    } else {
      *dst = ok ? *src : from_f32<T>(0.f);
    }
  }
}

// Taps [r0, r1) of w[:, c0 : c0 + CH] (zero past C) into ws, tap r at row
// r - r0.
template <typename T, int VEC>
__device__ __forceinline__ void load_taps(float* ws, const float* w, int r0,
                                          int r1, int c0, int C) {
  using A = AnyTile<T, VEC>;
  for (int idx = threadIdx.x; idx < (r1 - r0) * A::CH; idx += C1A_THREADS) {
    const int r = r0 + idx / A::CH, c = c0 + idx % A::CH;
    cp_async4(ws + idx, w + (c < C ? (int64_t)r * C + c : 0), c < C);
  }
}

// acc[i] += x[t_i - FL + 1 + r] w[r] for taps r0 <= r < r1, in that order,
// for the thread's outputs t_i (slab row run0 + i + r holds the input), ws
// holding tap r0 at row 0. Each tap's weights are read once; x is read from
// the slab, one vector per (tap, output).
template <typename T, int VEC, bool RING>
__device__ __forceinline__ void walk_taps(
    const char* xs, const float* ws, int r0, int r1, int run0, int v,
    float (&acc)[AnyTile<T, VEC>::TT][VEC]) {
  using A = AnyTile<T, VEC>;
  for (int r = r0; r < r1; ++r) {
    const float* wp = ws + (r - r0) * A::CH + v * VEC;
    float wr[VEC];
    if constexpr (VEC == 1) {
      wr[0] = wp[0];
    } else {
#pragma unroll
      for (int e = 0; e < VEC; e += 4) load16(wp + e, wr + e);
    }
#pragma unroll
    for (int i = 0; i < A::TT; ++i) {
      int j = run0 + i + r;
      if constexpr (RING) j &= C1A_RING - 1;
      const T* p = reinterpret_cast<const T*>(xs + j * A::RB) + v * VEC;
      float f[VEC];
      if constexpr (VEC == 1) {
        f[0] = to_f32(*p);
      } else {
        load16(p, f);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][e] += f[e] * wr[e];
    }
  }
}

// out[b, t + i, c : c + VEC] = acc[i] for the steps below T.
template <typename T, int VEC, int TT>
__device__ __forceinline__ void store_run(T* out, const float (&acc)[TT][VEC],
                                          int b, int t, int c,
                                          const Conv1dShape& s) {
  if (c >= s.C) return;
  T* ob = out + ((int64_t)b * s.T + t) * s.C + c;
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    if (t + i >= s.T) break;
    if constexpr (VEC == 1) {
      ob[(int64_t)i * s.C] = from_f32<T>(acc[i][0]);
    } else {
      store16(ob + (int64_t)i * s.C, acc[i]);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(C1A_THREADS)
conv1d_any_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  T* __restrict__ out, Conv1dShape s, int FL) {
  using A = AnyTile<T, VEC>;
  extern __shared__ __align__(16) char smem[];
  const int nch = ceil_div(FL, C1A_FC);
  const int c0 = blockIdx.x * A::CH;
  const int t0 = blockIdx.y * C1A_TB * (nch == 1 ? C1A_NT : 1);
  const int b = blockIdx.z;
  const T* xb = x + (int64_t)b * s.xbs;
  // neighbouring threads take neighbouring vectors of one slab row
  const int run0 = threadIdx.x / A::CB * A::TT, v = threadIdx.x % A::CB;
  const int c = c0 + v * VEC;
  float acc[A::TT][VEC];

  if (nch == 1) {
    // Short filters: the block walks C1A_NT tiles of TB steps, each summed
    // from a slab of its TB + FL - 1 input rows (slab row 0 is step tile
    // - FL + 1); the next tile's slab is copied in while this one is summed.
    const int rows = C1A_TB + FL - 1, slab = rows * A::RB;
    float* ws = reinterpret_cast<float*>(smem + 2 * slab);
    const int nt = min(C1A_NT, ceil_div(s.T - t0, C1A_TB));
    load_rows<T, VEC, false>(smem, xb, t0 - FL + 1, 0, rows, c0, s);
    load_taps<T, VEC>(ws, w, 0, FL, c0, s.C);
    cp_async_commit();
    for (int n = 0; n < nt; ++n) {
      const int tile = t0 + n * C1A_TB;
      if (n + 1 < nt) {
        load_rows<T, VEC, false>(smem + (n + 1) % 2 * slab, xb,
                                 tile + C1A_TB - FL + 1, 0, rows, c0, s);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < A::TT; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
      walk_taps<T, VEC, false>(smem + n % 2 * slab, ws, 0, FL, run0, v, acc);
      store_run<T, VEC>(out, acc, b, tile + run0, c, s);
      __syncthreads();  // before slab n % 2 takes tile n + 2
    }
    return;
  }

  // Long filters: one tile, its taps in chunks of C1A_FC through a ring of
  // C1A_RING rows (row j, step t0 - FL + 1 + j, at slot j mod C1A_RING):
  // chunk c reads rows [c FC, c FC + TB + FC - 1) and brings FC new ones,
  // copied in with chunk c + 1's taps while chunk c is summed.
  const int base = t0 - FL + 1;
  float* ws = reinterpret_cast<float*>(smem + C1A_RING * A::RB);
#pragma unroll
  for (int i = 0; i < A::TT; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
  load_rows<T, VEC, true>(smem, xb, base, 0, C1A_TB + C1A_FC - 1, c0, s);
  load_taps<T, VEC>(ws, w, 0, C1A_FC, c0, s.C);
  cp_async_commit();
  for (int k = 0; k < nch; ++k) {
    if (k + 1 < nch) {
      const int r_next = min(FL, (k + 2) * C1A_FC);
      load_rows<T, VEC, true>(smem, xb, base, C1A_TB + (k + 1) * C1A_FC - 1,
                              C1A_TB + r_next - 1, c0, s);
      load_taps<T, VEC>(ws + (k + 1) % 2 * C1A_FC * A::CH, w,
                        (k + 1) * C1A_FC, r_next, c0, s.C);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int r_end = min(FL, (k + 1) * C1A_FC);
    walk_taps<T, VEC, true>(smem, ws + k % 2 * C1A_FC * A::CH, k * C1A_FC,
                            r_end, run0, v, acc);
    __syncthreads();  // before chunk k + 2's copies reuse these slots
  }
  store_run<T, VEC>(out, acc, b, t0 + run0, c, s);
}

template <typename T, int VEC>
int launch_any_vec(const void* x, const float* w, void* out,
                   const Conv1dShape& s, int fl, cudaStream_t stream) {
  using A = AnyTile<T, VEC>;
  auto kernel = conv1d_any_kernel<T, VEC>;
  const size_t bytes = A::bytes(fl);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(ceil_div(s.C, A::CH),
                  ceil_div(s.T, C1A_TB * (fl <= C1A_FC ? C1A_NT : 1)), s.B);
  kernel<<<grid, C1A_THREADS, bytes, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), s, fl);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(const void* x, const float* w, void* out, const Conv1dShape& s,
               int fl, int vec, cudaStream_t stream) {
  if (vec == 1) return launch_any_vec<T, 1>(x, w, out, s, fl, stream);
  if (vec == Vec16<T>::N)
    return launch_any_vec<T, Vec16<T>::N>(x, w, out, s, fl, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int FL>
int launch_fl(const void* x, const float* w, void* out, const Conv1dShape& s,
              int vec, cudaStream_t stream) {
  const dim3 block(CONV1D_THREADS);
  const int t_blocks = ceil_div(s.T, CONV1D_TT);
  if (vec == 1) {
    const dim3 grid(ceil_div(s.C, CONV1D_THREADS), t_blocks, s.B);
    conv1d_kernel<T, FL, 1><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), w, static_cast<T*>(out), s);
  } else if (vec == Vec16<T>::N) {
    const dim3 grid(ceil_div(s.C / Vec16<T>::N, CONV1D_THREADS), t_blocks,
                    s.B);
    conv1d_kernel<T, FL, Vec16<T>::N><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), w, static_cast<T*>(out), s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const float* w, void* out, const Conv1dShape& s,
           int fl, int vec, cudaStream_t stream) {
  switch (fl) {
    case 1: return launch_fl<T, 1>(x, w, out, s, vec, stream);
    case 2: return launch_fl<T, 2>(x, w, out, s, vec, stream);
    case 3: return launch_fl<T, 3>(x, w, out, s, vec, stream);
    case 4: return launch_fl<T, 4>(x, w, out, s, vec, stream);
    default: return launch_any<T>(x, w, out, s, fl, vec, stream);
  }
}

}  // namespace carla

// dtype: 0 = float32, 1 = bfloat16 (x and out); w is fp32 (FL, C),
// contiguous, FL >= 1. x[b, t, c] lies at x + b * x_bstride + t * x_tstride + c; out
// is a contiguous (B, T, C). vec: channels per thread, 1 or 16 bytes' worth
// of x's type (then C, both strides and both pointers must allow 16-byte
// vector access). Returns cudaGetLastError().
extern "C" int carla_conv1d_causal(int dtype, const void* x, const void* w,
                                   void* out, int B, int T, int C, int FL,
                                   int x_bstride, int x_tstride, int vec,
                                   void* stream) {
  if (B == 0 || T == 0 || C == 0) return 0;
  if (FL < 1) return (int)cudaErrorInvalidValue;
  const carla::Conv1dShape s{B, T, C, x_bstride, x_tstride};
  const float* wp = static_cast<const float*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return carla::launch<float>(x, wp, out, s, FL, vec, st);
  if (dtype == 1)
    return carla::launch<__nv_bfloat16>(x, wp, out, s, FL, vec, st);
  return (int)cudaErrorInvalidValue;
}
