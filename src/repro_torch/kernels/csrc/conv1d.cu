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
// FL above 4 (no config has one; the Pallas kernel takes any FL): a window
// of FL registers can't be indexed at a runtime FL, so conv1d_any_kernel
// keeps TT_ANY = 8 outputs per thread in registers instead and walks the
// taps outside them: for each r it loads the tap's VEC weights once and the
// TT_ANY inputs under it, re-read through L1 (an input is read by up to
// min(FL, TT_ANY) taps of a thread, and from device memory once). The
// summation order is the instances', r = 0, 1, ....
#include "numeric.cuh"

namespace carla {

constexpr int CONV1D_THREADS = 128;
constexpr int CONV1D_TT = 32;   // time steps per thread
constexpr int CONV1D_TT_ANY = 8;  // ... in conv1d_any_kernel

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

template <typename T, int VEC>
__global__ void __launch_bounds__(CONV1D_THREADS)
conv1d_any_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  T* __restrict__ out, Conv1dShape s, int FL) {
  const int c0 = (blockIdx.x * CONV1D_THREADS + threadIdx.x) * VEC;
  if (c0 >= s.C) return;
  const int t0 = blockIdx.y * CONV1D_TT_ANY;
  const int b = blockIdx.z;
  const T* xb = x + (int64_t)b * s.xbs + c0;
  T* ob = out + ((int64_t)b * s.T) * s.C + c0;

  float acc[CONV1D_TT_ANY][VEC];
#pragma unroll
  for (int i = 0; i < CONV1D_TT_ANY; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
  for (int r = 0; r < FL; ++r) {
    float wr[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) wr[e] = w[(int64_t)r * s.C + c0 + e];
    // output t0 + i reads input t0 + i - FL + 1 + r
    const int first = t0 - FL + 1 + r;
#pragma unroll
    for (int i = 0; i < CONV1D_TT_ANY; ++i) {
      const int t = first + i;
      if (t < 0 || t0 + i >= s.T) continue;
      float f[VEC];
      if constexpr (VEC == 1) {
        f[0] = to_f32(xb[(int64_t)t * s.xts]);
      } else {
        load16(xb + (int64_t)t * s.xts, f);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][e] += f[e] * wr[e];
    }
  }
#pragma unroll
  for (int i = 0; i < CONV1D_TT_ANY; ++i) {
    const int t = t0 + i;
    if (t >= s.T) break;
    if constexpr (VEC == 1) {
      ob[(int64_t)t * s.C] = from_f32<T>(acc[i][0]);
    } else {
      store16(ob + (int64_t)t * s.C, acc[i]);
    }
  }
}

template <typename T>
int launch_any(const void* x, const float* w, void* out, const Conv1dShape& s,
               int fl, int vec, cudaStream_t stream) {
  const dim3 block(CONV1D_THREADS);
  const int t_blocks = ceil_div(s.T, CONV1D_TT_ANY);
  if (vec == 1) {
    const dim3 grid(ceil_div(s.C, CONV1D_THREADS), t_blocks, s.B);
    conv1d_any_kernel<T, 1><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), w, static_cast<T*>(out), s, fl);
  } else if (vec == Vec16<T>::N) {
    const dim3 grid(ceil_div(s.C / Vec16<T>::N, CONV1D_THREADS), t_blocks,
                    s.B);
    conv1d_any_kernel<T, Vec16<T>::N><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), w, static_cast<T*>(out), s, fl);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
