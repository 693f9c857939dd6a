// The squeeze-and-excitation gate of an MBConv block for Hopper (sm_90a):
// g = sigmoid(W2 . SiLU(W1 . mean + b1) + b2), one kernel a block, and the
// pass that applies it to the block's depthwise map (se_scale_kernel).
//
// Replaces: no TPU kernel. The JAX package runs no squeeze-and-excitation;
// this kernel serves the 30 MBConv blocks of EfficientNetV2-S
// (models/efficientnet.py). Its input is what the block's depthwise conv
// (dwconv.cu) left beside its output: the fp32 sums of each tile of
// DW_TILE_PIX output pixels by channel, sums[b, tile, c]. Its output, the fp32
// gate (B, C), is applied to the depthwise map in place by the pass of its
// own, and the block's projection reads the gated map. (A gemm_pipe.cuh
// instance that scaled the A operand as the projection loaded it, so that
// the gated map was never written, made the batch-1 replay of the net
// slower on the H100: PERF.md.)
//
// What it computes, per image b: mean[c] = (sum over tiles, in tile order, of
// sums[b, tile, c]) / npix; h[j] = SiLU(b1[j] + sum_c mean[c] W1[c, j]) for
// W1 (C, R); gate[b, c] = sigmoid(b2[c] + sum_j h[j] W2[j, c]) for W2 (R, C).
// Every sum is taken in a fixed order, so a replay gives the same bits.
//
// Bound on this card: a few thousand FMAs and the two weight matrices (R x C
// each, 2 x 393 KB in fp32 at C 1536, R 64): under a microsecond of bytes.
// What bounds it is latency: three dependent reductions (the mean, h, the
// gate), each over a whole vector the one before produced, each a chain of
// round trips to the L2 or device memory. One block would read both
// matrices alone; so each image's gate is computed by a cluster of
// SE_CLUSTER blocks, each owning a slice of the channels and of h, and in
// every reduction each thread keeps SE_BATCH loads in flight before it adds
// them. Even so a batch of loads from device memory took 2-2.5 us (probed
// with clock64 on the H100, the weights cold: 24 us a gate at C 1536), so
// the kernel is a programmatic dependent launch: the depthwise conv before
// it lets it be placed as that conv starts (dwconv.cu), and before its
// griddepcontrol.wait each block asks the L2 for its slices of W1 and W2
// (a hint: the weights are no kernel's output), which then arrive under
// the depthwise conv's time. (Letting the projection after it be placed at
// the gate's start as well made that projection end 2.5 us later.) Block r
// adds its channels' tiles into its slice of the mean,
// the cluster's barrier, then every block copies the whole mean from its
// peers' shared memory (distributed shared memory), computes its slice of h
// (threads across h's outputs, so that a row of W1 is read in one piece,
// and across the channels), the barrier again, copies the whole h, and
// computes its channels' gates (threads across the channels, so that W2's
// rows are read in one piece, and across h). Each reduction's threads add
// their parts through shared memory by a tree of fixed shape. A last
// barrier keeps every block until its peers have read its slices.
#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

#include "numeric.cuh"
#include "ptx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SE_CLUSTER = 8;
constexpr int SE_THREADS = 1024;
constexpr int SE_BATCH = 16;  // loads a thread keeps in flight
constexpr int SE_SMEM_MAX = 48 * 1024;

// sum over i = first, first + step, ... < n of a(i) * load(i), SE_BATCH
// loads in flight at a time, added in order of i. Every load of a batch is
// issued, past the end at the last index (n > 0), and masked in the sum:
// loads under a predicate each were issued one after the other.
template <class A, class L>
__device__ __forceinline__ float batched_dot(int first, int step, int n,
                                             A a, L load) {
  float s = 0.f;
  for (int base = first; base < n; base += SE_BATCH * step) {
    float v[SE_BATCH];
#pragma unroll
    for (int u = 0; u < SE_BATCH; ++u) {
      const int i = base + u * step;
      v[u] = load(i < n ? i : n - 1);
    }
#pragma unroll
    for (int u = 0; u < SE_BATCH; ++u) {
      const int i = base + u * step;
      if (i < n) s = fmaf(a(i), v[u], s);
    }
  }
  return s;
}

// The threads' parts red[g * width + k] for g < groups added into out[k],
// k < width, by a tree of fixed shape (groups g and g + h paired, h half
// the groups left, rounded up), a barrier a level.
__device__ __forceinline__ void add_parts(float* red, int groups, int width,
                                          float* out) {
  for (int n = groups; n > 1; n = (n + 1) / 2) {
    const int h = (n + 1) / 2;
    __syncthreads();
    for (int i = threadIdx.x; i < (n - h) * width; i += SE_THREADS)
      red[i] += red[i + h * width];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < width; k += SE_THREADS) out[k] = red[k];
}

template <typename T>
__global__ void __cluster_dims__(SE_CLUSTER, 1, 1)
    __launch_bounds__(SE_THREADS)
se_gate_kernel(const float* __restrict__ sums, int tiles, int npix,
               const T* __restrict__ w1, const float* __restrict__ b1,
               const T* __restrict__ w2, const float* __restrict__ b2,
               float* __restrict__ gate, int C, int R) {
  extern __shared__ float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), b = blockIdx.y;
  const int tid = threadIdx.x;
  const int cc = carla::ceil_div(C, SE_CLUSTER);
  const int rc = carla::ceil_div(R, SE_CLUSTER);
  const int c_lo = rank * cc, c_hi = min(C, c_lo + cc);
  const int r_lo = rank * rc, r_hi = min(R, r_lo + rc);
  float* mean = sm;           // [C]: the whole mean, gathered
  float* part = mean + C;     // [cc]: this block's slice of it
  float* hid = part + cc;     // [R]: the whole h, gathered
  float* hpart = hid + R;     // [rc]: this block's slice of it
  float* red = hpart + rc;    // [SE_THREADS]: the threads' parts
  const int nc = c_hi > c_lo ? c_hi - c_lo : 0;
  const int nr = r_hi > r_lo ? r_hi - r_lo : 0;
  const auto one = [](int) { return 1.f; };

  // before the wait: this block's weight lines are asked of the L2 (W1's
  // rows hold its slice in one or two lines each, W2's rows of its slice
  // are whole lines)
  constexpr int LINE = 128;
  const int ebytes = (int)sizeof(T);
  const int w2_lines = nc ? (nc * ebytes + LINE - 1) / LINE + 1 : 0;
  for (int i = tid; i < (nr ? 2 * C : 0) + R * w2_lines; i += SE_THREADS) {
    const char* p;
    if (i < (nr ? 2 * C : 0))
      p = reinterpret_cast<const char*>(w1 + (int64_t)(i / 2) * R + r_lo) +
          (i % 2) * (nr - 1) * ebytes;
    else {
      const int e = i - (nr ? 2 * C : 0), j = e / w2_lines;
      const char* row = reinterpret_cast<const char*>(w2 + (int64_t)j * C);
      p = row + min(c_lo * ebytes + (e % w2_lines) * LINE,
                    (c_hi - 1) * ebytes);
    }
    carla::prefetch_l2(p);
  }
  carla::grid_dependency_wait();

  // this block's channels of the mean: thread (k, g) adds tiles g, g + G..
  const float* src = sums + (int64_t)b * tiles * C + c_lo;
  int groups = nc ? max(1, min(tiles, SE_THREADS / nc)) : 1;
  if (nc && tid < nc * groups) {
    const float* col = src + tid % nc;
    red[tid] = batched_dot(tid / nc, groups, tiles, one,
                           [&](int t) { return col[(int64_t)t * C]; });
  }
  add_parts(red, groups, nc, part);
  for (int k = tid; k < nc; k += SE_THREADS) part[k] /= (float)npix;
  cluster.sync();
  for (int c = tid; c < C; c += SE_THREADS)
    mean[c] = cluster.map_shared_rank(part, c / cc)[c % cc];
  __syncthreads();

  // this block's slice of h: thread (k, g) adds channels g, g + G..
  groups = nr ? max(1, min(C, SE_THREADS / nr)) : 1;
  if (nr && tid < nr * groups) {
    const T* col = w1 + r_lo + tid % nr;
    red[tid] = batched_dot(
        tid / nr, groups, C, [&](int c) { return mean[c]; },
        [&](int c) { return carla::to_f32(__ldg(col + (int64_t)c * R)); });
  }
  add_parts(red, groups, nr, hpart);
  for (int k = tid; k < nr; k += SE_THREADS) {
    const float y = hpart[k] + b1[r_lo + k];
    hpart[k] = y / (1.f + expf(-y));
  }
  cluster.sync();
  for (int j = tid; j < R; j += SE_THREADS)
    hid[j] = cluster.map_shared_rank(hpart, j / rc)[j % rc];
  // every block has read its peers' slices (no block leaves while a peer
  // reads it), and this block's h is whole
  cluster.sync();

  // this block's gates: thread (k, g) adds h's outputs g, g + G..
  groups = nc ? max(1, min(R, SE_THREADS / nc)) : 1;
  if (nc && tid < nc * groups) {
    const T* col = w2 + c_lo + tid % nc;
    red[tid] = batched_dot(
        tid / nc, groups, R, [&](int j) { return hid[j]; },
        [&](int j) { return carla::to_f32(__ldg(col + (int64_t)j * C)); });
  }
  add_parts(red, groups, nc, part);
  for (int k = tid; k < nc; k += SE_THREADS)
    gate[(int64_t)b * C + c_lo + k] =
        1.f / (1.f + expf(-(part[k] + b2[c_lo + k])));
}

// The gate applied in a pass of its own: out[b, p, c] = x[b, p, c] *
// gate[b, c] over a (B, npix, C) map, one product an element rounded to x's
// type (out may be x). A thread a 16-byte vector of channels (V values).
// It waits for the gate, then lets the projection after it be placed, which
// asks the L2 for its weights while this pass runs.
constexpr int SCALE_THREADS = 256;
constexpr int SCALE_BLOCKS_MAX = 4096;

template <typename T, int V>
__global__ void __launch_bounds__(SCALE_THREADS)
se_scale_kernel(const T* x, const float* __restrict__ gate, T* out,
                int npix, int C, int64_t vecs) {
  carla::grid_dependency_wait();
  carla::grid_dependents_launch();
  const int64_t plane = (int64_t)npix * C;
  for (int64_t v = (int64_t)blockIdx.x * SCALE_THREADS + threadIdx.x;
       v < vecs; v += (int64_t)gridDim.x * SCALE_THREADS) {
    const int64_t e = v * V;
    const float* g = gate + (e / plane) * C + (int)(e % C);
    float f[V];
    if constexpr (V == 1)
      f[0] = carla::to_f32(x[e]);
    else
      carla::load16(x + e, f);
#pragma unroll
    for (int u = 0; u < V; ++u) f[u] *= g[u];
    if constexpr (V == 1)
      out[e] = carla::from_f32<T>(f[0]);
    else
      carla::store16(out + e, f);
  }
}

template <typename T>
int scale_t(const void* x, const float* gate, void* out, int64_t n, int C,
            int npix, cudaStream_t st) {
  constexpr int VEC = carla::Vec16<T>::N;
  const bool vec = C % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t vecs = vec ? n / VEC : n;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)std::min<int64_t>(
      SCALE_BLOCKS_MAX, (vecs + SCALE_THREADS - 1) / SCALE_THREADS));
  cfg.blockDim = dim3(SCALE_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const cudaError_t err =
      vec ? cudaLaunchKernelEx(&cfg, se_scale_kernel<T, VEC>, xp, gate, op,
                               npix, C, vecs)
          : cudaLaunchKernelEx(&cfg, se_scale_kernel<T, 1>, xp, gate, op,
                               npix, C, vecs);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// A programmatic dependent launch (the file's header); under stream capture,
// a programmatic edge.
template <typename T>
int launch_t(const float* sums, int tiles, int npix, const void* w1,
             const float* b1, const void* w2, const float* b2, float* gate,
             int B, int C, int R, size_t smem, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(SE_CLUSTER, B);
  cfg.blockDim = dim3(SE_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, se_gate_kernel<T>, sums, tiles, npix, static_cast<const T*>(w1),
      b1, static_cast<const T*>(w2), b2, gate, C, R);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, the type of w1 (C, R) and w2 (R, C);
// sums fp32 (B, tiles, C) as dwconv.cu writes them for a map of npix
// pixels; b1 (R,), b2 (C,) and gate (B, C) fp32. Returns cudaGetLastError()
// (cudaErrorInvalidValue for sizes the kernel does not take).
extern "C" int carla_se_gate(int dtype, const void* sums, const void* w1,
                             const void* b1, const void* w2, const void* b2,
                             void* gate, int B, int tiles, int npix, int C,
                             int R, void* stream) {
  const size_t smem =
      sizeof(float) * (C + carla::ceil_div(C, SE_CLUSTER) + R +
                       carla::ceil_div(R, SE_CLUSTER) + SE_THREADS);
  if (B < 0 || B > 65535 || tiles < 1 || npix < 1 || C < 1 || R < 1 ||
      carla::ceil_div(C, SE_CLUSTER) > SE_THREADS ||
      carla::ceil_div(R, SE_CLUSTER) > SE_THREADS || smem > SE_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const float* s = static_cast<const float*>(sums);
  const float* p1 = static_cast<const float*>(b1);
  const float* p2 = static_cast<const float*>(b2);
  float* g = static_cast<float*>(gate);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(s, tiles, npix, w1, p1, w2, p2, g, B, C, R, smem,
                           st);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(s, tiles, npix, w1, p1, w2, p2, g, B, C,
                                   R, smem, st);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16, the type of x and out (B, npix, C);
// gate fp32 (B, C). out = x * gate per image and channel; out may be x.
// Returns cudaGetLastError() (cudaErrorInvalidValue for sizes the kernel
// does not take).
extern "C" int carla_se_scale(int dtype, const void* x, const void* gate,
                              void* out, int B, int npix, int C,
                              void* stream) {
  if (B < 0 || npix < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)B * npix * C;
  if (n == 0) return 0;
  const float* g = static_cast<const float*>(gate);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return scale_t<float>(x, g, out, n, C, npix, st);
  if (dtype == 1) return scale_t<__nv_bfloat16>(x, g, out, n, C, npix, st);
  return (int)cudaErrorInvalidValue;
}
