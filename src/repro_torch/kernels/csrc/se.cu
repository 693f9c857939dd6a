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
// What bounds it is latency: the mean, h and the gate each need the whole
// of the one before. A design that read the sums, then W1, then W2 after
// its wait, each a round trip to the L2 or device memory (1-2.5 us, probed
// with clock64 on the H100), and crossed three cluster barriers took 12.3-
// 12.8 us a gate at C 1536 alone, and 26,000 SM cycles after its wait in the
// replay of the net. So the design leaves one round trip to memory and one
// exchange between blocks after the depthwise conv before it ends:
// - Each image's gate is a cluster of SE_CLUSTER blocks; block r owns the
//   channels [c_lo, c_hi). The kernel is a programmatic dependent launch,
//   placed as the depthwise conv before it starts (dwconv.cu). The weights
//   are no kernel's output, so before its griddepcontrol.wait each block
//   copies its rows of W1 (one run in memory) and its columns of W2 (R runs)
//   into its shared memory, in the weights' type, and its biases: bulk
//   copies (cp.async.bulk on an mbarrier) where every run is whole 16-byte
//   pieces, as at every gate of EfficientNetV2-S in fp32 and bf16, plain
//   copies otherwise. They land while the depthwise conv runs.
// - After the wait it reads memory once, its channels' tile sums, and adds
//   them into its slice of the mean. h's pre-activation is linear in the
//   mean, so each block multiplies its slice of the mean by its rows of W1:
//   a partial sum for every output of h. One cluster barrier; then every
//   block reads the SE_CLUSTER partials of each output from its peers'
//   shared memory (distributed shared memory), adds them in rank order, b1
//   and SiLU, so h is whole in every block with no second exchange, and
//   computes its channels' gates from its columns of W2. A split cluster
//   barrier (arrive after the peers' reads, wait before exit) keeps every
//   block until its peers have read it.
// - A reduction cuts its sum into runs of SE_RUN terms; a thread adds runs
//   with their loads in flight together, and one thread an output adds the
//   runs' parts in order after one barrier. Few instructions and barriers
//   matter here: in the replay, trees of barriers over 1024 threads took
//   about 2 us a reduction; runs, and 512 threads a block, took the time
//   after the wait from 17,000 to 10,300 SM cycles at C 1536 (PERF.md).
// - A gate whose slices do not fit a block's shared memory (the card's
//   opt-in limit: C 3840, R 160 in fp32 would take 600 KB a block) runs the
//   same algorithm on weights read from memory after the wait; before it,
//   each block asks the L2 for its lines of them (prefetch.global.L2, a
//   hint). kernels/se.py picks the instance from C, R and the weights' type
//   (STAGED); the entry point refuses a staged launch that does not fit.
// (Letting the projection after the gate be placed at the gate's start as
// well made that projection end 2.5 us later.)
#include <cooperative_groups.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "numeric.cuh"
#include "ptx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SE_CLUSTER = 8;
constexpr int SE_THREADS = 512;
constexpr int SE_RUN = 16;  // loads a thread keeps in flight
constexpr int SE_SMEM_DEFAULT = 48 * 1024;  // more only by opting in
constexpr int SE_DEVICES = 64;

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// A gate block's dynamic shared memory, offsets in bytes (kernels/se.py's
// smem_bytes counts the same): fp32 part [cc], b2s [cc], hp [R], hid [R],
// b1s [R] and red [SE_THREADS]; the mbarrier of the bulk copies; staged, its
// rows of W1 [cc][R] and its columns of W2 [R][cc] in the weights' type.
struct SeSmem {
  size_t bar, w1, w2, bytes;
};
__host__ __device__ inline SeSmem se_smem(int C, int R, size_t es,
                                          bool staged) {
  const size_t cc = carla::ceil_div(C, SE_CLUSTER);
  const size_t bar =
      align16(sizeof(float) * (2 * cc + 3 * (size_t)R + SE_THREADS));
  const size_t w1 = bar + 16, w2 = w1 + align16(cc * R * es);
  return {bar, w1, w2, staged ? w2 + align16(cc * R * es) : w1};
}

// Hopper's bulk copies (the Tensor Memory Accelerator) on a transaction
// barrier (mbarrier), as decode_attention.cu's: kept in this file, since
// ptx.cuh's hash is carried by the tuned tables.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   carla::smem_addr(bar))
               : "memory");
}
// Makes the barrier's initialisation visible to the bulk copies.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// The one arrival of a phase, which also expects `bytes` of copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          carla::smem_addr(bar)),
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
      "}\n" ::"r"(carla::smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// bytes (a multiple of 16, both ends 16-byte aligned) from src to this
// block's dst, counted on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(carla::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(carla::smem_addr(bar))
      : "memory");
}

// out[k] = sum over i < n of a(i) * w(i, k), for k < width. The i are cut
// into runs of SE_RUN; thread (k, g), g < G, adds runs g, g + G, .., in
// order, each run's SE_RUN loads issued before its adds (past the end at
// the last index, masked in the sum: loads under a predicate each were
// issued one after the other); then thread k adds the G parts in order.
// Thread k % SE_THREADS writes out[k], and no barrier follows.
template <class A, class W>
__device__ __forceinline__ void dot_cols(int n, int width, A a, W w,
                                         float* red, float* out) {
  const int runs = carla::ceil_div(n, SE_RUN);
  const int groups = width ? max(1, min(runs, SE_THREADS / width)) : 1;
  for (int e = threadIdx.x; e < width * groups; e += SE_THREADS) {
    const int k = e % width;
    float s = 0.f;
    for (int r = e / width; r < runs; r += groups) {
      const int i0 = r * SE_RUN;
      float v[SE_RUN];
#pragma unroll
      for (int u = 0; u < SE_RUN; ++u) v[u] = w(min(i0 + u, n - 1), k);
#pragma unroll
      for (int u = 0; u < SE_RUN; ++u)
        if (i0 + u < n) s = fmaf(a(i0 + u), v[u], s);
    }
    (groups == 1 ? out : red)[e] = s;
  }
  if (groups == 1) return;
  __syncthreads();
  for (int k = threadIdx.x; k < width; k += SE_THREADS) {
    float s = red[k];
    for (int g = 1; g < groups; ++g) s += red[g * width + k];
    out[k] = s;
  }
}

template <typename T, bool STAGED>
__global__ void __cluster_dims__(SE_CLUSTER, 1, 1)
    __launch_bounds__(SE_THREADS)
se_gate_kernel(const float* __restrict__ sums, int tiles, int npix,
               const T* __restrict__ w1, const float* __restrict__ b1,
               const T* __restrict__ w2, const float* __restrict__ b2,
               float* __restrict__ gate, int C, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), b = blockIdx.y;
  const int tid = threadIdx.x;
  constexpr int es = (int)sizeof(T);
  const SeSmem at = se_smem(C, R, es, STAGED);
  const int cc = carla::ceil_div(C, SE_CLUSTER);
  const int c_lo = min(C, rank * cc), nc = min(C, c_lo + cc) - c_lo;
  float* part = reinterpret_cast<float*>(smem);  // [cc]: its slice of the
                                                 // mean, then of the gate
  float* b2s = part + cc;  // [cc]
  float* hp = b2s + cc;    // [R]: its partials of h's pre-activation
  float* hid = hp + R;     // [R]: h, whole
  float* b1s = hid + R;    // [R]
  float* red = b1s + R;    // [SE_THREADS]: the threads' parts
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + at.bar);
  T* w1s = reinterpret_cast<T*>(smem + at.w1);  // [nc][R], as in memory
  T* w2s = reinterpret_cast<T*>(smem + at.w2);  // [R][cc]: rows of nc
  const T* w1g = w1 + (int64_t)c_lo * R;        // its rows of W1
  const T* w2g = w2 + c_lo;                     // its columns of W2

  // before the wait: what no kernel writes
  for (int k = tid; k < nc; k += SE_THREADS) b2s[k] = b2[c_lo + k];
  for (int j = tid; j < R; j += SE_THREADS) b1s[j] = b1[j];
  bool bulk = false;
  if constexpr (STAGED) {
    constexpr int vec = 16 / es;
    bulk = ((reinterpret_cast<uintptr_t>(w1) |
             reinterpret_cast<uintptr_t>(w2)) % 16 |
            C % vec | cc % vec | nc % vec) == 0;
    if (bulk) {
      if (tid == 0) {
        mbar_init(bar);
        mbar_init_fence();
      }
      __syncthreads();
      if (tid < 32) {
        if (tid == 0) mbar_expect(bar, (uint32_t)(2 * nc * R * es));
        __syncwarp();
        if (nc) {
          if (tid == 0) bulk_copy(w1s, w1g, (uint32_t)(nc * R * es), bar);
          for (int j = tid; j < R; j += 32)
            bulk_copy(w2s + j * cc, w2g + (int64_t)j * C,
                      (uint32_t)(nc * es), bar);
        }
      }
    } else {
      for (int i = tid; i < nc * R; i += SE_THREADS) w1s[i] = w1g[i];
      for (int i = tid; i < R * nc; i += SE_THREADS) {
        const int j = i / nc, k = i - j * nc;
        w2s[j * cc + k] = w2g[(int64_t)j * C + k];
      }
    }
  } else {
    // its lines of the weights asked of the L2: W1's rows one run, W2's
    // columns R runs (a run of n bytes lies in n / LINE + 2 lines at most)
    constexpr int LINE = 128;
    const int n1 = nc * R * es, n2 = nc * es;
    const int l1 = n1 ? n1 / LINE + 2 : 0, l2 = n2 ? n2 / LINE + 2 : 0;
    const char* p1 = reinterpret_cast<const char*>(w1g);
    for (int i = tid; i < l1 + R * l2; i += SE_THREADS) {
      if (i < l1) {
        carla::prefetch_l2(p1 + min(i * LINE, n1 - 1));
      } else {
        const int e = i - l1, j = e / l2;
        const char* row = reinterpret_cast<const char*>(w2g + (int64_t)j * C);
        carla::prefetch_l2(row + min((e - j * l2) * LINE, n2 - 1));
      }
    }
  }
  carla::grid_dependency_wait();

  // its slice of the mean, a channel's tiles in order
  const float* src = sums + (int64_t)b * tiles * C + c_lo;
  dot_cols(
      tiles, nc, [](int) { return 1.f; },
      [&](int t, int k) { return src[(int64_t)t * C + k]; }, red, part);
  for (int k = tid; k < nc; k += SE_THREADS) part[k] /= (float)npix;
  if (bulk) mbar_wait(bar, 0);
  __syncthreads();

  // its partials of h's pre-activation, over its channels in order; its
  // rows of W1 and columns of W2 from shared memory, or from memory in the
  // instance that does not stage them
  const auto w1_at = [&](int k, int j) {
    if constexpr (STAGED)
      return carla::to_f32(w1s[k * R + j]);
    else
      return carla::to_f32(__ldg(w1g + (int64_t)k * R + j));
  };
  const auto w2_at = [&](int j, int k) {
    if constexpr (STAGED)
      return carla::to_f32(w2s[j * cc + k]);
    else
      return carla::to_f32(__ldg(w2g + (int64_t)j * C + k));
  };
  dot_cols(nc, R, [&](int k) { return part[k]; }, w1_at, red, hp);
  cluster.sync();

  // h, whole: each output's partials in rank order, b1, SiLU
  for (int j = tid; j < R; j += SE_THREADS) {
    float p[SE_CLUSTER];
#pragma unroll
    for (int r = 0; r < SE_CLUSTER; ++r)
      p[r] = cluster.map_shared_rank(hp, r)[j];
    float y = 0.f;
#pragma unroll
    for (int r = 0; r < SE_CLUSTER; ++r) y += p[r];
    y += b1s[j];
    hid[j] = y / (1.f + expf(-y));
  }
  // this block is done with its peers; its wait below holds it until they
  // are done with it
  carla::cluster_arrive();
  __syncthreads();

  // its gates, over h's outputs in order
  dot_cols(R, nc, [&](int j) { return hid[j]; }, w2_at, red, part);
  for (int k = tid; k < nc; k += SE_THREADS)
    gate[(int64_t)b * C + c_lo + k] = 1.f / (1.f + expf(-(part[k] + b2s[k])));
  carla::cluster_wait();
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

// The card's opt-in limit of shared memory a block, on the current device.
cudaError_t smem_limit(int* bytes) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

// A programmatic dependent launch (the file's header); under stream capture,
// a programmatic edge. An instance that needs more than SE_SMEM_DEFAULT
// bytes opts in to the card's limit once a device, before its first launch
// there.
template <typename T, bool STAGED>
int launch_t(const float* sums, int tiles, int npix, const void* w1,
             const float* b1, const void* w2, const float* b2, float* gate,
             int B, int C, int R, size_t smem, int limit, cudaStream_t st) {
  auto kernel = se_gate_kernel<T, STAGED>;
  if (smem > SE_SMEM_DEFAULT) {
    static std::atomic<uint64_t> opted{0};  // a bit a device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    const bool done =
        dev < SE_DEVICES && (opted.load(std::memory_order_relaxed) >> dev & 1);
    if (err == cudaSuccess && !done) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
      if (err == cudaSuccess && dev < SE_DEVICES)
        opted.fetch_or(uint64_t{1} << dev, std::memory_order_relaxed);
    }
    if (err != cudaSuccess) return (int)err;
  }
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
      &cfg, kernel, sums, tiles, npix, static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, gate, C, R);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <typename T>
int gate_t(const float* sums, int tiles, int npix, const void* w1,
           const float* b1, const void* w2, const float* b2, float* gate,
           int B, int C, int R, bool staged, cudaStream_t st) {
  int limit = 0;
  const cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = se_smem(C, R, sizeof(T), staged).bytes;
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  return staged ? launch_t<T, true>(sums, tiles, npix, w1, b1, w2, b2, gate,
                                    B, C, R, smem, limit, st)
                : launch_t<T, false>(sums, tiles, npix, w1, b1, w2, b2, gate,
                                     B, C, R, smem, limit, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, the type of w1 (C, R) and w2 (R, C);
// sums fp32 (B, tiles, C) as dwconv.cu writes them for a map of npix
// pixels; b1 (R,), b2 (C,) and gate (B, C) fp32. staged: 1 for the instance
// that holds each block's slices of the weights in shared memory (the
// file's header), 0 for the one that reads them from memory. Returns
// cudaGetLastError() (cudaErrorInvalidValue for sizes the kernel does not
// take, a staged instance whose slices do not fit among them).
extern "C" int carla_se_gate(int dtype, const void* sums, const void* w1,
                             const void* b1, const void* w2, const void* b2,
                             void* gate, int B, int tiles, int npix, int C,
                             int R, int staged, void* stream) {
  if (B < 0 || B > 65535 || tiles < 1 || npix < 1 || C < 1 || R < 1 ||
      (staged != 0 && staged != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const float* s = static_cast<const float*>(sums);
  const float* p1 = static_cast<const float*>(b1);
  const float* p2 = static_cast<const float*>(b2);
  float* g = static_cast<float*>(gate);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gate_t<float>(s, tiles, npix, w1, p1, w2, p2, g, B, C, R, staged,
                         st);
  if (dtype == 1)
    return gate_t<__nv_bfloat16>(s, tiles, npix, w1, p1, w2, p2, g, B, C, R,
                                 staged, st);
  return (int)cudaErrorInvalidValue;
}

// The opt-in limit of shared memory a block on device `device`, in bytes,
// written to *bytes (an int). Returns the CUDA error of the query.
extern "C" int carla_se_smem_limit(int device, void* bytes) {
  return (int)cudaDeviceGetAttribute(static_cast<int*>(bytes),
                                     cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                     device);
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
