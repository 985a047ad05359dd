// K4: the SMC weight pipeline in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel lhvi_tpu/ops/resample.py::_weights_kernel (:48).
// From unnormalized log-weights lw [N]:
//   M = max lw, S = sum exp(lw - M), step_z = M + log S,
//   lwn = lw - step_z, w^ = exp(lw - M) / S, ess = 1 / sum w^2,
//   cum = inclusive cumulative sum of w^ (cum[N-1] = 1 to f32 rounding).
//
// What bounds it on the H100. The compulsory traffic is 12 bytes an
// element (lw in; lwn and cum out): 768 KB at N = 65,536, a quarter of a
// microsecond of HBM time, and one exp per element is less still. What
// costs is latency: the launch, a round trip to memory, and the barriers
// between the dependent steps (max -> sums -> scan). The first design ran
// them as three passes over lw in ONE block of 1,024 threads, on one SM of
// 132 (0.09-0.11 ms at 65,536). This one reads lw once, spread over up to
// 16 SMs, and joins the blocks through a thread-block cluster's
// distributed shared memory. What is left of a call at the SMC sizes is
// mostly fixed: the launch, the barriers and the wrapper's host time
// (PERF.md §6).
//
// Cluster layout (N <= 16 x 1,024 x 16 = 262,144). One cluster of S <= 16
// blocks of T threads; ops/resample.py::k4_launch picks S, T and E, and the
// launcher checks that they cover N and that the card can place the
// cluster (cudaOccupancyMaxActiveClusters; above 8 blocks the non-portable
// size). Thread t of block b holds the E consecutive elements from
// (b*T + t)*E in registers, read once (16-byte loads where aligned).
//   - Block b forms its max m_b, then w = exp(x - m_b) in f32 and, in
//     double, s_b = sum w, s2_b = sum w^2 and the block-local inclusive
//     scan of w: each thread's own E in order, warp shuffles, then one warp
//     over the warp totals.
//   - (m_b, s_b, s2_b) go into shared memory; one cluster barrier; warp 0 of
//     every block reads the S triples through distributed shared memory
//     (lane r reads rank r) and forms M = max m_r, S = sum s_r e^(m_r - M),
//     S2 = sum s2_r e^(2(m_r - M)) and its block's exclusive prefix P_b,
//     all with one fixed shuffle tree over the ranks, so every block gets
//     the same bits.
//   - cum_i = (P_b + incl_i e^(m_b - M)) / S; lwn_i = x_i - (M + log S),
//     formed in double and rounded once; block 0 writes step_z and
//     ess = S^2 / S2.
//   - The second cluster barrier is split: every block arrives once its
//     remote reads are done and waits just before it exits, so no block's
//     shared memory goes while a peer reads it, and the stores overlap the
//     wait. One read of lw, one write of each output, two cluster barriers.
// The rescaling by e^(m_b - M) is applied in double to sums of f32 exps
// taken against the block's own max; the variant that exchanges the maxima
// first (a third barrier) was not needed: the card tests and chip_smoke.py
// hold both layouts to the plain version at its tolerances.
//
// Grid layout (any N; k4_launch takes it past the cluster's capacity). One
// cooperative launch of a persistent grid of G blocks of 512 threads, each
// owning a contiguous range of R elements (R a multiple of 4). Phase 1: the
// range's max, then its sums of w = exp(x - m_b) (a second read, from
// L1/L2); the triple goes to global scratch, then one grid barrier (an
// atomic counter, as K1's cooperative layout; post-barrier loads through
// L2 with __ldcg). Phase 2: warp 0 reads the G triples in rank order, and
// the block scans its range again in chunks of 2,048 with a carry, using
// the same exps as phase 1, so the block totals behind P_b and the scan
// agree to double rounding. Still one launch, as in the reference.
//
// Reproducible: every sum's order depends only on N and the geometry,
// never on scheduling; there are no atomics on the data path (the grid
// barrier's counter carries no data). Two launches give the same bits.
// Sums and the scan are accumulated in double and stored as f32; step_z
// and ess go to a 2-float device buffer, so nothing is read back to the
// host.
//
// A log-weight of -inf (a particle with zero weight) gives lwn = -inf, a
// zero weight and a flat cum; a block whose elements are all -inf adds
// nothing (its max is taken as 0 for the subtraction). A vector that is
// -inf everywhere is outside the contract, as in the reference (NaN).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_util.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;  // cluster layout: threads of a block
constexpr int kMaxCluster = 16;    // past 8: the non-portable size
constexpr int kGridThreads = 512;  // grid layout
constexpr int kGridPer = 4;        // grid layout: elements a thread a chunk

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// E (a multiple of 4) consecutive elements from i0; -inf at i >= n.
template <int E>
__device__ __forceinline__ void load_run(const float* lw, long long i0,
                                         long long n, float (&x)[E]) {
  if (i0 + E <= n && aligned16(lw + i0)) {
#pragma unroll
    for (int k = 0; k < E; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(lw + i0 + k);
      x[k] = v.x;
      x[k + 1] = v.y;
      x[k + 2] = v.z;
      x[k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k) x[k] = i0 + k < n ? lw[i0 + k] : -INFINITY;
  }
}

template <int E>
__device__ __forceinline__ void store_run(float* out, long long i0,
                                          long long n, const float (&v)[E]) {
  if (i0 + E <= n && aligned16(out + i0)) {
#pragma unroll
    for (int k = 0; k < E; k += 4)
      *reinterpret_cast<float4*>(out + i0 + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k)
      if (i0 + k < n) out[i0 + k] = v[k];
  }
}

// Block-wide max of one float a thread (valid in every thread). Called once
// a kernel, so `red` needs no barrier before it is written.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < warps ? red[lane] : -INFINITY;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t = fmaxf(t, __shfl_xor_sync(kFull, t, o));
  return t;
}

// Exclusive block-wide scan of t (one double a thread) and the block sums
// of t and t2, valid in every thread. Warp shuffles, then warp 0 over the
// warp totals in warp order. red: 98 doubles.
__device__ __forceinline__ void block_scan(double t, double t2, double* red,
                                           double* excl, double* total,
                                           double* total2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  double incl = t;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t2 += __shfl_xor_sync(kFull, t2, o);
  const double before = __shfl_up_sync(kFull, incl, 1);
  __syncthreads();  // red may still be read from an earlier call
  if (lane == 31) red[warp] = incl;
  if (lane == 0) red[32 + warp] = t2;
  __syncthreads();
  if (warp == 0) {
    const double a = lane < warps ? red[lane] : 0.0;
    double b = lane < warps ? red[32 + lane] : 0.0;
    double ai = a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(kFull, ai, o);
      if (lane >= o) ai += u;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) b += __shfl_xor_sync(kFull, b, o);
    const double prev = __shfl_up_sync(kFull, ai, 1);
    red[64 + lane] = lane == 0 ? 0.0 : prev;  // each warp's offset
    if (lane == 31) {
      red[96] = ai;
      red[97] = b;
    }
  }
  __syncthreads();
  *excl = red[64 + warp] + (lane == 0 ? 0.0 : before);
  *total = red[96];
  *total2 = red[97];
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---- cluster layout -------------------------------------------------------
template <int E>
__global__ void __launch_bounds__(kMaxThreads)
cluster_kernel(const float* __restrict__ lw, float* __restrict__ lwn,
               float* __restrict__ cum, float* __restrict__ stats, int n) {
  __shared__ float redf[32];
  __shared__ double red[98];
  __shared__ double pub[3];   // (m_b, s_b, s2_b), read by the whole cluster
  __shared__ double comb[4];  // step_z, 1/S, P_b, e^(m_b - M)
  cg::cluster_group cl = cg::this_cluster();
  const int b = (int)cl.block_rank();
  const long long i0 = ((long long)b * blockDim.x + threadIdx.x) * E;

  float x[E];
  load_run<E>(lw, i0, n, x);
  float m = x[0];
#pragma unroll
  for (int k = 1; k < E; ++k) m = fmaxf(m, x[k]);
  m = block_max(m, redf);
  const float ms = m == -INFINITY ? 0.f : m;  // all -inf: weights 0
  float w[E];
  double t = 0.0, t2 = 0.0;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    w[k] = expf(x[k] - ms);
    const double wd = (double)w[k];
    t += wd;
    t2 = fma(wd, wd, t2);
  }
  double excl, s_b, s2_b;
  block_scan(t, t2, red, &excl, &s_b, &s2_b);
  if (threadIdx.x == 0) {
    pub[0] = (double)m;
    pub[1] = s_b;
    pub[2] = s2_b;
  }
  cl.sync();  // every block's triple is published

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    double mr = -INFINITY, sr = 0.0, s2r = 0.0;
    if (lane < (int)cl.num_blocks()) {
      const double* p = cl.map_shared_rank(pub, (unsigned)lane);
      mr = p[0];
      sr = p[1];
      s2r = p[2];
    }
    double M = mr;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmax(M, __shfl_xor_sync(kFull, M, o));
    const double f = sr > 0.0 ? exp(mr - M) : 0.0;
    double incl = sr * f;
    double sq = s2r * f * f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(kFull, sq, o);
    const double total = __shfl_sync(kFull, incl, 31);
    const double prefix = __shfl_sync(kFull, incl, b > 0 ? b - 1 : 0);
    const double fb = __shfl_sync(kFull, f, b);
    if (lane == 0) {
      const double step_z = M + log(total);
      comb[0] = step_z;
      comb[1] = 1.0 / total;
      comb[2] = b > 0 ? prefix : 0.0;
      comb[3] = fb;
      if (b == 0) {
        stats[0] = (float)step_z;
        stats[1] = (float)(total * total / sq);
      }
    }
  }
  __syncthreads();
  cluster_arrive();  // this block's reads of its peers are done

  const double step_z = comb[0], inv_s = comb[1], pre = comb[2],
               fb = comb[3];
  float c[E], l[E];
  double r = excl;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    r += (double)w[k];
    c[k] = (float)((pre + r * fb) * inv_s);
    l[k] = (float)((double)x[k] - step_z);  // one rounding, not two
  }
  store_run<E>(cum, i0, n, c);
  store_run<E>(lwn, i0, n, l);
  cluster_wait();  // no block leaves while a peer may read its triple
}

// ---- grid layout ------------------------------------------------------------
struct GridArgs {
  const float* lw;
  float *lwn, *cum, *stats;
  double* part;   // [G][3] (m_b, s_b, s2_b)
  unsigned* bar;  // zeroed barrier word
  long long n, range;
};

// Every block of the (co-resident) grid arrives, then all go on.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (*reinterpret_cast<volatile unsigned*>(bar) < gridDim.x)
      __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kGridThreads, 2) grid_kernel(GridArgs a) {
  __shared__ float redf[32];
  __shared__ double red[98];
  __shared__ double comb[4];  // step_z, 1/S, P_b, e^(m_b - M)
  const int b = blockIdx.x, G = gridDim.x, tid = threadIdx.x;
  constexpr long long kChunk = (long long)kGridPer * kGridThreads;
  const long long lo = a.n < b * a.range ? a.n : b * a.range;
  const long long hi = a.n < lo + a.range ? a.n : lo + a.range;

  // phase 1: the range's max, then its sums against that max
  float m = -INFINITY;
  for (long long i = lo + kGridPer * tid; i < hi; i += kChunk) {
    float x[kGridPer];
    load_run<kGridPer>(a.lw, i, hi, x);
#pragma unroll
    for (int k = 0; k < kGridPer; ++k) m = fmaxf(m, x[k]);
  }
  m = block_max(m, redf);
  const float ms = m == -INFINITY ? 0.f : m;
  double s = 0.0, s2 = 0.0;
  for (long long i = lo + kGridPer * tid; i < hi; i += kChunk) {
    float x[kGridPer];
    load_run<kGridPer>(a.lw, i, hi, x);
#pragma unroll
    for (int k = 0; k < kGridPer; ++k) {
      const double wd = (double)expf(x[k] - ms);
      s += wd;
      s2 = fma(wd, wd, s2);
    }
  }
  double unused, s_b, s2_b;
  block_scan(s, s2, red, &unused, &s_b, &s2_b);
  if (tid == 0) {
    a.part[3 * b] = (double)m;
    a.part[3 * b + 1] = s_b;
    a.part[3 * b + 2] = s2_b;
  }
  grid_barrier(a.bar);

  // the G triples, in rank order: lane l takes ranks [l*q, (l+1)*q)
  if (tid < 32) {
    const int lane = tid, q = (G + 31) / 32;
    const int r0 = lane * q < G ? lane * q : G;
    const int r1 = r0 + q < G ? r0 + q : G;
    double M = -INFINITY;
    for (int r = r0; r < r1; ++r) M = fmax(M, __ldcg(a.part + 3 * r));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmax(M, __shfl_xor_sync(kFull, M, o));
    double acc = 0.0, sq = 0.0, own_pre = 0.0, own_f = 0.0;
    for (int r = r0; r < r1; ++r) {
      const double mr = __ldcg(a.part + 3 * r);
      const double sr = __ldcg(a.part + 3 * r + 1);
      const double s2r = __ldcg(a.part + 3 * r + 2);
      const double f = sr > 0.0 ? exp(mr - M) : 0.0;
      if (r == b) {
        own_pre = acc;
        own_f = f;
      }
      acc += sr * f;
      sq += s2r * f * f;
    }
    double incl = acc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(kFull, sq, o);
    const double before = __shfl_up_sync(kFull, incl, 1);
    const double total = __shfl_sync(kFull, incl, 31);
    if (lane == b / q) {
      const double step_z = M + log(total);
      comb[0] = step_z;
      comb[1] = 1.0 / total;
      comb[2] = (lane == 0 ? 0.0 : before) + own_pre;
      comb[3] = own_f;
      if (b == 0) {
        a.stats[0] = (float)step_z;
        a.stats[1] = (float)(total * total / sq);
      }
    }
  }
  __syncthreads();

  // phase 2: the range again, chunk by chunk, with a carry
  const double step_z = comb[0], inv_s = comb[1], pre = comb[2],
               fb = comb[3];
  double carry = 0.0;
  for (long long base = lo; base < hi; base += kChunk) {
    const long long i = base + kGridPer * tid;
    float x[kGridPer], w[kGridPer];
    load_run<kGridPer>(a.lw, i, hi, x);
    double t = 0.0;
#pragma unroll
    for (int k = 0; k < kGridPer; ++k) {
      w[k] = expf(x[k] - ms);
      t += (double)w[k];
    }
    double excl, chunk_total, unused2;
    block_scan(t, 0.0, red, &excl, &chunk_total, &unused2);
    float c[kGridPer], l[kGridPer];
    double r = carry + excl;
#pragma unroll
    for (int k = 0; k < kGridPer; ++k) {
      r += (double)w[k];
      c[k] = (float)((pre + r * fb) * inv_s);
      l[k] = (float)((double)x[k] - step_z);
    }
    store_run<kGridPer>(a.cum, i, hi, c);
    store_run<kGridPer>(a.lwn, i, hi, l);
    carry += chunk_total;
  }
}

template <int E>
int launch_cluster(int cluster, int threads, const float* lw, float* lwn,
                   float* cum, float* stats, int n, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;
  cudaError_t err =
      lhvi_cluster::clusters_that_fit(cluster_kernel<E>, &cfg, &fit);
  if (err != cudaSuccess) return (int)err;
  if (fit < 1) return (int)cudaErrorInvalidValue;  // refused, not shrunk
  err = cudaLaunchKernelEx(&cfg, cluster_kernel<E>, lw, lwn, cum, stats, n);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// layout 0 (cluster: `cluster` blocks of `threads`, `per_thread` elements a
// thread, grid == cluster) or 1 (grid: `grid` cooperative blocks of 512
// threads, 4 elements a thread a chunk, `scratch` from the wrapper: 6 floats
// a block for the triples, then a zeroed barrier word); the geometry from
// ops/resample.py::k4_launch, checked here: one that does not cover N or
// does not fit on the card returns cudaErrorInvalidValue.
extern "C" int lhvi_weight_pipeline(const float* lw, float* lwn, float* cum,
                                    float* stats, int n, int layout,
                                    int cluster, int threads, int per_thread,
                                    int grid, float* scratch, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == 0) {
    if (cluster < 1 || cluster > kMaxCluster || grid != cluster ||
        threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
        (long long)cluster * threads * per_thread < n)
      return (int)cudaErrorInvalidValue;
    switch (per_thread) {
#define K4_CASE(E)                                                        \
  case E:                                                                 \
    return launch_cluster<E>(cluster, threads, lw, lwn, cum, stats, n, s);
      K4_CASE(4) K4_CASE(8) K4_CASE(16)
#undef K4_CASE
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (layout != 1 || cluster != 1 || threads != kGridThreads ||
      per_thread != kGridPer || grid < 1 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_kernel,
                                                        kGridThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (grid > sms * per_sm) return (int)cudaErrorInvalidValue;
  const long long range = ((n + (long long)grid - 1) / grid + 3) / 4 * 4;
  GridArgs a{lw, lwn, cum, stats, reinterpret_cast<double*>(scratch),
             reinterpret_cast<unsigned*>(scratch + 6 * (size_t)grid),
             (long long)n, range};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)grid_kernel, dim3(grid),
                                    dim3(kGridThreads), args, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
