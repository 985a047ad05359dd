// K4: the SMC weight pipeline in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel lhvi_tpu/ops/resample.py::_weights_kernel (:48).
// From unnormalized log-weights lw [N]:
//   m = max lw, s = sum exp(lw - m), step_z = m + log s,
//   lwn = lw - step_z, w^ = exp(lw - m) / s, ess = 1 / sum w^2,
//   cum = inclusive cumulative sum of w^ (cum[N-1] = 1 to f32 rounding).
//
// What bounds it on the H100. At the bench size (N = 65,536) the vector is
// 256 KB in and 512 KB out: a few microseconds of HBM time, and the
// arithmetic (one exp per element per pass) is smaller still. What costs is
// the launch and the chain of block-wide barriers between the dependent
// steps (max -> sum -> scan); the reference had the same shape (one VMEM
// pass replacing five small XLA kernels). So one block does everything and
// the [N] vector stays in L2 between passes; there is no second launch and
// no inter-block sync.
//
// Design. One block of 1,024 threads. Passes 1-2 (max, then the sums of
// w and w^2) stride over lw so that neighbouring threads read neighbouring
// words. Pass 3 walks the vector in 4,096-element chunks: each thread
// scans its 4 neighbouring elements, a block-wide exclusive scan (warp
// shuffles, then one warp over the 32 warp totals) gives its offset within
// the chunk, a running carry the chunk's offset, and the thread writes lwn
// and the inclusive sums. (A first version gave each thread one
// contiguous run of N/1,024 elements: its loads were 64 words apart
// across a warp, and the kernel took 0.23 ms at N = 65,536, twice the
// plain version.) Sums and the scan are
// accumulated in double and stored as f32, so cum[N-1] is 1 to f32
// rounding and the ESS is not lost to cancellation; step_z and lwn are
// formed in double and rounded once. step_z and ess are
// written to a 2-float device buffer: nothing is read back to the host.
// Triton would also express this reduction and scan; CUDA C++ keeps the
// port's one build route (ops/_build.py, ctypes, no Triton import).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                    // scan: elements per thread per chunk
constexpr int kChunk = kThreads * kPer;

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[lane];  // kWarps == 32: every lane holds one warp's value
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, o));
  return t;  // valid in every thread
}

__device__ __forceinline__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double t = red[lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;  // valid in every thread
}

// Exclusive block-wide scan of one double per thread; *total gets the
// block's sum (valid in every thread).
__device__ __forceinline__ double block_exclusive_scan(double v, double* red,
                                                       double* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    double u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  __syncthreads();  // red may still be read from a previous call
  if (lane == 31) red[warp] = incl;  // warp totals
  __syncthreads();
  if (warp == 0) {
    double t = red[lane];
    double ti = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      double u = __shfl_up_sync(0xffffffffu, ti, o);
      if (lane >= o) ti += u;
    }
    red[lane] = ti - t;  // exclusive offset of each warp
    if (lane == 31) red[kWarps] = ti;
  }
  __syncthreads();
  *total = red[kWarps];
  return red[warp] + incl - v;
}

__global__ void __launch_bounds__(kThreads)
weights_kernel(const float* __restrict__ lw, float* __restrict__ lwn,
               float* __restrict__ cum, float* __restrict__ stats, int n) {
  __shared__ float redf[kWarps];
  __shared__ double redd[kWarps + 1];
  const int tid = threadIdx.x;

  float m = -INFINITY;
  for (int i = tid; i < n; i += kThreads) m = fmaxf(m, lw[i]);
  m = block_max(m, redf);

  double s = 0.0, s2 = 0.0;
  for (int i = tid; i < n; i += kThreads) {
    double w = (double)expf(lw[i] - m);
    s += w;
    s2 += w * w;
  }
  s = block_sum(s, redd);
  s2 = block_sum(s2, redd);
  const double step_z = (double)m + log(s);
  const double inv_s = 1.0 / s;

  // the scan, chunk by chunk: thread t owns elements 4t..4t+3 of each
  // 4,096-element chunk (a warp covers 128 neighbouring words)
  double carry = 0.0;
  for (int base = 0; base < n; base += kChunk) {
    const int i0 = base + kPer * tid;
    float x[kPer];
    double run[kPer];
    double t = 0.0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = i0 + k;
      x[k] = i < n ? lw[i] : -INFINITY;
      t += (double)expf(x[k] - m) * inv_s;  // 0 past n
      run[k] = t;
    }
    double chunk_total;
    const double off = carry + block_exclusive_scan(t, redd, &chunk_total);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = i0 + k;
      if (i < n) {
        cum[i] = (float)(off + run[k]);
        lwn[i] = (float)((double)x[k] - step_z);  // one rounding, not two
      }
    }
    carry += chunk_total;
  }
  if (tid == 0) {
    stats[0] = (float)step_z;
    stats[1] = (float)(s * s / s2);  // 1 / sum (w/s)^2
  }
}

}  // namespace

extern "C" int lhvi_weight_pipeline(const float* lw, float* lwn, float* cum,
                                    float* stats, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  weights_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lw, lwn, cum, stats, n);
  return (int)cudaGetLastError();
}
