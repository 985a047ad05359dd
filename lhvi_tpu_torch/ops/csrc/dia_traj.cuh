// The banded (DIA) trajectory that K2 (dia_proposal.cu) and K6
// (dia_leapfrog.cu) share, so that the two kernels cannot drift apart.
//
// One block of kThreads threads owns one chain. Its positions xs and
// momenta ms live in shared memory for the whole trajectory; each lane i
// is owned by threads i, i + kThreads, ... so a lane's momentum is only
// ever touched by its owner. J x = diag*x + sum_k w_k * x[i + o_k], with the
// shifted index wrapped modulo the row width: a wrapped neighbour always
// meets a structural-zero weight (ops/dia.py::ell_to_dia asserts it), as
// in the reference's circular roll. lp = 1/2 sum x(h + g) with g = h - J x;
// per-thread partial sums are taken in double.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace lhvi_dia {

constexpr int kThreads = 1024;
constexpr int kMaxOffsets = 8;
constexpr int kSmemLimit = 227 * 1024;

struct Offsets {
  int o[kMaxOffsets];
};

// (J x)[i] on the chain's shared-memory row.
__device__ __forceinline__ float band_matvec(const float* xs, int i, int n,
                                             const float* __restrict__ diag,
                                             const float* __restrict__ wdia,
                                             int K, const Offsets& offs) {
  float y = diag[i] * xs[i];
  for (int k = 0; k < K; ++k) {
    int j = i + offs.o[k];
    if (j < 0) j += n; else if (j >= n) j -= n;
    y += wdia[(size_t)k * n + i] * xs[j];
  }
  return y;
}

__device__ __forceinline__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double t = 0.0;
  if (warp == 0) {
    t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
  }
  return t;  // valid in thread 0
}

// Position-Verlet from (xs, ms) = (x0, p0), both in shared memory and
// visible to the block (the caller's barrier). Adds this thread's lanes'
// x0(h + g0) to *lp0 and im*p0^2 to *ke0. On return, after a barrier, xs
// holds x1 and ms the momentum before the last half kick (p0 unchanged
// when n_steps == 0); end_lane finishes each lane.
__device__ __forceinline__ void trajectory(
    float* xs, float* ms, int n, const float* __restrict__ diag,
    const float* __restrict__ wdia, const float* __restrict__ h,
    const float* __restrict__ im, int K, const Offsets& offs, float eps,
    int n_steps, double* lp0, double* ke0) {
  const int tid = threadIdx.x;
  // start: lp0, ke0 and the first half-kick (positions are only read)
  for (int i = tid; i < n; i += kThreads) {
    float g = h[i] - band_matvec(xs, i, n, diag, wdia, K, offs);
    float m = ms[i];
    *lp0 += (double)(xs[i] * (h[i] + g));
    *ke0 += (double)(im[i] * m * m);
    if (n_steps > 0) ms[i] = m + 0.5f * eps * g;
  }
  if (n_steps > 0) {
    for (int s = 0; s < n_steps - 1; ++s) {
      __syncthreads();
      for (int i = tid; i < n; i += kThreads) xs[i] += eps * im[i] * ms[i];
      __syncthreads();
      for (int i = tid; i < n; i += kThreads) {
        float g = h[i] - band_matvec(xs, i, n, diag, wdia, K, offs);
        ms[i] += eps * g;
      }
    }
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) xs[i] += eps * im[i] * ms[i];
  }
  __syncthreads();
}

// Lane i's endpoint after trajectory(): returns p1 = m + 1/2 eps g1 and
// adds x1(h + g1) to *lp1. n_steps == 0 is the identity map: p1 is p0 and
// the endpoint term repeats the start's exactly.
__device__ __forceinline__ float end_lane(
    const float* xs, const float* ms, int i, int n,
    const float* __restrict__ diag, const float* __restrict__ wdia,
    const float* __restrict__ h, int K, const Offsets& offs, float eps,
    int n_steps, double* lp1) {
  float g = h[i] - band_matvec(xs, i, n, diag, wdia, K, offs);
  *lp1 += (double)(xs[i] * (h[i] + g));
  return n_steps > 0 ? ms[i] + 0.5f * eps * g : ms[i];
}

// Host-side checks shared by both launchers: argument ranges, the offsets
// (|o| < n keeps the single-wrap index arithmetic in range) and the
// dynamic shared memory of one chain's two rows. Returns a CUDA error code.
inline int check_launch(int C, int n, int K, const int* offsets, int n_steps,
                        Offsets* offs, size_t* smem) {
  if (C <= 0 || n <= 0 || n_steps < 0 || K < 0 || K > kMaxOffsets)
    return (int)cudaErrorInvalidValue;
  *offs = Offsets{};
  for (int k = 0; k < K; ++k) {
    if (offsets[k] <= -n || offsets[k] >= n) return (int)cudaErrorInvalidValue;
    offs->o[k] = offsets[k];
  }
  *smem = 2 * (size_t)n * sizeof(float);
  if (*smem > (size_t)kSmemLimit - 32 * sizeof(double))
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

}  // namespace lhvi_dia
