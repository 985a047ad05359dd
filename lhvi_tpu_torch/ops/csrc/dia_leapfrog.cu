// K6: position-Verlet on a banded (DIA) quadratic target from given
// positions and momenta, for Hopper (sm_90a).
//
// Replaces the TPU kernel lhvi_tpu/ops/dia.py::_dia_leapfrog_kernel (:184).
// In embedded coordinates, per chain: g0 = h - J x, m = p + 1/2 eps g0;
// n_steps - 1 times x += eps im m, m += eps (h - J x); a last drift; then
// p1 = m + 1/2 eps g1, with J x = diag*x + sum_k w_k * x[i + o_k]. Returns
// x1, p1 [C, n] and the endpoint log-potentials lp = 1/2 sum x(h + g)
// (without the constant) [C]. n_steps == 0 returns x and p unchanged and
// lp0 twice.
//
// What bounds it on the H100. At the 128x128 grid (n_emb = 16,384 lanes,
// K = 4 offsets, C = 1,024 chains, 8 steps) the call must move x and p in
// and x1 and p1 out, 4 x 64 MB = 268 MB (~80 us at 3.35 TB/s), against
// 2(K+1) flops per lane per matvec over 9 matvecs, 1.5 GFLOP (~23 us at 67
// TFLOP/s f32): the bound is memory traffic. The lane constants (K+3 rows
// of n_emb floats, 0.4 MB) stay in L2.
//
// Design: K2 (dia_proposal.cu) without the momentum draw and the accept;
// the trajectory body is the one K2 runs (dia_traj.cuh). One block of
// 1,024 threads owns one chain: its positions and momenta stay in shared
// memory for the whole trajectory (2 x 64 KB at that shape, up to 2 x
// 28,672 lanes), so device memory sees one read of x and p and one write
// of x1 and p1; the shifted reads are shared-memory loads, and each step
// costs two block barriers. The endpoint sums are accumulated in double
// and reduced in the block. Simple and right first: one chain per block
// leaves most of each SM's bandwidth unused (as in K2), which is the next
// thing to change.

#include <cuda_runtime.h>

#include "dia_traj.cuh"

namespace {

using lhvi_dia::kThreads;
using lhvi_dia::Offsets;

__global__ void __launch_bounds__(kThreads)
dia_leapfrog_kernel(const float* __restrict__ x,
                    const float* __restrict__ p,
                    const float* __restrict__ diag,
                    const float* __restrict__ wdia,
                    const float* __restrict__ h,
                    const float* __restrict__ im,
                    const float* __restrict__ eps_ptr,
                    float* __restrict__ xo, float* __restrict__ po,
                    float* __restrict__ lp0o, float* __restrict__ lp1o,
                    int n, int K, Offsets offs, int n_steps) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double red[32];
  float* xs = smem;      // [n] positions
  float* ms = smem + n;  // [n] momenta
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const float eps = *eps_ptr;
  const float* xrow = x + (size_t)c * n;
  const float* prow = p + (size_t)c * n;
  for (int i = tid; i < n; i += kThreads) {
    xs[i] = xrow[i];
    ms[i] = prow[i];
  }
  __syncthreads();

  double lp0 = 0.0, ke0 = 0.0;
  lhvi_dia::trajectory(xs, ms, n, diag, wdia, h, im, K, offs, eps, n_steps,
                       &lp0, &ke0);
  double lp1 = 0.0;
  float* xorow = xo + (size_t)c * n;
  float* porow = po + (size_t)c * n;
  for (int i = tid; i < n; i += kThreads) {
    porow[i] = lhvi_dia::end_lane(xs, ms, i, n, diag, wdia, h, K, offs, eps,
                                  n_steps, &lp1);
    xorow[i] = xs[i];
  }
  double s0 = lhvi_dia::block_sum(lp0, red);
  double s1 = lhvi_dia::block_sum(lp1, red);
  if (tid == 0) {
    lp0o[c] = (float)(0.5 * s0);
    lp1o[c] = (float)(0.5 * s1);
  }
}

}  // namespace

extern "C" int lhvi_dia_leapfrog(const float* x, const float* p,
                                 const float* diag, const float* wdia,
                                 const float* h, const float* im,
                                 const float* eps, float* xo, float* po,
                                 float* lp0, float* lp1, int C, int n, int K,
                                 const int* offsets, int n_steps,
                                 void* stream) {
  Offsets offs;
  size_t smem;
  int code = lhvi_dia::check_launch(C, n, K, offsets, n_steps, &offs, &smem);
  if (code != 0) return code;
  cudaError_t err = cudaFuncSetAttribute(
      dia_leapfrog_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dia_leapfrog_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, p, diag, wdia, h, im, eps, xo, po, lp0, lp1, n, K, offs, n_steps);
  return (int)cudaGetLastError();
}
