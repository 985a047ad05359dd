// K2: one whole HMC proposal on a banded (DIA) quadratic target, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel lhvi_tpu/ops/dia.py::_dia_proposal_kernel (:354).
// In embedded coordinates: momenta p0 = std * z (z standard normal, drawn
// in-kernel, or read from memory in test mode); position-Verlet with
// J x = diag*x + sum_k w_k * x[i + o_k]; lp = 1/2 sum x(h + g) at both
// ends; kinetic energies 1/2 sum im p^2; log_acc = min(0, dlp + dKE).
//
// What bounds it on the H100. At the bench shape (128x128 grid, n_emb =
// 16,384 lanes, C = 1,024 chains, 8 steps) the arithmetic is ~(K+1) FMAs
// per lane per matvec and 9 matvecs, ~1.5 GFLOP per call, against 128 MB
// of compulsory state traffic (x in, x1 out); the weights (K+4 rows of
// n_emb floats, 0.5 MB) stay in L2. So the proposal is bound by memory
// traffic and by the per-step block barriers, not by FLOPs. The
// reference pays for one [C, n_emb] momentum array in memory; drawing the
// momenta in-kernel removes it.
//
// Design. One block of 1,024 threads owns one chain for the whole
// trajectory (the body it shares with K6 is in dia_traj.cuh): the chain's
// positions and momenta stay in shared memory
// (2 x 64 KB at the bench shape, up to 2 x 28,672 lanes), so the shifted
// reads x[i + o_k] are shared-memory loads and device memory sees one
// read of x and one write of x1 per proposal. Shifted indices wrap modulo
// the row width, so every read is in bounds; a wrapped neighbour always
// meets a structural-zero weight (ops/dia.py::ell_to_dia asserts it), as
// in the reference's circular roll. Gap lanes (evidence positions) have
// inv_mass = 0 and std = 0: they draw zero momentum, never drift, and add
// nothing to the energies. The four per-chain sums reduce in the block,
// accumulated in double so that the energy difference is not lost to f32
// rounding of two ~1e5-sized sums.
//
// Momenta: counter-based Philox4x32-10 keyed by a 64-bit seed, with
// counter (lane quad, chain, offset): the stream for a (seed, offset,
// chain) is fixed and never shared. Each draw of four 32-bit words gives
// two paired Box-Muller normal pairs, from uniforms in (0, 1] so log()
// stays finite. Seed and offset are host values (ops/dia.py takes them
// from the caller's torch.Generator and advances it), so no device value
// is read back to seed a proposal. eps is read from device memory (dual
// averaging updates it on the device).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dia_traj.cuh"

namespace {

using lhvi_dia::kThreads;
using lhvi_dia::Offsets;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += W0;
    k.y += W1;
  }
  return c;
}

// 32 random bits -> uniform in (0, 1] (24-bit grid; never 0).
__device__ __forceinline__ float uniform_open0(uint32_t bits) {
  return (float)((bits >> 8) + 1u) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b,
                                           float* z0, float* z1) {
  float r = sqrtf(-2.0f * logf(uniform_open0(a)));
  float s, c;
  sincospif(2.0f * uniform_open0(b), &s, &c);
  *z0 = r * c;
  *z1 = r * s;
}

__global__ void __launch_bounds__(kThreads)
dia_proposal_kernel(const float* __restrict__ x,
                    const float* __restrict__ diag,
                    const float* __restrict__ wdia,
                    const float* __restrict__ h,
                    const float* __restrict__ im,
                    const float* __restrict__ stdv,
                    const float* __restrict__ p0,
                    const float* __restrict__ eps_ptr,
                    float* __restrict__ xo, float* __restrict__ log_acc,
                    int n, int K, Offsets offs, int n_steps,
                    uint2 key, uint32_t off_lo, uint32_t off_hi) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double red[32];
  float* xs = smem;      // [n] positions
  float* ms = smem + n;  // [n] momenta
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const float eps = *eps_ptr;
  const float* xrow = x + (size_t)c * n;

  for (int i = tid; i < n; i += kThreads) xs[i] = xrow[i];
  if (p0 != nullptr) {
    const float* prow = p0 + (size_t)c * n;
    for (int i = tid; i < n; i += kThreads) ms[i] = prow[i];
  } else {
    for (int q = tid; 4 * q < n; q += kThreads) {
      uint4 r = philox4x32_10(make_uint4((uint32_t)q, (uint32_t)c, off_lo,
                                         off_hi), key);
      float z[4];
      box_muller(r.x, r.y, &z[0], &z[1]);
      box_muller(r.z, r.w, &z[2], &z[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int i = 4 * q + j;
        if (i < n) ms[i] = stdv[i] * z[j];
      }
    }
  }
  __syncthreads();

  double lp0 = 0.0, ke0 = 0.0;
  lhvi_dia::trajectory(xs, ms, n, diag, wdia, h, im, K, offs, eps, n_steps,
                       &lp0, &ke0);
  double lp1 = 0.0, ke1 = 0.0;
  float* xorow = xo + (size_t)c * n;
  for (int i = tid; i < n; i += kThreads) {
    float p1 = lhvi_dia::end_lane(xs, ms, i, n, diag, wdia, h, K, offs, eps,
                                  n_steps, &lp1);
    ke1 += (double)(im[i] * p1 * p1);
    xorow[i] = xs[i];
  }
  // n_steps == 0: the endpoint sums repeat the start's and log_acc is 0
  double d = 0.5 * (lhvi_dia::block_sum(lp1, red)
                    - lhvi_dia::block_sum(lp0, red));
  d += 0.5 * (lhvi_dia::block_sum(ke0, red) - lhvi_dia::block_sum(ke1, red));
  if (tid == 0) log_acc[c] = (float)(d > 0.0 ? 0.0 : d);  // NaN stays NaN
}

}  // namespace

extern "C" int lhvi_dia_proposal(const float* x, const float* diag,
                                 const float* wdia, const float* h,
                                 const float* im, const float* stdv,
                                 const float* p0, const float* eps,
                                 float* xo, float* log_acc, int C, int n,
                                 int K, const int* offsets, int n_steps,
                                 unsigned long long seed,
                                 unsigned long long offset, void* stream) {
  Offsets offs;
  size_t smem;
  int code = lhvi_dia::check_launch(C, n, K, offsets, n_steps, &offs, &smem);
  if (code != 0) return code;
  cudaError_t err = cudaFuncSetAttribute(
      dia_proposal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  dia_proposal_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, diag, wdia, h, im, stdv, p0, eps, xo, log_acc, n, K, offs, n_steps,
      key, (uint32_t)offset, (uint32_t)(offset >> 32));
  return (int)cudaGetLastError();
}
