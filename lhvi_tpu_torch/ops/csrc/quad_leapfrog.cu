// K1: batched n-step leapfrog on a dense quadratic target, for Hopper (sm_90a).
//
// Replaces the TPU kernel lhvi_tpu/ops/leapfrog.py::_leapfrog_kernel (:53).
// Target log pi(x) = h.x - 1/2 x'Jx, gradient g(x) = h - xJ. Merged
// half-kicks, as the reference: p += 1/2 eps g(x); then n_steps times
// x += eps*inv_mass*p, p += s*eps*g(x) with s = 1/2 on the last step.
//
// What bounds it on the H100. At the bench shape (n = 82, C = 65,536,
// 8 steps) each step is a [C, n] x [n, n] product: 0.88 GFLOP per step,
// 7.9 GFLOP per call, against 86 MB of state that must cross device
// memory at least once (x, p in; x, p out). Both are small; what the
// design has to avoid is moving the state through device memory on every
// step (9x the traffic) and feeding each FMA from shared memory with two
// loads. At n = 3,246 (the 64x64 grid) J is 42 MB and cannot be held on
// chip: each block streams J once per step from L2/HBM, so that regime is
// bound by J traffic, (C / chains-per-block) x n^2 x 4 bytes per step,
// and by the f32 FMA rate (86 GFLOP per step at C = 4,096).
//
// Design. One block of 256 threads owns a tile of chains for the whole
// trajectory; chains never interact, so blocks are independent. The
// momentum lives in the output buffer p_out; every element is owned by
// one thread per phase and phases are separated by __syncthreads. eps is
// read from device memory, so the step size can change on the device
// (dual averaging) without a host sync. Two layouts, chosen by n:
//   n <= 256 (resident): 64 chains per block; their positions stay in
//     shared memory for all steps, transposed to [n][64] so a warp reads
//     one chain group's x[k] as a broadcast, and J (27 KB at n = 82) sits
//     in shared memory beside them when both fit. Each thread keeps an
//     8-chain x 2-column register tile of xJ.
//   n >  256 (tiled): 32 chains per block; positions live in x_out (the
//     block's rows stay in L1/L2) and each kick is a tiled product: 32-deep
//     k stages of x [32 x 32] and J [32 x 128] staged through shared
//     memory, the next stage loaded into registers while the current one
//     is multiplied, a 4-chain x 4-column register tile per thread.
// No tensor cores (f32 throughout, TF32 off) and no TMA yet: a simple
// kernel that is right comes first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 227 * 1024;
constexpr int kJSmemBudget = 100 * 1024;  // keep >= 2 blocks per SM

// ---- resident layout (n <= 256) ------------------------------------------
constexpr int kRM = 8;                      // chains per thread
constexpr int kRBM = (kThreads / 32) * kRM;  // 64 chains per block
constexpr int kRCols = 2;                   // columns per lane per pass
constexpr int kRTileCols = 32 * kRCols;

// p_out[c, j] = src[c, j] + se * (h[j] - (x J)[c, j]) for the block's
// chains. src may alias p_out (same element, same thread).
__device__ __forceinline__ void resident_kick(const float* xs, const float* Jm,
                                              const float* __restrict__ h,
                                              const float* src, float* pout,
                                              float se, int c0, int C, int n,
                                              int warp, int lane) {
  for (int j0 = 0; j0 < n; j0 += kRTileCols) {
    int jj[kRCols];
    bool ok[kRCols];
#pragma unroll
    for (int s = 0; s < kRCols; ++s) {
      jj[s] = j0 + lane + 32 * s;
      ok[s] = jj[s] < n;
      if (!ok[s]) jj[s] = 0;  // in-bounds dummy column, never stored
    }
    float acc[kRM][kRCols];
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int s = 0; s < kRCols; ++s) acc[r][s] = 0.f;

    const float* xw = xs + warp * kRM;
    for (int k = 0; k < n; ++k) {
      const float* Jk = Jm + (size_t)k * n;
      float jv[kRCols];
#pragma unroll
      for (int s = 0; s < kRCols; ++s) jv[s] = Jk[jj[s]];
      float xv[kRM];
#pragma unroll
      for (int r = 0; r < kRM; r += 4) {
        float4 v = *reinterpret_cast<const float4*>(xw + k * kRBM + r);
        xv[r] = v.x; xv[r + 1] = v.y; xv[r + 2] = v.z; xv[r + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < kRM; ++r)
#pragma unroll
        for (int s = 0; s < kRCols; ++s)
          acc[r][s] = fmaf(xv[r], jv[s], acc[r][s]);
    }
#pragma unroll
    for (int r = 0; r < kRM; ++r) {
      int c = c0 + warp * kRM + r;
      if (c >= C) continue;
#pragma unroll
      for (int s = 0; s < kRCols; ++s) {
        if (!ok[s]) continue;
        size_t e = (size_t)c * n + jj[s];
        pout[e] = src[e] + se * (h[jj[s]] - acc[r][s]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
resident_kernel(const float* __restrict__ x, const float* __restrict__ p,
                const float* __restrict__ J, const float* __restrict__ h,
                const float* __restrict__ im,
                const float* __restrict__ eps_ptr,
                float* __restrict__ xo, float* pout,
                int C, int n, int n_steps, int j_in_smem) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;  // [n][kRBM]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * kRBM;
  const float eps = *eps_ptr;

  const float* Jm = J;
  if (j_in_smem) {
    float* Js = smem + (size_t)n * kRBM;
    for (int e = tid; e < n * n; e += kThreads) Js[e] = J[e];
    Jm = Js;
  }
  for (int e = tid; e < kRBM * n; e += kThreads) {
    int c = e / n, k = e - c * n;
    int gc = c0 + c;
    xs[k * kRBM + c] = gc < C ? x[(size_t)gc * n + k] : 0.f;
  }
  __syncthreads();
  resident_kick(xs, Jm, h, p, pout, 0.5f * eps, c0, C, n, warp, lane);
  for (int i = 0; i < n_steps; ++i) {
    __syncthreads();
    for (int e = tid; e < kRBM * n; e += kThreads) {
      int c = e / n, k = e - c * n;
      int gc = c0 + c;
      if (gc < C) xs[k * kRBM + c] += eps * im[k] * pout[(size_t)gc * n + k];
    }
    __syncthreads();
    float se = (i == n_steps - 1 ? 0.5f : 1.0f) * eps;
    resident_kick(xs, Jm, h, pout, pout, se, c0, C, n, warp, lane);
  }
  __syncthreads();
  for (int e = tid; e < kRBM * n; e += kThreads) {
    int c = e / n, k = e - c * n;
    int gc = c0 + c;
    if (gc < C) xo[(size_t)gc * n + k] = xs[k * kRBM + c];
  }
}

// ---- tiled layout (n > 256) ----------------------------------------------
constexpr int kTBM = 32;   // chains per block
constexpr int kTBN = 128;  // columns per tile
constexpr int kTBK = 32;   // k depth per shared-memory stage
constexpr int kTT = 4;     // 4 chains x 4 columns per thread
constexpr int kXRow = kTBM + 4;  // padded row: 4-way, not 32-way, store conflicts
constexpr int kXPer = kTBM * kTBK / kThreads;  // x tile values per thread
constexpr int kJPer = kTBK * kTBN / kThreads;  // J tile values per thread

// Global -> registers for one k stage (zero outside the matrix).
__device__ __forceinline__ void load_stage(const float* xg, const float* J,
                                           int c0, int C, int n, int j0,
                                           int k0, float* xr, float* jr) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kXPer; ++r) {
    int e = tid + r * kThreads;
    int c = e / kTBK, kk = e - c * kTBK;
    int gc = c0 + c, k = k0 + kk;
    xr[r] = (gc < C && k < n) ? xg[(size_t)gc * n + k] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kJPer; ++r) {
    int e = tid + r * kThreads;
    int kk = e / kTBN, jc = e - kk * kTBN;
    int k = k0 + kk, j = j0 + jc;
    jr[r] = (k < n && j < n) ? J[(size_t)k * n + j] : 0.f;
  }
}

// pout[c, j] = src[c, j] + se * (h[j] - (x J)[c, j]). x is the block's
// rows of x_out, written by this block only: plain (coherent) loads, never
// the read-only path. src may alias pout (same element, same thread).
// The next k stage is loaded into registers while the current one is
// multiplied out of shared memory.
__device__ __forceinline__ void tiled_kick(const float* xg, const float* J,
                                           const float* __restrict__ h,
                                           const float* src, float* pout,
                                           float se, int c0, int C, int n,
                                           float (*Xs)[kXRow],
                                           float (*Js)[kTBN]) {
  const int tid = threadIdx.x;
  const int tx = tid & 31;  // columns tx*4 .. tx*4+3
  const int ty = tid >> 5;  // chains  ty*4 .. ty*4+3
  float xr[kXPer], jr[kJPer];
  for (int j0 = 0; j0 < n; j0 += kTBN) {
    float acc[kTT][kTT];
#pragma unroll
    for (int r = 0; r < kTT; ++r)
#pragma unroll
      for (int s = 0; s < kTT; ++s) acc[r][s] = 0.f;
    load_stage(xg, J, c0, C, n, j0, 0, xr, jr);
    for (int k0 = 0; k0 < n; k0 += kTBK) {
      __syncthreads();  // the previous stage's reads are done
#pragma unroll
      for (int r = 0; r < kXPer; ++r) {
        int e = tid + r * kThreads;
        Xs[e % kTBK][e / kTBK] = xr[r];
      }
#pragma unroll
      for (int r = 0; r < kJPer; ++r) {
        int e = tid + r * kThreads;
        Js[e / kTBN][e % kTBN] = jr[r];
      }
      __syncthreads();
      if (k0 + kTBK < n) load_stage(xg, J, c0, C, n, j0, k0 + kTBK, xr, jr);
#pragma unroll
      for (int kk = 0; kk < kTBK; ++kk) {
        float4 xv = *reinterpret_cast<const float4*>(&Xs[kk][ty * kTT]);
        float4 jv = *reinterpret_cast<const float4*>(&Js[kk][tx * kTT]);
        float xa[kTT] = {xv.x, xv.y, xv.z, xv.w};
        float ja[kTT] = {jv.x, jv.y, jv.z, jv.w};
#pragma unroll
        for (int r = 0; r < kTT; ++r)
#pragma unroll
          for (int s = 0; s < kTT; ++s)
            acc[r][s] = fmaf(xa[r], ja[s], acc[r][s]);
      }
    }
#pragma unroll
    for (int r = 0; r < kTT; ++r) {
      int c = c0 + ty * kTT + r;
      if (c >= C) continue;
#pragma unroll
      for (int s = 0; s < kTT; ++s) {
        int j = j0 + tx * kTT + s;
        if (j >= n) continue;
        size_t e = (size_t)c * n + j;
        pout[e] = src[e] + se * (h[j] - acc[r][s]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
tiled_kernel(const float* __restrict__ x, const float* __restrict__ p,
             const float* J, const float* __restrict__ h,
             const float* __restrict__ im, const float* __restrict__ eps_ptr,
             float* xo, float* pout, int C, int n, int n_steps) {
  __shared__ __align__(16) float Xs[kTBK][kXRow];
  __shared__ __align__(16) float Js[kTBK][kTBN];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kTBM;
  const int rows = min(kTBM, C - c0);
  const float eps = *eps_ptr;

  for (int e = tid; e < rows * n; e += kThreads)
    xo[(size_t)c0 * n + e] = x[(size_t)c0 * n + e];
  __syncthreads();
  tiled_kick(xo, J, h, p, pout, 0.5f * eps, c0, C, n, Xs, Js);
  for (int i = 0; i < n_steps; ++i) {
    __syncthreads();
    for (int e = tid; e < rows * n; e += kThreads) {
      size_t g = (size_t)c0 * n + e;
      xo[g] += eps * im[e % n] * pout[g];
    }
    __syncthreads();
    float se = (i == n_steps - 1 ? 0.5f : 1.0f) * eps;
    tiled_kick(xo, J, h, pout, pout, se, c0, C, n, Xs, Js);
  }
}

cudaError_t launch_resident(const float* x, const float* p, const float* J,
                            const float* h, const float* im, const float* eps,
                            float* xo, float* po, int C, int n, int n_steps,
                            cudaStream_t stream) {
  size_t x_bytes = (size_t)kRBM * n * sizeof(float);
  size_t j_bytes = (size_t)n * n * sizeof(float);
  int j_in_smem = x_bytes + j_bytes <= (size_t)kJSmemBudget;
  size_t smem = x_bytes + (j_in_smem ? j_bytes : 0);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  resident_kernel<<<(C + kRBM - 1) / kRBM, kThreads, smem, stream>>>(
      x, p, J, h, im, eps, xo, po, C, n, n_steps, j_in_smem);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lhvi_quad_leapfrog(const float* x, const float* p,
                                  const float* J, const float* h,
                                  const float* im, const float* eps,
                                  float* xo, float* po, int C, int n,
                                  int n_steps, void* stream) {
  if (C <= 0 || n <= 0 || n_steps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 256)
    return (int)launch_resident(x, p, J, h, im, eps, xo, po, C, n, n_steps, s);
  tiled_kernel<<<(C + kTBM - 1) / kTBM, kThreads, 0, s>>>(
      x, p, J, h, im, eps, xo, po, C, n, n_steps);
  return (int)cudaGetLastError();
}

extern "C" const char* lhvi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
