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
// memory once (x, p in; x, p out): the f32 FMA rate bounds it, and the
// design has to keep each FMA's operands out of shared memory's way and
// the state out of device memory. At n = 3,246 (the 64x64 grid, C = 4,096)
// J is 42 MB and each step is 86 GFLOP: a large product, bound by the FMA
// rate if every block's tiles are reused from shared memory and registers.
//
// Design. eps is read from device memory, so the step size can change on
// the device (dual averaging) without a host sync. The geometry is chosen
// by ops/leapfrog.py::k1_launch and checked by the launcher.
//   Resident layout (n <= 256): blocks of 4 warps; a warp owns M chains
//     (8 up to n = 96, 4 up to 192, else 2) for the whole trajectory and
//     all their columns, lane-strided (j = lane + 32 s, NP = ceil(n/32)),
//     so a thread holds an M x NP tile of x, p and the product in
//     registers. The thread that computes p[c, j] also drifts x[c, j] and
//     writes it into the warp's columns of a transposed [n][4M + pad]
//     shared tile (pad: the column-strided vector stores fall on distinct
//     banks); the product reads a row of it as one broadcast, J from
//     shared memory where it fits beside the tile. Only the warp reads
//     what it wrote, so a step costs two __syncwarp and no block barrier;
//     p is read from device memory once and written once.
//   Cooperative layout (n > 256): one persistent grid, every block
//     resident (cudaLaunchCooperativeKernel, sized from the occupancy
//     query). A prologue copies J, x and p into zero-padded scratch (x and
//     p transposed to [column][chain]) so that every tile is a whole,
//     aligned cp.async copy. Each step is a tiled product over 128 x 128
//     (chains x columns) output tiles, 8 x 8 a thread, k-stages of 16
//     staged by cp.async and double-buffered; the tile's epilogue forms
//     p += s*eps*(h - xJ) and x_next = x + eps*im*p into the other x
//     buffer. One grid-wide barrier per step (an atomic counter: needs no
//     relocatable device code).
// No tensor cores (f32 throughout, TF32 off).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dia_traj.cuh"  // ld/st of a lane's values for several chains

namespace {

using lhvi_dia::ld;
using lhvi_dia::st;

constexpr size_t kSmemLimit = 227 * 1024;

// ---- resident layout (n <= 256) ------------------------------------------
constexpr int kRWarps = 4;

// row stride of the [n][4M + pad] position tile (ops/leapfrog.py mirrors it)
__host__ __device__ constexpr int tile_stride(int M) {
  return kRWarps * M + (M >= 4 ? 4 : 2);
}

__host__ __device__ constexpr size_t round16(size_t b) {
  return (b + 15) / 16 * 16;
}

template <int NP, int M>
__global__ void __launch_bounds__(kRWarps * 32, 4)
resident_kernel(const float* __restrict__ x, const float* __restrict__ p,
                const float* __restrict__ J, const float* __restrict__ h,
                const float* __restrict__ im,
                const float* __restrict__ eps_ptr, float* __restrict__ xo,
                float* __restrict__ po, int C, int n, int n_steps,
                int j_smem) {
  constexpr int LD = tile_stride(M);
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [n][LD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float eps = *eps_ptr;
  const float* Jm = J;
  if (j_smem) {
    float* Js = xs + round16(4 * (size_t)n * LD) / 4;
    for (int e = tid; e < n * n; e += kRWarps * 32) Js[e] = J[e];
    Jm = Js;
  }
  const int c0 = blockIdx.x * kRWarps * M + warp * M;  // this warp's chains
  float* xw = xs + warp * M;
  int jj[NP];
  bool col[NP];
  float hj[NP], ej[NP];
  float xr[M][NP], pr[M][NP];
#pragma unroll
  for (int s = 0; s < NP; ++s) {
    const int j = lane + 32 * s;
    col[s] = j < n;
    jj[s] = col[s] ? j : n - 1;  // in-bounds dummy column, never stored
    hj[s] = col[s] ? h[j] : 0.f;
    ej[s] = col[s] ? eps * im[j] : 0.f;
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const bool ok = c0 + m < C;
#pragma unroll
    for (int s = 0; s < NP; ++s) {
      const size_t e = (size_t)(c0 + m) * n + jj[s];
      xr[m][s] = ok && col[s] ? x[e] : 0.f;
      pr[m][s] = ok && col[s] ? p[e] : 0.f;
    }
  }
  // x of the warp's chains into its columns of the tile
  auto stage = [&]() {
#pragma unroll
    for (int s = 0; s < NP; ++s) {
      if (!col[s]) continue;
      float v[M];
#pragma unroll
      for (int m = 0; m < M; ++m) v[m] = xr[m][s];
      st<M>(xw + (size_t)jj[s] * LD, v);
    }
  };
  // p += se * (h - x J) on the thread's M x NP tile
  auto kick = [&](float se) {
    float acc[M][NP];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int s = 0; s < NP; ++s) acc[m][s] = 0.f;
#pragma unroll 2
    for (int k = 0; k < n; ++k) {
      float xv[M];
      ld<M>(xw + (size_t)k * LD, xv);
      const float* Jk = Jm + (size_t)k * n;
      float jv[NP];
#pragma unroll
      for (int s = 0; s < NP; ++s) jv[s] = Jk[jj[s]];
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int s = 0; s < NP; ++s) acc[m][s] = fmaf(xv[m], jv[s], acc[m][s]);
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int s = 0; s < NP; ++s)
        pr[m][s] = pr[m][s] + se * (hj[s] - acc[m][s]);
  };
  stage();
  __syncthreads();  // J staged (the only block barrier)
  kick(0.5f * eps);
  for (int i = 0; i < n_steps; ++i) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int s = 0; s < NP; ++s) xr[m][s] = xr[m][s] + ej[s] * pr[m][s];
    __syncwarp();  // the warp's reads of the tile are done
    stage();
    __syncwarp();
    kick((i == n_steps - 1 ? 0.5f : 1.0f) * eps);
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if (c0 + m >= C) continue;
#pragma unroll
    for (int s = 0; s < NP; ++s) {
      if (!col[s]) continue;
      const size_t e = (size_t)(c0 + m) * n + jj[s];
      xo[e] = xr[m][s];
      po[e] = pr[m][s];
    }
  }
}

template <int NP, int M>
cudaError_t launch_resident(const float* x, const float* p, const float* J,
                            const float* h, const float* im, const float* eps,
                            float* xo, float* po, int C, int n, int n_steps,
                            int j_smem, int smem, int grid,
                            cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      resident_kernel<NP, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  resident_kernel<NP, M><<<grid, kRWarps * 32, smem, stream>>>(
      x, p, J, h, im, eps, xo, po, C, n, n_steps, j_smem);
  return cudaGetLastError();
}

// ---- cooperative layout (n > 256) ------------------------------------------
constexpr int kCThreads = 256;
constexpr int kBM = 128;  // chains a tile
constexpr int kBN = 128;  // columns a tile
constexpr int kBK = 16;   // k depth a stage
constexpr size_t kCoopSmem = 2 * (size_t)kBK * (kBM + kBN) * sizeof(float);

struct Coop {
  const float *x, *p, *J, *h, *im, *eps;
  float *xo, *po;
  float* Jp;   // [kpad][npad] J, zero-padded
  float* xb0;  // [kpad][Cpad] x transposed, zero-padded
  float* xb1;  // the other x buffer
  float* pb;   // [npad][Cpad] p transposed, zero-padded
  unsigned* bar;
  int C, n, n_steps, Cpad, kpad, npad;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Every block of the (co-resident) grid arrives, then all go on. The
// counter only grows: barrier number k waits for k x gridDim.x arrivals.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const unsigned target = k * gridDim.x;
    while (*reinterpret_cast<volatile unsigned*>(bar) < target) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kCThreads, 2) coop_kernel(Coop a) {
  extern __shared__ __align__(16) float sm[];
  float* As = sm;                         // [2][kBK][kBM]
  float* Bs = sm + 2 * kBK * kBM;         // [2][kBK][kBN]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n = a.n, C = a.C, Cpad = a.Cpad, kpad = a.kpad, npad = a.npad;
  const float eps = *a.eps;

  // prologue: the padded, transposed copies
  const size_t G = (size_t)gridDim.x * kCThreads;
  const size_t g0 = (size_t)blockIdx.x * kCThreads + tid;
  for (size_t e = g0; e < (size_t)kpad * npad; e += G) {
    const int k = (int)(e / npad), j = (int)(e % npad);
    a.Jp[e] = k < n && j < n ? a.J[(size_t)k * n + j] : 0.f;
  }
  for (size_t e = g0; e < (size_t)kpad * Cpad; e += G) {
    const int k = (int)(e / Cpad), r = (int)(e % Cpad);
    a.xb0[e] = k < n && r < C ? a.x[(size_t)r * n + k] : 0.f;
    a.xb1[e] = 0.f;
  }
  for (size_t e = g0; e < (size_t)npad * Cpad; e += G) {
    const int j = (int)(e / Cpad), r = (int)(e % Cpad);
    a.pb[e] = j < n && r < C ? a.p[(size_t)r * n + j] : 0.f;
  }
  if (a.n_steps == 0)
    for (size_t e = g0; e < (size_t)C * n; e += G) a.xo[e] = a.x[e];
  unsigned barriers = 0;
  grid_barrier(a.bar, ++barriers);

  const int tiles_n = npad / kBN, tiles = (Cpad / kBM) * tiles_n;
  const int nk = kpad / kBK;
  for (int step = 0; step <= a.n_steps; ++step) {
    const float* cur = (step & 1) ? a.xb1 : a.xb0;
    float* nxt = (step & 1) ? a.xb0 : a.xb1;
    const float se = (step == 0 || step == a.n_steps) ? 0.5f * eps : eps;
    const bool drift = step < a.n_steps;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * kBM, j0 = (t % tiles_n) * kBN;
      auto load_stage = [&](int kt, int b) {
        float* as = As + b * kBK * kBM;
        float* bs = Bs + b * kBK * kBN;
#pragma unroll
        for (int c = tid; c < kBK * kBM / 4; c += kCThreads) {
          const int kk = c / (kBM / 4), m4 = c % (kBM / 4);
          cp_async16(as + kk * kBM + 4 * m4,
                     cur + (size_t)(kt * kBK + kk) * Cpad + m0 + 4 * m4);
        }
#pragma unroll
        for (int c = tid; c < kBK * kBN / 4; c += kCThreads) {
          const int kk = c / (kBN / 4), j4 = c % (kBN / 4);
          cp_async16(bs + kk * kBN + 4 * j4,
                     a.Jp + (size_t)(kt * kBK + kk) * npad + j0 + 4 * j4);
        }
        asm volatile("cp.async.commit_group;\n" ::);
      };
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;
      load_stage(0, 0);
      for (int kt = 0; kt < nk; ++kt) {
        if (kt + 1 < nk) {
          load_stage(kt + 1, (kt + 1) & 1);
          asm volatile("cp.async.wait_group 1;\n" ::);
        } else {
          asm volatile("cp.async.wait_group 0;\n" ::);
        }
        __syncthreads();
        const float* as = As + (kt & 1) * kBK * kBM;
        const float* bs = Bs + (kt & 1) * kBK * kBN;
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
          float av[8], bv[8];
          const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kBM + 4 * ty);
          const float4 a1 = *reinterpret_cast<const float4*>(as + kk * kBM + 64 + 4 * ty);
          const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kBN + 4 * tx);
          const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kBN + 64 + 4 * tx);
          av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
          av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
          bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
          bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
              acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
        }
        __syncthreads();  // the stage is read before it is refilled
      }
      // epilogue: rows r = m0 + {4ty.., 64+4ty..}, columns j = j0 +
      // {4tx.., 64+4tx..}; p and x by four chains at a time
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = j0 + (jj < 4 ? 4 * tx + jj : 64 + 4 * tx + jj - 4);
        if (j >= n) continue;
        const float hj = a.h[j], ej = eps * a.im[j];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r0 = m0 + 64 * half + 4 * ty;
          // L2 loads: another SM wrote these since this SM last read them
          float* pp = a.pb + (size_t)j * Cpad + r0;
          const float4 p4 = __ldcg(reinterpret_cast<const float4*>(pp));
          const float4 x4 = __ldcg(
              reinterpret_cast<const float4*>(cur + (size_t)j * Cpad + r0));
          float pv[4] = {p4.x, p4.y, p4.z, p4.w};
          float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pv[i] = pv[i] + se * (hj - acc[4 * half + i][jj]);
            xv[i] = xv[i] + ej * pv[i];
          }
          st<4>(pp, pv);
          if (drift) st<4>(nxt + (size_t)j * Cpad + r0, xv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (r0 + i >= C) continue;
            if (step == a.n_steps) a.po[(size_t)(r0 + i) * n + j] = pv[i];
            if (drift && step == a.n_steps - 1)
              a.xo[(size_t)(r0 + i) * n + j] = xv[i];
          }
        }
      }
    }
    if (drift) grid_barrier(a.bar, ++barriers);
  }
}

// Blocks of the cooperative kernel that fit on the card at once.
cudaError_t coop_capacity(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, coop_kernel, kCThreads, kCoopSmem);
  *blocks = sms * per_sm;
  return err;
}

}  // namespace

// layout 0 (resident: chains a warp, 4 warps a block, J in shared memory or
// not) or 1 (cooperative: 128 x 128 tiles, 8 warps a block); smem and grid
// from ops/leapfrog.py::k1_launch, checked here. The cooperative layout
// needs `scratch` (K1Launch.scratch floats: padded J [kpad][npad], two x
// buffers [kpad][Cpad] and p [npad][Cpad]) and a zeroed `barrier` word.
extern "C" int lhvi_quad_leapfrog(const float* x, const float* p,
                                  const float* J, const float* h,
                                  const float* im, const float* eps,
                                  float* xo, float* po, int C, int n,
                                  int n_steps, int layout, int chains,
                                  int warps, int smem, int grid, int j_smem,
                                  float* scratch, unsigned* barrier,
                                  void* stream) {
  if (C <= 0 || n <= 0 || n > 4096 || n_steps < 0)
    return (int)cudaErrorInvalidValue;
  if (grid < 1 || smem < 0 || (size_t)smem > kSmemLimit)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == 0) {
    const int np = (n + 31) / 32;
    const int m = np <= 3 ? 8 : (np <= 6 ? 4 : 2);
    const size_t need = round16(4 * (size_t)n * tile_stride(m)) +
                        (j_smem ? 4 * (size_t)n * n : 0);
    if (n > 256 || chains != m || warps != kRWarps ||
        grid < (C + kRWarps * m - 1) / (kRWarps * m) || (size_t)smem < need)
      return (int)cudaErrorInvalidConfiguration;
    switch (np) {
#define K1_CASE(NP, M)                                                      \
  case NP:                                                                  \
    return (int)launch_resident<NP, M>(x, p, J, h, im, eps, xo, po, C, n,   \
                                       n_steps, j_smem, smem, grid, s);
      K1_CASE(1, 8) K1_CASE(2, 8) K1_CASE(3, 8) K1_CASE(4, 4) K1_CASE(5, 4)
      K1_CASE(6, 4) K1_CASE(7, 2) K1_CASE(8, 2)
#undef K1_CASE
      default: return (int)cudaErrorInvalidValue;
    }
  }
  int capacity = 0;
  cudaError_t err = coop_capacity(&capacity);
  if (err != cudaSuccess) return (int)err;
  if (layout != 1 || chains != kBM || warps != kCThreads / 32 ||
      (size_t)smem < kCoopSmem || grid > capacity || scratch == nullptr ||
      barrier == nullptr)
    return (int)cudaErrorInvalidConfiguration;
  Coop a{x, p, J, h, im, eps, xo, po, nullptr, nullptr, nullptr, nullptr,
         barrier, C, n, n_steps, (C + kBM - 1) / kBM * kBM,
         (n + kBK - 1) / kBK * kBK, (n + kBN - 1) / kBN * kBN};
  a.Jp = scratch;
  a.xb0 = a.Jp + (size_t)a.kpad * a.npad;
  a.xb1 = a.xb0 + (size_t)a.kpad * a.Cpad;
  a.pb = a.xb1 + (size_t)a.kpad * a.Cpad;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)coop_kernel, dim3(grid),
                                    dim3(kCThreads), args, (size_t)smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* lhvi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
