// K6: position-Verlet on a banded (DIA) quadratic target from given
// positions and momenta, for Hopper (sm_90a).
//
// Replaces the TPU kernel lhvi_tpu/ops/dia.py::_dia_leapfrog_kernel (:184).
// Latent rows in and out; in embedded coordinates, per chain: g0 = h - J x,
// m = p + 1/2 eps g0; n_steps - 1 times x += eps im m, m += eps (h - J x);
// a last drift; then p1 = m + 1/2 eps g1, with J x = diag*x + sum_k w_k *
// x[i + o_k]. Returns x1, p1 [C, n] and the endpoint log-potentials lp =
// 1/2 sum x(h + g) (without the constant) [C]. n_steps == 0 returns x and
// p unchanged and lp0 twice.
//
// What bounds it on the H100. At the 128x128 grid (n_emb = 16,384 lanes,
// K = 4 offsets, C = 1,024 chains, 6 steps) the call must move x and p in
// and x1 and p1 out, 4 x 62 MB of latent rows, against 2(K+1) flops per
// lane per gradient over 7 gradients (~20 us at 67 TFLOP/s f32): the bound
// is memory traffic. What binds the kernel is the step loop's
// shared-memory reads of every lane's position and four neighbours and one
// cluster barrier a step.
//
// Design: K2 (dia_proposal.cu) without the momentum draw and the accept;
// the trajectory body is the one K2 runs (dia_traj.cuh): clusters that
// split the embedded row, lane constants staged once per launch, positions
// double-buffered in shared memory as conflict-free planes of float4,
// momenta in registers, one cluster barrier per step. The endpoint sums
// are accumulated in double and reduced in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dia_traj.cuh"

namespace {

template <int CB>
__global__ void __launch_bounds__(lhvi_dia::kMaxThreads)
dia_leapfrog_kernel(const __grid_constant__ lhvi_dia::Args a) {
  lhvi_dia::run<CB, false>(a);
}

}  // namespace

extern "C" int lhvi_dia_leapfrog(const float* x, const float* p,
                                 const float* diag, const float* wdia,
                                 const float* h, const float* im,
                                 const int64_t* inv, const float* eps, float* xo,
                                 float* po, float* lp0, float* lp1, int C,
                                 int n, int n_emb, int K, const int* offsets,
                                 int n_steps, int cluster, int threads,
                                 int chains, int slice, int smem,
                                 void* stream) {
  lhvi_dia::Args a{};
  if (p == nullptr) return (int)cudaErrorInvalidValue;
  int code = lhvi_dia::check_launch(C, n, n_emb, K, offsets, n_steps,
                                    inv != nullptr, cluster, threads, chains,
                                    slice, (size_t)smem, &a.offs);
  if (code != 0) return code;
  a.x = x; a.p = p; a.diag = diag; a.wdia = wdia; a.h = h; a.im = im;
  a.inv = inv; a.eps = eps; a.xo = xo; a.po = po; a.out0 = lp0;
  a.out1 = lp1;
  a.C = C; a.n = n; a.n_emb = n_emb; a.K = K; a.n_steps = n_steps;
  a.slice = slice;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chains) {
    case 1: return lhvi_dia::launch(dia_leapfrog_kernel<1>, a, cluster, threads, 1, smem, s);
    case 2: return lhvi_dia::launch(dia_leapfrog_kernel<2>, a, cluster, threads, 2, smem, s);
    case 4: return lhvi_dia::launch(dia_leapfrog_kernel<4>, a, cluster, threads, 4, smem, s);
    default: return lhvi_dia::launch(dia_leapfrog_kernel<8>, a, cluster, threads, 8, smem, s);
  }
}
