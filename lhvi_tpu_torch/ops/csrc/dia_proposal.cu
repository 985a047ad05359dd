// K2: one whole HMC proposal on a banded (DIA) quadratic target, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel lhvi_tpu/ops/dia.py::_dia_proposal_kernel (:354).
// Latent rows in and out; in embedded coordinates: momenta p0 = std * z (z
// standard normal, drawn in-kernel, or read from memory in test mode, std
// = 1/sqrt(im), 0 at gap lanes); position-Verlet with J x = diag*x +
// sum_k w_k * x[i + o_k]; lp = 1/2 sum x(h + g) at both ends; kinetic
// energies 1/2 sum im p^2; log_acc = min(0, dlp + dKE), -inf where not
// finite. Given the chains' uniforms u, the kernel also makes the
// Metropolis step: it writes x1 where log u < log_acc and x0 elsewhere, so
// the caller runs no [C, n] select of its own.
//
// What bounds it on the H100. At the benchmark's shape (128x128 grid,
// n_emb = 16,384 lanes, K = 4, 6 steps) the arithmetic is 2(K+1) flops per
// lane and chain per gradient over 7 gradients, against 2 x 4 x C x n bytes
// of latent rows in and out: the bound is memory traffic, 0.038 ms at
// 1,024 chains and 0.611 ms at 16,384 (portbench/roofline.py). The kernel
// runs some 9x above it (PERF.md, the port's kernels): what binds is
// inside the SMs, the step loop's shared-memory reads of every lane's
// position and four neighbours for every chain, one cluster barrier a
// step, and the momentum draw (Philox4x32-10 and Box-Muller, about 200
// instructions for four normals). A block per chain would read the lane
// constants from L2 for every chain and matvec.
//
// Design: the trajectory body in dia_traj.cuh. A cluster of blocks splits
// the embedded row and integrates a group of chains at once; each block
// stages its slice's lane constants once per launch, holds positions
// double-buffered in shared memory as planes of float4 (no bank conflict)
// and momenta in registers, and reads a neighbour in another slice through
// distributed shared memory: one cluster barrier per step, released by one
// thread's fence. The embedding is folded in: rows and the latent diag, h
// and inv_mass are read through inv. The four per-chain energy sums are
// one double per chain and end, reduced in a fixed order. With u, the
// trajectories are unchanged and each cluster, once its groups are done,
// writes x0 back over the rows of its rejected chains: about a fifth of
// the rows read and written again at an accept rate of 0.8, against a
// [C, n] pass that reads two arrays and writes a third.
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

template <int CB>
__global__ void __launch_bounds__(lhvi_dia::kMaxThreads)
dia_proposal_kernel(const __grid_constant__ lhvi_dia::Args a) {
  lhvi_dia::run<CB, true>(a);
}

}  // namespace

extern "C" int lhvi_dia_proposal(const float* x, const float* diag,
                                 const float* wdia, const float* h,
                                 const float* im, const int64_t* inv,
                                 const float* p0, const float* u,
                                 const float* eps,
                                 float* xo, float* log_acc, int C, int n,
                                 int n_emb, int K, const int* offsets,
                                 int n_steps, unsigned long long seed,
                                 unsigned long long offset, int cluster,
                                 int threads, int chains, int slice,
                                 int smem, void* stream) {
  lhvi_dia::Args a{};
  int code = lhvi_dia::check_launch(C, n, n_emb, K, offsets, n_steps,
                                    inv != nullptr, cluster, threads, chains,
                                    slice, (size_t)smem, &a.offs);
  if (code != 0) return code;
  a.x = x; a.p = p0; a.diag = diag; a.wdia = wdia; a.h = h; a.im = im;
  a.inv = inv; a.eps = eps; a.u = u; a.xo = xo; a.po = nullptr;
  a.out0 = log_acc; a.out1 = nullptr;
  a.C = C; a.n = n; a.n_emb = n_emb; a.K = K; a.n_steps = n_steps;
  a.slice = slice;
  a.key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  a.off_lo = (uint32_t)offset;
  a.off_hi = (uint32_t)(offset >> 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chains) {
    case 1: return lhvi_dia::launch(dia_proposal_kernel<1>, a, cluster, threads, 1, smem, s);
    case 2: return lhvi_dia::launch(dia_proposal_kernel<2>, a, cluster, threads, 2, smem, s);
    case 4: return lhvi_dia::launch(dia_proposal_kernel<4>, a, cluster, threads, 4, smem, s);
    default: return lhvi_dia::launch(dia_proposal_kernel<8>, a, cluster, threads, 8, smem, s);
  }
}
