// K5: fused non-quadratic energy, its gradient and the whole n-step leapfrog,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel lhvi_tpu/ops/logpot.py::_leapfrog_kernel (:271).
// Energy of a chain at x (the discrete slots fixed for the move):
//   E(x) = beta [x.h - 1/2 x'Jx + sum_rows w_r lp_r(slots_r(x))]
//          - (1 - beta) 1/2 sum_i (x_i - mid_i)^2 is2_i      (use_base only)
// and its gradient, then merged half-kicks, as the reference:
//   p += 1/2 eps g(x0); n_steps times: x += eps im p, p += s eps g(x), s = 1/2
//   on the last step. Writes x1, p1 and E(x0), E(x1).
//
// The log-potential lp_r of a factor row is its bucket's TAPE, recorded on
// the host from the potential's planar function (ops/logpot_tape.py): a list
// of nodes (leaves: a constant, a continuous slot, a discrete slot value, a
// parameter of the row; then +, -, *, /, neg, pow by a constant, exp, log,
// abs, min, max and comparisons). A thread interprets it forward for lp and
// backward for the adjoints of the row's continuous slots. The reference
// traced jax.vjp inside its Pallas kernel, which CUDA cannot do.
//
// What bounds it on the H100. The models the gate admits are small (robot
// map: 14 latents, 14 factor rows with a latent slot; 11x11 denoise: 121
// latents, 341 rows). Per gradient each chain does n^2 FMAs of x.J and about
// 3 x (tape length) operations per row: a few kFLOP, against 8 n bytes of
// state that crosses device memory once per proposal. So it is neither
// bandwidth- nor FLOP-bound: the cost is latency (barriers between the four
// phases of each gradient, local-memory tape arrays) and, at these chain
// counts, occupancy.
//
// Design. One block of 256 threads owns a tile of TC chains for the whole
// trajectory. Shared memory holds their x, p, g, the per-(chain, variable)
// quadratic energy terms, the per-(chain, row) weighted log-potentials and
// the per-(chain, row, slot) adjoints; J too when it fits (n = 14: 784 B).
// Each gradient is four phases split by barriers:
//   A  (chain, variable): g = h - (xJ)_j, q = x_j (h_j - 1/2 (xJ)_j);
//   B  (chain, active row): the tape forward and back -> w lp, adjoints;
//   C  (chain, variable): g += the variable's adjoints, in the fixed order of
//      a CSR list (no atomics: every run gives the same bits); the base term;
//   D  (a warp per chain, only at the trajectory's two ends): the energy,
//      summed in double with a fixed xor-butterfly.
// Rows that read only evidence slots have a constant energy along the
// trajectory: they are evaluated once, at the start. Padded rows were
// dropped on the host. eps and beta are read from device memory, so the
// step size can change on the device without a host sync.
// No tensor cores and no TMA: a simple kernel that is right comes first.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTape = 128;   // ops/logpot_tape.py MAX_NODES
constexpr int kMaxChains = 128;
constexpr int kSmemBudget = 112 * 1024;  // keep two blocks per SM
constexpr int kSmemLimit = 227 * 1024;
constexpr int kJSmemMax = 48 * 1024;

// ops/logpot_tape.py OPS
enum Op {
  kConst = 0, kCont, kDisc, kParam, kAdd, kSub, kMul, kDiv, kNeg, kPow,
  kExp, kLog, kAbs, kMin, kMax, kEq, kNe, kLt, kGt, kLe, kGe
};

struct Args {
  const float* x;
  const float* p;
  const float* im;
  const float* eps;
  const float* beta;
  const float* J;    // [n, n] or null (no quadratic form)
  const float* h;    // [n] or null
  const float* mid;  // [n] or null (no base measure)
  const float* is2;  // [n] or null
  const int* row_bucket;   // [R]
  const int* bucket_tape;  // [B, 2]: first node, node count
  const int* op;           // [T]: op | (depends on a continuous slot) << 8
  const int* ta;           // [T]
  const int* tb;           // [T]
  const float* tc;         // [T]
  const int* cidx;         // [R, acm]: latent index or -1
  const float* cconst;     // [R, acm]: evidence value
  const float* prm;        // [R, pm]
  const float* w;          // [R]
  const float* dv;         // [C, R, adm] or null
  const int* csr_ptr;      // [n + 1]
  const int* csr_ent;      // [nnz]: row * acm + slot
  float* xo;
  float* po;
  float* e0;
  float* e1;
  int C, n, n_act, n_rows, acm, adm, pm, n_steps, tile, j_smem;
};

// x ** c as torch computes it for a scalar exponent
__device__ __forceinline__ float pow_c(float x, float c) {
  if (c == 2.f) return x * x;
  if (c == 1.f) return x;
  if (c == 0.f) return 1.f;
  if (c == 3.f) return x * x * x;
  if (c == 0.5f) return sqrtf(x);
  if (c == -1.f) return 1.f / x;
  if (c == -2.f) return 1.f / (x * x);
  return powf(x, c);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? NAN : (a < b ? a : b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? NAN : (a > b ? a : b);
}

// Row r's tape forward for chain c (xrow: the chain's positions). With
// grad, the reverse sweep from d lp = w_r writes the adjoint of each of the
// row's continuous slots to slot_adj[0 .. acm). Returns lp.
__device__ float eval_row(const Args& a, int r, int c, const float* xrow,
                          bool grad, float* slot_adj) {
  const int b = a.row_bucket[r];
  const int t0 = a.bucket_tape[2 * b], T = a.bucket_tape[2 * b + 1];
  const int* op = a.op + t0;
  const int* ta = a.ta + t0;
  const int* tb = a.tb + t0;
  const float* tc = a.tc + t0;
  float v[kMaxTape];
  for (int i = 0; i < T; ++i) {
    const int o = op[i] & 0xff;
    const int ia = ta[i], ib = tb[i];
    float y;
    switch (o) {
      case kConst: y = tc[i]; break;
      case kCont: {
        const int vi = a.cidx[r * a.acm + ia];
        y = vi >= 0 ? xrow[vi] : a.cconst[r * a.acm + ia];
        break;
      }
      case kDisc: y = a.dv[((size_t)c * a.n_rows + r) * a.adm + ia]; break;
      case kParam: y = a.prm[(size_t)r * a.pm + ia]; break;
      case kAdd: y = v[ia] + v[ib]; break;
      case kSub: y = v[ia] - v[ib]; break;
      case kMul: y = v[ia] * v[ib]; break;
      case kDiv: y = v[ia] / v[ib]; break;
      case kNeg: y = -v[ia]; break;
      case kPow: y = pow_c(v[ia], tc[i]); break;
      case kExp: y = expf(v[ia]); break;
      case kLog: y = logf(v[ia]); break;
      case kAbs: y = fabsf(v[ia]); break;
      case kMin: y = min_nan(v[ia], v[ib]); break;
      case kMax: y = max_nan(v[ia], v[ib]); break;
      case kEq: y = v[ia] == v[ib] ? 1.f : 0.f; break;
      case kNe: y = v[ia] != v[ib] ? 1.f : 0.f; break;
      case kLt: y = v[ia] < v[ib] ? 1.f : 0.f; break;
      case kGt: y = v[ia] > v[ib] ? 1.f : 0.f; break;
      case kLe: y = v[ia] <= v[ib] ? 1.f : 0.f; break;
      default: y = v[ia] >= v[ib] ? 1.f : 0.f; break;
    }
    v[i] = y;
  }
  const float lp = v[T - 1];
  if (!grad) return lp;
  float g[kMaxTape];
  for (int i = 0; i < T; ++i) g[i] = 0.f;
  for (int s = 0; s < a.acm; ++s) slot_adj[s] = 0.f;
  g[T - 1] = a.w[r];
  for (int i = T - 1; i >= 0; --i) {
    if (!(op[i] >> 8)) continue;  // reaches no continuous slot
    const int o = op[i] & 0xff;
    const int ia = ta[i], ib = tb[i];
    const float gi = g[i];
    switch (o) {
      case kCont: slot_adj[ia] += gi; break;
      case kAdd: g[ia] += gi; g[ib] += gi; break;
      case kSub: g[ia] += gi; g[ib] -= gi; break;
      case kMul: g[ia] += gi * v[ib]; g[ib] += gi * v[ia]; break;
      case kDiv:
        g[ia] += gi / v[ib];
        g[ib] += -gi * v[ia] / (v[ib] * v[ib]);
        break;
      case kNeg: g[ia] -= gi; break;
      case kPow: {
        const float c_ = tc[i];
        g[ia] += c_ == 0.f ? 0.f * gi : gi * (c_ * pow_c(v[ia], c_ - 1.f));
        break;
      }
      case kExp: g[ia] += gi * v[i]; break;
      case kLog: g[ia] += gi / v[ia]; break;
      case kAbs: {
        const float xa = v[ia];
        g[ia] += gi * (xa > 0.f ? 1.f : (xa < 0.f ? -1.f : 0.f));
        break;
      }
      case kMin:
      case kMax: {
        const float xa = v[ia], xb = v[ib];
        float wa;
        if (xa == xb) wa = 0.5f;
        else wa = (o == kMin ? xa < xb : xa > xb) ? 1.f : 0.f;
        g[ia] += gi * wa;
        g[ib] += gi * (1.f - wa);
        break;
      }
      default: break;  // comparisons: no gradient
    }
  }
  return lp;
}

__device__ __forceinline__ double warp_sum(double s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

struct Smem {
  double* econst;  // [TC] evidence-only rows' energy
  float* xs;       // [TC, n]
  float* ps;       // [TC, n]
  float* gs;       // [TC, n]
  float* qe;       // [TC, n] quadratic energy terms
  float* lw;       // [TC, n_act] w lp of the active rows
  float* adj;      // [TC, n_act, acm] slot adjoints
  const float* Jm;  // J in shared memory, or in device memory
};

// g = grad E(x) for the block's chains; with need_e the energy goes to
// e_out (beta-blended). Ends with a barrier.
__device__ void energy_grad(const Args& a, const Smem& s, int c0, int rows,
                            float beta, bool need_e, float* e_out) {
  const int tid = threadIdx.x, n = a.n;
  const int na = a.n_act, acm = a.acm;
  // A: the quadratic form
  for (int k = tid; k < rows * n; k += kThreads) {
    const int c = k / n, j = k - c * n;
    float gq = 0.f, q = 0.f;
    if (a.h != nullptr) {
      const float* xr = s.xs + c * n;
      float acc = 0.f;
      for (int kk = 0; kk < n; ++kk) acc = fmaf(xr[kk], s.Jm[kk * n + j], acc);
      gq = a.h[j] - acc;
      q = xr[j] * (a.h[j] - 0.5f * acc);
    }
    s.gs[k] = gq;
    s.qe[k] = q;
  }
  // B: the active rows' tapes (independent of A)
  for (int k = tid; k < rows * na; k += kThreads) {
    const int c = k / na, r = k - c * na;
    s.lw[k] = a.w[r] * eval_row(a, r, c0 + c, s.xs + c * n, true,
                                s.adj + (size_t)k * acm);
  }
  __syncthreads();
  // C: gather the adjoints per variable (fixed CSR order), the base term
  for (int k = tid; k < rows * n; k += kThreads) {
    const int c = k / n, v = k - c * n;
    float gsum = s.gs[k];
    const float* ac = s.adj + (size_t)c * na * acm;
    for (int e = a.csr_ptr[v]; e < a.csr_ptr[v + 1]; ++e) gsum += ac[a.csr_ent[e]];
    if (a.mid != nullptr) {
      const float d = s.xs[k] - a.mid[v];
      gsum = beta * gsum - (1.f - beta) * d * a.is2[v];
    }
    s.gs[k] = gsum;
  }
  // D: the energy, a warp per chain (reads only what A and B wrote)
  if (need_e) {
    const int warp = tid >> 5, lane = tid & 31;
    for (int c = warp; c < rows; c += kWarps) {
      double em = 0.0, eb = 0.0;
      for (int j = lane; j < n; j += 32) {
        em += (double)s.qe[c * n + j];
        if (a.mid != nullptr) {
          const float d = s.xs[c * n + j] - a.mid[j];
          eb += (double)(d * d * a.is2[j]);
        }
      }
      for (int r = lane; r < na; r += 32) em += (double)s.lw[c * na + r];
      em = warp_sum(em);
      eb = warp_sum(eb);
      if (lane == 0) {
        double e = em + s.econst[c];
        if (a.mid != nullptr)
          e = (double)beta * e - (1.0 - (double)beta) * 0.5 * eb;
        e_out[c0 + c] = (float)e;
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
logpot_leapfrog_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TC = a.tile, n = a.n, tid = threadIdx.x;
  const int c0 = blockIdx.x * TC;
  const int rows = min(TC, a.C - c0);
  Smem s;
  s.econst = reinterpret_cast<double*>(smem_raw);
  s.xs = reinterpret_cast<float*>(s.econst + TC);
  s.ps = s.xs + TC * n;
  s.gs = s.ps + TC * n;
  s.qe = s.gs + TC * n;
  s.lw = s.qe + TC * n;
  s.adj = s.lw + TC * a.n_act;
  s.Jm = a.J;
  if (a.j_smem) {
    float* Js = s.adj + (size_t)TC * a.n_act * a.acm;
    for (int e = tid; e < n * n; e += kThreads) Js[e] = a.J[e];
    s.Jm = Js;
  }
  const float eps = *a.eps, beta = *a.beta;
  for (int e = tid; e < rows * n; e += kThreads) {
    s.xs[e] = a.x[(size_t)c0 * n + e];
    s.ps[e] = a.p[(size_t)c0 * n + e];
  }
  __syncthreads();
  // evidence-only rows: constant along the trajectory, once per chain
  {
    const int warp = tid >> 5, lane = tid & 31;
    for (int c = warp; c < rows; c += kWarps) {
      double ec = 0.0;
      for (int r = a.n_act + lane; r < a.n_rows; r += 32)
        ec += (double)(a.w[r] * eval_row(a, r, c0 + c, s.xs + c * n, false,
                                         nullptr));
      ec = warp_sum(ec);
      if (lane == 0) s.econst[c] = ec;
    }
  }
  __syncthreads();
  energy_grad(a, s, c0, rows, beta, true, a.e0);
  for (int e = tid; e < rows * n; e += kThreads) s.ps[e] += 0.5f * eps * s.gs[e];
  for (int i = 0; i < a.n_steps; ++i) {
    __syncthreads();
    for (int e = tid; e < rows * n; e += kThreads)
      s.xs[e] += eps * a.im[e % n] * s.ps[e];
    __syncthreads();
    const bool last = i == a.n_steps - 1;
    energy_grad(a, s, c0, rows, beta, last, a.e1);
    const float se = (last ? 0.5f : 1.f) * eps;
    for (int e = tid; e < rows * n; e += kThreads) s.ps[e] += se * s.gs[e];
  }
  __syncthreads();
  if (a.n_steps == 0) {
    for (int c = tid; c < rows; c += kThreads) a.e1[c0 + c] = a.e0[c0 + c];
  }
  for (int e = tid; e < rows * n; e += kThreads) {
    a.xo[(size_t)c0 * n + e] = s.xs[e];
    a.po[(size_t)c0 * n + e] = s.ps[e];
  }
}

}  // namespace

extern "C" int lhvi_logpot_leapfrog(
    const float* x, const float* p, const float* im, const float* eps,
    const float* beta, const float* J, const float* h, const float* mid,
    const float* is2, const int* row_bucket, const int* bucket_tape,
    const int* op, const int* ta, const int* tb, const float* tc,
    const int* cidx, const float* cconst, const float* prm, const float* w,
    const float* dv, const int* csr_ptr, const int* csr_ent, float* xo,
    float* po, float* e0, float* e1, int C, int n, int n_act, int n_rows,
    int acm, int adm, int pm, int n_steps, void* stream) {
  if (C <= 0 || n <= 0 || n_steps < 0 || acm <= 0 || n_act > n_rows ||
      (adm > 0 && dv == nullptr) || ((J == nullptr) != (h == nullptr)) ||
      ((mid == nullptr) != (is2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a{x, p, im, eps, beta, J, h, mid, is2, row_bucket, bucket_tape, op,
         ta, tb, tc, cidx, cconst, prm, w, dv, csr_ptr, csr_ent, xo, po, e0,
         e1, C, n, n_act, n_rows, acm, adm, pm, n_steps, 0, 0};
  const size_t per_chain =
      sizeof(double) + sizeof(float) * (4 * (size_t)n + (size_t)n_act * (1 + acm));
  const size_t j_bytes = sizeof(float) * (size_t)n * n;
  a.j_smem = J != nullptr && j_bytes <= (size_t)kJSmemMax &&
             j_bytes + per_chain <= (size_t)kSmemBudget;
  const size_t fixed = a.j_smem ? j_bytes : 0;
  // ops/logpot.py::kernel_plan holds a graph to this same bound
  if (fixed + per_chain + 16 > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  size_t tile = fixed + per_chain <= (size_t)kSmemBudget
                    ? ((size_t)kSmemBudget - fixed) / per_chain
                    : 1;
  // enough blocks to give every SM two, where the chain count allows
  const size_t spread = ((size_t)C + 263) / 264;
  const size_t floor_tc = spread > 8 ? spread : 8;
  tile = tile < (size_t)kMaxChains ? tile : (size_t)kMaxChains;
  tile = tile < floor_tc ? tile : floor_tc;
  if (tile < 1) tile = 1;
  a.tile = (int)tile;
  const size_t smem = fixed + tile * per_chain + 16;
  cudaError_t err = cudaFuncSetAttribute(
      logpot_leapfrog_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  logpot_leapfrog_kernel<<<(C + a.tile - 1) / a.tile, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}
