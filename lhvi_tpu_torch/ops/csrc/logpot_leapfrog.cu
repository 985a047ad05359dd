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
// abs, min, max and comparisons), interpreted forward for lp and backward
// for the adjoints of the row's continuous slots. The reference traced
// jax.vjp inside its Pallas kernel, which CUDA cannot do.
//
// What bounds it on the H100. The models are small (robot map: 14 latents,
// 14 factor rows with a latent slot, 16-node tapes; 11x11 denoise: 121
// latents, 341 rows, 9-node tapes). Per gradient each chain does n^2 FMAs
// of x.J and about 3 x (tape length) operations per row: a few kFLOP,
// against 8 n bytes of state that crosses device memory once per proposal.
// So it is neither bandwidth- nor FLOP-bound: the cost is the latency of
// the interpreter's memory traffic and the barriers between phases.
//
// Design (the launch geometry comes from ops/logpot.py::k5_launch, and the
// launcher checks it). A block owns TC chains (a power of two up to 32)
// for the whole trajectory; its warps interpret tapes. A warp task is one
// tape over 32 lanes = (32 / TC rows of one bucket) x (TC chains), lane l
// taking row l / TC and chain l % TC: at TC = 32 the lanes are 32 chains
// of one row. Every lane of a warp runs the same node of the same tape at
// once, so the interpreter never diverges, and each node (op, a, b, c
// packed in 16 bytes) is one broadcast load.
//   - Node values and adjoints live in shared memory, [node][lane] per
//     warp, sized by the plan's longest tape (16 nodes x 32 lanes x 4 B x 2
//     = 4 KB a warp on the robot graph), plus one adjoint row per
//     continuous slot: no per-thread arrays, so nothing in local memory.
//   - The tapes and the row tables (row order, segments, slot indices,
//     evidence values, parameters, scales) are staged in shared memory
//     once per launch where they fit, and J too.
//   - The active rows are split on the host into colours: no two rows of a
//     colour share a latent. A lane adds its row's slot adjoints straight
//     into the chain's gradient in shared memory, colour after colour with
//     a barrier between: every variable receives its adjoints in a fixed
//     order (the quadratic term, then colour by colour, slot by slot), with
//     no atomics, so every run gives the same bits; ops/logpot.py's
//     tape_energy_grad adds them in the same order.
//   - Each gradient is: the quadratic form per (chain, variable); the
//     colours; one pass per (chain, variable) that applies the tempering,
//     the kick and the next drift. Energies (only at the trajectory's two
//     ends) are summed per thread in double and reduced per chain in
//     thread order.
// Rows that read only evidence slots have a constant energy along the
// trajectory: they are evaluated once, at the start. Padded rows were
// dropped on the host. eps and beta are read from device memory, so the
// step size can change on the device without a host sync.
// At the main path's shapes: robot_map(100), C = 16,384: TC = 32, 14 warps
// (one colour of 14 rows), 512 blocks; 11x11 denoise, C = 4,096: TC = 32,
// 32 warps, 128 blocks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxTape = 128;  // ops/logpot_tape.py MAX_NODES
constexpr size_t kSmemLimit = 227 * 1024;

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
  const float* J;          // [n, n] or null (no quadratic form)
  const float* h;          // [n] or null
  const float* mid;        // [n] or null (no base measure)
  const float* is2;        // [n] or null
  const int4* tape;        // [T]: op | (reaches a continuous slot) << 8, a, b, c
  const int* bucket_tape;  // [B, 2]: first node, node count
  const int* row_order;    // [R]: plan rows, colour by colour, then evidence
  const int* segs;         // [S, 3]: bucket, first position in row_order, rows
  const int* color_ptr;    // [n_colors + 2]: segments of each colour; the
                           // last range is the evidence-only rows
  const int* cidx;         // [R, acm]: latent index or -1
  const float* cconst;     // [R, acm]: evidence value
  const float* prm;        // [R, pm]
  const float* w;          // [R]
  const float* dv;         // [C, R, adm] or null
  float* xo;
  float* po;
  float* e0;
  float* e1;
  int C, n, n_rows, n_tape, n_buckets, n_segs, n_colors, acm, adm, pm,
      max_tape, n_steps, tc, stage, j_smem;
};

// The plan's tables, in shared memory (staged) or in device memory.
struct Tables {
  const int4* tape;
  const int* bucket_tape;
  const int* row_order;
  const int* segs;
  const int* color_ptr;
  const int* cidx;
  const float* cconst;
  const float* prm;
  const float* w;
  const float* J;
};

// bytes of the staged tables (ops/logpot.py::_k5_smem mirrors it)
inline size_t table_bytes(int n_tape, int n_buckets, int n_rows, int n_segs,
                          int n_colors, int acm, int pm) {
  return 16 * (size_t)n_tape +
         4 * ((size_t)2 * n_buckets + n_rows + 3 * (size_t)n_segs +
              n_colors + 2 + 2 * (size_t)n_rows * acm +
              (size_t)n_rows * pm + n_rows);
}

inline size_t smem_bytes(const Args& a, int threads) {
  size_t b = 16 * (size_t)threads;  // two double partials a thread
  if (a.stage)
    b += table_bytes(a.n_tape, a.n_buckets, a.n_rows, a.n_segs, a.n_colors,
                     a.acm, a.pm);
  if (a.j_smem) b += 4 * (size_t)a.n * a.n;
  b += 12 * (size_t)a.n * a.tc;  // x, p, g
  b += (size_t)(threads / 32) * 128 * (2 * (size_t)a.max_tape + a.acm);
  return b;
}

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

template <typename T>
__device__ __forceinline__ const T* stage(const T* src, size_t count,
                                          unsigned char*& q) {
  T* dst = reinterpret_cast<T*>(q);
  for (size_t e = threadIdx.x; e < count; e += blockDim.x) dst[e] = src[e];
  q += sizeof(T) * count;
  return dst;
}

// The block's view of its chains and this thread's place in it.
struct Block {
  Tables t;
  float* xs;  // [n][TC]
  float* ps;
  float* gs;
  float* V;   // this warp's node values [max_tape][32]
  float* A;   // this warp's adjoints [max_tape][32], then [acm][32] slots
  int c0, rows, lane, warp, W, TC, RPL;
};

// Lane's tape of bucket b on plan row r for chain c (of the block): the
// forward sweep into V; with grad, the reverse sweep from d lp = w_r into
// A, the slot adjoints into the slot rows, and from there into the
// chain's gradient (only for ok lanes). Returns lp.
__device__ __forceinline__ float run_tape(const Args& a, const Block& s,
                                          int b, int r, int c, bool grad,
                                          bool ok) {
  const Tables& t = s.t;
  const int lane = s.lane;
  const int t0 = t.bucket_tape[2 * b], L = t.bucket_tape[2 * b + 1];
  const int4* tp = t.tape + t0;
  float* V = s.V;
  float* A = s.A;
  const int cg = min(s.c0 + c, a.C - 1);
  // The next node is loaded before this one's value is stored (shared
  // memory may alias), and the previous node's value stays in a register.
  int4 nd = tp[0];
  float prev = 0.f;
  for (int i = 0; i < L; ++i) {
    const int4 nx = i + 1 < L ? tp[i + 1] : nd;
    const int o = nd.x & 0xff, ia = nd.y, ib = nd.z;
    float va = 0.f, vb = 0.f;
    if (o >= kAdd) {
      va = ia == i - 1 ? prev : V[ia * 32 + lane];
      if (o < kNeg || o > kAbs) vb = ib == i - 1 ? prev : V[ib * 32 + lane];
    }
    float y;
    switch (o) {
      case kConst: y = __int_as_float(nd.w); break;
      case kCont: {
        const int vi = t.cidx[r * a.acm + ia];
        y = vi >= 0 ? s.xs[vi * s.TC + c] : t.cconst[r * a.acm + ia];
        break;
      }
      case kDisc: y = a.dv[((size_t)cg * a.n_rows + r) * a.adm + ia]; break;
      case kParam: y = t.prm[(size_t)r * a.pm + ia]; break;
      case kAdd: y = va + vb; break;
      case kSub: y = va - vb; break;
      case kMul: y = va * vb; break;
      case kDiv: y = va / vb; break;
      case kNeg: y = -va; break;
      case kPow: y = pow_c(va, __int_as_float(nd.w)); break;
      case kExp: y = expf(va); break;
      case kLog: y = logf(va); break;
      case kAbs: y = fabsf(va); break;
      case kMin: y = min_nan(va, vb); break;
      case kMax: y = max_nan(va, vb); break;
      case kEq: y = va == vb ? 1.f : 0.f; break;
      case kNe: y = va != vb ? 1.f : 0.f; break;
      case kLt: y = va < vb ? 1.f : 0.f; break;
      case kGt: y = va > vb ? 1.f : 0.f; break;
      case kLe: y = va <= vb ? 1.f : 0.f; break;
      default: y = va >= vb ? 1.f : 0.f; break;
    }
    V[i * 32 + lane] = y;
    prev = y;
    nd = nx;
  }
  const float lp = V[(L - 1) * 32 + lane];
  if (!grad) return lp;
  float* Sa = A + a.max_tape * 32;  // slot adjoints [acm][32]
  for (int i = 0; i < L - 1; ++i) A[i * 32 + lane] = 0.f;
  for (int k = 0; k < a.acm; ++k) Sa[k * 32 + lane] = 0.f;
  A[(L - 1) * 32 + lane] = t.w[r];
  nd = tp[L - 1];
  for (int i = L - 1; i >= 0; --i) {
    const int4 cur = nd;
    nd = i > 0 ? tp[i - 1] : cur;
    if (!(cur.x >> 8)) continue;  // reaches no continuous slot
    const int o = cur.x & 0xff, ia = cur.y, ib = cur.z;
    const float gi = A[i * 32 + lane];
    float* ga = A + ia * 32 + lane;
    float* gb = A + ib * 32 + lane;
    switch (o) {
      case kCont: Sa[ia * 32 + lane] += gi; break;
      case kAdd: *ga += gi; *gb += gi; break;
      case kSub: *ga += gi; *gb -= gi; break;
      case kMul: {
        const float va = V[ia * 32 + lane], vb = V[ib * 32 + lane];
        *ga += gi * vb;
        *gb += gi * va;
        break;
      }
      case kDiv: {
        const float va = V[ia * 32 + lane], vb = V[ib * 32 + lane];
        *ga += gi / vb;
        *gb += -gi * va / (vb * vb);
        break;
      }
      case kNeg: *ga -= gi; break;
      case kPow: {
        const float c_ = __int_as_float(cur.w);
        *ga += c_ == 0.f ? 0.f * gi
                         : gi * (c_ * pow_c(V[ia * 32 + lane], c_ - 1.f));
        break;
      }
      case kExp: *ga += gi * V[i * 32 + lane]; break;
      case kLog: *ga += gi / V[ia * 32 + lane]; break;
      case kAbs: {
        const float xa = V[ia * 32 + lane];
        *ga += gi * (xa > 0.f ? 1.f : (xa < 0.f ? -1.f : 0.f));
        break;
      }
      case kMin:
      case kMax: {
        const float xa = V[ia * 32 + lane], xb = V[ib * 32 + lane];
        float wa;
        if (xa == xb) wa = 0.5f;
        else wa = (o == kMin ? xa < xb : xa > xb) ? 1.f : 0.f;
        *ga += gi * wa;
        *gb += gi * (1.f - wa);
        break;
      }
      default: break;  // comparisons: no gradient
    }
  }
  if (ok) {
    for (int k = 0; k < a.acm; ++k) {
      const int vi = t.cidx[r * a.acm + k];
      if (vi >= 0) s.gs[vi * s.TC + c] += Sa[k * 32 + lane];
    }
  }
  return lp;
}

// The tasks of segments [s0, s1) over the block's warps; adds w_r lp_r of
// ok lanes to *eacc when need_e.
__device__ __forceinline__ void run_rows(const Args& a, const Block& s,
                                         int s0, int s1, bool grad,
                                         bool need_e, double* eacc) {
  const int q = s.lane / s.TC, c = s.lane - q * s.TC;
  int task = s.warp, base = 0;
  for (int g = s0; g < s1; ++g) {
    const int b = s.t.segs[3 * g], start = s.t.segs[3 * g + 1];
    const int cnt = s.t.segs[3 * g + 2];
    const int nt = (cnt + s.RPL - 1) / s.RPL;
    for (; task < base + nt; task += s.W) {
      const int k = (task - base) * s.RPL + q;
      const bool ok = k < cnt && c < s.rows;
      const int r = s.t.row_order[start + min(k, cnt - 1)];
      const float lp = run_tape(a, s, b, r, c, grad, ok);
      if (need_e && ok) *eacc += (double)(s.t.w[r] * lp);
    }
    base += nt;
  }
}

// One gradient of every chain at xs, then p += kick g and (drift) x +=
// eps im p. With need_e the energy at xs goes to e_out. Ends with a
// barrier.
__device__ __forceinline__ void step(const Args& a, const Block& s,
                                     double* pe, double ec, float beta,
                                     float eps, float kick, bool drift,
                                     bool need_e, float* e_out) {
  const int tid = threadIdx.x, T = blockDim.x, n = a.n, TC = s.TC;
  double eacc = need_e ? ec : 0.0, ebacc = 0.0;
  // the quadratic form per (variable, chain)
  for (int k = tid; k < n * TC; k += T) {
    const int j = k / TC, c = k - j * TC;
    float gq = 0.f;
    if (a.h != nullptr) {
      float acc = 0.f;
      for (int kk = 0; kk < n; ++kk)
        acc = fmaf(s.xs[kk * TC + c], s.t.J[kk * n + j], acc);
      const float hj = a.h[j];
      gq = hj - acc;
      if (need_e) eacc += (double)(s.xs[k] * (hj - 0.5f * acc));
    }
    s.gs[k] = gq;
  }
  __syncthreads();
  // the active rows, colour by colour
  for (int col = 0; col < a.n_colors; ++col) {
    run_rows(a, s, s.t.color_ptr[col], s.t.color_ptr[col + 1], true, need_e,
             &eacc);
    __syncthreads();
  }
  // tempering, kick and drift per (variable, chain)
  for (int k = tid; k < n * TC; k += T) {
    const int j = k / TC;
    float gsum = s.gs[k];
    if (a.mid != nullptr) {
      const float d = s.xs[k] - a.mid[j];
      gsum = beta * gsum - (1.f - beta) * d * a.is2[j];
      if (need_e) ebacc += (double)(d * d * a.is2[j]);
    }
    const float pn = s.ps[k] + kick * gsum;
    s.ps[k] = pn;
    if (drift) s.xs[k] += eps * a.im[j] * pn;
  }
  if (need_e) {
    pe[tid] = eacc;
    pe[T + tid] = ebacc;
  }
  __syncthreads();
  if (need_e && tid < s.rows) {
    double em = 0.0, eb = 0.0;
    for (int u = tid; u < T; u += TC) {
      em += pe[u];
      eb += pe[T + u];
    }
    if (a.mid != nullptr)
      em = (double)beta * em - (1.0 - (double)beta) * 0.5 * eb;
    e_out[s.c0 + tid] = (float)em;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
logpot_leapfrog_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int T = blockDim.x, tid = threadIdx.x, n = a.n;
  Block s;
  s.TC = a.tc;
  s.RPL = 32 / a.tc;
  s.W = T >> 5;
  s.lane = tid & 31;
  s.warp = tid >> 5;
  s.c0 = blockIdx.x * a.tc;
  s.rows = min(a.tc, a.C - s.c0);
  double* pe = reinterpret_cast<double*>(smem_raw);  // [2][T]
  unsigned char* q = smem_raw + 16 * (size_t)T;
  const size_t R = (size_t)a.n_rows;
  if (a.stage) {
    s.t.tape = stage(a.tape, (size_t)a.n_tape, q);
    s.t.bucket_tape = stage(a.bucket_tape, 2 * (size_t)a.n_buckets, q);
    s.t.row_order = stage(a.row_order, R, q);
    s.t.segs = stage(a.segs, 3 * (size_t)a.n_segs, q);
    s.t.color_ptr = stage(a.color_ptr, (size_t)a.n_colors + 2, q);
    s.t.cidx = stage(a.cidx, R * a.acm, q);
    s.t.cconst = stage(a.cconst, R * a.acm, q);
    s.t.prm = stage(a.prm, R * a.pm, q);
    s.t.w = stage(a.w, R, q);
  } else {
    s.t.tape = a.tape;
    s.t.bucket_tape = a.bucket_tape;
    s.t.row_order = a.row_order;
    s.t.segs = a.segs;
    s.t.color_ptr = a.color_ptr;
    s.t.cidx = a.cidx;
    s.t.cconst = a.cconst;
    s.t.prm = a.prm;
    s.t.w = a.w;
  }
  s.t.J = a.j_smem ? stage(a.J, (size_t)n * n, q) : a.J;
  s.xs = reinterpret_cast<float*>(q);
  s.ps = s.xs + n * a.tc;
  s.gs = s.ps + n * a.tc;
  const int span = 2 * a.max_tape + a.acm;
  s.V = s.gs + n * a.tc + (size_t)s.warp * span * 32;
  s.A = s.V + a.max_tape * 32;
  // positions and momenta, [variable][chain]; chains past C hold 0
  for (int e = tid; e < n * a.tc; e += T) {
    s.xs[e] = 0.f;
    s.ps[e] = 0.f;
  }
  __syncthreads();
  for (int e = tid; e < s.rows * n; e += T) {
    const int c = e / n, j = e - c * n;
    s.xs[j * a.tc + c] = a.x[(size_t)s.c0 * n + e];
    s.ps[j * a.tc + c] = a.p[(size_t)s.c0 * n + e];
  }
  __syncthreads();
  const float eps = *a.eps, beta = *a.beta;
  // evidence-only rows: constant along the trajectory, once per chain
  double ec = 0.0;
  run_rows(a, s, s.t.color_ptr[a.n_colors], s.t.color_ptr[a.n_colors + 1],
           false, true, &ec);
  step(a, s, pe, ec, beta, eps, 0.5f * eps, a.n_steps > 0, true, a.e0);
  for (int i = 0; i < a.n_steps; ++i) {
    __syncthreads();
    const bool last = i == a.n_steps - 1;
    step(a, s, pe, ec, beta, eps, (last ? 0.5f : 1.f) * eps, !last, last,
         a.e1);
  }
  __syncthreads();
  if (a.n_steps == 0) {
    for (int c = tid; c < s.rows; c += T) a.e1[s.c0 + c] = a.e0[s.c0 + c];
  }
  for (int e = tid; e < s.rows * n; e += T) {
    const int c = e / n, j = e - c * n;
    a.xo[(size_t)s.c0 * n + e] = s.xs[j * a.tc + c];
    a.po[(size_t)s.c0 * n + e] = s.ps[j * a.tc + c];
  }
}

}  // namespace

extern "C" int lhvi_logpot_leapfrog(
    const float* x, const float* p, const float* im, const float* eps,
    const float* beta, const float* J, const float* h, const float* mid,
    const float* is2, const void* tape, const int* bucket_tape,
    const int* row_order, const int* segs, const int* color_ptr,
    const int* cidx, const float* cconst, const float* prm, const float* w,
    const float* dv, float* xo, float* po, float* e0, float* e1, int C,
    int n, int n_rows, int n_tape, int n_buckets, int n_segs, int n_colors,
    int acm, int adm, int pm, int max_tape, int n_steps, int threads,
    int tc, int stage_tables, int j_smem, int smem, void* stream) {
  Args a{x, p, im, eps, beta, J, h, mid, is2,
         static_cast<const int4*>(tape), bucket_tape, row_order, segs,
         color_ptr, cidx, cconst, prm, w, dv, xo, po, e0, e1, C, n, n_rows,
         n_tape, n_buckets, n_segs, n_colors, acm, adm, pm, max_tape,
         n_steps, tc, stage_tables != 0, j_smem != 0};
  if (C <= 0 || n <= 0 || n_steps < 0 || acm <= 0 || n_rows <= 0 ||
      n_colors < 0 || max_tape < 1 || max_tape > kMaxTape ||
      (adm > 0 && dv == nullptr) || ((J == nullptr) != (h == nullptr)) ||
      ((mid == nullptr) != (is2 == nullptr)) || (j_smem && J == nullptr))
    return (int)cudaErrorInvalidValue;
  // the geometry ops/logpot.py::k5_launch chose
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      tc < 1 || tc > 32 || (tc & (tc - 1)) != 0 || smem < 0 ||
      (size_t)smem < smem_bytes(a, threads) || (size_t)smem > kSmemLimit)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      logpot_leapfrog_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  logpot_leapfrog_kernel<<<(C + tc - 1) / tc, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}
