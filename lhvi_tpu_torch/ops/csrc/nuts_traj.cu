// K3: one whole NUTS transition per chain on a dense quadratic target, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel lhvi_tpu/ops/nuts_traj.py::_nuts_traj_kernel
// (:48). Target log pi(q) = h.q - 1/2 q'Jq, gradient g = h - qJ. Iterative
// multinomial NUTS with the reference's shared (d, j) leaf schedule: at
// depth d a direction is drawn, 2^d leapfrog leaves are integrated from the
// chosen end, each leaf is weighted by exp(-dH) into the subtree's
// streaming multinomial proposal, even leaves are checkpointed at slot
// popcount(j) and odd leaves are checked for a U-turn against the
// checkpoints j+1-2^(l+1), l < ctz(j+1); the finished subtree is merged by
// biased progressive sampling and the whole trajectory is checked for a
// U-turn. A leaf with dH > 1000 (or non-finite) diverges. The semantics are
// those of lhvi_tpu_torch/engines/nuts.py::_nuts_lockstep, the plain
// version: a uniform for (kind, step) is read from a [3, 2^max_depth, C]
// table in test mode, so the two follow the same tree.
//
// What bounds it on the H100. At the bench shape (n = 82, C = 65,536,
// max_depth 4) a leaf is one [n] x [n, n] product per chain: 6,724 FMAs,
// and at most 15 leaves per transition, ~13 GFLOP per call if every chain
// ran every leaf, against 43 MB of compulsory traffic (q0, p0 in; q_prop
// out). Both are small. What the reference's TPU layout paid for, and what
// a lockstep port would pay for on the card, is every chain running every
// leaf behind masks and ~15 [C, n] state arrays crossing device memory
// per leaf; here a chain's trajectory state never leaves the SM, and a
// chain whose tree turned or diverged stops integrating.
//
// Design. Each chain's decisions depend only on its own state and on the
// shared (d, j) schedule, so chains run independently and stop at their
// own depth: no masks, no lockstep.
//   Resident layout (n <= 256): one warp per chain. Lane l holds
//     coordinates l, l+32, ... (ceil(n/32) of them) of the 11 state
//     vectors (current point, both ends, proposals) in registers. A leaf
//     stages q through a per-warp shared row; each lane computes its
//     coordinates of h - qJ reading J column-wise (consecutive lanes,
//     consecutive words: no bank conflicts), with J in shared memory,
//     shared by the block's warps, when it fits (n <= 128). The per-chain
//     sums (log-density, kinetic energy, U-turn products) are xor-butterfly
//     warp reductions, so every lane holds the same bits and takes the
//     same branch. The checkpoint stacks live in shared memory, each lane
//     touching only its own coordinates. A finished warp exits.
//   Block layout (256 < n <= 4,096, or a stack too deep for shared
//     memory): one block per chain (a persistent grid walks the chains),
//     thread t holding coordinates t, t+T, ... (up to 8), J read from
//     L2, the checkpoint stacks in a global scratch buffer, block
//     reductions in a fixed order.
// Energies are sums of many terms whose difference matters: each term is
// formed and accumulated in double (K2 accumulates in double too). In-kernel uniforms come from a
// Philox4x32-10 keyed by a host seed, counter (chain, step, offset): the
// wrapper takes seed and offset from the caller's torch.Generator and
// advances it, so no device value is read back. eps is read from device
// memory. No tensor cores (f32, TF32 off): a simple kernel that is right
// comes first.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kDivergence = 1000.0f;
constexpr int kWarpsPerBlock = 8;
constexpr int kSmemLimit = 227 * 1024;
constexpr int kJSmemMax = 64 * 1024;  // J in shared memory up to n = 128
constexpr int kBlockNP = 8;           // block layout: coordinates per thread
constexpr int kBlockMaxThreads = 512;
constexpr int kMaxDepth = 20;

struct Params {
  const float* q0;
  const float* p0;
  const float* J;
  const float* h;
  const float* im;
  const float* eps;
  const float* uni;  // [3, 2^max_depth, C] or null
  float* qp;
  float* sum_acc;
  int* n_leaf;
  int* depth;
  unsigned char* diverged;
  float* scratch;  // block layout: [gridDim.x, 2, max_depth+1, n]
  int C, n, max_depth;
  uint2 key;
  uint32_t off_lo, off_hi;
};

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

// Uniform in [0, 1) for (kind, step) of chain c: kind 0 = direction (step
// 2^d - 1), 1 = leaf (the leaf's step), 2 = merge (the step after the
// subtree's last leaf).
__device__ __forceinline__ float uniform(const Params& P, int c, int kind,
                                         int step) {
  if (P.uni != nullptr)
    return P.uni[((size_t)kind * ((size_t)1 << P.max_depth) + step) * P.C + c];
  uint4 r = philox4x32_10(make_uint4((uint32_t)c, (uint32_t)step, P.off_lo,
                                     P.off_hi), P.key);
  uint32_t b = kind == 0 ? r.x : (kind == 1 ? r.y : r.z);
  return (float)(b >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float logaddexpf_(float a, float b) {
  if (a == -INFINITY) return b;
  if (b == -INFINITY) return a;
  float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// ---- resident layout: one warp per chain ---------------------------------
template <int NP>
struct WarpPolicy {
  int lane, n, d1;
  float* row;  // [NP * 32] staging row of q
  float* ck;   // [2][d1][NP][32] checkpoint stacks (q, p)
  const float* Jm;

  __device__ int idx(int k) const { return lane + 32 * k; }

  template <int K>
  __device__ void sum(double* v) const {
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v[kk] += __shfl_xor_sync(0xffffffffu, v[kk], o);
  }

  // g = h - qJ on this lane's coordinates (zero outside [0, n))
  __device__ void grad(const float* q, float* g, const float* h) const {
    __syncwarp();
#pragma unroll
    for (int k = 0; k < NP; ++k)
      if (idx(k) < n) row[idx(k)] = q[k];
    __syncwarp();
    int jj[NP];
    float acc[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      jj[k] = min(idx(k), n - 1);
      acc[k] = 0.f;
    }
    for (int kk = 0; kk < n; ++kk) {
      const float r = row[kk];
      const float* Jk = Jm + (size_t)kk * n;
#pragma unroll
      for (int k = 0; k < NP; ++k) acc[k] = fmaf(r, Jk[jj[k]], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < NP; ++k) g[k] = idx(k) < n ? h[k] - acc[k] : 0.f;
  }

  __device__ float* ck_at(int which, int slot, int k) const {
    return ck + (((size_t)which * d1 + slot) * NP + k) * 32 + lane;
  }
};

// ---- block layout: one block per chain ------------------------------------
template <int NP>
struct BlockPolicy {
  int tid, nt, n, d1;
  float* row;    // [n] shared staging row of q
  double* red;   // [32 * 2] shared reduction slots
  float* ck;     // [2][d1][n] global, this block's
  const float* Jm;

  __device__ int idx(int k) const { return tid + nt * k; }

  template <int K>
  __device__ void sum(double* v) const {
    const int lane = tid & 31, warp = tid >> 5, nw = (nt + 31) >> 5;
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v[kk] += __shfl_xor_sync(0xffffffffu, v[kk], o);
    __syncthreads();  // the previous call's reads of red are done
    if (lane == 0)
#pragma unroll
      for (int kk = 0; kk < K; ++kk) red[warp * K + kk] = v[kk];
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      double t = 0.0;
      for (int w = 0; w < nw; ++w) t += red[w * K + kk];  // same order everywhere
      v[kk] = t;
    }
  }

  __device__ void grad(const float* q, float* g, const float* h) const {
    __syncthreads();  // the previous product's reads of row are done
#pragma unroll
    for (int k = 0; k < NP; ++k)
      if (idx(k) < n) row[idx(k)] = q[k];
    __syncthreads();
    int jj[NP];
    float acc[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      jj[k] = min(idx(k), n - 1);
      acc[k] = 0.f;
    }
    for (int kk = 0; kk < n; ++kk) {
      const float r = row[kk];
      const float* Jk = Jm + (size_t)kk * n;
#pragma unroll
      for (int k = 0; k < NP; ++k) acc[k] = fmaf(r, Jk[jj[k]], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < NP; ++k) g[k] = idx(k) < n ? h[k] - acc[k] : 0.f;
  }

  __device__ float* ck_at(int which, int slot, int k) const {
    return ck + ((size_t)which * d1 + slot) * n + idx(k);  // idx(k) < n
  }
};

// One chain's whole transition. Every thread of the chain's warp (resident
// layout) or block (block layout) runs it with the same reduced values, so
// all branches are uniform across the chain's threads.
template <int NP, class Pol>
__device__ void nuts_chain(const Pol& pol, const Params& P, int c) {
  const int n = P.n;
  const float eps = *P.eps;
  float h[NP], im[NP], q[NP], p[NP], g[NP];
  float ql[NP], pl[NP], gl[NP], qr[NP], pr[NP], gr[NP], qp[NP], sqp[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int i = pol.idx(k);
    const bool ok = i < n;
    h[k] = ok ? P.h[i] : 0.f;
    im[k] = ok ? P.im[i] : 0.f;
    q[k] = ok ? P.q0[(size_t)c * n + i] : 0.f;
    p[k] = ok ? P.p0[(size_t)c * n + i] : 0.f;
  }
  pol.grad(q, g, h);
  double s[2] = {0.0, 0.0};
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    s[0] += (double)q[k] * ((double)h[k] + (double)g[k]);
    s[1] += (double)im[k] * (double)p[k] * (double)p[k];
  }
  pol.template sum<2>(s);
  const double h0 = -0.5 * s[0] + 0.5 * s[1];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    ql[k] = qr[k] = qp[k] = sqp[k] = q[k];
    pl[k] = pr[k] = p[k];
    gl[k] = gr[k] = g[k];
  }

  float log_w = 0.f, sum_acc = 0.f;
  int n_leaf = 0, depth = 0;
  bool diverged = false;
  for (int d = 0; d < P.max_depth; ++d) {
    const int base = (1 << d) - 1;
    const bool fwd = uniform(P, c, 0, base) < 0.5f;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      sqp[k] = q[k];
      q[k] = fwd ? qr[k] : ql[k];
      p[k] = fwd ? pr[k] : pl[k];
      g[k] = fwd ? gr[k] : gl[k];
    }
    const float e = fwd ? eps : -eps;
    float sub_log_w = -INFINITY;
    bool sub_bad = false;
    for (int j = 0; j < (1 << d) && !sub_bad; ++j) {
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        p[k] = p[k] + 0.5f * e * g[k];
        q[k] = q[k] + e * im[k] * p[k];
      }
      pol.grad(q, g, h);
      s[0] = s[1] = 0.0;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        p[k] = p[k] + 0.5f * e * g[k];
        s[0] += (double)q[k] * ((double)h[k] + (double)g[k]);
        s[1] += (double)im[k] * (double)p[k] * (double)p[k];
      }
      pol.template sum<2>(s);
      const float dh = (float)((-0.5 * s[0] + 0.5 * s[1]) - h0);
      const bool div = !isfinite(dh) || dh > kDivergence;
      const float lw = div ? -INFINITY : -dh;
      const float acc_term = isfinite(dh) ? fminf(1.f, expf(-dh)) : 0.f;
      const float u = uniform(P, c, 1, base + j);
      sub_log_w = logaddexpf_(sub_log_w, lw);
      if (!div && logf(u) < lw - sub_log_w) {
#pragma unroll
        for (int k = 0; k < NP; ++k) sqp[k] = q[k];
      }
      bool turned = false;
      if ((j & 1) == 0) {
        const int slot = __popc(j);
#pragma unroll
        for (int k = 0; k < NP; ++k) {
          if (pol.idx(k) < n) {
            *pol.ck_at(0, slot, k) = q[k];
            *pol.ck_at(1, slot, k) = p[k];
          }
        }
      } else {
        const int n_checks = __ffs(j + 1) - 1;  // ctz(j + 1)
        for (int l = 0; l < n_checks && !turned; ++l) {
          const int sl = __popc(j + 1 - (2 << l));
          s[0] = s[1] = 0.0;
#pragma unroll
          for (int k = 0; k < NP; ++k) {
            if (pol.idx(k) >= n) continue;
            const float dq = q[k] - *pol.ck_at(0, sl, k);
            s[0] += (double)(dq * im[k] * *pol.ck_at(1, sl, k));
            s[1] += (double)(dq * im[k] * p[k]);
          }
          pol.template sum<2>(s);
          turned = s[0] < 0.0 || s[1] < 0.0;
        }
      }
      sub_bad = div || turned;
      sum_acc += acc_term;
      n_leaf += 1;
      diverged = diverged || div;
    }
    const float um = uniform(P, c, 2, (2 << d) - 1);
    if (!sub_bad) {
      if (logf(um) < sub_log_w - log_w) {
#pragma unroll
        for (int k = 0; k < NP; ++k) qp[k] = sqp[k];
      }
      log_w = logaddexpf_(log_w, sub_log_w);
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        if (fwd) {
          qr[k] = q[k]; pr[k] = p[k]; gr[k] = g[k];
        } else {
          ql[k] = q[k]; pl[k] = p[k]; gl[k] = g[k];
        }
      }
    }
    s[0] = s[1] = 0.0;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const float dq = qr[k] - ql[k];
      s[0] += (double)(dq * im[k] * pl[k]);
      s[1] += (double)(dq * im[k] * pr[k]);
    }
    pol.template sum<2>(s);
    depth = d + 1;
    if (sub_bad || s[0] < 0.0 || s[1] < 0.0) break;
  }

#pragma unroll
  for (int k = 0; k < NP; ++k)
    if (pol.idx(k) < n) P.qp[(size_t)c * n + pol.idx(k)] = qp[k];
  if (pol.idx(0) == 0) {
    P.sum_acc[c] = sum_acc;
    P.n_leaf[c] = n_leaf;
    P.depth[c] = depth;
    P.diverged[c] = diverged ? 1 : 0;
  }
}

template <int NP>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
warp_kernel(Params P, int j_in_smem) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = P.n, d1 = P.max_depth + 1;
  float* base = smem;
  const float* Jm = P.J;
  if (j_in_smem) {
    for (int e = tid; e < n * n; e += blockDim.x) base[e] = P.J[e];
    Jm = base;
    base += (size_t)n * n;
  }
  __syncthreads();  // the block's last barrier: warps run on their own
  const int c = blockIdx.x * (blockDim.x >> 5) + warp;
  if (c >= P.C) return;
  float* mine = base + (size_t)warp * (NP * 32) * (1 + 2 * d1);
  WarpPolicy<NP> pol{lane, n, d1, mine, mine + NP * 32, Jm};
  nuts_chain<NP>(pol, P, c);
}

__global__ void __launch_bounds__(kBlockMaxThreads)
block_kernel(Params P) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double red[32 * 2];
  const int n = P.n, d1 = P.max_depth + 1;
  float* ck = P.scratch + (size_t)blockIdx.x * 2 * d1 * n;
  BlockPolicy<kBlockNP> pol{(int)threadIdx.x, (int)blockDim.x, n, d1, smem,
                            red, ck, P.J};
  for (int c = blockIdx.x; c < P.C; c += gridDim.x) {
    nuts_chain<kBlockNP>(pol, P, c);
    __syncthreads();
  }
}

size_t warp_smem(int n, int np, int d1, int warps, bool j_in_smem) {
  return (j_in_smem ? (size_t)n * n * sizeof(float) : 0) +
         (size_t)warps * np * 32 * (1 + 2 * d1) * sizeof(float);
}

bool use_warp_layout(int n, int max_depth) {
  if (n > 256) return false;
  int np = (n + 31) / 32;
  bool js = (size_t)n * n * sizeof(float) <= (size_t)kJSmemMax;
  return warp_smem(n, np, max_depth + 1, 1, js) <= (size_t)kSmemLimit;
}

int block_grid(int C) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return C < 2 * sms ? C : 2 * sms;
}

template <int NP>
cudaError_t launch_warp(const Params& P, cudaStream_t stream) {
  const int n = P.n, d1 = P.max_depth + 1;
  const bool js = (size_t)n * n * sizeof(float) <= (size_t)kJSmemMax;
  int warps = kWarpsPerBlock;
  while (warps > 1 && warp_smem(n, NP, d1, warps, js) > (size_t)kSmemLimit)
    --warps;
  size_t smem = warp_smem(n, NP, d1, warps, js);
  cudaError_t err = cudaFuncSetAttribute(
      warp_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  warp_kernel<NP><<<(P.C + warps - 1) / warps, warps * 32, smem, stream>>>(
      P, js ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// Floats of global scratch the launcher needs for (C, n, max_depth): 0 on
// the resident layout.
extern "C" int lhvi_nuts_traj_scratch(int C, int n, int max_depth) {
  if (C <= 0 || n <= 0 || max_depth < 0 || max_depth > kMaxDepth) return 0;
  if (use_warp_layout(n, max_depth)) return 0;
  return block_grid(C) * 2 * (max_depth + 1) * n;
}

extern "C" int lhvi_nuts_traj(const float* q0, const float* p0, const float* J,
                              const float* h, const float* im, const float* eps,
                              const float* uniforms, float* qp, float* sum_acc,
                              int* n_leaf, int* depth, unsigned char* diverged,
                              float* scratch, int C, int n, int max_depth,
                              unsigned long long seed,
                              unsigned long long offset, void* stream) {
  if (C <= 0 || n <= 0 || n > 4096 || max_depth < 0 || max_depth > kMaxDepth)
    return (int)cudaErrorInvalidValue;
  Params P{q0, p0, J, h, im, eps, uniforms, qp, sum_acc, n_leaf, depth,
           diverged, scratch, C, n, max_depth,
           make_uint2((uint32_t)seed, (uint32_t)(seed >> 32)),
           (uint32_t)offset, (uint32_t)(offset >> 32)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_warp_layout(n, max_depth)) {
    switch ((n + 31) / 32) {
      case 1: return (int)launch_warp<1>(P, s);
      case 2: return (int)launch_warp<2>(P, s);
      case 3: return (int)launch_warp<3>(P, s);
      case 4: return (int)launch_warp<4>(P, s);
      case 5: return (int)launch_warp<5>(P, s);
      case 6: return (int)launch_warp<6>(P, s);
      case 7: return (int)launch_warp<7>(P, s);
      default: return (int)launch_warp<8>(P, s);
    }
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  int threads = ((n + kBlockNP - 1) / kBlockNP + 31) / 32 * 32;
  size_t smem = (size_t)n * sizeof(float);
  block_kernel<<<block_grid(C), threads, smem, s>>>(P);
  return (int)cudaGetLastError();
}
