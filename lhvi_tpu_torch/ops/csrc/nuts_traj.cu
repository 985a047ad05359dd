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
// max_depth 4) a leaf is one [n] x [n, n] product per chain, 6,724 FMAs,
// and the chains take ~6.8 leaves each: ~7 GFLOP a call against 43 MB of
// compulsory traffic, so the f32 FMA rate bounds it. A product fed from
// shared memory needs a J load per FMA unless one J load serves several
// chains; the per-chain sums (energies, U-turn products) are the rest.
//
// Design. Each chain's decisions depend only on its own state and on the
// shared (d, j) leaf schedule, so chains stop at their own depth: no
// lockstep. A *team* (a warp, or a block past n = 256) holds M chains in M
// slots and integrates one leaf of every live slot per iteration, so each
// J value it loads feeds M FMAs. A slot whose chain is done writes its
// outputs and takes the next chain of the team's fixed, contiguous range
// at once, in slot order: which slot runs which chain is a function of the
// chains' own data, so every run gives the same bits.
//   Warp layout (n <= 256): lane l holds coordinates l, l+32, ... (NP =
//     ceil(n/32)) of each slot's moving point (q, p, g) in registers. A
//     leaf stages the M slots' q into a [n][M] tile, so one broadcast load
//     gives a lane M positions of one row; J is read through L1 (measured
//     on the H100: faster than a shared copy, whose room buys warps).
//     Per-slot state touched once a subtree lives in shared memory as
//     [slot][row][coordinate], each lane touching only its own
//     coordinates: the far end of the trajectory (the near end is the point
//     being integrated; a direction flip swaps the two), the proposals,
//     the checkpoint stacks (max(1, max_depth - 1) rows each: popcount of
//     an even leaf index below 2^(max_depth-1)). A leaf is a chain of
//     latencies (sums, uniforms, exp/log) more than a product, so the
//     geometry buys warps: M = 2 or 4, 12 warps, two blocks an SM where
//     the registers allow.
//   Block layout (256 < n <= 4,096): 512 threads hold 8 chains; q lives in
//     the [n][8] shared tile, J streams through shared memory in k-tiles
//     by cp.async, double-buffered, so each J element crosses L2 once per
//     block-leaf for 8 chains. p, g and the per-slot rows live in a global
//     scratch buffer (each thread its own coordinates; J traffic dwarfs it).
// The geometry (slots, warps, shared bytes, grid, k-tile) is chosen by
// ops/nuts_traj.py::k3_launch; the launcher checks it. Per-slot sums: each
// thread adds its coordinates' terms in double, then one transposed warp
// reduction (lhvi_dia::warp_sums, 2M values) serves all slots; the block
// layout adds its warps in warp order. Energies are formed and summed in
// double. In-kernel uniforms come from Philox4x32-10 keyed by a host seed,
// counter (chain, step, offset): the wrapper takes seed and offset from the
// caller's torch.Generator and advances it, so no device value is read
// back. eps is read from device memory. No tensor cores (f32, TF32 off).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dia_traj.cuh"  // philox4x32_10, warp_sums, ld/st

namespace {

using lhvi_dia::ld;
using lhvi_dia::philox4x32_10;
using lhvi_dia::st;
using lhvi_dia::warp_sums;

constexpr float kDivergence = 1000.0f;
constexpr int kMaxDepth = 20;
constexpr size_t kSmemLimit = 227 * 1024;
constexpr int kMaxWarps = 12;       // warp layout: warps a block, at most
constexpr int kBlockThreads = 512;  // block layout
constexpr int kBlockSlots = 8;
constexpr int kBlockNP = 8;         // coordinates a thread: 8 x 512 = 4,096

// slot flags
constexpr unsigned kInit = 1;   // the slot's chain needs its first gradient
constexpr unsigned kFwd = 2;    // the current subtree runs forward
constexpr unsigned kNearR = 4;  // the point being integrated is the right end
constexpr unsigned kDiv = 8;    // the chain diverged
constexpr unsigned kBad = 16;   // the current subtree diverged or turned

// per-slot rows: the far end (q, p, g), the proposal, the subtree's
// proposal, then S checkpoint rows of q and S of p
constexpr int kFarQ = 0, kFarP = 1, kFarG = 2, kProp = 3, kSubProp = 4,
              kCk = 5;

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
  float* scratch;  // block layout: [grid][8][2 + R][n]
  int C, n, max_depth, S, R, kt;
  uint2 key;
  uint32_t off_lo, off_hi;
};

__host__ __device__ constexpr size_t round16(size_t b) {
  return (b + 15) / 16 * 16;
}

// Shared bytes of one warp of the warp layout: 2M double sums, the [n][M]
// tile, M x R rows of n floats (ops/nuts_traj.py::_k3_warp_bytes).
__host__ __device__ constexpr size_t warp_bytes(int n, int M, int R) {
  return round16(16 * (size_t)M + 4 * (size_t)n * M + 4 * (size_t)M * R * n);
}

// Floats of one J stage of the block layout: kt rows and 4 floats of
// alignment slack, a multiple of 4.
__host__ __device__ constexpr size_t stage_floats(int n, int kt) {
  return ((size_t)kt * n + 4 + 3) / 4 * 4;
}

// Shared bytes of the block layout: the warps' and the block's double sums,
// the keepers' ballot words, the [n][8] tile and two J stages
// (ops/nuts_traj.py::_k3_block_bytes).
constexpr size_t kBlockHead =
    8 * (size_t)(kBlockThreads / 32 + 1) * 2 * kBlockSlots + 4 * kBlockSlots;
__host__ __device__ constexpr size_t block_bytes(int n, int kt) {
  return kBlockHead + 4 * (size_t)n * kBlockSlots + 8 * stage_floats(n, kt);
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

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- warp layout: a warp holds M slots, registers hold the moving point ---
template <int NP, int M>
struct WarpTeam {
  static constexpr int kM = M, kNP = NP;
  int lane, n, R;
  double* red;     // [2M] reduced sums
  float* tile;     // [n][M] staged positions
  float* rows;     // [M][R][n]
  const float* J;  // [n][n] global, read through L1
  float q[M][NP], p[M][NP], g[M][NP];
  float hr[NP], imr[NP];  // h and inv_mass at the lane's coordinates

  __device__ __forceinline__ int idx(int k) const { return lane + 32 * k; }
  __device__ __forceinline__ bool own(int k) const { return idx(k) < n; }
  __device__ __forceinline__ int rank() const { return lane; }
  __device__ __forceinline__ float hk(int k) const { return hr[k]; }
  __device__ __forceinline__ float imk(int k) const { return imr[k]; }
  // bit m: slot m's keeper (lane m) passed true
  __device__ __forceinline__ unsigned ballot(bool pred) const {
    return __ballot_sync(0xffffffffu, pred) & ((1u << M) - 1);
  }
  __device__ __forceinline__ float& Q(int m, int k) { return q[m][k]; }
  __device__ __forceinline__ float& Pm(int m, int k) { return p[m][k]; }
  __device__ __forceinline__ float& G(int m, int k) { return g[m][k]; }
  __device__ __forceinline__ float* row(int m, int r) const {
    return rows + ((size_t)m * R + r) * n;
  }

  // g = h - qJ for every slot (dead slots compute on stale rows)
  __device__ __forceinline__ void product() {
    __syncwarp();  // the previous product's reads of the tile are done
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      if (!own(k)) continue;
      float v[M];
#pragma unroll
      for (int m = 0; m < M; ++m) v[m] = q[m][k];
      st<M>(tile + (size_t)idx(k) * M, v);
    }
    __syncwarp();
    int jc[NP];
    float acc[M][NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      jc[k] = min(idx(k), n - 1);  // in-bounds dummy column, never used
#pragma unroll
      for (int m = 0; m < M; ++m) acc[m][k] = 0.f;
    }
#pragma unroll 4
    for (int kk = 0; kk < n; ++kk) {
      float xv[M];
      ld<M>(tile + (size_t)kk * M, xv);
      const float* Jk = J + (size_t)kk * n;
      float jv[NP];
#pragma unroll
      for (int k = 0; k < NP; ++k) jv[k] = Jk[jc[k]];
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int k = 0; k < NP; ++k) acc[m][k] = fmaf(xv[m], jv[k], acc[m][k]);
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int k = 0; k < NP; ++k) g[m][k] = own(k) ? hr[k] - acc[m][k] : 0.f;
  }

  // v[i] <- the warp's sum of v[i], in every lane
  __device__ __forceinline__ void reduce(double (&v)[2 * M]) {
    warp_sums<2 * M>(v, lane, red);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 2 * M; ++i) v[i] = red[i];
    __syncwarp();  // every lane has read red before the next reduction
  }
};

// ---- block layout: 512 threads hold 8 slots, J streamed ------------------
struct BlockTeam {
  static constexpr int kM = kBlockSlots, kNP = kBlockNP;
  int tid, n, R, kt;
  double* redw;    // [16 warps][16]
  double* red;     // [16]
  int* flags;      // [8] the keepers' ballot
  float* tile;     // [n][8]: the slots' q
  float* stage;    // 2 x stage_floats(n, kt)
  float* scr;      // this block's [8][2 + R][n]: p, g, rows
  const float* J;  // [n][n] global
  float hr[kNP], imr[kNP];  // h and inv_mass at the thread's coordinates

  __device__ __forceinline__ int idx(int k) const {
    return tid + kBlockThreads * k;
  }
  __device__ __forceinline__ bool own(int k) const { return idx(k) < n; }
  __device__ __forceinline__ int rank() const { return tid; }
  __device__ __forceinline__ float hk(int k) const { return hr[k]; }
  __device__ __forceinline__ float imk(int k) const { return imr[k]; }
  __device__ __forceinline__ unsigned ballot(bool pred) const {
    __syncthreads();  // the previous ballot's reads are done
    if (tid < kM) flags[tid] = pred ? 1 : 0;
    __syncthreads();
    unsigned b = 0;
#pragma unroll
    for (int m = 0; m < kM; ++m)
      if (flags[m]) b |= 1u << m;
    return b;
  }
  __device__ __forceinline__ float& Q(int m, int k) {
    return tile[(size_t)idx(k) * kM + m];
  }
  __device__ __forceinline__ float& Pm(int m, int k) {
    return scr[(size_t)m * (R + 2) * n + idx(k)];
  }
  __device__ __forceinline__ float& G(int m, int k) {
    return scr[((size_t)m * (R + 2) + 1) * n + idx(k)];
  }
  __device__ __forceinline__ float* row(int m, int r) const {
    return scr + ((size_t)m * (R + 2) + 2 + r) * n;
  }

  // Rows [t*kt, min((t+1)*kt, n)) of J into stage buffer b: one flat range,
  // placed at the same offset mod 4 as its source so that the body goes by
  // 16-byte copies; returns that offset (floats).
  __device__ __forceinline__ int load_stage(int t, int b) const {
    const size_t src0 = (size_t)t * kt * n;
    const size_t len = (size_t)min(kt, n - t * kt) * n;
    const int phase = (int)(src0 & 3);
    float* dst = stage + b * stage_floats(n, kt) + phase;
    const float* src = J + src0;
    const size_t lead = (size_t)((4 - phase) & 3);
    const size_t head = lead < len ? lead : len;
    const size_t body = (len - head) / 4;
    for (size_t e = tid; e < head; e += kBlockThreads)
      cp_async4(dst + e, src + e);
    for (size_t c = tid; c < body; c += kBlockThreads)
      cp_async16(dst + head + 4 * c, src + head + 4 * c);
    for (size_t e = head + 4 * body + tid; e < len; e += kBlockThreads)
      cp_async4(dst + e, src + e);
    cp_async_commit();
    return phase;
  }

  __device__ __forceinline__ void product() {
    __syncthreads();  // every thread's q is in the tile
    float acc[kM][kNP];
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int k = 0; k < kNP; ++k) acc[m][k] = 0.f;
    const int nt = (n + kt - 1) / kt;
    int ph[2];
    ph[0] = load_stage(0, 0);
    ph[1] = 0;
    for (int t = 0; t < nt; ++t) {
      if (t + 1 < nt) {
        ph[(t + 1) & 1] = load_stage(t + 1, (t + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* Js = stage + (t & 1) * stage_floats(n, kt) + ph[t & 1];
      const int k0 = t * kt, kn = min(kt, n - k0);
      for (int kk = 0; kk < kn; ++kk) {
        float xv[kM];
        ld<kM>(tile + (size_t)(k0 + kk) * kM, xv);
        const float* Jk = Js + (size_t)kk * n;
#pragma unroll
        for (int k = 0; k < kNP; ++k) {
          if (!own(k)) continue;
          const float jv = Jk[idx(k)];
#pragma unroll
          for (int m = 0; m < kM; ++m) acc[m][k] = fmaf(xv[m], jv, acc[m][k]);
        }
      }
      __syncthreads();  // the stage is read before it is refilled
    }
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int k = 0; k < kNP; ++k)
        if (own(k)) G(m, k) = hk(k) - acc[m][k];
  }

  // v[i] <- the block's sum of v[i] (warps added in warp order), everywhere
  __device__ __forceinline__ void reduce(double (&v)[2 * kM]) {
    const int lane = tid & 31, warp = tid >> 5;
    warp_sums<2 * kM>(v, lane, redw + warp * 2 * kM);
    __syncthreads();
    if (tid < 2 * kM) {
      double s = 0.0;
      for (int w = 0; w < kBlockThreads / 32; ++w) s += redw[w * 2 * kM + tid];
      red[tid] = s;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2 * kM; ++i) v[i] = red[i];
  }
};

// a[i] for a runtime i without indexing a register array (i >= M: a[0])
template <int M, class V>
__device__ __forceinline__ V pick(const V (&a)[M], int i) {
  V r = a[0];
#pragma unroll
  for (int m = 1; m < M; ++m)
    if (i == m) r = a[m];
  return r;
}

// The team's chains [cb, ce), M at a time. Every thread keeps the integer
// books of every slot (chain, depth, leaf index, flags) and the coordinates
// it owns; thread m of the team (m < M) is slot m's *keeper*: it alone
// holds the slot's float books (h0, log_w, sub_log_w, sum_acc), draws its
// uniforms and takes its multinomial and merge decisions, which reach the
// team as ballots. So the slots' transcendental and Philox work runs side
// by side in M threads, and every decision is uniform across the team.
template <class Team>
__device__ __forceinline__ void run(Team& T, const Params& P, int cb, int ce) {
  constexpr int M = Team::kM, NP = Team::kNP;
  const int n = P.n, D = P.max_depth, S = P.S;
  const float eps = *P.eps;
  const int me = T.rank();
  const bool keeper = me < M;
  int cs[M], ds[M], js[M];
  unsigned fl[M];
  float log_w = 0.f, sub_log_w = -INFINITY, sum_acc = 0.f;  // the keeper's
  double h0 = 0.0;
  int next = cb;

  auto start_chain = [&](int m) {
    const int c = cs[m];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      if (!T.own(k)) continue;
      T.Q(m, k) = P.q0[(size_t)c * n + T.idx(k)];
      T.Pm(m, k) = P.p0[(size_t)c * n + T.idx(k)];
    }
    fl[m] = kInit;
  };
#pragma unroll
  for (int m = 0; m < M; ++m) {
    ds[m] = js[m] = 0;
    fl[m] = 0;
    cs[m] = next < ce ? next++ : -1;
    if (cs[m] >= 0) start_chain(m);
  }

  while (true) {
    unsigned live = 0;
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (cs[m] >= 0) live |= 1u << m;
    if (!live) break;
    const int kc = pick(cs, me);
    const unsigned kf = pick(fl, me);
    const bool kleaf = keeper && kc >= 0 && !(kf & kInit);

    // the keeper's leaf uniform, ahead of the product that hides its latency
    float u_leaf = 1.f;
    if (kleaf)
      u_leaf = uniform(P, kc, 1, (1 << pick(ds, me)) - 1 + pick(js, me));

    // first half kick and drift of every slot on a leaf
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (cs[m] < 0 || (fl[m] & kInit)) continue;
      const float e = (fl[m] & kFwd) ? eps : -eps;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        if (!T.own(k)) continue;
        float& pp = T.Pm(m, k);
        pp = pp + 0.5f * e * T.G(m, k);
        float& qq = T.Q(m, k);
        qq = qq + e * T.imk(k) * pp;
      }
    }
    T.product();

    // second half kick; the energy's two sums
    double v[2 * M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      v[2 * m] = v[2 * m + 1] = 0.0;
      if (cs[m] < 0) continue;
      const bool leaf = !(fl[m] & kInit);
      const float e = (fl[m] & kFwd) ? eps : -eps;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        if (!T.own(k)) continue;
        float& pp = T.Pm(m, k);
        const float gg = T.G(m, k);
        if (leaf) pp = pp + 0.5f * e * gg;
        v[2 * m] += (double)T.Q(m, k) * ((double)T.hk(k) + (double)gg);
        v[2 * m + 1] += (double)T.imk(k) * (double)pp * (double)pp;
      }
    }
    T.reduce(v);

    // the keeper's books: a chain's start, or the leaf's weight, accept
    // term and multinomial choice
    bool k_take = false, k_div = false;
    if (keeper && kc >= 0) {
      const double H = -0.5 * pick(v, 2 * me) + 0.5 * pick(v, 2 * me + 1);
      if (kf & kInit) {
        h0 = H;
        log_w = sum_acc = 0.f;
      } else {
        const float dh = (float)(H - h0);
        k_div = !isfinite(dh) || dh > kDivergence;
        const float lw = k_div ? -INFINITY : -dh;
        sum_acc += isfinite(dh) ? fminf(1.f, expf(-dh)) : 0.f;
        sub_log_w = logaddexpf_(sub_log_w, lw);
        k_take = !k_div && logf(u_leaf) < lw - sub_log_w;
      }
    }
    const unsigned take = T.ballot(k_take), divs = T.ballot(k_div);

    unsigned leaf = 0, begin = 0, init_done = 0;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (cs[m] < 0) continue;
      if (fl[m] & kInit) {  // the chain's start: both ends, the proposal
#pragma unroll
        for (int k = 0; k < NP; ++k) {
          if (!T.own(k)) continue;
          const int i = T.idx(k);
          T.row(m, kFarQ)[i] = T.Q(m, k);
          T.row(m, kFarP)[i] = T.Pm(m, k);
          T.row(m, kFarG)[i] = T.G(m, k);
          T.row(m, kProp)[i] = T.Q(m, k);
        }
        ds[m] = js[m] = 0;
        fl[m] = 0;
        if (D == 0) init_done |= 1u << m;
        else begin |= 1u << m;
        continue;
      }
      leaf |= 1u << m;
      if (take & (1u << m)) {
#pragma unroll
        for (int k = 0; k < NP; ++k)
          if (T.own(k)) T.row(m, kSubProp)[T.idx(k)] = T.Q(m, k);
      }
      if ((js[m] & 1) == 0) {  // checkpoint even leaves at slot popcount(j)
        const int sl = __popc(js[m]);
#pragma unroll
        for (int k = 0; k < NP; ++k) {
          if (!T.own(k)) continue;
          T.row(m, kCk + sl)[T.idx(k)] = T.Q(m, k);
          T.row(m, kCk + S + sl)[T.idx(k)] = T.Pm(m, k);
        }
      }
      if (divs & (1u << m)) fl[m] |= kDiv | kBad;
    }

    // odd leaves: U-turn checks against the checkpoints, one round per
    // level l for every slot still checking
    unsigned turned = 0;
    for (int l = 0;; ++l) {
      unsigned part = 0;
#pragma unroll
      for (int m = 0; m < M; ++m)
        if ((leaf & (1u << m)) && (js[m] & 1) && l < __ffs(js[m] + 1) - 1 &&
            !(turned & (1u << m)))
          part |= 1u << m;
      if (!part) break;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        v[2 * m] = v[2 * m + 1] = 0.0;
        if (!(part & (1u << m))) continue;
        const int sl = __popc(js[m] + 1 - (2 << l));
#pragma unroll
        for (int k = 0; k < NP; ++k) {
          if (!T.own(k)) continue;
          const int i = T.idx(k);
          const float dq = T.Q(m, k) - T.row(m, kCk + sl)[i];
          v[2 * m] += (double)(dq * T.imk(k) * T.row(m, kCk + S + sl)[i]);
          v[2 * m + 1] += (double)(dq * T.imk(k) * T.Pm(m, k));
        }
      }
      T.reduce(v);
#pragma unroll
      for (int m = 0; m < M; ++m)
        if ((part & (1u << m)) && (v[2 * m] < 0.0 || v[2 * m + 1] < 0.0))
          turned |= 1u << m;
    }

    // end of the leaf; a subtree that ended well is merged by its keeper
    unsigned ended = 0, glob = 0;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (!(leaf & (1u << m))) continue;
      if (turned & (1u << m)) fl[m] |= kBad;
      js[m] += 1;
      if ((fl[m] & kBad) || js[m] == (1 << ds[m])) {
        ended |= 1u << m;
        if (!(fl[m] & kBad)) glob |= 1u << m;
      }
    }
    bool k_merge = false;
    if (keeper && ((glob >> me) & 1)) {
      const float um = uniform(P, kc, 2, (2 << pick(ds, me)) - 1);
      k_merge = logf(um) < sub_log_w - log_w;
      log_w = logaddexpf_(log_w, sub_log_w);
    }
    const unsigned merge = T.ballot(k_merge);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (!(merge & (1u << m))) continue;
#pragma unroll
      for (int k = 0; k < NP; ++k)
        if (T.own(k)) T.row(m, kProp)[T.idx(k)] = T.row(m, kSubProp)[T.idx(k)];
    }

    // U-turn across the whole trajectory of every merged slot (its near
    // end is the subtree's last point)
    unsigned gturn = 0;
    if (glob) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        v[2 * m] = v[2 * m + 1] = 0.0;
        if (!(glob & (1u << m))) continue;
        const bool near_r = (fl[m] & kNearR) != 0;
#pragma unroll
        for (int k = 0; k < NP; ++k) {
          if (!T.own(k)) continue;
          const int i = T.idx(k);
          const float fq = T.row(m, kFarQ)[i], fp = T.row(m, kFarP)[i];
          const float qr = near_r ? T.Q(m, k) : fq;
          const float ql = near_r ? fq : T.Q(m, k);
          const float pr = near_r ? T.Pm(m, k) : fp;
          const float pl = near_r ? fp : T.Pm(m, k);
          const float dq = qr - ql;
          v[2 * m] += (double)(dq * T.imk(k) * pl);
          v[2 * m + 1] += (double)(dq * T.imk(k) * pr);
        }
      }
      T.reduce(v);
#pragma unroll
      for (int m = 0; m < M; ++m)
        if ((glob & (1u << m)) && (v[2 * m] < 0.0 || v[2 * m + 1] < 0.0))
          gturn |= 1u << m;
    }

    // done, or one level deeper
    unsigned done = init_done;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (!(ended & (1u << m))) continue;
      if ((fl[m] & kBad) || ds[m] + 1 == D || (gturn & (1u << m))) {
        done |= 1u << m;
      } else {
        ds[m] += 1;
        begin |= 1u << m;
      }
    }
    // a new subtree: its keeper draws the direction; the end it grows from
    // becomes the point being integrated
    bool k_fwd = false;
    if (keeper && ((begin >> me) & 1)) {
      k_fwd = uniform(P, kc, 0, (1 << pick(ds, me)) - 1) < 0.5f;
      sub_log_w = -INFINITY;
    }
    const unsigned fwds = T.ballot(k_fwd);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (!(begin & (1u << m))) continue;
      const bool fwd = (fwds >> m) & 1;
      if (fwd != ((fl[m] & kNearR) != 0)) {
#pragma unroll
        for (int k = 0; k < NP; ++k) {
          if (!T.own(k)) continue;
          const int i = T.idx(k);
          float* fq = T.row(m, kFarQ) + i;
          float* fp = T.row(m, kFarP) + i;
          float* fg = T.row(m, kFarG) + i;
          const float a = *fq, b = *fp, c = *fg;
          *fq = T.Q(m, k);
          *fp = T.Pm(m, k);
          *fg = T.G(m, k);
          T.Q(m, k) = a;
          T.Pm(m, k) = b;
          T.G(m, k) = c;
        }
      }
      fl[m] = (fl[m] & kDiv) | (fwd ? kFwd | kNearR : 0u);
      js[m] = 0;
    }
    // finished chains: outputs, then the next chains of the range, in
    // slot order
    if (keeper && ((done >> me) & 1)) {
      P.sum_acc[kc] = sum_acc;
      P.n_leaf[kc] = (1 << pick(ds, me)) - 1 + pick(js, me);
      P.depth[kc] = D == 0 ? 0 : pick(ds, me) + 1;
      P.diverged[kc] = (pick(fl, me) & kDiv) ? 1 : 0;
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (!(done & (1u << m))) continue;
#pragma unroll
      for (int k = 0; k < NP; ++k)
        if (T.own(k))
          P.qp[(size_t)cs[m] * n + T.idx(k)] = T.row(m, kProp)[T.idx(k)];
      cs[m] = next < ce ? next++ : -1;
      if (cs[m] >= 0) start_chain(m);
    }
  }
}

// Two blocks an SM where a thread's M x NP tile is small enough for 85
// registers, else one (168 registers): occupancy, not J's reuse, sets the
// pace of a leaf, whose sums and bookkeeping are latency chains.
template <int NP, int M>
__global__ void __launch_bounds__(kMaxWarps * 32, M * NP <= 8 ? 2 : 1)
    warp_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = blockDim.x >> 5, n = P.n;
  unsigned char* mine = smem + (size_t)warp * warp_bytes(n, M, P.R);
  WarpTeam<NP, M> T;
  T.lane = lane;
  T.n = n;
  T.R = P.R;
  T.red = reinterpret_cast<double*>(mine);
  T.tile = reinterpret_cast<float*>(mine + 16 * M);
  T.rows = T.tile + (size_t)n * M;
  T.J = P.J;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    T.hr[k] = T.own(k) ? P.h[T.idx(k)] : 0.f;
    T.imr[k] = T.own(k) ? P.im[T.idx(k)] : 0.f;
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int k = 0; k < NP; ++k) T.q[m][k] = T.p[m][k] = T.g[m][k] = 0.f;
  // this warp's contiguous range of chains
  const long long teams = (long long)gridDim.x * W;
  const long long w = (long long)blockIdx.x * W + warp;
  run(T, P, (int)(w * P.C / teams), (int)((w + 1) * P.C / teams));
}

__global__ void __launch_bounds__(kBlockThreads, 1) block_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  BlockTeam T;
  T.tid = threadIdx.x;
  T.n = P.n;
  T.R = P.R;
  T.kt = P.kt;
  T.redw = reinterpret_cast<double*>(smem);
  T.red = T.redw + (kBlockThreads / 32) * 2 * kBlockSlots;
  T.flags = reinterpret_cast<int*>(T.red + 2 * kBlockSlots);
  T.tile = reinterpret_cast<float*>(smem + kBlockHead);
  T.stage = T.tile + (size_t)P.n * kBlockSlots;
  T.scr = P.scratch + (size_t)blockIdx.x * kBlockSlots * (P.R + 2) * P.n;
  T.J = P.J;
#pragma unroll
  for (int k = 0; k < kBlockNP; ++k) {
    T.hr[k] = T.own(k) ? P.h[T.idx(k)] : 0.f;
    T.imr[k] = T.own(k) ? P.im[T.idx(k)] : 0.f;
  }
  const long long b = blockIdx.x, G = gridDim.x;
  run(T, P, (int)(b * P.C / G), (int)((b + 1) * P.C / G));
}

template <int NP, int M>
cudaError_t launch_warp(const Params& P, int warps, int smem, int grid,
                        cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      warp_kernel<NP, M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  warp_kernel<NP, M><<<grid, warps * 32, smem, s>>>(P);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch_np(const Params& P, int M, int warps, int smem, int grid,
                      cudaStream_t s) {
  if (M == 4) {
    if constexpr (NP <= 2) return launch_warp<NP, 4>(P, warps, smem, grid, s);
    return cudaErrorInvalidConfiguration;
  }
  if (M == 2) return launch_warp<NP, 2>(P, warps, smem, grid, s);
  return launch_warp<NP, 1>(P, warps, smem, grid, s);
}

int stack_rows(int max_depth) { return max_depth > 2 ? max_depth - 1 : 1; }

}  // namespace

// Floats of global scratch the block layout needs for `grid` blocks at
// (n, max_depth): per block 8 slots x (p, g and the R rows) x n.
extern "C" int lhvi_nuts_traj_scratch(int grid, int n, int max_depth) {
  if (grid <= 0 || n <= 0 || max_depth < 0 || max_depth > kMaxDepth) return 0;
  return grid * kBlockSlots * (2 + kCk + 2 * stack_rows(max_depth)) * n;
}

// layout 0 (warp: slots a warp, warps a block) or 1 (block: 8 slots, 16
// warps, J in k-tiles of kt rows); smem and grid
// from ops/nuts_traj.py::k3_launch, checked here against the kernel's own
// reckoning.
extern "C" int lhvi_nuts_traj(const float* q0, const float* p0, const float* J,
                              const float* h, const float* im, const float* eps,
                              const float* uniforms, float* qp, float* sum_acc,
                              int* n_leaf, int* depth, unsigned char* diverged,
                              float* scratch, int C, int n, int max_depth,
                              unsigned long long seed,
                              unsigned long long offset, int layout, int slots,
                              int warps, int smem, int grid, int kt,
                              void* stream) {
  if (C <= 0 || n <= 0 || n > kBlockNP * kBlockThreads || max_depth < 0 ||
      max_depth > kMaxDepth)
    return (int)cudaErrorInvalidValue;
  const int S = stack_rows(max_depth), R = kCk + 2 * S;
  Params P{q0, p0, J, h, im, eps, uniforms, qp, sum_acc, n_leaf, depth,
           diverged, scratch, C, n, max_depth, S, R, kt,
           make_uint2((uint32_t)seed, (uint32_t)(seed >> 32)),
           (uint32_t)offset, (uint32_t)(offset >> 32)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid < 1 || smem < 0 || (size_t)smem > kSmemLimit)
    return (int)cudaErrorInvalidConfiguration;
  if (layout == 0) {
    const int np = (n + 31) / 32;
    const int m_max = np <= 2 ? 4 : 2;
    if (n > 256 || (slots != 1 && slots != 2 && slots != 4) || slots > m_max ||
        warps < 1 || warps > kMaxWarps ||
        (size_t)smem < (size_t)warps * warp_bytes(n, slots, R))
      return (int)cudaErrorInvalidConfiguration;
    switch (np) {
      case 1: return (int)launch_np<1>(P, slots, warps, smem, grid, s);
      case 2: return (int)launch_np<2>(P, slots, warps, smem, grid, s);
      case 3: return (int)launch_np<3>(P, slots, warps, smem, grid, s);
      case 4: return (int)launch_np<4>(P, slots, warps, smem, grid, s);
      case 5: return (int)launch_np<5>(P, slots, warps, smem, grid, s);
      case 6: return (int)launch_np<6>(P, slots, warps, smem, grid, s);
      case 7: return (int)launch_np<7>(P, slots, warps, smem, grid, s);
      default: return (int)launch_np<8>(P, slots, warps, smem, grid, s);
    }
  }
  if (layout != 1 || slots != kBlockSlots ||
      warps != kBlockThreads / 32 || kt < 1 || scratch == nullptr ||
      (size_t)smem < block_bytes(n, kt))
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  block_kernel<<<grid, kBlockThreads, smem, s>>>(P);
  return (int)cudaGetLastError();
}
