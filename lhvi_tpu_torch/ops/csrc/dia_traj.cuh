// The banded (DIA) trajectory that K2 (dia_proposal.cu) and K6
// (dia_leapfrog.cu) share, so that the two kernels cannot drift apart.
//
// Position-Verlet on J x = diag*x + sum_k w_k * x[i + o_k] in embedded
// coordinates (n_emb lanes), with the shifted index wrapped modulo n_emb: a
// wrapped neighbour always meets a structural-zero weight
// (ops/dia.py::ell_to_dia asserts it), as in the reference's circular roll.
// lp = 1/2 sum x(h + g) with g = h - J x, summed in double.
//
// What binds (the 128x128 grid, 16,384 lanes, 4 offsets, 6 steps). Each
// step reads every lane's own position and its four neighbours for every
// chain of a group from shared memory, then one cluster barrier; those
// reads are the step's cost. Kept as [lane][CB], a warp's 16-byte loads
// fell 32 bytes apart, a 2-way bank conflict on every load; as planes they
// are conflict-free. Holding the positions in registers instead (a
// thread's tile of rows, row neighbours in its own registers, column
// neighbours by warp shuffles, only the halo in shared memory) took more
// instructions and registers than the loads it saved, and measured slower
// on the H100 (PERF.md, the port's kernels).
//
// Layout (the geometry comes from ops/dia.py::dia_launch, and
// check_launch() holds the launcher to it):
//   - A thread block cluster of S blocks (S in 1, 2, 4, 8) splits the
//     embedded row into S slices of `slice` lanes, one per block, and
//     integrates CB chains (1, 2, 4 or 8) at once. At the 128x128 grid
//     (16,384 lanes, K = 4): S = 8, slice = 2,048, CB = 8, 512 threads.
//   - Each block stages its slice's lane constants (diag, h, im, the latent
//     index and K rows of wdia) in shared memory ONCE per launch, reading
//     diag, h and im through the inverse embedding: lane i takes latent
//     inv[i], or 0 at a gap lane. A persistent cluster then walks over
//     chain groups, so the constants are read from device memory once per
//     block and from shared memory once per lane and step for all CB
//     chains.
//   - Positions live in shared memory as CB / 4 planes of float4,
//     [CB / 4][slice] (consecutive lanes 16 bytes apart: no bank
//     conflict), double-buffered: step s reads x_s and writes x_{s+1}, so
//     a step costs ONE cluster barrier: a block barrier, one thread's
//     cluster-scope fence (cumulative over the block's writes) and a
//     relaxed cluster arrive. A neighbour in another block's slice is read
//     through distributed shared memory.
//   - Momenta live in registers: lane i of a slice is owned by thread
//     i mod T for the whole trajectory, so no other thread touches its
//     momentum. A thread holds at most kRegLanes lane-chains; blocks have
//     at most 512 threads, so that 128 registers a thread hold them
//     without spilling.
//   - Chain rows are read and written in latent coordinates: lane i reads
//     x[c, inv[i]] (0 at a gap lane) and writes x1 back to the same place;
//     gap lanes have diag = h = im = 0 and zero weights, so they stay 0.
// Momenta (K2): Philox4x32-10 with counter (lane quad, chain, offset), staged
// as std * z in the second buffer until the first drift, so a generator
// state gives the same momenta bit for bit whatever the layout.
// Per-chain sums: each thread adds its lanes' terms per chain, each warp
// reduces them with a fixed shuffle pattern (warp_sums) into shared
// memory, the block adds its warps in warp order, and rank 0 adds the S
// blocks' partials in rank order, so every run gives the same bits.
// The Metropolis select (K2 given uniforms u): the trajectories write x1
// as they end, unchanged; once a cluster's groups are all done, each of
// its blocks reads back the log-accepts rank 0 wrote and puts its lanes of
// every rejected chain's row back to x0, so the launch leaves the next
// state and the [C, n] select pass after it goes. Deciding per group
// instead, in every block between a group's sums and the next group,
// measured 0.5-0.75 ms slower a launch at 16,384 chains (PERF.md).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include "cluster_util.cuh"

namespace lhvi_dia {

namespace cg = cooperative_groups;

constexpr int kMaxOffsets = 8;
constexpr int kMaxThreads = 512;
constexpr int kRegLanes = 32;   // momenta a thread holds: lanes x chains
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr size_t kSmemLimit = 227 * 1024;

struct Offsets {
  int o[kMaxOffsets];
};

struct Args {
  const float* x;     // [C, n] latent positions
  const float* p;     // [C, n] latent momenta (K6; K2's test mode) or null
  const float* diag;  // [n] latent
  const float* wdia;  // [K, n_emb] embedded
  const float* h;     // [n] latent
  const float* im;    // [n] latent inverse mass
  const int64_t* inv; // [n_emb] latent index, n at a gap lane; null: identity
  const float* eps;   // device scalar
  const float* u;     // K2: [C] uniforms, xo the selected state; null: x1
  float* xo;          // [C, n]
  float* po;          // [C, n] (K6) or null
  float* out0;        // K2: log_acc [C]; K6: lp0 [C]
  float* out1;        // K6: lp1 [C]
  int C, n, n_emb, K, n_steps, slice;
  Offsets offs;
  uint2 key;          // K2's Philox key
  uint32_t off_lo, off_hi;
};

// Dynamic shared memory of a block: per-warp, per-block and (rank 0)
// per-cluster double partials, the slice's lane constants and two
// position buffers.
inline size_t smem_bytes(int K, int chains, int slice, int threads) {
  return sizeof(double) * (size_t)chains *
             (2 * (threads / 32) + 2 + 2 * kMaxCluster) +
         sizeof(float) * (size_t)slice * (4 + K + 2 * chains);
}

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

// A lane's values for all CB chains: one 16-, 8- or 4-byte access each.
template <int CB>
__device__ __forceinline__ void ld(const float* p, float (&v)[CB]) {
  if constexpr (CB % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CB; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + c);
      v[c] = t.x; v[c + 1] = t.y; v[c + 2] = t.z; v[c + 3] = t.w;
    }
  } else if constexpr (CB == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

template <int CB>
__device__ __forceinline__ void st(float* p, const float (&v)[CB]) {
  if constexpr (CB % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CB; c += 4)
      *reinterpret_cast<float4*>(p + c) =
          make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
  } else if constexpr (CB == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// A lane's values for all CB chains in a position buffer: CB / 4 planes of
// float4, [CB / 4][slice] (below 4 chains, one access of ld / st).
template <int CB>
__device__ __forceinline__ void ld_lane(const float* buf, int slice, int i,
                                        float (&v)[CB]) {
  if constexpr (CB % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CB; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(
          buf + ((size_t)(c / 4) * slice + i) * 4);
      v[c] = t.x; v[c + 1] = t.y; v[c + 2] = t.z; v[c + 3] = t.w;
    }
  } else {
    ld<CB>(buf + (size_t)i * CB, v);
  }
}

template <int CB>
__device__ __forceinline__ void st_lane(float* buf, int slice, int i,
                                        const float (&v)[CB]) {
  if constexpr (CB % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CB; c += 4)
      *reinterpret_cast<float4*>(buf + ((size_t)(c / 4) * slice + i) * 4) =
          make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
  } else {
    st<CB>(buf + (size_t)i * CB, v);
  }
}

// Where chain c of lane i lies in a position buffer.
template <int CB>
__device__ __forceinline__ size_t plane_at(int slice, int i, int c) {
  if constexpr (CB % 4 == 0)
    return ((size_t)(c / 4) * slice + i) * 4 + c % 4;
  else
    return (size_t)i * CB + c;
}

// The step's cluster barrier: the block's writes gathered by a block
// barrier and released to the cluster by one thread's fence (cumulative),
// then a relaxed arrive and an acquiring wait. The same ordering as
// cluster_group::sync(), whose release fences every thread.
__device__ __forceinline__ void cluster_barrier() {
  __syncthreads();
  if (threadIdx.x == 0) asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  asm volatile(
      "barrier.cluster.arrive.relaxed.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The warp's sums of v[c] for all CB chains in 4 + 2 + 1 + 2 (CB = 8)
// double shuffles instead of CB butterflies of 5: at each of the first
// log2(CB) levels a lane keeps half of its values and adds its partner's
// half of them, then a butterfly over the remaining lanes. Writes chain
// c's sum to out[c] from one lane; the pattern is fixed, so every run
// gives the same bits.
template <int CB>
__device__ __forceinline__ void warp_sums(double (&v)[CB], int lane,
                                          double* out) {
  int c = 0;
  int o = 16;
#pragma unroll
  for (int k = CB; k > 1; k >>= 1, o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int j = 0; j < k / 2; ++j) {
      const double send = upper ? v[j] : v[j + k / 2];
      const double keep = upper ? v[j + k / 2] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    if (upper) c += k / 2;
  }
  double s = v[0];
#pragma unroll
  for (int r = o; r > 0; r >>= 1) s += __shfl_xor_sync(0xffffffffu, s, r);
  if ((lane & (2 * o - 1)) == 0) out[c] = s;
}

// The whole trajectory for every chain group of the launch. kProposal: K2
// (momenta drawn in-kernel unless a.p is given, log_acc out; x1 out, or
// with a.u the Metropolis-selected state); otherwise K6 (momenta from a.p;
// x1, p1, lp0, lp1 out).
template <int CB, bool kProposal>
__device__ __forceinline__ void run(const Args& a) {
  constexpr int ML = kRegLanes / CB;  // lanes a thread owns, at most
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int S = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x, T = blockDim.x, W = T >> 5;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = a.n_emb, K = a.K, slice = a.slice;
  const int lo = rank * slice;
  const int own = max(0, min(slice, n - lo));  // this block's lanes
  const int lpt = (own + T - 1) / T;           // <= ML (check_launch)

  double* red = reinterpret_cast<double*>(smem_raw);  // [2][W][CB]
  double* part = red + 2 * W * CB;                     // [2][CB]
  double* gath = part + 2 * CB;           // rank 0: [kMaxCluster][2][CB]
  float* cdiag = reinterpret_cast<float*>(gath + 2 * kMaxCluster * CB);
  float* ch = cdiag + slice;
  float* cim = ch + slice;
  int* cinv = reinterpret_cast<int*>(cim + slice);   // latent index or -1
  float* cw = reinterpret_cast<float*>(cinv + slice);  // [K][slice]
  float* buf0 = cw + (size_t)K * slice;                // [CB / 4][slice]
  float* buf1 = buf0 + (size_t)slice * CB;

  for (int i = tid; i < own; i += T) {
    const int g = lo + i;
    const int v = a.inv != nullptr ? (int)a.inv[g] : g;
    const bool lat = v < a.n;
    cdiag[i] = lat ? a.diag[v] : 0.f;
    ch[i] = lat ? a.h[v] : 0.f;
    cim[i] = lat ? a.im[v] : 0.f;
    cinv[i] = lat ? v : -1;
    for (int k = 0; k < K; ++k) cw[k * slice + i] = a.wdia[(size_t)k * n + g];
  }
  const float eps = *a.eps;
  __syncthreads();

  // x[j] of every chain of the group, j an embedded lane of any slice
  auto fetch = [&](float* buf, int j, float (&v)[CB]) {
    const int jl = j - lo;
    if ((unsigned)jl < (unsigned)slice) {
      ld_lane<CB>(buf, slice, jl, v);
    } else {
      const int r = j / slice;
      const float* rb = cl.map_shared_rank(buf, (unsigned)r);
      ld_lane<CB>(rb, slice, j - r * slice, v);
    }
  };
  // x of lane i (local) and g = h - J x, for every chain
  auto grad = [&](float* buf, int i, float (&x)[CB], float (&g)[CB]) {
    ld_lane<CB>(buf, slice, i, x);
    const float d = cdiag[i];
#pragma unroll
    for (int c = 0; c < CB; ++c) g[c] = d * x[c];
#pragma unroll
    for (int k = 0; k < kMaxOffsets; ++k) {
      if (k >= K) break;
      int j = lo + i + a.offs.o[k];
      if (j < 0) j += n; else if (j >= n) j -= n;
      const float w = cw[k * slice + i];
      float nb[CB];
      fetch(buf, j, nb);
#pragma unroll
      for (int c = 0; c < CB; ++c) g[c] += w * nb[c];
    }
    const float hh = ch[i];
#pragma unroll
    for (int c = 0; c < CB; ++c) g[c] = hh - g[c];
  };
  const int n_groups = (a.C + CB - 1) / CB;
  const int n_clusters = gridDim.x / S;
  for (int grp = blockIdx.x / S; grp < n_groups; grp += n_clusters) {
    const int c0 = grp * CB;
    // x0 -> buf0, 0 at gap lanes and for chains past C (unrolled over a
    // thread's lanes, so that all of its loads are in flight at once)
#pragma unroll
    for (int l = 0; l < ML; ++l) {
      const int i = tid + l * T;
      if (l < lpt && i < own) {
        const int v = cinv[i];
        float xv[CB];
#pragma unroll
        for (int c = 0; c < CB; ++c)
          xv[c] = (v >= 0 && c0 + c < a.C) ? a.x[(size_t)(c0 + c) * a.n + v]
                                           : 0.f;
        st_lane<CB>(buf0, slice, i, xv);
      }
    }
    float m[ML][CB];
    if (a.p != nullptr) {
#pragma unroll
      for (int l = 0; l < ML; ++l) {
        const int i = tid + l * T;
        const int v = (l < lpt && i < own) ? cinv[i] : -1;
#pragma unroll
        for (int c = 0; c < CB; ++c)
          m[l][c] = (v >= 0 && c0 + c < a.C)
                        ? a.p[(size_t)(c0 + c) * a.n + v] : 0.f;
      }
    } else {
      // Philox4x32-10, counter (lane quad, chain, offset): std * z per lane
      // into buf1 (free until the first drift), then into registers
      const int nq = (own + 3) / 4;
      for (int e = tid; e < nq * CB; e += T) {
        const int ql = e / CB, c = e - ql * CB;
        const uint4 r = philox4x32_10(
            make_uint4((uint32_t)((lo >> 2) + ql), (uint32_t)(c0 + c),
                       a.off_lo, a.off_hi), a.key);
        float z[4];
        box_muller(r.x, r.y, &z[0], &z[1]);
        box_muller(r.z, r.w, &z[2], &z[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * ql + j;
          if (i < own) {
            const float imv = cim[i];
            const float sd = imv > 0.f ? sqrtf(1.0f / fmaxf(imv, 1e-12f))
                                       : 0.f;
            buf1[plane_at<CB>(slice, i, c)] = sd * z[j];
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int l = 0; l < ML; ++l) {
        const int i = tid + l * T;
        if (l < lpt && i < own) {
          ld_lane<CB>(buf1, slice, i, m[l]);
        } else {
#pragma unroll
          for (int c = 0; c < CB; ++c) m[l][c] = 0.f;
        }
      }
    }
    cluster_barrier();  // the cluster's x0 in place; buf1 read

    // start: lp0 (K2: minus the kinetic energy), the first half-kick and
    // drift x1 -> buf1; each thread sums its lanes' terms per chain
    double acc[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[c] = 0.0;
#pragma unroll
    for (int l = 0; l < ML; ++l) {
      const int i = tid + l * T;
      if (l < lpt && i < own) {
        float x[CB], g[CB];
        grad(buf0, i, x, g);
        const float hh = ch[i], imv = cim[i];
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          acc[c] += (double)(x[c] * (hh + g[c]));
          if (kProposal) acc[c] -= (double)(imv * m[l][c] * m[l][c]);
          if (a.n_steps > 0) {
            m[l][c] = m[l][c] + 0.5f * eps * g[c];
            x[c] = x[c] + eps * imv * m[l][c];
          }
        }
        if (a.n_steps > 0) st_lane<CB>(buf1, slice, i, x);
      }
    }
    warp_sums<CB>(acc, lane, red + warp * CB);
    if (a.n_steps > 0) cluster_barrier();
    for (int s = 1; s < a.n_steps; ++s) {
      float* cur = (s & 1) ? buf1 : buf0;
      float* nxt = (s & 1) ? buf0 : buf1;
#pragma unroll
      for (int l = 0; l < ML; ++l) {
        const int i = tid + l * T;
        if (l < lpt && i < own) {
          float x[CB], g[CB];
          grad(cur, i, x, g);
          const float imv = cim[i];
#pragma unroll
          for (int c = 0; c < CB; ++c) {
            m[l][c] += eps * g[c];
            x[c] = x[c] + eps * imv * m[l][c];
          }
          st_lane<CB>(nxt, slice, i, x);
        }
      }
      cluster_barrier();
    }
    // end: lp1 (K2: minus the kinetic energy), the last half-kick; x1 and
    // (K6) p1 back to latent rows. n_steps == 0 repeats the start exactly.
    float* cur = (a.n_steps & 1) ? buf1 : buf0;
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[c] = 0.0;
#pragma unroll
    for (int l = 0; l < ML; ++l) {
      const int i = tid + l * T;
      if (l < lpt && i < own) {
        float x[CB], g[CB];
        grad(cur, i, x, g);
        const float hh = ch[i], imv = cim[i];
        const int v = cinv[i];
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          acc[c] += (double)(x[c] * (hh + g[c]));
          const float p1 = a.n_steps > 0 ? m[l][c] + 0.5f * eps * g[c]
                                         : m[l][c];
          if (kProposal) acc[c] -= (double)(imv * p1 * p1);
          if (v >= 0 && c0 + c < a.C) {
            const size_t o = (size_t)(c0 + c) * a.n + v;
            a.xo[o] = x[c];
            if (!kProposal) a.po[o] = p1;
          }
        }
      }
    }
    warp_sums<CB>(acc, lane, red + (W + warp) * CB);
    __syncthreads();
    if (tid < 2 * CB) {
      const int pass = tid / CB, c = tid - pass * CB;
      double s = 0.0;
      for (int w = 0; w < W; ++w) s += red[(pass * W + w) * CB + c];
      part[pass * CB + c] = s;
    }
    cluster_barrier();  // every block's partials in place; peers done reading x
    if (rank == 0) {
      // the peers' partials in one round of remote loads, then summed in
      // rank order
      if (tid < S * 2 * CB) {
        const double* pr = cl.map_shared_rank(part, (unsigned)(tid / (2 * CB)));
        gath[tid] = pr[tid % (2 * CB)];
      }
      __syncthreads();
    }
    if (rank == 0 && tid < CB && c0 + tid < a.C) {
      double s0 = 0.0, s1 = 0.0;
      for (int r = 0; r < S; ++r) {
        s0 += gath[r * 2 * CB + tid];
        s1 += gath[r * 2 * CB + CB + tid];
      }
      if (kProposal) {
        // 1/2 [(lp1 - ke1) - (lp0 - ke0)], capped at 0; a non-finite value
        // (NaN, an overflow) is -inf, so it never accepts
        const double d = 0.5 * (s1 - s0);
        const float la = (float)(d > 0.0 ? 0.0 : d);
        a.out0[c0 + tid] = isfinite(la) ? la : -CUDART_INF_F;
      } else {
        a.out0[c0 + tid] = (float)(0.5 * s0);
        a.out1[c0 + tid] = (float)(0.5 * s1);
      }
    }
  }
  cl.sync();  // no block leaves while a peer may still read its memory;
              // rank 0's log_acc stores seen by the cluster
  if (kProposal && a.u != nullptr) {
    // The select: the cluster's rejected chains (log u < log_acc fails)
    // listed in buf0 (free now), for a chunk of its groups at a time; then
    // this block's lanes of their rows back to x0, CB rows at a time, every
    // load before the stores, so that a thread has up to CB x ML loads in
    // flight (a store to xo may alias a later load of x for all the
    // compiler knows). The list's order varies; the rows written do not.
    int* rows = reinterpret_cast<int*>(buf0);  // [slice * CB]
    int* n_rows = reinterpret_cast<int*>(red);
    const int first = blockIdx.x / S;
    const int mine = (n_groups - first + n_clusters - 1) / n_clusters;
    for (int k0 = 0; k0 < mine; k0 += slice) {
      const int kn = min(slice, mine - k0);
      if (tid == 0) *n_rows = 0;
      __syncthreads();
      for (int e = tid; e < kn; e += T) {
        const int c0 = (first + (k0 + e) * n_clusters) * CB;
#pragma unroll
        for (int c = 0; c < CB; ++c)
          if (c0 + c < a.C && !(logf(a.u[c0 + c]) < a.out0[c0 + c]))
            rows[atomicAdd(n_rows, 1)] = c0 + c;
      }
      __syncthreads();
      const int nr = *n_rows;
      for (int r0 = 0; r0 < nr; r0 += CB) {
        float y[CB][ML];
#pragma unroll
        for (int j = 0; j < CB; ++j) {
          if (r0 + j < nr) {
            const size_t row = (size_t)rows[r0 + j] * a.n;
#pragma unroll
            for (int l = 0; l < ML; ++l) {
              const int i = tid + l * T;
              const int v = (l < lpt && i < own) ? cinv[i] : -1;
              if (v >= 0) y[j][l] = a.x[row + v];
            }
          }
        }
#pragma unroll
        for (int j = 0; j < CB; ++j) {
          if (r0 + j < nr) {
            const size_t row = (size_t)rows[r0 + j] * a.n;
#pragma unroll
            for (int l = 0; l < ML; ++l) {
              const int i = tid + l * T;
              const int v = (l < lpt && i < own) ? cinv[i] : -1;
              if (v >= 0) a.xo[row + v] = y[j][l];
            }
          }
        }
      }
      __syncthreads();  // the list read before the next chunk's
    }
  }
}

// Host-side checks shared by both launchers: argument ranges, the offsets
// (|o| < n_emb keeps the single-wrap index arithmetic in range) and the
// geometry against the shared-memory reckoning. Returns a CUDA error code.
inline int check_launch(int C, int n, int n_emb, int K, const int* offsets,
                        int n_steps, bool has_inv, int cluster, int threads,
                        int chains, int slice, size_t smem, Offsets* offs) {
  if (C <= 0 || n <= 0 || n_emb < n || n_steps < 0 || K < 0 ||
      K > kMaxOffsets || (!has_inv && n_emb != n))
    return (int)cudaErrorInvalidValue;
  *offs = Offsets{};
  for (int k = 0; k < K; ++k) {
    if (offsets[k] <= -n_emb || offsets[k] >= n_emb)
      return (int)cudaErrorInvalidValue;
    offs->o[k] = offsets[k];
  }
  const bool pow2_cluster = cluster == 1 || cluster == 2 || cluster == 4 ||
                            cluster == kMaxCluster;
  const bool pow2_chains = chains == 1 || chains == 2 || chains == 4 ||
                           chains == 8;
  if (!pow2_cluster || !pow2_chains || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || slice <= 0 ||
      slice % 4 != 0 || (long long)cluster * slice < n_emb ||
      (slice + threads - 1) / threads > kRegLanes / chains)
    return (int)cudaErrorInvalidConfiguration;
  if (smem < smem_bytes(K, chains, slice, threads) || smem > kSmemLimit)
    return (int)cudaErrorInvalidConfiguration;
  return (int)cudaSuccess;
}

// Launch `kernel` as persistent clusters of `cluster` blocks: as many as
// fit on the card at once, at most one per chain group.
template <typename Kernel>
inline int launch(Kernel kernel, const Args& a, int cluster, int threads,
                  int chains, size_t smem, cudaStream_t stream) {
  cudaError_t err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;
  err = lhvi_cluster::clusters_that_fit(kernel, &cfg, &fit);
  if (err != cudaSuccess) return (int)err;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  const int groups = (a.C + chains - 1) / chains;
  cfg.gridDim = dim3((unsigned)(cluster * (groups < fit ? groups : fit)), 1, 1);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace lhvi_dia
