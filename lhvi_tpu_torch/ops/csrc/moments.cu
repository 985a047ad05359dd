// K7 and K8: the sampler's per-draw moment and streamed-diagnostics update,
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package leaves this stream to XLA,
// which fuses its elementwise ops into the sampling loop's body; the port
// ran it as plain PyTorch, about 14 ATen launches and 31 passes over a
// [C, n] f32 array for every kept draw. Both kernels are the CUDA branch of
// one engine function each (engines/hmc.py::_stream_diag_update for K7,
// ::_moment_sums for K8); the engine's plain torch code is their twin.
//
// K7, lhvi_stream_diag: fold draw t of every chain, xc [C, n], into the
// streamed split-R-hat / ESS accumulators (engines/hmc.py::_StreamDiag):
//   - the active split-half Welford pair (none for the odd tail draw):
//       d = x - mean, mean' = mean + d * (1/cnt), m2' = m2 + d * (x - mean');
//   - cross' = cross + x * prev (from the second draw on);
//   - bm_cur' = bm_cur + x, and at a batch boundary the batch mean
//       b = bm_cur' * (1/bm_len) folded into the Welford pair (bm_mean,
//       bm_m2) with count batch_no, and bm_cur' = 0.
// Elementwise per (chain, latent), so the flat C*n array is walked as one.
//
// What bounds K7 on the H100: bytes. A draw reads xc, prev, the active
// pair, cross and bm_cur and writes four arrays, 40 bytes an element and
// no more than 8 flops: 0.64 GB (0.19 ms at 3.35 TB/s) at 1,024 chains x
// 15,600 latents, 10.2 GB (3.05 ms) at 16,384; a batch boundary adds the
// batch-means pair. The design is the one a pure streaming pass needs:
// 16-byte loads and stores (float4) when every array is 16-byte aligned
// (the flat ragged tail one element a thread), a grid-stride loop over
// blocks that fill every SM, and all of an element-vector's loads issued
// before its first store, so each thread keeps up to eight 16-byte loads
// in flight. The branch (which parts: pair, cross, batch, boundary) is
// fixed by the pointers and scalars of the launch, so it is uniform and
// nothing is read back to the host; the engine decides it and passes only
// the arrays the draw changes. The outputs are fresh arrays (the wrapper's
// torch.empty): the same bytes as an update in place, and the function
// stays pure like its twin.
//
// Bitwise equal to the twin on the card: each element's arithmetic is the
// twin's sequence of ATen ops, one rounding each. ATen divides a tensor by
// a Python number as a multiply by its float reciprocal formed on the host
// (BinaryDivTrueKernel.cu), so the launcher forms 1/cnt, 1/bm_len and
// 1/batch_no the same way, and the kernel multiplies; every product and
// sum goes through __fmul_rn / __fadd_rn / __fsub_rn so that nvcc cannot
// contract a*b+c into an FMA.
//
// K8, lhvi_moment_sums: s1' = s1 + sum_c xc[c, :], s2' = s2 + sum_c xc^2,
// the running sums of the mean and variance. Bound by bytes too: one read
// of xc, 4*C*n bytes (0.019 ms at 1,024 chains, 0.305 ms at 16,384). One
// block owns a tile of 8*vec columns over all chains: 8 threads side by
// side read a row segment of 32 (vec 1) or 128 (float4) contiguous bytes,
// the block's 32 row groups take every 32nd chain, four rows in flight a
// thread. A thread accumulates in double, in row order; the
// block then adds the row groups' partials in group order through shared
// memory and adds the total, rounded to f32, to s1 (as the twin adds its
// f32 sum). No atomics: the order depends only on C, n and the geometry,
// so a run repeats bitwise. At the grid cells' 15,600 latents that is 488
// blocks of float4 tiles, 3.7 an SM (ops/moments.py::k8_launch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDiagThreads = 256;  // K7: threads a block
constexpr int kSumThreads = 256;   // K8: threads a block
constexpr int kSumLanes = 8;       // K8: threads side by side along a row
constexpr int kSumGroups = kSumThreads / kSumLanes;  // K8: row groups

template <int V>
__device__ __forceinline__ void ld(const float* __restrict__ p, long long i,
                                   float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + i);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = p[i + k];
  }
}

template <int V>
__device__ __forceinline__ void st(float* __restrict__ p, long long i,
                                   const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[i + k] = v[k];
  }
}

struct DiagArgs {
  const float* xc;
  const float* prev;
  const float* mean;     // the active half's Welford pair (null: none)
  const float* m2;
  const float* cross;    // (null: the first draw, cross unchanged)
  const float* bm_cur;   // (null: no batch-means stream)
  const float* bm_mean;  // (null: not a batch boundary)
  const float* bm_m2;
  float* mean_out;
  float* m2_out;
  float* cross_out;
  float* bm_cur_out;
  float* bm_mean_out;
  float* bm_m2_out;
  long long n;           // C * n_cont elements
  float inv_cnt;         // 1/cnt, 1/bm_len, 1/batch_no, as ATen forms them
  float inv_len;
  float inv_batch;
};

// One element-vector of V at flat index i: every load, then the arithmetic,
// then every store.
template <int V>
__device__ __forceinline__ void fold(const DiagArgs& a, long long i) {
  float x[V], mu[V], m2[V], pv[V], cr[V], bc[V], bmu[V], bv[V];
  ld<V>(a.xc, i, x);
  if (a.mean) {
    ld<V>(a.mean, i, mu);
    ld<V>(a.m2, i, m2);
  }
  if (a.cross) {
    ld<V>(a.prev, i, pv);
    ld<V>(a.cross, i, cr);
  }
  if (a.bm_cur) ld<V>(a.bm_cur, i, bc);
  if (a.bm_mean) {
    ld<V>(a.bm_mean, i, bmu);
    ld<V>(a.bm_m2, i, bv);
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (a.mean) {
      const float d = __fsub_rn(x[k], mu[k]);
      const float m = __fadd_rn(mu[k], __fmul_rn(d, a.inv_cnt));
      m2[k] = __fadd_rn(m2[k], __fmul_rn(d, __fsub_rn(x[k], m)));
      mu[k] = m;
    }
    if (a.cross) cr[k] = __fadd_rn(cr[k], __fmul_rn(x[k], pv[k]));
    if (a.bm_cur) {
      bc[k] = __fadd_rn(bc[k], x[k]);
      if (a.bm_mean) {
        const float b = __fmul_rn(bc[k], a.inv_len);
        const float d = __fsub_rn(b, bmu[k]);
        const float m = __fadd_rn(bmu[k], __fmul_rn(d, a.inv_batch));
        bv[k] = __fadd_rn(bv[k], __fmul_rn(d, __fsub_rn(b, m)));
        bmu[k] = m;
        bc[k] = 0.0f;
      }
    }
  }
  if (a.mean) {
    st<V>(a.mean_out, i, mu);
    st<V>(a.m2_out, i, m2);
  }
  if (a.cross) st<V>(a.cross_out, i, cr);
  if (a.bm_cur) st<V>(a.bm_cur_out, i, bc);
  if (a.bm_mean) {
    st<V>(a.bm_mean_out, i, bmu);
    st<V>(a.bm_m2_out, i, bv);
  }
}

template <int V>
__global__ void __launch_bounds__(kDiagThreads)
    stream_diag_kernel(const DiagArgs a) {
  const long long nv = a.n / V;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = first; v < nv; v += stride) fold<V>(a, v * V);
  if (V > 1) {  // the flat ragged tail (n % V elements), one a thread
    const long long i = nv * V + first;
    if (i < a.n) fold<1>(a, i);
  }
}

template <int V>
__global__ void __launch_bounds__(kSumThreads)
    moment_sums_kernel(const float* __restrict__ xc,
                       const float* __restrict__ s1,
                       const float* __restrict__ s2, float* __restrict__ s1_out,
                       float* __restrict__ s2_out, int C, int n) {
  __shared__ double red[2][kSumThreads * V];
  const int l = threadIdx.x % kSumLanes, g = threadIdx.x / kSumLanes;
  constexpr int groups = kSumGroups;
  const long long col = ((long long)blockIdx.x * kSumLanes + l) * V;
  double s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = q[k] = 0.0;
  if (col < n) {
    const long long row = n;
    int r = g;
    for (; r + 3 * groups < C; r += 4 * groups) {
      float v[4][V];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        ld<V>(xc, (long long)(r + u * groups) * row + col, v[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const double d = v[u][k];
          s[k] += d;
          q[k] = fma(d, d, q[k]);
        }
    }
    for (; r < C; r += groups) {
      float v[V];
      ld<V>(xc, (long long)r * row + col, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const double d = v[k];
        s[k] += d;
        q[k] = fma(d, d, q[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    red[0][threadIdx.x * V + k] = s[k];
    red[1][threadIdx.x * V + k] = q[k];
  }
  __syncthreads();
  if (g == 0 && col < n) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      double ts = 0.0, tq = 0.0;
      for (int j = 0; j < groups; ++j) {
        ts += red[0][(j * kSumLanes + l) * V + k];
        tq += red[1][(j * kSumLanes + l) * V + k];
      }
      s1_out[col + k] = __fadd_rn(s1[col + k], (float)ts);
      s2_out[col + k] = __fadd_rn(s2[col + k], (float)tq);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// K7. A null output skips its part: mean_out (and m2_out) the Welford pair
// (cnt >= 1 its count), cross_out the lag-1 product, bm_cur_out the batch
// stream (bm_len >= 1), bm_mean_out (and bm_m2_out) the boundary fold
// (batch_no >= 1, needs the batch stream). Inputs of a skipped part may be
// null.
extern "C" int lhvi_stream_diag(
    const float* xc, const float* prev, const float* mean, const float* m2,
    const float* cross, const float* bm_cur, const float* bm_mean,
    const float* bm_m2, float* mean_out, float* m2_out, float* cross_out,
    float* bm_cur_out, float* bm_mean_out, float* bm_m2_out, long long n,
    int cnt, int bm_len, int batch_no, int vec, int threads, int grid,
    void* stream) {
  const bool half = mean_out != nullptr, lag = cross_out != nullptr;
  const bool bm = bm_cur_out != nullptr, edge = bm_mean_out != nullptr;
  if (n < 1 || xc == nullptr || threads != kDiagThreads || grid < 1 ||
      (vec != 1 && vec != 4) ||
      (half && (cnt < 1 || !mean || !m2 || !m2_out)) ||
      (lag && (!prev || !cross)) || (bm && (bm_len < 1 || !bm_cur)) ||
      (edge && (!bm || batch_no < 1 || !bm_mean || !bm_m2 || !bm_m2_out)))
    return (int)cudaErrorInvalidValue;
  DiagArgs a{};
  a.xc = xc;
  a.n = n;
  if (half) {
    a.mean = mean;
    a.m2 = m2;
    a.mean_out = mean_out;
    a.m2_out = m2_out;
    a.inv_cnt = 1.0f / (float)cnt;  // host float division, as ATen's
  }
  if (lag) {
    a.prev = prev;
    a.cross = cross;
    a.cross_out = cross_out;
  }
  if (bm) {
    a.bm_cur = bm_cur;
    a.bm_cur_out = bm_cur_out;
    a.inv_len = 1.0f / (float)bm_len;
  }
  if (edge) {
    a.bm_mean = bm_mean;
    a.bm_m2 = bm_m2;
    a.bm_mean_out = bm_mean_out;
    a.bm_m2_out = bm_m2_out;
    a.inv_batch = 1.0f / (float)batch_no;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    const void* ptrs[] = {a.xc,          a.prev,      a.mean,
                          a.m2,          a.cross,     a.bm_cur,
                          a.bm_mean,     a.bm_m2,     a.mean_out,
                          a.m2_out,      a.cross_out, a.bm_cur_out,
                          a.bm_mean_out, a.bm_m2_out};
    for (const void* p : ptrs)
      if (p && !aligned16(p)) return (int)cudaErrorInvalidValue;
    stream_diag_kernel<4><<<grid, threads, 0, s>>>(a);
  } else {
    stream_diag_kernel<1><<<grid, threads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// K8. grid must be ceil(n / (8 * vec)); vec 4 needs n % 4 == 0 and xc
// 16-byte aligned.
extern "C" int lhvi_moment_sums(const float* xc, const float* s1,
                                const float* s2, float* s1_out, float* s2_out,
                                int C, int n, int vec, int threads, int grid,
                                void* stream) {
  if (n < 1 || C < 0 || threads != kSumThreads || (vec != 1 && vec != 4) ||
      (long long)grid * kSumLanes * vec < n ||
      (long long)(grid - 1) * kSumLanes * vec >= n ||
      (vec == 4 && (n % 4 != 0 || !aligned16(xc))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    moment_sums_kernel<4><<<grid, threads, 0, s>>>(xc, s1, s2, s1_out, s2_out,
                                                    C, n);
  else
    moment_sums_kernel<1><<<grid, threads, 0, s>>>(xc, s1, s2, s1_out, s2_out,
                                                    C, n);
  return (int)cudaGetLastError();
}
