// Occupancy of thread-block clusters, shared by the kernels that launch
// one (K2 and K6 through dia_traj.cuh, K4 in weights.cu).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <mutex>

namespace lhvi_cluster {

constexpr int kMaxPortableCluster = 8;

// How many clusters of a kernel fit on the card at once. The kernel's
// dynamic shared-memory limit is raised to the largest size asked of it
// so far (a smaller launch runs under a larger limit), a cluster past the
// portable size of 8 is allowed before the query, and the runtime's
// answer is remembered per kernel, device, cluster size, block size and
// shared bytes: these calls cost more than the launch.
template <typename Kernel>
inline cudaError_t clusters_that_fit(Kernel kernel, cudaLaunchConfig_t* cfg,
                                     int* fit) {
  struct Limit {
    const void* fn;
    int device;
    size_t smem;
  };
  struct Entry {
    const void* fn;
    int device, cluster, threads;
    size_t smem;
    int fit;
  };
  static std::mutex mu;
  static Limit limits[16];
  static Entry seen[64];
  static int n_limits = 0, n_seen = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const void* fn = (const void*)kernel;
  const int cluster = (int)cfg->attrs[0].val.clusterDim.x;
  const int threads = (int)cfg->blockDim.x;
  const size_t smem = cfg->dynamicSmemBytes;
  std::lock_guard<std::mutex> lock(mu);
  Limit* lim = nullptr;
  for (int e = 0; e < n_limits; ++e)
    if (limits[e].fn == fn && limits[e].device == device) lim = &limits[e];
  if (lim == nullptr || lim->smem < smem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (lim != nullptr) lim->smem = smem;
    else if (n_limits < 16) limits[n_limits++] = Limit{fn, device, smem};
  }
  for (int e = 0; e < n_seen; ++e) {
    const Entry& s = seen[e];
    if (s.fn == fn && s.device == device && s.cluster == cluster &&
        s.threads == threads && s.smem == smem) {
      *fit = s.fit;
      return cudaSuccess;
    }
  }
  if (cluster > kMaxPortableCluster) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveClusters(fit, kernel, cfg);
  if (err != cudaSuccess) return err;
  if (n_seen < 64)
    seen[n_seen++] = Entry{fn, device, cluster, threads, smem, *fit};
  return cudaSuccess;
}

}  // namespace lhvi_cluster
