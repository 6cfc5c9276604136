// Shared by the kernels' cluster designs: whether a cluster launch can be
// placed on the current device.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace {

// cudaSuccess when at least one cluster of cfg's shape fits the current
// device (cudaOccupancyMaxActiveClusters > 0), cudaErrorLaunchOutOfResources
// when none does, or the query's own error.  The answer is cached per
// (kernel, device, cluster size, block size, shared memory): the query costs
// far more host time than a launch.
inline cudaError_t cluster_fits(const void* kernel,
                                const cudaLaunchConfig_t* cfg) {
  struct Entry {
    const void* kernel;
    int dev, C, threads;
    size_t smem;
    int active;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int C = static_cast<int>(cfg->attrs[0].val.clusterDim.x);
  const int threads = static_cast<int>(cfg->blockDim.x);
  const size_t smem = cfg->dynamicSmemBytes;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < used; ++i) {
      const Entry& e = cache[i];
      if (e.kernel == kernel && e.dev == dev && e.C == C &&
          e.threads == threads && e.smem == smem)
        return e.active > 0 ? cudaSuccess : cudaErrorLaunchOutOfResources;
    }
  }
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, cfg);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  cache[used % 64] = Entry{kernel, dev, C, threads, smem, active};
  if (used < 64) ++used;
  return active > 0 ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

}  // namespace
