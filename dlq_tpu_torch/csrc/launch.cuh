// Host-side launch helpers shared by the launchers of the persistent and
// opted-in kernels (K1 conv_int8, K2 matmul_int8, K6 mhsa and mhsa_f32, K7
// vit_post_w8, K10 matmul_int4a8, K13 matmul_int4): every device query and
// every shared-memory opt-in is made once per device (and kernel), so a
// launch makes no device query of its own.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <map>
#include <mutex>
#include <tuple>

namespace dlq {

constexpr int MAX_DEVICES = 64;
constexpr int SMEM_OPT_IN = 232448;   // the most dynamic shared memory a block may opt in to

// The current device and its SM count (looked up once per device).
inline cudaError_t device(int* dev, int* sms) {
  static std::atomic<int> known[MAX_DEVICES];   // 0: not looked up yet
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  if (*dev < MAX_DEVICES && (*sms = known[*dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (e == cudaSuccess && *dev < MAX_DEVICES) known[*dev].store(*sms, std::memory_order_relaxed);
  return e;
}

// Kernel K opted in to SMEM_OPT_IN bytes of dynamic shared memory on device
// dev, once per device (the attribute is a ceiling: each launch still asks
// for its own bytes). A refused opt-in returns its error.
template <auto K>
cudaError_t opt_in(int dev) {
  static std::atomic<unsigned long long> opted{0};   // a bit per device
  const unsigned long long bit = dev < MAX_DEVICES ? 1ull << dev : 0ull;
  if (bit != 0 && (opted.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             SMEM_OPT_IN);
  if (e == cudaSuccess) opted.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

// Blocks of kernel K that fit one SM at `threads` threads and `smem` bytes
// of dynamic shared memory on device dev (K opted in first), looked up once
// per (device, threads, bytes).
template <auto K>
cudaError_t blocks_per_sm(int dev, int threads, int smem, int* per_sm) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, int> known;
  const auto key = std::make_tuple(dev, threads, smem);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = known.find(key);
    if (it != known.end()) {
      *per_sm = it->second;
      return cudaSuccess;
    }
  }
  cudaError_t e = opt_in<K>(dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, K, threads, smem);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  known[key] = *per_sm;
  return cudaSuccess;
}

}  // namespace dlq
