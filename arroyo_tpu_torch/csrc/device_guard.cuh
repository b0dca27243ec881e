// The caller's current CUDA device, kept across a C entry point.
//
// Each entry point launches on the card its tensors live on, which it is
// given by index. It sets that card for its own calls through a guard,
// and the guard hands the thread back on the card it found it on: after a
// launch on card 1, an index-less torch.device("cuda") of the caller still
// means the card it meant before.
#pragma once

#include <cuda_runtime.h>

struct DeviceGuard {
  int prev = -1;  // the caller's device where it differs from ours, else -1
  cudaError_t err = cudaSuccess;

  explicit DeviceGuard(int device) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err != cudaSuccess || cur == device) return;
    err = cudaSetDevice(device);
    if (err == cudaSuccess) prev = cur;
  }
  ~DeviceGuard() {
    if (prev >= 0) (void)cudaSetDevice(prev);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};
