// The dynamic shared memory a kernel may take (cudaFuncSetAttribute) is an
// attribute of the (function, device) pair: a process that launches on more
// than one card sets it once on each. Include once per library.
#pragma once

#include <cuda_runtime.h>

constexpr int kMaxDevices = 64;

// Attributes set on each device by this library, for its _configured query.
static int g_configured[kMaxDevices];

// Sets `kernel`'s dynamic shared memory limit to `smem` bytes on the current
// device, the first time that device launches it; `done` is the kernel's own
// flag per device.
template <typename Kernel>
cudaError_t set_smem_once(bool (&done)[kMaxDevices], Kernel kernel, int smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    done[dev] = true;
    ++g_configured[dev];
  }
  return cudaSuccess;
}

// How many kernels of this library have had their attribute set on `dev`.
inline int configured_on(int dev) {
  return dev >= 0 && dev < kMaxDevices ? g_configured[dev] : 0;
}
