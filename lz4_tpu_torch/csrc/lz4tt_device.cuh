// The card a library launches on.
//
// Each csrc/<name>.cu is its own shared library, linked with nvcc's static
// CUDA runtime, so each library keeps its own current device for each host
// thread. kernels/build.py calls lz4tt_set_device before a launch on a
// tensor's card (under torch's device guard for the same card), so that a
// rank that owns cuda:k launches there. A kernel's function attributes
// (cudaFuncSetAttribute) hold for the current device only, so they are set
// once a card (lz4tt_once_a_device). The host (g++) builds of the kernel
// bodies never include this header.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

enum { LZ4TT_MAX_DEVICES = 64 };

// Returns cudaSetDevice(device).
extern "C" int lz4tt_set_device(int device) {
  return (int)cudaSetDevice(device);
}

// Runs init(device) once for each card, on the first call whose current
// device it is, and returns its result on every call for that card; the
// card goes to *device. Each call site (a lambda of its own type) keeps
// its own record.
template <class F>
cudaError_t lz4tt_once_a_device(F init, int* device) {
  static std::once_flag once[LZ4TT_MAX_DEVICES];
  static cudaError_t result[LZ4TT_MAX_DEVICES];
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev)) return e;
  if (dev < 0 || dev >= LZ4TT_MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [&] { result[dev] = init(dev); });
  *device = dev;
  return result[dev];
}
