// Shared by every launch entry of csrc/*.cu: included by the sources, not
// compiled on its own (ops/_cuda.py skips names that start with "_").
#pragma once

#include <cuda_runtime.h>

// Make `device` the runtime's current device for this host thread. The
// library keeps its own current device per thread, so an entry cannot
// assume PyTorch's; but when it already is `device` (every launch after a
// thread's first, on a one-card machine) the read is all that is paid.
static inline cudaError_t rva_use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}
