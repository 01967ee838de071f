// Dynamic shared memory above the 48 KB default, shared by the kernels
// that stage rows or boxes in shared memory (trace_kernels.cu,
// stream_kernels.cu, cluster_kernels.cu).

#pragma once

#include <cuda_runtime.h>

namespace strolle {

// Lets ``kernel`` take ``bytes`` of dynamic shared memory per block; a
// size over the card's limit returns the error of the attribute call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
  }
  return cudaSuccess;
}

}  // namespace strolle
