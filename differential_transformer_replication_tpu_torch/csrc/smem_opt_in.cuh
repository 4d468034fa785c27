// Dynamic shared memory past 48 KB: a launch that asks for it is refused
// (error 1) unless its kernel was opted in first. Shared by the sources
// whose kernels take that much.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// lets launches of ``Kernel`` take ``smem`` bytes of dynamic shared memory;
// the attribute is set again only when a launch needs more than before, so
// launches captured into a CUDA graph make no attribute calls
template <auto Kernel>
int allow_smem(size_t smem) {
  static size_t granted = 0;  // one per kernel
  if (smem <= granted) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) granted = smem;
  return static_cast<int>(err);
}

}  // namespace
