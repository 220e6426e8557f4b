// kernel_info: what a compiled kernel takes at its launch configuration,
// for the entry points that report registers, shared and local memory and
// occupancy (the ``*kernel_info`` functions of the ops modules). Included
// by tensor_core.cuh and fused_blocks.cu; internal linkage, as every
// source is built into a library of its own.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// One (registers, static smem, dynamic smem, local bytes a thread, threads,
// blocks an SM) record of a compiled kernel at its launch configuration.
template <typename K>
int kernel_info(K kernel, size_t smem, int threads, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = threads;
  out[5] = blocks;
  return 0;
}

}  // namespace
