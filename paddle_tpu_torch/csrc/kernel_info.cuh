// What a kernel launch asks of the card, as the card reports it: the
// record every source's ``*_info`` entry writes for each kernel of a
// launch, which the Hopper kernel lint (framework/kernel_lint.py) holds
// against its launch plan on the card.
//
// One record is kInfoInts ints: grid x, y and z, threads a block, dynamic
// shared bytes (the launch's own arguments), then from
// cudaFuncGetAttributes registers a thread, local (spill) bytes a thread
// and static shared bytes, and from the occupancy API the blocks of that
// size resident on one SM.  An ``*_info`` entry writes the number of its
// launch's kernels to out[0] and their records from out[1], in launch
// order, and returns a CUDA error code (0 on success).  It launches
// nothing; it raises a kernel's dynamic shared-memory limit as its launch
// does, since the occupancy query needs it.
#pragma once

#include <cuda_runtime.h>

namespace kinfo {

constexpr int kInfoInts = 9;

template <typename K>
int record(K kernel, dim3 grid, int threads, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  const int n = out[0]++;
  int* r = out + 1 + n * kInfoInts;
  r[0] = (int)grid.x;
  r[1] = (int)grid.y;
  r[2] = (int)grid.z;
  r[3] = threads;
  r[4] = (int)smem;
  r[5] = a.numRegs;
  r[6] = (int)a.localSizeBytes;
  r[7] = (int)a.sharedSizeBytes;
  r[8] = blocks;
  return 0;
}

}  // namespace kinfo
