// launch_floor: an empty kernel, so that what one launch costs on the card
// can be timed by the same CUDA-event method as the port's kernels
// (chip_smoke.py's `[kernels:floor]` line).  No wrapper calls it.
//
// `cluster` 0 launches one CTA of 32 threads with `<<<>>>`; C > 0 launches
// one cluster of C such CTAs through `cudaLaunchKernelEx`, as
// `vtt_gang_block_fit` does.
#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int vtt_empty_launch(int cluster, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster <= 0) {
    empty_kernel<<<1, 32, 0, st>>>();
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(32);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, empty_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
