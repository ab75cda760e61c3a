// Shared device helpers of the inter-pod affinity kernels (aff_live.cu,
// aff_filter.cu): the count-table reads.
//
// A count table is [E, D] int32: resident (or, in `cnt_p`, pipelined)
// pods matching term e in domain d.  A node's count for term e is read
// through its domain under the term's topology key, node_dom[n,
// term_key[e]] (-1: the node has no such label, count 0).  The JAX package
// reads these on a TPU through a dense [N, D] domain one-hot (an MXU
// product) below DOM_MM_MAX_MB; counts are integers and only one product
// per output is nonzero, so the gather here gives the same values without
// building that plane.
#pragma once

#include "common.cuh"

namespace vtt {
namespace {

// count(e, dom) of the allocated + pipelined tables (cnt_p may be null).
__device__ __forceinline__ int32_t count_at(const int32_t* cnt_a,
                                            const int32_t* cnt_p, int e,
                                            int dom, int D) {
  if (dom < 0) return 0;
  const int64_t i = static_cast<int64_t>(e) * D + dom;
  return cnt_a[i] + (cnt_p ? cnt_p[i] : 0);
}

// totals[e] = sum over the D domains of term e's counts (one block per
// term).
__global__ void __launch_bounds__(256) count_totals_kernel(
    const int32_t* cnt_a, const int32_t* cnt_p, int D, int32_t* totals) {
  __shared__ int32_t part[256];
  const int e = blockIdx.x;
  int32_t acc = 0;
  const int64_t base = static_cast<int64_t>(e) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    acc += cnt_a[base + d] + (cnt_p ? cnt_p[base + d] : 0);
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[e] = part[0];
}

}  // namespace
}  // namespace vtt
