// Shared device helper of the inter-pod affinity kernels (aff_live.cu,
// aff_filter.cu): the count-table read.
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

}  // namespace
}  // namespace vtt
