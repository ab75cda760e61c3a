// Shared device helpers of the inter-pod affinity kernels (aff_live.cu,
// aff_steer.cu, aff_filter.cu): the count-table read, and the required /
// anti verdict that aff_live and aff_steer share.
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

// What a (row, term) entry asks of a node's count: kRequired (required
// affinity without the self-match rule: the count must be > 0), kAnti
// (the count must be 0).
enum : uint8_t { kRequired = 1, kAnti = 2 };

// Term e's count over all domains, from the totals pass's P partials.
__device__ __forceinline__ int32_t term_total(const int32_t* part, int P,
                                              int e) {
  int32_t tot = 0;
  for (int q = 0; q < P; ++q) tot += part[static_cast<int64_t>(e) * P + q];
  return tot;
}

// The entry's kind: a required term is exempt while no pod anywhere
// matches it and the row matches it itself (the self-match rule).
__device__ __forceinline__ uint8_t term_kind(bool aff, bool anti,
                                             bool match, const int32_t* part,
                                             int P, int e) {
  const bool need = aff && !(match && term_total(part, P, e) == 0);
  return (need ? kRequired : 0) | (anti ? kAnti : 0);
}

// The same kind once the entry's zero test is known (aff_steer reads a
// total only for an entry with aff & match, and only whether it is zero).
__device__ __forceinline__ uint8_t kind_of(bool aff, bool anti, bool match,
                                           bool total_zero) {
  const bool need = aff && !(match && total_zero);
  return (need ? kRequired : 0) | (anti ? kAnti : 0);
}

// Whether a count violates an entry of that kind.
__device__ __forceinline__ bool violates(uint8_t kind, int32_t cv) {
  return ((kind & kRequired) && cv == 0) || ((kind & kAnti) && cv > 0);
}

}  // namespace
}  // namespace vtt
