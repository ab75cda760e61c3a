// aff_filter: the sub-round's live inter-pod affinity recheck and
// pair-conflict filter.
//
// Replaces `_aff_filter` of the JAX package's `_solve_wave`
// (volcano_tpu/ops/wave.py:1749-2000).  After the capacity walk, every
// live task t of the wave has a choice node; on the wave's [EW, D] count
// window (allocated + pipelined), at that node, for each window term e:
//   dw[t,e]   = node_dom[choice[t], term_key[e]]
//   cval[t,e] = cnt[e, dw] (0 where dw < 0)
//   aff_ok    = no required term with cval == 0 unless the self-match rule
//               holds (total[e] == 0 and t matches its own term)
//   anti_ok   = no anti term with cval > 0
// and, against the earlier live tasks of the same sub-round:
//   gives[t,e]      = t matches e, dw >= 0, t live, some wave row requires e
//   gm[e, d]        = the earliest giver of term e in domain d  (atomicMin)
//   gt[e]           = the earliest giver of term e in any domain (atomicMin)
//   conflict(anti)  = an anti term of t (dw >= 0) has an earlier giver in
//                     t's domain
//   conflict(self)  = t relies on the self-match rule for e, e has an
//                     earlier giver, and that earliest giver is not in t's
//                     domain (a domain-less t conflicts with any)
// A task keeps its acceptance (`acc`, and `pipe` when given) only if
// aff_ok & anti_ok & no conflict.  Minima are order-free, so the atomics
// give the JAX scatter-min's values.
//
// The JAX function compacts giver and reader rows to the earliest 256
// (GCAP) and branches between the compact and the full forms (`_gm_full`
// / `_gm_compact`, `_conf_*`), and between flattened and 2-D (term,
// domain) keys (`flat_keys`); its comments state that every branch gives
// the same values.  Those are TPU scatter-cost tricks: this kernel
// computes the full form once, with 64-bit cell offsets.
//
// `gm` is an [EW, D] int32 scratch the caller fills with W once per solve;
// the last stage restores every cell it lowered, so it stays at W between
// calls without a fill of EW * D cells per sub-round.
//
// Passes: totals and term_req (one block per term), then one block of
// 1024 threads for the wave (gives, conflicts and the filter, the reset),
// with block barriers between the stages.  Bound: the window reads, W x EW
// (2,048 x a few tens at config 5) gathers -- microseconds.
#include "aff.cuh"

namespace {

__device__ __forceinline__ bool gives(const uint8_t* t_match,
                                      const uint8_t* live,
                                      const int32_t* term_req, int u, int e,
                                      int E, int t, int dw) {
  return dw >= 0 && live[t] && term_req[e] &&
         t_match[static_cast<int64_t>(u) * E + e];
}

__global__ void __launch_bounds__(1024) aff_filter_kernel(
    const int32_t* choice, const uint8_t* live, const int32_t* pid_l, int W,
    const int32_t* node_dom, int K, const int32_t* term_key,
    const int32_t* cnt_a, const int32_t* cnt_p, int E, int D,
    const uint8_t* t_aff, const uint8_t* t_anti, const uint8_t* t_match,
    int32_t* gm, const int32_t* totals, const int32_t* term_req, int32_t* gt,
    uint8_t* acc, uint8_t* pipe) {
  const int64_t WE = static_cast<int64_t>(W) * E;
  for (int e = threadIdx.x; e < E; e += blockDim.x) gt[e] = W;
  __syncthreads();
  // 1. earliest live giver per (term, domain) and per term.
  for (int64_t idx = threadIdx.x; idx < WE; idx += blockDim.x) {
    const int t = static_cast<int>(idx / E);
    const int e = static_cast<int>(idx % E);
    const int dw = node_dom[static_cast<int64_t>(choice[t]) * K + term_key[e]];
    if (gives(t_match, live, term_req, pid_l[t], e, E, t, dw)) {
      atomicMin(&gm[static_cast<int64_t>(e) * D + dw], t);
      atomicMin(&gt[e], t);
    }
  }
  __syncthreads();
  // 2. the live recheck and the conflict reads, per accepted task.
  for (int t = threadIdx.x; t < W; t += blockDim.x) {
    const bool a = acc[t] != 0;
    const bool p = pipe != nullptr && pipe[t] != 0;
    if (!a && !p) continue;
    const int u = pid_l[t];
    const int32_t* nd = node_dom + static_cast<int64_t>(choice[t]) * K;
    bool bad = false;
    for (int e = 0; e < E && !bad; ++e) {
      const int64_t c = static_cast<int64_t>(u) * E + e;
      const bool ra = t_aff[c] != 0;
      const bool an = t_anti[c] != 0;
      if (!ra && !an) continue;
      const int dw = nd[term_key[e]];
      const int32_t cval = vtt::count_at(cnt_a, cnt_p, e, dw, D);
      const bool selfok = totals[e] == 0 && t_match[c];
      if (ra && !selfok && cval == 0) bad = true;
      if (an && cval > 0) bad = true;
      const int32_t gm_my =
          gm[static_cast<int64_t>(e) * D + (dw > 0 ? dw : 0)];
      if (an && dw >= 0 && gm_my < t) bad = true;
      const bool uses_selfok = ra && selfok && cval == 0;
      const int32_t gm_self = dw >= 0 ? gm_my : W;
      if (uses_selfok && gt[e] < t && gm_self > gt[e]) bad = true;
    }
    if (bad) {
      acc[t] = 0;
      if (pipe) pipe[t] = 0;
    }
  }
  __syncthreads();
  // 3. restore the cells stage 1 lowered.
  for (int64_t idx = threadIdx.x; idx < WE; idx += blockDim.x) {
    const int t = static_cast<int>(idx / E);
    const int e = static_cast<int>(idx % E);
    const int dw = node_dom[static_cast<int64_t>(choice[t]) * K + term_key[e]];
    if (gives(t_match, live, term_req, pid_l[t], e, E, t, dw)) {
      gm[static_cast<int64_t>(e) * D + dw] = W;
    }
  }
}

}  // namespace

// scratch: 3 * E int32 (totals, term_req, gt).  pipe may be null.
extern "C" int vtt_aff_filter(
    const void* choice, const void* live, const void* pid_l, int W,
    const void* node_dom, int K, const void* term_key, const void* cnt_a,
    const void* cnt_p, int E, int D, const void* t_aff, const void* t_anti,
    const void* t_match, int UM, void* gm, void* scratch, void* acc,
    void* pipe, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* totals = static_cast<int32_t*>(scratch);
  int32_t* term_req = totals + E;
  int32_t* gt = term_req + E;
  vtt::count_totals_kernel<<<E, 256, 0, st>>>(
      static_cast<const int32_t*>(cnt_a), static_cast<const int32_t*>(cnt_p),
      D, totals, static_cast<const uint8_t*>(t_aff),
      static_cast<const uint8_t*>(t_anti), UM, E, term_req);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  aff_filter_kernel<<<1, 1024, 0, st>>>(
      static_cast<const int32_t*>(choice), static_cast<const uint8_t*>(live),
      static_cast<const int32_t*>(pid_l), W,
      static_cast<const int32_t*>(node_dom), K,
      static_cast<const int32_t*>(term_key),
      static_cast<const int32_t*>(cnt_a), static_cast<const int32_t*>(cnt_p),
      E, D, static_cast<const uint8_t*>(t_aff),
      static_cast<const uint8_t*>(t_anti),
      static_cast<const uint8_t*>(t_match), static_cast<int32_t*>(gm),
      totals, term_req, gt, static_cast<uint8_t*>(acc),
      static_cast<uint8_t*>(pipe));
  return static_cast<int>(cudaGetLastError());
}
