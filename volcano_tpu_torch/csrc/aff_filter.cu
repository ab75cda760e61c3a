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
// aff_ok & anti_ok & no conflict.
//
// The JAX function compacts giver and reader rows to the earliest 256
// (GCAP) and branches between the compact and the full forms (`_gm_full`
// / `_gm_compact`, `_conf_*`), and between flattened and 2-D (term,
// domain) keys (`flat_keys`); its comments state that every branch gives
// the same values.  Those are TPU scatter-cost tricks: this kernel
// computes the full form once, with 64-bit cell offsets.
//
// Design: four launches over the whole card, each a grid of pairs.
//   init:   one block per term: totals[e] over the D domains (only the
//           terms some wave row requires: no other term's total is read),
//           gt[e] = W, and the involved-task counter zeroed;
//   givers: one thread per (task, term) pair: the earliest givers
//           (atomicMin into gm / gt), and the compaction of the involved
//           tasks -- accepted or pipelined, with a required term in their
//           profile (JAX's p_involved rows, wave.py:1561-1567) -- by an
//           atomic counter (the set matters, not its order);
//   check:  one thread per (involved task, term) pair: the live recheck
//           and the conflict reads; a failing pair clears the task's acc
//           and pipe (every writer stores 0);
//   reset:  one thread per (task, term) pair: the cells `givers` lowered
//           go back to W.
// Everything is integer or boolean and minima do not depend on order, so
// the output equals the plain version exactly.  `term_req` ([E]: some wave
// row requires e) and `prof_req` ([UM]: the profile requires some term)
// are constant for a wave: the caller derives them once, not per call.
//
// `gm` is an [EW, D] int32 scratch the caller fills with W once per solve;
// the reset launch restores every cell the givers lowered, so it stays at
// W between calls without a fill of EW * D cells per sub-round.
//
// Bound: the required terms' count rows and the W x EW gathers (tens to
// hundreds of KB: well under a microsecond); the four launches and their
// dependent gathers bound it.
#include "aff.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTotThreads = 1024;

__device__ __forceinline__ int task_dom(const int32_t* choice,
                                        const int32_t* node_dom, int K,
                                        const int32_t* term_key, int t,
                                        int e) {
  return node_dom[static_cast<int64_t>(choice[t]) * K + term_key[e]];
}

// Does task t give to term e (a live match with a domain, e required)?
__device__ __forceinline__ bool gives(const int32_t* choice,
                                      const uint8_t* live,
                                      const int32_t* pid_l,
                                      const int32_t* node_dom, int K,
                                      const int32_t* term_key,
                                      const uint8_t* t_match,
                                      const uint8_t* term_req, int E, int t,
                                      int e, int* dw) {
  if (!live[t] || !term_req[e]) return false;
  if (!t_match[static_cast<int64_t>(pid_l[t]) * E + e]) return false;
  *dw = task_dom(choice, node_dom, K, term_key, t, e);
  return *dw >= 0;
}

__global__ void __launch_bounds__(kTotThreads) aff_filter_init_kernel(
    const int32_t* cnt_a, const int32_t* cnt_p, int D,
    const uint8_t* term_req, int W, int32_t* totals, int32_t* gt,
    int32_t* n_inv) {
  __shared__ int32_t part[kTotThreads / 32];
  const int e = blockIdx.x;
  if (threadIdx.x == 0) {
    gt[e] = W;
    if (e == 0) *n_inv = 0;
  }
  if (!term_req[e]) {
    if (threadIdx.x == 0) totals[e] = 0;
    return;
  }
  const int64_t base = static_cast<int64_t>(e) * D;
  int32_t acc = 0;
  for (int d = threadIdx.x; d < D; d += kTotThreads) {
    acc += cnt_a[base + d] + (cnt_p ? cnt_p[base + d] : 0);
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xFFFFFFFFu, acc, off);
  }
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    acc = part[threadIdx.x];
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xFFFFFFFFu, acc, off);
    }
    if (threadIdx.x == 0) totals[e] = acc;
  }
}

__global__ void __launch_bounds__(kThreads) aff_filter_givers_kernel(
    const int32_t* choice, const uint8_t* live, const int32_t* pid_l, int W,
    const int32_t* node_dom, int K, const int32_t* term_key, int E, int D,
    const uint8_t* t_match, const uint8_t* term_req,
    const uint8_t* prof_req, const uint8_t* acc, const uint8_t* pipe,
    int32_t* gm, int32_t* gt, int32_t* n_inv, int32_t* inv) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(W) * E) return;
  const int t = static_cast<int>(idx / E);
  const int e = static_cast<int>(idx % E);
  if (e == 0 && (acc[t] || (pipe && pipe[t])) && prof_req[pid_l[t]]) {
    inv[atomicAdd(n_inv, 1)] = t;
  }
  int dw;
  if (gives(choice, live, pid_l, node_dom, K, term_key, t_match, term_req,
            E, t, e, &dw)) {
    atomicMin(&gm[static_cast<int64_t>(e) * D + dw], t);
    atomicMin(&gt[e], t);
  }
}

__global__ void __launch_bounds__(kThreads) aff_filter_check_kernel(
    const int32_t* choice, const int32_t* pid_l, int W,
    const int32_t* node_dom, int K, const int32_t* term_key,
    const int32_t* cnt_a, const int32_t* cnt_p, int E, int D,
    const uint8_t* t_aff, const uint8_t* t_anti, const uint8_t* t_match,
    const int32_t* gm, const int32_t* totals, const int32_t* gt,
    const int32_t* n_inv, const int32_t* inv, uint8_t* acc,
    uint8_t* pipe) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(*n_inv) * E) return;
  const int t = inv[idx / E];
  const int e = static_cast<int>(idx % E);
  const int64_t c = static_cast<int64_t>(pid_l[t]) * E + e;
  const bool ra = t_aff[c] != 0;
  const bool an = t_anti[c] != 0;
  if (!ra && !an) return;
  const int dw = task_dom(choice, node_dom, K, term_key, t, e);
  const int32_t cval = vtt::count_at(cnt_a, cnt_p, e, dw, D);
  const bool selfok = ra && totals[e] == 0 && t_match[c];
  bool bad = (ra && !selfok && cval == 0) || (an && cval > 0);
  const int32_t gm_my = dw >= 0 ? gm[static_cast<int64_t>(e) * D + dw] : W;
  if (an && dw >= 0 && gm_my < t) bad = true;
  const int32_t g = gt[e];
  if (selfok && cval == 0 && g < t && gm_my > g) bad = true;
  if (bad) {
    acc[t] = 0;
    if (pipe) pipe[t] = 0;
  }
}

__global__ void __launch_bounds__(kThreads) aff_filter_reset_kernel(
    const int32_t* choice, const uint8_t* live, const int32_t* pid_l, int W,
    const int32_t* node_dom, int K, const int32_t* term_key, int E, int D,
    const uint8_t* t_match, const uint8_t* term_req, int32_t* gm) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(W) * E) return;
  const int t = static_cast<int>(idx / E);
  const int e = static_cast<int>(idx % E);
  int dw;
  if (gives(choice, live, pid_l, node_dom, K, term_key, t_match, term_req,
            E, t, e, &dw)) {
    gm[static_cast<int64_t>(e) * D + dw] = W;
  }
}

}  // namespace

// scratch: 2 * E + 1 + W int32 (totals, gt, the involved count, the
// involved tasks).  pipe may be null.  term_req [E] and prof_req [UM] are
// bool planes.
extern "C" int vtt_aff_filter(
    const void* choice, const void* live, const void* pid_l, int W,
    const void* node_dom, int K, const void* term_key, const void* cnt_a,
    const void* cnt_p, int E, int D, const void* t_aff, const void* t_anti,
    const void* t_match, const void* term_req, const void* prof_req,
    void* gm, void* scratch, void* acc, void* pipe, void* stream) {
  if (W <= 0 || E <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* totals = static_cast<int32_t*>(scratch);
  int32_t* gt = totals + E;
  int32_t* n_inv = gt + E;
  int32_t* inv = n_inv + 1;
  const auto* ch = static_cast<const int32_t*>(choice);
  const auto* lv = static_cast<const uint8_t*>(live);
  const auto* pl = static_cast<const int32_t*>(pid_l);
  const auto* nd = static_cast<const int32_t*>(node_dom);
  const auto* tk = static_cast<const int32_t*>(term_key);
  const auto* tm = static_cast<const uint8_t*>(t_match);
  const auto* tr = static_cast<const uint8_t*>(term_req);
  auto* g = static_cast<int32_t*>(gm);
  auto* a = static_cast<uint8_t*>(acc);
  auto* p = static_cast<uint8_t*>(pipe);
  const int64_t pairs = static_cast<int64_t>(W) * E;
  const int blocks = static_cast<int>((pairs + kThreads - 1) / kThreads);
  aff_filter_init_kernel<<<E, kTotThreads, 0, st>>>(
      static_cast<const int32_t*>(cnt_a), static_cast<const int32_t*>(cnt_p),
      D, tr, W, totals, gt, n_inv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  aff_filter_givers_kernel<<<blocks, kThreads, 0, st>>>(
      ch, lv, pl, W, nd, K, tk, E, D, tm, tr,
      static_cast<const uint8_t*>(prof_req), a, p, g, gt, n_inv, inv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  aff_filter_check_kernel<<<blocks, kThreads, 0, st>>>(
      ch, pl, W, nd, K, tk, static_cast<const int32_t*>(cnt_a),
      static_cast<const int32_t*>(cnt_p), E, D,
      static_cast<const uint8_t*>(t_aff), static_cast<const uint8_t*>(t_anti),
      tm, g, totals, gt, n_inv, inv, a, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  aff_filter_reset_kernel<<<blocks, kThreads, 0, st>>>(
      ch, lv, pl, W, nd, K, tk, E, D, tm, tr, g);
  return static_cast<int>(cudaGetLastError());
}
