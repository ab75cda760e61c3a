// aff_live: required-affinity / anti-affinity verdicts and soft scores of
// profile rows at candidate nodes, read from per-(term, domain) counts.
//
// Replaces the count-window reads of the JAX package's `_solve_wave` and
// its phase 1 (volcano_tpu/ops/wave.py):
//  - phase 1 on the solve-start counts `cnt0`, over all N nodes
//    (`_coarse_shortlist` :615-660) or the dirty blocks' rows
//    (`_warm_shortlist` :777-812);
//  - the per-attempt planes at shortlist width on a wave's [EW, D] window
//    `cw_a + cw_p` (`live_parts_sl` :1329-1389, the attempt cache);
//  - the shortlist-exhaustion fallback's fresh planes over all N
//    (`live_parts` :1229-1282).
//
// For each (row b, candidate node n), u = rows[b], over the term columns
// the row lists (terms[b] or one shared list, -1 padded):
//   cv[e]  = cnt[e, node_dom[n, term_key[e]]]   (0 without a domain)
//   viol  |= t_req_aff[u,e] & !(total[e] == 0 & t_matches[u,e]) & cv == 0
//   viol  |= t_req_anti[u,e] & cv > 0
//   soft   = soft + t_soft[u,e] * cv             (from +0.0, left to right)
// The TPU classified the violations with bf16 indicator products; here
// they are integer tests.  The soft products are integers (weights are
// integer floats), so the f32 sum is exact below 2^24 and equals the
// JAX product's in any order.  A row's verdict and score read only the
// columns where one of its four table entries is nonzero, so phase 1
// walks each profile's own few terms instead of all E + 1.
//
// A first pass sums each count row over its D domains (`total`, one block
// per row); the main pass is one thread per (row, candidate).
//
// Bound: bytes.  Phase 1 at config 5, 10,000 x 100,000: [8,192 rows x
// 10,016 nodes] outputs (5 bytes each, ~410 MB) against ~1-3 terms per
// row; the totals pass reads the 164 MB count table once.
#include "aff.cuh"

namespace {

__global__ void __launch_bounds__(256) aff_live_kernel(
    const int32_t* rows, int M, const int32_t* cand, int mode, int L,
    const int32_t* terms, int terms_per_row, int T, const int32_t* node_dom,
    int K, const int32_t* term_key, const int32_t* cnt_a,
    const int32_t* cnt_p, int D, const uint8_t* t_aff, const uint8_t* t_anti,
    const uint8_t* t_match, const float* t_soft, int E, const int32_t* totals,
    uint8_t* out_ok, float* out_soft) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(M) * L) return;
  const int b = static_cast<int>(idx / L);
  const int i = static_cast<int>(idx % L);
  const int u = rows[b];
  int n = i;
  if (mode == 1) n = cand[i];
  if (mode == 2) n = cand[static_cast<int64_t>(u) * L + i];
  const int32_t* tl = terms + (terms_per_row ? static_cast<int64_t>(b) * T : 0);
  const int32_t* nd = node_dom + static_cast<int64_t>(n) * K;
  bool viol = false;
  float acc = 0.0f;
  for (int j = 0; j < T; ++j) {
    const int e = tl[j];
    if (e < 0) break;
    const int32_t cv = vtt::count_at(cnt_a, cnt_p, e, nd[term_key[e]], D);
    const int64_t c = static_cast<int64_t>(u) * E + e;
    const bool selfok = totals[e] == 0 && t_match[c];
    if (t_aff[c] && !selfok && cv == 0) viol = true;
    if (t_anti[c] && cv > 0) viol = true;
    acc = acc + t_soft[c] * static_cast<float>(cv);
  }
  out_ok[idx] = viol ? 0 : 1;
  out_soft[idx] = acc;
}

}  // namespace

// mode 0: every node (L = N); 1: one shared [L] candidate list; 2: [U, L]
// candidates, row u = rows[b].  terms_per_row 0: one shared [T] list.
extern "C" int vtt_aff_live(
    const void* rows, int M, const void* cand, int mode, int L,
    const void* terms, int terms_per_row, int T, const void* node_dom, int K,
    const void* term_key, const void* cnt_a, const void* cnt_p, int E, int D,
    const void* t_aff, const void* t_anti, const void* t_match,
    const void* t_soft, int U, void* totals, void* out_ok, void* out_soft,
    void* stream) {
  (void)U;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  vtt::count_totals_kernel<<<E, 256, 0, st>>>(
      static_cast<const int32_t*>(cnt_a), static_cast<const int32_t*>(cnt_p),
      D, static_cast<int32_t*>(totals));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t work = static_cast<int64_t>(M) * L;
  if (work == 0) return 0;
  aff_live_kernel<<<static_cast<unsigned>((work + 255) / 256), 256, 0, st>>>(
      static_cast<const int32_t*>(rows), M,
      static_cast<const int32_t*>(cand), mode, L,
      static_cast<const int32_t*>(terms), terms_per_row, T,
      static_cast<const int32_t*>(node_dom), K,
      static_cast<const int32_t*>(term_key),
      static_cast<const int32_t*>(cnt_a), static_cast<const int32_t*>(cnt_p),
      D, static_cast<const uint8_t*>(t_aff),
      static_cast<const uint8_t*>(t_anti),
      static_cast<const uint8_t*>(t_match),
      static_cast<const float*>(t_soft), E,
      static_cast<const int32_t*>(totals), static_cast<uint8_t*>(out_ok),
      static_cast<float*>(out_soft));
  return static_cast<int>(cudaGetLastError());
}
