// aff_live: required-affinity / anti-affinity verdicts and soft scores of
// profile rows at candidate nodes, read from per-(term, domain) counts.
//
// Replaces the count-window reads of the JAX package's `_solve_wave` and
// its phase 1 (volcano_tpu/ops/wave.py):
//  - phase 1 on the solve-start counts `cnt0`, over all N nodes
//    (`_coarse_shortlist` :615-660) or the dirty blocks' rows
//    (`_warm_shortlist` :777-812);
//  - the per-attempt planes at shortlist width on a wave's [EW, D] window
//    `cw_a + cw_p` (`live_parts_sl` :1329-1389), behind the attempt cache
//    (:1368-1371: the planes are recomputed only after a sub-round changed
//    a count);
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
// JAX product's in any order.  A column whose entry neither requires nor
// forbids anything and weighs zero adds +0.0 to a sum that is never -0.0,
// so it is left out: each row walks only its own active terms.
//
// The attempt cache: `gate` (a device byte, null: always compute) says
// whether the window's counts changed since the planes were last computed.
// Both launches read it first and return at once when it is clear, leaving
// `out_ok` / `out_soft` (the caller's cache buffers) as they were -- no
// host read decides it.  A computing launch adds one to `computed` (when
// given), so a run can tell computing from gated launches afterwards.
//
// Two launches:
//  count_totals_kernel, a block per (term row, 4,096 domains): the row's
//  counts summed with 16-byte loads (when the rows are aligned) into one
//  partial per block.  Integer sums are exact in any order, and keeping
//  the partials apart (the main kernel adds a term's few) needs no zeroed
//  accumulator, so a gated call launches nothing but these two early exits;
//  aff_live_kernel, a block per (row, 256 candidates): the row's list is
//  staged 256 entries at a time -- each entry's term row, key column, soft
//  weight and kind (required without the self-match rule, anti), with its
//  total from the partials -- compacted in list order to the active terms
//  in shared memory; a thread's inner loop is then its node's domain read
//  and one count read per active term.
//
// Bound: bytes.  Phase 1 at config 5, 10,000 x 100,000: [8,192 rows x
// 10,016 nodes] outputs (5 bytes each, ~410 MB) against ~1-3 terms per
// row; the totals pass reads the 164 MB count table once.  The per-attempt
// call reads the wave's [EW, D] window (~6 MB) for its totals and writes
// [UM, S] planes: a few microseconds at the card's rate, latency beyond.
//
// aff_steer, which shares the verdict (aff.cuh), is csrc/aff_steer.cu.
#include "aff.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTotChunk = 4096;  // domains a totals block sums
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int32_t sum4(int4 v) {
  return v.x + v.y + v.z + v.w;
}

// part[e * P + p] = the counts (allocated + pipelined) of term row e over
// domains [p * kTotChunk, (p + 1) * kTotChunk).
__global__ void __launch_bounds__(kThreads) count_totals_kernel(
    const int32_t* cnt_a, const int32_t* cnt_p, int D, int P, int vec,
    const uint8_t* gate, int32_t* part) {
  __shared__ int32_t s_warp[kThreads / 32];
  if (gate && !*gate) return;
  const int e = blockIdx.x;
  const int p = blockIdx.y;
  const int64_t base = static_cast<int64_t>(e) * D;
  const int d0 = p * kTotChunk;
  const int d1 = min(D, d0 + kTotChunk);
  int32_t acc = 0;
  if (vec) {
    const int4* a4 = reinterpret_cast<const int4*>(cnt_a + base);
    const int4* p4 = cnt_p ? reinterpret_cast<const int4*>(cnt_p + base)
                           : nullptr;
    for (int q = d0 / 4 + threadIdx.x; q < d1 / 4; q += blockDim.x) {
      acc += sum4(a4[q]);
      if (p4) acc += sum4(p4[q]);
    }
  } else {
    for (int d = d0 + threadIdx.x; d < d1; d += blockDim.x) {
      acc += cnt_a[base + d] + (cnt_p ? cnt_p[base + d] : 0);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(kFull, acc, off);
  }
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t tot = 0;
    for (int w = 0; w < kThreads / 32; ++w) tot += s_warp[w];
    part[static_cast<int64_t>(e) * P + p] = tot;
  }
}

__global__ void __launch_bounds__(kThreads) aff_live_kernel(
    const int32_t* rows, const int32_t* cand, int mode, int L,
    const int32_t* terms, int terms_per_row, int T, const int32_t* node_dom,
    int K, const int32_t* term_key, const int32_t* cnt_a,
    const int32_t* cnt_p, int D, const uint8_t* t_aff, const uint8_t* t_anti,
    const uint8_t* t_match, const float* t_soft, int E, const int32_t* part,
    int P, const uint8_t* gate, int32_t* computed, uint8_t* out_ok,
    float* out_soft) {
  __shared__ int s_e[kThreads];
  __shared__ int s_key[kThreads];
  __shared__ float s_w[kThreads];
  __shared__ uint8_t s_kind[kThreads];
  __shared__ int s_warp[kThreads / 32];
  if (gate && !*gate) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const int i = blockIdx.y * kThreads + tid;
  if (computed && b == 0 && blockIdx.y == 0 && tid == 0) {
    atomicAdd(computed, 1);
  }
  const int u = rows[b];
  const bool in = i < L;
  int n = 0;
  if (in) {
    n = mode == 0 ? i
                  : (mode == 1 ? cand[i]
                               : cand[static_cast<int64_t>(u) * L + i]);
  }
  const int32_t* nd = node_dom + static_cast<int64_t>(n) * K;
  const int32_t* tl =
      terms + (terms_per_row ? static_cast<int64_t>(b) * T : 0);
  bool viol = false;
  float acc = 0.0f;
  for (int j0 = 0; j0 < T; j0 += kThreads) {
    // Stage entries j0.. of the list: the active ones, in list order.
    const int j = j0 + tid;
    int e = j < T ? tl[j] : -1;
    int key = 0;
    float w = 0.0f;
    uint8_t kind = 0;
    if (e >= 0) {
      const int64_t c = static_cast<int64_t>(u) * E + e;
      kind = vtt::term_kind(t_aff[c] != 0, t_anti[c] != 0, t_match[c] != 0,
                            part, P, e);
      w = t_soft[c];
      if (kind == 0 && w == 0.0f) {
        e = -1;
      } else {
        key = term_key[e];
      }
    }
    const unsigned act = __ballot_sync(kFull, e >= 0);
    if (lane == 0) s_warp[warp] = __popc(act);
    __syncthreads();
    int pos = __popc(act & ((1u << lane) - 1u));
    int cnt = 0;
    for (int v = 0; v < kThreads / 32; ++v) {
      const int x = s_warp[v];
      if (v < warp) pos += x;
      cnt += x;
    }
    if (e >= 0) {
      s_e[pos] = e;
      s_key[pos] = key;
      s_w[pos] = w;
      s_kind[pos] = kind;
    }
    __syncthreads();
    if (in) {
      for (int q = 0; q < cnt; ++q) {
        const int32_t cv =
            vtt::count_at(cnt_a, cnt_p, s_e[q], nd[s_key[q]], D);
        if (vtt::violates(s_kind[q], cv)) viol = true;
        acc = acc + s_w[q] * static_cast<float>(cv);
      }
    }
    __syncthreads();
  }
  if (in) {
    out_ok[static_cast<int64_t>(b) * L + i] = viol ? 0 : 1;
    out_soft[static_cast<int64_t>(b) * L + i] = acc;
  }
}

}  // namespace

// mode 0: every node (L = N); 1: one shared [L] candidate list; 2: [U, L]
// candidates, row u = rows[b].  terms_per_row 0: one shared [T] list.
// `part` is an [E, max(1, ceil(D / 4,096))] int32 scratch; `gate` and
// `computed` may be null.
extern "C" int vtt_aff_live(
    const void* rows, int M, const void* cand, int mode, int L,
    const void* terms, int terms_per_row, int T, const void* node_dom, int K,
    const void* term_key, const void* cnt_a, const void* cnt_p, int E, int D,
    const void* t_aff, const void* t_anti, const void* t_match,
    const void* t_soft, void* part, const void* gate, void* computed,
    void* out_ok, void* out_soft, void* stream) {
  const int64_t tiles = (static_cast<int64_t>(L) + kThreads - 1) / kThreads;
  if (M == 0 || L == 0) return 0;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int P = D > 0 ? (D + kTotChunk - 1) / kTotChunk : 1;
  const auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = D % 4 == 0 && aligned(cnt_a) && aligned(cnt_p);
  const uint8_t* g = static_cast<const uint8_t*>(gate);
  if (E > 0) {
    count_totals_kernel<<<dim3(E, P), kThreads, 0, st>>>(
        static_cast<const int32_t*>(cnt_a),
        static_cast<const int32_t*>(cnt_p), D, P, vec, g,
        static_cast<int32_t*>(part));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  aff_live_kernel<<<dim3(M, static_cast<unsigned>(tiles)), kThreads, 0,
                    st>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cand),
      mode, L, static_cast<const int32_t*>(terms), terms_per_row, T,
      static_cast<const int32_t*>(node_dom), K,
      static_cast<const int32_t*>(term_key),
      static_cast<const int32_t*>(cnt_a), static_cast<const int32_t*>(cnt_p),
      D, static_cast<const uint8_t*>(t_aff),
      static_cast<const uint8_t*>(t_anti),
      static_cast<const uint8_t*>(t_match),
      static_cast<const float*>(t_soft), E,
      static_cast<const int32_t*>(part), P, g,
      static_cast<int32_t*>(computed), static_cast<uint8_t*>(out_ok),
      static_cast<float*>(out_soft));
  return static_cast<int>(cudaGetLastError());
}
