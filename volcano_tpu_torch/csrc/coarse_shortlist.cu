// coarse_shortlist: phase 1 of the two-phase wave solve.
//
// Replaces the JAX package's jitted `_coarse_shortlist`
// (volcano_tpu/ops/wave.py:547), with `_class_static` (wave.py:285) and
// `_topk_nodes` (wave.py:498) folded in.
//
// The static ok/score planes per (profile, node class): without
// `static_ext` the main pass computes them itself, in the same launch --
// block u writes row u's C pairs (`static_at`), passes a block barrier
// and reads them back while it scores (global writes of a block are
// visible to the block after `__syncthreads()`; the pairs are not staged
// in shared memory, which the row's score keys fill).  With `static_ext`
// it reads the given planes.  `vtt_static_planes`, the planes alone
// (`class_static_kernel`, one thread a pair), replaces the JAX package's
// separately jitted `_static_planes` (wave.py:347): the
// device-incremental lane's persistent planes, which its block-form
// launches (warm_shortlist.cu) read.  Those launches keep the planes'
// own launch: a block there ranks one node block of a row, so it cannot
// read pairs another block writes, and every way of computing them inside
// it measured slower on an H100 than the separate launch (PERF.md
// section 6).  The TPU ran the selector / affinity / taint bit subset tests as bf16
// indicator matmuls; here each test is an AND-NOT over the packed uint32
// words, exact by construction.
//
// Main pass (`shortlist_kernel`): one block per profile row scores all N
// nodes and keeps each score's 32 ordered bits (common.cuh score_ord) in
// shared memory -- up to kRowSmem, 57,344 nodes; past that in a global
// scratch row.  Joined with the node id they are unique 64-bit keys
// (score descending, node id ascending: the jax.lax.top_k tie-break).
// common.cuh's block_radix_select finds the S-th key (run-length
// histograms, a parallel scan of the 256 bins, an early stop), and
// block_compact_asc writes the selected ids in ascending id order (one
// block barrier), so the sorted output the solve needs comes for free.
// With releasing capacity (`rel`/`pip` given: the JAX has_future branch)
// the fit test reads the solve-start FutureIdle fi0 = (idle + releasing) -
// pipelined (wave.py:608-609); the score keeps the live idle.  With host
// ports a node whose solve-start ports share a bit with the profile's is
// dropped (wave.py:650-653); with inter-pod terms on nonzero solve-start
// counts, aff_live's [U, N] planes mask the node and add the soft score
// after the static one (wave.py:655-660).  A custom plugin's per-profile
// [U, N] planes (`e_ok` verdicts, `e_score` scores; null when absent) are
// ANDed into the static verdict and added to the static score before the
// live score joins, node_score + (static + extra) (wave.py:642-645).
//
// Bound: at 10k nodes x 64 profile rows the pass reads under a megabyte
// (node planes once per block from L2) and does ~40 float operations per
// (profile, node) pair: microseconds on an H100.  The radix passes over
// each row's keys dominate; shared memory holds the keys, and a pass ends
// the select as soon as the S-th key's bucket is taken whole.
#include "common.cuh"

using vtt::Weights;

namespace {

// The inputs of the [U, C] static planes: the profile rows' bitsets and
// preferred-term weights, the node classes' tables, the node-affinity
// weight.  Passed by value; only its named fields are read.
struct StaticIn {
  const uint32_t* sel_bits;   // [U, LW]
  const uint32_t* aff_bits;   // [U, A, LW]
  const int32_t* aff_terms;   // [U]
  const uint32_t* tol_bits;   // [U, TW]
  const uint32_t* pref_bits;  // [U, AP, LW]
  const float* pref_w;        // [U, AP]
  const uint32_t* cls_label;  // [C, LW]
  const uint32_t* cls_taint;  // [C, TW]
  const uint8_t* cls_ready;   // [C]
  int LW, A, TW, AP;
  float naff;
  int has_taints;
};

// A StaticIn from the C entries' untyped arguments.
inline StaticIn static_in(const void* sel_bits, int LW, const void* aff_bits,
                          int A, const void* aff_terms, const void* tol_bits,
                          int TW, const void* pref_bits, int AP,
                          const void* pref_w, const void* cls_label,
                          const void* cls_taint, const void* cls_ready,
                          float naff, int has_taints) {
  return StaticIn{static_cast<const uint32_t*>(sel_bits),
                  static_cast<const uint32_t*>(aff_bits),
                  static_cast<const int32_t*>(aff_terms),
                  static_cast<const uint32_t*>(tol_bits),
                  static_cast<const uint32_t*>(pref_bits),
                  static_cast<const float*>(pref_w),
                  static_cast<const uint32_t*>(cls_label),
                  static_cast<const uint32_t*>(cls_taint),
                  static_cast<const uint8_t*>(cls_ready),
                  LW, A, TW, AP, naff, has_taints};
}

// Profile row u against node class c: the verdict, and the static score
// naff * pref (ops/wave.py _class_static), the planes' two cells.
__device__ __forceinline__ vtt::StaticPair static_at(const StaticIn& s,
                                                     int u, int c) {
  const vtt::StaticPair p = vtt::static_pair(
      s.cls_ready[c] != 0, s.cls_label + static_cast<int64_t>(c) * s.LW,
      s.has_taints ? s.cls_taint + static_cast<int64_t>(c) * s.TW : nullptr,
      s.LW, s.TW, s.sel_bits + static_cast<int64_t>(u) * s.LW,
      s.aff_bits + static_cast<int64_t>(u) * s.A * s.LW, s.A, s.aff_terms[u],
      s.tol_bits + static_cast<int64_t>(u) * s.TW,
      s.pref_bits + static_cast<int64_t>(u) * s.AP * s.LW,
      s.pref_w + static_cast<int64_t>(u) * s.AP, s.AP);
  return vtt::StaticPair{p.ok, s.naff * p.pref};
}

constexpr int kThreads = 512;
// A row's 4-byte ordered scores stay in shared memory up to this size
// (57,344 nodes); past it they go to the global scratch the wrapper
// passes (ops/kernels.py COARSE_SMEM mirrors it).
constexpr int kRowSmem = 224 * 1024;

// Calls emit(slot, i) for every i < L with pred(i), slots 0, 1, ... in
// ascending i, using the whole block (blockDim.x a multiple of 32, at
// most 1,024).  Warp w scans the w-th contiguous segment of [0, L) twice
// -- counting, then writing at its offset -- so the block synchronises
// once.  `warp_cnt` is 32 ints of shared memory.
template <typename Pred, typename Emit>
__device__ void block_compact_asc(int L, Pred pred, Emit emit,
                                  int* warp_cnt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int seg = ((L + nwarps - 1) / nwarps + 31) & ~31;
  const int lo = warp * seg;
  const int hi = min(L, lo + seg);
  int cnt = 0;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    cnt += __popc(__ballot_sync(vtt::kFullMask, i < hi && pred(i)));
  }
  if (lane == 0) warp_cnt[warp] = cnt;
  __syncthreads();
  int slot = 0;
  for (int w = 0; w < warp; ++w) slot += warp_cnt[w];
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const bool sel = i < hi && pred(i);
    const unsigned b = __ballot_sync(vtt::kFullMask, sel);
    if (sel) emit(slot + __popc(b & ((1u << lane) - 1u)), i);
    slot += __popc(b);
  }
}

// The [U, C] planes alone, one thread a pair.
__global__ void __launch_bounds__(256) class_static_kernel(
    StaticIn sin, int C, int U, uint8_t* stat_ok, float* stat_score) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(U) * C) return;
  const vtt::StaticPair s = static_at(
      sin, static_cast<int>(idx / C), static_cast<int>(idx % C));
  stat_ok[idx] = s.ok ? 1 : 0;
  stat_score[idx] = s.pref;
}

// `fill`: the block first writes row u's C static pairs into stat_ok /
// stat_score (read back below after the barrier; no other block touches
// row u).  Else those planes are given and only read.
__global__ void __launch_bounds__(kThreads, 2) shortlist_kernel(
    const float* req, const float* init_req, int R, uint8_t* stat_ok,
    float* stat_score, StaticIn sin, int fill, const int32_t* cls_id,
    int C, const float* idle, const float* rel, const float* pip,
    const float* alloc, const int32_t* ntasks, const int32_t* max_tasks,
    int N, const float* eps, const uint8_t* scalar_slot, const float* bres,
    Weights w, int S, uint32_t* ord_scratch, int in_smem, int32_t* out,
    const uint32_t* ports, int PW, const uint32_t* nports,
    const uint8_t* aff_ok, const float* aff_soft, const uint8_t* e_ok,
    const float* e_score) {
  extern __shared__ uint32_t s_ord[];  // [N] when in_smem
  __shared__ vtt::RadixSmem rs;
  __shared__ int warp_cnt[32];
  const int u = blockIdx.x;
  const float* rq = req + static_cast<int64_t>(u) * R;
  const float* irq = init_req + static_cast<int64_t>(u) * R;
  uint32_t* ord = in_smem ? s_ord : ord_scratch + static_cast<int64_t>(u) * N;
  uint8_t* sok = stat_ok + static_cast<int64_t>(u) * C;
  float* ssc = stat_score + static_cast<int64_t>(u) * C;
  if (fill) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const vtt::StaticPair p = static_at(sin, u, c);
      sok[c] = p.ok ? 1 : 0;
      ssc[c] = p.pref;
    }
    __syncthreads();
  }
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const int c = cls_id[n];
    const float* id = idle + static_cast<int64_t>(n) * R;
    const float* al = alloc + static_cast<int64_t>(n) * R;
    float fi0[vtt::kMaxR];
    vtt::future_idle(idle, rel, pip, nullptr, n, R, fi0);
    const bool pods_ok = max_tasks[n] <= 0 || ntasks[n] < max_tasks[n];
    const int64_t ai = static_cast<int64_t>(u) * N + n;
    const bool feas =
        sok[c] != 0 && vtt::less_equal(irq, fi0, eps, scalar_slot, R) &&
        pods_ok &&
        !(ports && vtt::ports_clash(ports + static_cast<int64_t>(u) * PW,
                                    nports, nullptr, n, PW)) &&
        !(aff_ok && !aff_ok[ai]) && !(e_ok && !e_ok[ai]);
    // An infeasible node's key is NEG whatever it scores: no score.
    float score = vtt::kNeg;
    if (feas) {
      float stat = ssc[c];
      if (e_score) stat = stat + e_score[ai];
      score = vtt::node_score(rq, al, id, bres, R, w) + stat;
      if (aff_soft) score = score + aff_soft[ai];
    }
    ord[n] = vtt::score_ord(score);
  }
  __syncthreads();
  auto key_at = [ord](int n) {
    return vtt::pos_key(ord[n], static_cast<uint32_t>(n));
  };
  const uint64_t kth = vtt::block_radix_select(key_at, N, S, N, rs);
  // The S selected node ids, ascending.
  int32_t* row = out + static_cast<int64_t>(u) * S;
  block_compact_asc(
      N, [&](int n) { return key_at(n) >= kth; },
      [row](int slot, int n) { row[slot] = n; }, warp_cnt);
}

}  // namespace

extern "C" int vtt_coarse_shortlist(
    const void* req, const void* init_req, int U, int R, const void* sel_bits,
    int LW, const void* aff_bits, int A, const void* aff_terms,
    const void* tol_bits, int TW, const void* pref_bits, int AP,
    const void* pref_w, const void* cls_id, const void* cls_label,
    const void* cls_taint, const void* cls_ready, int C, const void* idle,
    const void* rel, const void* pip, const void* alloc, const void* ntasks,
    const void* max_tasks, int N,
    const void* eps, const void* scalar_slot, const void* bres, float bw,
    float lw, float mw, float balw, float naff, int has_taints, int S,
    int static_ext, void* stat_ok, void* stat_score, void* keys_scratch,
    void* out, const void* ports, int PW, const void* nports,
    const void* aff_ok, const void* aff_soft, const void* e_ok,
    const void* e_score, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const StaticIn sin =
      static_ext ? StaticIn{}
                 : static_in(sel_bits, LW, aff_bits, A, aff_terms, tol_bits,
                             TW, pref_bits, AP, pref_w, cls_label, cls_taint,
                             cls_ready, naff, has_taints);
  Weights w{bw, lw, mw, balw};
  const size_t row_bytes = static_cast<size_t>(N) * sizeof(uint32_t);
  const int in_smem = row_bytes <= static_cast<size_t>(kRowSmem);
  if (!in_smem && !keys_scratch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = in_smem ? row_bytes : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        shortlist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  shortlist_kernel<<<U, kThreads, smem, st>>>(
      static_cast<const float*>(req), static_cast<const float*>(init_req), R,
      static_cast<uint8_t*>(stat_ok), static_cast<float*>(stat_score), sin,
      static_ext ? 0 : 1, static_cast<const int32_t*>(cls_id), C,
      static_cast<const float*>(idle), static_cast<const float*>(rel),
      static_cast<const float*>(pip), static_cast<const float*>(alloc),
      static_cast<const int32_t*>(ntasks),
      static_cast<const int32_t*>(max_tasks), N,
      static_cast<const float*>(eps),
      static_cast<const uint8_t*>(scalar_slot),
      static_cast<const float*>(bres), w, S,
      static_cast<uint32_t*>(keys_scratch), in_smem,
      static_cast<int32_t*>(out),
      static_cast<const uint32_t*>(ports), PW,
      static_cast<const uint32_t*>(nports),
      static_cast<const uint8_t*>(aff_ok),
      static_cast<const float*>(aff_soft),
      static_cast<const uint8_t*>(e_ok),
      static_cast<const float*>(e_score));
  return static_cast<int>(cudaGetLastError());
}

// The [U, C] static planes alone (the device-incremental lane's
// persistent planes, which its block-form launches read).
extern "C" int vtt_static_planes(
    int U, const void* sel_bits, int LW, const void* aff_bits, int A,
    const void* aff_terms, const void* tol_bits, int TW,
    const void* pref_bits, int AP, const void* pref_w,
    const void* cls_label, const void* cls_taint, const void* cls_ready,
    int C, float naff, int has_taints, void* stat_ok, void* stat_score,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t pairs = static_cast<int64_t>(U) * C;
  if (pairs == 0) return 0;
  const int threads = 256;
  const int blocks = static_cast<int>((pairs + threads - 1) / threads);
  class_static_kernel<<<blocks, threads, 0, st>>>(
      static_in(sel_bits, LW, aff_bits, A, aff_terms, tol_bits, TW,
                pref_bits, AP, pref_w, cls_label, cls_taint, cls_ready, naff,
                has_taints),
      C, U, static_cast<uint8_t*>(stat_ok), static_cast<float*>(stat_score));
  return static_cast<int>(cudaGetLastError());
}
