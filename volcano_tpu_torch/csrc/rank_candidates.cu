// rank_candidates: the per-attempt live ranking of phase 2.
//
// Replaces `live_parts_sl` + `rank_shortlist` of the JAX package's
// `_solve_wave` (volcano_tpu/ops/wave.py:1302, :1376) and, on all N nodes,
// the shortlist-exhaustion fallback's `live_parts` + `rank_nodes`
// (wave.py:1192, :1277, used at :1450-1512).
//
// Each candidate of a ranked profile row (a shortlist id, or every node)
// gets its live feasibility (static class verdict, fit of the init
// request against the live idle, pod slots) and its live score (with
// releasing capacity, the has_future branch of wave.py:1205-1218 and
// :1314-1322: the fit reads FutureIdle = ((idle + releasing) - pipelined)
// - pip_extra and the pod slots count ntasks + pip_ntasks; the score keeps
// the live idle) (node_score + static score, NEG when infeasible; the
// static score takes the fabric topology's [N] node-order bias when one is
// given) as a 64-bit key (score descending, candidate position ascending:
// shortlists hold ascending node ids, so this is jax.lax.top_k's
// lowest-node-id tie-break).  With host ports a candidate whose used ports
// (allocated | pipelined) share a bit with the profile's is infeasible
// (wave.py:1222-1227, :1329-1334); with inter-pod terms the row's affinity
// planes (aff_live's verdict and soft score, [M, L] in row-and-candidate
// order) mask the candidate and add the soft score after the static one,
// (node_score + static) + soft (wave.py:1385-1389).  A custom plugin's
// per-profile [U, N] planes (`e_ok` verdicts, `e_score` scores; null when
// absent) are read at the row's profile, `pids[rows[b]]`: the verdict
// masks the candidate and the score joins the static score before the bias
// does, node_score + ((static + extra) + bias) (wave.py:1127-1139,
// :1165-1179).  Outputs: the top-K node ids in rank order, their
// feasibility, and whether any candidate was feasible.
//
// The keys are unique, so any exact selection gives the reference's order,
// ties included.  Two shapes:
//
//  - a row of at most kSortMax candidates (the per-attempt call on the
//    shortlists, L = S ~ 500): one block of rank_tile_kernel keeps its keys
//    in shared memory, padded to a power of two (at least 64) with the key
//    0 (below every real key, kNeg rows included), bitonic-sorts them
//    (common.cuh block_sort_desc: stages under 64 apart in registers) and
//    writes the first K.  No selection pass at all;
//  - a longer row (the fallback over all N nodes, run for a few exhausted
//    rows): its candidates are cut into tiles of kTile, one block each, so
//    a handful of rows still spread over dozens of SMs.  Each block sorts
//    its tile as above and keeps its top min(K, kTile) keys; then
//    rank_merge_kernel, one block a row, finds the K-th largest of the
//    tiles' keys by common.cuh's block_radix_select (run-length
//    histograms, a parallel scan of the 256 bins, an early stop once the
//    K-th key's bucket is taken whole) and bitonic-sorts only the K
//    selected keys.  The tiles'
//    keys sit in shared memory while they fit (kMergeSmem), else the passes
//    read them from the global scratch the wrapper passes.
//  A per-tile top-K and a merge (as coarse_shortlist's block_rank_kernel +
//  merge_kernel do) was preferred to a thread-block cluster sharing one
//  histogram: a cluster holds at most 16 blocks, so a row over ~16 tiles
//  would still need a second level, and the merge is the same code at any
//  N.
//
// Bound: per attempt it reads the wave's profile rows and the candidate
// nodes' idle/allocatable rows (16 profiles x 500 candidates x 2 slots at
// the north-star shape: ~100 KB) -- tens of nanoseconds; the kernel is
// latency-bound (dependent node-row gathers, the sort's barriers), and
// launch and the host's loop around it dominate the attempt.
#include "common.cuh"

using vtt::Weights;

namespace {

constexpr int kThreads = 512;
constexpr int kSortMax = 2048;  // a row up to this long sorts in one block
constexpr int kTile = 1024;     // candidates per block of a longer row
constexpr int kMergeSmem = 224 * 1024;  // the merge's dynamic shared memory

// Every input of one ranking, passed by value to both kernels.
struct Rank {
  const int32_t* rows;
  const int32_t* cand;
  int L;
  const uint8_t* ok_w;
  const float* score_w;
  const float* bias;
  int C;
  const int32_t* cls_id;
  const float* p_req;
  const float* p_init_req;
  int R;
  const float* idle;
  const float* rel;
  const float* pip;
  const float* pxe;
  const int32_t* pip_ntasks;
  const float* alloc;
  const int32_t* ntasks;
  const int32_t* max_tasks;
  const float* eps;
  const uint8_t* scalar_slot;
  const float* bres;
  Weights w;
  const uint32_t* ports;
  int PW;
  const uint32_t* nport;
  const uint32_t* pip_nport;
  const uint8_t* aff_ok;
  const float* aff_soft;
  const int32_t* pids;
  int EN;
  const uint8_t* e_ok;
  const float* e_score;
  int K;
  int32_t* out_ranked;
  uint8_t* out_feas;
  uint8_t* out_pany;
};

// The key of candidate i of row b (profile row u) and its feasibility.
__device__ __forceinline__ uint64_t candidate_key(const Rank& a, int b, int u,
                                                  int i, bool* feas_out) {
  const int n = a.cand ? a.cand[static_cast<int64_t>(u) * a.L + i] : i;
  const int c = a.cls_id[n];
  const float* rq = a.p_req + static_cast<int64_t>(u) * a.R;
  const float* irq = a.p_init_req + static_cast<int64_t>(u) * a.R;
  const float* id = a.idle + static_cast<int64_t>(n) * a.R;
  const float* al = a.alloc + static_cast<int64_t>(n) * a.R;
  const int64_t erow = a.pids ? static_cast<int64_t>(a.pids[u]) * a.EN : 0;
  const int64_t ai = static_cast<int64_t>(b) * a.L + i;
  float fi[vtt::kMaxR];
  vtt::future_idle(a.idle, a.rel, a.pip, a.pxe, n, a.R, fi);
  const int nt = a.ntasks[n] + (a.pip_ntasks ? a.pip_ntasks[n] : 0);
  const bool pods_ok = a.max_tasks[n] <= 0 || nt < a.max_tasks[n];
  const bool feas =
      a.ok_w[static_cast<int64_t>(u) * a.C + c] != 0 &&
      vtt::less_equal(irq, fi, a.eps, a.scalar_slot, a.R) && pods_ok &&
      !(a.ports && vtt::ports_clash(a.ports + static_cast<int64_t>(u) * a.PW,
                                    a.nport, a.pip_nport, n, a.PW)) &&
      !(a.aff_ok && !a.aff_ok[ai]) && !(a.e_ok && !a.e_ok[erow + n]);
  // The custom score, then the topology bias, join the static score
  // before the live score does (wave.py:1165-1179, :1288), each only
  // when given: -0.0 + 0.0 would flip a sign bit of a plain solve.
  // An infeasible candidate's key is NEG whatever it scores: no score.
  float score = vtt::kNeg;
  if (feas) {
    float stat = a.score_w[static_cast<int64_t>(u) * a.C + c];
    if (a.e_score) stat = stat + a.e_score[erow + n];
    if (a.bias) stat = stat + a.bias[n];
    score = vtt::node_score(rq, al, id, a.bres, a.R, a.w) + stat;
    if (a.aff_soft) score = score + a.aff_soft[ai];
  }
  *feas_out = feas;
  return vtt::make_key(score, static_cast<uint32_t>(i));
}

// The node id of candidate position `pos` of row u.
__device__ __forceinline__ int node_of(const Rank& a, int u, int pos) {
  return a.cand ? a.cand[static_cast<int64_t>(u) * a.L + pos] : pos;
}

__device__ __forceinline__ int key_pos(uint64_t key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
}

// Block (b, t): candidates [t * TL, min(L, (t + 1) * TL)) of row b, their
// keys and feasibility in shared memory ([TL] keys, then [TL] bytes),
// sorted.  One tile: the row's outputs.  Several: the tile's top Kt keys
// to `tile_keys` [M, T, Kt], the feasibility by position to `feas_g`
// [M, L] and the tile's any-feasible flag to `any_g` [M, T].
__global__ void __launch_bounds__(kThreads) rank_tile_kernel(
    Rank a, int TL, int Kt, uint64_t* tile_keys, uint8_t* feas_g,
    uint8_t* any_g) {
  extern __shared__ uint64_t s_keys[];
  uint8_t* s_feas = reinterpret_cast<uint8_t*>(s_keys + TL);
  const int b = blockIdx.x;
  const int t = blockIdx.y;
  const int T = gridDim.y;
  const int u = a.rows[b];
  const int i0 = t * TL;
  const int here = min(TL, a.L - i0);
  int any = 0;
  for (int j = threadIdx.x; j < TL; j += blockDim.x) {
    uint64_t key = 0;
    bool feas = false;
    if (j < here) key = candidate_key(a, b, u, i0 + j, &feas);
    s_keys[j] = key;
    s_feas[j] = feas ? 1 : 0;
    any |= feas ? 1 : 0;
  }
  any = __syncthreads_or(any);
  vtt::block_sort_desc(s_keys, TL);
  if (T == 1) {
    for (int k = threadIdx.x; k < a.K; k += blockDim.x) {
      const int pos = key_pos(s_keys[k]);
      a.out_ranked[static_cast<int64_t>(b) * a.K + k] = node_of(a, u, pos);
      a.out_feas[static_cast<int64_t>(b) * a.K + k] = s_feas[pos];
    }
    if (threadIdx.x == 0) a.out_pany[b] = any ? 1 : 0;
    return;
  }
  uint64_t* dst = tile_keys + (static_cast<int64_t>(b) * T + t) * Kt;
  for (int k = threadIdx.x; k < Kt; k += blockDim.x) dst[k] = s_keys[k];
  for (int j = threadIdx.x; j < here; j += blockDim.x) {
    feas_g[static_cast<int64_t>(b) * a.L + i0 + j] = s_feas[j];
  }
  if (threadIdx.x == 0) any_g[static_cast<int64_t>(b) * T + t] = any;
}

// Block b: the row's K winners among its T tiles' top keys (Kt each,
// padded with the key 0 where a tile held fewer candidates).  Dynamic
// shared memory: [KP] selected keys (KP the power of two >= K), then the
// row's T * Kt keys when `keys_in_smem`.
__global__ void __launch_bounds__(kThreads) rank_merge_kernel(
    Rank a, int T, int Kt, const uint64_t* tile_keys, const uint8_t* feas_g,
    const uint8_t* any_g, int KP, int keys_in_smem) {
  extern __shared__ uint64_t s_dyn[];
  __shared__ vtt::RadixSmem rs;
  __shared__ int n_sel;
  const int b = blockIdx.x;
  const int u = a.rows[b];
  const int tid = threadIdx.x;
  const int C = T * Kt;
  uint64_t* sel = s_dyn;
  const uint64_t* keys = tile_keys + static_cast<int64_t>(b) * C;
  if (keys_in_smem) {
    uint64_t* s_keys = s_dyn + KP;
    for (int i = tid; i < C; i += blockDim.x) s_keys[i] = keys[i];
    keys = s_keys;
  }
  if (tid == 0) n_sel = 0;
  __syncthreads();
  const uint64_t prefix = vtt::block_radix_select(
      [keys](int i) { return keys[i]; }, C, a.K, a.L, rs);

  for (int i = tid; i < C; i += blockDim.x) {
    const uint64_t key = keys[i];
    if (key >= prefix) sel[atomicAdd(&n_sel, 1)] = key;
  }
  for (int i = a.K + tid; i < KP; i += blockDim.x) sel[i] = 0;
  __syncthreads();
  vtt::block_sort_desc(sel, KP);
  for (int k = tid; k < a.K; k += blockDim.x) {
    const int pos = key_pos(sel[k]);
    a.out_ranked[static_cast<int64_t>(b) * a.K + k] = node_of(a, u, pos);
    a.out_feas[static_cast<int64_t>(b) * a.K + k] =
        feas_g[static_cast<int64_t>(b) * a.L + pos];
  }
  if (tid == 0) {
    int any = 0;
    for (int t = 0; t < T; ++t) any |= any_g[static_cast<int64_t>(b) * T + t];
    a.out_pany[b] = any ? 1 : 0;
  }
}

// The power of two >= n, at least 64 (block_sort_desc's chunk).
int pow2_at_least(int n) {
  int p = 64;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

// A row of L <= kSortMax candidates runs as one tile (the scratches are
// null); a longer one as ceil(L / kTile) tiles and a merge, with
// `tile_keys` [M, T, min(K, kTile)] uint64, `feas_scratch` [M, L] and
// `any_scratch` [M, T] bytes (ops/kernels.py rank_candidates mirrors
// these limits).
extern "C" int vtt_rank_candidates(
    const void* rows, int M, const void* cand, int L, const void* ok_w,
    const void* score_w, const void* bias, int C, const void* cls_id,
    const void* p_req,
    const void* p_init_req, int R, const void* idle, const void* rel,
    const void* pip, const void* pxe, const void* pip_ntasks,
    const void* alloc,
    const void* ntasks, const void* max_tasks, const void* eps,
    const void* scalar_slot, const void* bres, float bw, float lw, float mw,
    float balw, int K, void* tile_keys, void* feas_scratch,
    void* any_scratch, void* out_ranked, void* out_feas, void* out_pany,
    const void* ports, int PW, const void* nport, const void* pip_nport,
    const void* aff_ok, const void* aff_soft, const void* pids, int EN,
    const void* e_ok, const void* e_score, void* stream) {
  if (M == 0) return 0;
  if (K < 1 || K > L) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Rank a{static_cast<const int32_t*>(rows),
         static_cast<const int32_t*>(cand),
         L,
         static_cast<const uint8_t*>(ok_w),
         static_cast<const float*>(score_w),
         static_cast<const float*>(bias),
         C,
         static_cast<const int32_t*>(cls_id),
         static_cast<const float*>(p_req),
         static_cast<const float*>(p_init_req),
         R,
         static_cast<const float*>(idle),
         static_cast<const float*>(rel),
         static_cast<const float*>(pip),
         static_cast<const float*>(pxe),
         static_cast<const int32_t*>(pip_ntasks),
         static_cast<const float*>(alloc),
         static_cast<const int32_t*>(ntasks),
         static_cast<const int32_t*>(max_tasks),
         static_cast<const float*>(eps),
         static_cast<const uint8_t*>(scalar_slot),
         static_cast<const float*>(bres),
         Weights{bw, lw, mw, balw},
         static_cast<const uint32_t*>(ports),
         PW,
         static_cast<const uint32_t*>(nport),
         static_cast<const uint32_t*>(pip_nport),
         static_cast<const uint8_t*>(aff_ok),
         static_cast<const float*>(aff_soft),
         static_cast<const int32_t*>(pids),
         EN,
         static_cast<const uint8_t*>(e_ok),
         static_cast<const float*>(e_score),
         K,
         static_cast<int32_t*>(out_ranked),
         static_cast<uint8_t*>(out_feas),
         static_cast<uint8_t*>(out_pany)};
  const bool one = L <= kSortMax;
  const int TL = one ? pow2_at_least(L) : kTile;  // >= 64: the sort's chunk
  const int T = one ? 1 : (L + kTile - 1) / kTile;
  const int Kt = K < TL ? K : TL;
  if (!one && (!tile_keys || !feas_scratch || !any_scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t tile_smem = static_cast<size_t>(TL) * 9;
  rank_tile_kernel<<<dim3(M, T), kThreads, tile_smem, st>>>(
      a, TL, Kt, static_cast<uint64_t*>(tile_keys),
      static_cast<uint8_t*>(feas_scratch), static_cast<uint8_t*>(any_scratch));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || one) return static_cast<int>(err);
  const int KP = pow2_at_least(K);
  const size_t sel_bytes = static_cast<size_t>(KP) * 8;
  const size_t key_bytes = static_cast<size_t>(T) * Kt * 8;
  if (sel_bytes > static_cast<size_t>(kMergeSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int in_smem = sel_bytes + key_bytes <= static_cast<size_t>(kMergeSmem);
  const size_t smem = sel_bytes + (in_smem ? key_bytes : 0);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(rank_merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rank_merge_kernel<<<M, kThreads, smem, st>>>(
      a, T, Kt, static_cast<const uint64_t*>(tile_keys),
      static_cast<const uint8_t*>(feas_scratch),
      static_cast<const uint8_t*>(any_scratch), KP, in_smem);
  return static_cast<int>(cudaGetLastError());
}
