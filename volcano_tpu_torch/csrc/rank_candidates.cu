// rank_candidates: the per-attempt live ranking of phase 2.
//
// Replaces `live_parts_sl` + `rank_shortlist` of the JAX package's
// `_solve_wave` (volcano_tpu/ops/wave.py:1302, :1376) and, on all N nodes,
// the shortlist-exhaustion fallback's `live_parts` + `rank_nodes`
// (wave.py:1192, :1277, used at :1450-1512).
//
// One block per ranked profile row.  Each candidate (a shortlist id, or
// every node) gets its live feasibility (static class verdict, fit of the
// init request against the live idle, pod slots) and its live score
// (with releasing capacity, the has_future branch of wave.py:1205-1218 and
// :1314-1322: the fit reads FutureIdle = ((idle + releasing) - pipelined)
// - pip_extra and the pod slots count ntasks + pip_ntasks; the score keeps
// the live idle)
// (node_score + static score, NEG when infeasible; the static score takes
// the fabric topology's [N] node-order bias when one is given) as a 64-bit
// key (score descending, candidate position ascending: shortlists hold
// ascending node ids, so this is jax.lax.top_k's lowest-node-id tie-break).
// With host ports a candidate whose used ports (allocated | pipelined)
// share a bit with the profile's is infeasible (wave.py:1222-1227,
// :1329-1334); with inter-pod terms the row's affinity planes (aff_live's
// verdict and soft score, [M, L] in row-and-candidate order) mask the
// candidate and add the soft score after the static one, (node_score +
// static) + soft (wave.py:1385-1389).  A custom plugin's per-profile
// [U, N] planes (`e_ok` verdicts, `e_score` scores; null when absent) are
// read at the row's profile, `pids[rows[b]]`: the verdict masks the
// candidate and the score joins the static score before the bias does,
// node_score + ((static + extra) + bias) (wave.py:1127-1139, :1165-1179).
// A radix select finds the K-th key; the K winners are ordered by counting,
// for each, the winners with a larger key.  Outputs: the top-K node ids in
// rank order, their feasibility, and whether any candidate was feasible.
//
// Bound: per attempt it reads the wave's profile rows and the candidate
// nodes' idle/allocatable rows (16 profiles x 500 candidates x 2 slots at
// the north-star shape: ~100 KB) -- microseconds; launch and the host's
// loop around it dominate.
#include "common.cuh"

using vtt::Weights;

namespace {

__global__ void __launch_bounds__(512) rank_kernel(
    const int32_t* rows, const int32_t* cand, int L, const uint8_t* ok_w,
    const float* score_w, const float* bias, int C, const int32_t* cls_id,
    const float* p_req,
    const float* p_init_req, int R, const float* idle, const float* rel,
    const float* pip, const float* pxe, const int32_t* pip_ntasks,
    const float* alloc, const int32_t* ntasks, const int32_t* max_tasks,
    const float* eps,
    const uint8_t* scalar_slot, const float* bres, Weights w, int K,
    uint64_t* keys_scratch, uint8_t* feas_scratch, int32_t* out_ranked,
    uint8_t* out_feas, uint8_t* out_pany, const uint32_t* ports, int PW,
    const uint32_t* nport, const uint32_t* pip_nport, const uint8_t* aff_ok,
    const float* aff_soft, const int32_t* pids, int EN, const uint8_t* e_ok,
    const float* e_score) {
  extern __shared__ uint64_t sel_key[];  // [K]
  __shared__ int hist[256];
  __shared__ int bcast[2];
  __shared__ int n_sel;
  __shared__ int any_feas;
  const int b = blockIdx.x;
  const int u = rows[b];
  const float* rq = p_req + static_cast<int64_t>(u) * R;
  const float* irq = p_init_req + static_cast<int64_t>(u) * R;
  uint64_t* keys = keys_scratch + static_cast<int64_t>(b) * L;
  uint8_t* feas_row = feas_scratch + static_cast<int64_t>(b) * L;
  const int64_t erow = pids ? static_cast<int64_t>(pids[u]) * EN : 0;
  if (threadIdx.x == 0) {
    n_sel = 0;
    any_feas = 0;
  }
  __syncthreads();
  int local_any = 0;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const int n = cand ? cand[static_cast<int64_t>(u) * L + i] : i;
    const int c = cls_id[n];
    const float* id = idle + static_cast<int64_t>(n) * R;
    const float* al = alloc + static_cast<int64_t>(n) * R;
    float fi[vtt::kMaxR];
    vtt::future_idle(idle, rel, pip, pxe, n, R, fi);
    const int nt = ntasks[n] + (pip_ntasks ? pip_ntasks[n] : 0);
    const bool pods_ok = max_tasks[n] <= 0 || nt < max_tasks[n];
    const int64_t ai = static_cast<int64_t>(b) * L + i;
    const bool feas =
        ok_w[static_cast<int64_t>(u) * C + c] != 0 &&
        vtt::less_equal(irq, fi, eps, scalar_slot, R) && pods_ok &&
        !(ports && vtt::ports_clash(ports + static_cast<int64_t>(u) * PW,
                                    nport, pip_nport, n, PW)) &&
        !(aff_ok && !aff_ok[ai]) && !(e_ok && !e_ok[erow + n]);
    // The custom score, then the topology bias, join the static score
    // before the live score does (wave.py:1165-1179, :1288), each only
    // when given: -0.0 + 0.0 would flip a sign bit of a plain solve.
    float stat = score_w[static_cast<int64_t>(u) * C + c];
    if (e_score) stat = stat + e_score[erow + n];
    if (bias) stat = stat + bias[n];
    float score = vtt::node_score(rq, al, id, bres, R, w) + stat;
    if (aff_soft) score = score + aff_soft[ai];
    keys[i] = vtt::make_key(feas ? score : vtt::kNeg, static_cast<uint32_t>(i));
    feas_row[i] = feas ? 1 : 0;
    local_any |= feas ? 1 : 0;
  }
  if (local_any) atomicOr(&any_feas, 1);
  __syncthreads();
  const uint64_t kth = vtt::block_select_kth(keys, L, K, hist, bcast);
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    if (keys[i] >= kth) {
      const int slot = atomicAdd(&n_sel, 1);
      sel_key[slot] = keys[i];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const uint64_t key = sel_key[i];
    int rank = 0;
    for (int j = 0; j < K; ++j) rank += sel_key[j] > key ? 1 : 0;
    const int pos = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
    const int n = cand ? cand[static_cast<int64_t>(u) * L + pos] : pos;
    out_ranked[static_cast<int64_t>(b) * K + rank] = n;
    out_feas[static_cast<int64_t>(b) * K + rank] = feas_row[pos];
  }
  if (threadIdx.x == 0) out_pany[b] = any_feas ? 1 : 0;
}

}  // namespace

extern "C" int vtt_rank_candidates(
    const void* rows, int M, const void* cand, int L, const void* ok_w,
    const void* score_w, const void* bias, int C, const void* cls_id,
    const void* p_req,
    const void* p_init_req, int R, const void* idle, const void* rel,
    const void* pip, const void* pxe, const void* pip_ntasks,
    const void* alloc,
    const void* ntasks, const void* max_tasks, const void* eps,
    const void* scalar_slot, const void* bres, float bw, float lw, float mw,
    float balw, int K, void* keys_scratch, void* feas_scratch,
    void* out_ranked, void* out_feas, void* out_pany, const void* ports,
    int PW, const void* nport, const void* pip_nport, const void* aff_ok,
    const void* aff_soft, const void* pids, int EN, const void* e_ok,
    const void* e_score, void* stream) {
  if (M == 0) return 0;
  const size_t smem = static_cast<size_t>(K) * sizeof(uint64_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Weights w{bw, lw, mw, balw};
  rank_kernel<<<M, 512, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cand), L,
      static_cast<const uint8_t*>(ok_w), static_cast<const float*>(score_w),
      static_cast<const float*>(bias), C,
      static_cast<const int32_t*>(cls_id), static_cast<const float*>(p_req),
      static_cast<const float*>(p_init_req), R,
      static_cast<const float*>(idle), static_cast<const float*>(rel),
      static_cast<const float*>(pip), static_cast<const float*>(pxe),
      static_cast<const int32_t*>(pip_ntasks),
      static_cast<const float*>(alloc),
      static_cast<const int32_t*>(ntasks),
      static_cast<const int32_t*>(max_tasks), static_cast<const float*>(eps),
      static_cast<const uint8_t*>(scalar_slot),
      static_cast<const float*>(bres), w, K,
      static_cast<uint64_t*>(keys_scratch),
      static_cast<uint8_t*>(feas_scratch), static_cast<int32_t*>(out_ranked),
      static_cast<uint8_t*>(out_feas), static_cast<uint8_t*>(out_pany),
      static_cast<const uint32_t*>(ports), PW,
      static_cast<const uint32_t*>(nport),
      static_cast<const uint32_t*>(pip_nport),
      static_cast<const uint8_t*>(aff_ok),
      static_cast<const float*>(aff_soft),
      static_cast<const int32_t*>(pids), EN,
      static_cast<const uint8_t*>(e_ok),
      static_cast<const float*>(e_score));
  return static_cast<int>(cudaGetLastError());
}
