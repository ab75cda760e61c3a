// apply_commit: commit accepted tasks to the cluster state, or roll back
// discarded gangs.
//
// Replaces the apply step of the JAX package's sub-round
// (volcano_tpu/ops/wave.py:2013-2021: idle, ntasks, q_alloc, and the
// alloc_cnt / assigned updates of :2125-2131) and the final gang discard
// (wave.py:2262-2274: idle and q_alloc give back the requests of every
// task of a job that never reached min_available; assigned goes to -1).
// With releasing capacity a commit also takes the sub-round's pipelined
// acceptances (`pipe`, the has_future branch of wave.py:2023-2031 and
// :2131): pip_extra and q_pip grow by their requests, pip_ntasks by one,
// `pipelined` records the node.  alloc_cnt counts allocations only
// (:2125-2129), and the discard leaves pipelined rows alone (:2262-2272).
//
// No float atomicAdd whose order could change a float sum: requests are
// gathered per node and per queue in double (request values are integers
// in milli-units and bytes, so these sums are exact and the same in any
// order), and each touched row's sum is then added to the float state
// once.  Integer counters use integer atomics.  Where the JAX scatter-adds
// are exact in f32 (as they are for synthetic_cluster's milli-CPU and Gi
// values) the results agree bit for bit; the JAX scatter order is
// unspecified (wave.py:2271), so beyond that neither side is the
// reference.
//
// With host ports a commit ORs the task's port words into the node's used
// ports (`nport`; a pipelined task's into `pip_nport`), integer atomics
// (wave.py:2031-2042).  With inter-pod terms it adds one to the wave's
// count window at (e, node_dom[node, term_key[e]]) for every window term
// e the task's profile matches where the node has a domain -- `cw_a` for
// a commit, `cw_p` for a pipelined task -- as int32 atomics
// (wave.py:2043-2130).  The terms come from `match_terms`, each profile
// row's matched terms listed first (built once per wave), so a task visits
// only its own terms.
//
// One launch, `commit_kernel`, cooperative: one thread a task over as
// many 128-thread blocks as the tasks need (at most the card's co-resident
// blocks; more tasks loop), so the atomics spread over the SMs -- one SM
// issuing a 2,048-task sub-round's ~8,000 atomic transactions alone takes
// ~8 us.  Equal keys (node, queue, job, (term, domain) cell) in a run of
// neighbouring lanes add once: a segmented sum over the warp (five
// shuffle steps, skipped when no two neighbours share a key), then one
// atomic per run -- a hot node or a one-queue wave does not serialise on
// one address.  Node and queue sums go to the float64 accumulators as
// global reductions.  After a grid barrier each run's head claims its
// row's sums with an atomic exchange against zero -- the first claimer
// of a row gets the whole sum, any later one zero -- and adds them to the
// float plane (the pipelined planes too).  So only the rows the tasks
// touched are read and written, with no touched list to build, and the
// accumulators are left zeroed.
//
// Bound: reads T task rows and writes the touched rows; a few tens of KB
// per sub-round.  It is latency-bound: the task loads, the atomics, the
// grid barrier and the claims.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;

struct Commit {
  const int32_t* node;
  const uint8_t* mask;
  const float* rows;
  const int32_t* row_idx;
  const int32_t* qidx;
  int T;
  int R;
  double node_sign;
  double queue_sign;
  int mode;
  const int32_t* jw;
  float* idle;
  float* q_alloc;
  int32_t* ntasks;
  int32_t* alloc_l;
  int32_t* assigned;
  double* idle_acc;
  double* q_acc;
  const uint8_t* pipe;
  float* pip_extra;
  int32_t* pip_ntasks;
  float* q_pip;
  int32_t* pipelined;
  double* pxe_acc;
  double* qp_acc;
  const uint32_t* ports;
  int PW;
  uint32_t* nport;
  uint32_t* pip_nport;
  const int32_t* node_dom;
  int K;
  const int32_t* term_key;
  const int32_t* match_terms;
  int EW;
  int D;
  int32_t* cw_a;
  int32_t* cw_p;
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// Lanes 0 .. o as a bit mask.
__device__ __forceinline__ unsigned upto(int o) {
  return 0xFFFFFFFFu >> (31 - o);
}

// The heads of the warp's runs of equal `key` (lanes off carry -1).
__device__ __forceinline__ unsigned run_heads(int key) {
  const int lane = lane_id();
  const int prev = __shfl_up_sync(vtt::kFullMask, key, 1);
  return __ballot_sync(vtt::kFullMask, lane == 0 || prev != key);
}

// acc[key, :] += sign * rq for the lanes `on`: each run of equal keys
// sums its rows (a segmented suffix sum) and its head adds once.
__device__ void warp_add_rows(bool on, int key, const float* rq, int R,
                              double sign, double* acc) {
  if (!__any_sync(vtt::kFullMask, on)) return;
  const int lane = lane_id();
  const unsigned heads = run_heads(on ? key : -1);
  const int rid = __popc(heads & upto(lane));
  const bool lead = on && ((heads >> lane) & 1u);
  for (int s = 0; s < R; ++s) {
    double v = on ? sign * static_cast<double>(rq[s]) : 0.0;
    if (heads != vtt::kFullMask) {
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double y = __shfl_down_sync(vtt::kFullMask, v, off);
        if (lane + off < 32 && __popc(heads & upto(lane + off)) == rid) {
          v += y;
        }
      }
    }
    if (lead && v != 0.0) atomicAdd(&acc[static_cast<int64_t>(key) * R + s], v);
  }
}

// cnt[key] += 1 for the lanes `on`: one atomic per run of equal keys.
__device__ void warp_count(bool on, int key, int32_t* cnt) {
  if (!__any_sync(vtt::kFullMask, on)) return;
  const int lane = lane_id();
  const unsigned heads = run_heads(on ? key : -1);
  if (on && ((heads >> lane) & 1u)) {
    const unsigned after = lane == 31 ? 0u : heads >> (lane + 1);
    atomicAdd(&cnt[key], after ? __ffs(after) : 32 - lane);
  }
}

__device__ __forceinline__ void or_ports(uint32_t* plane,
                                         const uint32_t* ports, int u, int n,
                                         int PW) {
  for (int w = 0; w < PW; ++w) {
    const uint32_t bits = ports[static_cast<int64_t>(u) * PW + w];
    if (bits) atomicOr(&plane[static_cast<int64_t>(n) * PW + w], bits);
  }
}

// cw[e, node_dom[n, term_key[e]]] += 1 for each term e that task (u, n)
// of the lanes `on` matches, where the node has a domain; four terms a
// step, their loads together.
__device__ void warp_window(bool on, int u, int n, const Commit& a,
                            int32_t* cw) {
  if (!__any_sync(vtt::kFullMask, on)) return;
  const int32_t* lst = a.match_terms + static_cast<int64_t>(on ? u : 0) * a.EW;
  const int32_t* nd = a.node_dom + static_cast<int64_t>(on ? n : 0) * a.K;
  for (int i0 = 0;; i0 += 4) {
    int cell[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      cell[m] = (on && i0 + m < a.EW) ? lst[i0 + m] : -1;
    }
    // The lists are dense: a row's first -1 ends it.
    if (!__any_sync(vtt::kFullMask, cell[0] >= 0)) break;
    int key[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) key[m] = cell[m] >= 0 ? a.term_key[cell[m]] : 0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int dom = cell[m] >= 0 ? nd[key[m]] : -1;
      cell[m] = dom >= 0 ? cell[m] * a.D + dom : -1;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) warp_count(cell[m] >= 0, cell[m], cw);
  }
}

// Task t's commit (and pipelined charge); lanes past T are off.
__device__ void commit_task(const Commit& a, int t) {
  const bool in = t < a.T;
  if (!__any_sync(vtt::kFullMask, in)) return;
  const int n = in ? a.node[t] : -1;
  const int u = in ? a.row_idx[t] : 0;
  const int q = in ? a.qidx[t] : -1;
  const bool com = in && a.mask[t];
  const bool pip = in && a.pipe && a.pipe[t];
  const int jw = (in && a.mode == 0) ? a.jw[t] : -1;
  const float* rq = a.rows + static_cast<int64_t>(u) * a.R;
  if (a.pipe) {
    if (pip) a.pipelined[t] = n;
    warp_add_rows(pip, n, rq, a.R, 1.0, a.pxe_acc);
    warp_add_rows(pip, q, rq, a.R, 1.0, a.qp_acc);
    warp_count(pip, n, a.pip_ntasks);
    if (a.ports && pip) or_ports(a.pip_nport, a.ports, u, n, a.PW);
    if (a.cw_p) warp_window(pip, u, n, a, a.cw_p);
  }
  if (com) a.assigned[t] = a.mode == 0 ? n : -1;
  warp_add_rows(com, n, rq, a.R, a.node_sign, a.idle_acc);
  warp_add_rows(com, q, rq, a.R, a.queue_sign, a.q_acc);
  if (a.mode == 0) {
    warp_count(com, n, a.ntasks);
    warp_count(com, jw, a.alloc_l);
    if (a.ports && com) or_ports(a.nport, a.ports, u, n, a.PW);
    if (a.cw_a) warp_window(com, u, n, a, a.cw_a);
  }
}

// Each run head of the lanes `on` takes row `key`'s sums out of `acc`
// (an atomic exchange with zero: a row's first claimer gets its whole
// sum) and adds the nonzero ones to `plane`, whose values it loads with
// the claims.
__device__ void warp_claim(bool on, int key, int R, double* acc,
                           float* plane) {
  if (!__any_sync(vtt::kFullMask, on)) return;
  const unsigned heads = run_heads(on ? key : -1);
  if (!on || !((heads >> lane_id()) & 1u)) return;
  for (int s0 = 0; s0 < R; s0 += 4) {
    double tot[4];
    float pv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (s0 + k >= R) break;
      const int64_t j = static_cast<int64_t>(key) * R + s0 + k;
      tot[k] = __longlong_as_double(static_cast<long long>(atomicExch(
          reinterpret_cast<unsigned long long*>(&acc[j]), 0ull)));
      pv[k] = plane[j];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (s0 + k >= R) break;
      if (tot[k] != 0.0) {
        plane[static_cast<int64_t>(key) * R + s0 + k] =
            pv[k] + static_cast<float>(tot[k]);
      }
    }
  }
}

// Task t's claims after the barrier (the same lanes and runs as its adds).
__device__ void claim_task(const Commit& a, int t) {
  const bool in = t < a.T;
  if (!__any_sync(vtt::kFullMask, in)) return;
  const int n = in ? a.node[t] : -1;
  const int q = in ? a.qidx[t] : -1;
  const bool com = in && a.mask[t];
  if (a.pipe) {
    const bool pip = in && a.pipe[t];
    warp_claim(pip, n, a.R, a.pxe_acc, a.pip_extra);
    warp_claim(pip, q, a.R, a.qp_acc, a.q_pip);
  }
  warp_claim(com, n, a.R, a.idle_acc, a.idle);
  warp_claim(com, q, a.R, a.q_acc, a.q_alloc);
}

// Launched cooperatively: every block is resident, so the grid barrier
// cannot wait on a block that never starts.
__global__ void __launch_bounds__(kThreads) commit_kernel(Commit a) {
  const int end = max(a.T, 1);
  const int stride = gridDim.x * blockDim.x;
  for (int t0 = blockIdx.x * blockDim.x; t0 < end; t0 += stride) {
    commit_task(a, t0 + threadIdx.x);
  }
  // Every task's adds are done (and visible) before any claim.
  cg::this_grid().sync();
  for (int t0 = blockIdx.x * blockDim.x; t0 < end; t0 += stride) {
    claim_task(a, t0 + threadIdx.x);
  }
}

}  // namespace

// `rows` [UM, R] request rows.  `pipe` null: no pipelined acceptances
// (the pip_* pointers are unused).
// `match_terms` [UM, EW] int32: each profile row's matched window terms,
// then -1 (with counts only).
extern "C" int vtt_apply_commit(
    const void* node, const void* mask, const void* rows,
    const void* row_idx, const void* qidx, int T, int R, float idle_sign,
    int mode, const void* jw, void* idle, void* q_alloc, void* ntasks,
    void* alloc_l, void* assigned, void* idle_acc, void* q_acc,
    const void* pipe, void* pip_extra, void* pip_ntasks, void* q_pip,
    void* pipelined, void* pxe_acc, void* qp_acc, const void* ports, int PW,
    void* nport, void* pip_nport, const void* node_dom, int K,
    const void* term_key, const void* match_terms, int EW, int D, void* cw_a,
    void* cw_p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Commit a{static_cast<const int32_t*>(node),
           static_cast<const uint8_t*>(mask),
           static_cast<const float*>(rows),
           static_cast<const int32_t*>(row_idx),
           static_cast<const int32_t*>(qidx),
           T,
           R,
           static_cast<double>(idle_sign),
           -static_cast<double>(idle_sign),
           mode,
           static_cast<const int32_t*>(jw),
           static_cast<float*>(idle),
           static_cast<float*>(q_alloc),
           static_cast<int32_t*>(ntasks),
           static_cast<int32_t*>(alloc_l),
           static_cast<int32_t*>(assigned),
           static_cast<double*>(idle_acc),
           static_cast<double*>(q_acc),
           static_cast<const uint8_t*>(pipe),
           static_cast<float*>(pip_extra),
           static_cast<int32_t*>(pip_ntasks),
           static_cast<float*>(q_pip),
           static_cast<int32_t*>(pipelined),
           static_cast<double*>(pxe_acc),
           static_cast<double*>(qp_acc),
           static_cast<const uint32_t*>(ports),
           PW,
           static_cast<uint32_t*>(nport),
           static_cast<uint32_t*>(pip_nport),
           static_cast<const int32_t*>(node_dom),
           K,
           static_cast<const int32_t*>(term_key),
           static_cast<const int32_t*>(match_terms),
           EW,
           D,
           static_cast<int32_t*>(cw_a),
           static_cast<int32_t*>(cw_p)};
  if (cw_a && !match_terms) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The grid: a thread a task, at most the blocks the card holds at once.
  static int max_blocks = 0;
  if (max_blocks == 0) {
    int dev = 0;
    int sms = 0;
    int per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, commit_kernel, kThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    max_blocks = sms * per_sm;
  }
  const int want = T > 0 ? (T + kThreads - 1) / kThreads : 1;
  const int blocks = want < max_blocks ? want : max_blocks;
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(commit_kernel), dim3(blocks), dim3(kThreads),
      args, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
