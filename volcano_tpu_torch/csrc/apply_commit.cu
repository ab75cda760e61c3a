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
// gathered per node and per queue in double (`accumulate_kernel`; request
// values are integers in milli-units and bytes, so these sums are exact
// and the same in any order), and `write_kernel` then adds each touched
// row's sum to the float state once.  Integer counters use integer atomics.
// Where the JAX scatter-adds are exact in f32 (as they are for
// synthetic_cluster's milli-CPU and Gi values) the results agree bit for
// bit; the JAX scatter order is unspecified (wave.py:2271), so beyond
// that neither side is the reference.
//
// With host ports a commit ORs the task's port words into the node's used
// ports (`nport`; a pipelined task's into `pip_nport`), integer atomics
// (wave.py:2031-2042).  With inter-pod terms it adds one to the wave's
// count window at (e, node_dom[node, term_key[e]]) for every window term
// e the task's profile matches where the node has a domain -- `cw_a` for
// a commit, `cw_p` for a pipelined task -- as int32 atomics
// (wave.py:2043-2130).
//
// Bound: reads T task rows and writes the touched N x R rows; a few tens
// of KB per sub-round, microseconds.
#include "common.cuh"

namespace {

__device__ __forceinline__ void add_row(double* node_acc, double* queue_acc,
                                        const float* rq, int n, int q, int R,
                                        double node_sign, double queue_sign) {
  for (int s = 0; s < R; ++s) {
    const double v = static_cast<double>(rq[s]);
    if (v != 0.0) {
      atomicAdd(&node_acc[static_cast<int64_t>(n) * R + s], node_sign * v);
      atomicAdd(&queue_acc[static_cast<int64_t>(q) * R + s], queue_sign * v);
    }
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

__device__ __forceinline__ void add_counts(int32_t* cw,
                                           const int32_t* node_dom, int K,
                                           const int32_t* term_key,
                                           const uint8_t* t_match, int u,
                                           int n, int EW, int D) {
  const int32_t* nd = node_dom + static_cast<int64_t>(n) * K;
  for (int e = 0; e < EW; ++e) {
    if (!t_match[static_cast<int64_t>(u) * EW + e]) continue;
    const int dom = nd[term_key[e]];
    if (dom >= 0) atomicAdd(&cw[static_cast<int64_t>(e) * D + dom], 1);
  }
}

__global__ void __launch_bounds__(256) accumulate_kernel(
    const int32_t* node, const uint8_t* mask, const float* rows,
    const int32_t* row_idx, const int32_t* qidx, int T, int R,
    float idle_sign, int mode, const int32_t* jw, int32_t* ntasks,
    int32_t* alloc_l, int32_t* assigned, double* idle_acc, double* q_acc,
    const uint8_t* pipe, int32_t* pip_ntasks, int32_t* pipelined,
    double* pxe_acc, double* qp_acc, const uint32_t* ports, int PW,
    uint32_t* nport, uint32_t* pip_nport, const int32_t* node_dom, int K,
    const int32_t* term_key, const uint8_t* t_match, int EW, int D,
    int32_t* cw_a, int32_t* cw_p) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const int n = node[t];
  const float* rq = rows + static_cast<int64_t>(row_idx[t]) * R;
  const int q = qidx[t];
  const int u = row_idx[t];
  if (pipe && pipe[t]) {
    add_row(pxe_acc, qp_acc, rq, n, q, R, 1.0, 1.0);
    atomicAdd(&pip_ntasks[n], 1);
    pipelined[t] = n;
    if (ports) or_ports(pip_nport, ports, u, n, PW);
    if (cw_p) add_counts(cw_p, node_dom, K, term_key, t_match, u, n, EW, D);
  }
  if (!mask[t]) return;
  add_row(idle_acc, q_acc, rq, n, q, R, static_cast<double>(idle_sign),
          -static_cast<double>(idle_sign));
  if (mode == 0) {
    atomicAdd(&ntasks[n], 1);
    atomicAdd(&alloc_l[jw[t]], 1);
    assigned[t] = n;
    if (ports) or_ports(nport, ports, u, n, PW);
    if (cw_a) add_counts(cw_a, node_dom, K, term_key, t_match, u, n, EW, D);
  } else {
    assigned[t] = -1;
  }
}

__global__ void __launch_bounds__(256) write_kernel(
    float* idle, int64_t nidle, double* idle_acc, float* q_alloc, int64_t nq,
    double* q_acc) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < nidle) {
    const double tot = idle_acc[i];
    if (tot != 0.0) {
      idle[i] = idle[i] + static_cast<float>(tot);
      idle_acc[i] = 0.0;
    }
  } else if (i < nidle + nq) {
    const int64_t j = i - nidle;
    const double tot = q_acc[j];
    if (tot != 0.0) {
      q_alloc[j] = q_alloc[j] + static_cast<float>(tot);
      q_acc[j] = 0.0;
    }
  }
}

}  // namespace

// `pipe` null: no pipelined acceptances (the pip_* pointers are unused).
extern "C" int vtt_apply_commit(
    const void* node, const void* mask, const void* rows, const void* row_idx,
    const void* qidx, int T, int R, float idle_sign, int mode, const void* jw,
    void* idle, int N, void* q_alloc, int Q, void* ntasks, void* alloc_l,
    void* assigned, void* idle_acc, void* q_acc, const void* pipe,
    void* pip_extra, void* pip_ntasks, void* q_pip, void* pipelined,
    void* pxe_acc, void* qp_acc, const void* ports, int PW, void* nport,
    void* pip_nport, const void* node_dom, int K, const void* term_key,
    const void* t_match, int EW, int D, void* cw_a, void* cw_p,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  if (T > 0) {
    accumulate_kernel<<<(T + threads - 1) / threads, threads, 0, st>>>(
        static_cast<const int32_t*>(node), static_cast<const uint8_t*>(mask),
        static_cast<const float*>(rows), static_cast<const int32_t*>(row_idx),
        static_cast<const int32_t*>(qidx), T, R, idle_sign, mode,
        static_cast<const int32_t*>(jw), static_cast<int32_t*>(ntasks),
        static_cast<int32_t*>(alloc_l), static_cast<int32_t*>(assigned),
        static_cast<double*>(idle_acc), static_cast<double*>(q_acc),
        static_cast<const uint8_t*>(pipe), static_cast<int32_t*>(pip_ntasks),
        static_cast<int32_t*>(pipelined), static_cast<double*>(pxe_acc),
        static_cast<double*>(qp_acc), static_cast<const uint32_t*>(ports),
        PW, static_cast<uint32_t*>(nport), static_cast<uint32_t*>(pip_nport),
        static_cast<const int32_t*>(node_dom), K,
        static_cast<const int32_t*>(term_key),
        static_cast<const uint8_t*>(t_match), EW, D,
        static_cast<int32_t*>(cw_a), static_cast<int32_t*>(cw_p));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t nidle = static_cast<int64_t>(N) * R;
  const int64_t nq = static_cast<int64_t>(Q) * R;
  const int blocks = static_cast<int>((nidle + nq + threads - 1) / threads);
  write_kernel<<<blocks, threads, 0, st>>>(
      static_cast<float*>(idle), nidle, static_cast<double*>(idle_acc),
      static_cast<float*>(q_alloc), nq, static_cast<double*>(q_acc));
  if (pipe) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    write_kernel<<<blocks, threads, 0, st>>>(
        static_cast<float*>(pip_extra), nidle, static_cast<double*>(pxe_acc),
        static_cast<float*>(q_pip), nq, static_cast<double*>(qp_acc));
  }
  return static_cast<int>(cudaGetLastError());
}
