// topology: per-fabric-block gang fit and the stranded-capacity score.
//
// Replaces the JAX package's jitted `gang_block_fit` and `fabric_frag`
// (volcano_tpu/ops/topology.py:179, :240).
//
// gang_block_fit, for one gang's [U, R] profile table (all-zero rows
// inert) and [U] pending counts (0 for padding):
//
//   cap[n, u]  = min over the slots of floor((idle + eps) / max(req,
//                1e-9)) for a requested slot and 2^30 for one not
//                requested (0 for a profile that requests nothing), clipped to [0, 2^30],
//                capped by the node's free pod slots when max_tasks > 0,
//                0 on a node that is not ready -- an exact int32;
//   cfit[b, u] = sum of cap over the nodes of block b (block_id -1 rows
//                go to a trash row b = Bp, which the wrapper drops);
//   whole[b]   = cfit[b, u] >= cnt[u] for every u;
//   score[b]   = sum over u of min(cfit[b, u], cnt[u]) in f32.
//
// The TPU program scatters with `.at[seg].add`; here one thread per node
// computes its U capacities and adds them with integer atomics, which are
// exact in any order (int32 wraps alike on both sides).  A second launch,
// one thread per block, reduces a block's row to `whole` and `score`
// (integer-valued f32 sums, exact below 2^24).
//
// fabric_frag, one thread per block: need = max(sum cnt, 1) and
// frag[b] = whole[b] ? 0 : (sum over u of min(f32 cfit[b, u], cnt[u])) /
// need, summed left to right.
//
// Bound: bytes -- gang_block_fit reads the [N, R] idle plane and four [N]
// node planes (~28 bytes a node at R = 2; 8,192 nodes: ~0.23 MB) and
// writes [B, U] counts; its ~U R divisions a node are far below the card's
// rate.  fabric_frag reads and writes a few KB: launch latency dominates.
#include "common.cuh"

namespace {

constexpr float kFitMax = 1073741824.0f;  // 2^30 (topology.py _FIT_MAX)

__global__ void __launch_bounds__(256) node_cap_kernel(
    const float* idle, const uint8_t* ready, const int32_t* ntasks,
    const int32_t* max_tasks, const int32_t* block_id, const float* req,
    const float* eps, int N, int U, int R, int Bp, int32_t* cfit) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N || !ready[n]) return;  // not ready: capacity 0 everywhere
  const int b = block_id[n];
  const int seg = b >= 0 ? b : Bp;
  if (seg > Bp) return;  // out of range: dropped, as XLA's scatter drops
  const int64_t o = static_cast<int64_t>(n) * R;
  float id[vtt::kMaxR];
  for (int s = 0; s < R; ++s) id[s] = idle[o + s];
  const int mt = max_tasks[n];
  const int left = mt - ntasks[n];
  const float slots = mt > 0 ? static_cast<float>(left > 0 ? left : 0)
                             : kFitMax;
  for (int u = 0; u < U; ++u) {
    const float* rq = req + static_cast<int64_t>(u) * R;
    float cap = INFINITY;
    bool any = false;
    for (int s = 0; s < R; ++s) {
      const bool requested = rq[s] > eps[s];
      any = any || requested;
      const float per =
          requested ? floorf((id[s] + eps[s]) / fmaxf(rq[s], 1e-9f))
                    : kFitMax;
      cap = fminf(cap, per);
    }
    if (!any) cap = 0.0f;
    cap = fminf(fmaxf(cap, 0.0f), kFitMax);
    cap = fminf(cap, slots);
    const int c = static_cast<int>(cap);  // in [0, 2^30]: exact
    if (c) atomicAdd(cfit + static_cast<int64_t>(seg) * U + u, c);
  }
}

__global__ void __launch_bounds__(256) block_fit_kernel(
    const int32_t* cfit, const int32_t* cnt, int B, int U, uint8_t* whole,
    float* score) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int32_t* row = cfit + static_cast<int64_t>(b) * U;
  bool w = true;
  float sc = 0.0f;
  for (int u = 0; u < U; ++u) {
    const int32_t c = row[u];
    w = w && c >= cnt[u];
    sc = sc + static_cast<float>(c < cnt[u] ? c : cnt[u]);
  }
  whole[b] = w ? 1 : 0;
  score[b] = sc;
}

__global__ void __launch_bounds__(256) fabric_frag_kernel(
    const int32_t* cfit, const uint8_t* whole, const int32_t* cnt, int B,
    int U, float* frag) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float need = 0.0f;
  for (int u = 0; u < U; ++u) need = need + static_cast<float>(cnt[u]);
  need = fmaxf(need, 1.0f);
  const int32_t* row = cfit + static_cast<int64_t>(b) * U;
  float partial = 0.0f;
  for (int u = 0; u < U; ++u) {
    partial = partial + fminf(static_cast<float>(row[u]),
                              static_cast<float>(cnt[u]));
  }
  frag[b] = whole[b] ? 0.0f : partial / need;
}

}  // namespace

// `cfit` is the zeroed [Bp + 1, U] int32 buffer (row Bp the trash row);
// `whole` / `score` are [Bp].
extern "C" int vtt_gang_block_fit(const void* idle, const void* ready,
                                  const void* ntasks, const void* max_tasks,
                                  const void* block_id, const void* req,
                                  const void* cnt, const void* eps, int N,
                                  int U, int R, int Bp, void* cfit,
                                  void* whole, void* score, void* stream) {
  if (R > vtt::kMaxR) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  if (N > 0) {
    node_cap_kernel<<<(N + threads - 1) / threads, threads, 0, st>>>(
        static_cast<const float*>(idle), static_cast<const uint8_t*>(ready),
        static_cast<const int32_t*>(ntasks),
        static_cast<const int32_t*>(max_tasks),
        static_cast<const int32_t*>(block_id),
        static_cast<const float*>(req), static_cast<const float*>(eps), N, U,
        R, Bp, static_cast<int32_t*>(cfit));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (Bp > 0) {
    block_fit_kernel<<<(Bp + threads - 1) / threads, threads, 0, st>>>(
        static_cast<const int32_t*>(cfit), static_cast<const int32_t*>(cnt),
        Bp, U, static_cast<uint8_t*>(whole), static_cast<float*>(score));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vtt_fabric_frag(const void* cfit, const void* whole,
                               const void* cnt, int B, int U, void* frag,
                               void* stream) {
  if (B <= 0) return 0;
  const int threads = 256;
  fabric_frag_kernel<<<(B + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cfit), static_cast<const uint8_t*>(whole),
      static_cast<const int32_t*>(cnt), B, U, static_cast<float*>(frag));
  return static_cast<int>(cudaGetLastError());
}
