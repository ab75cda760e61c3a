// frag_scores: the rebalance planner's per-node fragmentation planes.
//
// Replaces the JAX package's jitted `frag_scores`
// (volcano_tpu/ops/rebalance.py:61).  For one starved gang, given its
// [U, R] profile table (all-zero rows inert), per node n:
//
//   fit(plane)[n] = max over u of max(cnt[n, u], 0), cnt = min over the
//                   slots s of floor((plane[n, s] + eps[s]) / max(req[u, s],
//                   1e-9)) for a requested slot (req[u, s] > eps[s]) and
//                   2^30 for one not requested, 0 for a profile that
//                   requests nothing; cast to int32 as XLA does (saturating:
//                   the JAX function does not clip, so a plane of tens of
//                   GiB over a tiny request lands above 2^31 and becomes
//                   INT32_MAX, never an undefined C++ cast);
//   fit_now   = fit(idle), fit_freed = fit(idle + evictable);
//   frag[n]   = (sum over provisioned slots of clip(idle / max(alloc,
//               1e-9), 0, 1)) / max(#provisioned, 1), gated to nodes that
//               are ready, hold some idle and host no gang task now.
//
// Each float operation rounds on its own (-fmad=false, IEEE division),
// and the idle-fraction sum runs left to right from 0, the order of the
// plain version and of XLA's CPU reduction.
//
// One thread per node, looping over the U profiles and the R slots; the
// profile table is read by every thread (a broadcast from L1).
//
// Bound: bytes -- it reads three [N, R] f32 planes and the [N] ready flags
// and writes three [N] planes: ~44 bytes a node at R = 2 (10,000 nodes:
// ~0.44 MB), against ~(2U + 1) R divisions a node.
#include "common.cuh"

namespace {

constexpr float kFitInert = 1073741824.0f;  // 2^30, a slot not requested

// The fit count of one node's plane `p` ([R] in registers).
__device__ __forceinline__ int fit_count(const float* p, const float* req,
                                         const float* eps, int U, int R) {
  float best = 0.0f;
  for (int u = 0; u < U; ++u) {
    const float* rq = req + static_cast<int64_t>(u) * R;
    // Min over every slot, a slot not requested counting 2^30: with all
    // slots requested the count may exceed 2^30 (and 2^31).
    float cnt = INFINITY;
    bool any = false;
    for (int s = 0; s < R; ++s) {
      const bool requested = rq[s] > eps[s];
      any = any || requested;
      const float per =
          requested ? floorf((p[s] + eps[s]) / fmaxf(rq[s], 1e-9f))
                    : kFitInert;
      cnt = fminf(cnt, per);
    }
    if (!any) cnt = 0.0f;
    best = fmaxf(best, fmaxf(cnt, 0.0f));
  }
  // cvt.rzi.s32.f32: saturates at the int32 range, as XLA's convert does.
  return __float2int_rz(best);
}

__global__ void __launch_bounds__(256) frag_scores_kernel(
    const float* idle, const float* alloc, const uint8_t* ready,
    const float* ev, const float* req, const float* eps, int N, int U,
    int R, float* frag, int32_t* fit_now, int32_t* fit_freed) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int64_t o = static_cast<int64_t>(n) * R;
  float id[vtt::kMaxR];
  float fr[vtt::kMaxR];
  for (int s = 0; s < R; ++s) {
    id[s] = idle[o + s];
    fr[s] = id[s] + ev[o + s];
  }
  const int now = fit_count(id, req, eps, U, R);
  fit_now[n] = now;
  fit_freed[n] = fit_count(fr, req, eps, U, R);
  float acc = 0.0f;
  int nprov = 0;
  bool has_idle = false;
  for (int s = 0; s < R; ++s) {
    const float a = alloc[o + s];
    const bool prov = a > eps[s];
    const float q = id[s] / fmaxf(a, 1e-9f);
    const float frac = prov ? fminf(fmaxf(q, 0.0f), 1.0f) : 0.0f;
    acc = acc + frac;
    nprov += prov ? 1 : 0;
    has_idle = has_idle || id[s] > eps[s];
  }
  const float idle_frac = acc / static_cast<float>(nprov > 1 ? nprov : 1);
  frag[n] = (ready[n] && has_idle && now == 0) ? idle_frac : 0.0f;
}

}  // namespace

extern "C" int vtt_frag_scores(const void* idle, const void* alloc,
                               const void* ready, const void* ev,
                               const void* req, const void* eps, int N,
                               int U, int R, void* frag, void* fit_now,
                               void* fit_freed, void* stream) {
  if (N <= 0) return 0;
  if (R > vtt::kMaxR) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int blocks = (N + threads - 1) / threads;
  frag_scores_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(idle), static_cast<const float*>(alloc),
      static_cast<const uint8_t*>(ready), static_cast<const float*>(ev),
      static_cast<const float*>(req), static_cast<const float*>(eps), N, U,
      R, static_cast<float*>(frag), static_cast<int32_t*>(fit_now),
      static_cast<int32_t*>(fit_freed));
  return static_cast<int>(cudaGetLastError());
}
