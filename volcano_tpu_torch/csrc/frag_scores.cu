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
// Each float operation rounds on its own (-fmad=false, IEEE division,
// never a reciprocal multiply), and the idle-fraction sum runs left to
// right from 0, the order of the plain version and of XLA's CPU reduction.
//
// The work a node is a few divisions; what costs is latency: the loads,
// the chain of divisions and the launch.  So:
//
// - two lanes a node on CTAs of 256 threads (16,384 nodes: 128 CTAs, one
//   an SM): the even lane counts the idle plane and writes fit_now and
//   frag, the odd lane counts idle + evictable and writes fit_freed, so
//   each chain of divisions is one plane's and the two run side by side;
//   a lane's loads are issued first and are in flight while the CTA
//   stages the profiles;
// - each CTA stages the profile table once, 64 rows at a time, into
//   shared memory: per row the divisors max(req, 1e-9) and a mask of the
//   requested slots, and a bit per row that requests any slot.  A row
//   that requests nothing (the all-zero padding rows) gives a count of 0,
//   which cannot raise a max that starts at 0: it is skipped, exactly.
//   Live rows are visited in row order through the bits.
//
// Measured against one thread a node with both chains interleaved in one
// loop (CTAs of 128 and of 256 threads) at the [rebalance] shape, this
// was the fastest of the three (PERF.md, section 6).
//
// The min over slots and the max over rows are taken in another order
// than the plain version's (a row's inert 2^30 first): fminf / fmaxf are
// order-free on these values (a NaN is dropped whatever its place), and
// only the int32 casts of the results leave the kernel.
//
// Bound: bytes -- it reads three [N, R] f32 planes and the [N] ready flags
// and writes three [N] planes: ~44 bytes a node at R = 2 (10,000 nodes:
// ~0.44 MB), against ~(2U + 1) R divisions a node.  The outputs are the
// rows of one [3, N] int32 buffer, fetched by one copy.
#include "common.cuh"

namespace {

constexpr float kFitInert = 1073741824.0f;  // 2^30, a slot not requested
constexpr int kThreads = 256;
constexpr int kRows = 64;  // profile rows staged at a time

template <int kR>
__global__ void __launch_bounds__(kThreads) frag_scores_kernel(
    const float* idle, const float* alloc, const uint8_t* ready,
    const float* ev, const float* req, const float* eps, int N, int U,
    int R, float* frag, int32_t* fit_now, int32_t* fit_freed) {
  __shared__ float sdiv[kRows * kR];  // max(req, 1e-9) of a staged row
  __shared__ uint32_t smask[kRows];   // its requested slots, bit s
  __shared__ uint32_t slive[kRows / 32];  // rows requesting any slot
  // Two lanes a node: the even one the idle count and frag, the odd one
  // the count after draining.
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int n = g >> 1;
  const bool freed = (g & 1) != 0;
  const bool ok = n < N;
  const int64_t o = static_cast<int64_t>(ok ? n : 0) * R;
  // The lane's loads (and eps), in flight during the staging.
  float id[kR], x[kR], al[kR], ep[kR];
#pragma unroll
  for (int s = 0; s < kR; ++s) {
    if (s < R) {
      ep[s] = eps[s];
      id[s] = ok ? idle[o + s] : 0.0f;
      const float e = ok && freed ? ev[o + s] : 0.0f;
      al[s] = ok && !freed ? alloc[o + s] : 0.0f;
      x[s] = freed ? (id[s] + e) + ep[s] : id[s] + ep[s];
    }
  }
  const bool rdy = ok && !freed && ready[n];
  const uint32_t all = (1u << R) - 1u;  // R <= 16
  float b = 0.0f;
  for (int u0 = 0; u0 < U; u0 += kRows) {
    if (u0 > 0) __syncthreads();  // the last rows are read
    if (threadIdx.x < kRows) {  // warps 0 and 1: one row a thread
      const int u = u0 + threadIdx.x;
      uint32_t mask = 0;
      if (u < U) {
        const float* rq = req + static_cast<int64_t>(u) * R;
#pragma unroll
        for (int s = 0; s < kR; ++s) {
          if (s < R) {
            const float r = rq[s];
            mask |= (r > ep[s] ? 1u : 0u) << s;
            sdiv[threadIdx.x * kR + s] = fmaxf(r, 1e-9f);
          }
        }
      }
      smask[threadIdx.x] = mask;
      const unsigned live = __ballot_sync(0xffffffffu, mask != 0);
      if ((threadIdx.x & 31) == 0) slive[threadIdx.x >> 5] = live;
    }
    __syncthreads();
    uint64_t live = static_cast<uint64_t>(slive[0]) |
                    (static_cast<uint64_t>(slive[1]) << 32);
    while (live != 0) {
      const int j = __ffsll(static_cast<long long>(live)) - 1;
      live &= live - 1;
      const uint32_t m = smask[j];
      const float* d = sdiv + j * kR;
      // A slot not requested counts 2^30; with all slots requested the
      // count may exceed 2^30 (and 2^31).
      float c = m == all ? INFINITY : kFitInert;
#pragma unroll
      for (int s = 0; s < kR; ++s) {
        if (s < R && ((m >> s) & 1u)) c = fminf(c, floorf(x[s] / d[s]));
      }
      b = fmaxf(b, fmaxf(c, 0.0f));
    }
  }
  if (!ok) return;
  // cvt.rzi.s32.f32: saturates at the int32 range, as XLA's convert does.
  const int cnt = __float2int_rz(b);
  if (freed) {
    fit_freed[n] = cnt;
    return;
  }
  fit_now[n] = cnt;
  float acc = 0.0f;
  int nprov = 0;
  bool has_idle = false;
#pragma unroll
  for (int s = 0; s < kR; ++s) {
    if (s < R) {
      const bool prov = al[s] > ep[s];
      const float q = id[s] / fmaxf(al[s], 1e-9f);
      const float frac = prov ? fminf(fmaxf(q, 0.0f), 1.0f) : 0.0f;
      acc = acc + frac;
      nprov += prov ? 1 : 0;
      has_idle = has_idle || id[s] > ep[s];
    }
  }
  const float idle_frac = acc / static_cast<float>(nprov > 1 ? nprov : 1);
  frag[n] = (rdy && has_idle && cnt == 0) ? idle_frac : 0.0f;
}

template <int kR>
void launch_frag(int blocks, cudaStream_t st, const float* idle,
                 const float* alloc, const uint8_t* ready, const float* ev,
                 const float* req, const float* eps, int N, int U, int R,
                 float* frag, int32_t* fit_now, int32_t* fit_freed) {
  frag_scores_kernel<kR><<<blocks, kThreads, 0, st>>>(
      idle, alloc, ready, ev, req, eps, N, U, R, frag, fit_now, fit_freed);
}

}  // namespace

extern "C" int vtt_frag_scores(const void* idle, const void* alloc,
                               const void* ready, const void* ev,
                               const void* req, const void* eps, int N,
                               int U, int R, void* frag, void* fit_now,
                               void* fit_freed, void* stream) {
  if (N <= 0) return 0;
  if (R > vtt::kMaxR) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (2 * N + kThreads - 1) / kThreads;
  // Up to 4 slots: a node's planes in 4 registers each; more: room for 16.
  auto* launch = R <= 4 ? &launch_frag<4> : &launch_frag<vtt::kMaxR>;
  launch(blocks, static_cast<cudaStream_t>(stream),
         static_cast<const float*>(idle), static_cast<const float*>(alloc),
         static_cast<const uint8_t*>(ready), static_cast<const float*>(ev),
         static_cast<const float*>(req), static_cast<const float*>(eps), N,
         U, R, static_cast<float*>(frag), static_cast<int32_t*>(fit_now),
         static_cast<int32_t*>(fit_freed));
  return static_cast<int>(cudaGetLastError());
}
