// Shared device helpers of the wave-solve kernels.
//
// Built with `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false`
// (no --use_fast_math): every float operation below rounds on its own, in
// the order the JAX package's ops/scoring.py and ops/resreq.py use, so a
// score computed here equals the plain PyTorch version bit for bit.  A
// one-ulp difference would flip a tie in a node ranking, and a flipped tie
// changes an assignment.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace vtt {

constexpr int kMaxR = 16;           // resource slots a kernel handles
constexpr float kNeg = -3.0e38f;    // ops/allocate.py NEG
constexpr float kBig = 1.0e9f;      // ops/wave.py BIG (capacity clip)

struct Weights {
  float binpack;
  float least;
  float most;
  float balanced;
};

// ops/resreq.py less_equal over R slots.
__device__ __forceinline__ bool less_equal(const float* l, const float* r,
                                           const float* eps,
                                           const uint8_t* scalar_slot,
                                           int R) {
  for (int s = 0; s < R; ++s) {
    const float a = l[s];
    const float b = r[s];
    const bool ok = (a < b) || (fabsf(a - b) < eps[s]) ||
                    (scalar_slot[s] && (a <= eps[s]));
    if (!ok) return false;
  }
  return true;
}

// FutureIdle of node n (ops/wave.py:609, :1207, :1316, :1661): ((idle +
// releasing) - pipelined) - pip_extra, each operation rounded on its own,
// left to right.  `rel` null: no releasing capacity, the plain idle (the
// JAX solve's has_future=False branch); `pxe` null: no in-solve pipelined
// charge (the solve-start planes of the shortlist passes).  `rel`, `pip`
// and `pxe` are [N, R] planes.
__device__ __forceinline__ void future_idle(const float* idle,
                                            const float* rel,
                                            const float* pip,
                                            const float* pxe, int64_t n,
                                            int R, float* out) {
  const int64_t o = n * R;
  for (int s = 0; s < R; ++s) {
    float v = idle[o + s];
    if (rel) {
      v = v + rel[o + s];
      v = v - pip[o + s];
      if (pxe) v = v - pxe[o + s];
    }
    out[s] = v;
  }
}

// ops/scoring.py node_score: binpack + least-requested + most-requested +
// balanced, used = allocatable - idle.  Sums over slots run left to right.
__device__ __forceinline__ float node_score(const float* req,
                                            const float* alloc,
                                            const float* idle,
                                            const float* bres, int R,
                                            const Weights& w) {
  float used[kMaxR];
  for (int s = 0; s < R; ++s) used[s] = alloc[s] - idle[s];
  // binpack.go:200-260
  float score = 0.0f;
  float wsum = 0.0f;
  for (int s = 0; s < R; ++s) {
    const float uf = used[s] + req[s];
    const bool valid = (req[s] > 0.0f) && (alloc[s] > 0.0f) &&
                       (bres[s] > 0.0f) && (uf <= alloc[s]);
    const float den = alloc[s] > 0.0f ? alloc[s] : 1.0f;
    const float per = valid ? (uf * bres[s]) / den : 0.0f;
    const float cnt = (req[s] > 0.0f && bres[s] > 0.0f) ? bres[s] : 0.0f;
    if (s == 0) {
      score = per;
      wsum = cnt;
    } else {
      score = score + per;
      wsum = wsum + cnt;
    }
  }
  if (wsum > 0.0f) score = score / wsum;
  const float binpack = (score * 10.0f) * w.binpack;
  // least / most requested and balanced read cpu + memory only.
  float lr[2], mr[2], fr[2];
  for (int s = 0; s < 2; ++s) {
    const float requested = used[s] + req[s];
    const float cap = alloc[s];
    const float den = cap > 0.0f ? cap : 1.0f;
    const float spare = cap - requested;
    const float clipped = spare > 0.0f ? spare : 0.0f;
    lr[s] = cap > 0.0f ? (clipped * 10.0f) / den : 0.0f;
    mr[s] = (cap > 0.0f && requested <= cap) ? (requested * 10.0f) / den
                                             : 0.0f;
    fr[s] = cap > 0.0f ? requested / den : 1.0f;
  }
  const float least = ((lr[0] + lr[1]) / 2.0f) * w.least;
  const float most = ((mr[0] + mr[1]) / 2.0f) * w.most;
  const float diff = fabsf(fr[0] - fr[1]);
  const bool over = (fr[0] > 1.0f) || (fr[1] > 1.0f);
  const float bal = (over ? 0.0f : (1.0f - diff) * 10.0f) * w.balanced;
  float s = binpack + least;
  s = s + most;
  s = s + bal;
  return s;
}

// Host ports: does the profile's port word row `asked` share a bit with
// node n's used ports (the allocated plane `used`, OR the pipelined plane
// `used_pip` when given)?  [N, PW] planes of uint32 words.
__device__ __forceinline__ bool ports_clash(const uint32_t* asked,
                                            const uint32_t* used,
                                            const uint32_t* used_pip,
                                            int64_t n, int PW) {
  for (int w = 0; w < PW; ++w) {
    uint32_t u = used[n * PW + w];
    if (used_pip) u |= used_pip[n * PW + w];
    if (asked[w] & u) return true;
  }
  return false;
}

// Is every bit of the `words`-word bitset `row` set in `table`?
__device__ __forceinline__ bool subset(const uint32_t* row,
                                       const uint32_t* table, int words) {
  for (int w = 0; w < words; ++w) {
    if (row[w] & ~table[w]) return false;
  }
  return true;
}

// The static verdict and the preferred-affinity sum of one (task or
// profile row, node or node class) pair.  The row's bitsets: selector
// `sel` [LW], node-affinity alternatives `aff` [A, LW] of which the first
// `nterms` are real (none asked when 0), tolerations `tol` [TW], preferred
// terms `pref` [AP, LW] with weights `pref_w` [AP]; the node's `label`
// [LW] and `taint` [TW] (null: no taint test).  The verdict is ready AND
// selector AND some alternative AND no untolerated taint; the sum is
// sum_AP(match * pref_w) added left to right, as the JAX sum over AP.
struct StaticPair {
  bool ok;
  float pref;
};

__device__ __forceinline__ StaticPair static_pair(
    bool ready, const uint32_t* label, const uint32_t* taint, int LW,
    int TW, const uint32_t* sel, const uint32_t* aff, int A, int nterms,
    const uint32_t* tol, const uint32_t* pref, const float* pref_w,
    int AP) {
  bool ok = ready && subset(sel, label, LW);
  if (ok && nterms != 0) {
    bool any = false;
    for (int a = 0; a < A && a < nterms; ++a) {
      if (subset(aff + static_cast<int64_t>(a) * LW, label, LW)) {
        any = true;
        break;
      }
    }
    ok = any;
  }
  if (taint) {
    for (int w = 0; ok && w < TW; ++w) {
      if (taint[w] & ~tol[w]) ok = false;
    }
  }
  float acc = 0.0f;
  for (int a = 0; a < AP; ++a) {
    const bool m = subset(pref + static_cast<int64_t>(a) * LW, label, LW);
    const float term = (m ? 1.0f : 0.0f) * pref_w[a];
    acc = a == 0 ? term : acc + term;
  }
  return StaticPair{ok, acc};
}

// Selection key:(score descending, position ascending), the tie-break of
// jax.lax.top_k and of a stable descending sort.  -0.0 ranks as +0.0.
__device__ __forceinline__ uint64_t make_key(float score, uint32_t pos) {
  if (score == 0.0f) score = 0.0f;
  const uint32_t bits = __float_as_uint(score);
  const uint32_t ord = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return (static_cast<uint64_t>(ord) << 32) |
         static_cast<uint64_t>(0xFFFFFFFFu - pos);
}

// The k-th largest of L distinct keys (1 <= k <= L), by an 8-bit radix
// select over the whole block.  `hist` is 256 ints of shared memory,
// `bcast` two ints of shared memory.  Every thread returns the same key;
// exactly k keys are >= it.
__device__ inline uint64_t block_select_kth(const uint64_t* keys, int L, int k,
                                     int* hist, int* bcast) {
  uint64_t prefix = 0;
  uint64_t mask = 0;
  int krem = k;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
      const uint64_t key = keys[i];
      if ((key & mask) == prefix) {
        atomicAdd(&hist[(key >> shift) & 0xFF], 1);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int above = 0;
      int digit = 0;
      for (int b = 255; b >= 0; --b) {
        if (above + hist[b] >= krem) {
          digit = b;
          break;
        }
        above += hist[b];
      }
      bcast[0] = digit;
      bcast[1] = krem - above;
    }
    __syncthreads();
    prefix |= static_cast<uint64_t>(bcast[0]) << shift;
    mask |= static_cast<uint64_t>(0xFF) << shift;
    krem = bcast[1];
    __syncthreads();
  }
  return prefix;
}

}  // namespace vtt
