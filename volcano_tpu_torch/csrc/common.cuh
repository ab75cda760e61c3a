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

// ops/resreq.py less_equal for slot s: l <= r within eps[s] (a scalar slot
// also when l is at most eps[s]).  eps and scalar_slot are read only when
// l < r fails, so a slot that fits waits on no load of them.
__device__ __forceinline__ bool slot_le(float l, float r, const float* eps,
                                        const uint8_t* scalar_slot, int s) {
  return (l < r) || (fabsf(l - r) < eps[s]) ||
         (scalar_slot[s] && (l <= eps[s]));
}

// ops/resreq.py less_equal over R slots.
__device__ __forceinline__ bool less_equal(const float* l, const float* r,
                                           const float* eps,
                                           const uint8_t* scalar_slot,
                                           int R) {
  for (int s = 0; s < R; ++s) {
    if (!slot_le(l[s], r[s], eps, scalar_slot, s)) return false;
  }
  return true;
}

// FutureIdle of one slot: ((idle + releasing) - pipelined) - pip_extra,
// each operation rounded on its own, left to right; without `has_rel` the
// plain idle, without `has_pxe` no pip_extra term.
__device__ __forceinline__ float future_slot(float idle, float rel,
                                             float pip, float pxe,
                                             bool has_rel, bool has_pxe) {
  float v = idle;
  if (has_rel) {
    v = v + rel;
    v = v - pip;
    if (has_pxe) v = v - pxe;
  }
  return v;
}

// FutureIdle of node n (ops/wave.py:609, :1207, :1316, :1661).  `rel`
// null: no releasing capacity, the plain idle (the JAX solve's
// has_future=False branch); `pxe` null: no in-solve pipelined charge (the
// solve-start planes of the shortlist passes).  `rel`, `pip` and `pxe`
// are [N, R] planes.
__device__ __forceinline__ void future_idle(const float* idle,
                                            const float* rel,
                                            const float* pip,
                                            const float* pxe, int64_t n,
                                            int R, float* out) {
  const int64_t o = n * R;
  for (int s = 0; s < R; ++s) {
    out[s] = future_slot(idle[o + s], rel ? rel[o + s] : 0.0f,
                         rel ? pip[o + s] : 0.0f,
                         rel && pxe ? pxe[o + s] : 0.0f, rel != nullptr,
                         pxe != nullptr);
  }
}

// ops/scoring.py node_score: binpack + least-requested + most-requested +
// balanced, used = allocatable - idle, over R slots of `req`, `alloc` and
// `idle`: [R] planes, or register arrays of kR >= R floats.  Sums over
// slots run left to right.  kR > 0 unrolls the slot loops, so that such
// arrays stay in registers; kR = 0 loops to R.
template <int kR, class P>
__device__ __forceinline__ float node_score_at(const P& req, const P& alloc,
                                               const P& idle,
                                               const float* bres, int R,
                                               const Weights& w) {
  // binpack.go:200-260
  float score = 0.0f;
  float wsum = 0.0f;
#pragma unroll
  for (int s = 0; s < (kR > 0 ? kR : R); ++s) {
    if (s >= R) break;
    const float b = bres[s];
    const float uf = (alloc[s] - idle[s]) + req[s];
    const bool valid = (req[s] > 0.0f) && (alloc[s] > 0.0f) && (b > 0.0f) &&
                       (uf <= alloc[s]);
    const float den = alloc[s] > 0.0f ? alloc[s] : 1.0f;
    const float per = valid ? (uf * b) / den : 0.0f;
    const float cnt = (req[s] > 0.0f && b > 0.0f) ? b : 0.0f;
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
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float requested = (alloc[s] - idle[s]) + req[s];
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

// node_score over [R] planes.
__device__ __forceinline__ float node_score(const float* req,
                                            const float* alloc,
                                            const float* idle,
                                            const float* bres, int R,
                                            const Weights& w) {
  return node_score_at<0>(req, alloc, idle, bres, R, w);
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

// Selection keys: (score descending, position ascending), the tie-break
// of jax.lax.top_k and of a stable descending sort.  `score_ord` maps a
// score to 32 bits that order as the scores do (-0.0 ranks as +0.0);
// `pos_key` joins them with the position into a key unique per position.
__device__ __forceinline__ uint32_t score_ord(float score) {
  if (score == 0.0f) score = 0.0f;
  const uint32_t bits = __float_as_uint(score);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ uint64_t pos_key(uint32_t ord, uint32_t pos) {
  return (static_cast<uint64_t>(ord) << 32) |
         static_cast<uint64_t>(0xFFFFFFFFu - pos);
}

__device__ __forceinline__ uint64_t make_key(float score, uint32_t pos) {
  return pos_key(score_ord(score), pos);
}

constexpr unsigned kFullMask = 0xFFFFFFFFu;

// The register stages of a bitonic sort: a warp holds a 64-key chunk,
// lane l its positions l (x0) and l + 32 (x1).  `desc0` / `desc1` say
// whether the k-block of each position sorts descending.  Stage j = 32
// compares the lane's own two keys; stages j = 16 .. 1 trade with the
// lane j apart.  The lower position of a pair keeps the larger key in a
// descending k-block.
template <int kJ>
__device__ __forceinline__ void chunk_stages(uint64_t& x0, uint64_t& x1,
                                             bool desc0, bool desc1,
                                             int lane) {
#pragma unroll
  for (int j = kJ; j > 0; j >>= 1) {
    if (j == 32) {
      if ((x0 < x1) == desc0) {
        const uint64_t t = x0;
        x0 = x1;
        x1 = t;
      }
    } else {
      const bool low = (lane & j) == 0;
      const uint64_t y0 = __shfl_xor_sync(kFullMask, x0, j);
      const uint64_t y1 = __shfl_xor_sync(kFullMask, x1, j);
      if ((x0 < y0) == (low == desc0)) x0 = y0;
      if ((x1 < y1) == (low == desc1)) x1 = y1;
    }
  }
}

// The register stages of k-block size kK (<= 64) for the chunk whose
// lane holds positions p and p + 32.
template <int kK>
__device__ __forceinline__ void chunk_block(uint64_t& x0, uint64_t& x1,
                                            int p, int lane) {
  chunk_stages<kK / 2>(x0, x1, (p & kK) == 0, ((p + 32) & kK) == 0, lane);
}

// Sorts each of the `nseg` rows keys[g * P, (g + 1) * P) descending with
// the whole block (P a power of two >= 64, blockDim.x a multiple of 32;
// the caller has synchronised after writing the keys).  A bitonic
// network: the stages that pair keys 64 or more apart run in shared
// memory, one block barrier each for all rows; the stages under 64 apart
// run in registers and warp shuffles (`chunk_stages`), so rows of 1,024
// keys take 15 block barriers where a plain bitonic sort takes 55.
__device__ inline void block_sort_desc(uint64_t* keys, int P, int nseg = 1) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int chunks = nseg * (P / 64);
  // k = 2 .. 64: every stage inside a chunk.
  for (int c = threadIdx.x >> 5; c < chunks; c += nwarps) {
    const int p0 = (64 * c) & (P - 1);
    uint64_t x0 = keys[64 * c + lane];
    uint64_t x1 = keys[64 * c + 32 + lane];
    chunk_block<2>(x0, x1, p0 + lane, lane);
    chunk_block<4>(x0, x1, p0 + lane, lane);
    chunk_block<8>(x0, x1, p0 + lane, lane);
    chunk_block<16>(x0, x1, p0 + lane, lane);
    chunk_block<32>(x0, x1, p0 + lane, lane);
    chunk_block<64>(x0, x1, p0 + lane, lane);
    keys[64 * c + lane] = x0;
    keys[64 * c + 32 + lane] = x1;
  }
  __syncthreads();
  for (int k = 128; k <= P; k <<= 1) {
    for (int j = k >> 1; j >= 64; j >>= 1) {
      for (int i = threadIdx.x; i < nseg * (P / 2); i += blockDim.x) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const uint64_t x = keys[lo];
        const uint64_t y = keys[hi];
        if ((x < y) == ((lo & (P - 1) & k) == 0)) {
          keys[lo] = y;
          keys[hi] = x;
        }
      }
      __syncthreads();
    }
    for (int c = threadIdx.x >> 5; c < chunks; c += nwarps) {
      // k >= 64: one direction for the whole chunk.
      const bool desc = (((64 * c) & (P - 1)) & k) == 0;
      uint64_t x0 = keys[64 * c + lane];
      uint64_t x1 = keys[64 * c + 32 + lane];
      chunk_stages<32>(x0, x1, desc, desc, lane);
      keys[64 * c + lane] = x0;
      keys[64 * c + 32 + lane] = x1;
    }
    __syncthreads();
  }
}

// Shared memory of `block_radix_select`.
struct RadixSmem {
  int hist[256];
  int warp[8];
  int pick[3];
};

// A threshold key T with exactly k of the L distinct keys key_at(0 ..
// L - 1) at or above it (1 <= k <= L), each a pos_key of a position
// below `pos_limit` (or the key 0, which never reaches the k-th place):
// an 8-bit radix select, most significant byte first, over the whole
// block (blockDim.x >= 256, a multiple of 32; the caller has synchronised
// after writing what key_at reads).  Each pass builds a histogram of the
// next byte of the keys under the prefix found so far and scans the 256
// bins in parallel (warp shuffles, then the eight warp totals).  Warp w
// reads the w-th contiguous segment of the keys, lane l every 32nd key of
// it from l, and counts runs of one bin in a register, adding a run to
// the shared histogram when its bin changes: keys that arrive sorted, or
// in long runs of equal leading bytes (a row of identical nodes), cost a
// few shared atomics a lane, not one a key on one hot bin.  A position
// byte that no position below pos_limit sets is all ones in every key
// under the prefix: its pass is skipped.  The select stops as soon as the
// k-th key's bucket is taken whole: the keys >= the prefix (its lower
// bytes zero) are then exactly the k largest.  Every thread returns the
// same T.
template <typename KeyAt>
__device__ uint64_t block_radix_select(KeyAt key_at, int L, int k,
                                       int pos_limit, RadixSmem& sm) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int seg = ((L + nwarps - 1) / nwarps + 31) & ~31;
  const int lo = warp * seg;
  const int hi = min(L, lo + seg);
  uint64_t prefix = 0;
  uint64_t mask = 0;
  int krem = k;
  for (int shift = 56; shift >= 0; shift -= 8) {
    if (shift < 32 && ((static_cast<uint32_t>(pos_limit) - 1u) >> shift) == 0) {
      prefix |= static_cast<uint64_t>(0xFF) << shift;
      mask |= static_cast<uint64_t>(0xFF) << shift;
      continue;
    }
    for (int i = tid; i < 256; i += blockDim.x) sm.hist[i] = 0;
    __syncthreads();
    int cur = -1;
    int run = 0;
    for (int i = lo + lane; i < hi; i += 32) {
      const uint64_t key = key_at(i);
      const int bin = (key & mask) == prefix
                          ? static_cast<int>((key >> shift) & 0xFF)
                          : -1;
      if (bin != cur) {
        if (cur >= 0) atomicAdd(&sm.hist[cur], run);
        cur = bin;
        run = 0;
      }
      ++run;
    }
    if (cur >= 0) atomicAdd(&sm.hist[cur], run);
    __syncthreads();
    // Thread t of the first 256 holds bin 255 - t: an inclusive scan over
    // the threads counts the keys at or above each digit.
    int h = 0;
    int x = 0;
    if (tid < 256) {
      h = sm.hist[255 - tid];
      x = h;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFullMask, x, off);
        if (lane >= off) x += y;
      }
      if (lane == 31) sm.warp[warp] = x;
    }
    __syncthreads();
    if (tid < 256) {
      int incl = x;
      for (int w = 0; w < warp; ++w) incl += sm.warp[w];
      const int excl = incl - h;
      if (excl < krem && krem <= incl) {
        sm.pick[0] = 255 - tid;
        sm.pick[1] = krem - excl;
        sm.pick[2] = h;
      }
    }
    __syncthreads();
    prefix |= static_cast<uint64_t>(sm.pick[0]) << shift;
    mask |= static_cast<uint64_t>(0xFF) << shift;
    krem = sm.pick[1];
    if (sm.pick[2] == krem) break;
  }
  return prefix;
}

}  // namespace vtt
