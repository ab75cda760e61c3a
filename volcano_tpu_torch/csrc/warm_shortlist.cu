// warm_shortlist: per-block candidate ranking + winner merge, the
// shortlist machinery of the device-incremental lane.
//
// Replaces the JAX package's jitted `_warm_shortlist`
// (volcano_tpu/ops/wave.py:721) and, with every block dirty, the
// `with_cand` form of `_coarse_shortlist` (wave.py:547, per-block top_k at
// :677 and `_merge_block_cands` at :449).  One pair of kernels serves
// both: the cold pass is the warm pass with every block dirty and no
// previous candidates, so the two agree by construction.
//
// `block_rank_kernel`: one block per (node block, up to four profile rows in
// a large launch; kRankRows).  A clean node block copies its previous
// candidates; a dirty one reads each of its nlb node rows once and scores it
// for each of its profile rows (static class verdict and score, init-request
// fit against idle, pod slots, node_score -- the same arithmetic as
// coarse_shortlist's main pass; with releasing capacity the fit reads fi0 =
// (idle + releasing) - pipelined, wave.py:763-768; with host ports a node
// whose solve-start ports clash is infeasible, wave.py:790-793; with
// inter-pod terms on nonzero counts aff_live's planes for the block's rows
// mask the row and add the soft score after the static one, wave.py:800-812),
// builds the unique 64-bit keys (score descending, local row ascending: the
// jax.lax.top_k tie-break), sorts each row's keys in shared memory with
// common.cuh's block_sort_desc (512 threads, the rows between the same
// barriers; the stages under 64 apart in registers and warp shuffles, so
// 1,024 keys take 15 block barriers where a plain bitonic sort takes 55) and
// writes each row's top klb in rank order.  Masked (infeasible) rows carry
// NEG (unscored) and rank like any score, so a block with fewer than klb
// feasible rows fills with NEG at its lowest rows, as top_k does; a block
// whose keys all share one score (padding, or equal nodes) is in key order
// already and skips the sort.
//
// `merge_kernel`: one block per profile.  The B*klb candidates' scores as
// 32 ordered bits in shared memory (13,104 x 4 bytes at the north-star
// geometry), keys (score descending, position ascending -- within a score
// class position order is ascending node id, the `_merge_block_cands`
// argument) formed from them on the fly; common.cuh's block_radix_select
// finds the S-th key (run-length histograms, a parallel scan of the
// 256 bins, an early stop), and only the S winners' ids are sorted
// ascending.
//
// Bound: at the north-star shape (U = 64 profile rows, N = 16384 padded
// nodes, B = 16 blocks of 1024, klb = S = 819) a full pass reads the node
// planes and writes 6.7 MB of candidates; a warm pass with one dirty block
// re-ranks 1/16 of the nodes and copies the rest -- bytes-bound at a few
// microseconds.  The per-block sorts' barriers and the merge's radix
// passes dominate.
#include <algorithm>

#include "common.cuh"

using vtt::Weights;

namespace {

constexpr int kThreads = 512;
// The merge keeps a row's B * klb ordered scores (4 bytes each) in shared
// memory beside the S winners' keys up to this size; past it the scores
// go to the global scratch the wrapper passes (ops/kernels.py
// BLOCK_MERGE_SMEM mirrors it).
constexpr int kMergeSmem = 200 * 1024;
// The ranking takes up to kRankRows profile rows a block while their keys
// and scores fit kRankSmem (two blocks an SM) -- when the launch ranks at
// least kRankGroupWork (row, dirty block) pairs.  A smaller launch (a warm
// pass, the 64 rows of a north-star solve) keeps one row a block: there
// the blocks' latency, not the card's throughput, sets the time.  On an
// H100 (tools/port_ab.py --phase shortlist) four rows a block take 0.82x
// one row's time on config 5's cold launch (65,536 pairs), 1.08x on the
// north-star launch (1,024) and 1.19x on a one-block warm pass (64).
constexpr int kRankRows = 4;
constexpr size_t kRankSmem = 96 * 1024;
constexpr int64_t kRankGroupWork = 4096;

// Block (b, y): node block b for the profile rows u = y * G + g, g < G.
// Each node's planes are read once for the G rows (the later reads hit
// L1); the G rows' keys sort together.  Dynamic shared memory: [G, npow2]
// keys, then [G, nlb] scores.
template <bool kCold>
__global__ void __launch_bounds__(kThreads, 2) block_rank_kernel(
    const float* req, const float* init_req, int R, const uint8_t* stat_ok,
    const float* stat_score, int C, const int32_t* cls_id,
    const float* idle, const float* rel, const float* pip,
    const float* alloc, const int32_t* ntasks,
    const int32_t* max_tasks, const float* eps, const uint8_t* scalar_slot,
    const float* bres, Weights w, const int32_t* db, int ndb, int U, int G,
    int B, int nlb, int klb, int npow2, const float* old_s,
    const int32_t* old_i, float* cand_s, int32_t* cand_i,
    const uint32_t* ports, int PW, const uint32_t* nports,
    const uint8_t* aff_ok, const float* aff_soft, int Ma) {
  extern __shared__ uint64_t smem[];
  uint64_t* keys = smem;
  float* scores = reinterpret_cast<float*>(smem + G * npow2);
  const int b = blockIdx.x;
  const int u0 = blockIdx.y * G;
  const int rows = min(G, U - u0);
  bool dirty = kCold;
  // The block's position in the dirty list: its rows' offset in the
  // affinity planes ([U, Ma], Ma = ndb * nlb; every block when cold).
  int pos = b;
  if (!kCold) {
    for (int i = 0; i < ndb; ++i) {
      if (!dirty && db[i] == b) {
        dirty = true;
        pos = i;
      }
    }
  }
  if (!dirty) {
    for (int g = 0; g < rows; ++g) {
      const int64_t cbase = (static_cast<int64_t>(u0 + g) * B + b) * klb;
      for (int r = threadIdx.x; r < klb; r += blockDim.x) {
        cand_s[cbase + r] = old_s[cbase + r];
        cand_i[cbase + r] = old_i[cbase + r];
      }
    }
    return;
  }
  for (int l = threadIdx.x; l < npow2; l += blockDim.x) {
    if (l >= nlb) {
      for (int g = 0; g < G; ++g) keys[g * npow2 + l] = 0;  // below every key
      continue;
    }
    const int n = b * nlb + l;
    const int c = cls_id[n];
    const float* id = idle + static_cast<int64_t>(n) * R;
    const float* al = alloc + static_cast<int64_t>(n) * R;
    float fi0[vtt::kMaxR];
    vtt::future_idle(idle, rel, pip, nullptr, n, R, fi0);
    const bool pods_ok = max_tasks[n] <= 0 || ntasks[n] < max_tasks[n];
    for (int g = 0; g < G; ++g) {
      if (g >= rows) {
        keys[g * npow2 + l] = 0;
        continue;
      }
      const int u = u0 + g;
      const int64_t ai =
          static_cast<int64_t>(u) * Ma + static_cast<int64_t>(pos) * nlb + l;
      const bool feas =
          stat_ok[static_cast<int64_t>(u) * C + c] != 0 &&
          vtt::less_equal(init_req + static_cast<int64_t>(u) * R, fi0, eps,
                          scalar_slot, R) &&
          pods_ok &&
          !(ports && vtt::ports_clash(ports + static_cast<int64_t>(u) * PW,
                                      nports, nullptr, n, PW)) &&
          !(aff_ok && !aff_ok[ai]);
      // An infeasible row's key is NEG whatever it scores: no score.
      float masked = vtt::kNeg;
      if (feas) {
        masked = vtt::node_score(req + static_cast<int64_t>(u) * R, al, id,
                                 bres, R, w) +
                 stat_score[static_cast<int64_t>(u) * C + c];
        if (aff_soft) masked = masked + aff_soft[ai];
      }
      scores[g * nlb + l] = masked;
      keys[g * npow2 + l] = vtt::make_key(masked, static_cast<uint32_t>(l));
    }
  }
  __syncthreads();
  // Rows whose nlb keys share one score (a block of padding, or of equal
  // nodes) are in key order already: local row ascending, then padding.
  bool same = true;
  for (int g = 0; g < rows; ++g) {
    const uint64_t top = keys[g * npow2] >> 32;
    for (int l = threadIdx.x; l < nlb; l += blockDim.x) {
      same = same && (keys[g * npow2 + l] >> 32) == top;
    }
  }
  if (!__syncthreads_and(same)) vtt::block_sort_desc(keys, npow2, G);
  for (int g = 0; g < rows; ++g) {
    const int64_t cbase = (static_cast<int64_t>(u0 + g) * B + b) * klb;
    for (int r = threadIdx.x; r < klb; r += blockDim.x) {
      const uint32_t l =
          0xFFFFFFFFu - static_cast<uint32_t>(keys[g * npow2 + r]);
      cand_s[cbase + r] = scores[g * nlb + l];
      cand_i[cbase + r] = b * nlb + static_cast<int32_t>(l);
    }
  }
}

// Block u: profile row u's S winners among its L = B * klb candidates.
// Dynamic shared memory: [spow2] winner keys, then the row's [L] ordered
// scores when `in_smem` (else `ord_scratch` [U, L]).
template <bool kCold>
__global__ void __launch_bounds__(kThreads, 2) merge_kernel(
    const float* cand_s, const int32_t* cand_i, int L, int S, int spow2,
    uint32_t* ord_scratch, int in_smem, int32_t* out) {
  extern __shared__ uint64_t s_dyn[];
  __shared__ vtt::RadixSmem rs;
  __shared__ int n_sel;
  const int u = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const float* cs = cand_s + static_cast<int64_t>(u) * L;
  const int32_t* ci = cand_i + static_cast<int64_t>(u) * L;
  uint64_t* sel = s_dyn;
  uint32_t* ord = in_smem ? reinterpret_cast<uint32_t*>(s_dyn + spow2)
                          : ord_scratch + static_cast<int64_t>(u) * L;
  for (int p = threadIdx.x; p < L; p += blockDim.x) {
    ord[p] = vtt::score_ord(cs[p]);
  }
  if (threadIdx.x == 0) n_sel = 0;
  __syncthreads();
  auto key_at = [ord](int p) {
    return vtt::pos_key(ord[p], static_cast<uint32_t>(p));
  };
  const uint64_t kth = vtt::block_radix_select(key_at, L, S, L, rs);
  // The winners' ids as keys that sort descending into ascending ids
  // (the padding key 0 sorts last), appended a warp at a time.
  for (int base = 0; base < L; base += blockDim.x) {
    const int p = base + threadIdx.x;
    const bool win = p < L && key_at(p) >= kth;
    const unsigned ballot = __ballot_sync(vtt::kFullMask, win);
    if (!ballot) continue;
    const int first = __ffs(ballot) - 1;
    int slot = 0;
    if (lane == first) slot = atomicAdd(&n_sel, __popc(ballot));
    slot = __shfl_sync(vtt::kFullMask, slot, first);
    if (win) {
      sel[slot + __popc(ballot & ((1u << lane) - 1u))] =
          0xFFFFFFFFull - static_cast<uint32_t>(ci[p]);
    }
  }
  for (int i = S + threadIdx.x; i < spow2; i += blockDim.x) sel[i] = 0;
  __syncthreads();
  vtt::block_sort_desc(sel, spow2);
  int32_t* row = out + static_cast<int64_t>(u) * S;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    row[i] = static_cast<int32_t>(0xFFFFFFFFu -
                                  static_cast<uint32_t>(sel[i]));
  }
}

// The power of two >= n, at least 64 (block_sort_desc's chunk).
int pow2_at_least(int n) {
  int p = 64;
  while (p < n) p <<= 1;
  return p;
}

size_t rank_smem(int nlb) {
  return static_cast<size_t>(pow2_at_least(nlb)) * sizeof(uint64_t) +
         static_cast<size_t>(nlb) * sizeof(float);
}

// The merge's winner keys; its row of ordered scores joins them when
// both fit kMergeSmem.
size_t merge_smem(int L, int S, int* in_smem) {
  const size_t sel = static_cast<size_t>(pow2_at_least(S)) * sizeof(uint64_t);
  const size_t row = static_cast<size_t>(L) * sizeof(uint32_t);
  *in_smem = sel + row <= static_cast<size_t>(kMergeSmem);
  return *in_smem ? sel + row : sel;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <bool kCold>
int launch(const float* req, const float* init_req, int U, int R,
           const uint8_t* stat_ok, const float* stat_score, int C,
           const int32_t* cls_id, const float* idle, const float* rel,
           const float* pip, const float* alloc,
           const int32_t* ntasks, const int32_t* max_tasks,
           const float* eps, const uint8_t* scalar_slot, const float* bres,
           Weights w, const int32_t* db, int ndb, int B, int nlb, int klb,
           int S, const float* old_s, const int32_t* old_i, float* cand_s,
           int32_t* cand_i, uint32_t* ord_scratch, int32_t* out,
           const uint32_t* ports, int PW, const uint32_t* nports,
           const uint8_t* aff_ok, const float* aff_soft, int Ma,
           cudaStream_t st) {
  // G profile rows a block, as many as fit kRankSmem (at most kRankRows).
  const size_t per_row = rank_smem(nlb);
  const int64_t work = static_cast<int64_t>(U) * (kCold ? B : ndb);
  const int G =
      work < kRankGroupWork
          ? 1
          : static_cast<int>(std::max<size_t>(
                1, std::min<size_t>(kRankRows, kRankSmem / per_row)));
  const size_t r_smem = G * per_row;
  cudaError_t err = allow_smem(block_rank_kernel<kCold>, r_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_rank_kernel<kCold><<<dim3(B, (U + G - 1) / G), kThreads, r_smem,
                             st>>>(
      req, init_req, R, stat_ok, stat_score, C, cls_id, idle, rel, pip,
      alloc, ntasks, max_tasks, eps, scalar_slot, bres, w, db, ndb, U, G, B,
      nlb, klb, pow2_at_least(nlb), old_s, old_i, cand_s, cand_i, ports, PW,
      nports, aff_ok, aff_soft, Ma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int L = B * klb;
  int in_smem = 0;
  const size_t m_smem = merge_smem(L, S, &in_smem);
  if (!in_smem && !ord_scratch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = allow_smem(merge_kernel<kCold>, m_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<kCold><<<U, kThreads, m_smem, st>>>(
      cand_s, cand_i, L, S, pow2_at_least(S), ord_scratch, in_smem, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory the launch needs at least (the wrapper refuses shapes
// past the card's 227 KB per block): the ranking's keys and scores, the
// merge's winner keys.
extern "C" int vtt_block_shortlist_smem(int nlb, int S) {
  const size_t a = rank_smem(nlb);
  const size_t b = static_cast<size_t>(pow2_at_least(S)) * sizeof(uint64_t);
  return static_cast<int>(a > b ? a : b);
}

// cold != 0: every block is dirty (db/old_* unused) -- the with_cand
// coarse pass.  cold == 0: the warm pass over the ndb dirty blocks db.
// `keys_scratch` [U, B * klb] uint32: the merge's ordered scores when
// they do not fit its shared memory (else unused, may be null).
extern "C" int vtt_block_shortlist(
    int cold, const void* req, const void* init_req, int U, int R,
    const void* stat_ok, const void* stat_score, int C, const void* cls_id,
    const void* idle, const void* rel, const void* pip, const void* alloc,
    const void* ntasks, const void* max_tasks, const void* eps,
    const void* scalar_slot, const void* bres, float bw, float lw, float mw,
    float balw, const void* db, int ndb, int B, int nlb, int klb, int S,
    const void* old_s, const void* old_i, void* cand_s, void* cand_i,
    void* keys_scratch, void* out, const void* ports, int PW,
    const void* nports, const void* aff_ok, const void* aff_soft, int Ma,
    void* stream) {
  Weights w{bw, lw, mw, balw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = cold ? launch<true> : launch<false>;
  return f(static_cast<const float*>(req),
           static_cast<const float*>(init_req), U, R,
           static_cast<const uint8_t*>(stat_ok),
           static_cast<const float*>(stat_score), C,
           static_cast<const int32_t*>(cls_id),
           static_cast<const float*>(idle), static_cast<const float*>(rel),
           static_cast<const float*>(pip), static_cast<const float*>(alloc),
           static_cast<const int32_t*>(ntasks),
           static_cast<const int32_t*>(max_tasks),
           static_cast<const float*>(eps),
           static_cast<const uint8_t*>(scalar_slot),
           static_cast<const float*>(bres), w,
           static_cast<const int32_t*>(db), ndb, B, nlb, klb, S,
           static_cast<const float*>(old_s),
           static_cast<const int32_t*>(old_i), static_cast<float*>(cand_s),
           static_cast<int32_t*>(cand_i),
           static_cast<uint32_t*>(keys_scratch), static_cast<int32_t*>(out),
           static_cast<const uint32_t*>(ports), PW,
           static_cast<const uint32_t*>(nports),
           static_cast<const uint8_t*>(aff_ok),
           static_cast<const float*>(aff_soft), Ma, st);
}
