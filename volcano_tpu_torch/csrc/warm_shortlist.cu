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
// `block_rank_kernel`: one block per (node block, profile).  A clean node
// block copies its previous candidates; a dirty one scores its nlb node
// rows (static class verdict and score, init-request fit against idle, pod
// slots, node_score -- the same arithmetic as coarse_shortlist's main
// pass; with releasing capacity the fit reads fi0 = (idle + releasing) -
// pipelined, wave.py:763-768; with host ports a node whose solve-start
// ports clash is infeasible, wave.py:790-793; with inter-pod terms on
// nonzero counts aff_live's planes for the block's rows mask the row and
// add the soft score after the static one, wave.py:800-812), builds the
// unique 64-bit keys (score
// descending, local row ascending: the jax.lax.top_k tie-break),
// bitonic-sorts them in shared
// memory and writes the top klb in rank order.  Masked (infeasible) rows
// carry NEG and rank like any score, so a block with fewer than klb
// feasible rows fills with NEG at its lowest rows, as top_k does.
//
// `merge_kernel`: one block per profile.  Keys over the B*klb candidate
// positions (score descending, position ascending -- within a score class
// position order is ascending node id, the `_merge_block_cands`
// argument), a radix select of the S-th key, the S winners' node ids
// compacted to shared memory and bitonic-sorted ascending.
//
// Bound: at the north-star shape (U = 64 profile rows, N = 16384 padded
// nodes, B = 16 blocks of 1024, klb = S = 819) a full pass reads the node
// planes and writes 6.7 MB of candidates; a warm pass with one dirty block
// re-ranks 1/16 of the nodes and copies the rest -- bytes-bound at a few
// microseconds.  The sorts (55 compare stages over 1024 keys per block)
// and the merge's 8 radix passes over 13,104 keys per profile dominate.
#include "common.cuh"

using vtt::Weights;

namespace {

template <bool kCold>
__global__ void __launch_bounds__(1024) block_rank_kernel(
    const float* req, const float* init_req, int R, const uint8_t* stat_ok,
    const float* stat_score, int C, const int32_t* cls_id,
    const float* idle, const float* rel, const float* pip,
    const float* alloc, const int32_t* ntasks,
    const int32_t* max_tasks, const float* eps, const uint8_t* scalar_slot,
    const float* bres, Weights w, const int32_t* db, int ndb, int B,
    int nlb, int klb, int npow2, const float* old_s, const int32_t* old_i,
    float* cand_s, int32_t* cand_i, const uint32_t* ports, int PW,
    const uint32_t* nports, const uint8_t* aff_ok, const float* aff_soft,
    int Ma) {
  extern __shared__ uint64_t smem[];
  uint64_t* keys = smem;                                  // [npow2]
  float* scores = reinterpret_cast<float*>(smem + npow2);  // [nlb]
  const int b = blockIdx.x;
  const int u = blockIdx.y;
  const int64_t cbase = (static_cast<int64_t>(u) * B + b) * klb;
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
    for (int r = threadIdx.x; r < klb; r += blockDim.x) {
      cand_s[cbase + r] = old_s[cbase + r];
      cand_i[cbase + r] = old_i[cbase + r];
    }
    return;
  }
  const float* rq = req + static_cast<int64_t>(u) * R;
  const float* irq = init_req + static_cast<int64_t>(u) * R;
  for (int l = threadIdx.x; l < npow2; l += blockDim.x) {
    if (l < nlb) {
      const int n = b * nlb + l;
      const int c = cls_id[n];
      const float* id = idle + static_cast<int64_t>(n) * R;
      const float* al = alloc + static_cast<int64_t>(n) * R;
      float fi0[vtt::kMaxR];
      vtt::future_idle(idle, rel, pip, nullptr, n, R, fi0);
      const bool pods_ok = max_tasks[n] <= 0 || ntasks[n] < max_tasks[n];
      const int64_t ai =
          static_cast<int64_t>(u) * Ma + static_cast<int64_t>(pos) * nlb + l;
      const bool feas =
          stat_ok[static_cast<int64_t>(u) * C + c] != 0 &&
          vtt::less_equal(irq, fi0, eps, scalar_slot, R) && pods_ok &&
          !(ports && vtt::ports_clash(ports + static_cast<int64_t>(u) * PW,
                                      nports, nullptr, n, PW)) &&
          !(aff_ok && !aff_ok[ai]);
      float score = vtt::node_score(rq, al, id, bres, R, w) +
                    stat_score[static_cast<int64_t>(u) * C + c];
      if (aff_soft) score = score + aff_soft[ai];
      const float masked = feas ? score : vtt::kNeg;
      scores[l] = masked;
      keys[l] = vtt::make_key(masked, static_cast<uint32_t>(l));
    } else {
      keys[l] = 0;  // below every real key
    }
  }
  __syncthreads();
  // Bitonic sort, descending.
  for (int k = 2; k <= npow2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < npow2; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t a = keys[i];
          const uint64_t c2 = keys[ixj];
          const bool desc = (i & k) == 0;
          if (desc ? (a < c2) : (a > c2)) {
            keys[i] = c2;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int r = threadIdx.x; r < klb; r += blockDim.x) {
    const uint32_t l =
        0xFFFFFFFFu - static_cast<uint32_t>(keys[r] & 0xFFFFFFFFu);
    cand_s[cbase + r] = scores[l];
    cand_i[cbase + r] = b * nlb + static_cast<int32_t>(l);
  }
}

template <bool kCold>
__global__ void __launch_bounds__(1024) merge_kernel(
    const float* cand_s, const int32_t* cand_i, int L, int S, int spow2,
    uint64_t* keys_scratch, int32_t* out) {
  extern __shared__ int32_t ids[];  // [spow2]
  __shared__ int hist[256];
  __shared__ int bcast[2];
  __shared__ int warp_sums[32];
  __shared__ int base_s;
  const int u = blockIdx.x;
  const float* cs = cand_s + static_cast<int64_t>(u) * L;
  const int32_t* ci = cand_i + static_cast<int64_t>(u) * L;
  uint64_t* keys = keys_scratch + static_cast<int64_t>(u) * L;
  for (int p = threadIdx.x; p < L; p += blockDim.x) {
    keys[p] = vtt::make_key(cs[p], static_cast<uint32_t>(p));
  }
  __syncthreads();
  const uint64_t kth = vtt::block_select_kth(keys, L, S, hist, bcast);
  if (threadIdx.x == 0) base_s = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int start = 0; start < L; start += blockDim.x) {
    const int p = start + threadIdx.x;
    const bool sel = p < L && keys[p] >= kth;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, sel);
    if (lane == 0) warp_sums[warp] = __popc(ballot);
    __syncthreads();
    int before = 0;
    int total = 0;
    for (int i = 0; i < nwarps; ++i) {
      if (i < warp) before += warp_sums[i];
      total += warp_sums[i];
    }
    const int pos = base_s + before + __popc(ballot & ((1u << lane) - 1u));
    if (sel) ids[pos] = ci[p];
    __syncthreads();
    if (threadIdx.x == 0) base_s += total;
    __syncthreads();
  }
  for (int i = S + threadIdx.x; i < spow2; i += blockDim.x) {
    ids[i] = 0x7FFFFFFF;
  }
  __syncthreads();
  // Bitonic sort, ascending.
  for (int k = 2; k <= spow2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < spow2; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const int32_t a = ids[i];
          const int32_t c2 = ids[ixj];
          const bool asc = (i & k) == 0;
          if (asc ? (a > c2) : (a < c2)) {
            ids[i] = c2;
            ids[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  int32_t* row = out + static_cast<int64_t>(u) * S;
  for (int i = threadIdx.x; i < S; i += blockDim.x) row[i] = ids[i];
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
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
           int32_t* cand_i, uint64_t* keys_scratch, int32_t* out,
           const uint32_t* ports, int PW, const uint32_t* nports,
           const uint8_t* aff_ok, const float* aff_soft, int Ma,
           cudaStream_t st) {
  const int npow2 = pow2_at_least(nlb);
  const size_t rank_smem = static_cast<size_t>(npow2) * sizeof(uint64_t) +
                           static_cast<size_t>(nlb) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      block_rank_kernel<kCold>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(rank_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  block_rank_kernel<kCold><<<dim3(B, U), 1024, rank_smem, st>>>(
      req, init_req, R, stat_ok, stat_score, C, cls_id, idle, rel, pip,
      alloc, ntasks,
      max_tasks, eps, scalar_slot, bres, w, db, ndb, B, nlb, klb, npow2,
      old_s, old_i, cand_s, cand_i, ports, PW, nports, aff_ok, aff_soft, Ma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int spow2 = pow2_at_least(S);
  const size_t merge_smem = static_cast<size_t>(spow2) * sizeof(int32_t);
  err = cudaFuncSetAttribute(merge_kernel<kCold>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(merge_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<kCold><<<U, 1024, merge_smem, st>>>(
      cand_s, cand_i, B * klb, S, spow2, keys_scratch, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory sizes the launch asks for (the wrapper refuses shapes
// past the card's 227 KB per block).
extern "C" int vtt_block_shortlist_smem(int nlb, int S) {
  const int a = pow2_at_least(nlb) * 8 + nlb * 4;
  const int b = pow2_at_least(S) * 4;
  return a > b ? a : b;
}

// cold != 0: every block is dirty (db/old_* unused) -- the with_cand
// coarse pass.  cold == 0: the warm pass over the ndb dirty blocks db.
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
           static_cast<uint64_t*>(keys_scratch), static_cast<int32_t*>(out),
           static_cast<const uint32_t*>(ports), PW,
           static_cast<const uint32_t*>(nports),
           static_cast<const uint8_t*>(aff_ok),
           static_cast<const float*>(aff_soft), Ma, st);
}
