// victim_scores: tier-gated victim eligibility, eviction order and the
// per-node evictable plane of the preempt and reclaim lanes.
//
// Replaces the JAX package's jitted `victim_scores`
// (volcano_tpu/ops/victim.py:82).  Five steps on one stream:
//
//  1. `share_kernel`, one thread per queue: q_share[q] = max over slots of
//     q_alloc / max(q_deserved, 1e-9) where the slot is capped
//     (q_deserved < 1e30), else 0 -- f32 IEEE division and a max.
//  2. `key_kernel`, one thread per victim row: eligibility (preempt:
//     v_ok & same queue & lower job priority; reclaim: v_ok & other queue &
//     reclaimable & q_share > 1 + 1e-6, the queue index clipped), and two
//     sort keys.  The order key replaces the JAX
//     `lexsort((tie, -crank, prio_key, ineligible))`: torch has no lexsort,
//     so one 64-bit word holds the ineligible bit (bit 63), the biased
//     prio_key (int32 max when ineligible, bits 62-31) and V-1-crank (bits
//     30-0; crank is a permutation of 0..V-1, whatif.py:758-759), and a
//     second word holds the biased tie and the row index, so the
//     (word, word) order is the lexsort order.  The node key is (clipped
//     node, row index).
//  3. A bitonic sort of both key arrays, ascending, padded to a power of
//     two with all-ones keys: tiles of 1024 keys sort in shared memory
//     (`bitonic_tile_kernel`), the compare distances of 1024 and more run
//     as global passes (`bitonic_global_kernel`).
//  4. `order_kernel`: the row indices of the sorted order keys.
//  5. `evictable_kernel`: the node-sorted rows form one segment per node,
//     in victim-index order; one thread per segment sums its rows'
//     eligible requests left to right in f32, starting from 0, as the JAX
//     scatter-add does on the CPU, and writes the node's row (the plane
//     is zeroed first).  No float atomics: the sum order is fixed.
//
// Bound: the function reads V x (R + 6) x 4 bytes of victim rows and
// 2 x Q x R x 4 bytes of queue planes and writes the [N, R] plane; at the
// preempt_cluster shape (V = 40,000, N = 10,000, R = 3) that is ~1.6 MB,
// ~0.5 us at 3.35 TB/s.  The sort's ~20 launches over 64 K keys dominate.
#include "common.cuh"

namespace {

constexpr int kTile = 1024;  // keys a shared-memory tile sorts

__device__ __forceinline__ bool pair_less(uint64_t a1, uint64_t a2,
                                          uint64_t b1, uint64_t b2) {
  return a1 < b1 || (a1 == b1 && a2 < b2);
}

__global__ void share_kernel(const float* q_alloc, const float* q_des,
                             int Q, int R, float* q_share) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  float m = 0.0f;
  for (int s = 0; s < R; ++s) {
    const float d = q_des[static_cast<int64_t>(q) * R + s];
    const float a = q_alloc[static_cast<int64_t>(q) * R + s];
    const float r = d < 1.0e30f ? a / (d > 1e-9f ? d : 1e-9f) : 0.0f;
    m = s == 0 ? r : (r > m ? r : m);
  }
  q_share[q] = m;
}

__global__ void key_kernel(const uint8_t* v_ok, const int32_t* v_jprio,
                           const int32_t* v_crank, const int32_t* v_tie,
                           const int32_t* v_queue, const int32_t* v_node,
                           int V, int Vp, int p_prio, int p_queue,
                           const float* q_share, const uint8_t* q_rec, int Q,
                           int mode, int N, uint8_t* eligible,
                           uint64_t* ok1, uint64_t* ok2, uint64_t* nk1,
                           uint64_t* nk2) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= Vp) return;
  if (v >= V) {
    ok1[v] = ~0ull;
    ok2[v] = ~0ull;
    nk1[v] = ~0ull;
    nk2[v] = ~0ull;
    return;
  }
  int vq = v_queue[v];
  vq = vq < 0 ? 0 : (vq > Q - 1 ? Q - 1 : vq);
  const bool same_q = v_queue[v] == p_queue;
  const bool ok = v_ok[v] != 0;
  bool elig;
  if (mode == 0) {
    elig = ok && same_q && v_jprio[v] < p_prio;
  } else {
    const float tol = static_cast<float>(1.0 + 1e-6);
    elig = ok && !same_q && q_rec[vq] != 0 && q_share[vq] > tol;
  }
  eligible[v] = elig ? 1 : 0;
  const int32_t prio_key = elig ? v_jprio[v] : 0x7FFFFFFF;
  const uint64_t prio_bits =
      static_cast<uint64_t>(static_cast<uint32_t>(prio_key) ^ 0x80000000u);
  const uint64_t young =
      static_cast<uint64_t>(static_cast<uint32_t>(V - 1 - v_crank[v])) &
      0x7FFFFFFFull;
  ok1[v] = (static_cast<uint64_t>(elig ? 0 : 1) << 63) | (prio_bits << 31) |
           young;
  ok2[v] = (static_cast<uint64_t>(static_cast<uint32_t>(v_tie[v]) ^
                                  0x80000000u)
            << 32) |
           static_cast<uint64_t>(v);
  int n = v_node[v];
  n = n < 0 ? 0 : (n > N - 1 ? N - 1 : n);
  nk1[v] = static_cast<uint64_t>(n);
  nk2[v] = static_cast<uint64_t>(v);
}

// One compare-exchange of the bitonic network at distance j inside the
// sequence of length k; i is the global position.
__device__ __forceinline__ void cmp_swap(uint64_t* k1, uint64_t* k2, int a,
                                         int b, bool ascending) {
  const uint64_t a1 = k1[a], a2 = k2[a], b1 = k1[b], b2 = k2[b];
  if (pair_less(b1, b2, a1, a2) == ascending) {
    k1[a] = b1;
    k2[a] = b2;
    k1[b] = a1;
    k2[b] = a2;
  }
}

// blockIdx.y picks the key array (0: order keys, 1: node keys).  Sorts
// each tile of kTile keys for every k in [k_lo, min(k_hi, kTile)] when
// k_lo == 2 (the first pass), or finishes the distances j < kTile of one
// k > kTile (a merge pass).
__global__ void __launch_bounds__(kTile / 2) bitonic_tile_kernel(
    uint64_t* a1, uint64_t* a2, uint64_t* b1, uint64_t* b2, int Vp, int k_fix) {
  __shared__ uint64_t s1[kTile];
  __shared__ uint64_t s2[kTile];
  uint64_t* g1 = blockIdx.y ? b1 : a1;
  uint64_t* g2 = blockIdx.y ? b2 : a2;
  const int tile = blockDim.x * 2;
  const int base = blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    s1[i] = g1[base + i];
    s2[i] = g2[base + i];
  }
  __syncthreads();
  const int k_first = k_fix ? k_fix : 2;
  const int k_last = k_fix ? k_fix : (Vp < tile ? Vp : tile);
  for (int k = k_first; k <= k_last; k <<= 1) {
    for (int j = (k_fix ? tile : k) >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < tile / 2; t += blockDim.x) {
        // The t-th pair at distance j: low index i, partner i + j.
        const int i = (t / j) * 2 * j + (t % j);
        const bool ascending = ((base + i) & k) == 0;
        cmp_swap(s1, s2, i, i + j, ascending);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    g1[base + i] = s1[i];
    g2[base + i] = s2[i];
  }
}

__global__ void bitonic_global_kernel(uint64_t* a1, uint64_t* a2,
                                      uint64_t* b1, uint64_t* b2, int Vp,
                                      int k, int j) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Vp / 2) return;
  uint64_t* g1 = blockIdx.y ? b1 : a1;
  uint64_t* g2 = blockIdx.y ? b2 : a2;
  const int i = (t / j) * 2 * j + (t % j);
  cmp_swap(g1, g2, i, i + j, (i & k) == 0);
}

__global__ void order_kernel(const uint64_t* ok2, int V, int32_t* order) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < V) order[r] = static_cast<int32_t>(ok2[r] & 0xFFFFFFFFull);
}

__global__ void zero_kernel(float* plane, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) plane[i] = 0.0f;
}

__global__ void evictable_kernel(const uint64_t* nk1, const uint64_t* nk2,
                                 int V, const uint8_t* eligible,
                                 const float* v_req, int R,
                                 float* evictable) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= V) return;
  if (r > 0 && nk1[r - 1] == nk1[r]) return;  // not a segment start
  const uint64_t n = nk1[r];
  float acc[vtt::kMaxR];
  for (int s = 0; s < R; ++s) acc[s] = 0.0f;
  for (int e = r; e < V && nk1[e] == n; ++e) {
    const int v = static_cast<int>(nk2[e] & 0xFFFFFFFFull);
    const bool el = eligible[v] != 0;
    for (int s = 0; s < R; ++s) {
      acc[s] = acc[s] + (el ? v_req[static_cast<int64_t>(v) * R + s] : 0.0f);
    }
  }
  for (int s = 0; s < R; ++s) evictable[static_cast<int64_t>(n) * R + s] = acc[s];
}

}  // namespace

// Scratch: four uint64 arrays of Vp keys (Vp = V rounded up to a power of
// two, at least kTile).  V >= 1, N >= 1, Q >= 1, R <= kMaxR.
extern "C" int vtt_victim_scores(
    const void* v_ok, const void* v_jprio, const void* v_crank,
    const void* v_tie, const void* v_queue, const void* v_node,
    const void* v_req, int V, int R, int p_prio, int p_queue,
    const void* q_alloc, const void* q_des, const void* q_rec, int Q,
    int mode, int N, int Vp, void* ok1, void* ok2, void* nk1, void* nk2,
    void* eligible, void* order, void* evictable, void* q_share,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  share_kernel<<<(Q + threads - 1) / threads, threads, 0, st>>>(
      static_cast<const float*>(q_alloc), static_cast<const float*>(q_des), Q,
      R, static_cast<float*>(q_share));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  uint64_t* a1 = static_cast<uint64_t*>(ok1);
  uint64_t* a2 = static_cast<uint64_t*>(ok2);
  uint64_t* b1 = static_cast<uint64_t*>(nk1);
  uint64_t* b2 = static_cast<uint64_t*>(nk2);
  key_kernel<<<(Vp + threads - 1) / threads, threads, 0, st>>>(
      static_cast<const uint8_t*>(v_ok), static_cast<const int32_t*>(v_jprio),
      static_cast<const int32_t*>(v_crank), static_cast<const int32_t*>(v_tie),
      static_cast<const int32_t*>(v_queue),
      static_cast<const int32_t*>(v_node), V, Vp, p_prio, p_queue,
      static_cast<const float*>(q_share), static_cast<const uint8_t*>(q_rec),
      Q, mode, N, static_cast<uint8_t*>(eligible), a1, a2, b1, b2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 tiles(Vp / kTile, 2);
  bitonic_tile_kernel<<<tiles, kTile / 2, 0, st>>>(a1, a2, b1, b2, Vp, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int k = 2 * kTile; k <= Vp; k <<= 1) {
    for (int j = k >> 1; j >= kTile; j >>= 1) {
      const dim3 grid((Vp / 2 + threads - 1) / threads, 2);
      bitonic_global_kernel<<<grid, threads, 0, st>>>(a1, a2, b1, b2, Vp, k,
                                                      j);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    bitonic_tile_kernel<<<tiles, kTile / 2, 0, st>>>(a1, a2, b1, b2, Vp, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  order_kernel<<<(V + threads - 1) / threads, threads, 0, st>>>(
      a2, V, static_cast<int32_t*>(order));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t plane = static_cast<int64_t>(N) * R;
  zero_kernel<<<static_cast<int>((plane + threads - 1) / threads), threads, 0,
                st>>>(static_cast<float*>(evictable), plane);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  evictable_kernel<<<(V + threads - 1) / threads, threads, 0, st>>>(
      b1, b2, V, static_cast<const uint8_t*>(eligible),
      static_cast<const float*>(v_req), R, static_cast<float*>(evictable));
  return static_cast<int>(cudaGetLastError());
}
