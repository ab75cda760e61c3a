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
//   cfit[b, u] = sum of cap over the nodes of block b;
//   whole[b]   = cfit[b, u] >= cnt[u] for every u;
//   score[b]   = sum over u of min(cfit[b, u], cnt[u]) in f32;
//   frag[b]    = whole[b] ? 0 : score[b] / need, need = max(sum over u
//                of f32 cnt[u], 1): JAX's fabric_frag of this cfit and
//                whole, written by the same launch.
//
// The TPU program scatters with `.at[seg].add`.  Here it is one launch of
// a thread-block cluster of C CTAs (`block_fit_kernel`; C from 1 to 16,
// chosen by N: a node a thread on CTAs of 512 threads), with no global
// atomics and no zero fill:
//
// 1. each CTA zeroes a [T, W] int32 table of partial sums in its shared
//    memory, stages the profiles' requests and counts, walks its share of
//    the nodes (the next node's loads in flight while one is counted),
//    computes each node's capacities and adds them into its block's row
//    with shared-memory integer atomics (one add per run of lanes of a
//    warp in one block);
// 2. `cluster.sync()`; CTA rank r reduces rows r, r + C, ... over all C
//    CTAs' tables (distributed shared memory), one warp a row: it writes
//    each row of `cfit` once and computes `whole`, `score` and `frag`
//    from it (`need` is summed once per CTA by thread 0 while the nodes
//    are walked);
// 3. a cluster barrier before any CTA zeroes its table again or exits, so
//    no table is rewritten or released while another CTA still reads it
//    (relaxed: it orders no memory, so it does not wait for the stores).
//
// A blockless node (b < 0) and a node past the last block (b >= Bp) add
// nothing to any row the function returns: JAX adds the first into a
// trash row it slices off and drops the second as out of range.  Both are
// skipped.  Where Bp x U int32 does not fit one CTA's shared memory the
// table is a tile of T rows x W profiles and steps 1-3 run once per tile
// (profile tiles outermost, so a row's `whole` and `score` carry across
// them in profile order; `frag` is written after the last profile tile).
// Integer adds are exact in any order (int32 wraps alike on both sides);
// `score` adds its f32 terms left to right over u.
//
// `frag` is fabric_frag's output bit for bit: fabric_frag sums
// min(f32 cfit, f32 cnt) left to right from +0.0, `score` f32(min(cfit,
// cnt)) in the same order, and rounding to f32 is monotonic, so the two
// minimums are the same f32 values and the sums are equal; `need` is
// summed left to right from +0.0 as fabric_frag sums it.  So the
// rebalance planner reads the stranded-block score from the block fit's
// own fetch, with no upload, launch or fetch of its own.
//
// fabric_frag (`fabric_frag_kernel`, one thread per block) stays for a
// caller that holds only cfit and whole: need = max(sum cnt, 1) and
// frag[b] = whole[b] ? 0 : (sum over u of min(f32 cfit[b, u], cnt[u])) /
// need, summed left to right.
//
// Bound: bytes -- gang_block_fit reads the [N, R] idle plane and four [N]
// node planes (~28 bytes a node at R = 2; 8,192 nodes: ~0.23 MB) and
// writes [B, U] counts; its ~U R divisions a node are far below the card's
// rate.  fabric_frag reads and writes a few KB: launch latency dominates,
// which is why the block fit computes it in its launch.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr float kFitMax = 1073741824.0f;  // 2^30 (topology.py _FIT_MAX)

constexpr int kFitSmem = 212 * 1024;  // a tile's table, at most (+ 12 KB static)
constexpr int kReqSmem = 2048;        // a tile's [W, R] requests staged
constexpr int kCntSmem = 1024;        // a tile's [W] counts staged
constexpr int kMaxCluster = 16;

// One node's capacity for profile u (topology.py:213-229): the floor of
// (idle + eps) / max(req, 1e-9) over the requested slots, 2^30 for a slot
// not requested, 0 for a profile that requests nothing, clipped to
// [0, 2^30] and capped by the free pod slots -- an exact int32.
template <int kR>
__device__ __forceinline__ int node_cap(const float (&id)[kR],
                                        const float* rq,
                                        const float (&eps)[kR], int R,
                                        float slots) {
  float cap = INFINITY;
  bool any = false;
#pragma unroll
  for (int s = 0; s < kR; ++s) {
    if (s < R) {
      const float r = rq[s];
      const bool requested = r > eps[s];
      any = any || requested;
      const float per =
          requested ? floorf((id[s] + eps[s]) / fmaxf(r, 1e-9f)) : kFitMax;
      cap = fminf(cap, per);
    }
  }
  if (!any) cap = 0.0f;
  cap = fminf(fmaxf(cap, 0.0f), kFitMax);
  cap = fminf(cap, slots);
  return static_cast<int>(cap);  // in [0, 2^30]: exact
}

// One node's inputs, loaded at once (no load waits on another).
template <int kR>
struct NodeIn {
  bool ok;
  uint8_t ready;
  int32_t bid, mt, nt;
  float id[kR];
};

template <int kR>
__device__ __forceinline__ void load_node(
    NodeIn<kR>& x, int n, int N, int R, const float* idle,
    const uint8_t* ready, const int32_t* ntasks, const int32_t* max_tasks,
    const int32_t* block_id) {
  x.ok = n < N;
  if (!x.ok) return;
  x.ready = ready[n];
  x.bid = block_id[n];
  x.mt = max_tasks[n];
  x.nt = ntasks[n];
  const float* ip = idle + static_cast<int64_t>(n) * R;
#pragma unroll
  for (int s = 0; s < kR; ++s) {
    if (s < R) x.id[s] = ip[s];
  }
}

// A cluster barrier without the release / acquire fences of
// `cluster.sync()` (a GPU-scope MEMBAR before the arrive, which waits for
// every global store in flight): enough where it only has to keep a CTA
// from overwriting or releasing a table that another CTA is reading, as
// a read has returned its value once the reader goes on.
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile(
      "barrier.cluster.arrive.relaxed.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One launch of one cluster of CTAs of at most kThreads threads (a
// multiple of 32), R <= kR; dynamic shared memory: T * W int32.
template <int kR, int kThreads>
__global__ void __launch_bounds__(kThreads, 1) block_fit_kernel(
    const float* idle, const uint8_t* ready, const int32_t* ntasks,
    const int32_t* max_tasks, const int32_t* block_id, const float* req,
    const int32_t* cnt, const float* eps, int N, int U, int R, int Bp, int T,
    int W, int32_t* cfit, uint8_t* whole, float* score, float* frag) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ int32_t tab[];
  __shared__ float es[vtt::kMaxR];
  __shared__ float sreq[kReqSmem];
  __shared__ int32_t scnt[kCntSmem];
  __shared__ float sneed;  // fabric_frag's divisor, max(sum cnt, 1)
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int threads = blockDim.x;
  const int warps = threads >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t cells = static_cast<int64_t>(T) * W;
  const int first_base = rank * threads + (threadIdx.x & ~31);
  const int stride = C * threads;
  if (threadIdx.x < R) es[threadIdx.x] = eps[threadIdx.x];
  bool first = true;
  // U = 0 still runs one (empty) profile tile: whole = true, score = 0.
  for (int u0 = 0; u0 < U || (U == 0 && u0 == 0); u0 += W > 0 ? W : 1) {
    const int w = min(W, U - u0);
    const bool staged = static_cast<int64_t>(w) * R <= kReqSmem;
    const bool cnt_staged = w <= kCntSmem;
    for (int r0 = 0; r0 < Bp; r0 += T) {
      const int t = min(T, Bp - r0);
      // This thread's first node: its loads are in flight during the
      // barrier, the zero fill and the staging below.
      NodeIn<kR> cur;
      load_node(cur, first_base + lane, N, R, idle, ready, ntasks,
                max_tasks, block_id);
      if (!first) cluster_sync_relaxed();  // the last tile's reads are done
      first = false;
      for (int64_t i = threadIdx.x; i < cells; i += threads) tab[i] = 0;
      if (staged) {
        for (int i = threadIdx.x; i < w * R; i += threads) {
          sreq[i] = req[static_cast<int64_t>(u0) * R + i];
        }
      }
      if (cnt_staged) {
        for (int i = threadIdx.x; i < w; i += threads) scnt[i] = cnt[u0 + i];
      }
      __syncthreads();
      if (u0 == 0 && r0 == 0 && threadIdx.x == 0) {
        // Left to right from +0.0, the staged counts where they are all
        // staged; read after the cluster barrier below.
        float need = 0.0f;
        for (int u = 0; u < U; ++u) {
          need = need + static_cast<float>(w == U && cnt_staged ? scnt[u]
                                                                : cnt[u]);
        }
        sneed = fmaxf(need, 1.0f);
      }
      float ev[kR];
#pragma unroll
      for (int s = 0; s < kR; ++s) ev[s] = s < R ? es[s] : 0.0f;
      // Warp-uniform trip count: every lane reaches the warp intrinsics.
      // The next node's loads are in flight while this one is counted.
      for (int base = first_base; base < N; base += stride) {
        NodeIn<kR> nxt;
        nxt.ok = false;
        if (base + stride < N) {
          load_node(nxt, base + stride + lane, N, R, idle, ready, ntasks,
                    max_tasks, block_id);
        }
        int row = -1;
        if (cur.ok && cur.ready && cur.bid >= r0 && cur.bid < r0 + t) {
          row = cur.bid - r0;
        }
        if (!__all_sync(0xffffffffu, row < 0)) {
          const unsigned grp = __match_any_sync(0xffffffffu, row);
          const bool leader = lane == __ffs(grp) - 1;
          const int left = cur.mt - cur.nt;
          const float slots = cur.mt > 0
                                  ? static_cast<float>(left > 0 ? left : 0)
                                  : kFitMax;
          for (int u = 0; u < w; ++u) {
            const float* rq =
                staged ? sreq + u * R : req + static_cast<int64_t>(u0 + u) * R;
            const int c = row >= 0 ? node_cap<kR>(cur.id, rq, ev, R, slots)
                                   : 0;
            const int sum = __reduce_add_sync(grp, c);
            if (leader && row >= 0 && sum != 0) {
              atomicAdd(&tab[static_cast<int64_t>(row) * w + u], sum);
            }
          }
        }
        cur = nxt;
      }
      cluster.sync();  // every CTA's partial sums are in
      for (int i = rank + C * warp; i < t; i += C * warps) {
        const int b = r0 + i;
        bool ok = true;
        float sc = 0.0f;
        if (u0 > 0 && lane == 0) {
          ok = whole[b] != 0;
          sc = score[b];
        }
        for (int c0 = 0; c0 < w; c0 += 32) {
          const int u = c0 + lane;
          float part = 0.0f;
          if (u < w) {
            // The C reads are independent: all in flight at once.
            uint32_t sum = 0;  // int32 wraps alike on both sides
#pragma unroll
            for (int q = 0; q < kMaxCluster; ++q) {
              if (q < C) {
                const int32_t* other = cluster.map_shared_rank(tab, q);
                sum += static_cast<uint32_t>(
                    other[static_cast<int64_t>(i) * w + u]);
              }
            }
            const int32_t v = static_cast<int32_t>(sum);
            const int32_t need = cnt_staged ? scnt[u] : cnt[u0 + u];
            cfit[static_cast<int64_t>(b) * U + u0 + u] = v;
            part = static_cast<float>(v < need ? v : need);
            ok = ok && v >= need;
          }
          // Left to right over u: lane 0 adds the lanes' terms in order.
          const int m = min(32, w - c0);
          for (int j = 0; j < m; ++j) {
            const float x = __shfl_sync(0xffffffffu, part, j);
            if (lane == 0) sc = sc + x;
          }
        }
        ok = __all_sync(0xffffffffu, ok);
        if (lane == 0) {
          whole[b] = ok ? 1 : 0;
          score[b] = sc;
          if (u0 + w >= U) frag[b] = ok ? 0.0f : sc / sneed;
        }
      }
    }
  }
  cluster_sync_relaxed();  // no CTA exits while its table is still read
}

// Sets the kernel's attributes and launches one cluster of C CTAs (C = 0:
// chosen by N).
template <int kR, int kThreads>
cudaError_t launch_block_fit(int C, size_t smem, cudaStream_t st,
                             const float* idle, const uint8_t* ready,
                             const int32_t* ntasks, const int32_t* max_tasks,
                             const int32_t* block_id, const float* req,
                             const int32_t* cnt, const float* eps, int N,
                             int U, int R, int Bp, int T, int W,
                             int32_t* cfit, uint8_t* whole, float* score,
                             float* frag) {
  auto kernel = block_fit_kernel<kR, kThreads>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFitSmem);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e != cudaSuccess) return e;
  // A node a thread on CTAs of 512 threads, up to 16 of them; past
  // 8,192 nodes the CTAs grow to kThreads, then take several nodes a
  // thread.
  if (C == 0) {
    const int want = (N + 511) / 512;
    C = want < 1 ? 1 : (want > kMaxCluster ? kMaxCluster : want);
  }
  int threads = ((N + C - 1) / C + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kThreads ? kThreads : threads);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, idle, ready, ntasks, max_tasks,
                            block_id, req, cnt, eps, N, U, R, Bp, T, W, cfit,
                            whole, score, frag);
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

// `cfit` is [Bp, U] int32 (every row written), `whole` / `score` /
// `frag` [Bp]; `cluster` forces the cluster size (0: chosen by N).
extern "C" int vtt_gang_block_fit(const void* idle, const void* ready,
                                  const void* ntasks, const void* max_tasks,
                                  const void* block_id, const void* req,
                                  const void* cnt, const void* eps, int N,
                                  int U, int R, int Bp, int cluster,
                                  void* cfit, void* whole, void* score,
                                  void* frag, void* stream) {
  if (R > vtt::kMaxR || Bp < 1 || cluster < 0 || cluster > kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The tile: all Bp rows of W = U profiles where they fit, else fewer
  // rows, else fewer profiles.
  const int64_t words = kFitSmem / 4;
  const int W = static_cast<int>(U < words ? U : words);
  const int64_t rows = W > 0 ? words / W : Bp;
  const int T = static_cast<int>(rows < Bp ? rows : Bp);
  const size_t smem = static_cast<size_t>(T) * W * 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* f_idle = static_cast<const float*>(idle);
  const auto* f_ready = static_cast<const uint8_t*>(ready);
  const auto* f_nt = static_cast<const int32_t*>(ntasks);
  const auto* f_mt = static_cast<const int32_t*>(max_tasks);
  const auto* f_bid = static_cast<const int32_t*>(block_id);
  const auto* f_req = static_cast<const float*>(req);
  const auto* f_cnt = static_cast<const int32_t*>(cnt);
  const auto* f_eps = static_cast<const float*>(eps);
  auto* f_cfit = static_cast<int32_t*>(cfit);
  auto* f_whole = static_cast<uint8_t*>(whole);
  auto* f_score = static_cast<float*>(score);
  auto* f_frag = static_cast<float*>(frag);
  // Up to 4 slots: 1,024 threads with a node's idle row in 4 registers;
  // more: 512 threads with room for 16.
  const cudaError_t e =
      R <= 4 ? launch_block_fit<4, 1024>(cluster, smem, st, f_idle, f_ready,
                                         f_nt, f_mt, f_bid, f_req, f_cnt,
                                         f_eps, N, U, R, Bp, T, W, f_cfit,
                                         f_whole, f_score, f_frag)
             : launch_block_fit<vtt::kMaxR, 512>(
                   cluster, smem, st, f_idle, f_ready, f_nt, f_mt, f_bid,
                   f_req, f_cnt, f_eps, N, U, R, Bp, T, W, f_cfit, f_whole,
                   f_score, f_frag);
  if (e != cudaSuccess) return static_cast<int>(e);
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
