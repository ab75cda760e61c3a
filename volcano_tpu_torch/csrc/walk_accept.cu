// walk_accept: one sub-round of the wave solve's capacity walk and
// in-order acceptance.
//
// Replaces one pass of the JAX package's sub-round body `sub_body`
// (volcano_tpu/ops/wave.py:1587-2003): the walk (:1660-1705) and the
// prefix acceptance (:1707-1748), up to the inter-pod affinity filter
// (aff_filter.cu, applied to its outputs).  With releasing capacity (`rel`
// given: the JAX has_future branch) the walk reads FutureIdle = ((idle +
// releasing) - pipelined) - pip_extra (wave.py:1659-1662), pod slots count
// ntasks + pip_ntasks, and a task that fits the future idle but not the
// live idle is accepted as pipelined (`acc_pipe`, wave.py:1997-2003):
//
//  1. per ranked node: copies of the profile that still fit,
//     c[u,k] = min(floor(min_r idle/req), max_tasks - ntasks), 0 where the
//     candidate is infeasible, and its running sum `cumcap` along the
//     ranking;
//  2. per task: its rank m among the remaining candidates of its contention
//     group that come earlier in task order, the walk position
//     j = #{k : cumcap[u,k] <= m}, the chosen node ranked[u, j] and the
//     overflow flag;
//  3. per live task: the requests and count of the strictly-earlier live
//     tasks that chose the same node, then the idle and pod-slot checks
//     that give `acc_alloc` (and `acc_pipe`).
//
// With host ports a task also fails when an earlier live task on the same
// node asks for one of its ports, or its node already uses one (allocated
// | pipelined; wave.py:1735-1747).  A profile anti-affine to its own
// labels (`self_anti`) holds at most one copy per ranked node in step 1
// (wave.py:1690-1696).
//
// The TPU builds steps 2 and 3 as [W, W] `tril` products.  Here they are
// O(W log W) or O(W * UM) and spread over the card, in two launches:
//
//  walk_choice_kernel, one block per profile row u (a padding row, which
//  no task uses, runs beside the others and writes nothing):
//   - capacities, one thread per ranked node, and their running sum by
//     one thread, left to right: the f32 adds of torch.cumsum in its
//     order (cumcap is compared with m exactly, and a scan that
//     reassociated adds of capacities up to 1e9 could round otherwise);
//   - the group rank m[t] = #{t' < t : cand_s[t'] & grp[u, pid[t']]} for
//     the tasks of profile u: one block-wide exclusive count of that flag
//     over the wave (eight tasks a thread, one scan per 2,048 tasks).  grp
//     is not transitive (wave.py:1544-1555), so each profile row scans
//     with its own flags;
//   - j by binary search (fixed steps, from the largest power of two <= K
//     down) for the upper bound of m in the row: capacities are >= 0, and
//     adding values >= 0 keeps an f32 running sum nondecreasing.  A row with a negative capacity (a node holding more
//     pods than its max) is not sorted; it counts linearly, as the plain
//     version does.
//  walk_accept_kernel, one block of 1,024 threads for the wave:
//   - the live tasks' keys (choice << 32 | t), compacted in task order and
//     bitonic-sorted (stages that pair keys under 64 apart stay inside a
//     warp and take a warp barrier): equal choices form segments in task
//     order;
//   - per request slot, the count, and per port word, one exclusive
//     segmented scan over the sorted keys (two keys a thread, warp
//     shuffles, one barrier pair per 2,048-key tile): the earlier
//     same-node live tasks' request sum
//     in double, their count, and the OR of their port words.  The port
//     test (my_ports & OR_prev) != 0 is the pairwise `any` of the TPU.
//     The request values are integers (milli-units and bytes) whose sums
//     stay below 2^53, so every double partial sum is exact and the scan's
//     order gives the float the plain version's task-order sum gives,
//     rounded once to f32;
//   - per task, the slot checks of ops/resreq.py less_equal are ANDed one
//     slot per scan, so the scan state is one value per key and a flag
//     byte: the sort keys and flags live in shared memory (9 bytes a key,
//     18 KB at W = 2,048) or, for a wave too large for it, in a global
//     scratch the wrapper passes -- the same kernel either way.
//
// Bound: a few hundred KB of inputs (tens of ns at 3.35 TB/s); the
// kernels are latency-bound: two launches, the capacity row's 256
// dependent adds, the sort's O(log W) block barriers (22 at W = 2,048)
// and a barrier pair per scan and tile.
#include "common.cuh"

namespace {

constexpr int kWalkThreads = 256;
constexpr int kAccThreads = 1024;
constexpr int kChunk = 8;  // tasks a walk_choice_kernel thread ranks
constexpr int kItems = 2;  // sorted keys a walk_accept_kernel thread scans
constexpr unsigned kFull = 0xFFFFFFFFu;
// Shared memory a launch may use without an opt-in.
constexpr int kWalkSmem = 48 * 1024;
// Per sort key: the key and its flag byte; keys of a wave above kAccSmem
// go to the global scratch.
constexpr int kKeyBytes = 9;
constexpr int kAccSmem = 200 * 1024;

enum : uint8_t {
  kFitsIdle = 1,
  kFitsFut = 2,
  kPortClash = 4,
  kPodsFit = 8,
};

// ops/resreq.py less_equal for one slot.
__device__ __forceinline__ bool slot_ok(float a, float b, float eps,
                                        bool scalar) {
  return (a < b) || (fabsf(a - b) < eps) || (scalar && (a <= eps));
}

__global__ void __launch_bounds__(kWalkThreads) walk_choice_kernel(
    const int32_t* ranked, const uint8_t* feas_k, int UM, int K,
    const float* p_req, int R, const int32_t* pid_l, const uint8_t* cand_s,
    const uint8_t* any_feas, const uint8_t* grp, int W, const float* idle,
    const float* rel, const float* pip, const float* pxe,
    const int32_t* pip_ntasks, const int32_t* ntasks,
    const int32_t* max_tasks, int N, const uint8_t* self_anti,
    float* cumcap_g, uint8_t* live, int32_t* out_choice) {
  extern __shared__ float s_cum[];
  __shared__ int s_warp[kWalkThreads / 32];
  const int u = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* cum = cumcap_g ? cumcap_g + static_cast<int64_t>(u) * K : s_cum;

  // 1. live capacity of every ranked node, then its running sum.
  bool unsorted = false;
  const float* rq = p_req + static_cast<int64_t>(u) * R;
  for (int k = tid; k < K; k += kWalkThreads) {
    const int64_t idx = static_cast<int64_t>(u) * K + k;
    const int n = ranked[idx];
    float id[vtt::kMaxR];
    vtt::future_idle(idle, rel, pip, pxe, n, R, id);
    float c_res = INFINITY;
    for (int s = 0; s < R; ++s) {
      const float per =
          rq[s] > 0.0f ? id[s] / (rq[s] > 1e-9f ? rq[s] : 1e-9f) : INFINITY;
      c_res = s == 0 ? per : fminf(c_res, per);
    }
    c_res = fminf(fmaxf(c_res, 0.0f), vtt::kBig);
    const int mt = max_tasks[n];
    const int nt = ntasks[n] + (pip_ntasks ? pip_ntasks[n] : 0);
    const float c_pods = mt > 0 ? static_cast<float>(mt - nt) : vtt::kBig;
    float c = feas_k[idx] ? fminf(floorf(c_res), c_pods) : 0.0f;
    if (self_anti && self_anti[u]) c = fminf(c, 1.0f);
    cum[k] = c;
    unsorted = unsorted || !(c >= 0.0f);
  }
  const bool sorted_row = __syncthreads_or(unsorted) == 0;
  if (tid == 0) {
    // torch.cumsum's order: c[0], then run + c[k].  Loads run ahead of the
    // dependent adds eight at a time.
    float run = 0.0f;
    for (int k0 = 0; k0 < K; k0 += 8) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = k0 + i < K ? cum[k0 + i] : 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (k0 + i < K) {
          run = k0 + i == 0 ? v[i] : run + v[i];
          cum[k0 + i] = run;
        }
      }
    }
  }
  __syncthreads();

  // 2. group rank (an exclusive count over the wave), walk position and
  // choice of the tasks of profile u.  A thread takes kChunk consecutive
  // tasks (their loads in flight together), so 2,048 tasks cost one block
  // scan of the per-thread counts.
  const uint8_t* g_row = grp + static_cast<int64_t>(u) * UM;
  int top = 1;  // the largest power of two <= K: the search's first step
  while (top * 2 <= K) top *= 2;
  int carry = 0;
  for (int t0 = 0; t0 < W; t0 += kWalkThreads * kChunk) {
    const int first = t0 + tid * kChunk;
    int pu[kChunk];
    unsigned gbits = 0u;
    unsigned mine = 0u;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      pu[i] = first + i < W ? pid_l[first + i] : -1;
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int t = first + i;
      if (t < W && cand_s[t] && g_row[pu[i]]) gbits |= 1u << i;
      if (pu[i] == u) mine |= 1u << i;
    }
    const int cnt = __popc(gbits);
    int x = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    int m0 = carry + x - cnt;
    int tot = 0;
    for (int w = 0; w < kWalkThreads / 32; ++w) {
      const int v = s_warp[w];
      if (w < warp) m0 += v;
      tot += v;
    }
    // The thread's tasks of profile u search independently, so the
    // fixed-step searches and their `ranked` reads overlap.
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int t = first + i;
      if (!((mine >> i) & 1u)) continue;
      const float mf =
          static_cast<float>(m0 + __popc(gbits & ((1u << i) - 1u)));
      int j = 0;
      if (sorted_row) {
        for (int step = top; step > 0; step >>= 1) {
          if (j + step <= K && cum[j + step - 1] <= mf) j += step;
        }
      } else {
        for (int k = 0; k < K; ++k) j += cum[k] <= mf ? 1 : 0;
      }
      const bool cs = cand_s[t] && any_feas[t];
      const bool overflow = cs && j >= K;
      j = j < K - 1 ? j : K - 1;
      int ch = ranked[static_cast<int64_t>(u) * K + j];
      ch = ch < 0 ? 0 : (ch > N - 1 ? N - 1 : ch);
      out_choice[t] = ch;
      live[t] = (cs && !overflow) ? 1 : 0;
    }
    carry += tot;
    __syncthreads();
  }
}

struct AddD {
  __device__ double operator()(double a, double b) const { return a + b; }
};
struct AddI {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct OrU {
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return a | b;
  }
};

// Block-wide segmented scan of one aggregate a thread over the block's
// 1,024 threads, continuing the tile before it through `carry` (the
// inclusive value of that tile's last item; updated here).  `x` is op over
// the thread's items from its last segment head on, `f` whether they hold
// a head.  Returns the inclusive value just before the thread's first item
// (meaningless when that item is a head).  Two block barriers; `s_wv`,
// `s_wf`, `s_pv` are shared scratch of 32, 32 and 33 entries.
template <typename T, typename Op>
__device__ __forceinline__ T seg_scan_prefix(T x, int f, Op op, T* s_wv,
                                             int* s_wf, T* s_pv, T& carry) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(kFull, x, off);
    const int g = __shfl_up_sync(kFull, f, off);
    if (lane >= off) {
      if (!f) x = op(y, x);
      f |= g;
    }
  }
  if (lane == 31) {
    s_wv[warp] = x;
    s_wf[warp] = f;
  }
  __syncthreads();
  if (warp == 0) {
    const T c = carry;
    T a = s_wv[lane];
    int b = s_wf[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T y = __shfl_up_sync(kFull, a, off);
      const int g = __shfl_up_sync(kFull, b, off);
      if (lane >= off) {
        if (!b) a = op(y, a);
        b |= g;
      }
    }
    const T ya = __shfl_up_sync(kFull, a, 1);
    const int yb = __shfl_up_sync(kFull, b, 1);
    s_pv[lane] = lane == 0 ? c : (yb ? ya : op(c, ya));
    if (lane == 31) s_pv[32] = b ? a : op(c, a);
  }
  __syncthreads();
  const T pv = s_pv[warp];
  const T incl = f ? x : op(pv, x);
  const T prev = __shfl_up_sync(kFull, incl, 1);
  carry = s_pv[32];
  return lane == 0 ? pv : prev;
}

// Task, choice and segment start of sorted key i.
__device__ __forceinline__ void sorted_item(const uint64_t* keys, int i,
                                            int* t, int* ch, bool* head) {
  const uint64_t key = keys[i];
  *t = static_cast<int>(key & 0xFFFFFFFFu);
  *ch = static_cast<int>(key >> 32);
  *head = i == 0 || (keys[i - 1] >> 32) != (key >> 32);
}

// One exclusive segmented scan over the L sorted keys, kItems
// consecutive keys a thread per tile of kItems * 1,024: `value(t)` is task
// t's value, `use(i, t, ch, ex)` receives key i's exclusive value.
template <typename T, typename Op, typename Value, typename Use>
__device__ __forceinline__ void scan_keys(const uint64_t* keys, int L,
                                          T ident, Op op, Value value,
                                          Use use, T* s_wv, int* s_wf,
                                          T* s_pv) {
  T carry = ident;
  for (int base = 0; base < L; base += kItems * kAccThreads) {
    const int i0 = base + kItems * threadIdx.x;
    int t[kItems], ch[kItems];
    bool head[kItems];
    T v[kItems];
    T x = ident;
    int f = 0;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      head[q] = true;
      v[q] = ident;
      if (i0 + q < L) {
        sorted_item(keys, i0 + q, &t[q], &ch[q], &head[q]);
        v[q] = value(t[q]);
      }
      x = head[q] ? v[q] : op(x, v[q]);
      f |= head[q] ? 1 : 0;
    }
    T run = seg_scan_prefix(x, f, op, s_wv, s_wf, s_pv, carry);
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const T ex = head[q] ? ident : run;
      if (i0 + q < L) use(i0 + q, t[q], ch[q], ex);
      run = head[q] ? v[q] : op(run, v[q]);
    }
  }
}

__global__ void __launch_bounds__(kAccThreads) walk_accept_kernel(
    const int32_t* pid_l, const int32_t* choice, const uint8_t* live, int W,
    const float* p_req, const float* p_init_req, int R, const float* idle,
    const float* rel, const float* pip, const float* pxe,
    const int32_t* pip_ntasks, const int32_t* ntasks,
    const int32_t* max_tasks, const float* eps, const uint8_t* scalar_slot,
    const uint32_t* ports, int PW, const uint32_t* nport,
    const uint32_t* pip_nport, int P_max, uint64_t* scratch_g,
    uint8_t* out_acc, uint8_t* out_pipe) {
  extern __shared__ uint64_t s_dyn[];
  __shared__ double s_wv[32];
  __shared__ int s_wf[32];
  __shared__ double s_pv[33];
  __shared__ int s_cnt[32];
  uint64_t* keys = scratch_g ? scratch_g : s_dyn;
  uint8_t* flags = reinterpret_cast<uint8_t*>(keys + P_max);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // 1. the live tasks' keys, compacted in task order; the rest fail.
  int L = 0;
  for (int t0 = 0; t0 < W; t0 += kAccThreads) {
    const int t = t0 + tid;
    const bool in = t < W;
    const bool lv = in && live[t];
    if (in && !lv) {
      out_acc[t] = 0;
      if (out_pipe) out_pipe[t] = 0;
    }
    const unsigned b = __ballot_sync(kFull, lv);
    if (lane == 0) s_cnt[warp] = __popc(b);
    __syncthreads();
    int pos = L + __popc(b & ((1u << lane) - 1u));
    int tot = 0;
    for (int w = 0; w < 32; ++w) {
      const int x = s_cnt[w];
      if (w < warp) pos += x;
      tot += x;
    }
    if (lv) {
      keys[pos] = (static_cast<uint64_t>(static_cast<uint32_t>(choice[t]))
                   << 32) | static_cast<uint32_t>(t);
    }
    L += tot;
    __syncthreads();
  }
  if (L == 0) return;
  int P = 1;
  while (P < L) P <<= 1;
  for (int i = L + tid; i < P; i += kAccThreads) keys[i] = ~0ull;
  __syncthreads();

  // 2. bitonic sort of the keys (unique: t is in them).  A stage that
  // pairs keys less than 64 apart stays inside each warp's 64-key chunk:
  // a warp barrier orders it.
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P / 2; i += kAccThreads) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const uint64_t a = keys[lo];
        const uint64_t b = keys[hi];
        if ((a > b) == ((lo & k) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      if (j > 32) {
        __syncthreads();
      } else {
        __syncwarp();
      }
    }
    if (k >= 64) __syncthreads();
  }
  __syncthreads();

  // 3. the same-node prefix, one segmented scan per component, each key's
  // flag byte updated by the thread that scans it.
  const bool has_fut = rel != nullptr;
  for (int i = tid; i < L; i += kAccThreads) {
    const uint64_t key = keys[i];
    const int t = static_cast<int>(key & 0xFFFFFFFFu);
    const int ch = static_cast<int>(key >> 32);
    uint8_t fl = kFitsIdle | (has_fut ? kFitsFut : 0);
    if (ports &&
        vtt::ports_clash(ports + static_cast<int64_t>(pid_l[t]) * PW, nport,
                         pip_nport, ch, PW)) {
      fl |= kPortClash;
    }
    flags[i] = fl;
  }
  __syncthreads();
  for (int s = 0; s < R; ++s) {
    const bool sc = scalar_slot[s] != 0;
    const float ep = eps[s];
    scan_keys(
        keys, L, 0.0, AddD(),
        [&](int t) {
          return static_cast<double>(
              p_req[static_cast<int64_t>(pid_l[t]) * R + s]);
        },
        [&](int i, int t, int ch, double ex) {
          const float need = p_init_req[static_cast<int64_t>(pid_l[t]) * R +
                                        s] + static_cast<float>(ex);
          const int64_t o = static_cast<int64_t>(ch) * R + s;
          const float id = idle[o];
          uint8_t fl = flags[i];
          if (!slot_ok(need, id, ep, sc)) fl &= ~kFitsIdle;
          if (has_fut) {
            float fut = id;
            fut = fut + rel[o];
            fut = fut - pip[o];
            if (pxe) fut = fut - pxe[o];
            if (!slot_ok(need, fut, ep, sc)) fl &= ~kFitsFut;
          }
          flags[i] = fl;
        },
        s_wv, s_wf, s_pv);
  }
  scan_keys(
      keys, L, 0, AddI(), [](int) { return 1; },
      [&](int i, int t, int ch, int cnt) {
        const int mt = max_tasks[ch];
        const int nt = ntasks[ch] + (pip_ntasks ? pip_ntasks[ch] : 0);
        if (mt <= 0 || nt + cnt < mt) flags[i] |= kPodsFit;
      },
      reinterpret_cast<int*>(s_wv), s_wf, reinterpret_cast<int*>(s_pv));
  for (int w = 0; w < PW; ++w) {
    auto word = [&](int t) {
      return ports[static_cast<int64_t>(pid_l[t]) * PW + w];
    };
    scan_keys(
        keys, L, 0u, OrU(), word,
        [&](int i, int t, int ch, uint32_t prev) {
          if (word(t) & prev) flags[i] |= kPortClash;
        },
        reinterpret_cast<uint32_t*>(s_wv), s_wf,
        reinterpret_cast<uint32_t*>(s_pv));
  }

  // 4. the verdicts.
  __syncthreads();
  for (int i = tid; i < L; i += kAccThreads) {
    const int t = static_cast<int>(keys[i] & 0xFFFFFFFFu);
    const uint8_t fl = flags[i];
    const bool clean = (fl & kPodsFit) && !(fl & kPortClash);
    const bool fits_idle = (fl & kFitsIdle) != 0;
    out_acc[t] = (clean && fits_idle) ? 1 : 0;
    if (out_pipe) {
      out_pipe[t] = (clean && !fits_idle && (fl & kFitsFut)) ? 1 : 0;
    }
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

// `cumcap` is a global [UM, K] f32 scratch when K * 4 bytes exceed 48 KB,
// else null (shared memory); `sort_scratch` a global scratch of 9 bytes
// per key of the power of two >= W when that exceeds 200 KB, else null
// (ops/kernels.py walk_accept mirrors both limits).
extern "C" int vtt_walk_accept(
    const void* ranked, const void* feas_k, int UM, int K, const void* p_req,
    const void* p_init_req, int R, const void* pid_l, const void* cand_s,
    const void* any_feas, const void* grp, int W, const void* idle,
    const void* rel, const void* pip, const void* pxe, const void* pip_ntasks,
    const void* ntasks, const void* max_tasks, int N, const void* eps,
    const void* scalar_slot, void* cumcap, void* sort_scratch, void* live,
    void* out_choice, void* out_acc, void* out_pipe, const void* ports,
    int PW, const void* nport, const void* pip_nport, const void* self_anti,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W <= 0 || UM <= 0) return 0;
  const int walk_smem = cumcap ? 0 : K * 4;
  if (walk_smem > kWalkSmem) return static_cast<int>(cudaErrorInvalidValue);
  walk_choice_kernel<<<UM, kWalkThreads, walk_smem, st>>>(
      static_cast<const int32_t*>(ranked), static_cast<const uint8_t*>(feas_k),
      UM, K, static_cast<const float*>(p_req), R,
      static_cast<const int32_t*>(pid_l), static_cast<const uint8_t*>(cand_s),
      static_cast<const uint8_t*>(any_feas), static_cast<const uint8_t*>(grp),
      W, static_cast<const float*>(idle), static_cast<const float*>(rel),
      static_cast<const float*>(pip), static_cast<const float*>(pxe),
      static_cast<const int32_t*>(pip_ntasks),
      static_cast<const int32_t*>(ntasks),
      static_cast<const int32_t*>(max_tasks), N,
      static_cast<const uint8_t*>(self_anti), static_cast<float*>(cumcap),
      static_cast<uint8_t*>(live), static_cast<int32_t*>(out_choice));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = pow2_at_least(W);
  const int64_t sort_bytes = static_cast<int64_t>(P) * kKeyBytes;
  int acc_smem = 0;
  if (!sort_scratch) {
    if (sort_bytes > kAccSmem) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    acc_smem = static_cast<int>(sort_bytes);
    if (acc_smem > kWalkSmem) {
      err = cudaFuncSetAttribute(walk_accept_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 acc_smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  walk_accept_kernel<<<1, kAccThreads, acc_smem, st>>>(
      static_cast<const int32_t*>(pid_l),
      static_cast<const int32_t*>(out_choice),
      static_cast<const uint8_t*>(live), W,
      static_cast<const float*>(p_req), static_cast<const float*>(p_init_req),
      R, static_cast<const float*>(idle), static_cast<const float*>(rel),
      static_cast<const float*>(pip), static_cast<const float*>(pxe),
      static_cast<const int32_t*>(pip_ntasks),
      static_cast<const int32_t*>(ntasks),
      static_cast<const int32_t*>(max_tasks),
      static_cast<const float*>(eps), static_cast<const uint8_t*>(scalar_slot),
      static_cast<const uint32_t*>(ports), PW,
      static_cast<const uint32_t*>(nport),
      static_cast<const uint32_t*>(pip_nport), P,
      static_cast<uint64_t*>(sort_scratch), static_cast<uint8_t*>(out_acc),
      static_cast<uint8_t*>(out_pipe));
  return static_cast<int>(cudaGetLastError());
}
