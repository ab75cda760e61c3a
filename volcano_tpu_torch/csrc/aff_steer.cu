// aff_steer: the sub-round's live steering.
//
// Replaces `_solve_wave`'s `steer` (volcano_tpu/ops/wave.py:1603-1633):
// after a sub-round accepted a task that carries a required term or matches
// one some row requires, the next sub-round walks
//   feas_k[u, k] = feas_att[u, k] and node ranked[u, k] violates no
//                  required or anti term of row u on the live window
// with aff_live's verdict (aff.cuh) and no soft score.  The JAX
// single-phase branch computes it over all N nodes and takes the ranked
// positions; the two give the same values there.  Integer and boolean
// work: the result equals the plain version bit for bit.
//
// Bound: bytes, and below the launch floor at the main path's shapes
// (config 5, UM 128 x K 256, EW 128, D 10,016: ~0.0002 ms against a
// ~0.002 ms empty launch).  So the design removes launches and latency:
//  - one launch a call, computing or gated.  The steering byte `gate` is
//    read on the device (no host read); a clear byte returns at once,
//    leaving the caller's working plane as it was;
//  - a term's total is read only where the self-match rule asks for it:
//    an entry with t_req_aff & t_matches, and then only whether it is zero.
//    Counts are nonnegative (pods matching a term), so the total is zero
//    exactly when every word of the count row is, and the scan stops at the
//    first step that meets a nonzero one.  No other row is read whole;
//  - no scratch, so the wrapper allocates nothing;
//  - one block per (row u, kThreads ranked positions), no dependency
//    between blocks.  Its time is a chain of dependent reads (the gate;
//    the row's entries with the positions' ranked ids; a self-match term's
//    zero test; a node's domain; a count), and the block adds no link a
//    row does not need (steer_row).  A term several rows self-match is
//    tested once per row, from L2 (the window's rows are a few MB).
// One cooperative launch that tests each such term once, then a grid
// barrier, then the verdicts, measured slower (PERF.md row 2f): its launch
// and barrier cost more than the repeated tests.
#include "aff.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // zero-test loads a thread keeps in flight
constexpr int kBatch = 4;   // count reads a thread keeps in flight
constexpr unsigned kFull = 0xFFFFFFFFu;

struct SteerArgs {
  const int32_t* ranked;
  const uint8_t* feas_att;
  int K;
  const int32_t* node_dom;
  int NK;
  const int32_t* term_key;
  const int32_t* cnt_a;
  const int32_t* cnt_p;
  int E;
  int D;
  int vec;  // count rows 16-byte aligned and D % 4 == 0
  const uint8_t* t_aff;
  const uint8_t* t_anti;
  const uint8_t* t_match;
  const uint8_t* gate;
  int32_t* computed;
  uint8_t* feas_k;
};

struct SteerSmem {
  int e[kThreads];
  int key[kThreads];
  int self_e[kThreads];
  uint8_t kind[kThreads];
  uint8_t self_nz[kThreads];
  int warp[kThreads / 32];
  int warp_self[kThreads / 32];
};

// One (row, term) entry of the window tables, and its term's key column.
struct Entry {
  bool aff;
  bool anti;
  bool match;
  int key;
};

__device__ __forceinline__ Entry load_entry(const SteerArgs& a, int64_t row,
                                            int e) {
  Entry en = {false, false, false, 0};
  if (e < a.E) {
    en.aff = a.t_aff[row + e] != 0;
    en.anti = a.t_anti[row + e] != 0;
    en.match = a.t_match[row + e] != 0;
    en.key = __ldg(a.term_key + e);
  }
  return en;
}

__device__ __forceinline__ int32_t or4(int4 v) {
  return v.x | v.y | v.z | v.w;
}

// Whether count row e of cnt_a (+ cnt_p) holds a nonzero word: the
// self-match rule's total != 0, since counts are nonnegative.  Every
// thread of the block calls it; the answer is the block's.  kUnroll
// 16-byte loads a thread a step where the rows are aligned (4 * kUnroll
// words otherwise), and the scan stops after the first step in which any
// thread met a nonzero word.
__device__ bool row_nonzero(const int32_t* cnt_a, const int32_t* cnt_p,
                            int e, int D, int vec) {
  const int64_t base = static_cast<int64_t>(e) * D;
  const int planes = cnt_p ? 2 : 1;
  const int tid = threadIdx.x;
  if (vec) {
    const int4* a4 = reinterpret_cast<const int4*>(cnt_a + base);
    const int4* p4 =
        cnt_p ? reinterpret_cast<const int4*>(cnt_p + base) : nullptr;
    const int nw = D >> 2;
    const int n = planes * nw;  // cnt_a's words, then cnt_p's
    for (int i0 = 0; i0 < n; i0 += kThreads * kUnroll) {
      int4 v[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int i = i0 + j * kThreads + tid;
        v[j] = i >= n ? make_int4(0, 0, 0, 0)
                      : (i < nw ? __ldg(a4 + i) : __ldg(p4 + (i - nw)));
      }
      int32_t x = 0;
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) x |= or4(v[j]);
      if (__syncthreads_or(x != 0)) return true;
    }
    return false;
  }
  const int n = planes * D;
  constexpr int kWords = 4 * kUnroll;
  for (int i0 = 0; i0 < n; i0 += kThreads * kWords) {
    int32_t v[kWords];
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const int i = i0 + j * kThreads + tid;
      v[j] = i >= n ? 0
                    : (i < D ? __ldg(cnt_a + base + i)
                             : __ldg(cnt_p + base + (i - D)));
    }
    int32_t x = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) x |= v[j];
    if (__syncthreads_or(x != 0)) return true;
  }
  return false;
}

// Row u's verdicts at ranked positions [tile * kThreads, +kThreads).  A
// clear gate returns before any other read: a warp leaves only once its
// loads have landed, so a gated call waits on nothing else.  The
// positions' ranked ids and flags and the row's first entries are read
// together; the row's entries are staged kThreads at a time, compacted in
// list order to those with a kind, a self-match entry as required until
// its zero test exempts it.  Each thread then reads its ranked node's
// domain and the count for each staged entry, kBatch at a time, until a
// violation.  A row without entries reads nothing more: most rows of a
// steered wave have none, and loads issued for them (the node's domains
// ahead of need, the counts ahead of the zero tests) measured slower.
// Positions the attempt already found infeasible stay so without a read.
__device__ void steer_row(const SteerArgs& a, SteerSmem& s, int u,
                          int tile) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  if (a.gate && !*a.gate) return;
  const int k = tile * kThreads + tid;
  const int64_t pos_k = static_cast<int64_t>(u) * a.K + k;
  const int64_t row = static_cast<int64_t>(u) * a.E;
  bool ok = false;
  int32_t node = 0;
  if (k < a.K) {
    ok = a.feas_att[pos_k] != 0;
    node = a.ranked[pos_k];
  }
  Entry en = load_entry(a, row, tid);
  if (a.computed && u == 0 && tile == 0 && tid == 0) {
    atomicAdd(a.computed, 1);
  }
  const int32_t* nd = a.node_dom + static_cast<int64_t>(node) * a.NK;
  for (int j0 = 0; j0 < a.E; j0 += kThreads) {
    const int e = j0 + tid;
    const bool self = en.aff && en.match;
    const uint8_t kind = static_cast<uint8_t>(
        (en.aff ? vtt::kRequired : 0) | (en.anti ? vtt::kAnti : 0));
    const unsigned act = __ballot_sync(kFull, kind != 0);
    const unsigned sel = __ballot_sync(kFull, self);
    if (lane == 0) {
      s.warp[warp] = __popc(act);
      s.warp_self[warp] = __popc(sel);
    }
    __syncthreads();
    int pos = __popc(act & below);
    int spos = __popc(sel & below);
    int cnt = 0;
    int nself = 0;
    for (int v = 0; v < kThreads / 32; ++v) {
      const int x = s.warp[v];
      const int y = s.warp_self[v];
      if (v < warp) {
        pos += x;
        spos += y;
      }
      cnt += x;
      nself += y;
    }
    if (kind != 0) {
      s.e[pos] = e;
      s.key[pos] = en.key;
      s.kind[pos] = kind;
    }
    if (nself > 0) {
      if (self) s.self_e[spos] = e;
      __syncthreads();
      for (int q = 0; q < nself; ++q) {
        const bool nz = row_nonzero(a.cnt_a, a.cnt_p, s.self_e[q], a.D,
                                    a.vec);
        if (tid == 0) s.self_nz[q] = nz ? 1 : 0;
      }
      __syncthreads();
      if (self) {
        s.kind[pos] = vtt::kind_of(en.aff, en.anti, en.match,
                                   s.self_nz[spos] == 0);
      }
    }
    // The next round's entries, in flight across this round's verdicts.
    const Entry next = load_entry(a, row, e + kThreads);
    __syncthreads();
    for (int q0 = 0; ok && q0 < cnt; q0 += kBatch) {
      int32_t cv[kBatch];
      uint8_t kq[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int q = q0 + j;
        kq[j] = q < cnt ? s.kind[q] : 0;  // 0: a self entry exempted
        cv[j] = 0;
        if (kq[j] != 0) {
          cv[j] = vtt::count_at(a.cnt_a, a.cnt_p, s.e[q], nd[s.key[q]],
                                a.D);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (vtt::violates(kq[j], cv[j])) ok = false;
      }
    }
    __syncthreads();
    en = next;
  }
  if (k < a.K) a.feas_k[pos_k] = ok ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads) aff_steer_row_kernel(
    SteerArgs a) {
  __shared__ SteerSmem s;
  steer_row(a, s, blockIdx.x, blockIdx.y);
}

}  // namespace

// feas_k[u, k] = feas_att[u, k] and no required / anti violation of row
// u's window entries at node ranked[u, k], on the live counts cnt_a (+
// cnt_p, may be null); written only when `gate` (null: always) is set on
// the device.  `computed` (may be null) counts the computing launches.
extern "C" int vtt_aff_steer(
    const void* ranked, const void* feas_att, int UM, int K,
    const void* node_dom, int NK, const void* term_key, const void* cnt_a,
    const void* cnt_p, int E, int D, const void* t_aff, const void* t_anti,
    const void* t_match, const void* gate, void* computed, void* feas_k,
    void* stream) {
  if (UM == 0 || K == 0) return 0;
  const int64_t tiles = (static_cast<int64_t>(K) + kThreads - 1) / kThreads;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const SteerArgs a = {static_cast<const int32_t*>(ranked),
                       static_cast<const uint8_t*>(feas_att),
                       K,
                       static_cast<const int32_t*>(node_dom),
                       NK,
                       static_cast<const int32_t*>(term_key),
                       static_cast<const int32_t*>(cnt_a),
                       static_cast<const int32_t*>(cnt_p),
                       E,
                       D,
                       D % 4 == 0 && aligned(cnt_a) && aligned(cnt_p),
                       static_cast<const uint8_t*>(t_aff),
                       static_cast<const uint8_t*>(t_anti),
                       static_cast<const uint8_t*>(t_match),
                       static_cast<const uint8_t*>(gate),
                       static_cast<int32_t*>(computed),
                       static_cast<uint8_t*>(feas_k)};
  aff_steer_row_kernel<<<dim3(UM, static_cast<unsigned>(tiles)), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
