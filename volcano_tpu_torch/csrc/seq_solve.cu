// seq_solve: the exact sequential allocate solve.
//
// Replaces the JAX package's jitted `solve` (volcano_tpu/ops/allocate.py:201),
// a `fori_loop(0, P + 1, step)` over job-contiguous task rows (:276-458).
//
// The steps depend on each other: each placement changes the idle, pod,
// port and count planes the next one reads.  But a step changes the node
// planes of one node only (`best`), or, when a job is rolled back, of the
// nodes that job held; and `node_score` reads no other node.  So while a
// run of rows scores the same way, every node's key but the changed ones'
// is the key of the step before.  The design keeps those keys:
//
// - `row_prep_kernel` (a grid, one warp a row, launched before the steps)
//   flags each row: whether it reads an inter-pod term (required affinity,
//   anti-affinity or a nonzero soft weight), whether it matches one, and
//   whether its term rows and its profile planes equal row t - 1's; and it
//   hashes the profile planes.  The profile planes are every plane the
//   node loop reads of a row: req, init_req, sel, aff_bits, aff_terms, tol,
//   pref_bits, pref_w, tports, and the extra_ok / extra_score rows when
//   present.  Compares are exact (float planes by their bits).
// - `seq_solve_kernel`, one persistent block of 512 threads for all P + 1
//   steps (one launch: the host reads nothing until the result), first
//   gives profiles: a row that reads no term and is not equal to the row
//   before it (a head) opens a run; round k takes the first head without a
//   profile and gives profile k to every head with its hash whose planes
//   are equal to its planes, compared word by word -- no row joins a
//   profile without the exact compare.  At most `U` (64) profiles; heads
//   past the cap, and rows that read terms, have none.
// - Each profile u keeps a table over the nodes: per node a 64-bit key
//   (score descending, node ascending, `vtt::make_key` on the score or
//   kNeg), a meta byte (feasible; the static verdict) and the
//   preferred-affinity sum -- the static part (ready, selector, node
//   affinity, taints, preferred terms) changes with no step, so a table
//   update rescores only the dynamic part -- and per chunk of 32 nodes
//   the maximum key and whether any node is feasible.  A log lists every
//   node whose planes a step changed: `best` after each placement or
//   pipeline, each node of a rolled-back job.  A table remembers how far
//   into the log it is current.
// - Warp 0 runs the steps alone: the job boundary (the rollback replays
//   the job's rows in ascending row order, `_undo_job`, :245-274, each
//   slot, port word and count cell owned by one lane), the queue overuse
//   skip, then for a row with a profile: rescore the table's keys of the
//   log entries since it was current (up to 128, one a lane, the last 32
//   from warp 0's register copy of the log, with the same `node_key` a
//   full rescore uses, so the keys are the same bits), recompute their
//   chunks' maxima, take the maximum over the chunks and `any` from their
//   feasible bytes (a kNeg score never decides `any`); then allocate when
//   the task fits the live idle of `best`, else pipeline onto future
//   capacity, and log `best`.  No block barrier.  The next row's fields
//   are loaded a step ahead and each load of a step goes out with the
//   others it does not depend on: a step whose row's profile was used the
//   step before (one new log entry) loads the changed node's planes, its
//   chunk's keys and the chunk maxima together, then the best node's row.
// - The whole block serves what one warp should not: a profile's first
//   table (or a table more than 128 log entries behind: rescored from the
//   log, or rebuilt past Np / 8 entries), a row without a profile (every
//   node scored and reduced, as before), and the term lists of a row (the
//   terms it reads and the terms it matches), compacted once per run of
//   rows with equal term rows, not once per step.
//
// Per step, as the JAX step: feasibility is ready, selector, node-affinity
// alternatives, taints, the fit on FutureIdle ((idle + releasing) -
// pipelined) - pip_extra, pod slots (ntasks + pip_ntasks), ports against
// nports | pip_nports, the inter-pod verdicts (domain -1 reads 0), then
// extra_ok; the score is ((node_score + extra_score) + naff * sum_AP(pref))
// + sum_E(soft * count), each operation rounded on its own (-fmad=false).
// Masked zero adds of the JAX step (x + 0.0 on an inactive step) are
// skipped: they could only turn a -0.0 into +0.0, which no plane holds.
//
// Bound: a solve scores its rows against the N nodes' planes (idle,
// allocatable, releasing, pipelined, pip_extra, label and taint words,
// ~60 float operations a pair).  With the tables a profiled step rescores
// the few nodes the steps since its last use changed; it is bound by the
// latency of warp 0's chain of dependent loads, not by bytes or
// operations.
#include "common.cuh"

using vtt::Weights;

namespace {

// 512 threads leave each 128 registers: the warp-0 step path keeps a node's
// planes in registers without spills (1,024 threads spilled ~1 KB and
// took 30.4 ms against 25.4 on the [seq] solve, tools/port_ab.py --phase
// seq on an H100 80GB HBM3 at 700 W).
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;        // nodes under a chunk maximum
constexpr int kMaxProfiles = 64;  // kernels.SEQ_MAX_PROFILES
constexpr int kWarpReplay = 128;  // log entries warp 0 rescores alone
constexpr int kPrepWarps = 8;     // rows a block of row_prep_kernel flags
constexpr int kFastR = 4;         // slots node_key keeps in registers

// Row flags (row_prep_kernel).
constexpr int kReads = 1;      // reads an inter-pod term
constexpr int kSameProf = 2;   // profile planes equal to row t - 1's
constexpr int kSameTerms = 4;  // term rows equal to row t - 1's
constexpr int kMatches = 8;    // matches an inter-pod term

// What a step asks of the whole block.
constexpr int kNeedLists = 1;  // the row's term lists
constexpr int kNeedFull = 2;   // every node scored (a row without profile)
constexpr int kNeedTable = 4;  // the profile's table brought up to date

// Per-row profile words (pidh): >= 0 a head's profile, -1 none.
constexpr int32_t kFollow = -2;  // the profile of row t - 1
constexpr int32_t kOpen = -3;    // a head not yet given one

struct SeqArgs {
  int N, R, PW, LW, TW, P, A, AP, J, K, E, D;
  // nodes
  const float* idle0;
  const float* alloc;
  const float* rel;
  const float* pip;
  const int32_t* ntasks0;
  const int32_t* max_tasks;
  const uint32_t* ports0;
  const uint8_t* ready;
  const uint32_t* label;
  const uint32_t* taint;
  // tasks
  const float* req;
  const float* init_req;
  const int32_t* job;
  const uint8_t* real;
  const uint32_t* tports;
  const uint32_t* sel;
  const uint32_t* aff_bits;
  const int32_t* aff_terms;
  const uint32_t* tol;
  const uint32_t* pref_bits;
  const float* pref_w;
  // jobs, queues
  const int32_t* queue;
  const int32_t* min_av;
  const int32_t* rbase;
  const float* deserved;
  const float* q_alloc0;
  int Q;
  // weights
  const float* eps;
  const uint8_t* scalar_slot;
  const float* bres;
  Weights w;
  float naff;
  // inter-pod terms
  const int32_t* node_dom;
  const int32_t* term_key;
  const int32_t* cnt0;
  const uint8_t* t_aff;
  const uint8_t* t_anti;
  const uint8_t* t_match;
  const float* t_soft;
  // custom-plugin planes (null when absent)
  const uint8_t* extra_ok;
  const float* extra_score;
  // state and outputs
  float* idle;
  float* pxe;
  int32_t* ntasks;
  int32_t* pnt;
  uint32_t* nports;
  uint32_t* pports;
  int32_t* cnt;
  int32_t* tot;
  float* q_alloc;
  float* q_pip;
  int32_t* assigned;
  int32_t* pipelined;
  int32_t* alloc_cnt;
  uint8_t* never_ready;
  uint8_t* fit_failed;
  // scratch: per row
  uint8_t* flags;
  uint64_t* hash;
  int32_t* pidh;
  int32_t* heads;
  int32_t* log;  // [2P + 1]
  // scratch: the profiles' tables, U x Np (Np = N rounded up to kChunk)
  int U, Np;
  uint64_t* keys;
  uint8_t* meta;   // bit 0 feasible, bit 1 the static verdict
  float* spref;    // the preferred-affinity sum
  uint64_t* cmax;  // [U, Np / kChunk]
  uint8_t* cany;
  // the term lists ([E] each)
  int32_t* rd_e;
  uint8_t* rd_flag;
  int32_t* md_e;
};

struct Block {
  // warp 0's step state, kept here while the block serves a step
  int t;     // the step; P + 1 when the solve is done
  int need;  // kNeed* bits the block serves for step t (0: none)
  int pid;
  int fl;
  int tg;    // first row of the run of equal term rows row t is in
  int prev_job;
  int job_start;
  int job_ready;
  int job_skip;
  int job_overskip;
  int qj;    // the open job's queue, ready base and min_available
  int rb;
  int ma;
  int cur_pid;
  int cur_alloc;
  int log_len;
  // the term lists: the run they belong to, their lengths
  int lists_tg;
  int nr;
  int nm;
  // a full rescore's result
  int best;
  int any;
  int synced[kMaxProfiles];  // log length a table is current to (-1: none)
  int ring[32];              // warp 0's last 32 log entries (lane i mod 32)
  // block helpers
  int base;
  int first;
  int warp_sums[kWarps];
  unsigned long long warp_key[kWarps];
  int warp_any[kWarps];
};

__device__ __forceinline__ unsigned long long umax(unsigned long long x,
                                                   unsigned long long y) {
  return x > y ? x : y;
}

// ---------------------------------------------------------------- rows

// The words of a row's profile planes, in a fixed order.
__device__ __forceinline__ int64_t prof_words(const SeqArgs& a) {
  return 2 * int64_t{a.R} + a.LW + int64_t{a.A} * a.LW + 1 + a.TW +
         int64_t{a.AP} * a.LW + a.AP + a.PW + (a.extra_ok ? a.N : 0) +
         (a.extra_score ? a.N : 0);
}

__device__ uint32_t prof_word(const SeqArgs& a, int64_t t, int64_t i) {
  if (i < a.R) return __float_as_uint(a.req[t * a.R + i]);
  i -= a.R;
  if (i < a.R) return __float_as_uint(a.init_req[t * a.R + i]);
  i -= a.R;
  if (i < a.LW) return a.sel[t * a.LW + i];
  i -= a.LW;
  const int64_t alw = int64_t{a.A} * a.LW;
  if (i < alw) return a.aff_bits[t * alw + i];
  i -= alw;
  if (i == 0) return static_cast<uint32_t>(a.aff_terms[t]);
  i -= 1;
  if (i < a.TW) return a.tol[t * a.TW + i];
  i -= a.TW;
  const int64_t plw = int64_t{a.AP} * a.LW;
  if (i < plw) return a.pref_bits[t * plw + i];
  i -= plw;
  if (i < a.AP) return __float_as_uint(a.pref_w[t * a.AP + i]);
  i -= a.AP;
  if (i < a.PW) return a.tports[t * a.PW + i];
  i -= a.PW;
  if (a.extra_ok) {
    if (i < a.N) return a.extra_ok[t * a.N + i];
    i -= a.N;
  }
  return __float_as_uint(a.extra_score[t * a.N + i]);
}

__device__ __forceinline__ uint64_t mix(uint64_t x) {
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ull;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebull;
  x ^= x >> 31;
  return x;
}

// One warp a row: the row's flags and the hash of its profile planes (a
// sum of mixed (index, word) pairs, so the lanes' order does not matter).
__global__ void __launch_bounds__(kPrepWarps * 32) row_prep_kernel(SeqArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kPrepWarps + (threadIdx.x >> 5);
  if (t >= a.P) return;
  bool reads = false;
  bool matches = false;
  bool same_terms = t > 0;
  const int64_t te = t * a.E;
  for (int e = lane; e < a.E; e += 32) {
    const uint8_t fa = a.t_aff[te + e];
    const uint8_t fn = a.t_anti[te + e];
    const uint8_t fm = a.t_match[te + e];
    const float fs = a.t_soft[te + e];
    reads = reads || fa || fn || fs != 0.0f;
    matches = matches || fm;
    if (t > 0) {
      const int64_t pe = te - a.E + e;
      same_terms = same_terms && a.t_aff[pe] == fa && a.t_anti[pe] == fn &&
                   a.t_match[pe] == fm &&
                   __float_as_uint(a.t_soft[pe]) == __float_as_uint(fs);
    }
  }
  reads = __any_sync(vtt::kFullMask, reads);
  matches = __any_sync(vtt::kFullMask, matches);
  same_terms = __all_sync(vtt::kFullMask, same_terms);
  const int64_t W = prof_words(a);
  uint64_t h = 0;
  bool same = t > 0;
  for (int64_t i = lane; i < W; i += 32) {
    const uint32_t w = prof_word(a, t, i);
    h += mix((static_cast<uint64_t>(i) << 32) | w);
    if (t > 0) same = same && prof_word(a, t - 1, i) == w;
  }
  for (int off = 16; off > 0; off >>= 1) {
    h += __shfl_xor_sync(vtt::kFullMask, h, off);
  }
  same = __all_sync(vtt::kFullMask, same);
  if (lane == 0) {
    a.flags[t] = static_cast<uint8_t>((reads ? kReads : 0) |
                                      (same ? kSameProf : 0) |
                                      (same_terms ? kSameTerms : 0) |
                                      (matches ? kMatches : 0));
    a.hash[t] = h;
  }
}

__device__ __forceinline__ bool profiled(const SeqArgs& a, int t) {
  return a.real[t] && !(a.flags[t] & kReads);
}

__device__ __forceinline__ bool is_head(const SeqArgs& a, int t) {
  return profiled(a, t) &&
         !(t > 0 && (a.flags[t] & kSameProf) && profiled(a, t - 1));
}

// Rows t and r equal on every profile word (one thread; eight words of
// each row loaded at once, so a long row costs W / 8 round trips).
__device__ bool rows_equal(const SeqArgs& a, int t, int r) {
  if (t == r) return true;
  const int64_t W = prof_words(a);
  for (int64_t i = 0; i < W; i += 8) {
    uint32_t x[8];
    uint32_t y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[j] = i + j < W ? prof_word(a, t, i + j) : 0u;
      y[j] = i + j < W ? prof_word(a, r, i + j) : 0u;
    }
    bool same = true;
#pragma unroll
    for (int j = 0; j < 8; ++j) same = same & (x[j] == y[j]);
    if (!same) return false;
  }
  return true;
}

// A row's planes, as the node loop reads them.
struct Row {
  const float* rq;
  const float* irq;
  const uint32_t* sel;
  const uint32_t* tol;
  const uint32_t* aff;
  const uint32_t* pref;
  const float* pw;
  const uint32_t* tp;
  int nterms;
  int64_t te;  // t * E
  int64_t tn;  // t * N
};

__device__ __forceinline__ Row row_of(const SeqArgs& a, int t) {
  const int64_t tt = t;
  return Row{a.req + tt * a.R,
             a.init_req + tt * a.R,
             a.sel + tt * a.LW,
             a.tol + tt * a.TW,
             a.aff_bits + tt * a.A * a.LW,
             a.pref_bits + tt * a.AP * a.LW,
             a.pref_w + tt * a.AP,
             a.tports + tt * a.PW,
             a.aff_terms[t],
             tt * a.E,
             tt * a.N};
}

// The static verdict and preferred-affinity sum of node n for a row: they
// change with no step, so a profile's table keeps them.
__device__ __forceinline__ vtt::StaticPair node_static(const SeqArgs& a,
                                                      const Row& r, int n) {
  return vtt::static_pair(
      a.ready[n] != 0, a.label + static_cast<int64_t>(n) * a.LW,
      a.taint + static_cast<int64_t>(n) * a.TW, a.LW, a.TW, r.sel, r.aff,
      a.A, r.nterms, r.tol, r.pref, r.pw, a.AP);
}

// The soft-term sum of node n for a row (`nr` read terms in rd_e /
// rd_flag), and the required terms' verdict ANDed into `feas`.
__device__ __forceinline__ float soft_terms(const SeqArgs& a, const Row& r,
                                           int n, int nr, bool& feas) {
  float soft = 0.0f;
  for (int i = 0; i < nr; ++i) {
    const int e = a.rd_e[i];
    const int fl = a.rd_flag[i];
    const int dom = a.node_dom[static_cast<int64_t>(n) * a.K + a.term_key[e]];
    const int32_t cv = dom < 0 ? 0 : a.cnt[static_cast<int64_t>(e) * a.D + dom];
    if ((fl & 1) && !(cv > 0 || (fl & 4))) feas = false;
    if ((fl & 2) && cv != 0) feas = false;
    soft = soft + a.t_soft[r.te + e] * static_cast<float>(cv);
  }
  return soft;
}

// node_key (below) for 2 <= R <= kR slots: every plane of node n and of
// the row is loaded into registers before any is used, so the key waits
// on one round trip to the node's planes, not one per slot loop.  The
// arithmetic is common.cuh's (vtt::future_slot, vtt::slot_le,
// vtt::node_score_at), as on the general path.
template <int kR>
__device__ __forceinline__ unsigned long long node_key_r(
    const SeqArgs& a, const Row& r, int n, int nr, vtt::StaticPair st,
    bool& ok) {
  const int R = a.R;
  const bool fut = a.rel != nullptr;
  float idle[kR], alloc[kR], rel[kR], pip[kR], pxe[kR], rq[kR], irq[kR];
#pragma unroll
  for (int s = 0; s < kR; ++s) {
    const bool in = s < R;
    const int64_t i = static_cast<int64_t>(n) * R + s;
    idle[s] = in ? a.idle[i] : 0.0f;
    alloc[s] = in ? a.alloc[i] : 0.0f;
    rel[s] = in && fut ? a.rel[i] : 0.0f;
    pip[s] = in && fut ? a.pip[i] : 0.0f;
    pxe[s] = in && fut ? a.pxe[i] : 0.0f;
    rq[s] = in ? r.rq[s] : 0.0f;
    irq[s] = in ? r.irq[s] : 0.0f;
  }
  const int32_t max_t = a.max_tasks[n];
  const int32_t used_t = a.ntasks[n] + a.pnt[n];
  const bool xok = a.extra_ok ? a.extra_ok[r.tn + n] != 0 : true;
  const float xs = a.extra_score ? a.extra_score[r.tn + n] : 0.0f;
  const bool clash = vtt::ports_clash(r.tp, a.nports, a.pports, n, a.PW);
  bool fit = true;
#pragma unroll
  for (int s = 0; s < kR; ++s) {
    if (s >= R) break;
    const float fi =
        vtt::future_slot(idle[s], rel[s], pip[s], pxe[s], fut, true);
    fit = fit && vtt::slot_le(irq[s], fi, a.eps, a.scalar_slot, s);
  }
  bool feas = st.ok;
  feas = feas & fit;
  feas = feas & (max_t <= 0 || used_t < max_t);
  feas = feas & !clash;
  const float soft = soft_terms(a, r, n, nr, feas);
  feas = feas & xok;
  float score = vtt::node_score_at<kR>(rq, alloc, idle, a.bres, R, a.w);
  if (a.extra_score) score = score + xs;
  score = score + a.naff * st.pref;
  score = score + soft;
  ok = feas;
  return vtt::make_key(feas ? score : vtt::kNeg, static_cast<uint32_t>(n));
}

// Node n's key for a row from its static part `st` (`nr` read terms in
// rd_e / rd_flag; 0 for a row with a profile) and whether n is feasible:
// the one scoring of every path, full rescores and table updates alike.
// Every load is issued before a verdict is decided (no short-circuit);
// with 2 to 4 slots the planes go to registers first (node_key_r).
__device__ __forceinline__ unsigned long long node_key(
    const SeqArgs& a, const Row& r, int n, int nr, vtt::StaticPair st,
    bool& ok) {
  if (a.R >= 2 && a.R <= kFastR) {
    return node_key_r<kFastR>(a, r, n, nr, st, ok);
  }
  float fi[vtt::kMaxR];
  vtt::future_idle(a.idle, a.rel, a.pip, a.pxe, n, a.R, fi);
  const int32_t max_t = a.max_tasks[n];
  const int32_t used_t = a.ntasks[n] + a.pnt[n];
  const bool clash = vtt::ports_clash(r.tp, a.nports, a.pports, n, a.PW);
  const bool xok = a.extra_ok ? a.extra_ok[r.tn + n] != 0 : true;
  const float xs = a.extra_score ? a.extra_score[r.tn + n] : 0.0f;
  bool feas = st.ok;
  feas = feas & vtt::less_equal(r.irq, fi, a.eps, a.scalar_slot, a.R);
  feas = feas & (max_t <= 0 || used_t < max_t);
  feas = feas & !clash;
  const float soft = soft_terms(a, r, n, nr, feas);
  feas = feas & xok;
  float score = vtt::node_score(r.rq, a.alloc + static_cast<int64_t>(n) * a.R,
                                a.idle + static_cast<int64_t>(n) * a.R,
                                a.bres, a.R, a.w);
  if (a.extra_score) score = score + xs;
  score = score + a.naff * st.pref;
  score = score + soft;
  ok = feas;
  return vtt::make_key(feas ? score : vtt::kNeg, static_cast<uint32_t>(n));
}

// ---------------------------------------------------------------- tables

// Table u's entry of node n (n < N), from the static part `st`: the key,
// and the meta byte (bit 0 feasible, bit 1 the static verdict).
__device__ __forceinline__ void set_key(const SeqArgs& a, int u, const Row& r,
                                        int n, vtt::StaticPair st) {
  bool ok = false;
  const unsigned long long key = node_key(a, r, n, 0, st, ok);
  const int64_t i = static_cast<int64_t>(u) * a.Np + n;
  a.keys[i] = key;
  a.meta[i] = static_cast<uint8_t>((ok ? 1 : 0) | (st.ok ? 2 : 0));
}

// The static part table u keeps for node n.
__device__ __forceinline__ vtt::StaticPair kept_static(const SeqArgs& a,
                                                      int u, int n) {
  const int64_t i = static_cast<int64_t>(u) * a.Np + n;
  return vtt::StaticPair{(a.meta[i] & 2) != 0, a.spref[i]};
}

// Chunk c's maximum key and any-feasible, from its 32 keys (one thread).
__device__ __forceinline__ void chunk_max(const SeqArgs& a, int u, int c) {
  const int64_t base = static_cast<int64_t>(u) * a.Np +
                       static_cast<int64_t>(c) * kChunk;
  const ulonglong2* k = reinterpret_cast<const ulonglong2*>(a.keys + base);
  unsigned long long m = 0ull;
#pragma unroll
  for (int i = 0; i < kChunk / 2; ++i) {
    const ulonglong2 v = k[i];
    m = umax(m, umax(v.x, v.y));
  }
  const uint4* f = reinterpret_cast<const uint4*>(a.meta + base);
  const uint4 f0 = f[0];
  const uint4 f1 = f[1];
  const int64_t ci = static_cast<int64_t>(u) * (a.Np / kChunk) + c;
  a.cmax[ci] = m;
  a.cany[ci] = ((f0.x | f0.y | f0.z | f0.w | f1.x | f1.y | f1.z | f1.w) &
                0x01010101u) != 0u;
}

// Table u rescored on the log entries [from, to) by the block: the keys
// of their nodes from the kept static parts, then their chunks' maxima.
// A node logged twice is rescored twice, and a chunk shared by two entries
// is recomputed twice, to the same values.
__device__ void block_replay(const SeqArgs& a, int u, const Row& r, int from,
                             int to) {
  for (int i = from + threadIdx.x; i < to; i += kThreads) {
    const int n = a.log[i];
    set_key(a, u, r, n, kept_static(a, u, n));
  }
  __syncthreads();
  for (int i = from + threadIdx.x; i < to; i += kThreads) {
    chunk_max(a, u, a.log[i] / kChunk);
  }
  __syncthreads();
}

// Table u scored on every node by the block, its static parts kept.
__device__ void rebuild(const SeqArgs& a, int u, const Row& r) {
  for (int n = threadIdx.x; n < a.Np; n += kThreads) {
    const int64_t i = static_cast<int64_t>(u) * a.Np + n;
    if (n < a.N) {
      const vtt::StaticPair st = node_static(a, r, n);
      a.spref[i] = st.pref;
      set_key(a, u, r, n, st);
    } else {
      a.keys[i] = 0ull;
      a.meta[i] = 0;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < a.Np / kChunk; c += kThreads) {
    chunk_max(a, u, c);
  }
  __syncthreads();
}

// The best key of table u over its chunks, and any-feasible (warp 0,
// every lane gets both).
__device__ __forceinline__ void warp_select(const SeqArgs& a, int u,
                                            int& best, int& any) {
  const int lane = threadIdx.x & 31;
  const int C = a.Np / kChunk;
  const int64_t base = static_cast<int64_t>(u) * C;
  unsigned long long k = 0ull;
  int an = 0;
  // Unrolled: a lane's chunk maxima are loaded eight at a time.
#pragma unroll 8
  for (int c = lane; c < C; c += 32) {
    k = umax(k, a.cmax[base + c]);
    an |= a.cany[base + c];
  }
  for (int off = 16; off > 0; off >>= 1) {
    k = umax(k, __shfl_xor_sync(vtt::kFullMask, k, off));
  }
  any = __any_sync(vtt::kFullMask, an) ? 1 : 0;
  best = static_cast<int>(0xFFFFFFFFu -
                          static_cast<uint32_t>(k & 0xFFFFFFFFull));
}

// ---------------------------------------------------------------- block

// Appends the indices i in [0, n) with pred(i) to `out` in ascending order
// and returns their count.  Called by every thread of the block.
template <typename Pred>
__device__ int block_compact(int n, Pred pred, int32_t* out, Block& sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) sh.base = 0;
  __syncthreads();
  for (int start = 0; start < n; start += kThreads) {
    const int i = start + threadIdx.x;
    const bool sel = i < n && pred(i);
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, sel);
    if (lane == 0) sh.warp_sums[warp] = __popc(ballot);
    __syncthreads();
    int before = 0;
    int total = 0;
    for (int k = 0; k < kWarps; ++k) {
      if (k < warp) before += sh.warp_sums[k];
      total += sh.warp_sums[k];
    }
    if (sel) out[sh.base + before + __popc(ballot & ((1u << lane) - 1u))] = i;
    __syncthreads();
    if (threadIdx.x == 0) sh.base += total;
    __syncthreads();
  }
  const int count = sh.base;
  __syncthreads();
  return count;
}

// Profiles for the heads (see the header): round k gives profile k to the
// first head without one and to every later head equal to it.
__device__ void assign_profiles(const SeqArgs& a, Block& sh) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H = block_compact(
      a.P, [&](int t) { return is_head(a, t); }, a.heads, sh);
  for (int t = tid; t < a.P; t += kThreads) {
    a.pidh[t] = !profiled(a, t) ? -1 : (is_head(a, t) ? kOpen : kFollow);
  }
  if (tid == 0) sh.first = 0;
  __syncthreads();
  for (int k = 0; k < a.U; ++k) {
    // Every head before sh.first has its profile.
    int mine = 0x7FFFFFFF;
    for (int h = sh.first + tid; h < H; h += kThreads) {
      if (a.pidh[a.heads[h]] == kOpen) {
        mine = h;
        break;
      }
    }
    mine = __reduce_min_sync(vtt::kFullMask, mine);
    if (lane == 0) sh.warp_sums[warp] = mine;
    __syncthreads();
    if (tid == 0) {
      int m = 0x7FFFFFFF;
      for (int w = 0; w < kWarps; ++w) m = min(m, sh.warp_sums[w]);
      sh.first = m;
    }
    __syncthreads();
    const int f = sh.first;
    if (f >= H) break;
    const int r = a.heads[f];
    const uint64_t hr = a.hash[r];
    for (int h = f + tid; h < H; h += kThreads) {
      const int t = a.heads[h];
      if (a.pidh[t] == kOpen && a.hash[t] == hr && rows_equal(a, t, r)) {
        a.pidh[t] = k;
      }
    }
    __syncthreads();
  }
  for (int h = tid; h < H; h += kThreads) {
    if (a.pidh[a.heads[h]] == kOpen) a.pidh[a.heads[h]] = -1;
  }
  __syncthreads();
}

// Every node scored for row t (a row without profile): the best key and
// any-feasible into sh.best / sh.any.
__device__ void full_select(const SeqArgs& a, Block& sh, int t) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Row r = row_of(a, t);
  const int nr = (sh.fl & kReads) ? sh.nr : 0;
  for (int i = tid; i < nr; i += kThreads) {
    const int e = a.rd_e[i];
    // bit 0: required affinity, bit 1: anti-affinity, bit 2: the
    // self-match rule holds (no match anywhere and the task matches).
    a.rd_flag[i] = (a.t_aff[r.te + e] ? 1 : 0) |
                   (a.t_anti[r.te + e] ? 2 : 0) |
                   ((a.tot[e] == 0 && a.t_match[r.te + e]) ? 4 : 0);
  }
  __syncthreads();
  unsigned long long best_key = 0ull;
  int any = 0;
  for (int n = tid; n < a.N; n += kThreads) {
    bool ok = false;
    const unsigned long long key =
        node_key(a, r, n, nr, node_static(a, r, n), ok);
    best_key = umax(best_key, key);
    any |= ok ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1) {
    best_key = umax(best_key, __shfl_down_sync(0xFFFFFFFFu, best_key, off));
  }
  any = __any_sync(0xFFFFFFFFu, any) ? 1 : 0;
  if (lane == 0) {
    sh.warp_key[warp] = best_key;
    sh.warp_any[warp] = any;
  }
  __syncthreads();
  if (tid == 0) {
    unsigned long long k = 0ull;
    int an = 0;
    for (int i = 0; i < kWarps; ++i) {
      k = umax(k, sh.warp_key[i]);
      an |= sh.warp_any[i];
    }
    sh.best = static_cast<int>(0xFFFFFFFFu -
                               static_cast<uint32_t>(k & 0xFFFFFFFFull));
    sh.any = an;
  }
  __syncthreads();
}

// What the block does for step sh.t (sh.need).
__device__ void serve_step(const SeqArgs& a, Block& sh) {
  const int tid = threadIdx.x;
  const int t = sh.t;
  const int need = sh.need;
  if (need & kNeedLists) {
    const int64_t te = static_cast<int64_t>(t) * a.E;
    const int nr = block_compact(
        a.E,
        [&](int e) {
          return a.t_aff[te + e] || a.t_anti[te + e] ||
                 a.t_soft[te + e] != 0.0f;
        },
        a.rd_e, sh);
    const int nm = block_compact(
        a.E, [&](int e) { return a.t_match[te + e] != 0; }, a.md_e, sh);
    if (tid == 0) {
      sh.nr = nr;
      sh.nm = nm;
      sh.lists_tg = sh.tg;
    }
    __syncthreads();
  }
  if (need & kNeedFull) full_select(a, sh, t);
  if (need & kNeedTable) {
    const int u = sh.pid;
    const int from = sh.synced[u];
    const int to = sh.log_len;
    const Row r = row_of(a, t);
    if (from < 0 || to - from >= a.Np / 8) {
      rebuild(a, u, r);
    } else {
      block_replay(a, u, r, from, to);
    }
    if (tid == 0) sh.synced[u] = to;
    __syncthreads();
  }
}

// ---------------------------------------------------------------- warp 0

// Appends node n to the log: lane 0 writes it, and the lane of its index
// mod 32 keeps it in `ring`, warp 0's register copy of the last 32
// entries.
__device__ __forceinline__ void log_node(const SeqArgs& a, int n,
                                         int& log_len, int& ring) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) a.log[log_len] = n;
  if (lane == (log_len & 31)) ring = n;
  ++log_len;
}

// ops/resreq.py less_equal of l <= r over the warp: lane s < R holds slot
// s of each; every lane gets the AND over the slots.
__device__ __forceinline__ bool warp_less_equal(const SeqArgs& a, float l,
                                                float r) {
  const int lane = threadIdx.x & 31;
  const bool ok =
      lane >= a.R || vtt::slot_le(l, r, a.eps, a.scalar_slot, lane);
  return __all_sync(vtt::kFullMask, ok);
}

// Rolls back the allocations of job rows [start, end) (`_undo_job`) and
// logs their nodes.  Each address is owned by one lane across the rows:
// slot s of idle and of the queue row by lane s, ntasks by lane 0, port
// word w by lane w mod 32, term e's count cells and total by lane e mod 32.
__device__ void warp_undo(const SeqArgs& a, int start, int end, int qj,
                          int& log_len, int& ring) {
  const int lane = threadIdx.x & 31;
  for (int u = start; u < end; ++u) {
    const int n = a.assigned[u];
    if (n < 0) continue;
    if (lane < a.R) {
      const int64_t s = static_cast<int64_t>(n) * a.R + lane;
      const float r = a.req[static_cast<int64_t>(u) * a.R + lane];
      a.idle[s] = a.idle[s] + r;
      const int64_t q = static_cast<int64_t>(qj) * a.R + lane;
      a.q_alloc[q] = a.q_alloc[q] + (-r);
    }
    if (lane == 0) a.ntasks[n] -= 1;
    log_node(a, n, log_len, ring);
    for (int w = lane; w < a.PW; w += 32) {
      a.nports[static_cast<int64_t>(n) * a.PW + w] &=
          ~a.tports[static_cast<int64_t>(u) * a.PW + w];
    }
    for (int e = lane; e < a.E; e += 32) {
      if (!a.t_match[static_cast<int64_t>(u) * a.E + e]) continue;
      const int dom = a.node_dom[static_cast<int64_t>(n) * a.K + a.term_key[e]];
      if (dom < 0) continue;
      a.cnt[static_cast<int64_t>(e) * a.D + dom] -= 1;
      a.tot[e] -= 1;
    }
  }
  __syncwarp();
}

// The node of log entry i < to: from `ring` (lane i mod 32) for the last
// 32 entries, else from the log.  Every lane of warp 0 calls it.
__device__ __forceinline__ int logged_node(const SeqArgs& a, int i, int to,
                                           int ring) {
  const int rn = __shfl_sync(vtt::kFullMask, ring, i & 31);
  return i >= to - 32 ? rn : a.log[i];
}

// Table u rescored by warp 0 on the log entries [from, to) (at most
// kWarpReplay): each entry's node from the kept static part, a lane an
// entry, then their chunks' maxima.
__device__ void warp_replay(const SeqArgs& a, int u, const Row& r, int from,
                            int to, int ring) {
  const int lane = threadIdx.x & 31;
  for (int i0 = from; i0 < to; i0 += 32) {
    const int i = i0 + lane;
    const int n = logged_node(a, i, to, ring);
    if (i < to) set_key(a, u, r, n, kept_static(a, u, n));
  }
  __syncwarp();
  for (int i0 = from; i0 < to; i0 += 32) {
    const int i = i0 + lane;
    const int n = logged_node(a, i, to, ring);
    if (i < to) chunk_max(a, u, n / kChunk);
  }
  __syncwarp();
}

// Warp 0's step on table u when one log entry, node n, is new since the
// table was current: n's key rescored (by every lane, the same bits), its
// chunk's maximum from the chunk's other kept keys, and the best over the
// chunks.  The chunk's keys and the first 32 chunk maxima are loaded
// before n's planes, so the three go out together.
__device__ void warp_update1(const SeqArgs& a, int u, const Row& r, int n,
                             int& best, int& any) {
  const int lane = threadIdx.x & 31;
  const int C = a.Np / kChunk;
  const int c = n / kChunk;
  const int64_t cb = static_cast<int64_t>(u) * C;
  const int64_t slot = static_cast<int64_t>(u) * a.Np +
                       static_cast<int64_t>(c) * kChunk + lane;
  const unsigned long long kc_old = a.keys[slot];
  const int mc_old = a.meta[slot];
  const bool pre = lane < C && lane != c;
  const unsigned long long k0 = pre ? a.cmax[cb + lane] : 0ull;
  const int a0 = pre ? a.cany[cb + lane] : 0;
  bool ok = false;
  const vtt::StaticPair st = kept_static(a, u, n);
  const unsigned long long key = node_key(a, r, n, 0, st, ok);
  const bool own = lane == (n & (kChunk - 1));
  if (own) {
    a.keys[slot] = key;
    a.meta[slot] = static_cast<uint8_t>((ok ? 1 : 0) | (st.ok ? 2 : 0));
  }
  unsigned long long cm = own ? key : kc_old;
  for (int off = 16; off > 0; off >>= 1) {
    cm = umax(cm, __shfl_xor_sync(vtt::kFullMask, cm, off));
  }
  const int cf = __any_sync(vtt::kFullMask, own ? ok : (mc_old & 1)) ? 1 : 0;
  if (lane == 0) {
    a.cmax[cb + c] = cm;
    a.cany[cb + c] = static_cast<uint8_t>(cf);
  }
  unsigned long long k = umax(k0, cm);
  int an = a0 | cf;
#pragma unroll 8
  for (int cc = lane + 32; cc < C; cc += 32) {
    if (cc == c) continue;
    k = umax(k, a.cmax[cb + cc]);
    an |= a.cany[cb + cc];
  }
  for (int off = 16; off > 0; off >>= 1) {
    k = umax(k, __shfl_xor_sync(vtt::kFullMask, k, off));
  }
  any = __any_sync(vtt::kFullMask, an) ? 1 : 0;
  best = static_cast<int>(0xFFFFFFFFu -
                          static_cast<uint32_t>(k & 0xFFFFFFFFull));
}

// A row's fields the step loop reads first, loaded a step ahead.
struct RowMeta {
  int real;
  int job;
  int flags;
  int pidh;
};

__device__ __forceinline__ RowMeta row_meta(const SeqArgs& a, int t) {
  if (t >= a.P) return RowMeta{0, -1, 0, -1};
  return RowMeta{a.real[t], a.job[t], a.flags[t], a.pidh[t]};
}

// Warp 0 runs steps from sh.t until one needs the block (sh.need set,
// sh.t that step) or the solve is done (sh.t = P + 1).  Entered with
// sh.need set, the block has served step sh.t's needs.
__device__ void warp_steps(const SeqArgs& a, Block& sh) {
  const int lane = threadIdx.x & 31;
  const int R = a.R;
  int t = sh.t;
  int need = sh.need;
  int pid = sh.pid;
  int fl = sh.fl;
  int tg = sh.tg;
  int prev_job = sh.prev_job;
  int job_start = sh.job_start;
  int job_ready = sh.job_ready;
  int job_skip = sh.job_skip;
  int job_overskip = sh.job_overskip;
  int qj = sh.qj;
  int rb = sh.rb;
  int ma = sh.ma;
  int cur_pid = sh.cur_pid;
  int cur_alloc = sh.cur_alloc;
  int log_len = sh.log_len;
  int ring = sh.ring[lane];
  bool stop = false;
  RowMeta cur = row_meta(a, t);
  RowMeta nxt;
  for (; t <= a.P; ++t, cur = nxt) {
    nxt = row_meta(a, t + 1);
    const int tt = t < a.P ? t : a.P - 1;
    const bool is_pad = t >= a.P || !cur.real;
    const int jt = is_pad ? -1 : cur.job;
    if (!need) {
      // ---- the row's profile and term run -------------------------------
      if (t < a.P) {
        fl = cur.flags;
        pid = cur.pidh == kFollow ? cur_pid : cur.pidh;
        cur_pid = pid;
        if (!(fl & kSameTerms)) tg = t;
      }
      // ---- job boundary: close the previous job, open this one ----------
      if (jt != prev_job) {
        if (prev_job >= 0 && !job_ready && !job_overskip) {
          warp_undo(a, job_start, t, qj, log_len, ring);
          if (lane == 0) a.never_ready[prev_job] = 1;
        }
        int rbj = 0;
        int maj = 0;
        int acj = 0;
        if (jt >= 0) {
          rbj = a.rbase[jt];
          maj = a.min_av[jt];
          acj = a.alloc_cnt[jt];
        }
        const int qo = a.queue[jt > 0 ? jt : 0];
        float qt = 0.0f;
        float des = 0.0f;
        if (lane < R) {
          const int64_t q = static_cast<int64_t>(qo) * R + lane;
          qt = a.q_alloc[q] + a.q_pip[q];
          des = a.deserved[q];
        }
        const bool overused = !warp_less_equal(a, qt, des);
        job_start = t;
        job_skip = job_overskip = (jt < 0 || overused) ? 1 : 0;
        job_ready = (jt >= 0 && rbj >= maj) ? 1 : 0;
        qj = qo;
        rb = rbj;
        ma = maj;
        cur_alloc = acj;
        prev_job = jt;
      }
      if (is_pad || job_skip) continue;
      // ---- what the block must do first ---------------------------------
      const bool lists = (fl & kMatches) || (pid < 0 && (fl & kReads));
      int nd = 0;
      if (lists && sh.lists_tg != tg) nd |= kNeedLists;
      if (pid < 0) {
        nd |= kNeedFull;
      } else if (sh.synced[pid] < 0 ||
                 log_len - sh.synced[pid] > kWarpReplay) {
        nd |= kNeedTable;
      }
      if (nd) {
        need = nd;
        stop = true;
        break;
      }
    }
    need = 0;
    // ---- the best node -------------------------------------------------
    int best;
    int any;
    if (pid >= 0) {
      const int from = sh.synced[pid];
      const Row r = row_of(a, tt);
      if (from == log_len - 1) {
        warp_update1(a, pid, r, logged_node(a, from, log_len, ring), best,
                     any);
      } else {
        if (from < log_len) warp_replay(a, pid, r, from, log_len, ring);
        warp_select(a, pid, best, any);
      }
      if (lane == 0) sh.synced[pid] = log_len;
      __syncwarp();
    } else {
      best = sh.best;
      any = sh.any;
    }
    if (!any) {
      // No feasible node: abort the rest of the job.
      if (lane == 0) a.fit_failed[jt] = 1;
      job_skip = 1;
      continue;
    }
    // ---- allocate, or pipeline onto future capacity --------------------
    // Lane s < R holds slot s of the best node's idle, the request and the
    // queue row; the loads go out together.
    const int64_t s = static_cast<int64_t>(best) * R + lane;
    const int64_t q = static_cast<int64_t>(qj) * R + lane;
    float idle_s = 0.0f;
    float req_s = 0.0f;
    float ireq_s = 0.0f;
    float qa_s = 0.0f;
    if (lane < R) {
      idle_s = a.idle[s];
      req_s = a.req[static_cast<int64_t>(tt) * R + lane];
      ireq_s = a.init_req[static_cast<int64_t>(tt) * R + lane];
      qa_s = a.q_alloc[q];
    }
    const int nt_best = lane == 0 ? a.ntasks[best] : 0;
    const bool alloc = warp_less_equal(a, ireq_s, idle_s);
    if (lane < R) {
      if (alloc) {
        a.idle[s] = idle_s + (-req_s);
        a.q_alloc[q] = qa_s + req_s;
      } else {
        a.pxe[s] = a.pxe[s] + req_s;
        a.q_pip[q] = a.q_pip[q] + req_s;
      }
    }
    const uint32_t* tp = a.tports + static_cast<int64_t>(tt) * a.PW;
    for (int w = lane; w < a.PW; w += 32) {
      const int64_t i = static_cast<int64_t>(best) * a.PW + w;
      if (alloc) {
        a.nports[i] |= tp[w];
      } else {
        a.pports[i] |= tp[w];
      }
    }
    if (fl & kMatches) {
      for (int i = lane; i < sh.nm; i += 32) {
        const int e = a.md_e[i];
        const int dom =
            a.node_dom[static_cast<int64_t>(best) * a.K + a.term_key[e]];
        if (dom < 0) continue;
        a.cnt[static_cast<int64_t>(e) * a.D + dom] += 1;
        a.tot[e] += 1;
      }
    }
    if (lane == 0) {
      if (alloc) {
        a.ntasks[best] = nt_best + 1;
        a.assigned[tt] = best;
        a.alloc_cnt[jt] = cur_alloc + 1;
      } else {
        a.pnt[best] += 1;
        a.pipelined[tt] = best;
      }
    }
    log_node(a, best, log_len, ring);
    if (alloc) {
      ++cur_alloc;
      if (rb + cur_alloc >= ma) job_ready = 1;
    }
    __syncwarp();
  }
  sh.ring[lane] = ring;
  if (lane == 0) {
    sh.t = t;
    sh.need = stop ? need : 0;
    sh.pid = pid;
    sh.fl = fl;
    sh.tg = tg;
    sh.prev_job = prev_job;
    sh.job_start = job_start;
    sh.job_ready = job_ready;
    sh.job_skip = job_skip;
    sh.job_overskip = job_overskip;
    sh.qj = qj;
    sh.rb = rb;
    sh.ma = ma;
    sh.cur_pid = cur_pid;
    sh.cur_alloc = cur_alloc;
    sh.log_len = log_len;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads) seq_solve_kernel(SeqArgs a) {
  __shared__ Block sh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int N = a.N;
  const int R = a.R;

  // ---- initial state -------------------------------------------------
  for (int64_t i = tid; i < static_cast<int64_t>(N) * R; i += kThreads) {
    a.idle[i] = a.idle0[i];
    a.pxe[i] = 0.0f;
  }
  for (int n = tid; n < N; n += kThreads) {
    a.ntasks[n] = a.ntasks0[n];
    a.pnt[n] = 0;
  }
  for (int64_t i = tid; i < static_cast<int64_t>(N) * a.PW; i += kThreads) {
    a.nports[i] = a.ports0[i];
    a.pports[i] = 0u;
  }
  for (int64_t i = tid; i < static_cast<int64_t>(a.E) * a.D; i += kThreads) {
    a.cnt[i] = a.cnt0[i];
  }
  for (int e = tid; e < a.E; e += kThreads) {
    int32_t s = 0;
    for (int d = 0; d < a.D; ++d) s += a.cnt0[static_cast<int64_t>(e) * a.D + d];
    a.tot[e] = s;
  }
  for (int i = tid; i < a.Q * R; i += kThreads) {
    a.q_alloc[i] = a.q_alloc0[i];
    a.q_pip[i] = 0.0f;
  }
  for (int p = tid; p < a.P; p += kThreads) {
    a.assigned[p] = -1;
    a.pipelined[p] = -1;
  }
  for (int j = tid; j < a.J; j += kThreads) {
    a.alloc_cnt[j] = 0;
    a.never_ready[j] = 0;
    a.fit_failed[j] = 0;
  }
  for (int u = tid; u < kMaxProfiles; u += kThreads) sh.synced[u] = -1;
  if (tid < 32) sh.ring[tid] = 0;
  if (tid == 0) {
    sh.t = 0;
    sh.need = 0;
    sh.pid = -1;
    sh.fl = 0;
    sh.tg = 0;
    sh.prev_job = -1;
    sh.job_start = 0;
    sh.job_ready = 1;
    sh.job_skip = 1;
    sh.job_overskip = 1;
    sh.qj = 0;
    sh.rb = 0;
    sh.ma = 0;
    sh.cur_pid = -1;
    sh.cur_alloc = 0;
    sh.log_len = 0;
    sh.lists_tg = -1;
    sh.nr = 0;
    sh.nm = 0;
  }
  __syncthreads();
  assign_profiles(a, sh);

  // ---- the steps: warp 0, and the block when a step needs it ----------
  for (;;) {
    if (warp == 0) warp_steps(a, sh);
    __syncthreads();
    if (sh.t > a.P) break;
    serve_step(a, sh);
    __syncthreads();
  }

  // ---- clear the assignments of discarded jobs; q_alloc + q_pip ----------
  for (int p = tid; p < a.P; p += kThreads) {
    const int j = a.job[p] > 0 ? a.job[p] : 0;
    if (a.real[p] && a.never_ready[j]) a.assigned[p] = -1;
  }
  for (int i = tid; i < a.Q * R; i += kThreads) {
    a.q_alloc[i] = a.q_alloc[i] + a.q_pip[i];
  }
}

}  // namespace

// Scratch (kernels.seq_scratch): flags [P] u8, hash [P] u64, pidh / heads
// [P] i32, log [2P + 1] i32, and the U profile tables over Np nodes (Np = N
// rounded up to 32, U <= 64): keys [U, Np] u64, meta [U, Np] u8, spref
// [U, Np] f32, cmax [U, Np / 32] u64, cany [U, Np / 32] u8; the term lists
// rd_e / md_e [E] i32, rd_flag [E] u8.
extern "C" int vtt_seq_solve(
    int N, int R, int PW, int LW, int TW, int P, int A, int AP, int J, int Q,
    int K, int E, int D, const void* idle0, const void* alloc,
    const void* rel, const void* pip, const void* ntasks0,
    const void* max_tasks, const void* ports0, const void* ready,
    const void* label, const void* taint, const void* req,
    const void* init_req, const void* job, const void* real,
    const void* tports, const void* sel, const void* aff_bits,
    const void* aff_terms, const void* tol, const void* pref_bits,
    const void* pref_w, const void* queue, const void* min_av,
    const void* rbase, const void* deserved, const void* q_alloc0,
    const void* eps, const void* scalar_slot, const void* bres, float bw,
    float lw, float mw, float balw, float naff, const void* node_dom,
    const void* term_key, const void* cnt0, const void* t_aff,
    const void* t_anti, const void* t_match, const void* t_soft,
    const void* extra_ok, const void* extra_score, void* idle, void* pxe,
    void* ntasks, void* pnt, void* nports, void* pports, void* cnt,
    void* tot, void* q_alloc, void* q_pip, void* assigned, void* pipelined,
    void* alloc_cnt, void* never_ready, void* fit_failed, void* flags,
    void* hash, void* pidh, void* heads, void* log, int U, int Np,
    void* keys, void* meta, void* spref, void* cmax, void* cany,
    void* rd_e, void* rd_flag, void* md_e, void* stream) {
  if (R > vtt::kMaxR || P < 1 || N < 1 || U < 0 || U > kMaxProfiles ||
      Np < N || Np % kChunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SeqArgs a;
  a.N = N;
  a.R = R;
  a.PW = PW;
  a.LW = LW;
  a.TW = TW;
  a.P = P;
  a.A = A;
  a.AP = AP;
  a.J = J;
  a.K = K;
  a.E = E;
  a.D = D;
  a.Q = Q;
  a.idle0 = static_cast<const float*>(idle0);
  a.alloc = static_cast<const float*>(alloc);
  a.rel = static_cast<const float*>(rel);
  a.pip = static_cast<const float*>(pip);
  a.ntasks0 = static_cast<const int32_t*>(ntasks0);
  a.max_tasks = static_cast<const int32_t*>(max_tasks);
  a.ports0 = static_cast<const uint32_t*>(ports0);
  a.ready = static_cast<const uint8_t*>(ready);
  a.label = static_cast<const uint32_t*>(label);
  a.taint = static_cast<const uint32_t*>(taint);
  a.req = static_cast<const float*>(req);
  a.init_req = static_cast<const float*>(init_req);
  a.job = static_cast<const int32_t*>(job);
  a.real = static_cast<const uint8_t*>(real);
  a.tports = static_cast<const uint32_t*>(tports);
  a.sel = static_cast<const uint32_t*>(sel);
  a.aff_bits = static_cast<const uint32_t*>(aff_bits);
  a.aff_terms = static_cast<const int32_t*>(aff_terms);
  a.tol = static_cast<const uint32_t*>(tol);
  a.pref_bits = static_cast<const uint32_t*>(pref_bits);
  a.pref_w = static_cast<const float*>(pref_w);
  a.queue = static_cast<const int32_t*>(queue);
  a.min_av = static_cast<const int32_t*>(min_av);
  a.rbase = static_cast<const int32_t*>(rbase);
  a.deserved = static_cast<const float*>(deserved);
  a.q_alloc0 = static_cast<const float*>(q_alloc0);
  a.eps = static_cast<const float*>(eps);
  a.scalar_slot = static_cast<const uint8_t*>(scalar_slot);
  a.bres = static_cast<const float*>(bres);
  a.w = Weights{bw, lw, mw, balw};
  a.naff = naff;
  a.node_dom = static_cast<const int32_t*>(node_dom);
  a.term_key = static_cast<const int32_t*>(term_key);
  a.cnt0 = static_cast<const int32_t*>(cnt0);
  a.t_aff = static_cast<const uint8_t*>(t_aff);
  a.t_anti = static_cast<const uint8_t*>(t_anti);
  a.t_match = static_cast<const uint8_t*>(t_match);
  a.t_soft = static_cast<const float*>(t_soft);
  a.extra_ok = static_cast<const uint8_t*>(extra_ok);
  a.extra_score = static_cast<const float*>(extra_score);
  a.idle = static_cast<float*>(idle);
  a.pxe = static_cast<float*>(pxe);
  a.ntasks = static_cast<int32_t*>(ntasks);
  a.pnt = static_cast<int32_t*>(pnt);
  a.nports = static_cast<uint32_t*>(nports);
  a.pports = static_cast<uint32_t*>(pports);
  a.cnt = static_cast<int32_t*>(cnt);
  a.tot = static_cast<int32_t*>(tot);
  a.q_alloc = static_cast<float*>(q_alloc);
  a.q_pip = static_cast<float*>(q_pip);
  a.assigned = static_cast<int32_t*>(assigned);
  a.pipelined = static_cast<int32_t*>(pipelined);
  a.alloc_cnt = static_cast<int32_t*>(alloc_cnt);
  a.never_ready = static_cast<uint8_t*>(never_ready);
  a.fit_failed = static_cast<uint8_t*>(fit_failed);
  a.flags = static_cast<uint8_t*>(flags);
  a.hash = static_cast<uint64_t*>(hash);
  a.pidh = static_cast<int32_t*>(pidh);
  a.heads = static_cast<int32_t*>(heads);
  a.log = static_cast<int32_t*>(log);
  a.U = U;
  a.Np = Np;
  a.keys = static_cast<uint64_t*>(keys);
  a.meta = static_cast<uint8_t*>(meta);
  a.spref = static_cast<float*>(spref);
  a.cmax = static_cast<uint64_t*>(cmax);
  a.cany = static_cast<uint8_t*>(cany);
  a.rd_e = static_cast<int32_t*>(rd_e);
  a.rd_flag = static_cast<uint8_t*>(rd_flag);
  a.md_e = static_cast<int32_t*>(md_e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int prep_blocks = (P + kPrepWarps - 1) / kPrepWarps;
  row_prep_kernel<<<prep_blocks, kPrepWarps * 32, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  seq_solve_kernel<<<1, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
