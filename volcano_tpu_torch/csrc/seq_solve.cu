// seq_solve: the exact sequential allocate solve.
//
// Replaces the JAX package's jitted `solve` (volcano_tpu/ops/allocate.py:201),
// a `fori_loop(0, P + 1, step)` over job-contiguous task rows (:276-458).
//
// Design: one persistent block of 1,024 threads runs all P + 1 steps, so a
// solve is one launch and the host reads nothing until the result.  The
// steps depend on each other (each placement changes the idle, pod, port and
// count planes the next one reads), so the parallelism is inside a step: the
// threads stride over the N nodes, each scoring its nodes into 64-bit keys
// (score descending, node index ascending: jnp.argmax's first-max rule), and
// a block reduction picks the best key and whether any node was feasible.
// Block-uniform decisions (job boundaries, the overuse skip, allocate versus
// pipeline) are made by thread 0 into shared memory between barriers.
//
// Per step, as the JAX step:
// - at a job boundary, a previous job that never became ready (and was not
//   skipped for queue overuse) is rolled back by replaying its rows' adds
//   in ascending row order (`_undo_job`, :245-274): idle += req,
//   ntasks -= 1, ports AND-NOT, counts -1, q_alloc += -req.  Each slot,
//   port word and count cell is owned by one thread across the rows, so
//   the float adds keep the JAX order without a barrier per row;
// - the new job opens: skipped when q_alloc + q_pip exceeds its queue's
//   deserved share (`less_equal`), ready from its base count;
// - the task's inter-pod term columns are compacted once per step into two
//   lists (the terms it reads: required affinity, anti-affinity or a
//   nonzero soft weight; the terms it matches), so the node loop reads only
//   those columns of the live [E, D] counts; a running per-term total
//   replaces a sum over D for the self-match rule;
// - feasibility: ready, selector, node-affinity alternatives, taints, the
//   fit on FutureIdle ((idle + releasing) - pipelined) - pip_extra, pod
//   slots (ntasks + pip_ntasks), ports against nports | pip_nports, the
//   inter-pod verdicts (domain -1 reads 0), then extra_ok;
// - score: ((node_score + extra_score) + naff * sum_AP(pref)) +
//   sum_E(soft * count), each operation rounded on its own (-fmad=false);
// - allocate when the init request fits the live idle of the best node,
//   else pipeline onto future capacity (the pipeline side survives a
//   rollback); no feasible node aborts the rest of the job.
// Masked zero adds of the JAX step (x + 0.0 on an inactive step) are
// skipped: they could only turn a -0.0 into +0.0, which no plane holds.
//
// Bound: the work is P steps, each a pass over the N nodes' planes (idle,
// allocatable, releasing, pipelined, pip_extra, label and taint words: some
// 30-60 bytes a node, from L2 after the first steps) plus ~60 float
// operations a node.  Memory-wise a solve needs little more than its inputs
// once; in practice it is bound by the step's latency: five block barriers
// and a reduction per step, with N / 1,024 nodes a thread.  One block uses
// one of the 132 SMs; a faster form splits the node loop over a cluster of
// blocks (a later change).
#include "common.cuh"

using vtt::Weights;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

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
  // per-step term lists ([E] each)
  int32_t* rd_e;
  uint8_t* rd_flag;
  int32_t* md_e;
};

struct Block {
  int prev_job;
  int job_start;
  int job_ready;
  int job_skip;
  int job_overskip;
  int qj;
  int best;
  int any;
  int fits;
  int base;
  int warp_sums[kWarps];
  unsigned long long warp_key[kWarps];
  int warp_any[kWarps];
};

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

// Rolls back the allocations of job rows [start, end) (`_undo_job`).  Each
// address is owned by one thread across the rows: slot r of idle and of the
// queue row by thread r, ntasks by thread 0, port word w by thread w mod
// 1,024, term e's count cells and total by thread e mod 1,024.
__device__ void undo_job(const SeqArgs& a, int start, int end, int qj) {
  const int tid = threadIdx.x;
  for (int u = start; u < end; ++u) {
    const int n = a.assigned[u];
    if (n < 0) continue;
    if (tid < a.R) {
      const int64_t s = static_cast<int64_t>(n) * a.R + tid;
      const float r = a.req[static_cast<int64_t>(u) * a.R + tid];
      a.idle[s] = a.idle[s] + r;
      const int64_t q = static_cast<int64_t>(qj) * a.R + tid;
      a.q_alloc[q] = a.q_alloc[q] + (-r);
    }
    if (tid == 0) a.ntasks[n] -= 1;
    for (int w = tid; w < a.PW; w += kThreads) {
      a.nports[static_cast<int64_t>(n) * a.PW + w] &=
          ~a.tports[static_cast<int64_t>(u) * a.PW + w];
    }
    for (int e = tid; e < a.E; e += kThreads) {
      if (!a.t_match[static_cast<int64_t>(u) * a.E + e]) continue;
      const int dom = a.node_dom[static_cast<int64_t>(n) * a.K + a.term_key[e]];
      if (dom < 0) continue;
      a.cnt[static_cast<int64_t>(e) * a.D + dom] -= 1;
      a.tot[e] -= 1;
    }
  }
}

__global__ void __launch_bounds__(kThreads) seq_solve_kernel(SeqArgs a) {
  __shared__ Block sh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
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
  if (tid == 0) {
    sh.prev_job = -1;
    sh.job_start = 0;
    sh.job_ready = 1;
    sh.job_skip = 1;
    sh.job_overskip = 1;
  }
  __syncthreads();

  for (int t = 0; t <= a.P; ++t) {
    const int tt = t < a.P ? t : a.P - 1;
    const bool is_pad = t >= a.P || !a.real[tt];
    const int jt = is_pad ? -1 : a.job[tt];

    // ---- job boundary: close the previous job, open this one ----------
    if (jt != sh.prev_job) {
      const int pj = sh.prev_job;
      if (pj >= 0 && !sh.job_ready && !sh.job_overskip) {
        undo_job(a, sh.job_start, t, a.queue[pj]);
        if (tid == 0) a.never_ready[pj] = 1;
      }
      __syncthreads();
      if (tid == 0) {
        const int qj = a.queue[jt > 0 ? jt : 0];
        float qt[vtt::kMaxR];
        for (int s = 0; s < R; ++s) {
          const int64_t q = static_cast<int64_t>(qj) * R + s;
          qt[s] = a.q_alloc[q] + a.q_pip[q];
        }
        const bool overused = !vtt::less_equal(
            qt, a.deserved + static_cast<int64_t>(qj) * R, a.eps,
            a.scalar_slot, R);
        sh.job_start = t;
        sh.job_skip = sh.job_overskip = (jt < 0 || overused) ? 1 : 0;
        sh.job_ready = (jt >= 0 && a.rbase[jt] >= a.min_av[jt]) ? 1 : 0;
        sh.prev_job = jt;
      }
      __syncthreads();
    }
    if (is_pad || sh.job_skip) continue;

    // ---- the task's term columns --------------------------------------
    const int64_t te = static_cast<int64_t>(tt) * a.E;
    const int nr = block_compact(
        a.E,
        [&](int e) {
          return a.t_aff[te + e] || a.t_anti[te + e] ||
                 a.t_soft[te + e] != 0.0f;
        },
        a.rd_e, sh);
    const int nm = block_compact(
        a.E, [&](int e) { return a.t_match[te + e] != 0; }, a.md_e, sh);
    for (int i = tid; i < nr; i += kThreads) {
      const int e = a.rd_e[i];
      // bit 0: required affinity, bit 1: anti-affinity, bit 2: the
      // self-match rule holds (no match anywhere and the task matches).
      a.rd_flag[i] = (a.t_aff[te + e] ? 1 : 0) | (a.t_anti[te + e] ? 2 : 0) |
                     ((a.tot[e] == 0 && a.t_match[te + e]) ? 4 : 0);
    }
    __syncthreads();

    // ---- score every node ---------------------------------------------
    const float* rq = a.req + static_cast<int64_t>(tt) * R;
    const float* irq = a.init_req + static_cast<int64_t>(tt) * R;
    const uint32_t* sel = a.sel + static_cast<int64_t>(tt) * a.LW;
    const uint32_t* tol = a.tol + static_cast<int64_t>(tt) * a.TW;
    const uint32_t* aff = a.aff_bits + static_cast<int64_t>(tt) * a.A * a.LW;
    const uint32_t* pref =
        a.pref_bits + static_cast<int64_t>(tt) * a.AP * a.LW;
    const float* pw = a.pref_w + static_cast<int64_t>(tt) * a.AP;
    const uint32_t* tp = a.tports + static_cast<int64_t>(tt) * a.PW;
    const int nterms = a.aff_terms[tt];
    unsigned long long best_key = 0ull;
    int any = 0;
    for (int n = tid; n < N; n += kThreads) {
      const vtt::StaticPair st = vtt::static_pair(
          a.ready[n] != 0, a.label + static_cast<int64_t>(n) * a.LW,
          a.taint + static_cast<int64_t>(n) * a.TW, a.LW, a.TW, sel, aff,
          a.A, nterms, tol, pref, pw, a.AP);
      bool feas = st.ok;
      float fi[vtt::kMaxR];
      vtt::future_idle(a.idle, a.rel, a.pip, a.pxe, n, R, fi);
      feas = feas && vtt::less_equal(irq, fi, a.eps, a.scalar_slot, R);
      feas = feas && (a.max_tasks[n] <= 0 ||
                      a.ntasks[n] + a.pnt[n] < a.max_tasks[n]);
      feas = feas && !vtt::ports_clash(tp, a.nports, a.pports, n, a.PW);
      float soft = 0.0f;
      for (int i = 0; i < nr; ++i) {
        const int e = a.rd_e[i];
        const int fl = a.rd_flag[i];
        const int dom =
            a.node_dom[static_cast<int64_t>(n) * a.K + a.term_key[e]];
        const int32_t cv =
            dom < 0 ? 0 : a.cnt[static_cast<int64_t>(e) * a.D + dom];
        if ((fl & 1) && !(cv > 0 || (fl & 4))) feas = false;
        if ((fl & 2) && cv != 0) feas = false;
        soft = soft + a.t_soft[te + e] * static_cast<float>(cv);
      }
      const int64_t tn = static_cast<int64_t>(tt) * N + n;
      if (a.extra_ok && !a.extra_ok[tn]) feas = false;
      float score = vtt::node_score(rq, a.alloc + static_cast<int64_t>(n) * R,
                                    a.idle + static_cast<int64_t>(n) * R,
                                    a.bres, R, a.w);
      if (a.extra_score) score = score + a.extra_score[tn];
      score = score + a.naff * st.pref;
      score = score + soft;
      const unsigned long long key =
          vtt::make_key(feas ? score : vtt::kNeg, static_cast<uint32_t>(n));
      if (key > best_key) best_key = key;
      any |= feas ? 1 : 0;
    }
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_down_sync(0xFFFFFFFFu, best_key, off);
      if (o > best_key) best_key = o;
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
        if (sh.warp_key[i] > k) k = sh.warp_key[i];
        an |= sh.warp_any[i];
      }
      const int best =
          static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(k & 0xFFFFFFFFull));
      sh.best = best;
      sh.any = an;
      sh.fits = vtt::less_equal(irq, a.idle + static_cast<int64_t>(best) * R,
                                a.eps, a.scalar_slot, R)
                    ? 1
                    : 0;
      sh.qj = a.queue[jt];
      if (!an) {
        // No feasible node: abort the rest of the job.
        a.fit_failed[jt] = 1;
        sh.job_skip = 1;
      }
    }
    __syncthreads();
    if (!sh.any) continue;

    // ---- allocate, or pipeline onto future capacity -------------------
    const int best = sh.best;
    const int qj = sh.qj;
    const bool alloc = sh.fits != 0;
    if (tid < R) {
      const float r = rq[tid];
      const int64_t s = static_cast<int64_t>(best) * R + tid;
      const int64_t q = static_cast<int64_t>(qj) * R + tid;
      if (alloc) {
        a.idle[s] = a.idle[s] + (-r);
        a.q_alloc[q] = a.q_alloc[q] + r;
      } else {
        a.pxe[s] = a.pxe[s] + r;
        a.q_pip[q] = a.q_pip[q] + r;
      }
    }
    for (int w = tid; w < a.PW; w += kThreads) {
      const int64_t i = static_cast<int64_t>(best) * a.PW + w;
      if (alloc) {
        a.nports[i] |= tp[w];
      } else {
        a.pports[i] |= tp[w];
      }
    }
    for (int i = tid; i < nm; i += kThreads) {
      const int e = a.md_e[i];
      const int dom =
          a.node_dom[static_cast<int64_t>(best) * a.K + a.term_key[e]];
      if (dom < 0) continue;
      a.cnt[static_cast<int64_t>(e) * a.D + dom] += 1;
      a.tot[e] += 1;
    }
    if (tid == 0) {
      if (alloc) {
        a.ntasks[best] += 1;
        a.assigned[tt] = best;
        a.alloc_cnt[jt] += 1;
        if (a.rbase[jt] + a.alloc_cnt[jt] >= a.min_av[jt]) sh.job_ready = 1;
      } else {
        a.pnt[best] += 1;
        a.pipelined[tt] = best;
      }
    }
    __syncthreads();
  }

  __syncthreads();
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
    void* alloc_cnt, void* never_ready, void* fit_failed, void* rd_e,
    void* rd_flag, void* md_e, void* stream) {
  if (R > vtt::kMaxR) return static_cast<int>(cudaErrorInvalidValue);
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
  a.rd_e = static_cast<int32_t*>(rd_e);
  a.rd_flag = static_cast<uint8_t*>(rd_flag);
  a.md_e = static_cast<int32_t*>(md_e);
  seq_solve_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
