// vcreclaim: the host reclaim engine of volcano_tpu_torch's victim walk.
//
// The reclaim action of the host victim walk (fastpath_evict.py,
// VOLCANO_TPU_EVICT_DEVICE=0) runs its per-reclaimer node walk, and the
// whole cross-queue round-robin, here: reclaim.go:40-189 with the tiered
// Reclaimable intersection of session_plugins.go:110-193.  One call walks
// nodes from a persistent cursor, collects cross-queue Running candidates,
// narrows them through the tiers (gang / conformance / proportion, encoded
// in `tiers`), validates, evicts victims in order until the reclaimed sum
// covers the request, and reports the pipeline node.  All cluster state is
// mutated in place through the caller's numpy buffers; evicted rows are
// returned so the Python side keeps its caches and event trail coherent.
//
// Host code: a plain C ABI read through ctypes (volcano_tpu_torch/native.py),
// built with `g++ -O2 -shared -fPIC` on first use into csrc/_build/.
// Every function writes into caller-allocated NumPy buffers, so no memory
// management crosses the boundary.

#include <cmath>
#include <cstdint>
#include <queue>
#include <vector>

extern "C" {

void* vcreclaim_ctx_new(
    const long long* node_ptr, const long long* node_rows,
    int16_t* p_status, const int32_t* p_job,
    const float* req, const uint8_t* req_empty, const uint8_t* critical,
    const int32_t* j_minav, int32_t* j_ready_base,
    int32_t* j_cnt_alloc, int32_t* j_cnt_run, int32_t* j_cnt_releasing,
    float* j_alloc_res, const int32_t* q_of_job,
    const uint8_t* q_reclaimable, float* q_alloc,
    const float* q_deserved, const uint8_t* q_has_deserved,
    float* fi, float* n_releasing,
    const int32_t* tiers, long long tiers_len,
    const float* eps, const uint8_t* scalar_slot,
    const uint8_t* alive, const float* init_req_base,
    long long Nn, long long R,
    long long st_running, long long st_releasing,
    float* n_pipelined, int32_t* n_ntasks, const int32_t* n_maxtasks,
    long long* pipe_node, int32_t* j_cnt_pending, long long* j_waiting,
    long long* j_version, long long* q_version, long long Qn,
    const int32_t* j_prio, const int32_t* j_rank,
    const int32_t* p_node,
    const float* total_res, const int32_t* job_order,
    long long job_order_len, long long reclaim_gated);
void vcreclaim_ctx_free(void* ctx);
long long vcreclaim_step(
    void* ctx_p, long long prow, long long qid,
    long long* cursor,
    const uint8_t* anym, const uint8_t* feas, const uint8_t* stat,
    const uint8_t* slots,
    long long* out_evicted, long long* out_n_evicted,
    long long max_evicted);
long long vcreclaim_drive_mq(
    void* ctx_p, long long has_pred,
    const long long* qs_ids, long long n_queues,
    const double* q_create, const int32_t* q_uid_rank,
    const uint8_t* q_named, long long qorder_has_prop,
    int8_t* q_overused, uint8_t* out_q_dropped,
    const long long* job_ids, long long n_jobs,
    const long long* job_qslot,
    const long long* task_ptr, const long long* task_rows,
    long long* task_cursor,
    const int32_t* row_maskidx,
    long long n_masks,
    unsigned long long* anym_ptrs, unsigned long long* feas_ptrs,
    unsigned long long* stat_ptrs, unsigned long long* slots_ptrs,
    unsigned long long* initreq_ptrs,
    const long long* mask_qids,
    long long* mask_cursors,
    long long* out_evicted, long long* out_n_evicted, long long max_ev,
    long long* out_pipe_rows, long long* out_pipe_nodes,
    long long* out_n_pipe,
    long long* out_touched, long long* out_n_touched,
    long long max_touched,
    long long* out_yield_job, uint8_t* out_job_dropped);

}  // extern "C"

extern "C" {

static const float VC_MIN_MILLI_SCALAR = 10.0f;


// Resource.less on dense slot vectors (api/resource.py:182-199), with the
// allocation's scalar DICT ENTRY SET modelled explicitly: Resource.sub
// keeps zeroed entries in the dict (and adds the subtrahend's keys), so
// "scalars is None" and "which keys exist" cannot be derived from values.
// a_has: the dict is non-None; a_entry[k]: slot k has a dict entry.
static bool vc_res_less(const float* a, bool a_has,
                        const uint8_t* a_entry, const float* b,
                        int64_t R, const uint8_t* scalar_slot) {
  if (!(a[0] < b[0])) return false;
  if (!(a[1] < b[1])) return false;
  bool b_any = false;
  for (int64_t k = 2; k < R; ++k)
    if (scalar_slot[k] && b[k] != 0.0f) b_any = true;
  if (!a_has) {
    if (b_any) {
      for (int64_t k = 2; k < R; ++k)
        if (scalar_slot[k] && b[k] != 0.0f && b[k] <= VC_MIN_MILLI_SCALAR)
          return false;
    }
    return true;
  }
  if (!b_any) return false;
  // Iterate the allocation's ENTRIES (rr.scalars.get(name, 0) == b[k]).
  for (int64_t k = 2; k < R; ++k)
    if (scalar_slot[k] && a_entry[k] && !(a[k] < b[k])) return false;
  return true;
}

// Resource.less_equal_strict(d, a) on dense vectors (resource.py:201-212).
static bool vc_res_le_strict(const float* d, const float* a, int64_t R,
                             const uint8_t* scalar_slot) {
  if (!(d[0] <= a[0])) return false;
  if (!(d[1] <= a[1])) return false;
  for (int64_t k = 2; k < R; ++k)
    if (scalar_slot[k] && d[k] != 0.0f && !(d[k] <= a[k])) return false;
  return true;
}

// Epsilon-tolerant Resource.less_equal (resource_info.go:286-320) of l vs r.
static bool vc_le(const float* l, const float* r, const float* eps,
                  const uint8_t* scalar_slot, int64_t R) {
  for (int64_t k = 0; k < R; ++k) {
    float lv = l[k], rv = r[k];
    bool ok = (lv < rv) || (std::abs(lv - rv) < eps[k]);
    if (scalar_slot[k] && lv <= eps[k]) ok = true;
    if (!ok) return false;
  }
  return true;
}

// Plugin ids in the `tiers` encoding (-1 = tier boundary).
enum { VC_PLUGIN_GANG = 0, VC_PLUGIN_CONFORMANCE = 1,
       VC_PLUGIN_PROPORTION = 2 };

#define VC_MAX_CAND 512

// Per-action context: every stable pointer captured once so the per-
// reclaimer call marshals only what varies (ctypes arg overhead was
// measurable at 20k reclaimers per cycle).
struct VcReclaimCtx {
  const long long* node_ptr; const long long* node_rows;
  int16_t* p_status; const int32_t* p_job;
  const float* req; const uint8_t* req_empty; const uint8_t* critical;
  const int32_t* j_minav; int32_t* j_ready_base;
  int32_t* j_cnt_alloc; int32_t* j_cnt_run; int32_t* j_cnt_releasing;
  float* j_alloc_res; const int32_t* q_of_job;
  const uint8_t* q_reclaimable; float* q_alloc;
  const float* q_deserved; const uint8_t* q_has_deserved;
  float* fi; float* n_releasing;
  const int32_t* tiers; long long tiers_len;
  const float* eps; const uint8_t* scalar_slot;
  const uint8_t* alive; const float* init_req_base;
  long long Nn, R, st_running, st_releasing;
  // ---- drive mode (vcreclaim_drive_mq) ----
  float* n_pipelined;          // [N,R]
  int32_t* n_ntasks;           // [N]
  const int32_t* n_maxtasks;   // [N]
  long long* pipe_node;        // [P]
  int32_t* j_cnt_pending;      // [J]
  long long* j_waiting;        // [J]
  long long* j_version;        // [J]
  long long* q_version;        // [Q]
  long long Qn;
  const int32_t* j_prio;       // [J]
  const int32_t* j_rank;       // [J] (create, uid) rank
  const int32_t* p_node;       // [P]
  const float* total_res;      // [R]
  const int32_t* job_order;    // encoding: 0=priority 1=gang 2=drf
  long long job_order_len;
  uint8_t reclaim_gated;       // proportion sits in first reclaim tier
};

void* vcreclaim_ctx_new(
    const long long* node_ptr, const long long* node_rows,
    int16_t* p_status, const int32_t* p_job,
    const float* req, const uint8_t* req_empty, const uint8_t* critical,
    const int32_t* j_minav, int32_t* j_ready_base,
    int32_t* j_cnt_alloc, int32_t* j_cnt_run, int32_t* j_cnt_releasing,
    float* j_alloc_res, const int32_t* q_of_job,
    const uint8_t* q_reclaimable, float* q_alloc,
    const float* q_deserved, const uint8_t* q_has_deserved,
    float* fi, float* n_releasing,
    const int32_t* tiers, long long tiers_len,
    const float* eps, const uint8_t* scalar_slot,
    const uint8_t* alive, const float* init_req_base,
    long long Nn, long long R,
    long long st_running, long long st_releasing,
    float* n_pipelined, int32_t* n_ntasks, const int32_t* n_maxtasks,
    long long* pipe_node, int32_t* j_cnt_pending, long long* j_waiting,
    long long* j_version, long long* q_version, long long Qn,
    const int32_t* j_prio, const int32_t* j_rank,
    const int32_t* p_node,
    const float* total_res, const int32_t* job_order,
    long long job_order_len, long long reclaim_gated) {
  VcReclaimCtx* c = new VcReclaimCtx{
      node_ptr, node_rows, p_status, p_job, req, req_empty, critical,
      j_minav, j_ready_base, j_cnt_alloc, j_cnt_run, j_cnt_releasing,
      j_alloc_res, q_of_job, q_reclaimable, q_alloc, q_deserved,
      q_has_deserved, fi, n_releasing, tiers, tiers_len, eps,
      scalar_slot, alive, init_req_base, Nn, R, st_running, st_releasing,
      n_pipelined, n_ntasks, n_maxtasks, pipe_node, j_cnt_pending,
      j_waiting, j_version, q_version, Qn, j_prio, j_rank, p_node,
      total_res, job_order, job_order_len, (uint8_t)reclaim_gated};
  return c;
}

void vcreclaim_ctx_free(void* ctx) {
  delete static_cast<VcReclaimCtx*>(ctx);
}

// Returns the node the reclaimer pipelined on, or -1.  Victim rows evicted
// along the walk (including on nodes that ultimately could not cover the
// request — reclaim.go's evictions are immediate and unwrapped) land in
// out_evicted.
static long long vc_walk_one(
    const VcReclaimCtx& C, long long prow, long long qid,
    long long* cursor,
    const uint8_t* anym, const uint8_t* feas, const uint8_t* stat,
    const uint8_t* slots,
    long long* out_evicted, long long* out_n_evicted,
    long long max_evicted) {
  const long long Nn = C.Nn, R = C.R;
  const long long* node_ptr = C.node_ptr;
  const long long* node_rows = C.node_rows;
  int16_t* p_status = C.p_status;
  const int32_t* p_job = C.p_job;
  const float* req = C.req;
  const uint8_t* req_empty = C.req_empty;
  const uint8_t* critical = C.critical;
  const int32_t* j_minav = C.j_minav;
  int32_t* j_ready_base = C.j_ready_base;
  int32_t* j_cnt_alloc = C.j_cnt_alloc;
  int32_t* j_cnt_run = C.j_cnt_run;
  int32_t* j_cnt_releasing = C.j_cnt_releasing;
  float* j_alloc_res = C.j_alloc_res;
  const int32_t* q_of_job = C.q_of_job;
  const uint8_t* q_reclaimable = C.q_reclaimable;
  float* q_alloc = C.q_alloc;
  const float* q_deserved = C.q_deserved;
  const uint8_t* q_has_deserved = C.q_has_deserved;
  float* fi = C.fi;
  float* n_releasing = C.n_releasing;
  const int32_t* tiers = C.tiers;
  const long long tiers_len = C.tiers_len;
  const float* eps = C.eps;
  const uint8_t* scalar_slot = C.scalar_slot;
  const uint8_t* alive = C.alive;
  const float* init_req = C.init_req_base + prow * R;
  const long long st_running = C.st_running, st_releasing = C.st_releasing;
  int64_t cand[VC_MAX_CAND];
  uint8_t in_victims[VC_MAX_CAND];
  uint8_t in_sel[VC_MAX_CAND];
  // Scratch for per-call plugin state (small: candidates per node).
  int64_t gang_jobs[VC_MAX_CAND];
  int32_t gang_cnt[VC_MAX_CAND];
  int64_t prop_qs[VC_MAX_CAND];
  float prop_alloc[VC_MAX_CAND * 8];  // R <= 8 supported
  uint8_t prop_entry[VC_MAX_CAND * 8];
  uint8_t prop_has[VC_MAX_CAND];
  float reclaimed[8];
  float vsum[8];
  if (R > 8) return -2;  // unsupported width; caller falls back

  // NOTE: out_n_evicted is owned by the caller (vcreclaim_batch
  // accumulates across turns); do not reset it here.
  long long n = *cursor;
  bool advancing = true;
  for (; n < Nn; ++n) {
    if (!(anym[n] && feas[n] && alive[n]
          && (stat == nullptr || (stat[n] && slots[n])))) {
      if (advancing) *cursor = n + 1;
      continue;
    }
    advancing = false;
    // ---- candidates: cross-queue Running tasks of reclaimable queues,
    // in resident (insertion) order.
    int64_t nc = 0;
    for (int64_t p = node_ptr[n]; p < node_ptr[n + 1]; ++p) {
      int64_t r = node_rows[p];
      if (p_status[r] != (int16_t)st_running || req_empty[r]) continue;
      int32_t jr = p_job[r];
      if (jr < 0) continue;
      int32_t vq = q_of_job[jr];
      if (vq == (int32_t)qid || vq < 0 || !q_reclaimable[vq]) continue;
      if (nc >= VC_MAX_CAND) return -2;  // degenerate node: fall back
      cand[nc++] = r;
    }
    if (nc == 0) continue;
    // ---- tiered Reclaimable intersection (session_plugins.go:110-193,
    // incl. the Go nil-slice quirk: an initialized-empty carried set
    // keeps poisoning later tiers).
    bool init = false;
    for (int64_t i = 0; i < nc; ++i) in_victims[i] = 0;
    int64_t n_victims = 0;
    int64_t t = 0;
    while (t < tiers_len) {
      // one tier: ids until -1
      for (; t < tiers_len && tiers[t] != -1; ++t) {
        int32_t plugin = tiers[t];
        // sel over the ORIGINAL candidates (session passes the full
        // preemptees list to every plugin fn).
        if (plugin == VC_PLUGIN_GANG) {
          int64_t ng = 0;
          for (int64_t i = 0; i < nc; ++i) {
            int32_t jr = p_job[cand[i]];
            int32_t cnt = -1;
            int64_t gslot = -1;
            for (int64_t g = 0; g < ng; ++g)
              if (gang_jobs[g] == jr) { gslot = g; break; }
            if (gslot < 0) {
              gslot = ng++;
              gang_jobs[gslot] = jr;
              gang_cnt[gslot] = j_ready_base[jr];
            }
            cnt = gang_cnt[gslot];
            int32_t minav = j_minav[jr];
            if (minav <= cnt - 1 || minav == 1) {
              gang_cnt[gslot] = cnt - 1;
              in_sel[i] = 1;
            } else {
              in_sel[i] = 0;
            }
          }
        } else if (plugin == VC_PLUGIN_CONFORMANCE) {
          for (int64_t i = 0; i < nc; ++i)
            in_sel[i] = critical[cand[i]] ? 0 : 1;
        } else if (plugin == VC_PLUGIN_PROPORTION) {
          int64_t nq = 0;
          for (int64_t i = 0; i < nc; ++i) {
            in_sel[i] = 0;
            int32_t jr = p_job[cand[i]];
            int32_t vq = q_of_job[jr];
            if (vq < 0) continue;
            if (!q_has_deserved[vq]) continue;
            int64_t qslot = -1;
            for (int64_t q = 0; q < nq; ++q)
              if (prop_qs[q] == vq) { qslot = q; break; }
            if (qslot < 0) {
              qslot = nq++;
              prop_qs[qslot] = vq;
              bool has = false;
              for (int64_t k = 0; k < R; ++k) {
                float v = q_alloc[vq * R + k];
                prop_alloc[qslot * 8 + k] = v;
                // FastCycle._res: dict entries are the NONZERO slots.
                bool entry = scalar_slot[k] && v != 0.0f;
                prop_entry[qslot * 8 + k] = entry ? 1 : 0;
                if (entry) has = true;
              }
              prop_has[qslot] = has ? 1 : 0;
            }
            float* alloc = prop_alloc + qslot * 8;
            uint8_t* entry = prop_entry + qslot * 8;
            const float* vreq = req + cand[i] * R;
            if (vc_res_less(alloc, prop_has[qslot] != 0, entry, vreq, R,
                            scalar_slot))
              continue;
            // Resource.sub: cpu/mem always; scalars only when the dict
            // exists (None -> early return, resource.py:132-134), and
            // the subtrahend's keys join the entry set (:135-136).
            alloc[0] -= vreq[0];
            alloc[1] -= vreq[1];
            if (prop_has[qslot]) {
              for (int64_t k = 2; k < R; ++k) {
                if (!scalar_slot[k]) continue;
                alloc[k] -= vreq[k];
                if (vreq[k] != 0.0f) entry[k] = 1;
              }
            }
            if (vc_res_le_strict(q_deserved + vq * R, alloc, R,
                                 scalar_slot))
              in_sel[i] = 1;
          }
        } else {
          continue;  // unknown plugin: no reclaimable fn registered
        }
        // intersect / initialize the carried victim set
        if (!init) {
          n_victims = 0;
          for (int64_t i = 0; i < nc; ++i) {
            in_victims[i] = in_sel[i];
            if (in_sel[i]) ++n_victims;
          }
          init = true;
        } else {
          n_victims = 0;
          for (int64_t i = 0; i < nc; ++i) {
            in_victims[i] = in_victims[i] && in_sel[i];
            if (in_victims[i]) ++n_victims;
          }
        }
      }
      ++t;  // skip tier separator
      if (n_victims > 0) break;   // first tier boundary with victims
      if (init) break;            // initialized-empty: poisoned
    }
    if (n_victims == 0) continue;
    // ---- validate_victims: FutureIdle + victims must cover the task.
    const float* fi_n = fi + n * R;
    for (int64_t k = 0; k < R; ++k) vsum[k] = fi_n[k];
    for (int64_t i = 0; i < nc; ++i)
      if (in_victims[i]) {
        const float* vreq = req + cand[i] * R;
        for (int64_t k = 0; k < R; ++k) vsum[k] += vreq[k];
      }
    if (!vc_le(init_req, vsum, eps, scalar_slot, R)) continue;
    // ---- evict victims in order until the reclaimed sum covers
    // (reclaim.go:160-175; evictions stand even if it never does).
    for (int64_t k = 0; k < R; ++k) reclaimed[k] = 0.0f;
    bool covered = false;
    for (int64_t i = 0; i < nc && !covered; ++i) {
      if (!in_victims[i]) continue;
      int64_t r = cand[i];
      const float* vreq = req + r * R;
      // session-level evict bookkeeping (fastpath_evict EvictState.evict)
      p_status[r] = (int16_t)st_releasing;
      for (int64_t k = 0; k < R; ++k) {
        n_releasing[n * R + k] += vreq[k];
        fi[n * R + k] += vreq[k];
      }
      int32_t jr = p_job[r];
      if (jr >= 0) {
        j_cnt_alloc[jr] -= 1;
        j_cnt_run[jr] -= 1;
        j_cnt_releasing[jr] += 1;
        j_ready_base[jr] -= 1;
        for (int64_t k = 0; k < R; ++k) j_alloc_res[jr * R + k] -= vreq[k];
        int32_t vq = q_of_job[jr];
        if (vq >= 0)
          for (int64_t k = 0; k < R; ++k) q_alloc[vq * R + k] -= vreq[k];
      }
      if (*out_n_evicted < max_evicted)
        out_evicted[(*out_n_evicted)++] = r;
      for (int64_t k = 0; k < R; ++k) reclaimed[k] += vreq[k];
      covered = vc_le(init_req, reclaimed, eps, scalar_slot, R);
    }
    if (covered) return n;  // caller pipelines the task here
  }
  return -1;
}


long long vcreclaim_step(
    void* ctx_p, long long prow, long long qid,
    long long* cursor,
    const uint8_t* anym, const uint8_t* feas, const uint8_t* stat,
    const uint8_t* slots,
    long long* out_evicted, long long* out_n_evicted,
    long long max_evicted) {
  const VcReclaimCtx& C = *static_cast<VcReclaimCtx*>(ctx_p);
  *out_n_evicted = 0;
  return vc_walk_one(C, prow, qid, cursor, anym, feas, stat, slots,
                     out_evicted, out_n_evicted, max_evicted);
}

// ---- batch mode helpers -------------------------------------------------

// In-scope evictable sum at one node (fresh walk over residents).
static bool vc_scope_ev(const VcReclaimCtx& C, long long qid, long long n,
                        float* ev_out) {
  for (long long k = 0; k < C.R; ++k) ev_out[k] = 0.0f;
  bool any = false;
  for (long long p = C.node_ptr[n]; p < C.node_ptr[n + 1]; ++p) {
    long long r = C.node_rows[p];
    if (C.p_status[r] != (int16_t)C.st_running || C.req_empty[r]) continue;
    int32_t jr = C.p_job[r];
    if (jr < 0) continue;
    int32_t vq = C.q_of_job[jr];
    if (vq == (int32_t)qid || vq < 0 || !C.q_reclaimable[vq]) continue;
    const float* vreq = C.req + r * C.R;
    for (long long k = 0; k < C.R; ++k) {
      ev_out[k] += vreq[k];
      if (ev_out[k] > 1e-6f) any = true;
    }
  }
  return any;
}

// The live job-order key in doubles (fastpath_evict._job_key with the
// (create, uid) tail replaced by the precomputed rank).  Component
// arithmetic matches the Python float math bit-for-bit: float32 inputs
// widened to double, same divisions.
static void vc_job_key(const VcReclaimCtx& C, long long jr, double* out) {
  long long o = 0;
  for (long long i = 0; i < C.job_order_len; ++i) {
    int32_t id = C.job_order[i];
    if (id == 0) {  // priority
      out[o++] = -(double)C.j_prio[jr];
    } else if (id == 1) {  // gang: ready jobs order last
      out[o++] = (C.j_ready_base[jr] >= C.j_minav[jr]) ? 1.0 : 0.0;
    } else if (id == 2) {  // drf share
      double s = 0.0;
      for (long long k = 0; k < C.R; ++k) {
        double t = (double)C.total_res[k];
        double a = (double)C.j_alloc_res[jr * C.R + k];
        double v = t > 0.0 ? a / t : (a > 0.0 ? 1.0 : 0.0);
        if (v > s) s = v;
      }
      out[o++] = s;
    }
  }
  out[o++] = (double)C.j_rank[jr];
}

// proportion's reclaim-possible veto: some OTHER reclaimable queue still
// at/above its deserved share (fastpath_evict._reclaim_possible).
static bool vc_reclaim_possible(const VcReclaimCtx& C, long long qid) {
  if (!C.reclaim_gated) return true;
  for (long long qi = 0; qi < C.Qn; ++qi) {
    if (qi == qid || !C.q_reclaimable[qi] || !C.q_has_deserved[qi])
      continue;
    if (vc_res_le_strict(C.q_deserved + qi * C.R, C.q_alloc + qi * C.R,
                         C.R, C.scalar_slot))
      return true;
  }
  return false;
}

// ---- reclaim drive shared structures -----------------------------------

struct VcKey {
  double v[8];
  int len;
  long long jr;
  bool operator<(const VcKey& o) const {
    // std::priority_queue is a MAX-heap; invert for min-pop.
    for (int i = 0; i < len; ++i) {
      if (v[i] < o.v[i]) return false;
      if (v[i] > o.v[i]) return true;
    }
    return false;
  }
};

// Per-profile mask set registered by the Python side.
struct VcMaskSet {
  uint8_t* anym;
  uint8_t* feas;
  const uint8_t* stat;   // may be the shared all-ones array
  uint8_t* slots;        // mutable when has_pred
  const float* init_req; // representative request vector
  long long cursor;
};


// ---- multi-queue reclaim drive -----------------------------------------
//
// The full cross-queue round-robin of fastpath_evict._reclaim_loop
// (reclaim.go:84-130): a lazy min-ordered QUEUE heap with live keys
// (share when proportion orders queues, then creation time, then uid
// rank), each turn popping one job from the queue's own lazy job heap
// and running one task's cursor walk.  Queue drop/re-push semantics
// mirror the Python loop exactly: overused (memoized at first
// evaluation, q_overused in/out), empty job heap, or a drained top job
// drop the queue; a consumed turn re-pushes it.  Yields (-3/-5) hand
// one job back to Python, which re-enters with dropped queues/jobs
// filtered out.

struct VcQKey {
  double v[3];
  int len;
  long long slot;  // local queue slot
  bool operator<(const VcQKey& o) const {
    // std::priority_queue is a MAX-heap; invert for min-pop.
    for (int i = 0; i < len; ++i) {
      if (v[i] < o.v[i]) return false;
      if (v[i] > o.v[i]) return true;
    }
    return false;
  }
};

// fastpath_evict._queue_share: max over the deserved Resource's NAMED
// slots of share(alloc, deserved) with 0/0 -> 0 and x/0 -> 1
// (api/helpers.go:46-59).  q_named marks the named slots (cpu/memory
// always; scalars the deserved dict carries, zero-valued included).
static double vc_queue_share(const VcReclaimCtx& C, const uint8_t* q_named,
                             long long qi) {
  if (!C.q_has_deserved[qi]) return 0.0;
  double s = 0.0;
  for (long long k = 0; k < C.R; ++k) {
    if (!q_named[qi * C.R + k]) continue;
    double a = (double)C.q_alloc[qi * C.R + k];
    double d = (double)C.q_deserved[qi * C.R + k];
    double v = (d == 0.0) ? (a == 0.0 ? 0.0 : 1.0) : a / d;
    if (v > s) s = v;
  }
  return s;
}

long long vcreclaim_drive_mq(
    void* ctx_p, long long has_pred,
    // queues (local slots; qs_ids maps to global queue ids)
    const long long* qs_ids, long long n_queues,
    const double* q_create, const int32_t* q_uid_rank,
    const uint8_t* q_named,        // [Qn * R], global-indexed
    long long qorder_has_prop,
    int8_t* q_overused,            // [n_queues] memo: -1 unknown / 0 / 1
    uint8_t* out_q_dropped,        // [n_queues]
    // jobs + tasks (job-major across all queues)
    const long long* job_ids, long long n_jobs,
    const long long* job_qslot,    // [n_jobs] local queue slot per job
    const long long* task_ptr, const long long* task_rows,
    long long* task_cursor,
    const int32_t* row_maskidx,
    // mask sets (per (queue scope, profile)); mask_qids = the GLOBAL
    // queue id whose evictable scope each set was built against
    long long n_masks,
    unsigned long long* anym_ptrs, unsigned long long* feas_ptrs,
    unsigned long long* stat_ptrs, unsigned long long* slots_ptrs,
    unsigned long long* initreq_ptrs,
    const long long* mask_qids,
    long long* mask_cursors,
    // outputs
    long long* out_evicted, long long* out_n_evicted, long long max_ev,
    long long* out_pipe_rows, long long* out_pipe_nodes,
    long long* out_n_pipe,
    long long* out_touched, long long* out_n_touched,
    long long max_touched,
    long long* out_yield_job, uint8_t* out_job_dropped) {
  const VcReclaimCtx& C = *static_cast<VcReclaimCtx*>(ctx_p);
  *out_n_evicted = 0;
  *out_n_pipe = 0;
  *out_n_touched = 0;
  *out_yield_job = -1;
  if (C.job_order_len + 1 > 8) return -4;  // VcKey buffer bound
  std::vector<VcMaskSet> masks((size_t)n_masks);
  for (long long i = 0; i < n_masks; ++i) {
    masks[i].anym = (uint8_t*)anym_ptrs[i];
    masks[i].feas = (uint8_t*)feas_ptrs[i];
    masks[i].stat = (const uint8_t*)stat_ptrs[i];
    masks[i].slots = (uint8_t*)slots_ptrs[i];
    masks[i].init_req = (const float*)initreq_ptrs[i];
    masks[i].cursor = mask_cursors[i];
  }
  auto make_jkey = [&](long long ji) {
    VcKey k;
    vc_job_key(C, job_ids[ji], k.v);
    k.len = (int)C.job_order_len + 1;
    k.jr = ji;
    return k;
  };
  auto make_qkey = [&](long long slot) {
    VcQKey k;
    int o = 0;
    long long qid = qs_ids[slot];
    if (qorder_has_prop) k.v[o++] = vc_queue_share(C, q_named, qid);
    k.v[o++] = q_create[slot];
    k.v[o++] = (double)q_uid_rank[slot];
    k.len = o;
    k.slot = slot;
    return k;
  };
  // Per-queue job heaps.
  std::vector<std::priority_queue<VcKey>> jheaps((size_t)n_queues);
  for (long long ji = 0; ji < n_jobs; ++ji)
    jheaps[(size_t)job_qslot[ji]].push(make_jkey(ji));
  std::priority_queue<VcQKey> qheap;
  for (long long slot = 0; slot < n_queues; ++slot)
    qheap.push(make_qkey(slot));
  // Mask refresh at a node for EVERY set, each against its OWN queue's
  // evictable scope (victims exclude the reclaimer's queue, so one
  // queue's eviction changes every other queue's sums too).  The
  // node-resident scan depends only on the set's queue, so it runs
  // once per DISTINCT queue, not once per (queue, profile) set.
  // Scratch hoisted out of the per-node lambda: zero steady-state
  // allocations in the hot refresh.
  std::vector<long long> seen_q;
  std::vector<float> ev_by_q;
  std::vector<uint8_t> any_by_q;
  seen_q.reserve((size_t)n_queues);
  ev_by_q.reserve((size_t)n_queues * 8);
  any_by_q.reserve((size_t)n_queues);
  auto refresh_node = [&](long long n_r) {
    seen_q.clear();
    ev_by_q.clear();
    any_by_q.clear();
    const float* fi_n = C.fi + n_r * C.R;
    for (long long mset = 0; mset < n_masks; ++mset) {
      long long qy = mask_qids[mset];
      long long qslot = -1;
      for (size_t s = 0; s < seen_q.size(); ++s)
        if (seen_q[s] == qy) { qslot = (long long)s; break; }
      if (qslot < 0) {
        qslot = (long long)seen_q.size();
        seen_q.push_back(qy);
        float ev_tmp[8];
        bool any = vc_scope_ev(C, qy, n_r, ev_tmp);
        any_by_q.push_back(any ? 1 : 0);
        for (long long k = 0; k < 8; ++k)
          ev_by_q.push_back(k < C.R ? ev_tmp[k] : 0.0f);
      }
      const float* ev_q = ev_by_q.data() + qslot * 8;
      float tot[8];
      for (long long k = 0; k < C.R; ++k) tot[k] = fi_n[k] + ev_q[k];
      masks[mset].anym[n_r] = any_by_q[(size_t)qslot];
      masks[mset].feas[n_r] =
          vc_le(masks[mset].init_req, tot, C.eps, C.scalar_slot, C.R)
              ? 1 : 0;
      if (has_pred)
        masks[mset].slots[n_r] =
            (C.n_maxtasks[n_r] <= 0
             || C.n_ntasks[n_r] < C.n_maxtasks[n_r]) ? 1 : 0;
    }
    if (*out_n_touched < max_touched)
      out_touched[(*out_n_touched)++] = n_r;
  };
  long long rc = 0;
  while (!qheap.empty()) {
    VcQKey qtop = qheap.top();
    qheap.pop();
    VcQKey qfresh = make_qkey(qtop.slot);
    bool stale = false;
    for (int i = 0; i < qfresh.len; ++i)
      if (qfresh.v[i] != qtop.v[i]) { stale = true; break; }
    if (stale) { qheap.push(qfresh); continue; }
    long long slot = qtop.slot;
    long long qid = qs_ids[slot];
    // Overused verdict, frozen at first evaluation (the Python
    // closure's per-pass memo).
    if (q_overused[slot] < 0) {
      bool over = C.q_has_deserved[qid] &&
          !vc_le(C.q_alloc + qid * C.R, C.q_deserved + qid * C.R,
                 C.eps, C.scalar_slot, C.R);
      q_overused[slot] = over ? 1 : 0;
    }
    if (q_overused[slot]) { out_q_dropped[slot] = 1; continue; }
    auto& jheap = jheaps[(size_t)slot];
    // Lazy job pop (stale keys re-push).
    long long ji = -1;
    while (!jheap.empty()) {
      VcKey top = jheap.top();
      jheap.pop();
      VcKey fresh = make_jkey(top.jr);
      bool jstale = false;
      for (int i = 0; i < fresh.len; ++i)
        if (fresh.v[i] != top.v[i]) { jstale = true; break; }
      if (jstale) { jheap.push(fresh); continue; }
      ji = top.jr;
      break;
    }
    if (ji < 0) { out_q_dropped[slot] = 1; continue; }
    long long base = task_ptr[ji];
    long long ntask = task_ptr[ji + 1] - base;
    if (task_cursor[ji] >= ntask) {
      // Drained top job kills the queue (the reclaim.go empty-tasks
      // `continue` skips the queue re-push — a faithful quirk).
      out_job_dropped[ji] = 1;
      out_q_dropped[slot] = 1;
      continue;
    }
    long long prow = task_rows[base + task_cursor[ji]];
    int32_t mi = row_maskidx[prow];
    if (mi < 0) {
      // Python turn needed: heap state is reconstructed on re-entry
      // from the dropped flags + task cursors (keys are live).
      *out_yield_job = ji;
      rc = -3;
      break;
    }
    task_cursor[ji] += 1;
    if (!vc_reclaim_possible(C, qid)) {
      // Turn consumed; job drops, queue re-enters.
      out_job_dropped[ji] = 1;
      qheap.push(make_qkey(slot));
      continue;
    }
    VcMaskSet& M = masks[mi];
    long long before_ev = *out_n_evicted;
    long long node = vc_walk_one(
        C, prow, qid, &M.cursor, M.anym, M.feas,
        has_pred ? M.stat : nullptr, M.slots,
        out_evicted, out_n_evicted, max_ev);
    for (long long i = before_ev; i < *out_n_evicted; ++i)
      refresh_node(C.p_node[out_evicted[i]]);
    if (node == -2) {
      // Mid-walk bail: resume WALK-ONLY in Python (rc -5).
      task_cursor[ji] -= 1;
      *out_yield_job = ji;
      rc = -5;
      break;
    }
    if (node >= 0) {
      const float* req_r = C.req + prow * C.R;
      for (long long k = 0; k < C.R; ++k) {
        C.n_pipelined[node * C.R + k] += req_r[k];
        C.fi[node * C.R + k] -= req_r[k];
      }
      C.pipe_node[prow] = node;
      C.n_ntasks[node] += 1;
      int32_t pj = C.p_job[prow];
      if (pj >= 0) {
        C.j_version[pj] += 1;
        C.j_waiting[pj] += 1;
        C.j_cnt_pending[pj] -= 1;
        for (long long k = 0; k < C.R; ++k)
          C.j_alloc_res[pj * C.R + k] += req_r[k];
        int32_t qi2 = C.q_of_job[pj];
        if (qi2 >= 0) {
          for (long long k = 0; k < C.R; ++k)
            C.q_alloc[qi2 * C.R + k] += req_r[k];
          C.q_version[qi2] += 1;
        }
      }
      out_pipe_rows[*out_n_pipe] = prow;
      out_pipe_nodes[*out_n_pipe] = node;
      ++*out_n_pipe;
      refresh_node(node);
      jheap.push(make_jkey(ji));  // assigned: job re-enters
    } else {
      out_job_dropped[ji] = 1;    // walk failed: job drops
    }
    qheap.push(make_qkey(slot));  // turn complete: queue re-enters
  }
  for (long long i = 0; i < n_masks; ++i) mask_cursors[i] = masks[i].cursor;
  return rc;
}


}  // extern "C"
