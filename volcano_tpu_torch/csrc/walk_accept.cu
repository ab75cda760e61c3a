// walk_accept: one sub-round of the wave solve's capacity walk and
// in-order acceptance.
//
// Replaces one pass of the JAX package's sub-round body `sub_body`
// (volcano_tpu/ops/wave.py:1660-2003), up to the inter-pod affinity
// filter (aff_filter.cu, applied to its outputs).  With releasing
// capacity (`rel` given: the JAX has_future branch) the walk reads
// FutureIdle = ((idle + releasing) - pipelined) - pip_extra
// (wave.py:1659-1662), pod slots count ntasks + pip_ntasks, and a task that
// fits the future idle but not the live idle is accepted as pipelined
// (`acc_pipe`, wave.py:1997-2003):
//
//  1. per ranked node: copies of the profile that still fit,
//     c[u,k] = min(floor(min_r idle/req), max_tasks - ntasks), 0 where the
//     candidate is infeasible, and its running sum along the ranking;
//  2. per task: its rank m among the remaining candidates of its contention
//     group that come earlier in task order (the TPU built this as a
//     [W, W] `grp_pair & tril` reduction), the walk position
//     j = #{k : cumcap[u,k] <= m}, the chosen node ranked[u, j] and the
//     overflow flag;
//  3. per task: the requests and count of the strictly-earlier live tasks
//     that chose the same node (the TPU's `tril` matmul), then the idle and
//     pod-slot checks that give `acc_alloc` (and `acc_pipe`).
//
// With host ports a task also fails when an earlier live task on the same
// node asks for one of its ports, or its node already uses one (allocated
// | pipelined; wave.py:1735-1747).  A profile anti-affine to its own
// labels (`self_anti`) holds at most one copy per ranked node in step 1
// (wave.py:1690-1696).
//
// The prefix requests are summed in double: request values are integers in
// milli-units and bytes, so the sums are exact and independent of order
// before the one rounding to float that the JAX f32 matmul also makes when
// its sum is exact.
//
// One block does the whole wave: steps 2 and 3 are O(W^2) compares
// (4M at W = 2048) over arrays that sit in L1/L2, a few tens of
// microseconds; the bytes read are a few hundred KB, so the bound is
// microseconds and the launch plus the host loop's sync dominate.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(1024) walk_accept_kernel(
    const int32_t* ranked, const uint8_t* feas_k, int UM, int K,
    const float* p_req, const float* p_init_req, int R, const int32_t* pid_l,
    const uint8_t* cand_s, const uint8_t* any_feas, const uint8_t* grp,
    int W, const float* idle, const float* rel, const float* pip,
    const float* pxe, const int32_t* pip_ntasks, const int32_t* ntasks,
    const int32_t* max_tasks, int N, const float* eps,
    const uint8_t* scalar_slot, float* cumcap, uint8_t* live,
    int32_t* out_choice, uint8_t* out_acc, uint8_t* out_pipe,
    const uint32_t* ports, int PW, const uint32_t* nport,
    const uint32_t* pip_nport, const uint8_t* self_anti) {
  // 1. live capacity of every ranked node, then its running sum.
  for (int idx = threadIdx.x; idx < UM * K; idx += blockDim.x) {
    const int u = idx / K;
    const int n = ranked[idx];
    float id[vtt::kMaxR];
    vtt::future_idle(idle, rel, pip, pxe, n, R, id);
    const float* rq = p_req + static_cast<int64_t>(u) * R;
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
    cumcap[idx] = c;
  }
  __syncthreads();
  for (int u = threadIdx.x; u < UM; u += blockDim.x) {
    float run = 0.0f;
    for (int k = 0; k < K; ++k) {
      run = k == 0 ? cumcap[u * K] : run + cumcap[u * K + k];
      cumcap[u * K + k] = run;
    }
  }
  __syncthreads();
  // 2. contention-group rank, walk position and choice.
  for (int t = threadIdx.x; t < W; t += blockDim.x) {
    const int u = pid_l[t];
    int m = 0;
    for (int t2 = 0; t2 < t; ++t2) {
      m += (cand_s[t2] && grp[u * UM + pid_l[t2]]) ? 1 : 0;
    }
    const float mf = static_cast<float>(m);
    int j = 0;
    for (int k = 0; k < K; ++k) j += cumcap[u * K + k] <= mf ? 1 : 0;
    const bool cs = cand_s[t] && any_feas[t];
    const bool overflow = cs && j >= K;
    j = j < K - 1 ? j : K - 1;
    int ch = ranked[u * K + j];
    ch = ch < 0 ? 0 : (ch > N - 1 ? N - 1 : ch);
    out_choice[t] = ch;
    live[t] = (cs && !overflow) ? 1 : 0;
  }
  __syncthreads();
  // 3. strictly-earlier same-node prefix and the acceptance checks.
  for (int t = threadIdx.x; t < W; t += blockDim.x) {
    const int ch = out_choice[t];
    double cum[vtt::kMaxR];
    for (int s = 0; s < R; ++s) cum[s] = 0.0;
    int cnt = 0;
    bool port_conf = false;
    const uint32_t* my_ports =
        ports ? ports + static_cast<int64_t>(pid_l[t]) * PW : nullptr;
    for (int t2 = 0; t2 < t; ++t2) {
      if (live[t2] && out_choice[t2] == ch) {
        const float* rq2 = p_req + static_cast<int64_t>(pid_l[t2]) * R;
        for (int s = 0; s < R; ++s) cum[s] += static_cast<double>(rq2[s]);
        ++cnt;
        if (my_ports) {
          const uint32_t* p2 = ports + static_cast<int64_t>(pid_l[t2]) * PW;
          for (int w = 0; w < PW; ++w) {
            if (my_ports[w] & p2[w]) port_conf = true;
          }
        }
      }
    }
    const bool port_live =
        my_ports && vtt::ports_clash(my_ports, nport, pip_nport, ch, PW);
    const float* irq = p_init_req + static_cast<int64_t>(pid_l[t]) * R;
    float need[vtt::kMaxR];
    for (int s = 0; s < R; ++s) need[s] = irq[s] + static_cast<float>(cum[s]);
    const bool fits_idle = vtt::less_equal(
        need, idle + static_cast<int64_t>(ch) * R, eps, scalar_slot, R);
    bool fits_fut = false;
    if (rel) {
      float fut[vtt::kMaxR];
      vtt::future_idle(idle, rel, pip, pxe, ch, R, fut);
      fits_fut = vtt::less_equal(need, fut, eps, scalar_slot, R);
    }
    const int mt = max_tasks[ch];
    const int nt = ntasks[ch] + (pip_ntasks ? pip_ntasks[ch] : 0);
    const bool pods_fit = mt <= 0 || nt + cnt < mt;
    const bool clean = live[t] && pods_fit && !port_conf && !port_live;
    out_acc[t] = (clean && fits_idle) ? 1 : 0;
    if (out_pipe) out_pipe[t] = (clean && !fits_idle && fits_fut) ? 1 : 0;
  }
}

}  // namespace

extern "C" int vtt_walk_accept(
    const void* ranked, const void* feas_k, int UM, int K, const void* p_req,
    const void* p_init_req, int R, const void* pid_l, const void* cand_s,
    const void* any_feas, const void* grp, int W, const void* idle,
    const void* rel, const void* pip, const void* pxe, const void* pip_ntasks,
    const void* ntasks, const void* max_tasks, int N, const void* eps,
    const void* scalar_slot, void* cumcap, void* live, void* out_choice,
    void* out_acc, void* out_pipe, const void* ports, int PW,
    const void* nport, const void* pip_nport, const void* self_anti,
    void* stream) {
  walk_accept_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ranked), static_cast<const uint8_t*>(feas_k),
      UM, K, static_cast<const float*>(p_req),
      static_cast<const float*>(p_init_req), R,
      static_cast<const int32_t*>(pid_l), static_cast<const uint8_t*>(cand_s),
      static_cast<const uint8_t*>(any_feas), static_cast<const uint8_t*>(grp),
      W, static_cast<const float*>(idle), static_cast<const float*>(rel),
      static_cast<const float*>(pip), static_cast<const float*>(pxe),
      static_cast<const int32_t*>(pip_ntasks),
      static_cast<const int32_t*>(ntasks),
      static_cast<const int32_t*>(max_tasks), N,
      static_cast<const float*>(eps), static_cast<const uint8_t*>(scalar_slot),
      static_cast<float*>(cumcap), static_cast<uint8_t*>(live),
      static_cast<int32_t*>(out_choice), static_cast<uint8_t*>(out_acc),
      static_cast<uint8_t*>(out_pipe), static_cast<const uint32_t*>(ports),
      PW, static_cast<const uint32_t*>(nport),
      static_cast<const uint32_t*>(pip_nport),
      static_cast<const uint8_t*>(self_anti));
  return static_cast<int>(cudaGetLastError());
}
