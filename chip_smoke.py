#!/usr/bin/env python3
"""Chip smoke of volcano_tpu_torch: the quickest proof that the port starts
and is right on an NVIDIA GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

(``python3 chip_smoke.py pipeline`` runs phase 8b alone, ``python3
chip_smoke.py obs`` phases 8c and 8d, ``python3 chip_smoke.py seq-trace``
the traced seq cycle of phase 21 alone, ``python3 chip_smoke.py recovery``
phases 24-31, ``python3 chip_smoke.py single-phase`` phases 32-34,
``python3 chip_smoke.py host-walk`` phases 35-37, ``python3 chip_smoke.py
remote`` phases 38-41, ``python3 chip_smoke.py control`` phases 42-44;
``crash-sticky``, ``lockdep <hash>`` and
``trace-dir`` are the child processes of phases 29, 30 and 31,
``solver-child`` the solver child of 38-41.)  It
builds the sixteen CUDA kernels of ``volcano_tpu_torch/csrc`` (fourteen
sources, one nvcc each, started together; ``launch_floor.cu`` holds only an
empty kernel, timed to give what one launch costs) and then runs these
phases, each
of which raises (and the script exits non-zero) when a check fails:

1. small reference: a 64-node x 512-pod solve on the card equals the same
   solve on the CPU (the plain versions, which the CPU tests hold against
   the JAX package bit for bit);
2. solve path: the north-star cluster (10,000 nodes x 100,000 pods, gangs
   of 8, 16 zones, binpack + nodeorder scorers) through
   ``solve_args_from_store`` and ``solve_wave`` on the card; launch counts
   zeroed just before and read just after; invariants; the median wall
   time of 3 more solves, and one solve traced with ``torch.profiler``
   (every kernel function's summed device time and launches);
3. plain: the same solve with the plain PyTorch versions forced on the
   card; every result field must be identical;
4. the solve path's kernels against their plain versions on the inputs of
   their first launch, timed with CUDA events around 20 back-to-back calls
   queued behind a sleep kernel (the wrappers' host work is reported
   apart); ``rank_candidates`` also on its first fallback launch (all N
   nodes);
5. features: 1,000 nodes x 10,000 pods with taints, selectors, node
   affinity and finite deserved shares, kernels against plain versions;
6. the cycle, the port's main path: ``Scheduler(store).run_once()`` with
   the deployed conf on the north-star store -- one cold cycle (all
   100,000 pods bound, devsnap full uploads), 5 steady cycles re-pending
   the pods on nodes 0-63 (warm shortlists and static-plane hits
   required), one traced steady cycle (device idle share), and one cycle
   after ``update_node`` gives 100 nodes half as much CPU again (a devsnap
   delta and a full re-rank required; the delta one ``scatter_planes``
   launch a chunk, the host time of ``DeviceSnapshot.node_planes``
   printed), then a second such cycle whose ``node_planes`` call is traced
   (its device operations: one copy and one launch a chunk, one copy a
   plane re-uploaded whole); a cycle launches ``static_planes`` once a
   static miss and never on a hit (printed per cycle); launch counts
   zeroed before the first cycle and read after the last: every kernel
   must have launched; invariants after every cycle;
7. lanes on / off: the same sequence at 1,000 x 10,000 with the
   device-incremental lane and the device snapshot on, then off; binds,
   PodGroup phases and mirror states identical;
8. every kernel of the cycle against its plain version on its captured
   inputs, timed as in 4: ``scatter_rows`` as the multi-plane launch of
   the update cycle's delta beside ``index_copy_`` on each plane, the
   one-plane launches and the packed copy with its launch;
   ``static_planes`` also as its share of the north-star solve's row-form
   shortlist launch, which builds the planes itself (that launch against
   the same launch reading given planes, and the pair of launches it
   replaced: the planes equal to the plain version's, every output to the
   pair's);
8b. pipeline: ``store.pipeline`` with ``async_bind`` (the solve on the
   store's solve worker, its own thread and CUDA stream, committed the next
   cycle behind the staleness guard; ``VOLCANO_TPU_FALLBACK=never`` is set
   for the whole run).  At 1,000 x 10,000 a cold dispatch, an
   ``update_node`` and a ``delete_pod`` during the overlap, two steady
   cycles and a drain, on the card and on the CPU: binds, drops by reason,
   solve ids and mirror states identical.  At the north star: the solve on
   the worker against the calling thread, in turns, and the launch
   counter's lock (``[pipeline:worker-ab]``); cycle 1 only dispatches,
   cycle 2 commits -- its placements those of phase 6's cold cycle, the
   solve's launches its launches -- then 5 steady cycles re-pending nodes
   0-63, one traced with the solve it dispatched (device busy against wall,
   idle share), an ``update_node`` of 100 nodes and a gang deleted during
   the overlap (its rows dropped as ``deleted``), a drain; after every
   cycle no node over capacity, no key bound twice, the binder, the mirror
   and the pod records agreeing, ``host_reads`` 0 for every fetched solve;
   after the drain every pod bound, gangs whole; per cycle the wall, the
   fetch wait, lanes, ids and drops printed; the worker's captured
   launches replayed against the plain versions; then a pipelined preempt
   (``priority_tier_workload(2,000 workers, a 1,000-task serving gang)``)
   card against CPU, ``victim_scores`` launched beside a worker solve;
   the north-star store's flight records and journey rows written with
   ``obs.export.write_trace`` and parsed back: one dispatch -> commit flow
   per committed solve id, journey instants on committed solve ids only;
8c. obs: every store of every phase runs with the default observability
   (the conservation auditor with its SLO tracker and the pod journey);
   each fast-path phase ends with no auditor anomaly, at least one audited
   cycle, and the journey's conservation check clean over its placed pods
   (``audit_checked``: ``audit_stats()`` and the journey's ``stats()``
   printed; an auditor error is an anomaly, so it fails the run).  At the
   north star, two stores loaded from the checkpoint of phase 6's store
   (taken before its cold cycle), one with ``VOLCANO_TPU_AUDIT_SAMPLE=1``
   (the aggregate re-verify and the encode and devincr sentinels every
   cycle), one with ``VOLCANO_TPU_AUDIT=0 VOLCANO_TPU_JOURNEY=0``: a cold
   and 5 steady cycles each, binds equal, every solve's launches and syncs
   equal, ``host_reads`` 0; then on against off in turns at the default
   sample rate, once each: a
   re-cold cycle (caches dropped, a fresh
   journey, every pod placed again), a steady cycle, a pipelined steady
   cycle -- walls and the self-timed audit and journey time;
8d. ha: the checkpoint of 8c (its bytes, save and load seconds); the
   loaded store's cold binds equal phase 6's cold binds pod for pod; a
   scheduler gated
   on a ``LeaderElector`` whose lease another identity holds: no bind, no
   cycle and no launch over 10 periods of ``Scheduler.run()``; after the
   holder releases, every pod of a 1,000 x 10,000 store bound; healthy
   after ``stop()``;
9. reclaim (BASELINE config 4): ``preempt_cluster(10,000 nodes, 4 fillers
   a node, 20,000 pending pods in gangs of 4)`` under the preempt + reclaim
   conf, ``ClusterSimulator(grace_steps=2)`` stepped after every cycle: a
   reclaim wave a cycle, its victims Releasing through the grace window
   (future-branch solves), restored as Pending after it;
10. preempt: ``priority_tier_workload(10,000 workers, a 5,000-task serving
   gang)`` with ``VOLCANO_TPU_EVICT_CAP=10000``: one wave of 5,000 victims,
   the gang pipelined onto their releasing capacity, then bound within 24
   cycles, 5,000 evictions and 5,000 restores.
   After every cycle of 9 and 10: no node over its allocatable (Releasing
   pods still charged), gangs whole, the pod count unchanged (every
   deleted victim came back as one restored pod), no device plane read
   back by any solve (what-if solves included); at least one future-branch
   solve per phase; launch counts zeroed before each phase and read after;
11. ``victim_scores`` in both modes and the five solve kernels on inputs
   captured from future-branch solves, against their plain versions, timed
   as in 4; beside ``victim_scores``, ``torch.sort(stable=True)`` of its
   packed order key (a yardstick for the sort alone);
12. rebalance: bench.py ``config_rebalance`` at 5,000 workers (10,000
   nodes, 5,000 stranded 3-cpu fillers placed by a set-up cycle, a
   2,500-task whole-node gang) under ``REBALANCE_SCHEDULER_CONF`` with
   ``VOLCANO_TPU_REBALANCE_DRAIN_CAP=5000``, grace 2, at most 8 cycles: the
   gang bound, every filler bound again, evictions equal to restores, no
   pod lost; the plan cycle traced (device idle share);
13. topology: ``fabric_cluster(16 racks x 8 slices x 64 nodes, a 128-task
   require-contiguous gang)``, 8,192 nodes in 128 blocks: cycle 0 gates
   the gang and commits one plan (traced), and the gang ends bound inside
   exactly one block with all 256 fillers bound again; ``fabric_frag`` is
   written by the block fit's launch (its own kernel launched 0 times),
   and every plan's ``volcano_topology_frag_score`` gauge equals the plain
   ``fabric_frag`` of the block fit that plan fetched; then, on a fresh
   fabric, one plan call traced (the ``[rebalance:plan-trace]`` line: its
   device operations, copies by direction and kernels, and the
   synchronising calls torch's sync debug mode flags);
14. prefer-contiguous: the same fabric binds the gang on cycle 0, through
   a biased ranking;
   after every cycle of 12-14 the checks of 9-10, the what-if engine's
   plan and what-if-solve spans printed with the lanes; launch counts
   zeroed before each phase and read after, each phase's kernels required;
15. ``frag_scores``, ``gang_block_fit`` and the biased
   ``rank_candidates`` on their captured inputs against their plain
   versions, timed as in 4; the standalone ``fabric_frag`` kernel on the
   captured block fit's ``cfit`` / ``whole`` (its row's launches are the
   block-fit launches that wrote the plane on the path);
16. affinity: BASELINE config 5 (bench.py ``config_5``: gangs of 8, 16
   zones, 5% required zone affinity, 5% required hostname anti-affinity,
   10% zone spread) at 10,000 nodes x 100,000 pods under CONF_BASE through
   ``run_once()``: one cold cycle (the count and profile tables shipped
   sparse and scattered on the card), 5 steady cycles re-pending the pods
   on nodes 0-63 (nonzero resident counts, encode-cache hits), one traced
   steady cycle (device idle share); launch counts zeroed before and read
   after, ``scatter_cnt0``, ``scatter_profile_tables``, ``aff_live`` and
   ``aff_filter`` required, the static planes' own launches and those
   built in a shortlist launch printed per cycle; after every cycle every pod bound, no node
   over capacity, gangs whole, every zone-affine gang in one zone, every
   anti-affine gang on distinct nodes, no host port twice on a node, no
   device plane read back; ``aff_live``'s computing and gated launches
   (the attempt cache); then the cold cycle again on a fresh store of the
   same seed, traced: every kernel's device time and launches summed over
   it (per wrapper and per CUDA function), ``aff_live``'s computing and
   gated launches, and the kernels' share of the ``device_fine`` lane;
17. affinity:small: the same mix at 1,000 x 10,000 with host ports on 10%
   of the gangs: 8 steady cycles (a warm shortlist on nonzero counts
   required), and on a second store a release (the pods of nodes 0-63
   terminating, 16 gangs selecting those nodes: pipelined tasks and
   pipelined ports); each run on the card against the CPU (plain
   versions: binds, PodGroup phases, mirror states and fallback counters
   identical) and with the lanes on against off;
18. affinity:chunks: the 1,000 x 10,000 store with
   ``VOLCANO_TPU_AFF_BUDGET_MB=2``: the cold cycle solves in at least 4
   job-aligned chunks; card against CPU;
19. the four affinity kernels, and the extended ``coarse_shortlist``,
   ``rank_candidates`` (its shortlist and its fallback launch),
   ``walk_accept``, ``apply_commit`` and ``warm_shortlist`` on affinity
   inputs, against their plain versions, timed as in 4 (``scatter_cnt0``
   beside ``index_put_``); ``aff_live`` again with its gate clear (a
   cached attempt's launch: the buffers unchanged); the cold cycle's
   block-form ``coarse_shortlist`` launch (every profile row ranked per
   node block and merged) as a kernels row of its own,
   ``coarse_shortlist:cold``, with its shape (U, N, B, klb, S);
20. object: BASELINE config 2 (bench.py ``config_2``: 1,000 nodes x 10,000
   pods, gangs of 4) under CONF_BASE with ``VOLCANO_TPU_FASTPATH=0``: two
   object-session cycles (open, the conf's actions, close; the pods of
   nodes 0-63 re-pended before the second), on the card and on the
   CPU: binds, PodGroup phases and mirror states identical every cycle,
   ``cycle_invariants`` after every cycle, a flight record with path
   "object", the lanes printed; the wave solve's kernels required;
21. seq: the same under ``solver: seq``: ``seq_solve`` required, card
   against CPU, and the kernel against its plain version on the inputs of
   its first launch, timed as in 4 but one call a turn, the plain version
   timed on the one call that checks it (kernel, kernel); then a cold seq
   cycle on a fresh store traced with ``torch.profiler`` in a process of
   its own
   (``python3 chip_smoke.py seq-trace``: the card's idle share, from the
   trace alone; three traces without the solve's two kernels fail the
   phase), the allocate lane, and the solve's launches timed by CUDA
   events around the library call;
22. seq:north-star: the solve args of 2 through the sequential solve on
   the card: one launch, its wall time, the invariants of 2;
23. custom: the config-2 store with a device-mask plugin (a fifth of the
   nodes vetoed per gang) and a batch scorer (three nodes a task), under
   the wave and the sequential solver, card against CPU, every bind on an
   allowed node; ``coarse_shortlist`` and ``rank_candidates`` on their
   custom-plugin inputs against their plain versions, timed as in 4;
24. warm-knobs: phase 7's sequence at 1,000 x 10,000 with
   ``VOLCANO_TPU_WARM_BLOCKS=4`` and ``VOLCANO_TPU_WARM_BLOCK_ROWS=256``, on
   the card and on the CPU: binds, the solve's warm-block geometry every
   cycle and the warm / full / skip counts identical, one cycle warm, the
   block count the knobs give;
25. affinity:crash: phase 18's store (config 5 at 1,000 x 10,000,
   ``VOLCANO_TPU_AFF_BUDGET_MB=2``) with a ``torch.cuda.OutOfMemoryError``
   raised at the cold cycle's second chunk's solve: the cycle completes,
   the chunk budget's scale halves (one ``DeviceCrashRecovered`` event,
   one crash-recovery count), the rest re-solves in more chunks, binds
   equal the CPU run given the same injection, the invariants of 16; 8
   clean affinity cycles bring the scale back to 1;
26. affinity:crash:ns: config 5 at 10,000 x 100,000, the default budget;
   first [fallback]'s north-star half on the fresh store (pending tasks x
   nodes 1e9 > 5e7: with ``VOLCANO_TPU_FALLBACK=auto`` an injected
   fast-path failure raises), then one out-of-memory error in the cold
   cycle: every pod bound, the invariants of 16, ``host_reads`` 0;
27. pipeline:crash: the pipelined 1,000 x 10,000 store; the worker's
   first solve raises the out-of-memory error, which surfaces at the
   fetch: its rows dropped as ``device-crash`` (journey rows too), the
   scale halved, after a drain every pod bound; card against CPU;
28. fallback: config 2 with ``VOLCANO_TPU_FALLBACK=auto`` for the
   phase only and ``FastCycle._allocate`` raising once: the object session
   binds every pod (path "object"), card against CPU, ``never`` restored;
29. crash:sticky: ``python3 chip_smoke.py crash-sticky``: a real
   device-side assert inside the solve; the child must exit non-zero with
   the crash classified, the probe failed and the original error raised;
30. lockdep: ``python3 chip_smoke.py lockdep <hash>`` with
   ``VOLCANO_TPU_LOCKDEP=1``: the pipelined north-star sequence with
   asynchronous binds (cold, 3 steady cycles re-pending nodes 0-63, an
   ``update_node`` during an overlap, a drain; the cold binds hashed
   against phase 6's) and the pipelined preempt of 8b: no
   ``lockdep-violation``, no ``lock-order-cycle``, order edges seen, the
   armed run's walls (the unarmed run beside it, the cost of enforcement,
   is not repeated);
31. trace-dir: ``python3 chip_smoke.py trace-dir``: one cycle at 1,000 x
   10,000 with ``VOLCANO_TPU_TRACE_DIR`` writes one Chrome trace holding
   the port's kernels; under an outer profiler a cycle binds every pod,
   writes nothing and warns.  The ``[recovery] seconds`` line gives each
   of 24-31's seconds;
32. single-phase: the north-star solve and its cycles with
   ``VOLCANO_TPU_TWOPHASE=0``, card against CPU at 1,000 x 10,000;
33. single-phase:affinity: config 5's cold cycle single-phase;
34. steer: config 5 with ``VOLCANO_TPU_AFF_STEER=1`` (``aff_steer``), card
   against CPU in both phase modes and on a contended store; its first
   launch replayed computing and gated against the plain version, each
   call one ``aff_steer_row_kernel`` on the card (a trace's names, a CUDA
   graph's count: ``[kernels:steer]``).  The
   ``[single-phase] seconds`` line gives each of 32-34's seconds;
35. host-walk:reclaim: the host victim walk (``VOLCANO_TPU_EVICT_DEVICE=0``)
   on BASELINE config 4 at its full size (phase 9's store) under the
   preempt + reclaim conf, grace 2, 6 cycles: after every cycle the
   capacity and gang checks of 9, no device plane read back, every pod
   that left the store evicted (the walk deletes its victims: no ledger
   restores them) and the mirror holding the store's pods; the exact
   evictions per cycle (20,000, then 40,000: every filler) and all 20,000
   reclaimers bound, the proportions the CPU tests hold at small sizes
   against the JAX package's walk; every eviction deleted after its grace
   or still terminating; the native reclaim drive (``csrc/host/vcreclaim.cc``,
   built with g++) ran every reclaim action in C; no ``victim_scores``
   launch and no what-if plan; the allocate kernels launched; per cycle
   the wall and the preempt / reclaim / allocate lanes;
36. host-walk:preempt: phase 10's store with the walk: the serving gang
   bound within 24 cycles through statement-wrapped preemption, exactly
   5,000 evictions in the first cycle and 10,000 from the second on, the
   checks of 35;
37. host-walk:twin: at 1,000 nodes, ``preempt_cluster`` and a two-queue
   store (the JAX package's tests/test_reclaim_multiqueue.py shape), 5
   walk cycles (the simulator stepped, grace 1) on the card against the
   CPU, and with the native drive against ``VOLCANO_TPU_NO_NATIVE=1``,
   through the CPU tests' own harness (``tests/test_torch_fixtures.py``'s
   ``walk_run``): evicted and pipelined uids, evictor keys, binds,
   PodGroup phases and mirror states identical every cycle, the audit
   clean after each.  The
   ``[host-walk] seconds`` line gives each of 35-37's seconds;
38. remote: the solver service.  Solver children (``python3 chip_smoke.py
   solver-child``: the port's ``SolverServer`` on the card, started with
   ``subprocess``, reusing this run's kernel build) serve the wave solves.
   The north-star store of 6 through a ``RemoteSolver``: a cold and 5
   steady cycles re-pending nodes 0-63, the binds of each equal phase 6's
   (by hash), the steady frames deltas, the invariants after every cycle,
   the wire audit every cycle without an anomaly, no kernel launched in
   this process and every kernel of ``REMOTE_KERNELS`` (PERF.md rows 1-4,
   2a-2c) in the child, which replays each one's first launch against its
   plain version when it stops; per cycle the wall, the frame kind and
   bytes, the child's ``solve_ms`` and the wait for the reply;
39. remote:shm: the same sequence at 1,000 x 10,000 over TCP and over the
   shared-memory lane (``VOLCANO_TPU_SHM=1``): binds equal each other and
   the local cycles', no ``remote_frame_fallback_total``;
40. remote:heal: a pipelined store at 1,000 x 10,000; the child killed
   with a solve in flight: the reply lost and its rows re-placed, the
   restarted child's first frame full, deltas again, every pod bound, the
   binds those of a local run losing the same reply;
41. remote:pool: two children on the one card (the mechanism, not
   multi-card scale): a pool of one equal to a single client (binds,
   frames, bytes); a hedge forced by a child holding its reply (the hedge
   wins, the held reply drains, binds unchanged); the what-if offload on
   BASELINE config 4 at 1,000 nodes (the evictions of the local what-if,
   cycle by cycle); failover after the primary child is killed (one
   cycle's lost reply, no pod lost).  The ``[remote] seconds`` line gives
   each of 38-41's seconds;
42. control:twin: the control plane in lockstep at 1,000 nodes, through
   the CPU tests' own harness (``tests/test_torch_fixtures.py``'s
   ``control_run``: both example job files, a mix over four queues of
   weights 1 / 2 / 4 / 8 with gangs of 2-16, a ``tpuslice`` job, a failed
   pod restarting its job, a failed node, AbortJob / ResumeJob, a queue
   closed and opened, a job collected by the TTL GC and one deleted; each
   step ``ControllerManager.process()``, ``run_once()``, ``sim.step()``)
   on the card against the CPU: job phases and retry counts, the pods'
   names, env, annotations and affinity, binds, PodGroup phases, queue
   states and events identical after every step, the auditor clean; the
   wave solve's kernels and ``aff_live`` (the slice term) launched;
43. control:service: the daemon on the card (``Service(simulate=True)``
   over the north-star nodes, the deployed conf from a file, its own
   scheduler, controller and HTTP threads): 4 queues created over HTTP,
   2,000 jobs of 8 (16,000 pods) through the admitted store, both example
   files through ``python -m volcano_tpu_torch.cli job run -f`` in
   children; a bounded wait until every job is Running; every gang whole,
   no node over capacity, no pod lost; the submit-to-all-Running wall,
   per-job submit-to-Running p50 / p99, the placing cycles with their
   lanes; ``/healthz``, ``/metrics``, ``/debug/health``, ``/debug/cycles``,
   ``/debug/pods/<uid>``, ``/debug/trace``, ``job list`` and ``job view``;
   rows 1-4 and 2a-2c launched in this process, each first launch
   replayed against its plain version;
44. control:config1: BASELINE config 1 as ``bench.py:630-681`` drives it
   (prewarmed, 2 nodes, a 3-replica gang, periods 0.01 / 0.005 s): the
   submit-to-3-Running ms of 5 runs and their median; then the same job
   with ``--remote-binder`` / ``--remote-evictor`` /
   ``--remote-status-updater`` at a ``python -m
   volcano_tpu_torch.cache.remote --port 0`` child: the binds and the
   PodGroup status land in the child.  The ``[control] seconds`` line
   gives each of 42-44's seconds, the ``[phases]`` line each phase
   group's.

Output: the card's name and power limit, versions, build time, the
registers, shared memory and spills of the kernels of ``PTXAS_SOURCES``
(``nvcc -Xptxas -v``), the device time of an empty kernel's launch (the
``[kernels:floor]`` line: ``<<<>>>``, and a cluster of 1 and of 8 CTAs
through ``cudaLaunchKernelEx``), per-phase
lines with the cycles' lane times, one ``{"kernels": [...]}`` line (where
no one PyTorch call computes a kernel's function, ``yardstick`` names the
nearest PyTorch sequence and ``yardstick_ms`` times it; ``library_ms`` is
then null) and,
last, one ``{"ok": true, "device": {...}}`` line.  Without CUDA, or
without the package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

MEM_BPS = 3.35e12  # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
F32_OPS = 67e12  # H100 SXM float32 operations/s outside the tensor cores


def _log(*a):
    print(*a, flush=True)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# The sources whose kernels' registers, shared memory and spills
# (`nvcc -Xptxas -v`) the run prints.
PTXAS_SOURCES = ("rank_candidates.cu", "aff_live.cu", "aff_steer.cu",
                 "walk_accept.cu", "aff_filter.cu", "coarse_shortlist.cu",
                 "warm_shortlist.cu", "apply_commit.cu", "seq_solve.cu",
                 "victim_scores.cu", "topology.cu", "aff_tables.cu",
                 "scatter_rows.cu", "frag_scores.cu")


def ptxas_report(sources=PTXAS_SOURCES) -> dict:
    """`nvcc -Xptxas -v` of ``sources`` with the kernels' build flags (one
    nvcc each, started together, objects to the build directory): per
    kernel function its registers, shared memory and spill bytes."""
    import re

    from volcano_tpu_torch.ops import kernels

    # Mangled names hold the plain ones; the longest match wins.
    names = sorted({f.split("<")[0] for fs in KERNEL_FUNCS.values()
                    for f in fs}, key=len, reverse=True)
    out_dir = kernels._BUILD
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = [(src, subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         str(kernels._CSRC / src), "-o", str(out_dir / f"ptxas_{src}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in sources]
    outs = [(src, p.communicate()[0], p.returncode) for src, p in procs]
    report = {}
    for src, text, rc in outs:
        if rc != 0:
            raise RuntimeError(f"nvcc -Xptxas -v {src} failed:\n{text}")
        fn = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = next((k for k in names if k in m.group(1)), m.group(1))
                # A template's instances apart: f<4, 1024> from
                # ...fILi4ELi1024EE...
                t = re.search(re.escape(fn) + r"I((?:L[a-z]\d+E)+)E",
                              m.group(1))
                if t:
                    fn += "<" + ", ".join(
                        re.findall(r"L[a-z](\d+)E", t.group(1))) + ">"
                report[fn] = {"source": src}
                continue
            if fn is None:
                continue
            m = re.search(r"(\d+) bytes stack frame", line)
            if m:
                report[fn]["stack_bytes"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                report[fn]["spill_bytes"] = [int(m.group(1)),
                                             int(m.group(2))]
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report[fn]["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                report[fn]["smem_bytes"] = int(sm.group(1)) if sm else 0
    return report


# ------------------------------------------------------------- clusters

def feature_store(n_nodes: int, n_pods: int, seed: int):
    """Taints on a quarter of the nodes, four zones, two disk kinds; gangs
    of 1-8 pods over two queues, a sixth pinning a zone by selector, a
    sixth tolerating the taint, a sixth requiring one of two zones, a sixth
    preferring hdd nodes and tolerating every taint."""
    import numpy as np

    from volcano_tpu_torch.api import (GROUP_NAME_ANNOTATION, Node, Pod,
                                       PodGroup, Queue, Taint, Toleration)
    from volcano_tpu_torch.cache import ClusterStore

    rng = np.random.default_rng(seed)
    store = ClusterStore()
    for i in range(n_nodes):
        taints = ([Taint(key="dedicated", value="batch", effect="NoSchedule")]
                  if i % 4 == 3 else [])
        store.add_node(Node(
            name=f"node-{i:05d}",
            allocatable={"cpu": "32", "memory": "128Gi", "pods": 110},
            labels={"zone": f"zone-{i % 4}", "disk": "ssd" if i % 3 else "hdd"},
            taints=taints,
        ))
    store.add_queue(Queue(name="queue-1", weight=2))
    queues = ["default", "queue-1"]
    made, g = 0, 0
    while made < n_pods:
        size = min(int(rng.integers(1, 9)), n_pods - made)
        name = f"pg-{g:06d}"
        store.add_pod_group(PodGroup(
            name=name, min_member=max(1, size - int(rng.integers(0, 2))),
            queue=queues[g % 2]))
        cpu = str(rng.choice(["1", "2", "4"]))
        mem = str(rng.choice(["2Gi", "4Gi", "8Gi"]))
        kind = int(rng.integers(0, 6))
        extra = {}
        if kind == 0:
            extra["node_selector"] = {"zone": f"zone-{g % 4}"}
        elif kind == 1:
            extra["tolerations"] = [Toleration(
                key="dedicated", operator="Equal", value="batch",
                effect="NoSchedule")]
        elif kind == 2:
            extra["required_node_affinity"] = [
                {"zone": "zone-0"}, {"zone": "zone-2", "disk": "ssd"}]
        elif kind == 3:
            extra["preferred_node_affinity"] = [({"disk": "hdd"}, 3),
                                                ({"zone": "zone-1"}, 1)]
            extra["tolerations"] = [Toleration(operator="Exists")]
        for k in range(size):
            store.add_pod(Pod(
                name=f"{name}-{k}",
                annotations={GROUP_NAME_ANNOTATION: name},
                containers=[{"cpu": cpu, "memory": mem}],
                **extra))
            made += 1
        g += 1
    return store


# ------------------------------------------------------------ checks

def check_invariants(args, res) -> dict:
    """No idle below -eps; idle = idle0 - committed requests (exact: every
    request is a multiple of 1000 milli-CPU and 1 GiB, so the float sums
    are exact); gangs all-or-nothing against min_available; every assigned
    node ready, static-feasible (selector, required affinity, taints),
    within its pod slots."""
    import numpy as np

    from volcano_tpu_torch.device import to_numpy

    nodes, tasks, jobs, _q, _w, eps, _slot, _aff = args
    n = {f: to_numpy(getattr(nodes, f)) for f in nodes._fields}
    t = {f: to_numpy(getattr(tasks, f)) for f in tasks._fields}
    j = {f: to_numpy(getattr(jobs, f)) for f in jobs._fields}
    eps = to_numpy(eps)
    assigned = to_numpy(res.assigned).astype(np.int64)
    idle = to_numpy(res.idle)
    never = to_numpy(res.never_ready)
    P = assigned.shape[0]
    real = t["real"][:P]
    if assigned.shape != (P,) or idle.shape != n["idle"].shape:
        raise AssertionError("result shapes")
    if not np.isfinite(idle).all():
        raise AssertionError("non-finite idle")
    if (idle < -eps[None, :]).any():
        raise AssertionError("idle below -eps")
    on = np.flatnonzero(assigned >= 0)
    if (~real[on]).any():
        raise AssertionError("padded task assigned")
    nn = assigned[on]
    use = np.zeros(n["idle"].shape, np.float64)
    np.add.at(use, nn, t["req"][on].astype(np.float64))
    want = (n["idle"].astype(np.float64) - use).astype(np.float32)
    if not np.array_equal(want, idle):
        raise AssertionError("idle != idle0 - committed requests")
    lb = n["label_bits"].view(np.uint32)
    tb = n["taint_bits"].view(np.uint32)
    if not n["ready"][nn].all():
        raise AssertionError("task on a node that is not ready")
    sel = t["sel_bits"].view(np.uint32)[on]
    if ((sel & ~lb[nn]) != 0).any():
        raise AssertionError("node selector violated")
    tol = t["tol_bits"].view(np.uint32)[on]
    if ((tb[nn] & ~tol) != 0).any():
        raise AssertionError("untolerated taint")
    terms = t["aff_terms"][on]
    if (terms > 0).any():
        ab = t["aff_bits"].view(np.uint32)[on]  # [M, A, LW]
        sub = ((ab & ~lb[nn][:, None, :]) == 0).all(-1)
        real_term = np.arange(ab.shape[1])[None, :] < terms[:, None]
        if not ((sub & real_term).any(1) | (terms == 0)).all():
            raise AssertionError("required node affinity violated")
    cnt = np.bincount(nn, minlength=idle.shape[0])
    mt = n["max_tasks"]
    if ((mt > 0) & (n["ntasks"] + cnt > mt)).any():
        raise AssertionError("pod slots exceeded")
    per_job = np.bincount(t["job"][on], minlength=j["min_available"].shape[0])
    placed_jobs = np.flatnonzero(per_job > 0)
    if (j["ready_base"][placed_jobs] + per_job[placed_jobs]
            < j["min_available"][placed_jobs]).any():
        raise AssertionError("gang committed below min_available")
    if (per_job[: never.shape[0]][never] > 0).any():
        raise AssertionError("discarded job left an allocation")
    out = {"pods_bound": int(on.size), "jobs_discarded": int(never.sum())}
    # The wave solve's diagnostics (the sequential solve has none).
    for f in ("iters", "fb_exhausted"):
        if getattr(res, f) is not None:
            out[f] = int(to_numpy(getattr(res, f)))
    return out


def same_result(a, b, what: str) -> None:
    import numpy as np

    from volcano_tpu_torch.device import to_numpy

    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None and y is None:
            continue
        x, y = to_numpy(x), to_numpy(y)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{what}: field {f} differs")


# ----------------------------------------------------- kernel replays

def _nbytes(*tensors) -> int:
    import torch

    return sum(int(x.numel() * x.element_size()) for x in tensors
               if isinstance(x, torch.Tensor))


def _clone(cap: dict) -> dict:
    import torch

    def clone(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, tuple):
            return type(v)(*[clone(t) for t in v]) if hasattr(
                v, "_fields") else tuple(clone(t) for t in v)
        return v

    return {k: clone(v) for k, v in cap.items()}


def _tensors(*vals) -> list:
    """The tensors of ``vals``, tuples (NamedTuples too) flattened."""
    import torch

    out = []
    for v in vals:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, tuple):
            out.extend(_tensors(*v))
    return out


def _future_bytes(cap: dict, rows: int) -> int:
    """Bytes of the releasing-capacity planes a kernel reads at ``rows``
    distinct node rows (0 without them)."""
    fut = cap.get("future")
    if fut is None:
        return 0
    R = fut.rel.shape[1]
    planes = 2 + (fut.pxe is not None)
    return rows * (planes * R * 4 + (4 if fut.pip_ntasks is not None else 0))


def _kernel_fn(name, c, plain):
    """A zero-argument call of wrapper ``name`` on the inputs ``c`` (consumed:
    apply_commit updates them in place) that returns its outputs as a tuple
    of tensors.  Everything but the wrapper call is done here, outside the
    timed region."""
    import torch

    from volcano_tpu_torch.ops import affkernels, kernels
    from volcano_tpu_torch.ops.nodeclass import NodeClasses
    from volcano_tpu_torch.ops.wave import SolveProfiles

    if name == "coarse_shortlist":
        z = torch.zeros(1, dtype=torch.float32, device=c["req"].device)
        g = (lambda k: c.get(k, z))  # static planes given: no bit rows
        prof = SolveProfiles(
            req=c["req"], init_req=c["init_req"], ports=z,
            sel_bits=g("sel_bits"), aff_bits=g("aff_bits"),
            aff_terms=g("aff_terms"), tol_bits=g("tol_bits"),
            pref_bits=g("pref_bits"), pref_w=g("pref_w"), t_req_aff=z,
            t_req_anti=z, t_matches=z, t_soft=z)
        cls = NodeClasses(c["cls_id"], c.get("cls_label"),
                          c.get("cls_taint"), c.get("cls_ready"))
        # The planes are read at call time (static_share swaps them in).
        return lambda: tuple(kernels.coarse_shortlist(
            prof, cls, c["idle"], c["alloc"], c["ntasks"], c["max_tasks"],
            c["eps"], c["scalar_slot"], c["weights"], c["S"],
            c["has_taints"], stat=((c["stat_ok"], c["stat_score"])
                                   if "stat_ok" in c else None),
            n_blocks=c["n_blocks"],
            future=c.get("future"), ports=c.get("ports"), aff=c.get("aff"),
            extra=c.get("extra"), plain=plain))
    if name == "static_planes":
        z = torch.zeros(1, dtype=torch.float32, device=c["sel_bits"].device)
        prof = SolveProfiles(
            req=z, init_req=z, ports=z, sel_bits=c["sel_bits"],
            aff_bits=c["aff_bits"], aff_terms=c["aff_terms"],
            tol_bits=c["tol_bits"], pref_bits=c["pref_bits"],
            pref_w=c["pref_w"], t_req_aff=z, t_req_anti=z, t_matches=z,
            t_soft=z)
        cls = NodeClasses(None, c["cls_label"], c["cls_taint"],
                          c["cls_ready"])
        return lambda: tuple(kernels.static_planes(
            prof, cls, c["naff"], c["has_taints"], plain=plain))
    if name == "warm_shortlist":
        z = torch.zeros(1, dtype=torch.float32, device=c["req"].device)
        prof = SolveProfiles(
            req=c["req"], init_req=c["init_req"], ports=z, sel_bits=z,
            aff_bits=z, aff_terms=z, tol_bits=z, pref_bits=z, pref_w=z,
            t_req_aff=z, t_req_anti=z, t_matches=z, t_soft=z)
        return lambda: tuple(kernels.warm_shortlist(
            prof, c["cls_id"], c["stat_ok"], c["stat_score"], c["idle"],
            c["alloc"], c["ntasks"], c["max_tasks"], c["eps"],
            c["scalar_slot"], c["weights"], c["db"], c["cand_s"],
            c["cand_i"], c["S"], future=c.get("future"),
            ports=c.get("ports"), aff=c.get("aff"), plain=plain))
    if name == "scatter_rows":
        # The node-table delta of every plane in one launch.
        def scatter():
            kernels.scatter_planes(c["bufs"], c["staged"], c["k"],
                                   plain=plain)
            return tuple(c["bufs"])
        return scatter
    if name == "rank_candidates":
        return lambda: tuple(kernels.rank_candidates(
            c["rows"], c["cand"], c["ok_w"], c["score_w"], c["cls_id"],
            c["p_req"], c["p_init_req"], c["idle"], c["alloc"], c["ntasks"],
            c["max_tasks"], c["eps"], c["scalar_slot"], c["weights"], c["K"],
            future=c.get("future"), bias=c.get("bias"), ports=c.get("ports"),
            aff=c.get("aff"), extra=c.get("extra"), pids=c.get("pids"),
            plain=plain))
    if name == "walk_accept":
        live = torch.empty(c["pid_l"].shape, dtype=torch.bool,
                           device=c["pid_l"].device)

        def walk():
            out = kernels.walk_accept(
                c["ranked"], c["feas_k"], c["p_req"], c["p_init_req"],
                c["pid_l"], c["cand_s"], c["any_feas"], c["grp"],
                c["idle"], c["ntasks"], c["max_tasks"], c["eps"],
                c["scalar_slot"], future=c.get("future"),
                ports=c.get("ports"), self_anti=c.get("self_anti"),
                live_out=live, plain=plain)
            return tuple(x for x in out if x is not None) + (live,)
        return walk
    if name == "scatter_cnt0":
        return lambda: (affkernels.scatter_cnt0(
            c["rows"], c["cols"], c["vals"], c["e"], c["d"], plain=plain),)
    if name == "scatter_profile_tables":
        return lambda: tuple(affkernels.scatter_profile_tables(
            c["rows"], c["cols"], c["flags"], c["soft"], c["u"], c["e"],
            plain=plain))
    if name == "aff_live":
        return lambda: tuple(affkernels.aff_live(
            c["rows"], c["cand"], c["terms"], c["at"], gate=c.get("gate"),
            out=c.get("out"), plain=plain))
    if name == "aff_steer":
        return lambda: (affkernels.aff_steer(
            c["ranked"], c["feas_att"], c["at"], gate=c.get("gate"),
            out=c.get("out"), plain=plain),)
    if name == "aff_filter":
        gm = torch.full(tuple(c["at"].cnt_a.shape), c["W"],
                        dtype=torch.int32, device=c["acc"].device)

        def filt():
            affkernels.aff_filter(c["choice"], c["live"], c["pid_l"],
                                  c["at"], c["acc"], c["pipe"], gm=gm,
                                  term_req=c["term_req"],
                                  prof_req=c["prof_req"], plain=plain)
            return tuple(x for x in (c["acc"], c["pipe"]) if x is not None)
        return filt
    if name == "apply_commit":
        dev = c["idle"].device
        N, R = c["idle"].shape
        Q = c["q_alloc"].shape[0]
        scratch = kernels.commit_scratch(N, R, Q, dev)
        pip = None
        if "pipe" in c:
            pip = {k: c[k] for k in ("pip_extra", "pip_ntasks", "q_pip",
                                     "pipelined")}
            pip["scratch"] = kernels.commit_scratch(N, R, Q, dev)

        def call():
            kernels.apply_commit(
                c["node"], c["mask"], c["rows"], c["row_idx"], c["qidx"],
                c["idle"], c["q_alloc"], mode=c["mode"],
                idle_sign=c["idle_sign"], jw=c.get("jw"),
                ntasks=c.get("ntasks"), alloc_l=c.get("alloc_l"),
                assigned=c["assigned"], scratch=scratch,
                pipe=c.get("pipe"), pip=pip, ports=c.get("ports"),
                counts=c.get("counts"), match_terms=c.get("match_terms"),
                plain=plain)
            extra = _tensors(
                *[x for x in (c.get("ports"), c.get("counts")) if x])
            return tuple(c[k] for k in (
                "idle", "q_alloc", "ntasks", "alloc_l", "assigned",
                "pip_extra", "pip_ntasks", "q_pip", "pipelined")
                if k in c) + tuple(
                t for t in extra if t.dtype == torch.int32 and t.dim() == 2)
        return call
    if name == "victim_scores":
        return lambda: tuple(kernels.victim_scores(
            c["v_ok"], c["v_jprio"], c["v_crank"], c["v_tie"], c["v_queue"],
            c["v_node"], c["v_req"], c["p_prio"], c["p_queue"], c["q_alloc"],
            c["q_deserved"], c["q_reclaimable"], c["mode"], c["n_nodes"],
            plain=plain))
    if name == "frag_scores":
        return lambda: tuple(kernels.frag_scores(
            c["idle"], c["alloc"], c["ready"], c["evictable"], c["prof_req"],
            c["eps"], plain=plain))
    if name == "gang_block_fit":
        return lambda: tuple(kernels.gang_block_fit(
            c["idle"], c["ready"], c["ntasks"], c["max_tasks"],
            c["block_id"], c["prof_req"], c["prof_cnt"], c["eps"],
            c["n_blocks"], plain=plain))
    if name == "fabric_frag":
        return lambda: (kernels.fabric_frag(c["cfit"], c["whole"],
                                            c["prof_cnt"], plain=plain),)
    if name == "seq_solve":
        from volcano_tpu_torch.ops.allocate import LAST_SEQ

        def call():
            res = kernels.seq_solve(c["x"], c["weights"], plain=plain)
            return tuple(res[:6]) + (LAST_SEQ["alloc_cnt"],)
        return call
    raise KeyError(name)


def _distinct(idx) -> int:
    import torch

    return int(torch.unique(idx).numel())


def _work(name, cap, outs):
    """(bytes, operations) the function needs on these inputs: each input
    byte it needs read once (of a node plane gathered by node id, only the
    distinct rows it gathers) and each output written once; operations
    counted as float32 work at the per-pair cost of the arithmetic (score
    ~25 + 8 per slot, fit 4 per slot, compares 1), for the cheapest
    algorithm, not the kernel's own."""
    import math

    import torch

    out_bytes = _nbytes(*outs)
    if name == "coarse_shortlist":
        ins = [v for v in cap.values() if isinstance(v, torch.Tensor)]
        U, R = cap["req"].shape
        N = cap["idle"].shape[0]
        nbytes = (_nbytes(*ins) + out_bytes + _future_bytes(cap, N)
                   + _nbytes(*_tensors(cap.get("ports"), cap.get("aff"),
                                       cap.get("extra"))))
        C = cap["C"]
        ops = U * N * (25 + 12 * R)
        if "sel_bits" in cap:
            ops += U * C * 8 * cap["sel_bits"].shape[1]
        if cap["n_blocks"]:
            # Selection over the blocks' candidates: one compare each.
            ops += int(outs[3].numel())
    elif name == "static_planes":
        ins = [v for v in cap.values() if isinstance(v, torch.Tensor)]
        nbytes = _nbytes(*ins) + out_bytes
        U, LW = cap["sel_bits"].shape
        C = cap["cls_ready"].shape[0]
        A = cap["aff_bits"].shape[1]
        AP = cap["pref_bits"].shape[1]
        TW = cap["tol_bits"].shape[1]
        ops = U * C * (2 * LW * (1 + A + AP) + 2 * TW + 2 * AP)
    elif name == "warm_shortlist":
        U, B, klb = cap["cand_s"].shape
        N, R = cap["idle"].shape
        nlb = N // B
        ndb = int(cap["db"].numel())
        rows = ndb * nlb
        # Dirty blocks' node rows, profile rows, static planes, the clean
        # blocks' candidates (read) and every output (written).
        nbytes = (rows * (2 * R * 4 + 3 * 4)
                  + _nbytes(cap["req"], cap["init_req"], cap["stat_ok"],
                            cap["stat_score"], cap["db"])
                  + (B - ndb) * U * klb * 8 + out_bytes
                  + _future_bytes(cap, rows)
                  + _nbytes(*_tensors(cap.get("aff"))))
        if cap.get("ports") is not None:
            pw = cap["ports"].prof.shape[1]
            nbytes += U * pw * 4 + rows * pw * 4
        ops = U * rows * (25 + 12 * R) + U * B * klb
    elif name == "scatter_rows":
        # The row ids and every plane's delta values read once, the same
        # bytes written into the planes.
        k = cap["k"]
        vals = sum(k * b[0].numel() * b.element_size() for b in cap["bufs"])
        nbytes = 4 * k + 2 * vals
        ops = 0
    elif name == "rank_candidates":
        rows = cap["rows"].long()
        M = rows.shape[0]
        N, R = cap["idle"].shape
        C = cap["ok_w"].shape[1]
        if cap["cand"] is None:
            L, D, cand_b = N, N, 0
        else:
            cand = cap["cand"][rows]
            L, D, cand_b = cand.shape[1], _distinct(cand), _nbytes(cand)
        # Per distinct node: idle and alloc rows, class, pod slots (and
        # the bias, when given).
        node_b = D * (2 * R * 4 + 3 * 4 + (4 if cap.get("bias") is not None
                                           else 0))
        prof_b = M * (2 * R * 4 + C * 5 + 4)
        nbytes = (cand_b + node_b + prof_b + R * 9 + out_bytes
                  + _future_bytes(cap, D)
                  + _nbytes(*_tensors(cap.get("aff"))))
        ex = cap.get("extra")
        if ex is not None:
            # The custom plugins' verdict and score at each row's
            # candidates, and the rows' profile ids.
            nbytes += M * L * ((ex.ok is not None) + 4 * (
                ex.score is not None)) + M * 4
        if cap.get("ports") is not None:
            pt = cap["ports"]
            pw = pt.prof.shape[1]
            nbytes += M * pw * 4 + D * pw * 4 * (1 + (pt.pip is not None))
        ops = M * L * (25 + 12 * R)
    elif name == "walk_accept":
        W = cap["pid_l"].shape[0]
        UM, K = cap["ranked"].shape
        R = cap["idle"].shape[1]
        # The walk gathers idle / pod slots at the ranked nodes only; the
        # chosen nodes are among them.
        D = _distinct(cap["ranked"])
        nbytes = (UM * K * 5 + D * (R * 4 + 8) + UM * (2 * R * 4 + UM)
                  + W * 6 + R * 5 + out_bytes + _future_bytes(cap, D)
                  + _nbytes(*_tensors(cap.get("self_anti"))))
        if cap.get("ports") is not None:
            pt = cap["ports"]
            pw = pt.prof.shape[1]
            nbytes += UM * pw * 4 + D * pw * 4 * (1 + (pt.pip is not None))
        lw = max(1, math.ceil(math.log2(W)))
        ops = (UM * K * (2 * R + 4)  # per-candidate capacity and mask
               + UM * K  # its running sum along the ranking
               + W + W * UM  # per-profile running counts -> group rank
               + W * max(1, math.ceil(math.log2(K)))  # search for j
               + W * lw  # sort by (choice, task)
               + W * (R + 1)  # segmented same-node prefix
               + W * (3 * R + 2))  # idle fit and pod slots
    elif name in ("scatter_cnt0", "scatter_profile_tables"):
        # The entries read once, the dense tables written once; one add
        # (four for the flag planes and the soft table) per entry.
        k = cap["rows"].numel()
        ins = [v for v in cap.values() if isinstance(v, torch.Tensor)]
        nbytes = _nbytes(*ins) + out_bytes
        ops = k * (1 if name == "scatter_cnt0" else 4)
    elif name == "aff_live":
        # The listed terms' count rows (the totals need whole rows), their
        # keys, the listed table entries, the candidates' domain rows, the
        # row / candidate / term lists, and the two planes written.
        at = cap["at"]
        rows = cap["rows"].long()
        M = rows.numel()
        lists = cap["terms"].long()
        valid = lists >= 0
        used = torch.unique(lists[valid]).numel()
        D = at.cnt_a.shape[1]
        cand = cap["cand"]
        N, K = at.node_dom.shape
        if cand is None:
            nodes = N
        elif cand.dim() == 1:
            nodes = _distinct(cand)
        else:
            nodes = _distinct(cand[rows])
        entries = int(valid.sum()) * (1 if lists.shape[0] == M else M)
        nbytes = (used * D * 4 * (1 + (at.cnt_p is not None)) + used * 4
                  + entries * 7 + nodes * K * 4
                  + _nbytes(cap["rows"], cand, cap["terms"]) + out_bytes)
        L = outs[0].shape[1]
        ops = entries * L * 6 + used * D
    elif name == "aff_steer":
        # The ranked ids, the attempt's plane and the plane written; the
        # count rows of the terms whose self-match rule needs a total;
        # the window's term keys and [UM, EW] table entries; the ranked
        # nodes' domain rows; one count cell (two with pipelined counts)
        # per distinct (term, domain) a feasible candidate reads under its
        # row's required or anti terms.
        at = cap["at"]
        E, D = at.cnt_a.shape
        UM, K = cap["ranked"].shape
        NK = at.node_dom.shape[1]
        planes = 1 + (at.cnt_p is not None)
        kinds = at.t_req_aff | at.t_req_anti  # [UM, E]
        self_terms = int((at.t_req_aff & at.t_matches).any(dim=0).sum())
        rk = cap["ranked"].long()
        dom = at.node_dom.long()[rk[:, :, None],
                                 at.term_key.long()[None, None, :]]
        read = (cap["feas_att"][:, :, None] & kinds[:, None, :]
                & (dom >= 0))
        e_idx = torch.arange(E, device=dom.device)[None, None, :].expand_as(
            dom)
        cells = torch.unique((e_idx * D + dom)[read]).numel()
        nbytes = (_nbytes(cap["ranked"], cap["feas_att"]) + out_bytes
                  + self_terms * D * 4 * planes + E * 4 + UM * E * 3
                  + _distinct(cap["ranked"]) * NK * 4 + cells * 4 * planes)
        ops = int(read.sum()) * 3 + self_terms * D
    elif name == "aff_filter":
        # The required terms' count rows (their totals: no other term's
        # is read), the term keys, the table entries, the chosen nodes'
        # domain rows, the per-wave planes, the task vectors, and acc /
        # pipe read and written.
        at = cap["at"]
        E, D = at.cnt_a.shape
        W = cap["W"]
        UM = at.t_req_aff.shape[0]
        K = at.node_dom.shape[1]
        used = int(cap["term_req"].sum())
        nbytes = (used * D * 4 * (1 + (at.cnt_p is not None)) + E * 4
                  + UM * E * 3 + _distinct(cap["choice"]) * K * 4
                  + _nbytes(cap["choice"], cap["live"], cap["pid_l"],
                            cap["term_req"], cap["prof_req"])
                  + 2 * out_bytes)
        ops = used * D + W * E * 8
    elif name == "victim_scores":
        # Every input read once, every output written once; the float work
        # is the queue shares' divisions and the evictable sums.
        ins = [v for v in cap.values() if isinstance(v, torch.Tensor)]
        nbytes = _nbytes(*ins) + out_bytes
        V, R = cap["v_req"].shape
        ops = cap["q_alloc"].numel() * 2 + V * (R + 2)
    elif name == "frag_scores":
        # Every input read once, every output written once; per node two
        # fit counts (add, divide, floor, min per profile and slot), the
        # freed plane's add and the idle fraction (divide, clip, add).
        ins = [v for v in cap.values() if isinstance(v, torch.Tensor)]
        nbytes = _nbytes(*ins) + out_bytes
        N, R = cap["idle"].shape
        U = cap["prof_req"].shape[0]
        ops = N * (2 * U * R * 4 + R + 4 * R)
    elif name == "gang_block_fit":
        # Every input read once, the [B, U] counts and the [B] planes
        # written once; per node and profile the fit (4 per slot) and one
        # add into its block, per block and profile a compare, a min and
        # an add, per block fabric_frag's divide and select, and the
        # counts' sum.
        ins = [v for v in cap.values() if isinstance(v, torch.Tensor)]
        nbytes = _nbytes(*ins) + out_bytes
        N, R = cap["idle"].shape
        U = cap["prof_req"].shape[0]
        B = cap["n_blocks"]
        ops = N * U * (4 * R + 3) + B * (U * 3 + 2) + U
    elif name == "fabric_frag":
        ins = [v for v in cap.values() if isinstance(v, torch.Tensor)]
        nbytes = _nbytes(*ins) + out_bytes
        B, U = cap["cfit"].shape
        ops = B * (2 * U + 1) + U
    elif name == "seq_solve":
        # Every input read once, every output written once.  The work is
        # the rows the solve scored against every node, exactly: each row
        # it allocated (a discarded job's too: the per-job allocation
        # counts, the last output), each row it pipelined and each job's
        # failing row; per (row, node) the score (~25 + 8 per slot), the
        # FutureIdle fit (7 per slot) and the predicates (~10).
        x = cap["x"]
        nbytes = _nbytes(*_tensors(x)) + _nbytes(*outs[:6])
        _assigned, pipelined, _never, failed = outs[:4]
        alloc_cnt = outs[6]
        scored = int(alloc_cnt.sum()) + int((pipelined >= 0).sum()) \
            + int(failed.sum())
        N, R = x.idle.shape
        ops = scored * N * (35 + 15 * R)
    else:
        T = cap["node"].shape[0]
        R = cap["rows"].shape[1]
        touched = int(cap["mask"].sum())
        if "pipe" in cap:
            touched += int(cap["pipe"].sum())
            nbytes_pipe = _nbytes(cap["pipe"])
        else:
            nbytes_pipe = 0
        ops = touched * 2 * R
        # Only the touched rows of the state are read and written.
        nbytes = _nbytes(cap["node"], cap["mask"], cap["row_idx"],
                         cap["qidx"]) + touched * R * 4 * 4 + T * 4 \
            + nbytes_pipe
        if cap.get("ports") is not None:
            # Each touched task's port words read, its node's written.
            nbytes += touched * cap["ports"].prof.shape[1] * 4 * 3
        if cap.get("counts") is not None:
            # Each touched task's domain row read; per term its profile
            # matches, the term id read and one count cell read and
            # written.
            cw = cap["counts"]
            rows = cap["row_idx"].long()
            sel = cap["mask"].clone()
            if "pipe" in cap:
                sel |= cap["pipe"]
            matches = int(cw.t_matches[rows[sel]].sum()) + (
                int(cw.t_matches[rows[cap["mask"] & cap["pipe"]]].sum())
                if "pipe" in cap else 0)
            nbytes += touched * cw.node_dom.shape[1] * 4 + matches * 12
            ops += matches
    return nbytes, ops


SLEEP_CYCLES = 100_000_000  # ~50 ms at the H100's clock
SEQ_TRACE_TRIES = 3  # traces of the cold seq cycle before [seq:trace] fails
SEQ_TRACE_TIMEOUT_S = 300  # the [seq:trace] process: start, build, 3 tries


def _device_ms(fns) -> tuple:
    """Device time per call of the zero-argument calls ``fns``: a sleep
    kernel holds the stream while the host queues every call between two
    events, so the wrappers' host work (checks, allocation, ctypes) overlaps
    the sleep and the events time only the device's work.  Returns (device
    ms per call, host ms per call, queued); ``queued`` is False when the
    device reached the first event before the host had queued the last call
    (a call synchronised, or the sleep was too short), and then the time
    includes the host's gaps."""
    import torch

    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    e0.record()
    h0 = time.perf_counter()
    for fn in fns:
        fn()
    host_ms = (time.perf_counter() - h0) * 1e3
    queued = not e0.query()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / len(fns), host_ms / len(fns), queued


def _library_fn(name, c):
    """One PyTorch call computing the kernel's function, or None."""
    if name == "scatter_cnt0":
        import torch

        idx = (c["rows"].long(), c["cols"].long())
        out = torch.zeros((c["e"], c["d"]), dtype=torch.int32,
                          device=c["vals"].device)
        return lambda: out.index_put_(idx, c["vals"], accumulate=True)
    return None


def _yardstick_fn(name, c):
    """(label, maker) of the nearest PyTorch sequence to a kernel that no
    one PyTorch call computes, or None.  ``maker()`` does the untimed
    preparation on the card and returns the zero-argument timed call;
    the call's outputs equal the kernel's on these inputs."""
    import torch

    if name == "scatter_profile_tables":
        def make():
            f, s = c["flags"], c["soft"]
            # The padded entries dropped: the real (row, col) pairs left
            # are unique, so a plain index_put_ stores each flag bit.
            keep = ((f & 7) != 0) | (s != 0)
            idx = (c["rows"][keep].long(), c["cols"][keep].long())
            bits = [((f[keep] >> b) & 1).bool() for b in range(3)]
            sk = s[keep]
            shape, dev = (c["u"], c["e"]), s.device

            def call():
                out = []
                for b in bits:
                    t = torch.zeros(shape, dtype=torch.bool, device=dev)
                    out.append(t.index_put_(idx, b))
                st = torch.zeros(shape, dtype=torch.float32, device=dev)
                out.append(st.index_put_(idx, sk, accumulate=True))
                return tuple(out)
            return call
        return ("torch.zeros + index_put_ on each of the four planes "
                "(8 calls; padded entries dropped before timing)", make)
    if name == "scatter_rows":
        def make():
            from volcano_tpu_torch.ops import kernels

            # The staged rows and values as the planes' views, and fresh
            # copies of the planes, made before timing.
            rows, vals = kernels._delta_views(c["bufs"], c["staged"], c["k"])
            rows = rows.long()
            bufs = [b.clone() for b in c["bufs"]]

            def call():
                return tuple(b.index_copy_(0, rows, v)
                             for b, v in zip(bufs, vals))
            return call
        return (f"index_copy_ on each of the {len(c['bufs'])} planes "
                f"({len(c['bufs'])} calls, the staged delta already "
                f"unpacked as views)", make)
    if name == "gang_block_fit":
        def make():
            from volcano_tpu_torch.ops import kernels

            # The plain version's [N, U] capacities and block rows,
            # computed before timing: the segment sum alone is timed.
            cap = kernels._block_caps(c["idle"], c["ready"], c["ntasks"],
                                      c["max_tasks"], c["prof_req"],
                                      c["eps"])
            B = c["n_blocks"]
            bid = c["block_id"]
            keep = (bid >= 0) & (bid < B)
            seg, capk = bid[keep].long(), cap[keep].contiguous()
            U = cap.shape[1]

            def call():
                cfit = torch.zeros((B, U), dtype=torch.int32,
                                   device=cap.device)
                return (cfit.index_add_(0, seg, capk),)
            return call
        return ("torch.zeros + index_add_ of the precomputed [N, U] "
                "capacities (2 calls: the segment sum alone)", make)
    return None


STATIC_INPUTS = ("sel_bits", "aff_bits", "aff_terms", "tol_bits",
                 "pref_bits", "pref_w", "cls_label", "cls_taint", "cls_ready")


def static_share(cap: dict, reps: int = 20) -> dict:
    """A row-form shortlist launch that built the static planes itself
    (its captured inputs, no planes given) against the two-launch form:
    the planes' own launch (``static_planes``), then the same shortlist
    launch reading them.  The planes must equal ``class_static_plain``
    and every output the two-launch form's.  Timed as in
    ``replay_kernels`` (best of two runs of ``reps`` queued calls, in
    turns): the launch building the planes (``fused_ms``), the same
    launch reading given planes (``given_ms``), the planes' own launch
    (``own_ms``) and the pair (``pair_ms``); ``share_ms`` = fused - given,
    the planes' share of the launch.  Also the device operations of one
    fused call and of one pair (``graph_ops``)."""
    import torch

    if "sel_bits" not in cap or "stat_ok" in cap or cap["n_blocks"]:
        raise AssertionError("the captured launch is not a row-form "
                             "shortlist building its static planes")
    static = {k: cap[k] for k in STATIC_INPUTS}
    static.update(naff=float(cap["weights"].node_affinity_weight),
                  has_taints=cap["has_taints"])
    want = _kernel_fn("static_planes", _clone(static), True)()

    def given():
        c = _clone(cap)
        c["stat_ok"], c["stat_score"] = (t.clone() for t in want)
        return c

    def pair():
        own = _kernel_fn("static_planes", _clone(static), False)
        c = given()
        short = _kernel_fn("coarse_shortlist", c, False)

        def call():
            c["stat_ok"], c["stat_score"] = own()
            return short()
        return call

    fused = _kernel_fn("coarse_shortlist", _clone(cap), False)()
    two = pair()()
    torch.cuda.synchronize()
    for a, b in zip(fused[1:3], want):
        if not torch.equal(a, b):
            raise AssertionError("static planes built in the shortlist "
                                 "launch != class_static_plain")
    for a, b in zip(fused, two):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError("shortlist launch building the planes != "
                                 "the two-launch form")
    makers = {
        "fused": lambda: _kernel_fn("coarse_shortlist", _clone(cap), False),
        "given": lambda: _kernel_fn("coarse_shortlist", given(), False),
        "own": lambda: _kernel_fn("static_planes", _clone(static), False),
        "pair": pair,
    }
    times = {}
    for name in ("fused", "given", "own", "pair", "pair", "own", "given",
                 "fused"):
        fns = [makers[name]() for _ in range(reps)]
        times.setdefault(name, []).append(_device_ms(fns))
    best = {k: min(v) for k, v in times.items()}
    ops_fused = graph_ops(makers["fused"]())
    ops_pair = graph_ops(makers["pair"]())
    U, C = want[0].shape
    return {"fused_ms": best["fused"][0], "given_ms": best["given"][0],
            "own_ms": best["own"][0], "pair_ms": best["pair"][0],
            "share_ms": best["fused"][0] - best["given"][0],
            "queued": best["fused"][2],
            "device_ops_fused": ops_fused, "device_ops_pair": ops_pair,
            "shape": {"U": int(U), "C": int(C),
                      "N": int(cap["idle"].shape[0]), "S": int(cap["S"])}}


def scatter_one_plane_ms(cap: dict, reps: int = 20) -> dict:
    """The captured node-table delta written plane by plane with the
    one-plane ``scatter_rows`` launch (the values already on the card):
    the summed device ms of those launches; and the whole delta as the
    snapshot writes it, packed, copied and launched (``stage_delta`` +
    ``scatter_planes``: the copy's and the launch's device ms)."""
    import torch

    from volcano_tpu_torch.ops import kernels

    c = _clone(cap)
    rows, vals = kernels._delta_views(c["bufs"], c["staged"], c["k"])
    rows, vals = rows.clone(), [v.clone() for v in vals]
    host = c["staged"].cpu().numpy()
    offs, _ = kernels.delta_layout(c["k"], [
        b[0].numel() * b.element_size() for b in c["bufs"]])
    host_vals = [host[o:o + v.numel() * v.element_size()]
                 .view(v.cpu().numpy().dtype).reshape(v.shape)
                 for o, v in zip(offs, vals)]
    host_rows = host[:4 * c["k"]].view("int32")
    dev = c["staged"].device

    def one_plane():
        bufs = [b.clone() for b in cap["bufs"]]
        return lambda: [kernels.scatter_rows(b, rows, v)
                        for b, v in zip(bufs, vals)]

    def staged():
        bufs = [b.clone() for b in cap["bufs"]]
        return lambda: kernels.scatter_planes(
            bufs, kernels.stage_delta(host_rows, host_vals, dev), c["k"])

    times = {}
    for name, make in (("one", one_plane), ("staged", staged),
                       ("staged", staged), ("one", one_plane)):
        times.setdefault(name, []).append(
            _device_ms([make() for _ in range(reps)])[0])
    torch.cuda.synchronize()
    return {"one_plane_launches_ms": min(times["one"]),
            "staged_with_copy_ms": min(times["staged"]),
            "planes": len(cap["bufs"]), "rows": int(c["k"])}


def launch_floor(reps: int = 20) -> dict:
    """Device ms a launch of an empty kernel (``csrc/launch_floor.cu``),
    timed as the kernels are (``_device_ms``, best of two): one CTA with
    ``<<<>>>`` and one cluster of 1 and of 8 CTAs through
    ``cudaLaunchKernelEx``."""
    from volcano_tpu_torch.ops import kernels

    lib = kernels.load()
    out = {}
    for label, cl in (("plain", 0), ("cluster1", 1), ("cluster8", 8)):
        rc = lib.vtt_empty_launch(cl, kernels._stream())
        if rc != 0:
            raise RuntimeError(f"empty launch ({label}) failed: {rc}")
        out[label] = min(_device_ms(
            [lambda cl=cl: lib.vtt_empty_launch(cl, kernels._stream())
             for _ in range(reps)])[0] for _ in range(2))
    return out


def replay_kernels(captured: dict, launches: dict, reps: int = 20,
                   names=None, turns=(False, True, True, False),
                   time_check: bool = False) -> list:
    """Each kernel against its plain version on its captured inputs;
    integer outputs must be identical, float outputs identical too (the
    kernels round like the plain versions and sum integers exactly).  Then
    ``reps`` back-to-back calls of each, on fresh copies of the inputs,
    timed by ``_device_ms`` in ``turns`` (plain or not: kernel, plain,
    plain, kernel), best of each; and, where one PyTorch call computes the
    same function, that call.  ``time_check``: the plain call of the
    equality check is timed too (a plain version too slow to run again;
    ``turns`` may then leave the plain version out)."""
    import torch

    from volcano_tpu_torch.ops import kernels

    rows = []
    for name in names or kernels.LAUNCHES:
        if name not in captured:
            raise AssertionError(f"kernel {name} never launched")
        cap = captured[name]
        k_out = _kernel_fn(name, _clone(cap), plain=False)()
        times = {}
        pfn = _kernel_fn(name, _clone(cap), plain=True)
        if time_check:
            box = []
            times[True] = [_device_ms([lambda: box.append(pfn())])]
            p_out = box[0]
        else:
            p_out = pfn()
        torch.cuda.synchronize()
        err = 0.0
        for a, b in zip(k_out, p_out):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"{name}: output dtype/shape differs")
            if a.is_floating_point():
                d = (a.double() - b.double()).abs()
                err = max(err, float(d.max()) if d.numel() else 0.0)
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: kernel != plain version")
        for plain in turns:
            fns = [_kernel_fn(name, _clone(cap), plain=plain)
                   for _ in range(reps)]
            times.setdefault(plain, []).append(_device_ms(fns))
        k_best = min(times[False])
        p_best = min(times[True])
        lib_ms = None
        if _library_fn(name, cap) is not None:
            lib_ms = min(_device_ms([_library_fn(name, _clone(cap))
                                     for _ in range(reps)])[0]
                         for _ in range(2))
        ys = _yardstick_fn(name, cap)
        ys_ms = None
        if ys is not None:
            y_out = ys[1]()()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(y_out, k_out)):
                raise AssertionError(f"{name}: yardstick != kernel")
            ys_ms = min(_device_ms([ys[1]() for _ in range(reps)])[0]
                        for _ in range(2))
        nbytes, ops = _work(name, cap, k_out)
        t_bytes = nbytes / MEM_BPS * 1e3
        t_ops = ops / F32_OPS * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": kernels.KERNEL_SOURCES[name],
            "replaces": kernels.REPLACES[name],
            "launches": int(launches[name]),
            "max_abs_err": err,
            "ms": k_best[0], "plain_ms": p_best[0],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            # The nearest PyTorch sequence where no one call computes the
            # function (``_yardstick_fn``), and its device ms.
            "yardstick": None if ys is None else ys[0],
            "yardstick_ms": ys_ms,
            # Host time of one wrapper call (checks, allocation, ctypes),
            # and whether the device ran the calls back to back (False:
            # the time includes host gaps; the plain versions of
            # walk_accept and apply_commit read values on the host).
            "wrapper_ms": k_best[1],
            "queued": k_best[2], "plain_queued": p_best[2],
            "bytes": nbytes, "ops": ops,
        })
    return rows


# The CUDA functions behind each wrapper (csrc/*.cu), to read a trace.
KERNEL_FUNCS = {
    "coarse_shortlist": ("shortlist_kernel", "block_rank_kernel<true>",
                         "merge_kernel<true>"),
    "rank_candidates": ("rank_tile_kernel", "rank_merge_kernel"),
    "walk_accept": ("walk_choice_kernel", "walk_accept_kernel"),
    "apply_commit": ("commit_kernel",),
    "static_planes": ("class_static_kernel",),
    "warm_shortlist": ("block_rank_kernel<false>", "merge_kernel<false>"),
    "scatter_rows": ("scatter_planes_kernel", "scatter_rows_kernel"),
    "victim_scores": ("victim_kernel",),
    "frag_scores": ("frag_scores_kernel",),
    "gang_block_fit": ("block_fit_kernel",),
    "fabric_frag": ("fabric_frag_kernel",),
    "scatter_cnt0": ("scatter_cnt0_kernel",),
    "scatter_profile_tables": ("zero_planes_kernel",
                               "scatter_profile_kernel"),
    "aff_live": ("aff_live_kernel", "count_totals_kernel"),
    "aff_filter": ("aff_filter_init_kernel", "aff_filter_givers_kernel",
                   "aff_filter_check_kernel", "aff_filter_reset_kernel"),
    # One launch a call, computing or gated.
    "aff_steer": ("aff_steer_row_kernel",),
    "seq_solve": ("row_prep_kernel", "seq_solve_kernel"),
}


def profile_device(fn) -> dict:
    """Device time of one call of ``fn`` from a ``torch.profiler`` trace of
    the card's activity: summed time per device function, the union of the
    device's busy intervals, and the call's host wall time (which the
    tracing lengthens a little).  Empty when the trace holds no device
    events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name, count = [], {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        name = e.name.replace("(anonymous namespace)::", "")
        key = name.split("(")[0].strip() or name
        by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e3
        count[key] = count.get(key, 0) + 1
    if not spans:
        return {}
    spans.sort()
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    per_kernel = {
        k: sum(ms for n, ms in by_name.items() if any(f in n for f in fs))
        for k, fs in KERNEL_FUNCS.items()
    }
    top = sorted(by_name, key=by_name.get, reverse=True)[:8]
    # Every CUDA function of the port's kernels: [summed ms, launches].
    funcs = {}
    for n, ms in by_name.items():
        for f in (f for fs in KERNEL_FUNCS.values() for f in fs if f in n):
            acc = funcs.setdefault(f, [0.0, 0])
            acc[0] += ms
            acc[1] += count[n]
    return {"wall_ms": wall * 1e3, "busy_ms": busy / 1e3,
            "device_events": len(spans), "kernels_ms": per_kernel,
            "funcs": funcs,
            "other_ms": sum(by_name.values()) - sum(per_kernel.values()),
            "top": [[k[:60], by_name[k], count[k]] for k in top]}


TRACE_LEAD_CYCLES = 2_000_000  # ~1 ms spin opening a short trace


def device_ops(fn):
    """(``fn()``, the names of the device operations the call put on the
    card -- kernels, copies, memsets -- in order, from a
    ``torch.profiler`` trace; None when the trace held none of them).  A
    short trace has come back without its first device events on the
    card, so it opens with a ~1 ms spin kernel (left out of the names);
    a trace may still lose events, never add them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(TRACE_LEAD_CYCLES)
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and "spin_kernel" not in e.name),
                    key=lambda e: e.time_range.start)
    names = [e.name.replace("(anonymous namespace)::", "")
             .removeprefix("void ").split("(")[0].split("<")[0].strip()
             for e in events]
    return out, names or None


# cuGraphNodeGetType's kinds (cuda.h CUgraphNodeType).
NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}


def graph_ops(fn) -> dict:
    """The device operations one call of the repeatable ``fn`` puts on
    the card, counted by kind ("kernel", "memcpy", "memset") from a CUDA
    graph captured around a second call (captured, not run).  Unlike a
    short profiler trace, which has come back empty on the card, it
    drops nothing."""
    import ctypes

    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = {}
    for node in nodes[:n.value]:
        t = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                 ctypes.byref(t)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kind = NODE_KINDS.get(t.value, f"type {t.value}")
        kinds[kind] = kinds.get(kind, 0) + 1
    g.reset()
    return kinds


def _traced_sums(prof: dict) -> str:
    """The traced per-function device time and launches, largest first."""
    rows = sorted(prof["funcs"].items(), key=lambda kv: -kv[1][0])
    return ", ".join(f"{f} {ms:.3f} ms / {n}" for f, (ms, n) in rows)


# --------------------------------------------------------------- main

# The kernels of the solve path (solve_args_from_store -> solve_wave).
SOLVE_KERNELS = ("coarse_shortlist", "rank_candidates", "walk_accept",
                 "apply_commit")
# The kernels of the north-star cycle (phase 6).
CYCLE_KERNELS = SOLVE_KERNELS + ("static_planes", "warm_shortlist",
                                 "scatter_rows")
FUSED_STATIC = "static_planes:fused"
FUSED_FRAG = "fabric_frag:fused"


def launch_counts() -> dict:
    """The wrappers' launch counts, under ``static_planes:fused`` the
    ``coarse_shortlist`` launches that built the static planes themselves
    (``static_planes`` counts the planes' own launches) and under
    ``fabric_frag:fused`` the ``gang_block_fit`` launches, each of which
    writes ``fabric_frag``'s plane."""
    from volcano_tpu_torch.ops import kernels

    return {**kernels.LAUNCHES,
            FUSED_STATIC: kernels.FUSED["static_planes"],
            FUSED_FRAG: kernels.FUSED["fabric_frag"]}


def never_launched(launches: dict, names) -> list:
    """The kernels of ``names`` with no launch: the static planes count
    their own launches and the shortlist launches that built them."""
    return [k for k in names if launches[k] + (
        launches.get(FUSED_STATIC, 0) if k == "static_planes" else 0) == 0]


def run_phase(label, store_fn, deserved=None, timed=0):
    """Encode, zero the launch counts, solve on the card, read the counts;
    invariants; optionally time more solves and trace one; plain-version
    solve on the card must match; returns (stats, launches, captured
    inputs)."""
    import numpy as np
    import torch

    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.ops.wave import LAST_TWOPHASE, solve_wave
    from volcano_tpu_torch.synth import solve_args_from_store

    t0 = time.perf_counter()
    store = store_fn()
    args, _maps = solve_args_from_store(store, binpack=True, nodeorder=True)
    if deserved is not None:
        q = args[3]
        des = q.deserved.clone()
        des[: len(deserved)] = torch.tensor(deserved, dtype=torch.float32,
                                            device=des.device)
        args = args[:3] + (q._replace(deserved=des),) + args[4:]
    torch.cuda.synchronize()
    _log(f"[{label}] cluster + encode {time.perf_counter() - t0:.3f} s, "
         f"tasks {int(args[1].real.sum())}, nodes {int(args[0].ready.sum())}")
    kernels.CAPTURE = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = solve_wave(*args)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = launch_counts()
    captured, kernels.CAPTURE = kernels.CAPTURE, None
    missing = never_launched(launches, SOLVE_KERNELS)
    if missing:
        raise AssertionError(f"[{label}] kernels never launched: {missing}")
    stats = check_invariants(args, res)
    stats["first_solve_s"] = first_s
    stats.update({k: LAST_TWOPHASE[k] for k in
                  ("prep_s", "coarse_s", "fine_s", "syncs", "waves")})
    _log(f"[{label}] launches {json.dumps(launches)}")
    if timed:
        walls, parts = [], []
        for _ in range(timed):
            t0 = time.perf_counter()
            again = solve_wave(*args)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            parts.append((LAST_TWOPHASE["prep_s"], LAST_TWOPHASE["coarse_s"],
                          LAST_TWOPHASE["fine_s"]))
            same_result(res, again, f"[{label}] repeat solve")
        stats["solve_s_median"] = statistics.median(walls)
        stats["solve_s_all"] = walls
        mid = parts[walls.index(statistics.median(walls))] \
            if len(walls) % 2 else parts[0]
        stats["median_parts_s"] = {"prep": mid[0], "coarse": mid[1],
                                   "fine": mid[2]}
        stats["profile"] = profile_device(lambda: solve_wave(*args))
    t0 = time.perf_counter()
    plain_res = solve_wave(*args, plain=True)
    torch.cuda.synchronize()
    stats["plain_solve_s"] = time.perf_counter() - t0
    same_result(res, plain_res, f"[{label}] kernels vs plain versions")
    stats["assigned_identical_to_plain"] = True
    _log(f"[{label}] {json.dumps(stats)}")
    return stats, launches, captured


# ---------------------------------------------------------- the cycle

ST_BOUND = 16  # TaskStatus.Bound


def repend_feed(node_rows):
    """Steady-state workload: every cycle re-pends the pods bound to the
    given node rows (their gangs re-place in the same cycle)."""
    import numpy as np

    def feed(fc):
        m = fc.m
        rows = np.flatnonzero((m.p_status[:fc.Pn] == ST_BOUND)
                              & m.p_alive[:fc.Pn])
        sel = rows[np.isin(m.p_node[rows], node_rows)]
        if len(sel):
            fc._unbind_rows(sel)

    return feed


def cycle_invariants(store, n_pods: int) -> dict:
    """Every pod bound, in the mirror and on the binder, to the node the
    mirror names; no node over its allocatable (exact: requests are
    multiples of 1000 milli-CPU and 1 GiB) or its pod slots; gangs whole;
    every PodGroup Running."""
    import numpy as np

    m = store.mirror
    Pn, Nn = m.n_pods, m.n_nodes
    alive = m.p_alive[:Pn]
    bound = alive & (m.p_status[:Pn] == ST_BOUND)
    rows = np.flatnonzero(bound)
    if len(rows) != n_pods or int(alive.sum()) != n_pods:
        raise AssertionError(f"{len(rows)} of {n_pods} pods bound")
    binds = store.binder.binds
    if len(binds) != n_pods:
        raise AssertionError(f"binder holds {len(binds)} binds")
    keys = [m.p_key[r] for r in rows.tolist()]
    if any(binds.get(k) != m.p_node_name[r]
           for k, r in zip(keys, rows.tolist())):
        raise AssertionError("a bind disagrees with the mirror's node")
    R = 2 + len(m.scalar_slots)
    alloc = np.zeros((Nn, R), np.float64)
    er, si, v = m.c_n_alloc.gather(m.node_csr_rows(np.arange(Nn)))
    alloc[er, si] = v
    use = np.zeros((Nn, R), np.float64)
    er, si, v = m.c_req.gather(rows)
    np.add.at(use, (m.p_node[rows][er].astype(np.int64), si), v)
    if (use > alloc).any():
        raise AssertionError("a node holds more than its allocatable")
    cnt = np.bincount(m.p_node[rows], minlength=Nn)
    mt = m.n_maxtasks[:Nn]
    if ((mt > 0) & (cnt > mt)).any():
        raise AssertionError("pod slots exceeded")
    Jn = len(m.j_uid)
    per_job = np.bincount(m.p_job[rows], minlength=Jn)
    if ((per_job > 0) & (per_job < m.j_minav[:Jn])).any():
        raise AssertionError("a gang is bound below min_available")
    phases = {pg.status.phase for pg in store.pod_groups.values()}
    if phases != {"Running"}:
        raise AssertionError(f"PodGroup phases {phases}")
    return {"pods_bound": int(len(rows)), "nodes_used": int((cnt > 0).sum())}


def _lanes(store) -> dict:
    return {k: round(v * 1e3, 3) for k, v in
            sorted((store.last_cycle_lanes or {}).items())}


# TaskStatus bits of a pod holding a placement: Allocated, Binding, Bound,
# Running, Succeeded (the journey's own mask).
BOUND_MASK = 2 | 8 | 16 | 32 | 128


def bound_uids(store) -> list:
    """The uids of the live pods the mirror holds placed."""
    import numpy as np

    m = store.mirror
    Pn = m.n_pods
    rows = np.flatnonzero(m.p_alive[:Pn]
                          & ((m.p_status[:Pn] & BOUND_MASK) != 0))
    return [m.p_uid[r] for r in rows.tolist()]


def audit_checked(label, store, fast=True, quiet=False) -> dict:
    """The store's default observability at the end of a phase: no
    anomaly in the auditor's ring (an auditor error is an ``audit-error``
    anomaly, so a broken auditor fails here too), with ``fast`` at least
    one audited cycle and one reconcile, and the journey's conservation
    check clean over every placed pod.  Logs ``audit_stats()`` and the
    journey's ``stats()`` unless ``quiet``; returns ``audit_stats()``."""
    anoms = store.auditor.anomalies()
    if anoms:
        raise AssertionError(
            f"[{label}] {len(anoms)} auditor anomalies: "
            f"{json.dumps([a.to_dict() for a in anoms[:5]], default=str)}")
    stats = store.auditor.audit_stats()
    if fast and store.auditor.enabled and (stats["cycles"] < 1
                                           or stats["reconciles"] < 1):
        raise AssertionError(f"[{label}] the auditor audited no cycle: "
                             f"{stats}")
    jstats = None
    if store.journey is not None:
        bad = store.journey.conservation_check(bound_uids(store))
        if bad:
            raise AssertionError(
                f"[{label}] journey conservation: "
                f"{json.dumps([a.to_dict() for a in bad], default=str)}")
        jstats = store.journey.stats()
    if not quiet:
        _log(f"[{label}] audit {json.dumps(stats)} journey "
             f"{json.dumps(jstats)}")
    return stats


def run_cycle(label, store, n_pods, steady=5, n_update=100, trace=False):
    """The port's main path: ``Scheduler(store).run_once()`` with the
    deployed conf.  One cold cycle, ``steady`` cycles re-pending the pods
    on nodes 0-63, one cycle after ``update_node`` gives ``n_update``
    nodes half as much CPU again (a node-table delta: one copy and one
    ``scatter_planes`` launch a chunk required, the host time of
    ``DeviceSnapshot.node_planes`` recorded); with ``trace`` one steady
    cycle traced and a second update cycle whose ``node_planes`` call is
    traced (its device operations).  No cycle launches ``static_planes``
    of its own but one a static miss (the block-form shortlist reads the
    planes).  Returns (stats, per-cycle records, the scheduler)."""
    import dataclasses

    import torch

    from volcano_tpu_torch.framework import DEPLOYED_SCHEDULER_CONF
    from volcano_tpu_torch.ops import devsnap
    from volcano_tpu_torch.scheduler import Scheduler

    from volcano_tpu_torch.ops import wave as wave_mod

    sched = Scheduler(store, conf_str=DEPLOYED_SCHEDULER_CONF)
    stats = {"cycles": []}
    records = []
    # Device planes each solve of the running cycle read back to the host
    # (LAST_TWOPHASE["host_reads"], read after every solve_wave call).
    solve_reads = []
    solve_wave = wave_mod.solve_wave
    # Host ms of each node_planes call of the running cycle, and the
    # device operations of the traced one.
    planes_ms, planes_ops = [], []
    node_planes = devsnap.DeviceSnapshot.node_planes
    trace_planes = [False]

    def counted_solve(*a, **kw):
        out = solve_wave(*a, **kw)
        solve_reads.append(wave_mod.LAST_TWOPHASE.get("host_reads"))
        return out

    def timed_planes(self, *a, **kw):
        if trace_planes[0]:
            out, ops = device_ops(lambda: node_planes(self, *a, **kw))
            planes_ops.extend(ops or ())
            return out
        t0 = time.perf_counter()
        out = node_planes(self, *a, **kw)
        planes_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def cycle(kind):
        solve_reads.clear()
        planes_ms.clear()
        planes_ops.clear()
        snap = getattr(store, "device_snapshot", None)
        chunks0 = 0 if snap is None else snap.delta_launches
        uploads0 = 0 if snap is None else snap.plane_uploads
        launched = launch_counts()
        dv = getattr(store, "_devincr_cache", None)
        builds0 = 0 if dv is None else dv.static_builds
        wave_mod.solve_wave = counted_solve
        devsnap.DeviceSnapshot.node_planes = timed_planes
        trace_planes[0] = kind.endswith(":traced")
        try:
            t0 = time.perf_counter()
            sched.run_once()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            wave_mod.solve_wave = solve_wave
            devsnap.DeviceSnapshot.node_planes = node_planes
        inv = cycle_invariants(store, n_pods)
        snap = store.device_snapshot
        dv = getattr(store, "_devincr_cache", None)
        n = {k: v - launched[k] for k, v in launch_counts().items()}
        rec = {"kind": kind, "wall_s": wall, "lanes_ms": _lanes(store),
               "devincr": wave_mod.LAST_TWOPHASE.get("devincr"),
               "devsnap": None if snap is None else [
                   snap.full_uploads, snap.delta_uploads, snap.hits],
               "host_reads": list(solve_reads),
               # Static planes: own launches, built in a shortlist launch,
               # and the device-incremental lane's builds (misses).
               "static_planes": [n["static_planes"], n[FUSED_STATIC]],
               "static_builds": (0 if dv is None
                                 else dv.static_builds - builds0),
               "scatter_launches": n["scatter_rows"],
               "delta_chunks": (0 if snap is None
                                else snap.delta_launches - chunks0),
               "plane_uploads": (0 if snap is None
                                 else snap.plane_uploads - uploads0),
               "node_planes_host_ms": list(planes_ms),
               "launches": {k: v for k, v in n.items() if v}, **inv}
        if planes_ops:
            rec["node_planes_device_ops"] = list(planes_ops)
        stats["cycles"].append(rec)
        _log(f"[{label}] {kind} cycle {wall:.4f} s devincr "
             f"{json.dumps(rec['devincr'])} devsnap(full,delta,hits) "
             f"{rec['devsnap']} host reads per solve {rec['host_reads']} "
             f"static planes (own, in a shortlist launch, misses) "
             f"{rec['static_planes'] + [rec['static_builds']]} "
             f"node_planes host ms "
             f"{rec['node_planes_host_ms']} scatter launches "
             f"{rec['scatter_launches']} lanes(ms) "
             f"{json.dumps(rec['lanes_ms'])}")
        if dv is not None and rec["static_planes"][0] != \
                rec["static_builds"]:
            raise AssertionError(
                f"[{label}] {kind} cycle: {rec['static_planes'][0]} "
                f"static_planes launches for {rec['static_builds']} "
                f"static misses")
        if rec["scatter_launches"] != rec["delta_chunks"]:
            raise AssertionError(
                f"[{label}] {kind} cycle: {rec['scatter_launches']} "
                f"scatter launches for {rec['delta_chunks']} delta chunks")
        if planes_ops:
            # A trace may lose events, never add them: at most one copy
            # and one launch a chunk, one copy a plane re-uploaded whole,
            # nothing else.
            copies = sum(o.startswith("Memcpy") for o in planes_ops)
            kern = planes_ops.count("scatter_planes_kernel")
            if (kern > rec["delta_chunks"]
                    or copies > rec["delta_chunks"] + rec["plane_uploads"]
                    or len(planes_ops) != copies + kern):
                raise AssertionError(
                    f"[{label}] {kind} cycle: node_planes put "
                    f"{planes_ops} on the card for "
                    f"{rec['delta_chunks']} chunks and "
                    f"{rec['plane_uploads']} whole planes")
        if kind == "cold" and not solve_reads:
            raise AssertionError(f"[{label}] the cold cycle ran no solve")
        if any(r != 0 for r in solve_reads):
            raise AssertionError(f"[{label}] {kind} cycle: a solve read "
                                 f"device planes back: {solve_reads}")
        records.append((dict(store.binder.binds),
                        {u: pg.status.phase
                         for u, pg in sorted(store.pod_groups.items())},
                        _mirror_state(store)))

    cycle("cold")
    snap = store.device_snapshot
    dv = store._devincr_cache
    if snap is not None and snap.full_uploads < 1:
        raise AssertionError(f"[{label}] no devsnap full upload")
    store.cycle_feed = repend_feed(list(range(64)))
    for _ in range(steady):
        cycle("steady")
    if dv is not None and (dv.counts["warm"] < 1 or dv.static_hits < 1):
        raise AssertionError(f"[{label}] no warm shortlist / static hit: "
                             f"{dv.counts} hits {dv.static_hits}")
    if trace:
        solve_reads.clear()
        wave_mod.solve_wave = counted_solve
        try:
            stats["profile"] = profile_device(sched.run_once)
        finally:
            wave_mod.solve_wave = solve_wave
        if any(r != 0 for r in solve_reads):
            raise AssertionError(f"[{label}] traced cycle: a solve read "
                                 f"device planes back: {solve_reads}")
        cycle_invariants(store, n_pods)
    full_before = dv.counts["full"] if dv is not None else 0
    m = store.mirror
    step = max(1, m.n_nodes // n_update)

    def update(kind):
        for row in range(0, step * n_update, step):
            # More capacity (never less, so no bound pod is stranded).
            old = m.node_objs[row]
            cpu = str(int(float(old.allocatable["cpu"]) * 1.5))
            store.update_node(dataclasses.replace(
                old, allocatable={**old.allocatable, "cpu": cpu},
                capacity={**old.capacity, "cpu": cpu}))
        cycle(kind)
        rec = stats["cycles"][-1]
        if snap is not None and (rec["delta_chunks"] < 1
                                 or snap.delta_uploads < 1):
            raise AssertionError(f"[{label}] {kind}: no devsnap delta "
                                 f"upload")
        return rec

    rec = update("update_node")
    if dv is not None and dv.counts["full"] <= full_before:
        raise AssertionError(f"[{label}] node update did not re-rank")
    if snap is not None:
        stats["update"] = {k: rec[k] for k in (
            "node_planes_host_ms", "delta_chunks", "scatter_launches",
            "plane_uploads", "static_planes")}
    if trace and snap is not None:
        rec = update("update_node:traced")
        # None: the trace held no device event (not measured).
        stats["update"]["traced_device_ops"] = rec.get(
            "node_planes_device_ops")
    if snap is not None:
        stats["devsnap"] = {k: getattr(snap, k) for k in (
            "full_uploads", "delta_uploads", "hits", "delta_chunks",
            "delta_launches", "plane_uploads", "class_uploads",
            "class_hits")}
        stats["devsnap"]["resident_bytes"] = snap.resident_bytes()
    if dv is not None:
        stats["devincr"] = {"counts": dict(dv.counts),
                            "static_hits": dv.static_hits,
                            "static_builds": dv.static_builds,
                            "last_blocks": list(dv.last_blocks)}
    stats["audit"] = audit_checked(label, store)
    return stats, records, sched


# ------------------------------------------------ the pipelined cycle

def pipeline_invariants(store, n_pods: int, final: bool = False,
                        gone=()) -> dict:
    """A pipelined cycle's state: every live pod Bound or Pending (a solve
    may be in flight), each Bound pod on the binder's node and named so on
    its record, no node over its allocatable or pod slots.  ``final``
    (nothing in flight): every live pod bound, gangs whole, every PodGroup
    Running; the binder holds exactly the live pods' binds and those of
    ``gone`` (pods deleted after they were bound)."""
    import numpy as np

    m = store.mirror
    Pn, Nn = m.n_pods, m.n_nodes
    alive = m.p_alive[:Pn]
    st = m.p_status[:Pn]
    if int(alive.sum()) != n_pods:
        raise AssertionError(f"{int(alive.sum())} live pods, not {n_pods}")
    bound = alive & (st == ST_BOUND)
    if (alive & ~bound & (st != 1)).any():
        raise AssertionError("a live pod neither Bound nor Pending")
    rows = np.flatnonzero(bound)
    binds = store.binder.binds
    for r in rows.tolist():
        key = m.p_key[r]
        if binds.get(key) != m.p_node_name[r]:
            raise AssertionError(f"{key}: binder {binds.get(key)} != "
                                 f"mirror {m.p_node_name[r]}")
        if store.pods[m.p_uid[r]].node_name != m.p_node_name[r]:
            raise AssertionError(f"{key}: record disagrees with mirror")
    R = 2 + len(m.scalar_slots)
    alloc = np.zeros((Nn, R), np.float64)
    er, si, v = m.c_n_alloc.gather(m.node_csr_rows(np.arange(Nn)))
    alloc[er, si] = v
    use = np.zeros((Nn, R), np.float64)
    er, si, v = m.c_req.gather(rows)
    np.add.at(use, (m.p_node[rows][er].astype(np.int64), si), v)
    if (use > alloc).any():
        raise AssertionError("a node holds more than its allocatable")
    cnt = np.bincount(m.p_node[rows], minlength=Nn)
    mt = m.n_maxtasks[:Nn]
    if ((mt > 0) & (cnt > mt)).any():
        raise AssertionError("pod slots exceeded")
    if final:
        if len(rows) != n_pods:
            raise AssertionError(f"{len(rows)} of {n_pods} pods bound")
        if set(binds) != {m.p_key[r] for r in rows.tolist()} | set(gone):
            raise AssertionError("the binder holds other binds")
        Jn = len(m.j_uid)
        per_job = np.bincount(m.p_job[rows], minlength=Jn)
        if ((per_job > 0) & (per_job < m.j_minav[:Jn])).any():
            raise AssertionError("a gang is bound below min_available")
        phases = {pg.status.phase for pg in store.pod_groups.values()}
        if phases != {"Running"}:
            raise AssertionError(f"PodGroup phases {phases}")
    return {"bound": int(len(rows)), "pending": int(n_pods - len(rows))}


class _Fetches:
    """Wraps ``pipeline.InflightSolve.fetch`` while active: each fetched
    solve's id, ``host_reads``, syncs and launches (the worker's own)."""

    def __init__(self):
        self.seen = []

    def __enter__(self):
        from volcano_tpu_torch import pipeline as pl

        self.real = real = pl.InflightSolve.fetch
        seen = self.seen

        def fetch(inflight):
            out = real(inflight)
            tp = inflight.twophase
            seen.append({"solve_id": inflight.solve_id,
                         "host_reads": tp.get("host_reads"),
                         "syncs": tp.get("syncs"),
                         "devincr": tp.get("devincr"),
                         "launches": dict(inflight.launches)})
            return out

        pl.InflightSolve.fetch = fetch
        return self

    def __exit__(self, *exc):
        from volcano_tpu_torch import pipeline as pl

        pl.InflightSolve.fetch = self.real
        return False


def pipelined_run(label, store, device, n_pods, script, log_cycles=True):
    """``store`` (``pipeline`` and ``async_bind`` on) through the deployed
    conf: for each ``(kind, before, traced)`` of ``script``, ``before(store)``
    (a mutation, the feed) then one ``run_once()``, ``flush_binds()`` and
    ``pipeline_invariants``; with ``traced`` the cycle and the solve it
    dispatched (until the worker is idle) run under ``profile_device``.  Per-cycle records: wall, fetch wait, lanes, ids,
    drops, binds, mirror state; the fetched solves; ``host_reads`` must be
    0 after every solve, and no key may be bound twice in one cycle."""
    import torch

    from volcano_tpu_torch.framework import DEPLOYED_SCHEDULER_CONF
    from volcano_tpu_torch.scheduler import Scheduler

    store.pipeline = True
    store.async_bind = True
    sched = Scheduler(store, conf_str=DEPLOYED_SCHEDULER_CONF, device=device)
    on_card = sched.device.type == "cuda"
    records, prof = [], None
    with _Fetches() as fetches:
        for kind, before, traced in script:
            gone = before(store) if before is not None else None
            ch0 = len(store.binder.channel)
            nf = len(fetches.seen)
            if traced:
                # The window: the cycle, then the solve it dispatched,
                # until the worker is idle (the device work of one
                # pipelined period).
                cyc = [None]

                def period():
                    t0 = time.perf_counter()
                    sched.run_once()
                    if on_card:
                        torch.cuda.current_stream().synchronize()
                    cyc[0] = time.perf_counter() - t0
                    if not store._solve_worker.idle(600):
                        raise AssertionError(f"[{label}] worker busy")

                prof = profile_device(period)
                wall = cyc[0]
            else:
                t0 = time.perf_counter()
                sched.run_once()
                if on_card:
                    torch.cuda.current_stream().synchronize()
                wall = time.perf_counter() - t0
            if not store.flush_binds(120):
                raise AssertionError(f"[{label}] binds not flushed")
            rec = store.flight.last()
            new = store.binder.channel[ch0:]
            if len(new) != len(set(new)) or len(new) != rec.pods_bound:
                raise AssertionError(
                    f"[{label}] {kind}: {len(new)} binds ({len(set(new))} "
                    f"keys) for {rec.pods_bound} committed rows")
            n_pods -= len(gone or ())
            inv = pipeline_invariants(store, n_pods)
            solves = fetches.seen[nf:]
            if any(f["host_reads"] != 0 for f in solves):
                raise AssertionError(f"[{label}] {kind}: a solve read "
                                     f"device planes back: {solves}")
            r = {"kind": kind, "wall_s": wall,
                 "inflight_fetch_wait_ms": rec.inflight_fetch_wait_ms,
                 "lanes_ms": _lanes(store),
                 "dispatched": rec.dispatched_solve_id,
                 "committed": rec.committed_solve_id,
                 "mut_at_dispatch": rec.mutation_seq_at_dispatch,
                 "drops": dict(rec.drop_reasons),
                 "bound_rows": rec.pods_bound, **inv,
                 "solves": [{k: f[k] for k in ("solve_id", "host_reads",
                                               "syncs")}
                            for f in solves]}
            if log_cycles:
                _log(f"[{label}] {kind} cycle {json.dumps(r)}")
            records.append((r, dict(store.binder.binds),
                            _mirror_state(store)))
    audit_checked(label, store)
    return records, fetches.seen, prof, sched


def pipeline_preempt(workers=2000, serving=1000, max_cycles=24):
    """A pipelined preempt: ``priority_tier_workload(workers, serving)``
    under the preempt conf with ``store.pipeline``, grace 2, until the
    serving gang is bound, on the card and on the CPU: every cycle's
    binds, evictions and what-if outcome identical.  The plan's what-if
    solve runs on the solve worker; ``victim_scores`` (a cooperative
    launch) runs on the cycle thread's stream, and the launches made while
    a worker solve was in flight are counted."""
    import os

    from volcano_tpu_torch.cache import ClusterStore, FakeBinder, FakeEvictor
    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.sim import ClusterSimulator

    saved = {k: os.environ.get(k) for k in ("VOLCANO_TPU_EVICT_DEVICE",
                                            "VOLCANO_TPU_EVICT_CAP")}
    os.environ["VOLCANO_TPU_EVICT_DEVICE"] = "1"
    os.environ["VOLCANO_TPU_EVICT_CAP"] = str(workers)
    real_vs = kernels.victim_scores
    beside = {"launches": 0, "in_flight": 0}

    def run(device):
        store = ClusterStore(binder=FakeBinder(), evictor=FakeEvictor())
        ClusterSimulator.priority_tier_workload(store, workers=workers,
                                                serving_tasks=serving)
        store.pipeline = True
        sched = Scheduler(store, conf_str=CONF_PREEMPT_ONLY, device=device)
        sim = ClusterSimulator(store, grace_steps=2)

        def watched(*a, **kw):
            w = store._solve_worker
            beside["launches"] += 1
            beside["in_flight"] += int(w is not None and not w.idle(0))
            return real_vs(*a, **kw)

        kernels.victim_scores = watched if device is None else real_vs
        trace = []
        try:
            for _ in range(max_cycles):
                t0 = time.perf_counter()
                sched.run_once()
                wall = time.perf_counter() - t0
                rec = store.flight.last()
                trace.append((dict(store.binder.binds),
                              list(store.evictor.evicts),
                              (rec.whatif or {}).get("outcome"),
                              rec.dispatched_solve_id,
                              rec.committed_solve_id, wall))
                sim.step()
                if sum(1 for p in store.pods.values()
                       if p.name.startswith("serving-")
                       and p.node_name) >= serving:
                    break
        finally:
            kernels.victim_scores = real_vs
        audit_checked(f"pipeline:preempt:{device or 'card'}", store)
        store.close()
        return trace

    try:
        launched = kernels.LAUNCHES["victim_scores"]
        card = run(None)
        launched = kernels.LAUNCHES["victim_scores"] - launched
        cpu = run("cpu")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if len(card) != len(cpu):
        raise AssertionError(f"[pipeline:preempt] {len(card)} cycles on the "
                             f"card, {len(cpu)} on the CPU")
    for i, (a, b) in enumerate(zip(card, cpu)):
        if a[:5] != b[:5]:
            raise AssertionError(f"[pipeline:preempt] cycle {i}: card and "
                                 f"CPU differ")
    outcomes = [t[2] for t in card]
    if "committed" not in outcomes or launched < 1:
        raise AssertionError(f"[pipeline:preempt] no committed plan "
                             f"({outcomes}) or no victim_scores launch")
    stats = {"cycles": len(card), "outcomes": outcomes,
             "evictions": len(card[-1][1]),
             "victim_scores_launches": launched,
             "victim_scores_beside_worker_solve": beside["in_flight"],
             "walls_s": [t[5] for t in card]}
    _log(f"[pipeline:preempt] {workers} workers, a {serving}-task serving "
         f"gang, pipelined: card == CPU over {len(card)} cycles; "
         f"{json.dumps(stats)}")
    return stats


def worker_ab(store, reps=2) -> dict:
    """What the solve worker costs: ``store``'s solve (``solve_args_from_
    store``) on the calling thread and on the worker's thread and stream,
    in turns (direct, worker, worker, direct) ``reps`` times, host clock
    around each call and its packed result's fetch; the results must be
    identical.  And the launch counter's lock: ``kernels.count_launch``
    against the unlocked ``d[k] += 1`` it replaced, host microseconds a
    call over 100,000 calls (counts reset after)."""
    import torch

    from volcano_tpu_torch import pipeline as pl
    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.ops.wave import solve_wave
    from volcano_tpu_torch.synth import solve_args_from_store

    args, _maps = solve_args_from_store(store, binpack=True, nodeorder=True)
    dev = args[0].idle.device
    # One untimed call each way first.
    solve_wave(*args, device=dev)
    pl.dispatch_solve(store, dev, args, pl.SOLVE_FIELDS).result()
    torch.cuda.synchronize()
    times = {"direct": [], "worker": []}
    outs = {}
    for _ in range(reps):
        for kind in ("direct", "worker", "worker", "direct"):
            t0 = time.perf_counter()
            if kind == "direct":
                out = pl._pack(solve_wave(*args, device=dev),
                               pl.SOLVE_FIELDS).cpu().numpy()
            else:
                out = pl.dispatch_solve(store, dev, args,
                                        pl.SOLVE_FIELDS).result()
            times[kind].append((time.perf_counter() - t0) * 1e3)
            if kind in outs and not (outs[kind] == out).all():
                raise AssertionError(f"[pipeline:worker-ab] {kind} solves "
                                     "differ")
            outs[kind] = out
    if not (outs["direct"] == outs["worker"]).all():
        raise AssertionError("[pipeline:worker-ab] the worker's solve "
                             "differs from the direct one")
    n = 100000
    d = {"x": 0}
    t0 = time.perf_counter()
    for _ in range(n):
        d["x"] += 1
    plain_us = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for _ in range(n):
        kernels.count_launch("scatter_rows")
    lock_us = (time.perf_counter() - t0) / n * 1e6
    kernels.reset_launches()
    out = {"direct_ms": times["direct"], "worker_ms": times["worker"],
           "direct_ms_median": statistics.median(times["direct"]),
           "worker_ms_median": statistics.median(times["worker"]),
           "count_launch_us": lock_us, "unlocked_increment_us": plain_us}
    _log(f"[pipeline:worker-ab] north-star solve, host ms with its fetch: "
         f"direct {out['direct_ms']}, worker {out['worker_ms']} (medians "
         f"{out['direct_ms_median']:.3f} / {out['worker_ms_median']:.3f}); "
         f"count_launch {lock_us:.4f} us a call against "
         f"{plain_us:.4f} us unlocked")
    return out


def pipeline_phase(sync_binds=None, sync_launches=None, big=(10000, 100000),
                   ref=(1000, 10000), preempt=None):
    """The pipelined session (``store.pipeline`` with ``async_bind``).

    Reference: at 1,000 x 10,000 the same pipelined script -- a cold
    dispatch, one ``update_node`` and one ``delete_pod`` of a dispatched
    pod during the overlap, two cycles re-pending the pods of nodes 0-7,
    a drain cycle -- on the card and on the CPU: every cycle's binds,
    drops by reason, ids and mirror state identical.

    Full width: a fresh north-star store; cycle 1 only dispatches, cycle
    2 commits (its placements equal the synchronous cold cycle's
    ``sync_binds``, the solve's launches its ``sync_launches``; without
    them the phase runs that synchronous cycle on a twin store), five
    steady cycles re-pending the pods of nodes 0-63, one traced, then an
    ``update_node`` of 100 nodes and a ``delete_pod`` of every pod of one
    dispatched gang during the overlap, and a drain cycle: every pod
    bound, gangs whole.  The worker's launches are captured and replayed
    against the plain versions.  Returns (stats, replay rows)."""
    import dataclasses

    import numpy as np

    from volcano_tpu_torch.ops import kernels

    # -- reference: card against CPU at 1,000 x 10,000.
    def ref_run(device):
        store = _fresh_cluster(n_nodes=ref[0], n_pods=ref[1], gang_size=8,
                               zones=16, seed=1)
        feed = repend_feed(list(range(8)))

        def overlap(store):
            m = store.mirror
            old = m.node_objs[7]
            cpu = str(int(float(old.allocatable["cpu"]) * 1.5))
            store.update_node(dataclasses.replace(
                old, allocatable={**old.allocatable, "cpu": cpu},
                capacity={**old.capacity, "cpu": cpu}))
            row = int(store._inflight_solve.task_rows[0])
            pod = store.pods[m.p_uid[row]]
            store.delete_pod(pod)
            return [pod]

        def set_feed(store):
            store.cycle_feed = feed

        def drain(store):
            store.cycle_feed = None

        script = [("cold", None, False), ("overlap", overlap, False),
                  ("steady", set_feed, False), ("steady", None, False),
                  ("drain", drain, False)]
        recs, solves, _p, _s = pipelined_run(
            f"pipeline:ref:{'cpu' if device else 'card'}", store, device,
            ref[1], script, log_cycles=device is None)
        store.close()
        return recs, solves

    t0 = time.perf_counter()
    card, card_solves = ref_run(None)
    cpu, _ = ref_run("cpu")
    for i, (a, b) in enumerate(zip(card, cpu)):
        ra, rb = a[0], b[0]
        for k in ("dispatched", "committed", "mut_at_dispatch", "drops",
                  "bound_rows", "bound", "pending"):
            if ra[k] != rb[k]:
                raise AssertionError(f"[pipeline:ref] cycle {i} {k}: card "
                                     f"{ra[k]} != CPU {rb[k]}")
        if a[1] != b[1] or a[2] != b[2]:
            raise AssertionError(f"[pipeline:ref] cycle {i}: binds or "
                                 f"mirror differ card vs CPU")
    if not card[1][0]["drops"].get("deleted"):
        raise AssertionError("[pipeline:ref] the overlap delete dropped "
                             "no row")
    _log(f"[pipeline:ref] {ref[0]}x{ref[1]} pipelined script card == CPU: "
         f"{len(card)} cycles, drops "
         f"{[r[0]['drops'] for r in card]}, "
         f"{time.perf_counter() - t0:.1f} s")

    # -- the synchronous cold cycle, when the caller has none.
    kw = dict(n_nodes=big[0], n_pods=big[1], gang_size=8, zones=16, seed=0)
    if sync_binds is None:
        from volcano_tpu_torch.framework import DEPLOYED_SCHEDULER_CONF
        from volcano_tpu_torch.scheduler import Scheduler

        twin = _fresh_cluster(**kw)
        before = launch_counts()
        Scheduler(twin, conf_str=DEPLOYED_SCHEDULER_CONF).run_once()
        sync_launches = {k: v - before[k]
                         for k, v in launch_counts().items()
                         if v - before[k]}
        sync_binds = dict(twin.binder.binds)
        twin.close()
        del twin

    # -- full width.
    store = _fresh_cluster(**kw)
    ab = worker_ab(store)
    n_pods = big[1]
    feed = repend_feed(list(range(64)))
    # Keys of deleted pods the binder had bound, and the deleted pods.
    gone: list = []
    deleted: list = []

    def first_steady(store):
        store.cycle_feed = feed

    def overlap(store):
        m = store.mirror
        step = max(1, m.n_nodes // 100)
        for row in range(0, step * 100, step):
            old = m.node_objs[row]
            cpu = str(int(float(old.allocatable["cpu"]) * 1.5))
            store.update_node(dataclasses.replace(
                old, allocatable={**old.allocatable, "cpu": cpu},
                capacity={**old.capacity, "cpu": cpu}))
        jrow = int(m.p_job[int(store._inflight_solve.task_rows[0])])
        uid = m.j_uid[jrow]
        pods = [p for p in list(store.pods.values())
                if m.p_job[m.p_row[p.uid]] == jrow]
        for p in pods:
            if p.node_name is not None:
                gone.append(f"{p.namespace}/{p.name}")
            store.delete_pod(p)
        store.delete_pod_group(uid)
        deleted.extend(pods)
        return pods

    def drain(store):
        store.cycle_feed = None

    script = ([("cold:dispatch", None, False), ("cold:commit", None, False),
               ("steady", first_steady, False)]
              + [("steady", None, False)] * 4
              + [("steady:traced", None, True),
                 ("update+delete", overlap, False), ("drain", drain, False)])
    kernels.CAPTURE = {}
    kernels.reset_launches()
    recs, solves, prof, _sched = pipelined_run(
        "pipeline", store, None, n_pods, script)
    launches = launch_counts()
    caps, kernels.CAPTURE = kernels.CAPTURE, None
    first, second = recs[0], recs[1]
    if first[0]["bound_rows"] or first[1]:
        raise AssertionError("[pipeline] cycle 1 bound pods")
    if first[0]["dispatched"] is None or second[0]["committed"] != \
            first[0]["dispatched"]:
        raise AssertionError("[pipeline] cycle 2 did not commit cycle 1's "
                             "dispatch")
    if second[1] != sync_binds:
        diff = sum(1 for k, v in sync_binds.items()
                   if second[1].get(k) != v)
        raise AssertionError(f"[pipeline] cycle 2's placements differ from "
                             f"the synchronous cold cycle's ({diff} pods)")
    cold = {k: v for k, v in solves[0]["launches"].items() if v}
    sync_cold = {k: v for k, v in sync_launches.items() if v}
    if cold != sync_cold:
        raise AssertionError(f"[pipeline] the pipelined cold solve's "
                             f"launches {cold} != the synchronous cold "
                             f"cycle's {sync_cold}")
    upd = recs[-2][0]
    if not upd["drops"].get("deleted"):
        raise AssertionError("[pipeline] the deleted gang dropped no row")
    pipeline_invariants(store, n_pods - len(deleted), final=True, gone=gone)
    export = export_checked("pipeline", store)
    missing = never_launched(launches, CYCLE_KERNELS)
    if missing:
        raise AssertionError(f"[pipeline] kernels never launched: {missing}")
    # Steady cycles that fetched and committed the one before's solve.
    steady = [r[0] for r in recs if r[0]["kind"] == "steady"
              and r[0]["committed"] is not None]
    stats = {
        "worker_ab": ab,
        "export": export,
        "cycles": [r[0] for r in recs],
        "launches": launches,
        "cold_solve_launches": cold,
        "steady_wall_s_median": statistics.median(r["wall_s"]
                                                  for r in steady),
        "steady_fetch_wait_ms_median": statistics.median(
            r["inflight_fetch_wait_ms"] for r in steady),
    }
    if prof:
        stats["traced"] = {
            "busy_ms": prof["busy_ms"], "wall_ms": prof["wall_ms"],
            "idle_share": 1 - prof["busy_ms"] / prof["wall_ms"],
            "kernels_ms": prof["kernels_ms"]}
        _log(f"[pipeline] traced steady cycle and the solve it dispatched "
             f"(until the worker is idle): device busy "
             f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms wall, "
             f"device idle share "
             f"{100.0 * (1 - prof['busy_ms'] / prof['wall_ms']):.2f}%, "
             f"kernels(ms) {json.dumps(prof['kernels_ms'])}")
    else:
        _log("[pipeline] traced steady cycle: no device events in the "
             "trace (idle share not measured)")
    _log(f"[pipeline] steady cycles: median wall "
         f"{stats['steady_wall_s_median']:.4f} s, median in-flight fetch "
         f"wait {stats['steady_fetch_wait_ms_median']:.3f} ms; launches "
         f"{json.dumps(launches)}; cold solve launches equal the "
         f"synchronous cold cycle's; placements of cycle 2 equal the "
         f"synchronous cold cycle's")
    store.close()
    del store, recs
    rows = replay_kernels(caps, launches, reps=3, names=CYCLE_KERNELS)
    stats["preempt"] = pipeline_preempt(**(preempt or {}))
    return stats, rows


def export_checked(label, store) -> dict:
    """Write the store's flight records and its journey's rows with
    ``obs.export.write_trace``, parse the file back and check it: for
    every committed solve id one flow arrow -- one start, on its dispatch
    span, and one finish, the commit span's among its events -- and
    journey instants whose solve ids are all committed ones (at least
    one).  Returns the counts."""
    import os
    import tempfile

    from volcano_tpu_torch.obs import export

    recs = store.flight.recent()
    committed = {r.committed_solve_id for r in recs
                 if r.committed_solve_id is not None}
    with tempfile.TemporaryDirectory() as d:
        path = export.write_trace(os.path.join(d, "trace.json"), recs,
                                  journey=store.journey.trace_rows())
        nbytes = os.path.getsize(path)
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
    spans = {}
    for e in evs:
        if e["ph"] == "X" and e["name"] in ("dispatch", "inflight_commit"):
            spans.setdefault((e["name"], e["args"].get("solve_id")),
                             []).append(e["ts"])
    flows = {}
    for e in evs:
        if e.get("cat") == "flow":
            flows.setdefault(e["id"], []).append((e["ph"], e["ts"]))
    if not committed:
        raise AssertionError(f"[{label}] no committed solve to export")
    for sid in committed:
        ph = flows.get(sid, [])
        starts = [ts for p, ts in ph if p == "s"]
        if len(starts) != 1 or [p for p, _ in ph].count("f") != 1:
            raise AssertionError(f"[{label}] solve {sid}: flow phases "
                                 f"{sorted(p for p, _ in ph)}")
        if starts != spans.get(("dispatch", sid)):
            raise AssertionError(f"[{label}] solve {sid}: the flow does "
                                 "not start on its dispatch span")
        if not set(spans.get(("inflight_commit", sid), ())) <= \
                {ts for _, ts in ph} or ("inflight_commit", sid) not in spans:
            raise AssertionError(f"[{label}] solve {sid}: the commit span "
                                 "is not on its flow")
    jsids = {e["args"]["solve_id"] for e in evs
             if e.get("cat") == "journey" and e["ph"] == "n"
             and e["args"].get("solve_id")}
    tracks = sum(1 for e in evs if e.get("cat") == "journey"
                 and e["ph"] == "b")
    if not jsids or not jsids <= committed:
        raise AssertionError(f"[{label}] journey solve ids {sorted(jsids)} "
                             f"not among the committed {sorted(committed)}")
    out = {"bytes": nbytes, "events": len(evs), "committed": len(committed),
           "journey_tracks": tracks, "journey_solve_ids": sorted(jsids)}
    _log(f"[{label}:export] Perfetto trace of {len(recs)} flight records "
         f"and the journey ring: {json.dumps(out)}; one dispatch -> commit "
         f"flow per committed solve id")
    return out


class _Env:
    """Set environment variables for a ``with`` block, then restore."""

    def __init__(self, **kv):
        self.kv = kv

    def __enter__(self):
        import os

        self.saved = {k: os.environ.get(k) for k in self.kv}
        os.environ.update(self.kv)
        return self

    def __exit__(self, *exc):
        import os

        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


class _Solves:
    """Wraps ``ops.wave.solve_wave`` while active (synchronous cycles
    only: the difference of the launch counts around a call is that
    call's): each solve's launches, syncs and host reads."""

    def __init__(self):
        self.seen = []

    def __enter__(self):
        from volcano_tpu_torch.ops import wave as wave_mod

        self.real = real = wave_mod.solve_wave
        seen = self.seen

        def counted(*a, **kw):
            before = launch_counts()
            out = real(*a, **kw)
            info = wave_mod.LAST_TWOPHASE
            seen.append({
                "launches": {k: v - before[k]
                             for k, v in launch_counts().items()
                             if v - before[k]},
                "syncs": info.get("syncs"),
                "host_reads": info.get("host_reads")})
            return out

        wave_mod.solve_wave = counted
        return self

    def __exit__(self, *exc):
        from volcano_tpu_torch.ops import wave as wave_mod

        wave_mod.solve_wave = self.real
        return False


def _obs_cycle(store, sched, pipelined=False) -> dict:
    """One ``run_once()`` on the card, host clock around it ending in a
    sync (of the cycle thread's stream when ``pipelined``); the solves it
    ran (synchronous: launches, syncs, host reads; pipelined: the solve it
    fetched), the auditor's and the journey's self-timed nanoseconds in
    it, the lanes."""
    import torch

    a0 = store.auditor.overhead_ns
    jr = store.journey
    j0 = 0 if jr is None else jr.capture_ns
    with (_Fetches() if pipelined else _Solves()) as counts:
        t0 = time.perf_counter()
        sched.run_once()
        if pipelined:
            torch.cuda.current_stream().synchronize()
        else:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if pipelined and not store.flush_binds(120):
        raise AssertionError("binds not flushed")
    solves = counts.seen
    if any(x["host_reads"] != 0 for x in solves):
        raise AssertionError(f"a solve read device planes back: {solves}")
    return {"wall_s": wall, "solves": solves,
            "audit_ns": store.auditor.overhead_ns - a0,
            "journey_ns": 0 if jr is None else jr.capture_ns - j0,
            "lanes_ms": _lanes(store)}


def save_checkpoint(store, directory) -> dict:
    """``persistence.save_store`` of ``store`` into ``directory`` (the
    first half of ``[ha]``): the path, the file's bytes and the seconds."""
    import os

    from volcano_tpu_torch.persistence import save_store

    path = os.path.join(directory, "north-star.ckpt")
    t0 = time.perf_counter()
    save_store(store, path)
    out = {"path": path, "save_s": time.perf_counter() - t0,
           "checkpoint_bytes": os.path.getsize(path),
           "pods": len(store.pods)}
    _log(f"[ha] checkpoint of the north-star store before its cold cycle: "
         f"{json.dumps(out)}")
    return out


def obs_phase(ckpt, orig_binds, reps=1):
    """The default observability at full width, and the checkpoint round
    trip of ``[ha]``.

    Two stores are loaded from ``ckpt`` (``save_checkpoint`` of the
    north-star store before its cold cycle): one with
    ``VOLCANO_TPU_AUDIT_SAMPLE=1`` (every cycle runs the aggregate
    re-verify and the encode and devincr sentinels over the card's
    planes), one with ``VOLCANO_TPU_AUDIT=0 VOLCANO_TPU_JOURNEY=0``; the
    load seconds are printed.  Both run a cold cycle and five steady
    cycles re-pending nodes 0-63: the cold binds equal ``orig_binds`` (the
    original store's cold cycle) pod for pod, the two stores' binds are
    equal after every cycle, every solve's launches and syncs are equal
    with observability on and off, ``host_reads`` is 0, and the audited
    store has no anomaly and clean journey conservation.  Then the A/B at
    the default sample rate, alternating the two stores (on, off) ``reps``
    times each: a re-cold cycle (caches dropped with ``close()``, a fresh
    journey, every pod re-pended by the feed and placed again), a steady
    synchronous cycle, and -- with ``store.pipeline`` and ``async_bind``
    -- a steady pipelined cycle; per cycle the wall and the auditor's and
    the journey's self-timed nanoseconds.  Returns the stats."""
    from volcano_tpu_torch.framework import DEPLOYED_SCHEDULER_CONF
    from volcano_tpu_torch.obs import JourneyLog
    from volcano_tpu_torch.obs.audit import DEFAULT_SAMPLE
    from volcano_tpu_torch.persistence import load_store
    from volcano_tpu_torch.scheduler import Scheduler

    n_pods = ckpt["pods"]
    ha = {k: v for k, v in ckpt.items() if k != "path"}
    t0 = time.perf_counter()
    with _Env(VOLCANO_TPU_AUDIT_SAMPLE="1"):
        on = load_store(ckpt["path"])
    ha["load_s"] = time.perf_counter() - t0
    with _Env(VOLCANO_TPU_AUDIT="0", VOLCANO_TPU_JOURNEY="0"):
        off = load_store(ckpt["path"])
    if on.auditor.sample != 1 or not on.auditor.enabled \
            or on.journey is None:
        raise AssertionError("[obs] the audited store's observability is "
                             "not on")
    if off.auditor.enabled or off.journey is not None:
        raise AssertionError("[obs] the other store's observability is on")
    if len(on.pods) != n_pods or set(off.pods) != set(on.pods):
        raise AssertionError("[ha] the checkpoint lost pods")
    _log(f"[ha] north-star checkpoint loaded: {json.dumps(ha)}")
    scheds = {k: Scheduler(st, conf_str=DEPLOYED_SCHEDULER_CONF)
              for k, st in (("on", on), ("off", off))}
    stores = {"on": on, "off": off}
    feed = repend_feed(list(range(64)))
    runs = {"on": [], "off": []}
    for kind in ["cold"] + ["steady"] * 5:
        for k in ("on", "off"):
            if kind == "steady":
                stores[k].cycle_feed = feed
            rec = _obs_cycle(stores[k], scheds[k])
            rec["kind"] = kind
            runs[k].append(rec)
            cycle_invariants(stores[k], n_pods)
        if kind == "cold" and dict(on.binder.binds) != orig_binds:
            raise AssertionError("[ha] the loaded store's cold binds differ "
                                 "from the original store's")
        if dict(on.binder.binds) != dict(off.binder.binds):
            raise AssertionError(f"[obs] {kind} cycle: binds differ with "
                                 f"observability on and off")
        a, b = runs["on"][-1], runs["off"][-1]
        if [(x["launches"], x["syncs"]) for x in a["solves"]] != \
                [(x["launches"], x["syncs"]) for x in b["solves"]]:
            raise AssertionError(
                f"[obs] {kind} cycle: solves differ with observability on "
                f"and off: {a['solves']} != {b['solves']}")
        _log(f"[obs] {kind} cycle: on {a['wall_s']:.4f} s (audit "
             f"{a['audit_ns'] / 1e6:.3f} ms, journey "
             f"{a['journey_ns'] / 1e6:.3f} ms), off {b['wall_s']:.4f} s; "
             f"per solve (launches, syncs) equal: "
             f"{[(sum(x['launches'].values()), x['syncs']) for x in a['solves']]}"
             f"; lanes(ms) on {json.dumps(a['lanes_ms'])}")
    st = audit_checked("obs", on)
    slots = sorted(on.auditor._sentinels)
    if st["sampled_cycles"] != 6 or "devincr-static" not in slots:
        raise AssertionError(f"[obs] not every cycle sampled, or no devincr "
                             f"sentinel: {st}, slots {slots}")
    _log(f"[ha] the loaded store's cold binds equal the original store's "
         f"pod for pod; [obs] binds and per-solve launches and syncs equal "
         f"on and off over the cold and 5 steady cycles; sentinel slots "
         f"{slots}")
    on.auditor.sample = DEFAULT_SAMPLE  # the A/B at the default rate

    # -- the A/B: the two stores in turns.
    def recold(k):
        store = stores[k]
        store.close()  # the cycle's caches and device state dropped
        if k == "on":
            store.journey = JourneyLog(slo=store.auditor.slo,
                                       auditor=store.auditor)
            store.mirror.journey = store.journey

        def all_pending(fc):
            import numpy as np

            m = fc.m
            rows = np.flatnonzero((m.p_status[:fc.Pn] == ST_BOUND)
                                  & m.p_alive[:fc.Pn])
            fc._unbind_rows(rows)

        store.cycle_feed = all_pending

    ab = {"cold": {"on": [], "off": []}, "steady": {"on": [], "off": []},
          "pipelined": {"on": [], "off": []}}
    for _ in range(reps):
        for k in ("on", "off"):
            recold(k)
            ab["cold"][k].append(_obs_cycle(stores[k], scheds[k]))
    for k in ("on", "off"):
        stores[k].cycle_feed = feed
    for _ in range(reps):
        for k in ("on", "off"):
            ab["steady"][k].append(_obs_cycle(stores[k], scheds[k]))
    for k in ("on", "off"):
        stores[k].pipeline = True
        stores[k].async_bind = True
        _obs_cycle(stores[k], scheds[k], pipelined=True)  # first dispatch
    for _ in range(reps):
        for k in ("on", "off"):
            ab["pipelined"][k].append(
                _obs_cycle(stores[k], scheds[k], pipelined=True))
    for k in ("on", "off"):
        stores[k].cycle_feed = None
        _obs_cycle(stores[k], scheds[k], pipelined=True)  # drain
        pipeline_invariants(stores[k], n_pods, final=True)
    if dict(on.binder.binds) != dict(off.binder.binds):
        raise AssertionError("[obs] the A/B's binds differ on and off")
    out = {"ha": ha, "audit": audit_checked("obs:ab", on),
           "journey": on.journey.stats()}
    for kind, by in ab.items():
        row = {}
        for k in ("on", "off"):
            walls = [r["wall_s"] for r in by[k]]
            row[k] = {"wall_s": walls,
                      "wall_s_median": statistics.median(walls)}
        row["on"]["audit_ms"] = [r["audit_ns"] / 1e6 for r in by["on"]]
        row["on"]["journey_ms"] = [r["journey_ns"] / 1e6 for r in by["on"]]
        row["delta_ms_median"] = 1e3 * (row["on"]["wall_s_median"]
                                        - row["off"]["wall_s_median"])
        row["self_timed_ms_median"] = statistics.median(
            (r["audit_ns"] + r["journey_ns"]) / 1e6 for r in by["on"])
        out[kind] = row
        _log(f"[obs:ab] {kind}: on {json.dumps(row['on'])}, off "
             f"{json.dumps(row['off'])}, median on - off "
             f"{row['delta_ms_median']:.3f} ms, self-timed audit + journey "
             f"median {row['self_timed_ms_median']:.3f} ms")
    for st in stores.values():
        st.close()
    return out


def ha_gate_phase(size=(1000, 10000), periods=10, period_s=0.05):
    """The second half of ``[ha]``: a scheduler gated on a
    ``LeaderElector`` whose lease (in a temporary directory) another
    identity holds runs ``Scheduler.run()`` for ``periods`` periods with
    no bind, no flight record and no kernel launch; when the holder
    releases, the elector takes the lease and the next cycle binds every
    pod on the card; after ``stop()`` the scheduler is healthy."""
    import os
    import tempfile
    import threading

    from volcano_tpu_torch.framework import DEPLOYED_SCHEDULER_CONF
    from volcano_tpu_torch.ha import LeaderElector
    from volcano_tpu_torch.scheduler import Scheduler

    store = _fresh_cluster(n_nodes=size[0], n_pods=size[1], gang_size=8,
                           zones=16, seed=1)
    lease_kw = dict(lease_duration=1.0, renew_deadline=0.5,
                    retry_period=0.05)
    with tempfile.TemporaryDirectory() as d:
        lease = os.path.join(d, "lease")
        holder = LeaderElector(lease, identity="holder", **lease_kw)
        if not holder.try_acquire():
            raise AssertionError("[ha:gate] the holder took no lease")
        standby = LeaderElector(lease, identity="standby", **lease_kw)
        elect = threading.Thread(
            target=standby.run, args=(lambda: None, lambda: None),
            daemon=True)
        elect.start()
        sched = Scheduler(store, conf_str=DEPLOYED_SCHEDULER_CONF,
                          schedule_period=period_s,
                          gate=lambda: standby.is_leader)
        before = launch_counts()
        sched.run()
        try:
            for _ in range(periods):
                time.sleep(period_s)
                if not holder.renew():
                    raise AssertionError("[ha:gate] the holder lost its "
                                         "lease")
            launched = {k: v - before[k] for k, v in launch_counts().items()
                        if v != before[k]}
            if (standby.is_leader or store.binder.binds
                    or store.flight.recent() or launched):
                raise AssertionError(
                    f"[ha:gate] the standby ran: leader "
                    f"{standby.is_leader}, {len(store.binder.binds)} binds,"
                    f" {len(store.flight.recent())} cycles, launches "
                    f"{launched}")
            t0 = time.perf_counter()
            holder.stop()  # releases the lease
            deadline = time.time() + 120
            while len(store.binder.binds) < size[1] and \
                    time.time() < deadline:
                time.sleep(0.02)
            takeover_s = time.perf_counter() - t0
        finally:
            sched.stop()
            standby.stop()
            elect.join(timeout=10)
    launched = {k: v - before[k] for k, v in launch_counts().items()
                if v != before[k]}
    if len(store.binder.binds) != size[1] or not launched:
        raise AssertionError(f"[ha:gate] after the takeover "
                             f"{len(store.binder.binds)} binds, launches "
                             f"{launched}")
    if not sched.healthy():
        raise AssertionError("[ha:gate] unhealthy after stop()")
    cycle_invariants(store, size[1])
    out = {"standby_periods": periods, "takeover_to_bound_s": takeover_s,
           "cycles": len(store.flight.recent()), "launches": launched,
           "healthy": sched.healthy(),
           "audit": audit_checked("ha:gate", store)}
    _log(f"[ha:gate] {size[0]}x{size[1]}: no bind and no launch over "
         f"{periods} gated periods; after the holder released, every pod "
         f"bound in {takeover_s:.3f} s; healthy after stop(); "
         f"{json.dumps({k: v for k, v in out.items() if k != 'audit'})}")
    store.close()
    return out


def _mirror_state(store):
    m = store.mirror
    return tuple((m.p_uid[r], int(m.p_status[r]), m.p_node_name[r])
                 for r in range(m.n_pods) if m.p_uid[r] is not None)


def _reset_uids() -> None:
    """Restart the uid counters, so two builds of one configuration carry
    the same uids."""
    import itertools

    import volcano_tpu_torch.api.spec as spec

    spec._uid_counter = itertools.count(1)
    spec._ts_counter = itertools.count(1)


class _no_gc:
    """Python's cyclic collector off around a store's build (set-up, not
    a measured path): a build only allocates, and late in the script, with
    a large live heap, the collector's passes took a third or more of it
    (builds of one store spread 1-12 s)."""

    def __enter__(self):
        import gc

        self.was = gc.isenabled()
        gc.disable()

    def __exit__(self, *exc):
        import gc

        if self.was:
            gc.enable()
        return False


def _fresh_cluster(**kw):
    """synthetic_cluster with the uid counters reset."""
    from volcano_tpu_torch.synth import synthetic_cluster

    _reset_uids()
    with _no_gc():
        return synthetic_cluster(**kw)


def lanes_on_off(n_nodes, n_pods):
    """The cycle sequence with the device-incremental lane and the device
    snapshot on, then off: binds, phases and mirror states identical."""
    import os

    kw = dict(n_nodes=n_nodes, n_pods=n_pods, gang_size=8, zones=16, seed=0)
    _on, rec_on, _ = run_cycle("on-off:on", _fresh_cluster(**kw), n_pods,
                               n_update=n_nodes // 100)
    saved = {k: os.environ.get(k) for k in ("VOLCANO_TPU_DEVINCR",
                                            "VOLCANO_TPU_DEVSNAP")}
    os.environ.update({k: "0" for k in saved})
    try:
        off_store = _fresh_cluster(**kw)
        _off, rec_off, _ = run_cycle("on-off:off", off_store, n_pods,
                                     n_update=n_nodes // 100)
        if off_store.device_snapshot is not None \
                or off_store._devincr_cache is not None:
            raise AssertionError("[on-off] lanes ran while switched off")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if len(rec_on) != len(rec_off):
        raise AssertionError("[on-off] cycle counts differ")
    for i, (a, b) in enumerate(zip(rec_on, rec_off)):
        for what, x, y in zip(("binds", "phases", "mirror"), a, b):
            if x != y:
                raise AssertionError(f"[on-off] cycle {i}: {what} differ")
    _log(f"[on-off] {n_nodes}x{n_pods}: {len(rec_on)} cycles, binds, "
         f"phases and mirror states identical with the lanes on and off")


# ------------------------------------------------- preempt and reclaim

# BASELINE config 4's conf (bench.py CONF_PREEMPT) and the preempt conf of
# bench.py config_preempt.
CONF_PREEMPT = """
actions: "enqueue, allocate, preempt, reclaim, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""
CONF_PREEMPT_ONLY = """
actions: "enqueue, allocate, preempt"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""

# The kernels the two eviction paths launch (no node-table change, so no
# devsnap delta scatter; warm shortlists when the dirty set allows).
EVICT_KERNELS = ("victim_scores", "coarse_shortlist", "static_planes",
                 "rank_candidates", "walk_accept", "apply_commit")
FUTURE_KERNELS = ("coarse_shortlist", "warm_shortlist", "rank_candidates",
                  "walk_accept", "apply_commit")
ALLOCATED = (2, 8, 16, 32)  # TaskStatus Allocated, Binding, Bound, Running
ST_RELEASING = 64  # TaskStatus.Releasing


def evict_invariants(store, n_pods: int) -> dict:
    """The checks of ``held_invariants``; the pod count unchanged: every
    deleted victim came back as one restored pod."""
    m = store.mirror
    alive = m.p_alive[:m.n_pods]
    if len(store.pods) != n_pods or int(alive.sum()) != n_pods:
        raise AssertionError(f"{len(store.pods)} pods, {n_pods} expected: "
                             f"a victim was lost or doubled")
    return held_invariants(store)[0]


def held_invariants(store, split=()):
    """On the pods that hold capacity (allocated, bound, running and
    Releasing): no node over its allocatable or pod slots (exact: whole-CPU
    and whole-GiB requests); gangs whole (a job's allocated pods are 0 or
    at least min_available), except the job rows ``split``.  Returns
    (counts, the held rows)."""
    import numpy as np

    m = store.mirror
    Pn, Nn = m.n_pods, m.n_nodes
    alive = m.p_alive[:Pn]
    st = m.p_status[:Pn]
    charged = alive & (np.isin(st, ALLOCATED) | (st == ST_RELEASING))
    rows = np.flatnonzero(charged & (m.p_node[:Pn] >= 0))
    R = 2 + len(m.scalar_slots)
    alloc = np.zeros((Nn, R), np.float64)
    er, si, v = m.c_n_alloc.gather(m.node_csr_rows(np.arange(Nn)))
    alloc[er, si] = v
    use = np.zeros((Nn, R), np.float64)
    er, si, v = m.c_req.gather(rows)
    np.add.at(use, (m.p_node[rows][er].astype(np.int64), si), v)
    if (use > alloc).any():
        raise AssertionError("a node holds more than its allocatable")
    cnt = np.bincount(m.p_node[rows], minlength=Nn)
    mt = m.n_maxtasks[:Nn]
    if ((mt > 0) & (cnt > mt)).any():
        raise AssertionError("pod slots exceeded")
    Jn = len(m.j_uid)
    arows = np.flatnonzero(alive & np.isin(st, ALLOCATED)
                           & (m.p_job[:Pn] >= 0))
    per_job = np.bincount(m.p_job[arows], minlength=Jn)
    partial = (per_job > 0) & (per_job < m.j_minav[:Jn])
    partial[list(split)] = False
    if partial.any():
        raise AssertionError("a gang is bound below min_available")
    return {"allocated": int(len(arows)),
            "releasing": int((alive & (st == ST_RELEASING)).sum())}, rows


def run_evict_phase(label, store, conf, grace, cycles, until=None,
                    need=EVICT_KERNELS, require_future=True, extra=None,
                    profile_cycle=None, invariants=None):
    """``Scheduler(store).run_once()`` then ``ClusterSimulator.step()``,
    ``cycles`` times (or until ``until(store)`` holds), with the checks of
    ``evict_invariants`` and zero host reads after every solve; the kernels
    ``need`` must have launched, and (``require_future``) one solve must
    have run the future branch.  ``invariants(store, n_pods)`` replaces
    ``evict_invariants`` (the host walk deletes its victims: there is no
    restore to keep the pod count).  ``extra(store)`` adds fields to each
    cycle's record, which also carries the what-if engine's spans (plan and
    what-if solve, ms); cycle ``profile_cycle`` runs under
    ``profile_device`` (its device busy time and idle share).  Captures ``victim_scores``' inputs per mode and, from
    future-branch solves, the inputs of each solve kernel's first launch;
    other launches go to ``kernels.CAPTURE`` when the caller set it.
    Returns (stats, launches, victim captures, future captures)."""
    import torch

    from volcano_tpu_torch.metrics import metrics
    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.ops import wave as wave_mod
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.sim import ClusterSimulator

    n_pods = len(store.pods)
    check = invariants or evict_invariants
    sched = Scheduler(store, conf_str=conf)
    sim = ClusterSimulator(store, grace_steps=grace)
    solve_wave = wave_mod.solve_wave
    victim_fn = kernels.victim_scores
    solves = []  # (host reads, future branch) per solve
    vs_caps, fut_caps = {}, {}

    def counted_solve(*a, **kw):
        future = bool(a[0].releasing.any())  # host planes from the cycle
        outer = kernels.CAPTURE
        if future and len(fut_caps) < len(FUTURE_KERNELS):
            kernels.CAPTURE = {}
        try:
            out = solve_wave(*a, **kw)
        finally:
            if kernels.CAPTURE is not outer:
                for k, v in kernels.CAPTURE.items():
                    if k in FUTURE_KERNELS and k not in fut_caps:
                        fut_caps[k] = v
                    if outer is not None:
                        outer.setdefault(k, v)
                kernels.CAPTURE = outer
        info = wave_mod.LAST_TWOPHASE
        if bool(info.get("future")) != future:
            raise AssertionError(f"[{label}] future branch flag disagrees "
                                 "with the releasing plane")
        solves.append((info.get("host_reads"), future))
        return out

    def capturing_victims(*a, **kw):
        mode = int(a[12])
        if mode not in vs_caps and a[0].is_cuda:
            outer = kernels.CAPTURE
            kernels.CAPTURE = {}
            try:
                out = victim_fn(*a, **kw)
                vs_caps[mode] = kernels.CAPTURE["victim_scores"]
            finally:
                kernels.CAPTURE = outer
            return out
        return victim_fn(*a, **kw)

    plans0 = dict(metrics.whatif_plans.data)
    evict0 = sum(metrics.preempt_evictions.data.values())
    reb0 = sum(metrics.rebalance_evictions.data.values())
    stats = {"cycles": []}
    kernels.reset_launches()
    wave_mod.solve_wave = counted_solve
    kernels.victim_scores = capturing_victims
    try:
        for c in range(cycles):
            solves.clear()
            prof = None
            t0 = time.perf_counter()
            if c == profile_cycle:
                prof = profile_device(sched.run_once)
            else:
                sched.run_once()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if prof:
                # The traced call alone, without the profiler's set-up.
                wall = prof["wall_ms"] / 1e3
            inv = check(store, n_pods)
            if any(r != 0 for r, _f in solves):
                raise AssertionError(f"[{label}] cycle {c}: a solve read "
                                     f"device planes back: {solves}")
            led = store.migrations
            rec = {"cycle": c, "wall_s": wall, "lanes_ms": _lanes(store),
                   "solves": len(solves),
                   "future_solves": sum(f for _r, f in solves),
                   "plans": 0 if led is None else led.committed_plans,
                   "restored": 0 if led is None else led.restored_pods,
                   **inv, **(extra(store) if extra else {})}
            spans = {}
            for sp in store.flight.last().spans:
                if sp.cat in ("rebalance", "whatif"):
                    spans[sp.name] = spans.get(sp.name, 0.0) + sp.dur_ns / 1e6
            rec["spans_ms"] = spans
            if prof is not None:
                rec["profile"] = ({
                    "traced_wall_ms": prof["wall_ms"],
                    "device_busy_ms": prof["busy_ms"],
                    "idle_share": 1.0 - prof["busy_ms"] / prof["wall_ms"],
                    "kernels_ms": {k: v for k, v in prof["kernels_ms"].items()
                                   if v}} if prof else
                    "no device events in the trace")
            stats["cycles"].append(rec)
            _log(f"[{label}] cycle {c} {wall:.4f} s {json.dumps(rec)}")
            sim.step()
            check(store, n_pods)
            if until is not None and until(store):
                break
    finally:
        wave_mod.solve_wave = solve_wave
        kernels.victim_scores = victim_fn
    launches = launch_counts()
    _log(f"[{label}] launches {json.dumps(launches)}")
    missing = never_launched(launches, need)
    if missing:
        raise AssertionError(f"[{label}] kernels never launched: {missing}")
    stats["future_solves"] = sum(r["future_solves"] for r in stats["cycles"])
    if require_future and stats["future_solves"] < 1:
        raise AssertionError(f"[{label}] no solve ran the future branch")
    stats["whatif_plans"] = {
        "/".join(v for _k, v in key): n - plans0.get(key, 0.0)
        for key, n in metrics.whatif_plans.data.items()
        if n != plans0.get(key, 0.0)}
    stats["evictions"] = sum(metrics.preempt_evictions.data.values()) - evict0
    stats["rebalance_evictions"] = (
        sum(metrics.rebalance_evictions.data.values()) - reb0)
    stats["audit"] = audit_checked(label, store)
    return stats, launches, vs_caps, fut_caps


def _summary(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k != "cycles"}


def sort_yardstick(cap: dict, reps: int = 20) -> float:
    """Device ms of ``torch.sort(key, stable=True)`` on the captured victim
    rows' order key packed into one int64 (ineligible bit, biased
    prio_key, V - 1 - crank: crank is a permutation of 0..V-1 and the tie
    arange(V) in the lanes' captures, so the key alone is the order).  A
    yardstick for the sort part of ``victim_scores``, not the function:
    its indices must equal the kernel's order."""
    import torch

    from volcano_tpu_torch.ops import kernels

    c = _clone(cap)
    el, order, _ev, _qs = kernels.victim_scores(
        c["v_ok"], c["v_jprio"], c["v_crank"], c["v_tie"], c["v_queue"],
        c["v_node"], c["v_req"], c["p_prio"], c["p_queue"], c["q_alloc"],
        c["q_deserved"], c["q_reclaimable"], c["mode"], c["n_nodes"])
    V = el.shape[0]
    crank = c["v_crank"].long()
    if not torch.equal(torch.sort(crank).values,
                       torch.arange(V, device=crank.device)):
        raise AssertionError("[kernels:evict] crank is not a permutation")
    prio = torch.where(el, c["v_jprio"].long(),
                       torch.full_like(crank, 2 ** 31 - 1))
    key = (((~el).long() << 62) | ((prio + 2 ** 31) << 30)
           | (V - 1 - crank))
    if not torch.equal(torch.sort(key, stable=True).indices.int(), order):
        raise AssertionError("[kernels:evict] torch.sort of the packed key "
                             "differs from the kernel's order")
    return min(_device_ms([lambda: torch.sort(key, stable=True)
                           for _ in range(reps)])[0] for _ in range(2))


def evict_phases():
    """Phases 9-11: the reclaim and preempt paths at 10,000 nodes, then
    ``victim_scores`` (both modes) and the solve kernels on future-branch
    inputs against their plain versions.  Returns (the victim_scores rows,
    one per mode; the future-branch rows of the solve kernels)."""
    import os

    from volcano_tpu_torch.cache import ClusterStore, FakeBinder, FakeEvictor
    from volcano_tpu_torch.sim import ClusterSimulator
    from volcano_tpu_torch.synth import preempt_cluster

    os.environ["VOLCANO_TPU_EVICT_DEVICE"] = "1"
    # 9. reclaim: BASELINE config 4 at its full size.
    t0 = time.perf_counter()
    with _no_gc():
        store = preempt_cluster(n_nodes=10000, fill_per_node=4,
                                n_pending=20000, gang_size=4, seed=0)
    _log(f"[reclaim] cluster {time.perf_counter() - t0:.3f} s, "
         f"{len(store.pods)} pods")
    os.environ.pop("VOLCANO_TPU_EVICT_CAP", None)
    rstats, rlaunch, rvs, rfut = run_evict_phase(
        "reclaim", store, CONF_PREEMPT, grace=2, cycles=6)
    bound = sum(1 for p in store.pods.values()
                if p.name.startswith("hi-") and p.node_name)
    rstats["hi_bound"] = bound
    if bound < 4 or rstats["whatif_plans"].get("reclaim/committed", 0) < 1:
        raise AssertionError(f"[reclaim] no reclaimed gang bound: {rstats}")
    _log(f"[reclaim] {json.dumps(_summary(rstats))}")
    store.close()

    # 10. preempt: bench.py config_preempt at 10,000 workers.
    os.environ["VOLCANO_TPU_EVICT_CAP"] = "10000"
    try:
        store = ClusterStore(binder=FakeBinder(), evictor=FakeEvictor())
        t0 = time.perf_counter()
        with _no_gc():
            ClusterSimulator.priority_tier_workload(store, workers=10000,
                                                    serving_tasks=5000)
        _log(f"[preempt] cluster {time.perf_counter() - t0:.3f} s, "
             f"{len(store.pods)} pods")

        def serving_bound(st):
            return sum(1 for p in st.pods.values()
                       if p.name.startswith("serving-") and p.node_name) \
                >= 5000

        pstats, plaunch, pvs, pfut = run_evict_phase(
            "preempt", store, CONF_PREEMPT_ONLY, grace=2, cycles=24,
            until=serving_bound)
    finally:
        os.environ.pop("VOLCANO_TPU_EVICT_CAP", None)
    restored = sum(1 for uid in store.pods if "-mig" in uid)
    pstats["restored"] = restored
    pstats["serving_bound"] = serving_bound(store)
    _log(f"[preempt] {json.dumps(_summary(pstats))}")
    if not pstats["serving_bound"]:
        raise AssertionError("[preempt] the serving gang did not bind in 24 "
                             "cycles")
    if pstats["evictions"] != 5000 or restored != 5000:
        raise AssertionError(f"[preempt] {pstats['evictions']} evictions, "
                             f"{restored} restores; 5000 each expected")
    store.close()

    # 11. the kernels on the eviction paths' inputs.
    from volcano_tpu_torch.ops import kernels

    if 0 not in rvs or 1 not in rvs:
        raise AssertionError("[kernels:evict] victim_scores not captured "
                             f"in both modes: {sorted(rvs)}")
    launches = {k: rlaunch[k] + plaunch[k] for k in rlaunch}
    rows = []
    for mode, cap in sorted(rvs.items()):
        row = replay_kernels({"victim_scores": cap}, launches,
                             names=["victim_scores"])[0]
        row["mode"] = ("preempt", "reclaim")[mode]
        row["V"] = int(cap["v_req"].shape[0])
        row["sort_ms"] = sort_yardstick(cap)
        rows.append(row)
        _log(f"[kernels:evict] victim_scores ({row['mode']}, V={row['V']}):"
             f" {row['ms']:.4f} ms/launch, plain {row['plain_ms']:.4f} ms, "
             f"bound {row['bound_ms']:.6f} ms ({row['bound_by']}), "
             f"launches {row['launches']}, max_abs_err {row['max_abs_err']}"
             f"; torch.sort(stable) of the packed order key "
             f"{row['sort_ms']:.4f} ms (the sort alone)")
    fut = dict(pfut)
    fut.update(rfut)
    missing = [k for k in FUTURE_KERNELS if k not in fut]
    _log(f"[kernels:future] captured from future-branch solves: "
         f"{sorted(fut)}; not launched by one: {missing}")
    future_rows = replay_kernels(fut, launches,
                                 names=[k for k in FUTURE_KERNELS if k in fut])
    for r in future_rows:
        _log(f"[kernels:future] {r['name']}: {r['ms']:.4f} ms/launch, plain "
             f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
             f"({r['bound_by']}), max_abs_err {r['max_abs_err']}")
    for k in ("coarse_shortlist", "rank_candidates", "walk_accept",
              "apply_commit"):
        if k not in fut:
            raise AssertionError(f"[kernels:future] {k} never ran in a "
                                 "future-branch solve")
    return rows, future_rows


# ------------------------------------------- rebalance and fabric topology

# The kernels each phase's main path must launch (``fabric_frag`` is
# written by the ``gang_block_fit`` launch: its own kernel launches 0 times).
REBALANCE_KERNELS = ("frag_scores", "coarse_shortlist", "rank_candidates",
                     "walk_accept", "apply_commit")
TOPOLOGY_KERNELS = REBALANCE_KERNELS + ("gang_block_fit",)
PREFER_KERNELS = ("gang_block_fit", "coarse_shortlist", "rank_candidates",
                  "walk_accept", "apply_commit")


def rebalance_store(workers: int):
    """bench.py config_rebalance's cluster: ``workers`` 4-cpu worker nodes,
    as many 3-cpu spill nodes, and one single-member 3-cpu filler gang per
    worker (pending; the set-up cycle places them)."""
    from volcano_tpu_torch.api import (GROUP_NAME_ANNOTATION, Node, Pod,
                                       PodGroup, PriorityClass)
    from volcano_tpu_torch.cache import ClusterStore, FakeBinder

    store = ClusterStore(binder=FakeBinder())
    store.add_priority_class(PriorityClass(name="bench-high", value=100))
    for i in range(workers):
        store.add_node(Node(name=f"w{i}", allocatable={
            "cpu": "4", "memory": "16Gi", "pods": 110}))
        store.add_node(Node(name=f"s{i}", allocatable={
            "cpu": "3", "memory": "16Gi", "pods": 110}))
    for i in range(workers):
        store.add_pod_group(PodGroup(name=f"bf{i}", min_member=1))
        store.add_pod(Pod(
            name=f"bfill{i}", annotations={GROUP_NAME_ANNOTATION: f"bf{i}"},
            containers=[{"cpu": "3", "memory": "1Gi"}]))
    return store


def add_bench_gang(store, gang: int) -> None:
    """config_rebalance's high-priority gang of whole-worker tasks."""
    from volcano_tpu_torch.api import GROUP_NAME_ANNOTATION, Pod, PodGroup

    store.add_pod_group(PodGroup(name="benchgang", min_member=gang,
                                 priority_class="bench-high"))
    for i in range(gang):
        store.add_pod(Pod(
            name=f"bg{i}", annotations={GROUP_NAME_ANNOTATION: "benchgang"},
            containers=[{"cpu": "4", "memory": "1Gi"}]))


def _bound(store, prefix: str) -> int:
    return sum(1 for p in store.pods.values()
               if p.name.startswith(prefix) and p.node_name)


def _gang_blocks(store) -> int:
    """Distinct fabric blocks (rack, slice) the fabric gang is bound in."""
    from volcano_tpu_torch.api import FABRIC_RACK, FABRIC_SLICE

    m = store.mirror
    blocks = set()
    for p in store.pods.values():
        if p.name.startswith("fabgang-") and p.node_name:
            labels = m.node_objs[m.n_row[p.node_name]].labels
            blocks.add((labels[FABRIC_RACK], labels[FABRIC_SLICE]))
    return len(blocks)


def _replay_rows(caps: dict, launches: dict, label: str, names) -> list:
    missing = [k for k in names if k not in caps]
    if missing:
        raise AssertionError(f"[kernels:{label}] never captured: {missing}")
    rows = []
    for name in names:
        key = name.split(":")[0]
        row = replay_kernels({key: caps[name]}, launches, names=[key])[0]
        rows.append(row)
        _log(f"[kernels:{label}] {name}: {row['ms']:.4f} ms/launch, plain "
             f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
             f"({row['bound_by']}), launches {row['launches']}, "
             f"max_abs_err {row['max_abs_err']}")
    return rows


def gated_replay(name: str, cap: dict, reps: int = 20) -> dict:
    """``aff_live`` or ``aff_steer`` on its captured inputs with the gate
    clear (a launch behind its byte): the kernel and the plain version
    must leave the buffers as they were; timed as in ``replay_kernels``."""
    import torch

    c = _clone(cap)
    dev = c["at"].cnt_a.device
    if name == "aff_live" and c.get("out") is None:
        # A phase-1 launch: no cache buffers of its own.
        M = c["rows"].shape[0]
        cand = c["cand"]
        L = (c["at"].node_dom.shape[0] if cand is None
             else cand.shape[0] if cand.dim() == 1 else cand.shape[1])
        c["out"] = (torch.ones((M, L), dtype=torch.bool, device=dev),
                    torch.zeros((M, L), dtype=torch.float32, device=dev))
    c["gate"] = torch.zeros(1, dtype=torch.bool, device=dev)
    prior = _tensors(c["out"])
    for plain in (False, True):
        out = _kernel_fn(name, _clone(c), plain)()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, prior)):
            raise AssertionError(f"{name} gated (plain={plain}) changed "
                                 f"its buffers")
    times = {}
    for plain in (False, True, True, False):
        fns = [_kernel_fn(name, _clone(c), plain) for _ in range(reps)]
        times.setdefault(plain, []).append(_device_ms(fns))
    k_best, p_best = min(times[False]), min(times[True])
    return {"ms": k_best[0], "plain_ms": p_best[0], "wrapper_ms": k_best[1],
            "queued": k_best[2], "plain_queued": p_best[2],
            "max_abs_err": 0.0}


def first_shapes(caps: dict) -> dict:
    """The first launches' shapes: ``rank_candidates`` (M rows, L
    candidates, depth K) and ``aff_live`` (M rows, L candidates, T listed
    terms, EW count rows, D domains, whether it was gated)."""
    out = {}
    for name, c in sorted(caps.items()):
        if name.startswith("rank_candidates"):
            L = c["idle"].shape[0] if c["cand"] is None else c["cand"].shape[1]
            out[name] = {"M": int(c["rows"].shape[0]), "L": int(L),
                         "K": int(c["K"])}
        elif name == "aff_live":
            cand = c["cand"]
            L = (c["at"].node_dom.shape[0] if cand is None
                 else cand.shape[0] if cand.dim() == 1 else cand.shape[1])
            EW, D = c["at"].cnt_a.shape
            out[name] = {"M": int(c["rows"].shape[0]), "L": int(L),
                         "T": int(c["terms"].shape[1]), "EW": int(EW),
                         "D": int(D), "gate": c.get("gate") is not None}
    return out


def frag_gauge_checked(checks: list):
    """A stand-in for ``FastCycle._plan_rebalance`` that holds each call's
    ``volcano_topology_frag_score`` gauge to the plain ``fabric_frag`` of
    the block fit the call fetched (``frag``, written by the block fit's
    launch, bytes compared; the gauge its mean) and appends the gauge to
    ``checks``.  Returns (the stand-in, the method it wraps)."""
    import torch

    from volcano_tpu_torch import fastpath
    from volcano_tpu_torch.metrics import metrics
    from volcano_tpu_torch.ops import kernels

    plan = fastpath.FastCycle._plan_rebalance
    fit = fastpath.FastCycle._topo_block_fit

    def checked(self, jrow):
        seen = []

        def recorded(cyc, j):
            tf = fit(cyc, j)
            seen.append(tf)
            return tf

        metrics.topology_frag_score.data.clear()
        fastpath.FastCycle._topo_block_fit = recorded
        try:
            out = plan(self, jrow)
        finally:
            fastpath.FastCycle._topo_block_fit = fit
        seen = [tf for tf in seen if tf is not None]
        if seen:
            tf = seen[-1]
            want = kernels._fabric_frag_plain(
                torch.from_numpy(tf["cfit"]), torch.from_numpy(tf["whole"]),
                torch.from_numpy(tf["prof_cnt"])).numpy()
            gauge = metrics.topology_frag_score.data.get(())
            want_g = float(want.mean()) if len(want) else 0.0
            if want.tobytes() != tf["frag"].tobytes() or gauge != want_g:
                raise AssertionError(
                    f"[topology] frag gauge {gauge} (planes {tf['frag']}) "
                    f"!= the plain fabric_frag's {want_g} ({want})")
            checks.append(want_g)
        return out

    return checked, plan


def sync_ops(fn):
    """(``fn()``, the device operations of the call in order (``device_ops``;
    [] when the trace held none), the synchronising calls it made: each
    warns once under torch's sync debug mode -- a fetch, a pageable
    upload -- and is listed as the ``file:line`` of the Python line that
    made it; warnings raised from torch's own modules (turning the mode on
    warns once a process) are not the call's)."""
    import os
    import warnings

    import torch

    own = os.path.dirname(torch.__file__) + os.sep
    syncs = []

    def counted():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
                syncs.extend(f"{os.path.basename(w.filename)}:{w.lineno}"
                             for w in caught
                             if "synchroniz" in str(w.message).lower()
                             and not w.filename.startswith(own))

    res, ops = device_ops(counted)
    return res, ops or [], syncs


def op_counts(ops) -> dict:
    """Device operations counted by kind: copies by direction, kernels by
    name."""
    kinds = {}
    for op in ops:
        key = ("copy HtoD" if "HtoD" in op else "copy DtoH" if "DtoH" in op
               else op)
        kinds[key] = kinds.get(key, 0) + 1
    return kinds


def plan_trace(racks=16, slices_per_rack=8, nodes_per_slice=64,
               tries=3) -> dict:
    """One ``FastCycle._plan_rebalance`` call with a topology constraint,
    traced: the ``[topology]`` fabric built afresh and one ``run_once()``,
    whose first plan call runs under ``sync_ops`` (its device operations
    in order and its synchronising calls).  A short trace has lost its
    first device events on the card, so this runs ``tries`` times, each on
    a fresh fabric, and keeps the fullest trace (a trace loses events, it
    never adds one).  Returns the operations, their counts
    (``op_counts``), the synchronising calls of that try and of every
    try."""
    import torch

    from volcano_tpu_torch import fastpath
    from volcano_tpu_torch.cache import FakeBinder
    from volcano_tpu_torch.framework import REBALANCE_SCHEDULER_CONF
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.synth import fabric_cluster

    plan = fastpath.FastCycle._plan_rebalance
    best, all_syncs = None, []
    for _ in range(tries):
        store = fabric_cluster(racks=racks, slices_per_rack=slices_per_rack,
                               nodes_per_slice=nodes_per_slice,
                               gang_tasks=2 * nodes_per_slice,
                               topology="require-contiguous",
                               binder=FakeBinder())
        out = {}

        def traced(self, jrow, out=out):
            if out:
                return plan(self, jrow)
            res, out["ops"], out["syncs"] = sync_ops(
                lambda: plan(self, jrow))
            out["topology"] = int(self.m.j_topo[jrow])
            return res

        fastpath.FastCycle._plan_rebalance = traced
        try:
            Scheduler(store, conf_str=REBALANCE_SCHEDULER_CONF).run_once()
            torch.cuda.synchronize()
            audit_checked("rebalance:plan-trace", store)
        finally:
            fastpath.FastCycle._plan_rebalance = plan
            store.close()
        if not out or not out["topology"]:
            raise AssertionError("[rebalance:plan-trace] no plan call with "
                                 "a topology constraint")
        all_syncs.append(len(out["syncs"]))
        if best is None or len(out["ops"]) > len(best["ops"]):
            best = out
    best["counts"] = op_counts(best["ops"])
    best["syncs_each_try"] = all_syncs
    return best


def rebalance_phases(workers=5000, racks=16, slices_per_rack=8,
                     nodes_per_slice=64):
    """Phases 12-15: the rebalance lane at 2 x ``workers`` nodes, the fabric
    topology path at racks x slices_per_rack blocks of nodes_per_slice
    nodes (require- and prefer-contiguous, a gang of 2 x nodes_per_slice
    tasks), then ``frag_scores``, ``gang_block_fit``, ``fabric_frag`` and
    the biased ``rank_candidates`` on their captured inputs against their
    plain versions.  Returns (the three new kernels' rows, the biased
    rank_candidates row)."""
    import os

    from volcano_tpu_torch import fastpath
    from volcano_tpu_torch.cache import FakeBinder
    from volcano_tpu_torch.framework import REBALANCE_SCHEDULER_CONF
    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.sim import ClusterSimulator
    from volcano_tpu_torch.synth import fabric_cluster

    conf = REBALANCE_SCHEDULER_CONF
    # 12. rebalance: bench.py config_rebalance at 5,000 workers (10,000
    # nodes, 5,000 fillers, a 2,500-task whole-node gang).
    gang = workers // 2
    os.environ["VOLCANO_TPU_REBALANCE_DRAIN_CAP"] = str(workers)
    try:
        t0 = time.perf_counter()
        store = rebalance_store(workers)
        # Set-up: the fillers are placed and start Running, then the gang
        # arrives.
        Scheduler(store, conf_str=conf).run_once()
        ClusterSimulator(store, grace_steps=2).step()
        if _bound(store, "bfill") != workers:
            raise AssertionError("[rebalance] set-up left fillers pending")
        add_bench_gang(store, gang)
        _log(f"[rebalance] cluster + set-up cycle "
             f"{time.perf_counter() - t0:.3f} s, {len(store.pods)} pods")

        def converged(st):
            return (_bound(st, "bg") >= gang
                    and _bound(st, "bfill") == workers)

        kernels.CAPTURE = {}
        rstats, rlaunch, _vs, _fut = run_evict_phase(
            "rebalance", store, conf, grace=2, cycles=8, until=converged,
            need=REBALANCE_KERNELS, require_future=False, profile_cycle=0,
            extra=lambda st: {"gang_bound": _bound(st, "bg"),
                              "fillers_bound": _bound(st, "bfill")})
        rcaps, kernels.CAPTURE = kernels.CAPTURE, None
    finally:
        os.environ.pop("VOLCANO_TPU_REBALANCE_DRAIN_CAP", None)
    led = store.migrations
    rstats.update(gang_bound=_bound(store, "bg"),
                  fillers_bound=_bound(store, "bfill"),
                  fillers=sum(1 for p in store.pods.values()
                              if p.name.startswith("bfill")),
                  evicted=len(store.evictor.evicts),
                  restored=0 if led is None else led.restored_pods,
                  committed_plans=0 if led is None else led.committed_plans)
    _log(f"[rebalance] {json.dumps(_summary(rstats))}")
    if not converged(store) or rstats["fillers"] != workers:
        raise AssertionError(f"[rebalance] did not converge: "
                             f"{_summary(rstats)}")
    if (rstats["committed_plans"] < 1 or rstats["evicted"] < 1
            or rstats["evicted"] != rstats["restored"]
            or rstats["rebalance_evictions"] != rstats["evicted"]):
        raise AssertionError(f"[rebalance] evictions and restores differ: "
                             f"{_summary(rstats)}")
    store.close()

    # 13. topology: a fragmented fabric of 128 blocks of 64 nodes, a
    # 128-task require-contiguous gang no block can host before a drain
    # (two fillers strand two nodes of every block).
    n_gang = 2 * nodes_per_slice
    n_fill = 2 * racks * slices_per_rack

    def fabric(topology):
        t0 = time.perf_counter()
        st = fabric_cluster(racks=racks, slices_per_rack=slices_per_rack,
                            nodes_per_slice=nodes_per_slice,
                            gang_tasks=n_gang, topology=topology,
                            binder=FakeBinder())
        _log(f"[topology] {topology} cluster {time.perf_counter() - t0:.3f}"
             f" s, {len(st.nodes)} nodes, {len(st.pods)} pods")
        return st

    def fabric_extra(st):
        return {"gang_bound": _bound(st, "fabgang-"),
                "gated": "default/fabgang" in st._topo_gated,
                "gang_blocks": _gang_blocks(st),
                "fillers_bound": _bound(st, "filler-")}

    store = fabric("require-contiguous")
    kernels.CAPTURE = {}
    gauges = []
    fastpath.FastCycle._plan_rebalance, plan = frag_gauge_checked(gauges)
    try:
        tstats, tlaunch, _vs, _fut = run_evict_phase(
            "topology", store, conf, grace=2, cycles=12,
            until=lambda st: _bound(st, "fabgang-") >= n_gang,
            need=TOPOLOGY_KERNELS, require_future=False, extra=fabric_extra,
            profile_cycle=0)
    finally:
        fastpath.FastCycle._plan_rebalance = plan
    tcaps, kernels.CAPTURE = kernels.CAPTURE, None
    _log(f"[topology] fabric_frag: {tlaunch['fabric_frag']} launches of its "
         f"own, {tlaunch[FUSED_FRAG]} written by gang_block_fit's "
         f"{tlaunch['gang_block_fit']} launches; frag gauges of the "
         f"{len(gauges)} plans equal to the plain fabric_frag: {gauges}")
    if (tlaunch["fabric_frag"] != 0 or not gauges
            or tlaunch[FUSED_FRAG] != tlaunch["gang_block_fit"]):
        raise AssertionError("[topology] fabric_frag not written by the "
                             "block-fit launch alone, or no plan's gauge "
                             "checked")
    c0 = tstats["cycles"][0]
    led = store.migrations
    tstats.update(fabric_extra(store), evicted=len(store.evictor.evicts),
                  restored=0 if led is None else led.restored_pods)
    _log(f"[topology] {json.dumps(_summary(tstats))}")
    if not (c0["gated"] and c0["gang_bound"] == 0 and c0["plans"] == 1):
        raise AssertionError(f"[topology] cycle 0 did not pregate the gang "
                             f"and commit one plan: {c0}")
    if (tstats["gang_bound"] != n_gang or tstats["gang_blocks"] != 1
            or tstats["fillers_bound"] != n_fill
            or tstats["evicted"] != tstats["restored"]):
        raise AssertionError(f"[topology] gang not bound in one block with "
                             f"every filler re-bound: {_summary(tstats)}")
    store.close()

    # 14. prefer-contiguous: the same fabric binds the gang on cycle 0,
    # steered by the solve's node bias.
    store = fabric("prefer-contiguous")
    kernels.CAPTURE = {}
    pstats, plaunch, _vs, _fut = run_evict_phase(
        "topology:prefer", store, conf, grace=2, cycles=1,
        need=PREFER_KERNELS, require_future=False, extra=fabric_extra)
    pcaps, kernels.CAPTURE = kernels.CAPTURE, None
    _log(f"[topology:prefer] {json.dumps(_summary(pstats))}")
    if pstats["cycles"][0]["gang_bound"] != n_gang:
        raise AssertionError("[topology:prefer] gang not bound on cycle 0")
    if "rank_candidates:bias" not in pcaps:
        raise AssertionError("[topology:prefer] no biased ranking launched")
    store.close()

    # One plan call with a topology constraint, traced.
    tr = plan_trace(racks, slices_per_rack, nodes_per_slice)
    _log(f"[rebalance:plan-trace] one _plan_rebalance call (topology "
         f"{tr['topology']}), the fullest of {len(tr['syncs_each_try'])} "
         f"traces: device operations {json.dumps(tr['counts'])}, in order "
         f"{tr['ops']}; synchronising calls {len(tr['syncs'])} (each try "
         f"{tr['syncs_each_try']}) at {tr['syncs']}")
    if (tr["counts"].get("copy DtoH", 0) > 2
            or tr["counts"].get("fabric_frag_kernel", 0)):
        raise AssertionError(f"[rebalance:plan-trace] more than two fetches "
                             f"or a fabric_frag launch: {tr['counts']}")

    # 15. the new kernels and the biased ranking on their inputs; the
    # standalone fabric_frag on the captured block fit's cfit / whole.
    launches = {k: rlaunch[k] + tlaunch[k] + plaunch[k] for k in rlaunch}
    rows = _replay_rows(rcaps, launches, "rebalance", ["frag_scores"])
    rows += _replay_rows(tcaps, launches, "topology", ["gang_block_fit"])
    c = tcaps["gang_block_fit"]
    cfit, whole, _score, _frag = kernels.gang_block_fit(
        c["idle"], c["ready"], c["ntasks"], c["max_tasks"], c["block_id"],
        c["prof_req"], c["prof_cnt"], c["eps"], c["n_blocks"])
    fused = tlaunch[FUSED_FRAG] + plaunch[FUSED_FRAG]
    frag_row = replay_kernels(
        {"fabric_frag": {"cfit": cfit, "whole": whole,
                         "prof_cnt": c["prof_cnt"]}},
        {"fabric_frag": fused}, names=["fabric_frag"])[0]
    frag_row.update(own_launches=launches["fabric_frag"],
                    launched_by="gang_block_fit")
    _log(f"[kernels:topology] fabric_frag (standalone, on the block fit's "
         f"cfit / whole): {frag_row['ms']:.4f} ms/launch, plain "
         f"{frag_row['plain_ms']:.4f} ms, bound {frag_row['bound_ms']:.6f} "
         f"ms ({frag_row['bound_by']}); on the path written by "
         f"{fused} gang_block_fit launches, {launches['fabric_frag']} of "
         f"its own, max_abs_err {frag_row['max_abs_err']}")
    rows.append(frag_row)
    bias_row = _replay_rows(tcaps, launches, "topology",
                            ["rank_candidates:bias"])[0]
    return rows, bias_row

# ------------------------------------------- inter-pod affinity (config 5)

# bench.py CONF_BASE: BASELINE config 5's conf.
CONF_BASE = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""
# The kernels the config-5 cycle must launch.
AFF_KERNELS = ("coarse_shortlist", "static_planes", "rank_candidates",
               "walk_accept", "apply_commit", "scatter_cnt0",
               "scatter_profile_tables", "aff_live", "aff_filter")
# Captured launches replayed against their plain versions: the four new
# kernels and the extended ones on affinity inputs.
AFF_REPLAY = ("scatter_cnt0", "scatter_profile_tables", "aff_live",
              "aff_filter", "coarse_shortlist:aff", "rank_candidates:aff",
              "rank_candidates:aff:fallback", "walk_accept:aff",
              "apply_commit:aff", "warm_shortlist:aff")
HOSTNAME = "kubernetes.io/hostname"


def config5_cluster(n_nodes, n_pods, ports=0.0, seed=0):
    """bench.py config_5's store (synthetic_cluster with gangs of 8, 16
    zones, 5% required zone affinity, 5% required hostname anti-affinity,
    10% zone spread), the uid counters reset; ``ports`` gives that share
    of gangs host ports."""
    return _fresh_cluster(n_nodes=n_nodes, n_pods=n_pods, gang_size=8,
                          zones=16, affinity_fraction=0.05,
                          anti_affinity_fraction=0.05, spread_fraction=0.1,
                          host_port_fraction=ports, seed=seed)


def aff_invariants(store, split=()) -> dict:
    """``held_invariants`` (``split``: the job rows whose members a feed
    unbound or deleted -- their re-placement competes with other pending
    gangs, as it does in the JAX package); every bound
    required-zone-affinity gang in one zone; every bound hostname
    anti-affinity gang on distinct nodes; no node with two held pods
    asking for one host port."""
    import numpy as np

    from volcano_tpu_torch.api import GROUP_NAME_ANNOTATION

    m = store.mirror
    st = m.p_status[:m.n_pods]
    counts, rows = held_invariants(store, split)
    zone_gangs = anti_gangs = 0
    by_gang = {}
    port_use = set()
    for r in rows.tolist():
        pod = store.pods.get(m.p_uid[r])
        if pod is None:
            continue
        node = m.p_node_name[r]
        for port in pod.host_ports:
            if (node, port) in port_use:
                raise AssertionError(f"host port {port} twice on {node}")
            port_use.add((node, port))
        if np.isin(st[r], ALLOCATED):
            by_gang.setdefault(pod.annotations.get(
                GROUP_NAME_ANNOTATION, ""), []).append((pod, node))
    for members in by_gang.values():
        pod = members[0][0]
        nodes = [n for _p, n in members]
        if any(t.topology_key == "zone" for t in pod.affinity):
            zone_gangs += 1
            zs = {m.node_objs[m.n_row[n]].labels.get("zone") for n in nodes}
            if len(zs) != 1:
                raise AssertionError(f"zone-affine gang across zones {zs}")
        if any(t.topology_key == HOSTNAME for t in pod.anti_affinity):
            anti_gangs += 1
            if len(set(nodes)) != len(nodes):
                raise AssertionError("anti-affine gang shares a node")
    return {**counts, "zone_gangs": zone_gangs, "anti_gangs": anti_gangs,
            "ports_held": len(port_use)}


def run_aff_cycles(label, store, steady=5, trace=False, device=None,
                   release=None, repend=range(64), all_bound=False,
                   conf=CONF_BASE):
    """``Scheduler(store).run_once()`` under ``conf``: one cold cycle,
    ``steady`` cycles re-pending the pods on the nodes ``repend``,
    optionally one traced steady cycle; ``release(store)`` (when given)
    runs after the steady cycles, and three more cycles follow, each
    followed by a kubelet tick (grace 1: the Releasing pods go after the
    second).  The feed leaves the re-pended pods' records as they were
    (``FastCycle._unbind_rows``), so a release, which edits pod records,
    runs on a store without steady cycles.  After every cycle:
    ``aff_invariants``, with ``all_bound`` also ``cycle_invariants``
    (every pod bound, every PodGroup Running), and zero host reads per
    solve.  Each cycle's record holds the launches it counted and the
    captures it added (``kernels.CAPTURE``, when set).  Returns (stats,
    per-cycle records)."""
    import numpy as np
    import torch

    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.ops import wave as wave_mod
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.sim import ClusterSimulator

    sched = Scheduler(store, conf_str=conf, device=device)
    sim = None
    solve_wave = wave_mod.solve_wave
    solves = []
    stats = {"cycles": []}
    records = []
    n_pods = len(store.pods)
    split = set()  # job rows the feed or the release split

    def feed(fc):
        m = fc.m
        rows = np.flatnonzero((m.p_status[:fc.Pn] == ST_BOUND)
                              & m.p_alive[:fc.Pn])
        sel = rows[np.isin(m.p_node[rows], list(repend))]
        if len(sel):
            split.update(m.p_job[sel].tolist())
            fc._unbind_rows(sel)

    def counted_solve(*a, **kw):
        out = solve_wave(*a, **kw)
        info = wave_mod.LAST_TWOPHASE
        solves.append({k: info.get(k) for k in (
            "host_reads", "future", "ports", "affinity", "cnt0_any",
            "sparse", "devincr", "enabled", "compacted_classes",
            "steer_calls")})
        solves[-1]["fb"] = [int(out.fb_exhausted), int(out.fb_affinity)]
        solves[-1]["pipelined"] = int((out.pipelined >= 0).sum())
        return out

    def cycle(kind):
        solves.clear()
        launched = launch_counts()
        captured = set(kernels.CAPTURE or ())
        wave_mod.solve_wave = counted_solve
        try:
            t0 = time.perf_counter()
            sched.run_once()
            if device is None:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            wave_mod.solve_wave = solve_wave
        inv = aff_invariants(store, split)
        if all_bound:
            inv.update(cycle_invariants(store, n_pods))
        rec = {"kind": kind, "wall_s": wall, "lanes_ms": _lanes(store),
               "solves": [dict(x) for x in solves],
               "launches": {k: v - launched[k]
                            for k, v in launch_counts().items()
                            if v != launched[k]},
               "captured": sorted(set(kernels.CAPTURE or ()) - captured),
               **inv}
        stats["cycles"].append(rec)
        _log(f"[{label}] {kind} cycle {wall:.4f} s "
             f"{json.dumps({k: v for k, v in rec.items() if k != 'kind'})}")
        if any(x["host_reads"] != 0 for x in solves):
            raise AssertionError(f"[{label}] {kind} cycle: a solve read "
                                 f"device planes back")
        records.append((dict(store.binder.binds),
                        {u: pg.status.phase
                         for u, pg in sorted(store.pod_groups.items())},
                        _mirror_state(store),
                        [x["fb"] for x in solves]))
        if sim is not None:
            sim.step()

    cycle("cold")
    if not stats["cycles"][0]["solves"]:
        raise AssertionError(f"[{label}] the cold cycle ran no solve")
    store.cycle_feed = feed
    for _ in range(steady):
        cycle("steady")
    if trace:
        solves.clear()
        wave_mod.solve_wave = counted_solve
        try:
            prof = profile_device(sched.run_once)
        finally:
            wave_mod.solve_wave = solve_wave
        if any(x["host_reads"] != 0 for x in solves):
            raise AssertionError(f"[{label}] traced cycle read planes back")
        aff_invariants(store, split)
        if all_bound:
            cycle_invariants(store, n_pods)
        stats["profile"] = prof
    if release is not None:
        store.cycle_feed = None
        split.update(release(store))
        all_bound = False
        sim = ClusterSimulator(store, grace_steps=1)
        for _ in range(3):
            cycle("release")
    stats["audit"] = audit_checked(label, store)
    return stats, records


def _release(store):
    """Releasing capacity for the future branch: the pods on nodes 0-63
    (the fullest: binpack fills the low rows first) start terminating
    (Releasing), those nodes gain the label pool=release, and 16 gangs of
    8 four-CPU pods selecting that label arrive -- every fourth with host
    port 8080, every third zone-affine to itself -- so they fit only the
    releasing capacity and are pipelined.  Returns the job rows whose
    members terminate."""
    import dataclasses

    from volcano_tpu_torch.api import (GROUP_NAME_ANNOTATION, AffinityTerm,
                                       Pod, PodGroup)

    m = store.mirror
    rows = [r for r in range(m.n_pods)
            if m.p_alive[r] and 0 <= m.p_node[r] < 64
            and int(m.p_status[r]) in ALLOCATED]
    for r in rows:
        store.update_pod(dataclasses.replace(store.pods[m.p_uid[r]],
                                             deleting=True))
    jobs = {int(m.p_job[r]) for r in rows}
    for row in range(64):
        node = m.node_objs[row]
        store.update_node(dataclasses.replace(
            node, labels={**node.labels, "pool": "release"}))
    for g in range(16):
        name = f"late-{g:02d}"
        store.add_pod_group(PodGroup(name=name, min_member=8))
        aff = ([AffinityTerm(match_labels={"app": name}, topology_key="zone")]
               if g % 3 == 0 else [])
        for k in range(8):
            store.add_pod(Pod(
                name=f"{name}-{k}", labels={"app": name},
                annotations={GROUP_NAME_ANNOTATION: name},
                containers=[{"cpu": "4", "memory": "4Gi"}], affinity=aff,
                node_selector={"pool": "release"},
                host_ports=[8080] if g % 4 == 0 else []))
    return jobs


def aff_cold_trace(big, cold_lanes) -> dict:
    """The [affinity] cold cycle again, on a fresh store of the same seed
    (the same decisions and kernel inputs), traced with ``torch.profiler``:
    every kernel's device time and launches summed over the cycle (per
    wrapper and per CUDA function), ``aff_live``'s computing and gated
    launches, and the kernels' share of the cycle's ``device_fine`` lane
    (the traced cycle's own, and the untraced cold cycle's
    ``cold_lanes``)."""
    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.scheduler import Scheduler

    t0 = time.perf_counter()
    store = config5_cluster(*big)
    build = time.perf_counter() - t0
    kernels.reset_launches()
    prof = profile_device(Scheduler(store, conf_str=CONF_BASE).run_once)
    launches = launch_counts()
    computing = kernels.read_tally("aff_live")
    aff_invariants(store)
    inv = cycle_invariants(store, len(store.pods))
    fine = _lanes(store).get("device_fine", 0.0)
    audit_checked("affinity:cold-trace", store)
    store.close()
    if not prof:
        _log("[affinity:cold-trace] no device events in the trace (the "
             "kernels' device time over the cold cycle not measured)")
        return {}
    km = prof["kernels_ms"]
    total = sum(km.values())
    untraced = cold_lanes.get("device_fine", 0.0)
    out = {"kernels_ms": km, "funcs": prof["funcs"], "launches": launches,
           "aff_live_computing": computing,
           "aff_live_gated": launches["aff_live"] - computing,
           "kernels_sum_ms": total, "device_fine_ms": fine,
           "untraced_device_fine_ms": untraced,
           "busy_ms": prof["busy_ms"], "wall_ms": prof["wall_ms"],
           "cluster_s": build, "pods_bound": inv["pods_bound"]}
    _log(f"[affinity:cold-trace] device time per kernel over the cold "
         f"cycle (ms / launches): {_traced_sums(prof)}; aff_live launches "
         f"{launches['aff_live']} = {computing} computing + "
         f"{out['aff_live_gated']} gated; all kernels {total:.3f} ms, "
         f"{100.0 * total / max(fine, 1e-9):.2f}% of its device_fine "
         f"{fine:.3f} ms ({100.0 * total / max(untraced, 1e-9):.2f}% of "
         f"the untraced cold cycle's {untraced:.3f} ms); "
         f"{json.dumps(out)}")
    return out


def affinity_phases(big=(10000, 100000), mid=(1000, 10000),
                    chunk_budget_mb="2", expect_sparse=True):
    """Phases 16-19: BASELINE config 5 through ``run_once()`` at 10,000 x
    100,000 (cold, 5 steady, one traced); the same mix at 1,000 x 10,000
    with host ports and releasing capacity, card against CPU and lanes on
    against off; the 1,000 x 10,000 store in job-aligned chunks, card
    against CPU; then the four new kernels and the extended ones on their
    captured affinity inputs against their plain versions.  Returns the
    kernel rows and the affinity rows of the extended kernels."""
    import os

    from volcano_tpu_torch.ops import kernels

    # 16. config 5 at 10,000 x 100,000.
    t0 = time.perf_counter()
    store = config5_cluster(*big)
    _log(f"[affinity] cluster {time.perf_counter() - t0:.3f} s, "
         f"{len(store.pods)} pods")
    kernels.CAPTURE = {}
    kernels.reset_launches()
    astats, _rec = run_aff_cycles("affinity", store, steady=5, trace=True,
                                  all_bound=True)
    launches = launch_counts()
    computing = kernels.read_tally("aff_live")
    caps, kernels.CAPTURE = kernels.CAPTURE, None
    _log(f"[affinity] launches {json.dumps(launches)}; aff_live "
         f"{computing} computing + {launches['aff_live'] - computing} gated;"
         f" first-launch shapes {json.dumps(first_shapes(caps))}")
    _log(f"[affinity] static planes: {launches['static_planes']} launches "
         f"of their own, {launches[FUSED_STATIC]} built in a shortlist "
         f"launch; per cycle (own, in a shortlist launch) "
         f"{[(c['launches'].get('static_planes', 0), c['launches'].get(FUSED_STATIC, 0)) for c in astats['cycles']]}")
    missing = never_launched(launches, AFF_KERNELS)
    if missing:
        raise AssertionError(f"[affinity] kernels never launched: {missing}")
    c0 = astats["cycles"][0]
    if expect_sparse and not any(tuple(x["sparse"]) == (True, True)
                                 for x in c0["solves"]):
        raise AssertionError("[affinity] the cold solve shipped dense tables")
    if not any(x["cnt0_any"] for c in astats["cycles"][1:]
               for x in c["solves"]):
        raise AssertionError("[affinity] no steady solve read resident "
                             "counts")
    prof = astats.pop("profile")
    if prof:
        _log(f"[affinity] traced steady cycle: device busy "
             f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms wall, "
             f"device idle share "
             f"{100.0 * (1 - prof['busy_ms'] / prof['wall_ms']):.2f}%, "
             f"kernels(ms) {json.dumps(prof['kernels_ms'])}, per function "
             f"{_traced_sums(prof)}, top {json.dumps(prof['top'])}")
    else:
        _log("[affinity] traced steady cycle: no device events in the "
             "trace (idle share not measured)")
    store.close()
    astats["cold_trace"] = aff_cold_trace(big, c0["lanes_ms"])

    # 17. 1,000 x 10,000 with host ports and releasing capacity: the card
    # against the CPU (plain versions), lanes on against lanes off.
    def small(device, lanes=True, release=False):
        saved = {k: os.environ.get(k) for k in ("VOLCANO_TPU_DEVINCR",
                                                "VOLCANO_TPU_DEVSNAP")}
        if not lanes:
            os.environ.update({k: "0" for k in saved})
        try:
            st = config5_cluster(*mid, ports=0.1)
            stats, rec = run_aff_cycles(
                f"affinity:small:{device or 'cuda'}"
                f"{'' if lanes else ':lanes-off'}"
                f"{':release' if release else ''}", st,
                steady=0 if release else 8, device=device,
                release=_release if release else None, repend=range(16))
            dv = st._devincr_cache
            st.close()
            return stats, rec, None if dv is None else dict(dv.counts)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    kernels.CAPTURE = {}
    kernels.reset_launches()
    s_card, r_card, dv_counts = small(None)
    x_card, rx_card, _ = small(None, release=True)
    small_launches = launch_counts()
    computing += kernels.read_tally("aff_live")
    small_caps, kernels.CAPTURE = kernels.CAPTURE, None
    for k, v in small_caps.items():
        caps.setdefault(k, v)
    _s_cpu, r_cpu, _ = small("cpu")
    _x_cpu, rx_cpu, _ = small("cpu", release=True)
    _same_records("affinity:small", r_card, r_cpu, "card vs CPU")
    _same_records("affinity:small", rx_card, rx_cpu, "card vs CPU, release")
    _s_off, r_off, _ = small(None, lanes=False)
    _x_off, rx_off, _ = small(None, lanes=False, release=True)
    # The lanes' null-delta skip drops solves, so only the outcome is
    # compared there.
    _same_records("affinity:small", r_card, r_off, "lanes on vs off",
                  fields=3)
    _same_records("affinity:small", rx_card, rx_off,
                  "lanes on vs off, release", fields=3)
    solves = [x for c in s_card["cycles"] + x_card["cycles"]
              for x in c["solves"]]
    if not any(x["future"] for x in solves):
        raise AssertionError("[affinity:small] no future-branch solve")
    if not any(x["ports"] for x in solves):
        raise AssertionError("[affinity:small] no solve with host ports")
    warm_cnt0 = [x for x in solves if x["cnt0_any"] and x["devincr"]
                 and x["devincr"]["mode"] == "warm"]
    if not warm_cnt0:
        raise AssertionError("[affinity:small] no warm shortlist on "
                             "nonzero counts (the cnt0-hash warm key)")
    if not any(x["pipelined"] for c in x_card["cycles"]
               for x in c["solves"]):
        raise AssertionError("[affinity:small] nothing pipelined")
    _log(f"[affinity:small] card = CPU and lanes on = off over "
         f"{len(r_card)} cycles; devincr {dv_counts}; warm solves on "
         f"nonzero counts {len(warm_cnt0)}; launches "
         f"{json.dumps(small_launches)}")

    # 18. the 1,000 x 10,000 store in >= 4 job-aligned chunks.
    os.environ["VOLCANO_TPU_AFF_BUDGET_MB"] = chunk_budget_mb
    try:
        def chunks(device):
            st = config5_cluster(*mid)
            stats, rec = run_aff_cycles(
                f"affinity:chunks:{device or 'cuda'}", st, steady=1,
                device=device)
            st.close()
            return stats, rec
        c_card, rc_card = chunks(None)
        _c_cpu, rc_cpu = chunks("cpu")
    finally:
        os.environ.pop("VOLCANO_TPU_AFF_BUDGET_MB", None)
    n_chunks = len(c_card["cycles"][0]["solves"])
    if n_chunks < 4:
        raise AssertionError(f"[affinity:chunks] {n_chunks} chunks, not >= 4")
    _same_records("affinity:chunks", rc_card, rc_cpu, "card vs CPU")
    _log(f"[affinity:chunks] cold cycle in {n_chunks} chunks; card = CPU")

    # 19. the kernels on their captured affinity inputs.
    total = {k: launches[k] + small_launches[k] for k in launches}
    rows = _replay_rows(caps, total, "affinity", AFF_REPLAY[:4])
    live = next(r for r in rows if r["name"] == "aff_live")
    # The attempt cache: launches that computed the planes and launches
    # the gate skipped (device counts), and a gated launch's time.
    live["computing_launches"] = computing
    live["gated_launches"] = total["aff_live"] - computing
    live["gated"] = gated_replay("aff_live", caps["aff_live"])
    _log(f"[kernels:affinity] aff_live gated: {json.dumps(live['gated'])}")
    ext = list(zip(AFF_REPLAY[4:], _replay_rows(caps, total, "affinity",
                                                AFF_REPLAY[4:])))
    rows.append(cold_block_row(caps, astats))
    return rows, ext, astats


def cold_block_row(caps: dict, astats: dict) -> dict:
    """The config-5 cold cycle's block-form ``coarse_shortlist`` launch
    (the ``[affinity]`` phase's cold cycle: every profile row of the cold
    solve ranked per node block and merged) against its plain version,
    timed as in ``replay_kernels``: a kernels row of its own,
    ``coarse_shortlist:cold``, with its shape.  Its launches are those
    the cold cycle counted; the cycle must launch the wrapper once, in
    the block form, and capture that launch."""
    c0 = astats["cycles"][0]
    n = c0["launches"].get("coarse_shortlist", 0)
    keys = [k for k in c0["captured"] if k.startswith("coarse_shortlist")]
    if n != 1 or len(keys) != 1 or not caps[keys[0]]["n_blocks"]:
        raise AssertionError(
            f"[affinity] the cold cycle launched coarse_shortlist {n} "
            f"times and captured {keys}: not one block-form launch")
    cap = caps[keys[0]]
    U = int(cap["req"].shape[0])
    N = int(cap["idle"].shape[0])
    B = int(cap["n_blocks"])
    shape = {"U": U, "N": N, "B": B, "klb": min(int(cap["S"]), N // B),
             "S": int(cap["S"])}
    row = _replay_rows({"coarse_shortlist:cold": cap},
                       {"coarse_shortlist": n}, "affinity",
                       ["coarse_shortlist:cold"])[0]
    row["name"] = "coarse_shortlist:cold"
    row["shape"] = shape
    _log(f"[kernels:affinity] coarse_shortlist:cold shape "
         f"{json.dumps(shape)}")
    return row


# ------------------------------------------------- the object session

CONF_SEQ = CONF_BASE + """configurations:
- name: allocate
  arguments:
    solver: seq
"""
# A custom device-mask plugin and a custom batch scorer ([custom]).
CONF_CUSTOM = CONF_BASE.replace("  - name: gang\n", (
    "  - name: gang\n  - name: chip-mask\n  - name: chip-scorer\n"))
CONFIG2 = dict(n_nodes=1000, n_pods=10000, gang_size=4, seed=0)
OBJECT_KERNELS = SOLVE_KERNELS


def _num(name: str) -> int:
    """The last number in a name (its length when it has none)."""
    import re

    digits = re.findall(r"\d+", name)
    return int(digits[-1]) if digits else len(name)


class ChipMask:
    """A device-mask plugin: a task of gang g may not use node n when
    (n + g) % 5 == 0 (a fifth of the nodes vetoed, per gang)."""

    name = "chip-mask"

    def __init__(self, arguments=None):
        pass

    @staticmethod
    def allowed(task_job: str, node_name: str) -> bool:
        return (_num(node_name) + _num(task_job)) % 5 != 0

    def on_session_open(self, ssn):
        import numpy as np

        def mask(cluster, pending, node_names):
            g = np.array([_num(t.job) for t in pending], np.int64)
            n = np.array([_num(nm) for nm in node_names], np.int64)
            return (n[None, :] + g[:, None]) % 5 != 0

        ssn.add_device_mask_fn(self.name, mask)

    def on_session_close(self, ssn):
        pass


class ChipScorer:
    """A custom batch scorer: each task scores three nodes (by its gang
    number); every other node scores nothing."""

    name = "chip-scorer"

    def __init__(self, arguments=None):
        pass

    def on_session_open(self, ssn):
        def batch(task, nodes):
            g = _num(task.job)
            return {nodes[(7 * g + 3 * k) % len(nodes)].name: 5.0 - 2 * k
                    for k in range(3)}

        ssn.add_batch_node_order_fn(self.name, batch)

    def on_session_close(self, ssn):
        pass


def _repend_nodes(store, n_nodes: int) -> int:
    """Return the pods bound to the first ``n_nodes`` nodes to Pending
    through the store (the object session's steady-state workload)."""
    import copy

    names = {store.mirror.node_objs[r].name for r in range(n_nodes)}
    pods = [p for p in store.pods.values() if p.node_name in names]
    for pod in pods:
        p = copy.copy(pod)
        p.node_name = None
        store.update_pod(p)
    return len(pods)


def object_cycles(label, conf, device, cycles=2, check_binds=None):
    """``cycles`` object-session cycles of ``Scheduler(store).run_once()``
    on BASELINE config 2 (``synthetic_cluster(1,000 nodes, 10,000 pods,
    gangs of 4)``, uids reset), the pods of nodes 0-63 re-pended before
    each later cycle.  After every cycle: a flight record with path
    "object" and no error, ``cycle_invariants``, and ``check_binds`` (when
    given) on the store.  Returns (per-cycle (binds, phases, mirror),
    per-cycle stats)."""
    import torch

    from volcano_tpu_torch.scheduler import Scheduler

    t0 = time.perf_counter()
    store = _fresh_cluster(**CONFIG2)
    build_s = time.perf_counter() - t0
    sched = Scheduler(store, conf_str=conf, device=device)
    records, stats = [], []
    for c in range(cycles):
        repended = _repend_nodes(store, 64) if c else 0
        t0 = time.perf_counter()
        sched.run_once()
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = store.flight.last()
        if rec.path != "object" or rec.error is not None:
            raise AssertionError(f"[{label}] cycle {c} ran {rec.path}, "
                                 f"error {rec.error}")
        inv = cycle_invariants(store, CONFIG2["n_pods"])
        if check_binds is not None:
            check_binds(store)
        lanes = {k: round(v * 1e3, 3) for k, v in sorted(rec.lanes.items())}
        stats.append({"cycle": c, "wall_s": wall, "repended": repended,
                      "lanes_ms": lanes, **inv})
        records.append((dict(store.binder.binds),
                        {u: pg.status.phase
                         for u, pg in sorted(store.pod_groups.items())},
                        _mirror_state(store)))
        _log(f"[{label}] {device or 'card'} cycle {c}: {wall:.4f} s (build "
             f"{build_s:.3f} s), re-pended {repended}, lanes(ms) "
             f"{json.dumps(lanes)}")
    audit_checked(f"{label}:{device or 'card'}", store, fast=False)
    store.close()
    return records, stats


def _card_and_cpu(label, conf, kernels_needed, check_binds=None):
    """``object_cycles`` on the card (launch counts zeroed just before and
    read just after, inputs captured) and on the CPU: binds, phases and
    mirror states identical every cycle.  Returns (card stats, launches,
    captured inputs)."""
    from volcano_tpu_torch.ops import kernels

    kernels.CAPTURE = {}
    kernels.reset_launches()
    card, stats = object_cycles(label, conf, None, check_binds=check_binds)
    launches = launch_counts()
    captured, kernels.CAPTURE = kernels.CAPTURE, None
    _log(f"[{label}] launches {json.dumps(launches)}")
    missing = never_launched(launches, kernels_needed)
    if missing:
        raise AssertionError(f"[{label}] kernels never launched: {missing}")
    cpu, _ = object_cycles(label, conf, "cpu")
    _same_records(label, card, cpu, "card vs CPU", fields=3)
    _log(f"[{label}] card equals CPU: {len(card)} cycles, binds, phases "
         f"and mirror states identical")
    return stats, launches, captured


def _allowed_binds(store) -> None:
    """Every pod bound on a node the chip-mask plugin allows its gang."""
    from volcano_tpu_torch.api import GROUP_NAME_ANNOTATION

    for p in store.pods.values():
        if p.node_name and not ChipMask.allowed(
                p.annotations[GROUP_NAME_ANNOTATION], p.node_name):
            raise AssertionError(f"[custom] {p.name} bound to vetoed node "
                                 f"{p.node_name}")


class _SeqTimedLib:
    """The kernel library with CUDA events around each ``vtt_seq_solve``
    call: the device time of a solve's launches (its row pass and step
    loop), timed apart from the profiler trace, which must hold them
    too."""

    def __init__(self, lib):
        self.lib = lib
        self.events = []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name != "vtt_seq_solve":
            return fn

        def timed(*args):
            import torch

            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            rc = fn(*args)
            e1.record()
            self.events.append((e0, e1))
            return rc
        return timed

    def device_ms(self) -> list:
        import torch

        torch.cuda.synchronize()
        return [e0.elapsed_time(e1) for e0, e1 in self.events]


def seq_trace() -> dict:
    """[seq:trace]: a cold seq cycle (``CONF_SEQ``) on a fresh config-2
    store, traced with ``torch.profiler``: the allocate lane beside the
    solve kernels' device time and the card's idle share.  Now and then
    the profiler hands back a trace with no device events, or without the
    solve's kernels, although the CUDA events saw them run: the cycle is
    then traced again on a fresh store, at most SEQ_TRACE_TRIES times,
    and the phase fails after the last.  Every attempt's cycle is held to
    the same checks (object path, no error, the cycle invariants, a
    ``seq_solve`` launch seen by CUDA events), and the busy time and idle
    share come from a trace alone: a trace that lacks a kernel the events
    saw launch is never filled in."""
    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.scheduler import Scheduler

    for attempt in range(1, SEQ_TRACE_TRIES + 1):
        store = _fresh_cluster(**CONFIG2)
        sched = Scheduler(store, conf_str=CONF_SEQ)
        timed = _SeqTimedLib(kernels.load())
        load, kernels.load = kernels.load, lambda: timed
        try:
            prof = profile_device(sched.run_once)
        finally:
            kernels.load = load
        rec = store.flight.last()
        if rec.path != "object" or rec.error is not None:
            raise AssertionError(f"[seq:trace] no traced object cycle: path "
                                 f"{rec.path}, error {rec.error}")
        cycle_invariants(store, CONFIG2["n_pods"])
        audit_checked("seq:trace", store, fast=False)
        store.close()
        solve_ms = timed.device_ms()
        if not solve_ms:
            raise AssertionError("[seq:trace] the cycle launched no "
                                 "seq_solve")
        missed = [f for f in KERNEL_FUNCS["seq_solve"]
                  if f not in prof.get("funcs", {})]
        if not missed:
            break
        _log(f"[seq:trace] attempt {attempt}: the trace holds "
             f"{prof.get('device_events', 0)} device events and no "
             f"{missed}; CUDA events saw {len(solve_ms)} seq_solve calls, "
             f"{sum(solve_ms):.3f} ms; traced "
             f"{json.dumps(prof.get('top', []))}")
    else:
        raise AssertionError(f"[seq:trace] {SEQ_TRACE_TRIES} traces of the "
                             f"cold seq cycle all lack {missed}")
    return {
        "wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
        "idle_share": 1.0 - prof["busy_ms"] / prof["wall_ms"],
        "top": prof["top"],
        "allocate_lane_ms": rec.lanes.get("allocate", 0.0) * 1e3,
        "lanes_ms": {k: round(v * 1e3, 3) for k, v in
                     sorted(rec.lanes.items())},
        "seq_solve_ms": solve_ms, "funcs": prof["funcs"],
        "attempts": attempt,
    }


def seq_trace_child() -> dict:
    """``seq_trace()`` in a process of its own (``python3 chip_smoke.py
    seq-trace``, which reuses the kernel build), waited for at most
    SEQ_TRACE_TIMEOUT_S and killed past it; its log lines are relayed
    here, its errors go to standard error.  Late in a whole run the
    profiler has handed back traces of this cycle without device events
    three times in a row, while a fresh process has traced it whole
    every time it was tried (``tools/port_ab.py --phase seq-trace``,
    alone and after ``--phase pipeline``)."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    try:
        p = subprocess.run(
            [sys.executable, os.path.join(here, "chip_smoke.py"),
             "seq-trace"], cwd=here, stdout=subprocess.PIPE, text=True,
            timeout=SEQ_TRACE_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"[seq:trace] the traced process ran past "
                             f"{SEQ_TRACE_TIMEOUT_S} s") from e
    lines = p.stdout.strip().splitlines()
    ok = p.returncode == 0 and lines
    for line in lines[:-1] if ok else lines:
        _log(f"[seq:trace process] {line}")
    if not ok:
        raise AssertionError(f"[seq:trace] the traced process exited "
                             f"{p.returncode} (its errors are above)")
    return json.loads(lines[-1])


def object_phases(ns_args):
    """Phases 20-23: the object session on BASELINE config 2 (wave solver,
    ``VOLCANO_TPU_FASTPATH=0``), under ``solver: seq``, with custom
    plugins under both solvers, and the sequential solve of the north-star
    args on the card.  Returns (the seq_solve row, the coarse_shortlist
    and rank_candidates rows on custom-plugin inputs)."""
    import os

    import torch

    from volcano_tpu_torch.framework import register_plugin_builder
    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.ops.allocate import solve

    # 20. [object]: the switched-off fast path runs the object session.
    saved = os.environ.get("VOLCANO_TPU_FASTPATH")
    os.environ["VOLCANO_TPU_FASTPATH"] = "0"
    try:
        _card_and_cpu("object", CONF_BASE, OBJECT_KERNELS)
    finally:
        if saved is None:
            os.environ.pop("VOLCANO_TPU_FASTPATH", None)
        else:
            os.environ["VOLCANO_TPU_FASTPATH"] = saved

    # 21. [seq]: the sequential solver; its kernel against the plain
    # version on the inputs of its first launch.
    _s, seq_launches, seq_cap = _card_and_cpu("seq", CONF_SEQ,
                                              ("seq_solve",))
    # The plain version takes ~30 s a call on the card: run once, timed as
    # it is checked.
    seq_row = replay_kernels(seq_cap, seq_launches, reps=1,
                             names=["seq_solve"], turns=(False, False),
                             time_check=True)[0]
    _log(f"[kernels:seq] seq_solve: {seq_row['ms']:.4f} ms/launch, plain "
         f"{seq_row['plain_ms']:.4f} ms, bound {seq_row['bound_ms']:.6f} ms "
         f"({seq_row['bound_by']}), launches {seq_row['launches']}, "
         f"max_abs_err {seq_row['max_abs_err']}")

    # [seq:trace]: a cold seq cycle on a fresh store, traced, in a fresh
    # process (see seq_trace_child).
    trace = seq_trace_child()
    seq_row["trace"] = trace
    _log(f"[seq:trace] cold seq cycle (traced) {trace['wall_ms']:.1f} ms, "
         f"allocate lane {trace['allocate_lane_ms']:.1f} ms, seq_solve's "
         f"launches {sum(trace['seq_solve_ms']):.3f} ms (wrapper calls: "
         f"{len(trace['seq_solve_ms'])}, CUDA events); traced functions: "
         f"{_traced_sums(trace)}; card busy {trace['busy_ms']:.2f} ms, idle "
         f"share {trace['idle_share']:.4f} (attempt {trace['attempts']}, "
         f"in a process of its own); lanes(ms) "
         f"{json.dumps(trace['lanes_ms'])}; top {json.dumps(trace['top'])}")

    # 22. [seq:north-star]: the [main] solve args through the sequential
    # solve on the card (its plain replay is [seq]'s).
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(*ns_args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if kernels.LAUNCHES["seq_solve"] != 1:
        raise AssertionError("[seq:north-star] seq_solve did not launch "
                             "once")
    inv = check_invariants(ns_args, res)
    seq_row["north_star"] = {"wall_s": wall, **inv}
    _log(f"[seq:north-star] 10,000 x 100,000 sequential solve {wall:.4f} "
         f"s, pods bound {inv['pods_bound']}, jobs discarded "
         f"{inv['jobs_discarded']}")

    # 23. [custom]: a device-mask plugin and a batch scorer, under the wave
    # and the sequential solver.
    register_plugin_builder(ChipMask.name, ChipMask)
    register_plugin_builder(ChipScorer.name, ChipScorer)
    _s, cus_launches, cus_cap = _card_and_cpu(
        "custom", CONF_CUSTOM, OBJECT_KERNELS, check_binds=_allowed_binds)
    extra_rows = _replay_rows(cus_cap, cus_launches, "custom", (
        "coarse_shortlist:extra", "rank_candidates:extra"))
    _card_and_cpu("custom:seq", CONF_CUSTOM + CONF_SEQ[len(CONF_BASE):],
                  ("seq_solve",), check_binds=_allowed_binds)
    return seq_row, extra_rows


# ------------------------- warm knobs, crash recovery, fallback, lockdep

CRASH_OOM = "CUDA out of memory (injected)"


def _crash_counter() -> int:
    from volcano_tpu_torch.metrics import metrics

    return int(sum(metrics.device_crash_recoveries.data.values()))


def _crash_events(store) -> list:
    return [e["reason"] for e in store.events_for("Scheduler/device")]


class _Crashing:
    """While active, ``ops.wave.solve_wave`` raises a
    ``torch.cuda.OutOfMemoryError`` at its ``at``-th call (1-based) and
    delegates otherwise; ``FastCycle._solve_chunks`` records the chunk
    count of each allocate round, and ``FastCycle._allocate`` the affinity
    chunk budget's scale after each cycle's allocate."""

    def __init__(self, at: int):
        self.at = at
        self.calls = 0
        self.chunks: list = []
        self.scales: list = []

    def __enter__(self):
        import torch

        from volcano_tpu_torch.fastpath import FastCycle
        from volcano_tpu_torch.ops import wave as wave_mod

        self.saved = (wave_mod.solve_wave, FastCycle._solve_chunks,
                      FastCycle._allocate)
        real, real_chunks, real_alloc = self.saved

        def solve(*a, **kw):
            self.calls += 1
            if self.calls == self.at:
                raise torch.cuda.OutOfMemoryError(CRASH_OOM)
            return real(*a, **kw)

        def chunks(cyc, *a, **kw):
            out = list(real_chunks(cyc, *a, **kw))
            self.chunks.append(len(out))
            return iter(out)

        def allocate(cyc):
            try:
                real_alloc(cyc)
            finally:
                self.scales.append(cyc.store._aff_budget_scale)

        wave_mod.solve_wave = solve
        FastCycle._solve_chunks = chunks
        FastCycle._allocate = allocate
        return self

    def __exit__(self, *exc):
        from volcano_tpu_torch.fastpath import FastCycle
        from volcano_tpu_torch.ops import wave as wave_mod

        (wave_mod.solve_wave, FastCycle._solve_chunks,
         FastCycle._allocate) = self.saved
        return False


def _grow_cpu(store, n_update: int) -> None:
    """``update_node`` on ``n_update`` nodes spread over the node table,
    each with half as much CPU again (never less, so no bound pod is
    stranded): a node-table delta.  Reads the mirror under the store's
    lock (lockdep's children hold to that)."""
    import dataclasses

    with store._lock:
        m = store.mirror
        step = max(1, m.n_nodes // n_update)
        olds = [m.node_objs[r] for r in range(0, step * n_update, step)]
    for old in olds:
        cpu = str(int(float(old.allocatable["cpu"]) * 1.5))
        store.update_node(dataclasses.replace(
            old, allocatable={**old.allocatable, "cpu": cpu},
            capacity={**old.capacity, "cpu": cpu}))


def warm_knobs_phase(size=(1000, 10000), blocks="4", rows="256",
                     steady=5) -> dict:
    """[warm-knobs]: phase 7's sequence (a cold cycle, ``steady`` cycles
    re-pending the pods of nodes 0-63, an ``update_node`` of 1% of the
    nodes and a cycle) with ``VOLCANO_TPU_WARM_BLOCKS`` /
    ``VOLCANO_TPU_WARM_BLOCK_ROWS`` set, on the card and on the CPU: the
    binds, the solve's warm-block geometry
    (``LAST_TWOPHASE["devincr"]["blocks"]``) every cycle and the warm /
    full / skip counts identical; one cycle warm; the geometry the knobs'
    (``devincr.block_geometry``)."""
    import torch

    from volcano_tpu_torch.framework import DEPLOYED_SCHEDULER_CONF
    from volcano_tpu_torch.ops import devincr
    from volcano_tpu_torch.ops import wave as wave_mod
    from volcano_tpu_torch.scheduler import Scheduler

    def run(device):
        label = f"warm-knobs:{device or 'card'}"
        store = _fresh_cluster(n_nodes=size[0], n_pods=size[1], gang_size=8,
                               zones=16, seed=0)
        sched = Scheduler(store, conf_str=DEPLOYED_SCHEDULER_CONF,
                          device=device)
        recs = []

        def cycle(kind):
            wave_mod.LAST_TWOPHASE.clear()
            t0 = time.perf_counter()
            sched.run_once()
            if device is None:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            dv = wave_mod.LAST_TWOPHASE.get("devincr") or {}
            recs.append({"kind": kind, "wall_s": wall,
                         "mode": dv.get("mode"),
                         "blocks": list(dv.get("blocks") or ()),
                         "host_reads": wave_mod.LAST_TWOPHASE.get(
                             "host_reads"),
                         "binds": dict(store.binder.binds)})

        cycle("cold")
        cycle_invariants(store, size[1])
        store.cycle_feed = repend_feed(list(range(64)))
        for _ in range(steady):
            cycle("steady")
        _grow_cpu(store, max(1, size[0] // 100))
        cycle("update_node")
        counts = dict(store._devincr_cache.counts)
        audit_checked(label, store)
        store.close()
        return recs, counts

    t0 = time.perf_counter()
    with _Env(VOLCANO_TPU_WARM_BLOCKS=blocks,
              VOLCANO_TPU_WARM_BLOCK_ROWS=rows):
        card, card_counts = run(None)
        cpu, cpu_counts = run("cpu")
        want_b = devincr.block_geometry(size[0], 1)[0]
    if card_counts != cpu_counts:
        raise AssertionError(f"[warm-knobs] counts card {card_counts} != "
                             f"CPU {cpu_counts}")
    for i, (a, b) in enumerate(zip(card, cpu)):
        for k in ("mode", "blocks", "binds"):
            if a[k] != b[k]:
                raise AssertionError(f"[warm-knobs] cycle {i} {k}: card "
                                     f"{a[k] if k != 'binds' else '...'} != "
                                     f"CPU")
        if a["host_reads"] not in (0, None):
            raise AssertionError(f"[warm-knobs] cycle {i} read planes back")
    modes = [r["mode"] for r in card]
    if "warm" not in modes or card_counts["warm"] < 1:
        raise AssertionError(f"[warm-knobs] no warm cycle: {modes}")
    totals = {r["blocks"][1] for r in card if r["blocks"]}
    if totals != {want_b}:
        raise AssertionError(f"[warm-knobs] block counts {totals}, the "
                             f"knobs give {want_b}")
    stats = {"knobs": [blocks, rows], "blocks_total": want_b,
             "modes": modes, "blocks": [r["blocks"] for r in card],
             "counts": card_counts,
             "walls_s": [r["wall_s"] for r in card],
             "cpu_walls_s": [r["wall_s"] for r in cpu],
             "phase_s": time.perf_counter() - t0}
    _log(f"[warm-knobs] {size[0]}x{size[1]} with VOLCANO_TPU_WARM_BLOCKS="
         f"{blocks} VOLCANO_TPU_WARM_BLOCK_ROWS={rows}: card == CPU over "
         f"{len(card)} cycles; {json.dumps(stats)}")
    return stats


def aff_crash_phase(mid=(1000, 10000), budget_mb="2", recover=8) -> dict:
    """[affinity:crash]: phase 18's store (config 5 at ``mid``,
    ``VOLCANO_TPU_AFF_BUDGET_MB=budget_mb``) with a
    ``torch.cuda.OutOfMemoryError`` raised at the cold cycle's second
    chunk's ``solve_wave`` call: the cycle completes, the budget's scale
    halves (one ``DeviceCrashRecovered`` event, one increment of
    ``volcano_device_crash_recoveries_total``), the work left re-solves in
    more chunks than the first round had, the binds equal the CPU run
    given the same injection, the phase-16 invariants hold; then
    ``recover`` clean affinity cycles (the pods of nodes 0-63 re-pended)
    bring the scale back to 1.0."""
    def run(device, steady):
        label = f"affinity:crash:{device or 'card'}"
        store = config5_cluster(*mid)
        before = _crash_counter()
        with _Env(VOLCANO_TPU_AFF_BUDGET_MB=budget_mb), _Crashing(2) as c:
            stats, recs = run_aff_cycles(label, store, steady=steady,
                                         device=device)
        out = {"chunks": list(c.chunks), "scales": list(c.scales),
               "events": _crash_events(store),
               "recoveries": _crash_counter() - before,
               "walls_s": [x["wall_s"] for x in stats["cycles"]],
               "cold_solves": len(stats["cycles"][0]["solves"]),
               "bound": len(store.binder.binds)}
        store.close()
        return out, recs

    t0 = time.perf_counter()
    card, card_recs = run(None, recover)
    cpu, cpu_recs = run("cpu", 0)
    _same_records("affinity:crash", card_recs[:1], cpu_recs, "card vs CPU")
    ch = card["chunks"]
    if card["scales"][0] != 0.5 or card["events"] != [
            "DeviceCrashRecovered"] or card["recoveries"] != 1:
        raise AssertionError(f"[affinity:crash] not degraded once: {card}")
    if len(ch) < 2 or ch[0] < 4 or ch[1] <= ch[0] - 1:
        raise AssertionError(f"[affinity:crash] chunks per round {ch}")
    if card["scales"][-1] != 1.0:
        raise AssertionError(f"[affinity:crash] the scale did not recover "
                             f"in {recover} clean cycles: {card['scales']}")
    if cpu["chunks"][:2] != ch[:2] or cpu["scales"] != card["scales"][:1]:
        raise AssertionError(f"[affinity:crash] CPU {cpu} != card {card}")
    card["phase_s"] = time.perf_counter() - t0
    _log(f"[affinity:crash] {mid[0]}x{mid[1]}, budget {budget_mb} MB: "
         f"chunks before the crash {ch[0]}, after it {ch[1]} (the first "
         f"chunk committed); card == CPU; {json.dumps(card)}")
    return card


def fallback_north_star(store) -> dict:
    """[fallback] at the north star: with ``VOLCANO_TPU_FALLBACK=auto``
    and ``FastCycle._allocate`` raising once, pending tasks x nodes (1e9)
    exceed ``FALLBACK_MAX_WORK``: the cycle raises, nothing binds."""
    import os

    from volcano_tpu_torch.fastpath import FastCycle
    from volcano_tpu_torch.scheduler import Scheduler

    sched = Scheduler(store, conf_str=CONF_BASE)
    m = store.mirror
    work = int((m.p_status[:m.n_pods] == 1).sum()) * m.n_nodes
    real = FastCycle._allocate

    def fail(cyc):
        FastCycle._allocate = real
        raise RuntimeError("fast path failed (injected)")

    raised = None
    with _Env(VOLCANO_TPU_FALLBACK="auto"):
        FastCycle._allocate = fail
        try:
            sched.run_once()
        except RuntimeError as e:
            raised = str(e)
        finally:
            FastCycle._allocate = real
    if os.environ.get("VOLCANO_TPU_FALLBACK") != "never":
        raise AssertionError("[fallback] VOLCANO_TPU_FALLBACK not restored")
    if raised != "fast path failed (injected)" or store.binder.binds:
        raise AssertionError(f"[fallback] the north star fell back: "
                             f"raised {raised}, {len(store.binder.binds)} "
                             f"binds")
    if work <= Scheduler.FALLBACK_MAX_WORK:
        raise AssertionError(f"[fallback] {work} work is within the bound")
    stats = {"pending_x_nodes": work,
             "bound": Scheduler.FALLBACK_MAX_WORK, "raised": raised}
    _log(f"[fallback:north-star] {json.dumps(stats)}")
    return stats


def aff_crash_ns_phase(big=(10000, 100000)) -> dict:
    """[affinity:crash:ns]: a config-5 store at ``big`` with the default
    budget (first, on the same store, the north-star half of
    [fallback]); one ``torch.cuda.OutOfMemoryError`` at the cold cycle's
    first ``solve_wave`` call: every pod bound, the phase-16 invariants,
    ``host_reads`` 0; chunks before and after the crash printed."""
    t0 = time.perf_counter()
    store = config5_cluster(*big)
    build_s = time.perf_counter() - t0
    fb = fallback_north_star(store)
    before = _crash_counter()
    with _Crashing(1) as c:
        stats, _recs = run_aff_cycles("affinity:crash:ns", store, steady=0,
                                      all_bound=True)
    out = {"build_s": build_s, "chunks": list(c.chunks),
           "scales": list(c.scales), "events": _crash_events(store),
           "recoveries": _crash_counter() - before,
           "cold_wall_s": stats["cycles"][0]["wall_s"],
           "lanes_ms": stats["cycles"][0]["lanes_ms"],
           "fallback": fb}
    store.close()
    if out["scales"] != [0.5] or out["recoveries"] != 1 or len(
            out["chunks"]) != 2:
        raise AssertionError(f"[affinity:crash:ns] {out}")
    out["phase_s"] = time.perf_counter() - t0
    _log(f"[affinity:crash:ns] {big[0]}x{big[1]}: chunks before the crash "
         f"{out['chunks'][0]}, after it {out['chunks'][1]}; every pod "
         f"bound; {json.dumps(out)}")
    return out


def pipeline_crash_phase(size=(1000, 10000)) -> dict:
    """[pipeline:crash]: the pipelined 1,000 x 10,000 store (``async_bind``
    on); the solve worker's first solve raises a
    ``torch.cuda.OutOfMemoryError``, which surfaces at cycle 2's fetch:
    the rows drop as ``device-crash`` (journey rows ``dropped`` /
    ``device-crash``), the scale halves, the rows re-dispatch; after a
    drain every pod bound; card against the CPU given the same
    injection: binds, drops, ids and mirror states identical."""
    def run(device):
        label = f"pipeline:crash:{device or 'card'}"
        store = _fresh_cluster(n_nodes=size[0], n_pods=size[1], gang_size=8,
                               zones=16, seed=1)
        before = _crash_counter()
        script = [("cold:dispatch", None, False),
                  ("fetch-crash", None, False), ("commit", None, False),
                  ("drain", None, False)]
        with _Crashing(1):
            recs, _solves, _p, _s = pipelined_run(label, store, device,
                                                  size[1], script,
                                                  log_cycles=device is None)
        pipeline_invariants(store, size[1], final=True)
        dropped = [r.get("detail") for r in store.journey.trace_rows()
                   if r["kind"] == "dropped"]
        out = {"drops": [r[0]["drops"] for r in recs],
               "ids": [(r[0]["dispatched"], r[0]["committed"])
                       for r in recs],
               "walls_s": [r[0]["wall_s"] for r in recs],
               "scale": store._aff_budget_scale,
               "events": _crash_events(store),
               "recoveries": _crash_counter() - before,
               "journey_dropped": {d: dropped.count(d)
                                   for d in set(dropped)}}
        store.close()
        return out, recs

    t0 = time.perf_counter()
    card, card_recs = run(None)
    cpu, cpu_recs = run("cpu")
    for i, (a, b) in enumerate(zip(card_recs, cpu_recs)):
        if a[1] != b[1] or a[2] != b[2]:
            raise AssertionError(f"[pipeline:crash] cycle {i}: binds or "
                                 f"mirror differ card vs CPU")
    for k in ("drops", "ids", "scale", "events", "recoveries",
              "journey_dropped"):
        if card[k] != cpu[k]:
            raise AssertionError(f"[pipeline:crash] {k}: card {card[k]} != "
                                 f"CPU {cpu[k]}")
    n = card["drops"][1].get("device-crash", 0)
    if (n < 1 or card["drops"][1] != {"device-crash": n}
            or card["journey_dropped"] != {"device-crash": n}
            or card["scale"] != 0.5 or card["recoveries"] != 1):
        raise AssertionError(f"[pipeline:crash] {card}")
    card["phase_s"] = time.perf_counter() - t0
    _log(f"[pipeline:crash] {size[0]}x{size[1]}: the worker's OOM dropped "
         f"{n} rows as device-crash at the fetch; card == CPU; "
         f"{json.dumps(card)}")
    return card


def fallback_phase() -> dict:
    """[fallback] at BASELINE config 2: for this phase only
    ``VOLCANO_TPU_FALLBACK=auto``, ``FastCycle._allocate`` raising a
    non-crash ``RuntimeError`` once: the object session binds every pod,
    its flight record has path "object", the binds equal the CPU run given
    the same injection; ``never`` restored afterwards."""
    import os

    import torch

    from volcano_tpu_torch.fastpath import FastCycle
    from volcano_tpu_torch.scheduler import Scheduler

    def run(device):
        store = _fresh_cluster(**CONFIG2)
        sched = Scheduler(store, conf_str=CONF_BASE, device=device)
        real = FastCycle._allocate
        calls = [0]

        def fail(cyc):
            calls[0] += 1
            if calls[0] == 1:
                raise RuntimeError("fast path failed (injected)")
            return real(cyc)

        with _Env(VOLCANO_TPU_FALLBACK="auto"):
            FastCycle._allocate = fail
            try:
                t0 = time.perf_counter()
                sched.run_once()
                if device is None:
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                FastCycle._allocate = real
        rec = store.flight.last()
        if rec.path != "object" or rec.error is not None or calls[0] != 1:
            raise AssertionError(f"[fallback] path {rec.path}, error "
                                 f"{rec.error}, {calls[0]} allocate calls")
        inv = cycle_invariants(store, CONFIG2["n_pods"])
        audit_checked(f"fallback:{device or 'card'}", store, fast=False)
        out = (dict(store.binder.binds),
               {u: pg.status.phase
                for u, pg in sorted(store.pod_groups.items())},
               _mirror_state(store))
        lanes = {k: round(v * 1e3, 3) for k, v in sorted(rec.lanes.items())}
        store.close()
        return out, {"wall_s": wall, "lanes_ms": lanes, **inv}

    t0 = time.perf_counter()
    card, stats = run(None)
    cpu, cpu_stats = run("cpu")
    _same_records("fallback", [card], [cpu], "card vs CPU", fields=3)
    if os.environ.get("VOLCANO_TPU_FALLBACK") != "never":
        raise AssertionError("[fallback] VOLCANO_TPU_FALLBACK not restored")
    stats["cpu_wall_s"] = cpu_stats["wall_s"]
    stats["phase_s"] = time.perf_counter() - t0
    _log(f"[fallback] config 2 ({CONFIG2['n_nodes']}x{CONFIG2['n_pods']}): "
         f"the failed fast cycle fell back to the object session, every "
         f"pod bound, card == CPU, VOLCANO_TPU_FALLBACK=never restored; "
         f"{json.dumps(stats)}")
    return stats


def _child(args, label, timeout, env=None):
    """``python3 chip_smoke.py <args>`` in a process of its own (it reuses
    the kernel build), its output relayed line by line; killed past
    ``timeout``.  Returns (exit code, output lines)."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    full_env = dict(os.environ, **(env or {}))
    try:
        p = subprocess.run(
            [sys.executable, os.path.join(here, "chip_smoke.py"), *args],
            cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, timeout=timeout, env=full_env)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"[{label}] the child ran past {timeout} "
                             f"s") from e
    lines = p.stdout.strip().splitlines()
    for line in lines:
        _log(f"[{label} process] {line}")
    return p.returncode, lines


def _binds_hash(binds: dict) -> str:
    import hashlib

    return hashlib.sha256(
        json.dumps(sorted(binds.items())).encode()).hexdigest()


STICKY_MARK = "[crash:sticky] the cycle raised"


def crash_sticky_child() -> None:
    """``python3 chip_smoke.py crash-sticky``: a real device-side assert
    inside the solve (an out-of-range index gathered on the card, then a
    synchronize): the classifier counts it as a crash, the probe fails
    (the context is poisoned), and ``run_once`` raises the original error
    under ``VOLCANO_TPU_FALLBACK=never``.  Prints ``STICKY_MARK`` and the
    evidence, then exits 3."""
    import os

    import torch

    from volcano_tpu_torch.fastpath import FastCycle
    from volcano_tpu_torch.ops import wave as wave_mod
    from volcano_tpu_torch.scheduler import Scheduler

    store = _fresh_cluster(n_nodes=64, n_pods=512, gang_size=4, seed=3)
    sched = Scheduler(store)
    seen = {"error": None, "classified": None, "probe": None}
    real_probe = FastCycle._probe_device

    def solve(*a, **kw):
        x = torch.zeros(4, device="cuda")
        _ = x[torch.tensor([1 << 20], device="cuda")]
        try:
            torch.cuda.synchronize()
        except Exception as e:
            seen["error"] = e
            seen["classified"] = FastCycle._is_device_crash(e)
            raise
        raise AssertionError("the out-of-range gather did not fault")

    def probe(cyc):
        try:
            real_probe(cyc)
        except Exception as e:
            seen["probe"] = f"{type(e).__name__}: {str(e)[:80]}"
            raise
        seen["probe"] = "passed"

    wave_mod.solve_wave = solve
    FastCycle._probe_device = probe
    try:
        sched.run_once()
    except Exception as e:
        ev = {"classified": seen["classified"], "probe": seen["probe"],
              "original_error_raised": e is seen["error"]}
        _log(f"{STICKY_MARK} {type(e).__name__}: "
             f"{str(e).splitlines()[0]}; {json.dumps(ev)}")
        sys.stdout.flush()
        os._exit(3)
    _log("[crash:sticky] run_once returned")
    os._exit(4)


def crash_sticky_phase() -> dict:
    """[crash:sticky]: the parent requires the child's non-zero exit and
    the expected message: the crash classified, the probe failed, the
    original device error raised."""
    t0 = time.perf_counter()
    rc, lines = _child(["crash-sticky"], "crash:sticky", 300)
    hit = [x for x in lines if x.startswith(STICKY_MARK)]
    if rc == 0 or not hit:
        raise AssertionError(f"[crash:sticky] the child exited {rc} without "
                             f"the expected message")
    ev = json.loads(hit[0][hit[0].index("; {") + 2:])
    if (ev != {"classified": True, "probe": ev["probe"],
               "original_error_raised": True}
            or ev["probe"] in (None, "passed")
            or "device-side assert" not in hit[0]):
        raise AssertionError(f"[crash:sticky] {hit[0]}")
    out = {"rc": rc, "evidence": ev, "phase_s": time.perf_counter() - t0}
    _log(f"[crash:sticky] the child failed with the original device error: "
         f"{json.dumps(out)}")
    return out


def lockdep_child(cold_hash: str, big=(10000, 100000),
                  preempt=(2000, 1000), max_cycles=24) -> dict:
    """``python3 chip_smoke.py lockdep <hash>`` with
    ``VOLCANO_TPU_LOCKDEP=1`` (without it, the same run unarmed: the walls
    to compare with): the pipelined north-star sequence with
    asynchronous binds (a cold dispatch and its commit -- binds hashed
    against ``cold_hash``, phase 6's cold binds -- 3 steady cycles
    re-pending nodes 0-63 with an ``update_node`` of 100 nodes during the
    second one's overlap, a drain), then a pipelined preempt at phase
    8b's size; every check reads the store under its lock.  Armed: no
    ``lockdep-violation`` and no ``lock-order-cycle``; ``stats()`` active
    with order edges.  Returns the walls."""
    import os

    import torch

    from volcano_tpu_torch.cache import ClusterStore, FakeBinder, FakeEvictor
    from volcano_tpu_torch.framework import DEPLOYED_SCHEDULER_CONF
    from volcano_tpu_torch.obs import lockdep
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.sim import ClusterSimulator

    armed = lockdep.lockdep_on()
    t0 = time.perf_counter()
    store = _fresh_cluster(n_nodes=big[0], n_pods=big[1], gang_size=8,
                           zones=16, seed=0)
    build_s = time.perf_counter() - t0
    if isinstance(store._lock, lockdep._LockProxy) != armed:
        raise AssertionError(f"[lockdep] the store is armed: "
                             f"{not armed}, the switch {armed}")
    store.pipeline = True
    store.async_bind = True
    sched = Scheduler(store, conf_str=DEPLOYED_SCHEDULER_CONF)
    feed = repend_feed(list(range(64)))

    def update(store):
        _grow_cpu(store, 100)

    def set_feed(store):
        store.cycle_feed = feed

    def drain(store):
        store.cycle_feed = None

    script = [("cold:dispatch", None), ("cold:commit", None),
              ("steady", set_feed), ("steady", None),
              ("update+steady", update), ("drain", drain),
              ("drain", None)]
    walls = []
    cold = None
    for kind, before in script:
        if before is not None:
            before(store)
        t0 = time.perf_counter()
        sched.run_once()
        torch.cuda.current_stream().synchronize()
        walls.append([kind, time.perf_counter() - t0])
        if not store.flush_binds(120):
            raise AssertionError(f"[lockdep] {kind}: binds not flushed")
        with store._lock:
            pipeline_invariants(store, big[1])
            if kind == "cold:commit":
                cold = _binds_hash(store.binder.binds)
        _log(f"[lockdep] {kind} cycle {walls[-1][1]:.4f} s")
    if cold != cold_hash:
        raise AssertionError("[lockdep] the cold binds differ from phase "
                             "6's cold binds")
    with store._lock:
        if store._inflight_solve is not None:
            raise AssertionError("[lockdep] a solve still in flight")
        pipeline_invariants(store, big[1], final=True)
        audit_checked("lockdep", store)
    stores = [store]

    saved = {k: os.environ.get(k) for k in ("VOLCANO_TPU_EVICT_DEVICE",
                                            "VOLCANO_TPU_EVICT_CAP")}
    pre = ClusterStore(binder=FakeBinder(), evictor=FakeEvictor())
    stores.append(pre)
    ClusterSimulator.priority_tier_workload(pre, workers=preempt[0],
                                            serving_tasks=preempt[1])
    pre.pipeline = True
    pre.async_bind = True
    pwalls = []
    with _Env(VOLCANO_TPU_EVICT_DEVICE="1",
              VOLCANO_TPU_EVICT_CAP=str(preempt[0])):
        psched = Scheduler(pre, conf_str=CONF_PREEMPT_ONLY)
        sim = ClusterSimulator(pre, grace_steps=2)
        for _ in range(max_cycles):
            t0 = time.perf_counter()
            psched.run_once()
            torch.cuda.current_stream().synchronize()
            pwalls.append(time.perf_counter() - t0)
            pre.flush_binds(120)
            sim.step()
            with pre._lock:
                done = sum(1 for p in pre.pods.values()
                           if p.name.startswith("serving-")
                           and p.node_name) >= preempt[1]
            if done:
                break
    if not done or not pre.evictor.evicts:
        raise AssertionError("[lockdep] the pipelined preempt did not bind "
                             "the serving gang")
    with pre._lock:
        audit_checked("lockdep:preempt", pre)
    bad = [a.to_dict() for s in stores for a in s.auditor.anomalies()
           if a.reason in ("lockdep-violation", "lock-order-cycle")]
    st = lockdep.stats()
    for s in stores:
        s.close()
    if bad:
        raise AssertionError(f"[lockdep] {json.dumps(bad[:4], default=str)}")
    if armed and (not st["active"] or st["order_edges"] < 1
                  or st["violations"] or st["order_cycles"]):
        raise AssertionError(f"[lockdep] stats {st}")
    return {"armed": armed, "stats": st, "build_s": build_s,
            "walls_s": walls,
            "preempt_walls_s": pwalls,
            "evictions": len(pre.evictor.evicts)}


LOCKDEP_MARK = "[lockdep] result "


def lockdep_phase(cold_hash: str) -> dict:
    """[lockdep] in a child process (the descriptors stay on the port's
    classes for the life of a process).  The unarmed run beside it (the
    cost of enforcement) is not repeated."""
    t0 = time.perf_counter()
    rc, lines = _child(["lockdep", cold_hash], "lockdep:on", 900,
                       env={"VOLCANO_TPU_LOCKDEP": "1"})
    hit = [x for x in lines if x.startswith(LOCKDEP_MARK)]
    if rc != 0 or not hit:
        raise AssertionError(f"[lockdep] the armed child exited {rc}")
    on = json.loads(hit[-1][len(LOCKDEP_MARK):])
    if not on["armed"]:
        raise AssertionError("[lockdep] the child's switch")
    out = {"stats": on["stats"], "evictions": on["evictions"],
           "walls_s": on["walls_s"],
           "preempt_walls_s": on["preempt_walls_s"],
           "build_s": on["build_s"],
           "phase_s": time.perf_counter() - t0}
    _log(f"[lockdep] no lockdep-violation, no lock-order-cycle; per cycle "
         f"(kind, wall with lockdep) {json.dumps(out['walls_s'])};"
         f" pipelined preempt walls {json.dumps(out['preempt_walls_s'])}; "
         + json.dumps(
             {k: out[k] for k in ("stats", "build_s", "evictions",
                                  "phase_s")}))
    return out


TRACE_MARK = "[trace-dir] result "
TRACE_TRIES = 3


def trace_dir_child(size=(1000, 10000)) -> dict:
    """``python3 chip_smoke.py trace-dir``: one cycle on a fresh store with
    ``VOLCANO_TPU_TRACE_DIR`` set writes one Chrome-trace JSON that parses
    and holds the device events of the port's kernels (an empty trace is
    taken again on a fresh store, at most TRACE_TRIES times); then, with an
    outer ``torch.profiler`` open, a cycle binds every pod, writes no file
    and logs a warning."""
    import glob
    import logging
    import os
    import tempfile

    import torch

    from volcano_tpu_torch.framework import DEPLOYED_SCHEDULER_CONF
    from volcano_tpu_torch.scheduler import Scheduler

    funcs = [f for fs in KERNEL_FUNCS.values() for f in fs]
    d = tempfile.mkdtemp(prefix="vtt-trace-")
    out = {"tries": 0}
    with _Env(VOLCANO_TPU_TRACE_DIR=d):
        for attempt in range(1, TRACE_TRIES + 1):
            store = _fresh_cluster(n_nodes=size[0], n_pods=size[1],
                                   gang_size=8, zones=16, seed=0)
            before = set(glob.glob(os.path.join(d, "*.json")))
            t0 = time.perf_counter()
            Scheduler(store, conf_str=DEPLOYED_SCHEDULER_CONF).run_once()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            cycle_invariants(store, size[1])
            store.close()
            new = sorted(set(glob.glob(os.path.join(d, "*.json"))) - before)
            if len(new) != 1:
                raise AssertionError(f"[trace-dir] {len(new)} trace files")
            with open(new[0]) as f:
                events = json.load(f)["traceEvents"]
            kern = {}
            for e in events:
                if e.get("cat") != "kernel":
                    continue
                name = e.get("name", "")
                for fn in funcs:
                    if fn in name:
                        kern[fn] = kern.get(fn, 0) + 1
            out = {"tries": attempt, "file": os.path.basename(new[0]),
                   "bytes": os.path.getsize(new[0]), "events": len(events),
                   "kernel_events": kern, "traced_cycle_s": wall}
            if "walk_accept_kernel" in kern:
                break
            _log(f"[trace-dir] attempt {attempt}: no kernel events "
                 f"({len(events)} events)")
        else:
            raise AssertionError(f"[trace-dir] {TRACE_TRIES} traces without "
                                 f"the port's kernels")

        # An outer profiler already open: the cycle still binds, no file.
        class Warnings(logging.Handler):
            def __init__(self):
                super().__init__(logging.WARNING)
                self.msgs = []

            def emit(self, record):
                self.msgs.append(record.getMessage())

        h = Warnings()
        log = logging.getLogger("volcano_tpu_torch.scheduler")
        log.addHandler(h)
        store = _fresh_cluster(n_nodes=size[0], n_pods=size[1], gang_size=8,
                               zones=16, seed=0)
        before = set(glob.glob(os.path.join(d, "*.json")))
        try:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]):
                Scheduler(store, conf_str=DEPLOYED_SCHEDULER_CONF).run_once()
                torch.cuda.synchronize()
        finally:
            log.removeHandler(h)
        cycle_invariants(store, size[1])
        store.close()
        if set(glob.glob(os.path.join(d, "*.json"))) != before:
            raise AssertionError("[trace-dir] a nested trace was written")
        if not any("device trace" in m for m in h.msgs):
            raise AssertionError(f"[trace-dir] no warning: {h.msgs}")
        out["nested_warning"] = [m for m in h.msgs if "device trace" in m][0]
    return out


def trace_dir_phase() -> dict:
    t0 = time.perf_counter()
    rc, lines = _child(["trace-dir"], "trace-dir", 600)
    hit = [x for x in lines if x.startswith(TRACE_MARK)]
    if rc != 0 or not hit:
        raise AssertionError(f"[trace-dir] the child exited {rc}")
    out = json.loads(hit[-1][len(TRACE_MARK):])
    out["phase_s"] = time.perf_counter() - t0
    _log(f"[trace-dir] one Chrome trace a cycle with the port's kernels; "
         f"under an outer profiler the cycle bound every pod and warned; "
         f"{json.dumps(out)}")
    return out


def recovery_phases(cold_hash: str) -> dict:
    """Phases 24-31 in order; each one's seconds printed on the
    ``[recovery] seconds`` line."""
    out = {"warm-knobs": warm_knobs_phase(),
           "affinity:crash": aff_crash_phase(),
           "affinity:crash:ns": aff_crash_ns_phase(),
           "pipeline:crash": pipeline_crash_phase(),
           "fallback": fallback_phase(),
           "crash:sticky": crash_sticky_phase(),
           "lockdep": lockdep_phase(cold_hash),
           "trace-dir": trace_dir_phase()}
    _log(f"[recovery] seconds "
         f"{json.dumps({k: v['phase_s'] for k, v in out.items()})}")
    return out


# ------------------------- the single-phase solve and live steering


def _env(name, value):
    """Sets environment variable ``name`` (None: unsets it); returns a
    function that restores it."""
    import os

    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value

    def restore():
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old
    return restore


def host_flag_args(args):
    """The solve args with the flags a solve would read off the card taken
    on the host beforehand, as the fast path hands them over: the
    releasing / pipelined planes as host arrays and ``taint_any``.
    Returns (args, taint_any)."""
    from volcano_tpu_torch.device import to_numpy

    nodes = args[0]
    taint_any = bool(to_numpy(nodes.taint_bits).any())
    nodes = nodes._replace(releasing=to_numpy(nodes.releasing),
                           pipelined=to_numpy(nodes.pipelined))
    return (nodes,) + tuple(args[1:]), taint_any


def timed_solves(args, reps=3, **kw) -> tuple:
    """``reps`` solves of ``args`` on the card: (walls, the last result,
    its ``LAST_TWOPHASE`` record)."""
    import torch

    from volcano_tpu_torch.ops import wave as wave_mod

    walls, res = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        again = wave_mod.solve_wave(*args, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if res is not None:
            same_result(res, again, "repeat solve")
        res = again
    return walls, res, dict(wave_mod.LAST_TWOPHASE)


def single_phase_solves(label, stats) -> None:
    """Every solve of ``run_aff_cycles``' cycles single-phase: no node
    classes, no device-incremental state."""
    for c in stats["cycles"]:
        for x in c["solves"]:
            if x["enabled"] or x["compacted_classes"] or x["devincr"]:
                raise AssertionError(f"[{label}] a solve ran two-phase, on "
                                     f"classes or with devincr: {x}")


def contended_store(seed=0):
    """The contended inter-pod mix of the steering twins
    (``tests/test_torch_fixtures.affinity_store(n_nodes=64, n_gangs=48,
    gang_size=8, zones=4, node_cpu="8", mix=("aff", "anti", "res_aff",
    "res_anti"))``): 64 nodes of 8 CPUs in 4 zones (every seventh without
    a zone label), two resident pods of each of three apps (host port 9000
    on every other one), 48 gangs of 8 cycling through required zone
    affinity and hostname anti-affinity to their own app and to a resident
    app, every third gang asking for host port 8080 (every sixth also
    9000)."""
    import itertools

    import numpy as np

    import volcano_tpu_torch.api.spec as spec
    from volcano_tpu_torch.api import (GROUP_NAME_ANNOTATION, AffinityTerm,
                                       Node, Pod, PodGroup)
    from volcano_tpu_torch.cache import ClusterStore

    spec._uid_counter = itertools.count(1)
    spec._ts_counter = itertools.count(1)
    rng = np.random.default_rng(seed)
    store = ClusterStore()
    n_nodes = 64
    for i in range(n_nodes):
        labels = {} if i % 7 == 6 else {"zone": f"z{i % 4}"}
        store.add_node(Node(name=f"n{i:03d}", labels=labels,
                            allocatable={"cpu": "8", "memory": "64Gi",
                                         "pods": 110}))
    for k in range(3):
        store.add_pod_group(PodGroup(name=f"res-{k}", min_member=1,
                                     queue="default"))
        for r in range(2):
            store.add_pod(Pod(
                name=f"res-{k}-{r}", labels={"app": f"res-{k}"},
                annotations={GROUP_NAME_ANNOTATION: f"res-{k}"},
                containers=[{"cpu": "1", "memory": "1Gi"}],
                node_name=f"n{(5 * k + 3 * r) % n_nodes:03d}",
                phase="Running", host_ports=[9000] if r % 2 == 0 else []))
    mix = ("aff", "anti", "res_aff", "res_anti")
    for g in range(48):
        name = f"g{g:03d}"
        kind = mix[g % len(mix)]
        res = f"res-{g % 3}"
        extra = {}
        if kind == "aff":
            extra["affinity"] = [AffinityTerm(match_labels={"app": name},
                                              topology_key="zone")]
        elif kind == "anti":
            extra["anti_affinity"] = [AffinityTerm(
                match_labels={"app": name}, topology_key=HOSTNAME)]
        elif kind == "res_aff":
            extra["affinity"] = [AffinityTerm(match_labels={"app": res},
                                              topology_key="zone")]
        else:
            extra["anti_affinity"] = [AffinityTerm(
                match_labels={"app": res}, topology_key=HOSTNAME)]
        if g % 3 == 0:
            extra["host_ports"] = [8080] + ([9000] if g % 6 == 0 else [])
        store.add_pod_group(PodGroup(name=name, min_member=8,
                                     queue="default"))
        cpu = str(rng.choice(["1", "2"]))
        for k in range(8):
            store.add_pod(Pod(
                name=f"{name}-{k}", labels={"app": name},
                annotations={GROUP_NAME_ANNOTATION: name},
                containers=[{"cpu": cpu, "memory": "2Gi"}], **extra))
    return store


def steer_replay(cap: dict, launches: int, computing: int) -> dict:
    """``aff_steer`` on its first launch's captured inputs (the live window
    of that sub-round) with the gate set -- held against the plain version
    and timed as in ``replay_kernels`` -- and with it clear
    (``gated_replay``); each with the device operations one call puts on
    the card (``_steer_ops``)."""
    import torch

    c = dict(cap)
    c["gate"] = torch.ones(1, dtype=torch.bool, device=c["ranked"].device)
    row = replay_kernels({"aff_steer": c}, {"aff_steer": launches},
                         names=["aff_steer"])[0]
    row["computing_launches"] = computing
    row["gated_launches"] = launches - computing
    row["gated"] = gated_replay("aff_steer", cap)
    _steer_ops(row, c, cap)
    UM, K = cap["ranked"].shape
    EW, D = cap["at"].cnt_a.shape
    row["shape"] = {"UM": int(UM), "K": int(K), "EW": int(EW), "D": int(D)}
    return row


def _steer_ops(row: dict, computing: dict, cap: dict) -> None:
    """The device operations of one computing and one gated ``aff_steer``
    call on ``cap`` into ``row`` (and ``row["gated"]``): a trace's names
    and a CUDA graph's counts; a call that is not one ``aff_steer``
    kernel fails."""
    import torch

    gated = dict(cap)
    gated["gate"] = torch.zeros(1, dtype=torch.bool,
                                device=cap["ranked"].device)
    for entry, c in ((row, computing), (row["gated"], gated)):
        fn = _kernel_fn("aff_steer", _clone(c), plain=False)
        _out, names = device_ops(fn)
        counts = graph_ops(fn)
        entry["device_ops"] = names
        entry["graph_ops"] = counts
        if counts != {"kernel": 1} or (names is not None and (
                names != list(KERNEL_FUNCS["aff_steer"]))):
            raise AssertionError(f"[kernels:steer] one aff_steer call put "
                                 f"{counts} ({names}) on the card")


def fold_single_rows(rows: list, single_rows: dict) -> None:
    """The single-phase launches' numbers under ``single`` in the rows of
    ``rank_candidates``, ``aff_live`` and ``static_planes``."""
    by_name = {r["name"]: r for r in rows}
    keys = ("launches", "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "wrapper_ms", "queued", "bytes", "ops")
    for name in ("rank_candidates", "aff_live", "static_planes"):
        r = single_rows[name]
        entry = {k: r[k] for k in keys}
        if name == "aff_live":
            entry.update({k: r[k] for k in ("computing_launches",
                                            "gated_launches", "gated")})
        by_name[name]["single"] = entry


def single_phase_phases(ns_args=None, big=(10000, 100000),
                        mid=(1000, 10000)):
    """Phases 32-34.  [single-phase]: the north-star solve with
    ``VOLCANO_TPU_TWOPHASE=0`` equal to its plain run on the card, timed
    against the two-phase solve of the same args; a cold and 2 steady
    cycles of a north-star store; 1,000 x 10,000 card against CPU.
    [single-phase:affinity]: config 5's cold cycle single-phase, and the
    full-N ``aff_live`` (computing and gated), ``rank_candidates`` and the
    node-level ``static_planes`` launches against their plain versions.
    [steer]: config 5 with ``AFF_STEER`` on (two-phase), a cold and 2
    steady cycles; ``aff_steer`` on its captured inputs; 1,000 x 10,000 in
    both phase modes and the contended store, card against CPU, and steering
    on against off there.  Returns (the ``aff_steer`` row, the single-phase
    rows of ``rank_candidates``, ``aff_live`` and ``static_planes``)."""
    import statistics

    import torch

    from volcano_tpu_torch.framework import DEPLOYED_SCHEDULER_CONF
    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.ops import wave as wave_mod
    from volcano_tpu_torch.synth import solve_args_from_store

    t_phase = time.perf_counter()
    secs = {}
    # 32. [single-phase]
    if ns_args is None:
        st = _fresh_cluster(n_nodes=big[0], n_pods=big[1], gang_size=8,
                            zones=16, seed=0)
        ns_args, _ = solve_args_from_store(st, binpack=True, nodeorder=True)
        st.close()
        del st
    args, taint_any = host_flag_args(ns_args)
    restore = _env("VOLCANO_TPU_TWOPHASE", "1")
    try:
        two_walls, two_res, two_rec = timed_solves(args, taint_any=taint_any)
    finally:
        restore()
    restore = _env("VOLCANO_TPU_TWOPHASE", "0")
    single_rows = {}
    try:
        kernels.CAPTURE = {}
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = wave_mod.solve_wave(*args, taint_any=taint_any)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = launch_counts()
        caps, kernels.CAPTURE = kernels.CAPTURE, None
        rec = dict(wave_mod.LAST_TWOPHASE)
        if rec["enabled"] or rec["shortlist"] is not None:
            raise AssertionError(f"[single-phase] the solve ran two-phase: "
                                 f"{rec}")
        if rec["host_reads"] != 0:
            raise AssertionError(f"[single-phase] the solve read device "
                                 f"planes back: {rec['host_reads']}")
        missing = never_launched(launches, ("rank_candidates", "walk_accept",
                                            "apply_commit", "static_planes"))
        if missing or launches["coarse_shortlist"] \
                or launches["warm_shortlist"]:
            raise AssertionError(f"[single-phase] launches {launches}")
        if launches["static_planes"] != rec["waves"]:
            raise AssertionError(f"[single-phase] {launches['static_planes']}"
                                 f" static_planes launches for "
                                 f"{rec['waves']} waves")
        inv = check_invariants(args, res)
        walls, again, _r = timed_solves(args, taint_any=taint_any)
        same_result(res, again, "[single-phase] repeat solve")
        t0 = time.perf_counter()
        plain = wave_mod.solve_wave(*args, taint_any=taint_any, plain=True)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        same_result(res, plain, "[single-phase] kernels vs plain versions")
        stats = {"first_solve_s": first_s,
                 "solve_s_median": statistics.median(walls),
                 "solve_s_all": walls, "plain_solve_s": plain_s,
                 "two_phase_solve_s_median": statistics.median(two_walls),
                 "two_phase_solve_s_all": two_walls,
                 "two_phase_host_reads": two_rec["host_reads"],
                 "two_phase_syncs": two_rec["syncs"],
                 "two_phase_pods_bound": int((two_res.assigned >= 0).sum()),
                 **{k: rec[k] for k in ("syncs", "host_reads", "waves",
                                        "prep_s", "fine_s")},
                 "launches": {k: v for k, v in launches.items() if v},
                 **inv}
        _log(f"[single-phase] north-star solve median "
             f"{stats['solve_s_median']:.4f} s (two-phase "
             f"{stats['two_phase_solve_s_median']:.4f} s, same args, same "
             f"run), equal to its plain run; {json.dumps(stats)}")
        single_rows["static_planes"] = _replay_rows(
            caps, launches, "single-phase", ["static_planes"])[0]
        del caps, res, again, plain, two_res
        # The cycle on a north-star store of its own.
        t0 = time.perf_counter()
        store = _fresh_cluster(n_nodes=big[0], n_pods=big[1], gang_size=8,
                               zones=16, seed=0)
        _log(f"[single-phase] north-star cluster "
             f"{time.perf_counter() - t0:.3f} s")
        cstats, _r = run_aff_cycles("single-phase:cycle", store, steady=2,
                                    all_bound=True,
                                    conf=DEPLOYED_SCHEDULER_CONF)
        single_phase_solves("single-phase:cycle", cstats)
        dv = store._devincr_cache
        if dv is not None and any(dv.counts.values()):
            raise AssertionError(f"[single-phase] devincr counted "
                                 f"{dv.counts}")
        store.close()
        del store
        _log(f"[single-phase] cycle walls (s) "
             f"{[round(c['wall_s'], 4) for c in cstats['cycles']]}")

        def mid_run(device):
            st = _fresh_cluster(n_nodes=mid[0], n_pods=mid[1], gang_size=8,
                                zones=16, seed=0)
            s_, r = run_aff_cycles(f"single-phase:mid:{device or 'cuda'}",
                                   st, steady=1, device=device,
                                   all_bound=True,
                                   conf=DEPLOYED_SCHEDULER_CONF)
            single_phase_solves("single-phase:mid", s_)
            st.close()
            return r
        _same_records("single-phase:mid", mid_run(None), mid_run("cpu"),
                      "card vs CPU")
        _log(f"[single-phase:mid] {mid[0]} x {mid[1]}: card = CPU")
        secs["single-phase"] = time.perf_counter() - t_phase

        # 33. [single-phase:affinity]
        t0 = time.perf_counter()
        store = config5_cluster(*big)
        _log(f"[single-phase:affinity] cluster "
             f"{time.perf_counter() - t0:.3f} s")
        kernels.CAPTURE = {}
        kernels.reset_launches()
        astats, _r = run_aff_cycles("single-phase:affinity", store,
                                    steady=0, all_bound=True)
        single_phase_solves("single-phase:affinity", astats)
        launches = launch_counts()
        computing = kernels.read_tally("aff_live")
        caps, kernels.CAPTURE = kernels.CAPTURE, None
        store.close()
        del store
        if launches["coarse_shortlist"] or launches["warm_shortlist"]:
            raise AssertionError(f"[single-phase:affinity] launches "
                                 f"{launches}")
        missing = never_launched(launches, (
            "rank_candidates", "walk_accept", "apply_commit",
            "static_planes", "aff_live", "aff_filter"))
        if missing:
            raise AssertionError(f"[single-phase:affinity] kernels never "
                                 f"launched: {missing}")
        _log(f"[single-phase:affinity] launches {json.dumps(launches)}; "
             f"aff_live {computing} computing + "
             f"{launches['aff_live'] - computing} gated; first-launch "
             f"shapes {json.dumps(first_shapes(caps))}")
        for name in ("aff_live", "rank_candidates:aff:fallback"):
            if caps[name]["cand"] is not None:
                raise AssertionError(f"[single-phase:affinity] {name} was "
                                     f"not a full-N launch")
        live = _replay_rows(caps, launches, "single-phase:affinity",
                            ["aff_live"])[0]
        live["computing_launches"] = computing
        live["gated_launches"] = launches["aff_live"] - computing
        live["gated"] = gated_replay("aff_live", caps["aff_live"])
        single_rows["aff_live"] = live
        single_rows["rank_candidates"] = _replay_rows(
            caps, launches, "single-phase:affinity",
            ["rank_candidates:aff:fallback"])[0]
        single_rows["cold_cycle_s"] = astats["cycles"][0]["wall_s"]
        del caps
        secs["single-phase:affinity"] = (time.perf_counter() - t_phase
                                         - sum(secs.values()))
    finally:
        restore()

    # 34. [steer]
    steer0 = wave_mod.AFF_STEER
    wave_mod.AFF_STEER = 1
    try:
        t0 = time.perf_counter()
        store = config5_cluster(*big)
        _log(f"[steer] cluster {time.perf_counter() - t0:.3f} s")
        kernels.CAPTURE = {}
        kernels.reset_launches()
        sstats, _r = run_aff_cycles("steer", store, steady=2,
                                    all_bound=True)
        launches = launch_counts()
        computing = kernels.read_tally("aff_steer")
        caps, kernels.CAPTURE = kernels.CAPTURE, None
        store.close()
        del store
        if launches["aff_steer"] == 0 or computing == 0:
            raise AssertionError(f"[steer] aff_steer launches "
                                 f"{launches['aff_steer']}, computing "
                                 f"{computing}")
        _log(f"[steer] launches {json.dumps(launches)}; aff_steer "
             f"{computing} computing + {launches['aff_steer'] - computing} "
             f"gated; cycle walls (s) "
             f"{[round(c['wall_s'], 4) for c in sstats['cycles']]}")
        steer_row = steer_replay(caps["aff_steer"], launches["aff_steer"],
                                 computing)
        steer_row["cycle_walls_s"] = [c["wall_s"]
                                      for c in sstats["cycles"]]
        _log(f"[kernels:steer] aff_steer: {steer_row['ms']:.5f} ms/launch "
             f"computing, {steer_row['gated']['ms']:.5f} ms gated, plain "
             f"{steer_row['plain_ms']:.5f} ms, bound "
             f"{steer_row['bound_ms']:.6f} ms ({steer_row['bound_by']}); "
             f"device ops a call {steer_row['device_ops']} / gated "
             f"{steer_row['gated']['device_ops']}; {json.dumps(steer_row)}")
        del caps

        def mid_run(device, twophase):
            restore = _env("VOLCANO_TPU_TWOPHASE", twophase)
            try:
                st = config5_cluster(*mid)
                s_, r = run_aff_cycles(
                    f"steer:mid:{twophase}:{device or 'cuda'}", st,
                    steady=1, device=device, repend=range(16))
                st.close()
                if twophase == "0":
                    single_phase_solves("steer:mid", s_)
                return r
            finally:
                restore()
        for tp in ("1", "0"):
            card, cpu = mid_run(None, tp), mid_run("cpu", tp)
            _same_records("steer:mid", card, cpu,
                          f"card vs CPU (TWOPHASE={tp})")
            _log(f"[steer:mid] {mid[0]} x {mid[1]} TWOPHASE={tp}: card = "
                 f"CPU")
        # The contended store: card against CPU in both phase modes, and
        # steering on against off.
        binds = {}
        for tp in ("1", "0"):
            restore = _env("VOLCANO_TPU_TWOPHASE", tp)
            try:
                for steer in (1, 0):
                    wave_mod.AFF_STEER = steer
                    got = []
                    for dev in (None, "cpu"):
                        st = contended_store()
                        a, _ = solve_args_from_store(
                            st, binpack=True, nodeorder=True, device=dev)
                        st.close()
                        r = wave_mod.solve_wave(*a, wave=32, device=dev)
                        got.append((r, dict(wave_mod.LAST_TWOPHASE)))
                    same_result(got[0][0], got[1][0],
                                f"[steer:contended] TWOPHASE={tp} "
                                f"AFF_STEER={steer} card vs CPU")
                    if steer and got[0][1]["steer_calls"] == 0:
                        raise AssertionError("[steer:contended] no "
                                             "steering call")
                    binds[(tp, steer)] = int((got[0][0].assigned >= 0).sum())
                    key = got[0][0].assigned.cpu().numpy().tobytes()
                    binds[(tp, steer, "key")] = key
            finally:
                restore()
        for tp in ("1", "0"):
            if binds[(tp, 1, "key")] == binds[(tp, 0, "key")]:
                raise AssertionError(f"[steer:contended] steering changed "
                                     f"nothing (TWOPHASE={tp})")
        _log(f"[steer:contended] card = CPU in both phase modes, steering "
             f"on and off; pods bound (TWOPHASE, AFF_STEER): "
             f"{json.dumps({f'{k[0]},{k[1]}': v for k, v in binds.items() if len(k) == 2})}")
    finally:
        wave_mod.AFF_STEER = steer0
    secs["steer"] = time.perf_counter() - t_phase - sum(secs.values())
    _log(f"[single-phase] seconds {json.dumps(secs)}")
    return steer_row, single_rows


# ------------------------------------------------- the host victim walk

# The allocate kernels a walk cycle launches (the walk itself is host work:
# no victim_scores, no what-if solve).
WALK_KERNELS = ("coarse_shortlist", "static_planes", "rank_candidates",
                "walk_accept", "apply_commit")


def walk_checks(store):
    """The checks of ``held_invariants`` after a walk cycle, and the walk's
    own conservation: the host walk deletes its victims (no migration
    ledger restores them), so every pod that left the store was evicted,
    and the mirror holds exactly the store's pods."""
    import numpy as np

    keys0 = {f"{p.namespace}/{p.name}" for p in store.pods.values()}

    def check(st, n_pods):
        keys = {f"{p.namespace}/{p.name}" for p in st.pods.values()}
        gone = keys0 - keys
        evicted = set(st.evictor.evicts)
        if not gone <= evicted or len(evicted) != len(st.evictor.evicts):
            raise AssertionError(f"a pod left the store unevicted, or one "
                                 f"was evicted twice: {len(gone)} gone, "
                                 f"{len(evicted)} evicted")
        if keys - keys0 or len(st.pods) != n_pods - len(gone):
            raise AssertionError("the walk added or lost a pod")
        m = st.mirror
        if int(np.count_nonzero(m.p_alive[:m.n_pods])) != len(st.pods):
            raise AssertionError("the mirror and the store disagree")
        out = held_invariants(st)[0]
        out.update(evicted=len(evicted), deleted=len(gone))
        return out

    return check


class WalkSpy:
    """Counts the walk's actions, and per reclaim action whether the native
    drive engaged (``_native_reclaim_setup`` gave a context and
    ``_native_reclaim_drive`` ran) and finished it in C."""

    def __init__(self):
        from volcano_tpu_torch import fastpath_evict as fe

        self.fe = fe
        self.orig = (fe.FastEvictor.preempt, fe.FastEvictor.reclaim,
                     fe.FastEvictor._native_reclaim_drive)
        self.preempts = self.reclaims = 0
        self.engaged = []  # per reclaim action: (drive calls, finished)

    def __enter__(self):
        E = self.fe.FastEvictor
        preempt, reclaim, drive = self.orig

        def preempt_spy(ev):
            self.preempts += 1
            return preempt(ev)

        def reclaim_spy(ev):
            self.reclaims += 1
            self.engaged.append([0, 0])
            return reclaim(ev)

        def drive_spy(ev, *a, **k):
            out = drive(ev, *a, **k)
            if self.engaged:
                self.engaged[-1][0] += 1
                self.engaged[-1][1] += bool(out)
            return out

        E.preempt, E.reclaim = preempt_spy, reclaim_spy
        E._native_reclaim_drive = drive_spy
        return self

    def __exit__(self, *exc):
        E = self.fe.FastEvictor
        (E.preempt, E.reclaim, E._native_reclaim_drive) = self.orig


def walk_lanes(stats) -> list:
    """Per cycle (wall s, preempt ms, reclaim ms, the allocate solve's
    ``device`` lane ms)."""
    return [(round(c["wall_s"], 4), c["lanes_ms"].get("preempt"),
             c["lanes_ms"].get("reclaim"), c["lanes_ms"].get("device"))
            for c in stats["cycles"]]


def _preempt_cluster_reset(**kw):
    """preempt_cluster with the uid counters reset."""
    from volcano_tpu_torch.synth import preempt_cluster

    _reset_uids()
    with _no_gc():
        return preempt_cluster(**kw)


def walk_fixtures():
    """``tests/test_torch_fixtures.py``, which imports only the port at
    module level: phase 37 runs its twin harness (``walk_run``) and its
    two-queue store, the CPU tests' own."""
    import os
    import sys

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import test_torch_fixtures

    return test_torch_fixtures


def walk_audited(label):
    """``walk_run``'s per-cycle hook: the phase's audit checks after every
    cycle, adding no field to the record."""
    def check(store):
        audit_checked(label, store, quiet=True)
        return {}
    return check


def host_walk_phases(big=10000, workers=10000, serving=5000,
                     twin_nodes=1000) -> dict:
    """Phases 35-37: the host victim walk (``VOLCANO_TPU_EVICT_DEVICE=0``)
    at full size, config 4 and the 10,000-worker preempt, then card
    against CPU and native drive against the Python walk at 1,000 nodes.
    Returns the per-phase records."""
    from volcano_tpu_torch import native
    from volcano_tpu_torch.cache import ClusterStore, FakeBinder, FakeEvictor
    from volcano_tpu_torch.sim import ClusterSimulator

    secs = {}
    out = {}
    restore = _env("VOLCANO_TPU_EVICT_DEVICE", "0")
    restore_cap = _env("VOLCANO_TPU_EVICT_CAP", None)
    try:
        t0 = time.perf_counter()
        native.load()
        _log(f"[host-walk] native engine built and loaded "
             f"{time.perf_counter() - t0:.3f} s ({native.CXX} "
             f"{' '.join(native.CXX_FLAGS)})")

        # 35. [host-walk:reclaim]: BASELINE config 4 at its full size.
        t_phase = time.perf_counter()
        t0 = time.perf_counter()
        store = _preempt_cluster_reset(n_nodes=big, fill_per_node=4,
                                       n_pending=2 * big, gang_size=4, seed=0)
        _log(f"[host-walk:reclaim] cluster {time.perf_counter() - t0:.3f} s,"
             f" {len(store.pods)} pods")
        with WalkSpy() as spy:
            rstats, rlaunch, _vs, _fut = run_evict_phase(
                "host-walk:reclaim", store, CONF_PREEMPT, grace=2, cycles=6,
                need=WALK_KERNELS, require_future=False,
                invariants=walk_checks(store))
        bound = sum(1 for p in store.pods.values()
                    if p.name.startswith("hi-") and p.node_name)
        deleted = rstats["cycles"][-1]["deleted"]
        evicted = rstats["cycles"][-1]["evicted"]
        rstats.update(hi_bound=bound, walk_evictions=evicted,
                      deleted=deleted, preempt_actions=spy.preempts,
                      reclaim_actions=spy.reclaims,
                      drive=spy.engaged, lanes=walk_lanes(rstats))
        _log(f"[host-walk:reclaim] per cycle (wall s, preempt ms, reclaim "
             f"ms, solve device ms) {json.dumps(rstats['lanes'])}")
        _log(f"[host-walk:reclaim] {json.dumps(_summary(rstats))}")
        # The walk's exact counts, in the proportions the CPU tests hold
        # at small sizes, where the port's walk equals the JAX package's
        # (tests/test_torch_host_walk.py, test_walk_eviction_counts_*):
        # the first wave evicts one filler for each pending pod, the
        # second as many again (the walk reclaims again for the gangs
        # allocate pipelined onto releasing capacity), no later cycle
        # evicts, and every pending pod binds.
        pending = 2 * big
        want = [pending] + [2 * pending] * (len(rstats["cycles"]) - 1)
        got = [c["evicted"] for c in rstats["cycles"]]
        if got != want or bound != pending:
            raise AssertionError(f"[host-walk:reclaim] evictions per cycle "
                                 f"{got}, {want} expected; {bound} of "
                                 f"{pending} reclaimers bound")
        if rlaunch["victim_scores"]:
            raise AssertionError("[host-walk:reclaim] the device lane ran")
        if rstats["whatif_plans"]:
            raise AssertionError("[host-walk:reclaim] a what-if plan was "
                                 f"counted: {rstats['whatif_plans']}")
        if spy.reclaims != len(rstats["cycles"]) or not all(
                n >= 1 and f == n for n, f in spy.engaged):
            raise AssertionError(f"[host-walk:reclaim] the native drive did "
                                 f"not run every reclaim action in C: "
                                 f"{spy.reclaims} actions, {spy.engaged}")
        # Evictions against deletions: every evicted pod left the store
        # after its grace or is still terminating (deleting, Releasing in
        # the mirror), and no other pod left (walk_checks, every cycle).
        ev_keys = set(store.evictor.evicts)
        left = [p for p in store.pods.values()
                if f"{p.namespace}/{p.name}" in ev_keys]
        if evicted < 1 or not all(p.deleting for p in left) \
                or deleted + len(left) != evicted:
            raise AssertionError(f"[host-walk:reclaim] {evicted} evictions,"
                                 f" {deleted} deleted, {len(left)} "
                                 "terminating")
        rstats["terminating"] = len(left)
        out["reclaim"] = _summary(rstats)
        store.close()
        del store
        secs["host-walk:reclaim"] = time.perf_counter() - t_phase

        # 36. [host-walk:preempt]: bench.py config_preempt at 10,000
        # workers, the walk's statement-wrapped phase 1.
        t_phase = time.perf_counter()
        store = ClusterStore(binder=FakeBinder(), evictor=FakeEvictor())
        t0 = time.perf_counter()
        with _no_gc():
            ClusterSimulator.priority_tier_workload(store, workers=workers,
                                                    serving_tasks=serving)
        _log(f"[host-walk:preempt] cluster {time.perf_counter() - t0:.3f} "
             f"s, {len(store.pods)} pods")

        def serving_bound(st):
            return sum(1 for p in st.pods.values()
                       if p.name.startswith("serving-") and p.node_name) \
                >= serving

        with WalkSpy() as spy:
            pstats, _pl, _vs, _fut = run_evict_phase(
                "host-walk:preempt", store, CONF_PREEMPT_ONLY, grace=2,
                cycles=24, until=serving_bound, need=WALK_KERNELS,
                require_future=False, invariants=walk_checks(store))
        pstats.update(serving_bound=serving_bound(store),
                      walk_evictions=len(set(store.evictor.evicts)),
                      preempt_actions=spy.preempts,
                      lanes=walk_lanes(pstats))
        _log(f"[host-walk:preempt] per cycle (wall s, preempt ms, reclaim "
             f"ms, solve device ms) {json.dumps(pstats['lanes'])}")
        _log(f"[host-walk:preempt] {json.dumps(_summary(pstats))}")
        if not pstats["serving_bound"]:
            raise AssertionError("[host-walk:preempt] the serving gang did "
                                 "not bind in 24 cycles")
        # The walk's exact counts, in the proportions the CPU tests hold
        # at small sizes against the JAX package's walk
        # (test_walk_eviction_counts_*): the first wave evicts one batch
        # pod for each serving task, the next cycle as many again (the
        # gang, pipelined by allocate onto the releasing capacity, still
        # reads as pending to the walk), and no later cycle evicts.
        want = [serving] + [2 * serving] * (len(pstats["cycles"]) - 1)
        got = [c["evicted"] for c in pstats["cycles"]]
        if 2 * serving > workers or got != want \
                or pstats["walk_evictions"] != 2 * serving:
            raise AssertionError(f"[host-walk:preempt] evictions per cycle "
                                 f"{got}, {want} expected")
        out["preempt"] = _summary(pstats)
        store.close()
        del store
        secs["host-walk:preempt"] = time.perf_counter() - t_phase

        # 37. [host-walk:twin]: card against CPU, native against Python.
        t_phase = time.perf_counter()
        fx = walk_fixtures()
        half = twin_nodes // 2
        builds = {
            "preempt-cluster": lambda pkg: pkg.synth.preempt_cluster(
                n_nodes=twin_nodes, fill_per_node=4,
                n_pending=2 * twin_nodes, gang_size=4, seed=0),
            "two-queue": lambda pkg: fx.two_queue_store(
                pkg, n_nodes=twin_nodes, hi_a=half, hi_b=half),
        }
        import volcano_tpu_torch

        def walk(build, device, native):
            return fx.walk_run(volcano_tpu_torch, build, conf=CONF_PREEMPT,
                               cycles=5, native=native, device=device,
                               on_cycle=walk_audited("host-walk:twin"))

        twin = {}
        for name, build in builds.items():
            with WalkSpy() as spy:
                card = walk(build, None, True)
            if not spy.engaged or not all(n >= 1 for n, _f in spy.engaged):
                raise AssertionError(f"[host-walk:twin] {name}: the native "
                                     f"drive did not engage: {spy.engaged}")
            cpu = walk(build, "cpu", True)
            _same_records("host-walk:twin", card, cpu, f"{name} card vs CPU")
            with WalkSpy() as spy:
                py = walk(build, None, False)
            if any(n for n, _f in spy.engaged):
                raise AssertionError(f"[host-walk:twin] {name}: the drive "
                                     "ran with VOLCANO_TPU_NO_NATIVE=1")
            _same_records("host-walk:twin", card, py,
                          f"{name} native vs Python walk")
            twin[name] = {
                "cycles": len(card),
                "evicted": [len(r["evicted"]) for r in card],
                "pipelined": [len(r["pipelined"]) for r in card],
                "binds": len(card[-1]["binds"]),
            }
            if not any(twin[name]["evicted"]):
                raise AssertionError(f"[host-walk:twin] {name}: no eviction")
            _log(f"[host-walk:twin] {name} at {twin_nodes} nodes: card = "
                 f"CPU, native = Python walk {json.dumps(twin[name])}")
        out["twin"] = twin
        secs["host-walk:twin"] = time.perf_counter() - t_phase
    finally:
        restore_cap()
        restore()
    _log(f"[host-walk] seconds {json.dumps(secs)}")
    out["seconds"] = secs
    return out


# ------------------------------------------------ the solver service

REMOTE_MARK = "[remote:child] result "
# PERF.md section 6, rows 1-4 and 2a-2c: the wave solve's kernels, which
# the solver child launches on its card.
REMOTE_KERNELS = ("coarse_shortlist", "static_planes", "warm_shortlist",
                  "rank_candidates", "walk_accept", "apply_commit")
# A child: start (interpreter, torch, CUDA context, the built library)
# and its stop (the replay of its captured first launches).
CHILD_START_S = 180
CHILD_STOP_S = 180
# How long a held child keeps a reply back ([remote:heal]'s kill with a
# reply unsent, [remote:pool]'s hedge).
HOLD_S = 3.0


def solver_child(argv) -> None:
    """``python3 chip_smoke.py solver-child [--hold-file F]``: the port's
    ``SolverServer`` on the card, on a port of its own, announced as
    ``SOLVER <port>``.  With ``--hold-file``, while that file exists the
    reply of every solve from the one numbered in it (empty: every solve)
    waits ``HOLD_S`` seconds: a straggler the pool hedges, or a reply
    still unsent when the child is killed.  Launch
    counts start at 0 and the inputs of each kernel's first launch are
    captured; on SIGTERM the child stops serving, replays the first
    launches of ``REMOTE_KERNELS`` against their plain versions and prints
    one ``REMOTE_MARK`` line: its launches, its build seconds (0: the
    library the parent built was reused), its solves and the rows."""
    import os
    import signal

    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.solver_service import SolverServer

    hold = argv[argv.index("--hold-file") + 1] \
        if "--hold-file" in argv else None
    kernels.reset_launches()
    kernels.CAPTURE = {}
    server = SolverServer(port=0)
    if hold is not None:
        def delay(i):
            try:
                with open(hold) as f:
                    first = int(f.read().strip() or 0)
            except OSError:
                return 0.0
            return HOLD_S if i >= first else 0.0

        server.solve_delay_fn = delay
    signal.signal(signal.SIGTERM, lambda *_: server._stop.set())
    print(f"SOLVER {server.port}", flush=True)
    server.serve_forever()
    server.shutdown()
    launches = launch_counts()
    captured, kernels.CAPTURE = kernels.CAPTURE, None
    names = [k for k in REMOTE_KERNELS if k in captured]
    rows = replay_kernels(captured, launches, reps=10, names=names)
    print(REMOTE_MARK + json.dumps({
        "launches": {k: v for k, v in launches.items() if v},
        "build_s": kernels.BUILD_SECONDS, "solves": server.solves,
        "first_launch": [{k: r[k] for k in (
            "name", "launches", "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "library_ms")} for r in rows]}), flush=True)


class _SolverChild:
    """``python3 chip_smoke.py solver-child`` started with ``subprocess``
    (never forked: this process holds a CUDA context); its output read on
    a thread."""

    def __init__(self, label, *args):
        import os
        import threading

        here = os.path.dirname(os.path.abspath(__file__))
        self.label = label
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"),
             "solver-child", *args],
            cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        self.lines = []
        self.port = None
        self._ready = threading.Event()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            line = line.rstrip("\n")
            self.lines.append(line)
            if self.port is None and line.startswith("SOLVER "):
                self.port = int(line.split()[1])
                self._ready.set()
        self._ready.set()

    def address(self) -> str:
        if not self._ready.wait(CHILD_START_S) or self.port is None:
            self.kill()
            raise AssertionError(f"[{self.label}] the solver child did not "
                                 f"start: {self.lines[-5:]}")
        return f"127.0.0.1:{self.port}"

    def stop(self) -> dict:
        """SIGTERM, wait, and the child's ``REMOTE_MARK`` result."""
        import signal

        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(CHILD_STOP_S)
        except subprocess.TimeoutExpired as e:
            self.kill()
            raise AssertionError(f"[{self.label}] the child did not stop") \
                from e
        self._reader.join(30)
        hit = [x for x in self.lines if x.startswith(REMOTE_MARK)]
        if rc != 0 or not hit:
            raise AssertionError(f"[{self.label}] the child exited {rc}: "
                                 f"{self.lines[-8:]}")
        return json.loads(hit[-1][len(REMOTE_MARK):])

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)
        self._reader.join(30)


def _remote_sched(store, conf=None):
    from volcano_tpu_torch.framework import DEPLOYED_SCHEDULER_CONF
    from volcano_tpu_torch.scheduler import Scheduler

    return Scheduler(store, conf_str=conf or DEPLOYED_SCHEDULER_CONF)


def remote_sequence(label, store, n_pods, cycles, pipelined=False,
                    client=None, between=None, drain=0, log=True,
                    lose_fetch=None):
    """``cycles`` cycles of the deployed conf on ``store`` (a cold one, then
    cycles re-pending the pods of nodes 0-63), through ``client`` when
    given (the store's remote solver) and locally otherwise, then ``drain``
    cycles with the feed off.  ``between(step)`` runs after cycle ``step``;
    ``lose_fetch`` (local, pipelined) drops the reply of that fetch (1 =
    the first) as a lost one, as a killed child loses it.  After every
    cycle the invariants (``cycle_invariants``; pipelined
    ``pipeline_invariants``, every pod bound after the drain).  Returns
    per-cycle records: the binds' hash and, remote, the frame kind, its
    bytes, the child's ``solve_ms``, the cycle's wait for the reply (a
    synchronous solve's round trip, a pipelined fetch's wait) and the
    wall."""
    import torch

    from volcano_tpu_torch import pipeline as pl

    store.pipeline = pipelined
    if client is not None:
        store.remote_solver = client
    sched = _remote_sched(store)
    waits = []
    if client is not None and not pipelined:
        real_solve = client.solve

        def timed_solve(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real_solve(*a, **kw)
            finally:
                waits.append((time.perf_counter() - t0) * 1e3)

        client.solve = timed_solve
    real_fetch = pl.InflightSolve.fetch
    fetches = [0]
    if lose_fetch is not None:
        def fetch(inflight):
            out = real_fetch(inflight)
            fetches[0] += 1
            if fetches[0] == lose_fetch:
                inflight.kind = "remote"
                raise ConnectionError("reply lost (injected)")
            return out

        pl.InflightSolve.fetch = fetch
    out = []
    try:
        for step in range(cycles + drain):
            if step == 1:
                store.cycle_feed = repend_feed(list(range(64)))
            if step == cycles:
                store.cycle_feed = None
            before = dict(client.frame_bytes) if client is not None else {}
            waits.clear()
            t0 = time.perf_counter()
            sched.run_once()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            store.flush_binds()
            if pipelined:
                inv = pipeline_invariants(store, n_pods,
                                          final=step == cycles + drain - 1
                                          and drain > 0)
            else:
                inv = cycle_invariants(store, n_pods)
            rec = store.flight.last()
            r = {"cycle": step, "wall_s": round(wall, 4),
                 "binds": _binds_hash(store.binder.binds), **inv,
                 "drops": dict(rec.drop_reasons)}
            if client is not None:
                r["frame"] = client.last_frame_kind
                r["frame_bytes"] = sum(
                    v - before.get(k, 0)
                    for k, v in client.frame_bytes.items())
                r["solve_ms"] = getattr(client, "last_solve_ms", None)
                r["wait_ms"] = (round(sum(waits), 3) if not pipelined
                                else rec.inflight_fetch_wait_ms)
            out.append(r)
            if log:
                _log(f"[{label}] {json.dumps(r)}")
            if between is not None:
                between(step)
    finally:
        pl.InflightSolve.fetch = real_fetch
        if client is not None and not pipelined:
            client.solve = real_solve
    return out


def _same_hashes(label, a, b, what, start=0):
    x = [r["binds"] for r in a][start:]
    y = [r["binds"] for r in b][start:]
    if x != y:
        raise AssertionError(f"[{label}] binds differ from {what}: "
                             f"{[i for i, (p, q) in enumerate(zip(x, y)) if p != q]}")


def _mid_store(mid):
    return _fresh_cluster(n_nodes=mid[0], n_pods=mid[1], gang_size=8,
                          zones=16, seed=0)


def remote_main(child, big, ns_hashes):
    """[remote]: the north-star store, a cold and 5 steady cycles, through
    a ``RemoteSolver`` to ``child`` on the card."""
    from volcano_tpu_torch.solver_service import RemoteSolver

    restore = _env("VOLCANO_TPU_AUDIT_SAMPLE", "1")
    try:
        t0 = time.perf_counter()
        store = _fresh_cluster(n_nodes=big[0], n_pods=big[1], gang_size=8,
                               zones=16, seed=0)
        _log(f"[remote] north-star cluster {time.perf_counter() - t0:.3f} s")
        client = RemoteSolver(child.address(), timeout=600)
        pong = client.ping()
        if pong.get("backend") != "cuda" or pong.get("wire") != 2:
            raise AssertionError(f"[remote] the child's pong {pong}")
        _log(f"[remote] child pong {json.dumps(pong)}")
        from volcano_tpu_torch.ops import kernels

        kernels.reset_launches()
        recs = remote_sequence("remote", store, big[1], 6, client=client)
        parent = {k: v for k, v in launch_counts().items() if v}
        if parent:
            raise AssertionError(f"[remote] the scheduler process launched "
                                 f"{parent}")
        kinds = [r["frame"] for r in recs]
        if kinds[0] != "full" or any(k != "delta" for k in kinds[1:]):
            raise AssertionError(f"[remote] frame kinds {kinds}")
        if ns_hashes is not None:
            _same_hashes("remote", recs,
                         [{"binds": h} for h in ns_hashes],
                         "the local card cycles")
        stats = audit_checked("remote", store)
        if stats["sampled_cycles"] < 6:
            raise AssertionError(f"[remote] the wire audit ran "
                                 f"{stats['sampled_cycles']} times")
        out = {"frames": dict(client.frame_counts),
               "frame_bytes": dict(client.frame_bytes),
               "fallbacks": dict(client.wire_fallbacks),
               "cycles": recs, "parent_launches": parent}
        client.close()
        store.close()
        return out
    finally:
        restore()


def remote_shm(child, mid):
    """[remote:shm]: the sequence of [remote] at 1,000 x 10,000 over TCP,
    then over the shared-memory lane, against one child."""
    from volcano_tpu_torch.metrics import metrics
    from volcano_tpu_torch.solver_service import RemoteSolver

    local = remote_sequence("remote:shm:local", _mid_store(mid), mid[1], 6,
                            log=False)
    tcp_client = RemoteSolver(child.address(), timeout=600)
    tcp = remote_sequence("remote:shm:tcp", _mid_store(mid), mid[1], 6,
                          client=tcp_client)
    restore = _env("VOLCANO_TPU_SHM", "1")
    try:
        before = sum(metrics.remote_frame_fallback.data.values())
        shm_client = RemoteSolver(child.address(), timeout=600)
        if shm_client._shm is None:
            raise AssertionError("[remote:shm] the lane is off")
        shm = remote_sequence("remote:shm", _mid_store(mid), mid[1], 6,
                              client=shm_client)
        fallbacks = sum(metrics.remote_frame_fallback.data.values()) - before
        if fallbacks or shm_client._shm is None:
            raise AssertionError(f"[remote:shm] {fallbacks} fallbacks, "
                                 f"{shm_client.wire_fallbacks}")
    finally:
        restore()
    _same_hashes("remote:shm", shm, tcp, "the TCP lane")
    _same_hashes("remote:shm", tcp, local, "the local card cycles")
    out = {"tcp_bytes": dict(tcp_client.frame_bytes),
           "shm_bytes": dict(shm_client.frame_bytes),
           "fallback_total": fallbacks}
    if out["shm_bytes"]["full"] >= out["tcp_bytes"]["full"]:
        raise AssertionError(f"[remote:shm] socket bytes {out}")
    tcp_client.close()
    shm_client.close()
    return out


def remote_heal(child, mid, start_children, local, hold):
    """[remote:heal]: a pipelined store at 1,000 x 10,000 on ``child``;
    after cycle 2 (a solve in flight) the child is killed and
    ``start_children()`` starts the next ones; the client is pointed at
    the first of them.  The lost reply re-places its rows, the restarted
    child's first frame is full, deltas resume, every pod binds, and the
    binds equal ``local``, a local pipelined run that loses the same
    reply."""
    import os

    from volcano_tpu_torch.solver_service import RemoteSolver

    client = RemoteSolver(child.address(), timeout=600)
    # The child's solves so far: cycle 2's solve is the third after them;
    # its reply is held, so the kill leaves it unsent.
    base = client.ping()["solves"]
    with open(hold, "w") as f:
        f.write(str(base + 3))
    fresh = []

    def between(step):
        if step == 2:
            child.kill()
            os.unlink(hold)
            fresh.extend(start_children())
            host, _, port = fresh[0].address().rpartition(":")
            client.host, client.port = host, int(port)

    recs = remote_sequence("remote:heal", _mid_store(mid), mid[1], 6,
                           pipelined=True, client=client, between=between,
                           drain=2)
    kinds = [r["frame"] for r in recs]
    lost = [r["drops"].get("lost-reply", 0) for r in recs]
    if lost[3] < 1 or kinds[3] != "full" or "delta" not in kinds[4:]:
        raise AssertionError(f"[remote:heal] lost {lost}, kinds {kinds}")
    if client.wire_fallbacks.get("reconnect", 0) < 1:
        raise AssertionError(f"[remote:heal] {client.wire_fallbacks}")
    _same_hashes("remote:heal", recs, local,
                 "the local run losing the same reply")
    client.close()
    return {"kinds": kinds, "lost_reply": lost,
            "fallbacks": dict(client.wire_fallbacks)}, fresh


def remote_pool(children, mid, hold, lost_local):
    """[remote:pool]: two children on the one card (the mechanism, not
    multi-card scale): a pool of one against a single client; a hedge
    forced by a held primary; the what-if offload on BASELINE config 4 at
    1,000 nodes against the local what-if; failover after the primary is
    killed."""
    import os

    from volcano_tpu_torch.cache import FakeBinder, FakeEvictor
    from volcano_tpu_torch.metrics import metrics
    from volcano_tpu_torch.sim import ClusterSimulator
    from volcano_tpu_torch.solver_pool import SolverPool
    from volcano_tpu_torch.solver_service import RemoteSolver
    from volcano_tpu_torch.synth import preempt_cluster

    addrs = [c.address() for c in children]
    out = {}
    local = remote_sequence("remote:pool:local", _mid_store(mid), mid[1],
                            10, pipelined=True, drain=2, log=False)
    # A pool of one against the single client: binds, frames, bytes.
    pool = SolverPool(addrs[:1], size=1, timeout=600)
    one = remote_sequence("remote:pool:one", _mid_store(mid), mid[1], 5,
                          pipelined=True, client=pool, log=False)
    single = RemoteSolver(addrs[0], timeout=600)
    ref = remote_sequence("remote:pool:single", _mid_store(mid), mid[1], 5,
                          pipelined=True, client=single, log=False)
    if [(r["binds"], r["frame"], r["frame_bytes"]) for r in one] != \
            [(r["binds"], r["frame"], r["frame_bytes"]) for r in ref] or \
            dict(pool.frame_counts) != dict(single.frame_counts) or \
            dict(pool.frame_bytes) != dict(single.frame_bytes):
        raise AssertionError("[remote:pool] a pool of one differs from the "
                             "single client")
    out["one"] = {"frames": dict(pool.frame_counts),
                  "frame_bytes": dict(pool.frame_bytes)}
    pool.close()
    single.close()
    # Hedging: child 1 holds its replies while the hold file exists; after
    # 6 cycles (samples for the rolling p99) the routing is steered to it
    # (the other replica's latency score raised), so the next dispatch is
    # held and the fetch hedges to child 0.
    restores = [_env("VOLCANO_TPU_POOL_HEDGE_MIN_MS", "200"),
                _env("VOLCANO_TPU_POOL_HEDGE_P99_MULT", "3")]
    try:
        pool = SolverPool(addrs, timeout=600)

        def steer(step):
            if step == 5:
                open(hold, "w").close()  # every solve of child 1 held
                with pool._lock:
                    pool.replicas[0].ewma_ms = 1.0e9
            if step == 7:
                # Past the hedged fetch of cycle 7; the held reply drains.
                os.unlink(hold)

        hedged = remote_sequence("remote:pool:hedge", _mid_store(mid),
                                 mid[1], 10, pipelined=True, client=pool,
                                 between=steer, drain=2)
        snap = pool.health_snapshot()
        for r in pool.replicas:
            pool._drain(r, block=True)
        if snap["hedge_dispatches"] < 1 or snap["hedge_wins"] < 1:
            raise AssertionError(f"[remote:pool] no hedge won: {snap}")
        if pool.wire_fallbacks.get("abandon", 0):
            raise AssertionError(f"[remote:pool] {pool.wire_fallbacks}")
        _same_hashes("remote:pool", hedged, local,
                     "the local pipelined run")
        out["hedge"] = {k: snap[k] for k in (
            "hedge_dispatches", "hedge_wins", "failovers")}
        out["hedge"]["frames"] = pool.per_replica_frames()
        out["hedge"]["wait_ms"] = [r["wait_ms"] for r in hedged]
        pool.close()
    finally:
        for restore in restores:
            restore()
        if os.path.exists(hold):
            os.unlink(hold)
    # The what-if offload: BASELINE config 4 at 1,000 nodes, pipelined.
    restore = _env("VOLCANO_TPU_EVICT_DEVICE", "1")
    try:
        def config4(pool_):
            _reset_uids()
            store = preempt_cluster(n_nodes=1000, fill_per_node=4,
                                    n_pending=2000, gang_size=4, seed=0)
            store.pipeline = True
            if pool_ is not None:
                store.remote_solver = pool_
            sched = _remote_sched(store, CONF_PREEMPT)
            sim = ClusterSimulator(store, grace_steps=2)
            recs = []
            for _ in range(6):
                sched.run_once()
                store.flush_binds()
                recs.append((_binds_hash(store.binder.binds),
                             sorted(store.evictor.evicts)))
                sim.step()
            plans = store.migrations.committed_plans \
                if store.migrations is not None else 0
            store.close()
            return recs, plans

        def whatifs():
            return sum(v for k, v in metrics.solver_pool_dispatch.data.items()
                       if dict(k).get("kind") == "whatif")

        want, want_plans = config4(None)
        pool = SolverPool(addrs, timeout=600)
        w0 = whatifs()
        got, got_plans = config4(pool)
        offloaded = whatifs() - w0
        pool.close()
    finally:
        restore()
    if got != want or got_plans != want_plans or got_plans < 1 \
            or offloaded < 1:
        raise AssertionError(
            f"[remote:pool] what-if offload: plans {got_plans} against "
            f"{want_plans}, {offloaded} offloaded, evictions equal "
            f"{[a[1] == b[1] for a, b in zip(got, want)]}")
    out["whatif"] = {"offloaded": offloaded, "plans": got_plans,
                     "evictions": [len(r[1]) for r in got]}
    # Failover: the primary killed with a solve in flight.
    pool = SolverPool(addrs, timeout=600)
    killed = []

    def kill(step):
        if step == 2:
            prim = pool.health_snapshot()["primary"]
            killed.append(prim)
            children[prim].kill()

    fail = remote_sequence("remote:pool:failover", _mid_store(mid), mid[1],
                           6, pipelined=True, client=pool, between=kill,
                           drain=2)
    snap = pool.health_snapshot()
    lost = [r["drops"].get("lost-reply", 0) for r in fail]
    # The reply in flight at the kill is lost (its fetch fails) unless the
    # child had sent it; then the next send fails over without a loss, or
    # the one after is lost.  The binds must equal a local run losing the
    # same reply, or none.
    at = [i for i, n in enumerate(lost) if n]
    if len(at) > 1 or snap["failovers"] < 1 \
            or snap["primary"] == killed[0]:
        raise AssertionError(f"[remote:pool] failover {snap}, lost {lost}")
    if at != [3]:
        lost_local = remote_sequence(
            "remote:pool:local-lost", _mid_store(mid), mid[1], 6,
            pipelined=True, drain=2, lose_fetch=at[0] if at else None,
            log=False)
    _same_hashes("remote:pool", fail, lost_local,
                 "a local run losing the same reply")
    out["failover"] = {"failovers": snap["failovers"], "lost_reply": lost,
                       "killed": killed[0]}
    pool.close()
    return out, killed[0]


def remote_phases(ns_hashes=None, big=(10000, 100000), mid=(1000, 10000)):
    """Phases 38-41, the solver service on the card.  ``ns_hashes``: the
    binds' hashes of phase 6's cold and first 5 steady cycles (None: a
    local run here gives them).  Returns the [remote] child's first-launch
    rows (``REMOTE_KERNELS`` against their plain versions) and its
    launches."""
    import os
    import tempfile

    seconds = {}
    t_all = time.perf_counter()
    kids = []

    def start(*labels_args):
        new = [_SolverChild(label, *args) for label, args in labels_args]
        kids.extend(new)
        return new

    tmp = tempfile.mkdtemp(prefix="remote-hold-")
    hold = os.path.join(tmp, "hold")
    try:
        c1, c2 = start(("remote:child1", ()),
                       ("remote:child2", ("--hold-file", hold)))
        if ns_hashes is None:
            _log("[remote] the local reference: phase 6's cold and steady "
                 "cycles")
            store = _fresh_cluster(n_nodes=big[0], n_pods=big[1],
                                   gang_size=8, zones=16, seed=0)
            ns_hashes = [r["binds"] for r in remote_sequence(
                "remote:local", store, big[1], 6, log=False)]
            store.close()
        t0 = time.perf_counter()
        main_out = remote_main(c1, big, ns_hashes)
        res1 = c1.stop()
        seconds["remote"] = time.perf_counter() - t0
        missing = [k for k in REMOTE_KERNELS
                   if not res1["launches"].get(k)
                   and not (k == "static_planes"
                            and res1["launches"].get(FUSED_STATIC))]
        if missing or res1["build_s"] != 0.0:
            raise AssertionError(f"[remote] the child's launches "
                                 f"{res1['launches']} (never: {missing}), "
                                 f"build {res1['build_s']} s")
        _log(f"[remote] child launches {json.dumps(res1['launches'])}, "
             f"solves {res1['solves']}, build {res1['build_s']} s (the "
             f"parent's library); the scheduler process launched nothing")
        for r in res1["first_launch"]:
            _log(f"[kernels:remote] {r['name']}: {r['ms']:.4f} ms/launch "
                 f"on the child's first-launch inputs, plain "
                 f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms, "
                 f"launches {r['launches']}, max_abs_err "
                 f"{r['max_abs_err']}")
        _log(f"[remote] {json.dumps({k: main_out[k] for k in ('frames', 'frame_bytes', 'fallbacks')})}")

        t0 = time.perf_counter()
        shm_out = remote_shm(c2, mid)
        seconds["remote:shm"] = time.perf_counter() - t0
        _log(f"[remote:shm] binds equal the TCP lane's and the local "
             f"cycles'; {json.dumps(shm_out)}")

        t0 = time.perf_counter()
        lost_local = remote_sequence("remote:local-lost", _mid_store(mid),
                                     mid[1], 6, pipelined=True, drain=2,
                                     lose_fetch=3, log=False)
        heal_out, fresh = remote_heal(c2, mid, lambda: start(
            ("remote:child3", ()),
            ("remote:child4", ("--hold-file", hold))), lost_local, hold)
        seconds["remote:heal"] = time.perf_counter() - t0
        _log(f"[remote:heal] the lost reply re-placed, the restarted "
             f"child's first frame full, binds equal the local run losing "
             f"the same reply; {json.dumps(heal_out)}")

        t0 = time.perf_counter()
        pool_out, killed = remote_pool(fresh, mid, hold, lost_local)
        seconds["remote:pool"] = time.perf_counter() - t0
        _log(f"[remote:pool] two children on one card (the mechanism, not "
             f"multi-card scale): {json.dumps(pool_out)}")
        survivor = fresh[1 - killed].stop()
        _log(f"[remote:pool] the surviving child's launches "
             f"{json.dumps(survivor['launches'])}")
    finally:
        for k in kids:
            k.kill()
        if os.path.exists(hold):
            os.unlink(hold)
        os.rmdir(tmp)
    seconds["all"] = time.perf_counter() - t_all
    _log(f"[remote] seconds {json.dumps(seconds)}")
    return res1, main_out


# ------------------------------------------------- 42-44: the control plane

# The kernels a tpuslice job's soft slice term adds to the [control:twin]
# card run, beside the wave solve's (read from the launch counter).
CONTROL_AFF_KERNELS = ("aff_live", "aff_filter")
SERVICE_KERNELS = REMOTE_KERNELS  # rows 1-4, 2a-2c
SERVICE_JOBS = 2000  # of 8 replicas: 16,000 pods
SERVICE_DEADLINE_S = 240.0


def control_twin(n_nodes=1000) -> dict:
    """Phase 42: ``tests/test_torch_fixtures.control_run`` (the CPU tests'
    lockstep script: both example files, a 4-queue mix, a tpuslice job,
    a failed pod and a failed node, AbortJob / ResumeJob, a queue closed
    and opened, a TTL collection and a deletion) at ``n_nodes`` on the
    card and on the CPU: every step's control digest equal, the auditor
    clean after each step (``control_run`` checks)."""
    import volcano_tpu_torch
    from volcano_tpu_torch.ops import kernels

    fixtures = walk_fixtures()
    kernels.reset_launches()
    t0 = time.perf_counter()
    card = fixtures.control_run(volcano_tpu_torch, n_nodes=n_nodes,
                                device=None)
    card_s = time.perf_counter() - t0
    launches = launch_counts()
    t0 = time.perf_counter()
    cpu = fixtures.control_run(volcano_tpu_torch, n_nodes=n_nodes,
                               device="cpu")
    cpu_s = time.perf_counter() - t0
    if [c[0] for c in card] != [c[0] for c in cpu]:
        raise AssertionError("[control:twin] step lists differ")
    for i, ((label, a), (_, b)) in enumerate(zip(card, cpu)):
        if a != b:
            keys = [k for k in a if a[k] != b.get(k)]
            raise AssertionError(
                f"[control:twin] step {i} ({label}): card and CPU differ "
                f"in {keys}")
    need = SOLVE_KERNELS + CONTROL_AFF_KERNELS
    missing = never_launched(launches, need)
    if missing:
        raise AssertionError(f"[control:twin] kernels never launched: "
                             f"{missing}; launches {json.dumps(launches)}")
    final = card[-1][1]
    phases = {}
    for j in final["jobs"].values():
        ph = j["status"]["state"]["phase"]
        phases[ph] = phases.get(ph, 0) + 1
    out = {"nodes": n_nodes, "steps": len(card),
           "pods": len(final["pods"]), "binds": len(final["binds"]),
           "job_phases": phases,
           "retries": {k: j["status"]["retry_count"]
                       for k, j in final["jobs"].items()
                       if j["status"]["retry_count"]},
           "card_s": round(card_s, 3), "cpu_s": round(cpu_s, 3),
           "launches": {k: v for k, v in launches.items() if v}}
    _log(f"[control:twin] card == CPU at every step: {json.dumps(out)}")
    return out


def _get(url, parse=True):
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        body = r.read()
    return r.status, (json.loads(body) if parse else body.decode())


def _cli_out(argv) -> str:
    import contextlib
    import io

    from volcano_tpu_torch.cli.main import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if cli_main(argv) != 0:
            raise AssertionError(f"vtpuctl {argv} failed")
    return out.getvalue()


def service_invariants(store, expect: dict) -> dict:
    """Every job of ``expect`` (key -> replicas) with all its pods Running
    on a node, no node over its allocatable CPU, memory or pod slots, no
    pod lost."""
    from volcano_tpu_torch.api import Resource

    with store._lock:
        pods = list(store.pods.values())
        nodes = {n: ni for n, ni in store.nodes.items()}
    by_job, per_node = {}, {}
    for p in pods:
        by_job.setdefault(p.owner_job, []).append(p)
        if p.node_name:
            r = Resource.empty()
            for c in p.containers:
                r.add(Resource.from_resource_list(c))
            acc = per_node.setdefault(p.node_name, [0.0, 0.0, 0])
            acc[0] += r.milli_cpu
            acc[1] += r.memory
            acc[2] += 1
    for key, n in expect.items():
        got = by_job.get(key, [])
        if len(got) != n or any(p.phase != "Running" or not p.node_name
                                for p in got):
            raise AssertionError(f"[control:service] job {key}: "
                                 f"{len(got)} pods, not all Running")
    if len(pods) != sum(expect.values()):
        raise AssertionError(f"[control:service] {len(pods)} pods, "
                             f"expected {sum(expect.values())}")
    for name, (cpu, mem, cnt) in per_node.items():
        alloc = nodes[name].allocatable
        if cpu > alloc.milli_cpu or mem > alloc.memory:
            raise AssertionError(f"[control:service] node {name} over "
                                 f"its allocatable")
        slots = nodes[name].node.allocatable.get("pods")
        if slots is not None and cnt > int(slots):
            raise AssertionError(f"[control:service] node {name} pod "
                                 f"slots exceeded")
    return {"pods": len(pods), "nodes_used": len(per_node)}


def control_service(n_jobs=SERVICE_JOBS, replicas=8,
                    n_nodes=10000) -> tuple:
    """Phase 43: the daemon on the card at full width: ``Service(simulate=
    True)`` over the north-star nodes (10,000 nodes, 16 zones) with the
    deployed conf from a file, ``start(http_port=0)``; 4 queues created
    over HTTP, ``n_jobs`` jobs of ``replicas`` submitted through the
    admitted store, the two example files through ``python -m
    volcano_tpu_torch.cli job run -f`` in children; a bounded wait until
    every job is Running.  Returns (stats, kernel rows: the wave solve's
    kernels' first launches in this process against their plain
    versions)."""
    import os
    import subprocess
    import tempfile

    import numpy as np

    from volcano_tpu_torch.client import Client
    from volcano_tpu_torch.controllers import Job, TaskSpec
    from volcano_tpu_torch.framework import DEPLOYED_SCHEDULER_CONF
    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.service import Service
    from volcano_tpu_torch.synth import synthetic_cluster

    t_build = time.perf_counter()
    store = synthetic_cluster(n_nodes=n_nodes, n_pods=0, gang_size=8,
                              zones=16, seed=0)
    build_s = time.perf_counter() - t_build
    conf = tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False)
    conf.write(DEPLOYED_SCHEDULER_CONF)
    conf.close()
    kernels.reset_launches()
    kernels.CAPTURE = {}
    svc = Service(store=store, simulate=True, conf_path=conf.name,
                  schedule_period=0.05, controller_period=0.02)
    port = svc.start(http_port=0)
    url = f"http://127.0.0.1:{port}"
    stats = {"nodes": n_nodes, "jobs": n_jobs, "replicas": replicas,
             "store_build_s": round(build_s, 3)}
    try:
        client = Client(url)
        queues = [("sq1", 1), ("sq2", 2), ("sq4", 4), ("sq8", 8)]
        for name, w in queues:
            client.create_queue(name, weight=w)
        expect = {}
        submitted = {}
        rng = np.random.default_rng(0)
        jobs = [Job(name=f"sj{j}", min_available=replicas,
                    queue=queues[j % 4][0],
                    tasks=[TaskSpec(name="worker", replicas=replicas,
                                    containers=[{
                                        "cpu": str(int(rng.choice([1, 2, 4]))),
                                        "memory": "4Gi"}])])
                for j in range(n_jobs)]
        t0 = time.perf_counter()
        # One burst: the store lock held across the admissions, so the
        # daemon's threads see every job at once (one at a time beside
        # the running daemon, each admission waits its turn at the store
        # lock and the interpreter: 20-30 ms a job).
        with svc.store._lock:
            for job in jobs:
                svc.admitted.add_batch_job(job)
                submitted[job.key] = time.perf_counter()
                expect[job.key] = replicas
        stats["submit_s"] = round(time.perf_counter() - t0, 3)
        repo = os.path.dirname(os.path.abspath(__file__))
        kids = [subprocess.Popen(
            [sys.executable, "-m", "volcano_tpu_torch.cli", "--server", url,
             "job", "run", "-f", os.path.join(repo, "examples", f)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=repo) for f in ("job.yaml", "tensorflow-dist.yaml")]
        for k, f in zip(kids, ("default/test-job", "default/dist-mnist")):
            out, err = k.communicate(timeout=180)
            if k.returncode != 0 or "successfully" not in out:
                raise AssertionError(f"[control:service] vtpuctl job run "
                                     f"-f failed: {err[-2000:]}")
            submitted[f] = time.perf_counter()
        expect["default/test-job"] = 6
        expect["default/dist-mnist"] = 3
        running_at = {}
        deadline = t0 + SERVICE_DEADLINE_S
        while time.perf_counter() < deadline:
            now = time.perf_counter()
            for key, job in list(svc.store.batch_jobs.items()):
                if key not in running_at and \
                        job.status.state.phase == "Running" and \
                        job.status.running == expect.get(key, -1):
                    running_at[key] = now
            if len(running_at) == len(expect):
                break
            time.sleep(0.02)
        else:
            raise AssertionError(
                f"[control:service] {len(expect) - len(running_at)} jobs "
                f"not Running after {SERVICE_DEADLINE_S} s")
        all_s = max(running_at.values()) - t0
        per_job = np.array([1e3 * (running_at[k] - submitted[k])
                            for k in expect])
        stats.update({
            "submit_to_all_running_s": round(all_s, 3),
            "job_submit_to_running_ms": {
                "p50": float(np.percentile(per_job, 50)),
                "p99": float(np.percentile(per_job, 99)),
                "max": float(per_job.max())}})
        # The endpoints, while the daemon runs.
        code, text = _get(url + "/healthz", parse=False)
        if (code, text) != (200, "ok"):
            raise AssertionError(f"[control:service] /healthz {code}")
        code, text = _get(url + "/metrics", parse=False)
        fams = sorted({ln.split()[2] for ln in text.splitlines()
                       if ln.startswith("# TYPE volcano_")})
        if not fams:
            raise AssertionError("[control:service] /metrics: no volcano_ "
                                 "family")
        _, health = _get(url + "/debug/health")
        _, cycles = _get(url + "/debug/cycles")
        uid = next(p.uid for p in list(svc.store.pods.values())
                   if p.owner_job == "default/sj0")
        code, timeline = _get(f"{url}/debug/pods/{uid}")
        _, trace = _get(url + "/debug/trace?cycles=4")
        if health["status"] != "ok" or not cycles or \
                timeline["why_pending"] != "bound" or \
                not trace["traceEvents"]:
            raise AssertionError(
                f"[control:service] /debug: health {health['status']}, "
                f"{len(cycles)} cycles, pod {timeline.get('why_pending')}, "
                f"{len(trace['traceEvents'])} trace events")
        listing = _cli_out(["--server", url, "job", "list"])
        view = _cli_out(["--server", url, "job", "view", "--name",
                         "dist-mnist"])
        if len(listing.splitlines()) != len(expect) + 1 or \
                not view.startswith("name: dist-mnist"):
            raise AssertionError("[control:service] job list / view")
        stats["endpoints"] = {"metrics_families": len(fams),
                              "debug_cycles": len(cycles),
                              "trace_events": len(trace["traceEvents"]),
                              "job_list_lines": len(listing.splitlines()),
                              "job_view_lines": len(view.splitlines())}
        stats["waiting"] = _waiting_gang(svc, client, n_nodes, expect)
    finally:
        svc.stop()
        os.unlink(conf.name)
    launches = launch_counts()
    captured, kernels.CAPTURE = kernels.CAPTURE, None
    stats.update(service_invariants(svc.store, expect))
    recs = svc.store.flight.recent()
    busy = [r for r in recs if r.pods_bound or r.pods_considered]
    stats["cycles"] = {
        "recorded": len(recs), "placing": len(busy),
        "placing_wall_ms": [round(r.duration_s * 1e3, 3) for r in busy],
        "pods_bound": [r.pods_bound for r in busy],
        "lanes_ms": [{k: round(v * 1e3, 3) for k, v in r.lanes.items()}
                     for r in busy[:6]]}
    missing = never_launched(launches, SERVICE_KERNELS)
    if missing:
        raise AssertionError(f"[control:service] kernels never launched "
                             f"in the service process: {missing}")
    stats["launches"] = {k: v for k, v in launches.items() if v}
    audit_checked("control:service", svc.store, quiet=True)
    rows = replay_kernels(captured, launches, reps=5,
                          names=SERVICE_KERNELS)
    _log(f"[control:service] {json.dumps(stats)}")
    for r in rows:
        _log(f"[kernels:service] {r['name']}: {r['ms']:.4f} ms/launch on "
             f"its first service inputs, plain {r['plain_ms']:.4f} ms, "
             f"max_abs_err {r['max_abs_err']}, launches {r['launches']}")
    return stats, rows


def _bounded(cond, what, timeout=120.0):
    """Poll ``cond()`` until it holds; raise after ``timeout`` s."""
    deadline = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() > deadline:
            raise AssertionError(f"[control:service] {what} not within "
                                 f"{timeout} s")
        time.sleep(0.005)


def _waiting_gang(svc, client, n_nodes, expect, n_delete=8) -> dict:
    """A gang waiting for capacity while users delete jobs: its pods
    select zone-0 (``n_nodes`` / 16 nodes) and outnumber them, so they
    stay Pending cycle after cycle (the same rows: the encode cache
    holds); each deletion frees a few nodes, and the next solve re-ranks
    only their node blocks (``warm_shortlist``).  The gang and the
    deleted jobs leave ``expect``."""
    from volcano_tpu_torch.controllers import Job, TaskSpec
    from volcano_tpu_torch.ops import devincr, kernels

    store = svc.store
    n = n_nodes // 16 + 8
    svc.admitted.add_batch_job(Job(
        name="waiting", min_available=n, queue="sq8",
        tasks=[TaskSpec(name="worker", replicas=n,
                        node_selector={"zone": "zone-0"},
                        containers=[{"cpu": "48", "memory": "4Gi"}])]))

    def waiting_pods():
        return [p for p in list(store.pods.values())
                if p.owner_job == "default/waiting"]

    _bounded(lambda: len(waiting_pods()) == n, "the waiting gang's pods")
    warm0 = kernels.LAUNCHES["warm_shortlist"]
    counts0 = dict(devincr.of_store(store).counts)
    for j in range(n_delete):
        seq0 = store.flight.last().seq
        client.delete_job(f"sj{j}")
        expect.pop(f"default/sj{j}")
        _bounded(lambda: store.flight.last().seq >= seq0 + 2,
                 "two cycles after a deletion")
    counts = {k: v - counts0.get(k, 0)
              for k, v in devincr.of_store(store).counts.items()}
    out = {"replicas": n, "deleted": n_delete,
           "warm_launches": kernels.LAUNCHES["warm_shortlist"] - warm0,
           "devincr_modes": counts,
           "bound": sum(1 for p in waiting_pods() if p.node_name)}
    client.delete_job("waiting")
    _bounded(lambda: not waiting_pods() and not any(
        p.owner_job.startswith("default/sj") and p.owner_job not in expect
        for p in list(store.pods.values())), "the deleted jobs' pods gone")
    if out["bound"]:
        raise AssertionError(f"[control:service] the waiting gang bound "
                             f"{out['bound']} pods")
    return out


def _config1_once(**svc_kw) -> tuple:
    """BASELINE config 1 as ``bench.py:630-681`` drives it: the daemon
    with periods 0.01 / 0.005 s, two nodes, a 3-replica gang; returns
    (submit -> 3 pods Running ms, the service)."""
    from volcano_tpu_torch.api import Node
    from volcano_tpu_torch.controllers import Job, TaskSpec
    from volcano_tpu_torch.service import Service

    svc = Service(simulate=True, schedule_period=0.01,
                  controller_period=0.005, **svc_kw)
    for i in range(2):
        svc.store.add_node(Node(name=f"node-{i}", allocatable={
            "cpu": "8", "memory": "16Gi", "pods": 64}))
    job = Job(name="test-job", min_available=3, tasks=[TaskSpec(
        name="worker", replicas=3,
        containers=[{"cpu": "1", "memory": "1Gi"}])])
    svc.start(http_port=0)
    try:
        t0 = time.perf_counter()
        svc.admitted.add_batch_job(job)
        deadline = t0 + 60.0
        while time.perf_counter() < deadline:
            pods = [p for p in list(svc.store.pods.values())
                    if p.owner_job == job.key and p.phase == "Running"]
            if len(pods) >= 3:
                break
            time.sleep(0.002)
        else:
            raise AssertionError("[control:config1] job did not reach "
                                 "Running in 60 s")
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        svc.stop()
    return ms, svc


def control_config1(runs=5) -> dict:
    """Phase 44: config 1, prewarmed, the median of ``runs``; then the
    same job with ``--remote-binder`` / ``--remote-evictor`` /
    ``--remote-status-updater`` at a ``python -m
    volcano_tpu_torch.cache.remote --port 0`` child: the binds and the
    PodGroup status land in the child."""
    import os
    import subprocess

    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.synth import synthetic_cluster

    warm = synthetic_cluster(n_nodes=2, n_pods=3, gang_size=3)
    Scheduler(warm).run_once()
    warm.close()
    times = [_config1_once()[0] for _ in range(runs)]
    out = {"submit_to_3_running_ms": times,
           "median_ms": statistics.median(times)}
    repo = os.path.dirname(os.path.abspath(__file__))
    child = subprocess.Popen(
        [sys.executable, "-m", "volcano_tpu_torch.cache.remote", "--port",
         "0"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=repo)
    try:
        line = child.stdout.readline()
        if "listening" not in line:
            raise AssertionError(f"[control:config1] remote child: {line}")
        url = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
        ms, svc = _config1_once(remote_binder=url, remote_evictor=url,
                                remote_status_updater=url)
        _, binds = _get(url + "/binds")
        _, groups = _get(url + "/podgroups")
        want = {f"default/test-job-worker-{i}" for i in range(3)}
        if set(binds) != want:
            raise AssertionError(f"[control:config1] remote binds {binds}")
        local = {f"{p.namespace}/{p.name}": p.node_name
                 for p in svc.store.pods.values()}
        if any(binds[k] != local[k] for k in want):
            raise AssertionError("[control:config1] a remote bind "
                                 "disagrees with the pod's node")
        if groups.get("default/test-job", {}).get("phase") != "Running":
            raise AssertionError(f"[control:config1] remote PodGroup "
                                 f"status {groups}")
        out["remote_ms"] = ms
        out["remote_binds"] = len(binds)
        out["remote_podgroup"] = groups["default/test-job"]
    finally:
        child.terminate()
        child.wait(timeout=30)
    _log(f"[control:config1] {json.dumps(out)}")
    return out


def control_phases(twin_nodes=1000, service=None) -> tuple:
    """Phases 42-44; returns ([control:service]'s kernel rows, each
    group's seconds).  ``service``: ``control_service``'s keywords."""
    seconds = {}
    t0 = time.perf_counter()
    control_twin(twin_nodes)
    seconds["42 twin"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _stats, rows = control_service(**(service or {}))
    seconds["43 service"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    control_config1()
    seconds["44 config1"] = time.perf_counter() - t0
    _log(f"[control] seconds {json.dumps(seconds)}")
    return rows, seconds


def _same_records(label, a, b, what, fields=4):
    """Per-cycle records equal field by field: tuples of (binds, phases,
    mirror, fallback), their first ``fields``, or dicts (``walk_run``'s)."""
    if len(a) != len(b):
        raise AssertionError(f"[{label}] {what}: cycle counts differ")
    for i, (x, y) in enumerate(zip(a, b)):
        pairs = ([(k, x[k], y[k]) for k in x] if isinstance(x, dict) else
                 list(zip(("binds", "phases", "mirror", "fb"),
                          x, y))[:fields])
        for name, p, q in pairs:
            if p != q:
                raise AssertionError(f"[{label}] {what}: cycle {i} {name} "
                                     f"differ" + (f": {p} != {q}"
                                                  if name == "fb" else ""))


def main(argv=()) -> int:
    import os

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_script = time.perf_counter()
    # No phase may turn a failing kernel into a passing cycle.
    os.environ["VOLCANO_TPU_FALLBACK"] = "never"
    import numpy as np

    from volcano_tpu_torch import interop
    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.ops.wave import solve_wave
    from volcano_tpu_torch.synth import (solve_args_from_store,
                                         synthetic_cluster)

    card = _smi()
    _log(f"card: {card}")
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    kernels.load()
    _log(f"kernel build {time.perf_counter() - t0:.3f} s "
         f"(nvcc {kernels.BUILD_SECONDS:.3f} s)")
    if list(argv) == ["seq-trace"]:
        # [seq:trace] alone: its trace on the last line of the output.
        print(json.dumps(seq_trace()), flush=True)
        return 0
    # The children of [crash:sticky], [lockdep] and [trace-dir].
    if list(argv) == ["crash-sticky"]:
        crash_sticky_child()  # exits the process
    if argv[:1] == ["lockdep"] and len(argv) == 2:
        print(LOCKDEP_MARK + json.dumps(lockdep_child(argv[1])), flush=True)
        return 0
    if list(argv) == ["trace-dir"]:
        print(TRACE_MARK + json.dumps(trace_dir_child()), flush=True)
        return 0
    # The solver child of phases 38-41.
    if argv[:1] == ["solver-child"]:
        solver_child(list(argv[1:]))
        return 0
    _log(f"ptxas {json.dumps(ptxas_report())}")
    _log(f"[kernels:floor] empty kernel, device ms a launch "
         f"{json.dumps(launch_floor())}")
    if list(argv) == ["pipeline"]:
        # The [pipeline] phase alone, with its own synchronous reference.
        pstats, prows = pipeline_phase()
        for r in prows:
            _log(f"[kernels:pipeline] {json.dumps(r)}")
        print(card, flush=True)
        return 0
    if list(argv) == ["obs"]:
        # The [obs] and [ha] phases alone, on a north-star store of their
        # own (checkpointed, then its cold cycle: the binds to hold).
        import tempfile

        from volcano_tpu_torch.framework import DEPLOYED_SCHEDULER_CONF
        from volcano_tpu_torch.scheduler import Scheduler

        store = _fresh_cluster(n_nodes=10000, n_pods=100000, gang_size=8,
                               zones=16, seed=0)
        with tempfile.TemporaryDirectory() as d:
            ckpt = save_checkpoint(store, d)
            Scheduler(store, conf_str=DEPLOYED_SCHEDULER_CONF).run_once()
            binds = dict(store.binder.binds)
            store.close()
            del store
            _log(f"[obs] {json.dumps(obs_phase(ckpt, binds))}")
        ha_gate_phase()
        print(card, flush=True)
        return 0
    if list(argv) == ["single-phase"]:
        # Phases 32-34 alone, on north-star solve args of their own.
        steer_row, single_rows = single_phase_phases()
        _log(f"[kernels:single] {json.dumps(single_rows)}")
        _log(f"[kernels:steer] {json.dumps(steer_row)}")
        print(card, flush=True)
        return 0
    if list(argv) == ["host-walk"]:
        # Phases 35-37 alone.
        host_walk_phases()
        print(card, flush=True)
        return 0
    if list(argv) == ["remote"]:
        # Phases 38-41 alone, against a local north-star run of their own.
        remote_phases()
        print(card, flush=True)
        return 0
    if list(argv) == ["control"]:
        # Phases 42-44 alone.
        control_phases()
        print(card, flush=True)
        return 0
    if list(argv) == ["recovery"]:
        # Phases 24-31 alone, [lockdep] against a synchronous cold cycle
        # of its own.
        from volcano_tpu_torch.framework import DEPLOYED_SCHEDULER_CONF
        from volcano_tpu_torch.scheduler import Scheduler

        store = _fresh_cluster(n_nodes=10000, n_pods=100000, gang_size=8,
                               zones=16, seed=0)
        Scheduler(store, conf_str=DEPLOYED_SCHEDULER_CONF).run_once()
        cold_hash = _binds_hash(store.binder.binds)
        store.close()
        del store
        recovery_phases(cold_hash)
        print(card, flush=True)
        return 0

    # Seconds of each phase group (the [phases] line).
    phase_s = {}
    t_phase = time.perf_counter()
    # 1. small reference: the card against the CPU plain versions.
    store = synthetic_cluster(n_nodes=64, n_pods=512, gang_size=4,
                              n_queues=2, zones=4, seed=3)
    a_gpu, _ = solve_args_from_store(store, binpack=True, nodeorder=True)
    a_cpu, _ = solve_args_from_store(store, binpack=True, nodeorder=True,
                                     device="cpu")
    r_gpu = interop.result_to_numpy(solve_wave(*a_gpu, wave=128))
    r_cpu = interop.result_to_numpy(solve_wave(*a_cpu, wave=128,
                                               device="cpu"))
    same_result(r_gpu, r_cpu, "[reference] card vs CPU")
    if int((r_gpu.assigned >= 0).sum()) != 512:
        raise AssertionError("[reference] not every pod placed")
    _log("[reference] 64x512 solve on the card equals the CPU solve")

    phase_s["1 reference"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 2-4. the solve path at the north-star shape.
    t0 = time.perf_counter()
    ns_store = _fresh_cluster(n_nodes=10000, n_pods=100000, gang_size=8,
                              zones=16, seed=0)
    _log(f"[main] north-star cluster {time.perf_counter() - t0:.3f} s")
    main_stats, launches, captured = run_phase("main", lambda: ns_store,
                                               timed=3)
    _log(f"[main] north-star solve median {main_stats['solve_s_median']:.4f}"
         f" s, pods bound {main_stats['pods_bound']}, card {card}")
    _log(f"[main] first-launch shapes {json.dumps(first_shapes(captured))}")
    solve_names = SOLVE_KERNELS
    solve_rows = replay_kernels(captured, launches, names=solve_names)
    # The first fallback launch (all N nodes: tiles and a merge).
    fb_row = _replay_rows(captured, launches, "solve",
                          ["rank_candidates:fallback"])[0]
    for r in solve_rows:
        _log(f"[kernels:solve] {r['name']}: {r['ms']:.4f} ms/launch on the "
             f"device (queued {r['queued']}), wrapper host "
             f"{r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms "
             f"(queued {r['plain_queued']}), bound {r['bound_ms']:.6f} ms "
             f"({r['bound_by']}), launches {r['launches']}")
    # Device time per solve from the trace of one north-star solve,
    # against the median wall time of the untraced solves.
    wall_ms = 1e3 * main_stats["solve_s_median"]
    prof = main_stats["profile"]
    for r in solve_rows:
        r["solve_ms"] = prof["kernels_ms"][r["name"]] if prof else None
    if prof:
        kern = sum(prof["kernels_ms"][k] for k in solve_names)
        _log(f"[main] traced solve: device busy {prof['busy_ms']:.3f} ms of "
             f"{prof['wall_ms']:.3f} ms wall; the four kernels "
             f"{kern:.3f} ms = {100.0 * kern / wall_ms:.2f}% of the median "
             f"untraced wall time {wall_ms:.3f} ms; device idle share "
             f"{100.0 * (1 - prof['busy_ms'] / prof['wall_ms']):.2f}%; per "
             f"function (ms / launches) {_traced_sums(prof)}")
    else:
        _log("[main] traced solve: no device events in the trace "
             "(device time per solve not measured)")

    # The [main] solve args, kept for the sequential solve of phase 22.
    ns_args, _ = solve_args_from_store(ns_store, binpack=True,
                                       nodeorder=True)

    phase_s["2-4 solve"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 5. features: taints, selectors, node affinity, finite deserved.
    gib = float(2 ** 30)
    feat_stats, feat_launches, feat_cap = run_phase(
        "features", lambda: feature_store(1000, 10000, seed=1),
        deserved=[[8.0e6, 32000 * gib], [6.0e6, 24000 * gib]],
    )
    replay_kernels(feat_cap, feat_launches, reps=3, names=solve_names)
    if feat_stats["pods_bound"] >= 10000 or feat_stats["pods_bound"] == 0:
        raise AssertionError("[features] overuse gating did not bind")
    _log("[features] kernels match their plain versions")

    phase_s["5 features"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 6. the cycle: Scheduler(store).run_once() on the north-star store,
    # checkpointed first (the [ha] round trip of 8c-8d loads it).
    import tempfile

    ckpt_dir = tempfile.TemporaryDirectory()
    ckpt = save_checkpoint(ns_store, ckpt_dir.name)
    kernels.CAPTURE = {}
    kernels.reset_launches()
    cyc_stats, _rec, _sched = run_cycle("cycle", ns_store, 100000,
                                        trace=True)
    cyc_launches = launch_counts()
    cyc_captured, kernels.CAPTURE = kernels.CAPTURE, None
    # The cold and first 5 steady cycles' binds: [remote]'s reference.
    ns_hashes = [_binds_hash(r[0]) for r in _rec[:6]]
    _log(f"[cycle] launches {json.dumps(cyc_launches)}")
    missing = never_launched(cyc_launches, CYCLE_KERNELS)
    if missing:
        raise AssertionError(f"[cycle] kernels never launched: {missing}")
    _log(f"[cycle] static planes: {cyc_launches['static_planes']} launches "
         f"of their own, {cyc_launches[FUSED_STATIC]} built in a shortlist "
         f"launch; per cycle (own, in a shortlist launch, misses) "
         f"{[c['static_planes'] + [c['static_builds']] for c in cyc_stats['cycles']]}")
    upd = cyc_stats["update"]
    _log(f"[cycle] update_node delta: node_planes host ms "
         f"{upd['node_planes_host_ms']}, {upd['delta_chunks']} chunks, "
         f"{upd['scatter_launches']} scatter launches, "
         f"{upd['plane_uploads']} planes re-uploaded whole; device "
         f"operations of node_planes (traced update cycle) "
         f"{upd.get('traced_device_ops')}")
    cprof = cyc_stats.pop("profile")
    _log(f"[cycle] {json.dumps(cyc_stats)}")
    if cprof:
        _log(f"[cycle] traced steady cycle: device busy "
             f"{cprof['busy_ms']:.3f} ms of {cprof['wall_ms']:.3f} ms "
             f"wall, device idle share "
             f"{100.0 * (1 - cprof['busy_ms'] / cprof['wall_ms']):.2f}%, "
             f"kernels(ms) {json.dumps(cprof['kernels_ms'])}, "
             f"other {cprof['other_ms']:.3f} ms, top "
             f"{json.dumps(cprof['top'])}")
    else:
        _log("[cycle] traced steady cycle: no device events in the trace "
             "(idle share not measured)")

    phase_s["6 cycle"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 7. lanes on against lanes off, at 1,000 x 10,000.
    lanes_on_off(1000, 10000)

    phase_s["7 lanes"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 8. every kernel of the cycle against its plain version, timed; the
    # static planes as their share of the shortlist launch that built them.
    rows = replay_kernels(cyc_captured, cyc_launches, names=CYCLE_KERNELS)
    for r in rows:
        if r["name"] == "scatter_rows":
            r.update(scatter_one_plane_ms(cyc_captured["scatter_rows"]))
        if r["name"] == "static_planes":
            # The row form builds the planes in its own launch: the
            # north-star solve's (phase 2) launch against the pair.
            r["in_launch"] = static_share(captured["coarse_shortlist"])
            r["in_launch_launches"] = launches[FUSED_STATIC]
    by_solve = {r["name"]: r for r in solve_rows}
    for r in rows:
        if cprof:
            r["cycle_ms"] = cprof["kernels_ms"][r["name"]]
        if r["name"] == "static_planes":
            sh = r["in_launch"]
            _log(f"[kernels] static_planes in the row-form shortlist "
                 f"launch {json.dumps(sh['shape'])}: fused "
                 f"{sh['fused_ms']:.5f} ms, planes given "
                 f"{sh['given_ms']:.5f}, own launch {sh['own_ms']:.5f}, "
                 f"pair {sh['pair_ms']:.5f}; device ops fused "
                 f"{sh['device_ops_fused']}, pair {sh['device_ops_pair']}")
        if r["name"] == "scatter_rows":
            _log(f"[kernels] scatter_rows: {r['planes']} planes x "
                 f"{r['rows']} rows in one launch {r['ms']:.5f} ms; "
                 f"one-plane launches {r['one_plane_launches_ms']:.5f} ms;"
                 f" packed + copied + launched "
                 f"{r['staged_with_copy_ms']:.5f} ms; index_copy_ per "
                 f"plane {r['yardstick_ms']}")
        if r["name"] in by_solve:
            s = by_solve[r["name"]]
            r["solve_path"] = {k: s[k] for k in (
                "launches", "ms", "plain_ms", "bound_ms", "wrapper_ms",
                "solve_ms")}
        _log(f"[kernels] {r['name']}: {r['ms']:.4f} ms/launch on the "
             f"device (queued {r['queued']}), wrapper host "
             f"{r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
             f"library {r['library_ms']}, bound {r['bound_ms']:.6f} ms "
             f"({r['bound_by']}), launches {r['launches']}")

    phase_s["8 kernels"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 8b. the pipelined session: the cycle's kernels launched from the
    # solve worker's stream, held against the [cycle] cold cycle.
    cold_binds = _rec[0][0]
    cold_hash = _binds_hash(cold_binds)
    pstats, prows = pipeline_phase(
        sync_binds=cold_binds,
        sync_launches=cyc_stats["cycles"][0]["launches"])
    del _rec
    cycle_rows = {r["name"]: r for r in rows}
    for r in prows:
        row = cycle_rows[r["name"]]
        row["worker"] = {k: r[k] for k in (
            "launches", "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "wrapper_ms", "queued", "bytes", "ops")}
        _log(f"[kernels:pipeline] {r['name']}: {r['ms']:.4f} ms/launch "
             f"from the worker's inputs, plain {r['plain_ms']:.4f} ms, "
             f"max_abs_err {r['max_abs_err']}, launches {r['launches']}")
    _log(f"[pipeline] {json.dumps(pstats)}")

    phase_s["8b pipeline"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 8c-8d. the default observability at full width (on against off) and
    # HA: the checkpoint round trip, the gated standby.
    _log(f"[obs] {json.dumps(obs_phase(ckpt, cold_binds))}")
    del cold_binds
    ckpt_dir.cleanup()
    ha_gate_phase()

    phase_s["8c-8d obs, ha"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 9-11. the reclaim and preempt paths; victim_scores and the solve
    # kernels on their inputs.
    vs_rows, future_rows = evict_phases()
    by_name = {r["name"]: r for r in rows}
    for r in future_rows:
        by_name[r["name"]]["future"] = {k: r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "wrapper_ms", "queued", "bytes", "ops")}
    vs = dict(vs_rows[-1])
    vs["modes"] = [{k: r[k] for k in ("mode", "V", "ms", "plain_ms",
                                       "bound_ms", "max_abs_err", "bytes")}
                   for r in vs_rows]
    vs["max_abs_err"] = max(r["max_abs_err"] for r in vs_rows)
    rows.append(vs)

    phase_s["9-11 evict"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 12-15. the rebalance lane and the fabric topology path; the three
    # new kernels and the biased ranking on their inputs.
    reb_rows, bias_row = rebalance_phases()
    by_name["rank_candidates"]["fallback"] = {k: fb_row[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
        "wrapper_ms", "queued", "bytes", "ops")}
    by_name["rank_candidates"]["bias"] = {k: bias_row[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
        "wrapper_ms", "queued", "bytes", "ops")}
    rows.extend(reb_rows)

    phase_s["12-15 rebalance"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 16-19. BASELINE config 5 through run_once(); the affinity kernels.
    aff_rows, ext_rows, _astats = affinity_phases()
    for cap, r in ext_rows:
        key = "aff_fallback" if cap.endswith(":fallback") else "affinity"
        by_name[r["name"]][key] = {k: r[k] for k in (
            "launches", "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "wrapper_ms", "queued", "bytes", "ops")}
    rows.extend(aff_rows)

    phase_s["16-19 affinity"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 20-23. the object session: config 2 with the fast path off, the
    # sequential solver (seq_solve), its north-star solve, custom plugins.
    seq_row, extra_rows = object_phases(ns_args)
    for r in extra_rows:
        by_name[r["name"]]["extra"] = {k: r[k] for k in (
            "launches", "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "wrapper_ms", "queued", "bytes", "ops")}
    rows.append(seq_row)

    phase_s["20-23 object"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 24-31. the warm-block knobs, crash recovery, the fallback, lockdep
    # and the per-cycle trace.
    recovery_phases(cold_hash)

    phase_s["24-31 recovery"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 32-34. the single-phase solve and live steering.
    steer_row, single_rows = single_phase_phases(ns_args)
    del ns_args
    fold_single_rows(rows, single_rows)
    rows.append(steer_row)

    phase_s["32-34 single-phase"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 35-37. the host victim walk (VOLCANO_TPU_EVICT_DEVICE=0).
    host_walk_phases()
    phase_s["35-37 host-walk"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 38-41. the solver service: the wave solve in solver children.
    child, _remote = remote_phases(ns_hashes)
    for r in child["first_launch"]:
        by_name[r["name"]]["remote"] = {
            "launches": child["launches"].get(r["name"], 0),
            **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "max_abs_err")}}
    phase_s["38-41 remote"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # 42-44. the control plane: the lockstep twin, the daemon at full
    # width, config 1 (also against a remote side-effect child).
    svc_rows, _control_s = control_phases()
    for r in svc_rows:
        by_name[r["name"]]["service"] = {
            k: r[k] for k in ("launches", "ms", "plain_ms", "bound_ms",
                              "bound_by", "max_abs_err")}
    phase_s["42-44 control"] = time.perf_counter() - t_phase
    _log(f"[phases] seconds {json.dumps(phase_s)}, script "
         f"{time.perf_counter() - t_script:.1f} s")

    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
