#!/usr/bin/env python3
"""Device time of the PyTorch port's kernels on two trees, for comparing a
change with its parent (or two builds of one source) on one card.

Run on a machine with one CUDA card, once per tree and in turns (parent,
change, change, parent), each in its own process:

    python3 tools/port_ab.py --tree path/to/parent --label parent --phase seq
    python3 tools/port_ab.py --tree . --label change --phase seq

``--tree`` is a checkout of the repository (the package
``volcano_tpu_torch`` and ``chip_smoke.py`` at its root); its kernels are
built from its own sources into its own build directory.  ``--phase``
(repeatable) picks what the script measures with that tree's code:

- ``solve``: the north-star solve (``synthetic_cluster(10,000 nodes,
  100,000 pods, gangs of 8, 16 zones)`` through ``solve_wave``): one
  warm-up solve, the median wall time of ``--solves`` (5), and one solve
  traced with ``torch.profiler``;
- ``cold``: BASELINE config 5's cold cycle (``chip_smoke.config5_cluster(
  10,000, 100,000)`` under ``CONF_BASE``): ``--cold`` untraced cycles (1),
  each on a fresh store (wall times, ``device_fine`` lanes), then one
  traced cycle on another fresh store of the same seed;
- ``shortlist``: the block-form shortlist launches captured on their real
  inputs (the north-star store's first ``coarse_shortlist`` and first warm
  ``warm_shortlist``, config 5's cold ``coarse_shortlist``), each checked
  against its plain version and timed by ``chip_smoke.replay_kernels``;
- ``seq``: BASELINE config 2 (``chip_smoke.CONFIG2``: 1,000 nodes x 10,000
  pods) under ``CONF_SEQ``, then again with chip_smoke's device-mask plugin
  and batch scorer (``custom_seq``: every row its own custom-plugin rows):
  a cold ``run_once()`` each, its ``seq_solve`` inputs captured and
  launched ``--reps`` (5) times, each alone between CUDA events (median);
- ``seq-north-star``: the north-star solve arguments through the
  sequential ``ops.allocate.solve``: median host wall of three solves;
- ``seq-trace``: ``--cycles`` (4) cold ``CONF_SEQ`` cycles of config 2,
  each on a fresh store and traced, with CUDA events around every
  ``vtt_seq_solve`` call: whether each trace holds the solve's kernels;
- ``victim``: ``victim_scores`` in both modes at V = 40,000 over 10,000
  nodes (four job priorities, creation ranks a permutation, ties 0..V-1,
  numpy seed 0), checked against its plain version; CUDA events around 20
  queued launches (``chip_smoke._device_ms``), best of two;
- ``kernels``: ``scatter_profile_tables`` and ``gang_block_fit`` on their
  first launches' inputs -- config 5's cold cycle (``config5_cluster(
  10,000, 100,000)``, U 4,096 x E+1 4,097) and the ``[topology]`` cycle 0
  (``fabric_cluster(16, 8, 64)``: 8,192 nodes in 128 blocks) -- checked
  against their plain versions and timed by ``chip_smoke.replay_kernels``;
  the device operations one call puts on the card (a trace); where the
  tree's wrapper takes ``cluster``, ``gang_block_fit`` at cluster sizes
  1, 2, 4, 8 and 16; where the tree has ``chip_smoke.launch_floor``, an
  empty kernel's launch.  Then the north-star solve's row-form
  ``coarse_shortlist`` call without static planes (the planes built on
  the way: the parent's separate launch, or inside the shortlist launch),
  its outputs held to the two-launch form's (``static_planes``, then the
  launch reading them), both timed as above, with the device operations
  of one call.  ``--caps FILE`` keeps the captured inputs: the first run
  captures and writes them, later runs (other trees) load them, so that
  every tree is timed on the same inputs;
- ``steer``: ``aff_steer``'s first computing launch of config 5's cold
  cycle with ``VOLCANO_TPU_AFF_STEER=1`` (``config5_cluster(10,000,
  100,000)``: UM 128 x K 256 over an EW 128 x D 10,016 window), replayed
  computing and gated: held against the plain version, timed by
  ``chip_smoke._device_ms`` (best of two), with the device operations one
  call puts on the card and the bound (``chip_smoke._work``).  ``--caps
  FILE`` as for ``kernels`` (another file);
- ``delta``: one node-table delta of chip_smoke phase 6's shape: the
  north-star store after a cold ``run_once()``, then ``--reps`` (5)
  rounds of ``update_node`` on 100 nodes (half as much CPU again) and a
  ``run_once()``, each timing the host wall of
  ``DeviceSnapshot.node_planes`` (no synchronisation: what the cycle's
  host pays), and one more round with that call traced (its device
  operations);
- ``frag``: the rebalance planner's two kernels on captured inputs --
  ``frag_scores`` from the first plan of ``[rebalance]``
  (``chip_smoke.rebalance_store(5,000)``, its set-up cycle, the 2,500-task
  gang: 16,384 padded nodes, R 2, a 4-row profile table) and
  ``gang_block_fit`` from the ``[topology]`` cycle 0 -- each checked
  against its plain version and timed by ``chip_smoke.replay_kernels``;
  one ``ops.rebalance.frag_scores`` call from the captured planes as
  numpy, with the fetch of its three planes as the tree's planner fetches
  them: the host wall of ``--reps`` (5) x 10 calls (median), and one
  call's device operations and synchronising calls; then one
  ``_plan_rebalance`` call with a topology constraint traced
  (``chip_smoke.plan_trace``).  The helpers (``sync_ops``,
  ``plan_trace``) come from the ``chip_smoke.py`` beside this tool, run
  with the tree's package, so a parent tree without them is measured the
  same way.  ``--caps FILE`` as for ``kernels`` (another file).
- ``worker``: the north-star solve (as ``solve``) through the pieces of
  the pipelined session's solve worker (``volcano_tpu_torch/pipeline.py``),
  in turns forward and backward ``--reps`` (5) times after one warm-up
  call each: on the calling thread (``direct``), on the calling thread
  under a second CUDA stream (``stream``), on a plain second thread
  (``thread``), on the store's solve worker (``worker``: its thread and
  stream, the inputs' owned copies, the packed pinned fetch), and on the
  worker while the calling thread runs pure-Python work until the solve
  is done (``worker_busy``; ``worker_busy_si``: the same with
  ``sys.setswitchinterval(0.0005)``, restored after): host wall of each
  call with its packed result's fetch, and the solve's ``fine_s``; every
  variant's result identical;
- ``pipeline``: ``chip_smoke.pipeline_phase()`` as ``python3 chip_smoke.py
  pipeline`` runs it (its card-against-CPU reference, the north-star
  pipelined script with its own synchronous twin, the pipelined preempt
  plan), summarised: the per-cycle kinds, walls and fetch waits, and the
  traced steady cycle's busy time.  Given before ``seq-trace``, it shows
  whether the traces that follow it keep their device events;
- ``evict``: chip_smoke phases 9 and 10 on the device-native eviction lane
  (``VOLCANO_TPU_EVICT_DEVICE=1``): BASELINE config 4 (``preempt_cluster(
  10,000 nodes, 4 fillers a node, 20,000 pending in gangs of 4, seed 0)``)
  under ``CONF_PREEMPT``, 6 cycles, grace 2, then
  ``priority_tier_workload(10,000 workers, 5,000-task serving gang)``
  under ``CONF_PREEMPT_ONLY`` with ``VOLCANO_TPU_EVICT_CAP=10000`` until
  the gang binds, each through the tree's ``run_evict_phase`` with its
  checks: per cycle the wall and the preempt / reclaim lanes (ms);
- ``walk``: ``chip_smoke.host_walk_phases()`` (phases 35-37: the host
  victim walk, ``VOLCANO_TPU_EVICT_DEVICE=0``, on the stores of ``evict``
  and the twins at 1,000 nodes), where the tree has it: per cycle the
  wall and the preempt / reclaim lanes;

A traced call reports the device time and launch count summed per CUDA
function (every device event, named as the profiler names it), the card's
busy time and the call's wall time.  A line per phase goes to standard
error; the last line of standard output is one JSON object with the
label, the card's name and power limit, and every phase's numbers.
Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

PHASES = ("solve", "cold", "shortlist", "seq", "seq-north-star",
          "seq-trace", "victim", "kernels", "steer", "delta", "frag",
          "worker", "pipeline", "evict", "walk")


def _trace(fn) -> dict:
    """Device time and launches per CUDA function over one call of
    ``fn``, the union of the card's busy intervals and the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, funcs, host = [], {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            host[e.name] = host.get(e.name, 0) + 1
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        name = e.name.replace("(anonymous namespace)::", "")
        key = name.split("(")[0].strip() or name
        acc = funcs.setdefault(key, [0.0, 0])
        acc[0] += (b - a) / 1e3
        acc[1] += 1
    spans.sort()
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"wall_ms": wall * 1e3, "busy_ms": busy / 1e3,
            "device_events": len(spans), "funcs": funcs,
            "host_events": host}


def _ops(fn, tries: int = 1) -> dict:
    """Launches per device operation (kernels, copies, memsets) of one
    call of ``fn``, from a trace that opens with a ~1 ms spin kernel (left
    out): a short trace has come back without its first device events.  A
    repeatable ``fn`` is traced ``tries`` times and the fullest trace
    kept (a trace loses events, it never adds one)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best = {}
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        ops = {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA or "spin_kernel" in e.name:
                continue
            name = e.name.replace("(anonymous namespace)::", "")
            key = name.split("(")[0].strip() or name
            ops[key] = ops.get(key, 0) + 1
        if sum(ops.values()) > sum(best.values()):
            best = ops
    return best


def _top(tr: dict, k: int = 12) -> str:
    rows = sorted(tr["funcs"].items(), key=lambda kv: -kv[1][0])[:k]
    return ", ".join(f"{f} {ms:.3f} ms / {n}" for f, (ms, n) in rows)


def _log(label: str, msg: str) -> None:
    print(f"[{label}] {msg}", file=sys.stderr, flush=True)


# ------------------------------------------------------------ wave solve

def phase_solve(cs, opts) -> dict:
    import torch

    from volcano_tpu_torch.ops.wave import LAST_TWOPHASE, solve_wave
    from volcano_tpu_torch.synth import (solve_args_from_store,
                                         synthetic_cluster)

    store = synthetic_cluster(n_nodes=10000, n_pods=100000, gang_size=8,
                              zones=16, seed=0)
    args, _ = solve_args_from_store(store, binpack=True, nodeorder=True)
    solve_wave(*args)
    torch.cuda.synchronize()
    walls, syncs = [], None
    for _ in range(opts.solves):
        t0 = time.perf_counter()
        solve_wave(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        syncs = LAST_TWOPHASE["syncs"]
    out = {"median_s": statistics.median(walls), "walls_s": walls,
           "syncs": syncs, "trace": _trace(lambda: solve_wave(*args))}
    _log(opts.label, f"solve {out['median_s']:.4f} s; traced busy "
         f"{out['trace']['busy_ms']:.3f} ms: {_top(out['trace'])}")
    return out


def phase_cold(cs, opts) -> dict:
    import torch

    from volcano_tpu_torch.ops.wave import LAST_TWOPHASE
    from volcano_tpu_torch.scheduler import Scheduler

    cold = {"wall_s": [], "device_fine_ms": [], "syncs": []}
    for traced in [False] * opts.cold + [True]:
        st = cs.config5_cluster(10000, 100000)
        sched = Scheduler(st, conf_str=cs.CONF_BASE)
        if traced:
            cold["trace"] = _trace(sched.run_once)
            cold["traced_device_fine_ms"] = cs._lanes(st).get(
                "device_fine", 0.0)
        else:
            t0 = time.perf_counter()
            sched.run_once()
            torch.cuda.synchronize()
            cold["wall_s"].append(time.perf_counter() - t0)
            cold["device_fine_ms"].append(cs._lanes(st).get(
                "device_fine", 0.0))
            cold["syncs"].append(LAST_TWOPHASE["syncs"])
        cs.cycle_invariants(st, len(st.pods))
        st.close()
    _log(opts.label, f"cold {cold['wall_s']} s; traced busy "
         f"{cold['trace']['busy_ms']:.3f} ms: {_top(cold['trace'])}")
    return cold


# ------------------------------------------------------------ shortlists

def _shortlist_shape(cap: dict) -> dict:
    """(U profile rows, N nodes, B node blocks, S; ndb dirty blocks for a
    warm pass)."""
    U = int(cap["req"].shape[0])
    N = int(cap["idle"].shape[0])
    if "db" in cap:
        B = int(cap["cand_s"].shape[1])
        return {"U": U, "N": N, "B": B, "S": int(cap["S"]),
                "ndb": int(cap["db"].shape[0])}
    return {"U": U, "N": N, "B": int(cap["n_blocks"]), "S": int(cap["S"])}


def phase_shortlist(cs, opts) -> dict:
    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.synth import synthetic_cluster

    caps = {}
    kernels.CAPTURE = {}
    store = synthetic_cluster(n_nodes=10000, n_pods=100000, gang_size=8,
                              zones=16, seed=0)
    cs.run_cycle("ab:cycle", store, 100000)
    cyc, kernels.CAPTURE = kernels.CAPTURE, None
    store.close()
    for name, key in (("north_star", "coarse_shortlist"),
                      ("warm", "warm_shortlist")):
        if key not in cyc or (key == "coarse_shortlist"
                              and not cyc[key]["n_blocks"]):
            raise AssertionError(f"[ab:cycle] no {name} launch captured")
        caps[name] = (key, cyc[key])

    kernels.CAPTURE = {}
    store = cs.config5_cluster(10000, 100000)
    stats, _ = cs.run_aff_cycles("ab:affinity", store, steady=0)
    c5, kernels.CAPTURE = kernels.CAPTURE, None
    store.close()
    keys = [k for k in stats["cycles"][0]["captured"]
            if k.startswith("coarse_shortlist")]
    if len(keys) != 1 or not c5[keys[0]]["n_blocks"]:
        raise AssertionError(f"[ab:affinity] captured {keys}: not one "
                             f"block-form launch")
    caps["config5_cold"] = ("coarse_shortlist", c5[keys[0]])

    out = {}
    for name, (key, cap) in caps.items():
        row = cs.replay_kernels({key: cap}, {key: 1}, names=[key])[0]
        shape = _shortlist_shape(cap)
        out[name] = {"shape": shape, "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "queued": row["queued"],
                     "max_abs_err": row["max_abs_err"]}
        _log(opts.label, f"shortlist {name} {json.dumps(shape)}: "
             f"{row['ms']:.5f} ms (plain {row['plain_ms']:.3f})")
    return out


# ------------------------------------------------------------ seq solve

def _seq_times(x, weights, reps: int) -> list:
    """Device ms of ``reps`` seq_solve launches on ``x``, each alone."""
    import torch

    from volcano_tpu_torch.ops import kernels

    kernels.seq_solve(x, weights)
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        kernels.seq_solve(x, weights)
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return out


def _seq_cycle(cs, conf: str, reps: int) -> dict:
    import torch

    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.scheduler import Scheduler

    store = cs._fresh_cluster(**cs.CONFIG2)
    kernels.CAPTURE = {}
    sched = Scheduler(store, conf_str=conf)
    t0 = time.perf_counter()
    sched.run_once()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cap, kernels.CAPTURE = kernels.CAPTURE, None
    rec = store.flight.last()
    if rec.path != "object" or "seq_solve" not in cap:
        raise RuntimeError(f"no object-session seq solve: {rec.path}")
    cs.cycle_invariants(store, cs.CONFIG2["n_pods"])
    store.close()
    c = cap["seq_solve"]
    ms = _seq_times(c["x"], c["weights"], reps)
    return {"cycle_wall_s": wall,
            "lanes_ms": {k: v * 1e3 for k, v in sorted(rec.lanes.items())},
            "rows": int(c["x"].req.shape[0]),
            "extra": c["x"].extra_ok is not None,
            "solve_ms": ms, "median_ms": statistics.median(ms)}


def _register_custom(cs) -> str:
    """chip_smoke's custom plugins registered; the conf naming them under
    the sequential solver."""
    from volcano_tpu_torch.framework import register_plugin_builder

    register_plugin_builder(cs.ChipMask.name, cs.ChipMask)
    register_plugin_builder(cs.ChipScorer.name, cs.ChipScorer)
    return cs.CONF_CUSTOM + cs.CONF_SEQ[len(cs.CONF_BASE):]


def phase_seq(cs, opts) -> dict:
    out = {"seq": _seq_cycle(cs, cs.CONF_SEQ, opts.reps),
           "custom_seq": _seq_cycle(cs, _register_custom(cs), opts.reps)}
    _log(opts.label, f"seq {out['seq']['median_ms']:.3f} ms "
         f"({out['seq']['solve_ms']}), custom:seq "
         f"{out['custom_seq']['median_ms']:.3f} ms "
         f"({out['custom_seq']['solve_ms']})")
    return out


def phase_seq_north_star(cs, opts) -> dict:
    import torch

    from volcano_tpu_torch.ops.allocate import solve
    from volcano_tpu_torch.synth import (solve_args_from_store,
                                         synthetic_cluster)

    store = synthetic_cluster(n_nodes=10000, n_pods=100000, gang_size=8,
                              zones=16, seed=0)
    args, _ = solve_args_from_store(store, binpack=True, nodeorder=True)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out = {"walls_s": walls, "median_s": statistics.median(walls)}
    _log(opts.label, f"seq north star {out['median_s']:.4f} s ({walls})")
    return out


class _EventLib:
    """A kernel library with CUDA events around each ``vtt_seq_solve``
    call, timed apart from any profiler trace."""

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


def phase_seq_trace(cs, opts) -> dict:
    import torch

    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.scheduler import Scheduler

    cycles = []
    for _ in range(opts.cycles):
        store = cs._fresh_cluster(**cs.CONFIG2)
        sched = Scheduler(store, conf_str=cs.CONF_SEQ)
        lib = _EventLib(kernels.load())
        load, kernels.load = kernels.load, lambda: lib
        try:
            tr = _trace(sched.run_once)
        finally:
            kernels.load = load
        torch.cuda.synchronize()
        cs.cycle_invariants(store, cs.CONFIG2["n_pods"])
        store.close()
        ev = [e0.elapsed_time(e1) for e0, e1 in lib.events]
        cycles.append({
            "events_ms": ev, "wall_ms": tr["wall_ms"],
            "busy_ms": tr["busy_ms"], "device_events": tr["device_events"],
            "traced": {f: tr["funcs"].get(f) for f in
                       ("row_prep_kernel", "seq_solve_kernel")},
            "host_events": tr["host_events"], "top": _top(tr, 6)})
        _log(opts.label, f"seq-trace events {ev} ms, traced "
             f"{cycles[-1]['traced']}, {tr['device_events']} device events, "
             f"host events {json.dumps(tr['host_events'])}, "
             f"busy {tr['busy_ms']:.3f} of {tr['wall_ms']:.1f} ms")
    return {"cycles": cycles,
            "missed": sum(c["traced"]["seq_solve_kernel"] is None
                          for c in cycles)}


# ------------------------------------------------------------ victims

def _victim_inputs(mode: int, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    V, N, Q, R = 40000, 10000, 4, 3
    v_req = np.zeros((V, R), np.float32)
    v_req[:, 0] = rng.choice([1000.0, 2000.0, 4000.0], V)
    v_req[:, 1] = rng.choice([2.0, 4.0, 8.0], V) * 2.0 ** 30
    q_alloc = rng.uniform(0.5, 2.0, (Q, R)).astype(np.float32) * 1e6
    q_des = np.full((Q, R), 1e6, np.float32)
    a = dict(
        v_ok=rng.random(V) > 0.05, v_jprio=rng.integers(0, 4, V),
        v_crank=rng.permutation(V), v_tie=np.arange(V),
        v_queue=rng.integers(0, Q, V), v_node=rng.integers(0, N, V),
        v_req=v_req, q_alloc=q_alloc, q_deserved=q_des,
        q_reclaimable=np.ones(Q, bool))
    t = {}
    for k, v in a.items():
        v = np.ascontiguousarray(v)
        if v.dtype == np.int64:
            v = v.astype(np.int32)
        t[k] = torch.from_numpy(v).to(dev)
    return (t["v_ok"], t["v_jprio"], t["v_crank"], t["v_tie"], t["v_queue"],
            t["v_node"], t["v_req"], 3, 1, t["q_alloc"], t["q_deserved"],
            t["q_reclaimable"], mode, N)


def phase_victim(cs, opts) -> dict:
    import torch

    from volcano_tpu_torch.ops import kernels

    out = {}
    for mode, name in ((0, "preempt"), (1, "reclaim")):
        args = _victim_inputs(mode, torch.device("cuda"))
        got = kernels.victim_scores(*args)
        want = kernels.victim_scores(*args, plain=True)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(f"victim_scores ({name}) != plain version")
        ms = min(cs._device_ms(
            [lambda: kernels.victim_scores(*args) for _ in range(20)])[0]
            for _ in range(2))
        out[name] = {"ms": ms, "eligible": int(got[0].sum())}
    _log(opts.label, f"victim preempt {out['preempt']['ms']:.5f} ms, "
         f"reclaim {out['reclaim']['ms']:.5f} ms")
    return out


# ------------------------------------------------ two redesigned kernels

def _capture_kernels(cs) -> dict:
    """The first ``scatter_profile_tables`` launch of config 5's cold cycle
    and the first ``gang_block_fit`` launch of the ``[topology]`` cycle 0."""
    from volcano_tpu_torch.cache import FakeBinder
    from volcano_tpu_torch.framework import REBALANCE_SCHEDULER_CONF
    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.synth import fabric_cluster

    kernels.CAPTURE = {}
    store = cs.config5_cluster(10000, 100000)
    cs.run_aff_cycles("ab:affinity", store, steady=0)
    c5, kernels.CAPTURE = kernels.CAPTURE, None
    store.close()
    kernels.CAPTURE = {}
    store = fabric_cluster(racks=16, slices_per_rack=8, nodes_per_slice=64,
                           gang_tasks=128, topology="require-contiguous",
                           binder=FakeBinder())
    Scheduler(store, conf_str=REBALANCE_SCHEDULER_CONF).run_once()
    topo, kernels.CAPTURE = kernels.CAPTURE, None
    store.close()
    caps = {}
    for key, got in (("scatter_profile_tables", c5),
                     ("gang_block_fit", topo)):
        if key not in got:
            raise AssertionError(f"[ab:kernels] no {key} launch captured")
        caps[key] = got[key]
    caps["miss:north_star_solve"] = _north_star_row()
    return caps


def _north_star_row() -> dict:
    """The north-star solve's row-form shortlist launch, no planes given."""
    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.ops.wave import solve_wave
    from volcano_tpu_torch.synth import (solve_args_from_store,
                                         synthetic_cluster)

    store = synthetic_cluster(n_nodes=10000, n_pods=100000, gang_size=8,
                              zones=16, seed=0)
    args, _ = solve_args_from_store(store, binpack=True, nodeorder=True)
    kernels.CAPTURE = {}
    solve_wave(*args)
    row, kernels.CAPTURE = kernels.CAPTURE, None
    store.close()
    cap = row.get("coarse_shortlist")
    if cap is None or cap["n_blocks"] or "sel_bits" not in cap:
        raise AssertionError("[ab:kernels] the north-star solve's "
                             "shortlist launch was not the row form "
                             "without planes")
    return cap


def _miss_calls(cap: dict):
    """(without planes, two-launch form) zero-argument calls of the
    row-form shortlist on ``cap`` with this tree's wrappers, each
    returning the call's outputs."""
    import torch

    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.ops.nodeclass import NodeClasses
    from volcano_tpu_torch.ops.wave import SolveProfiles

    z = torch.zeros(1, dtype=torch.float32, device=cap["req"].device)
    prof = SolveProfiles(
        req=cap["req"], init_req=cap["init_req"], ports=z,
        sel_bits=cap["sel_bits"], aff_bits=cap["aff_bits"],
        aff_terms=cap["aff_terms"], tol_bits=cap["tol_bits"],
        pref_bits=cap["pref_bits"], pref_w=cap["pref_w"], t_req_aff=z,
        t_req_anti=z, t_matches=z, t_soft=z)
    cls = NodeClasses(cap["cls_id"], cap["cls_label"], cap["cls_taint"],
                      cap["cls_ready"])
    w = cap["weights"]

    def short(**kw):
        return tuple(kernels.coarse_shortlist(
            prof, cls, cap["idle"], cap["alloc"], cap["ntasks"],
            cap["max_tasks"], cap["eps"], cap["scalar_slot"], w, cap["S"],
            cap["has_taints"], future=cap.get("future"),
            ports=cap.get("ports"), aff=cap.get("aff"), **kw))

    def pair():
        stat = kernels.static_planes(prof, cls, w.node_affinity_weight,
                                     cap["has_taints"])
        return short(stat=stat)

    return short, pair


def _miss_row(cs, cap: dict, label: str, name: str) -> dict:
    import torch

    short, pair = _miss_calls(cap)
    got, want = short(), pair()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"[ab:kernels] {name}: the call without "
                                 f"planes != the two-launch form")
    calls = {"no_planes": short, "pair": pair}
    times = {}
    for k in ("no_planes", "pair", "pair", "no_planes"):
        times.setdefault(k, []).append(
            cs._device_ms([calls[k] for _ in range(20)])[0])
    out = {"shape": {"U": int(cap["req"].shape[0]),
                     "N": int(cap["idle"].shape[0]),
                     "C": int(cap["cls_ready"].shape[0]), "S": int(cap["S"])}}
    for k, fn in calls.items():
        out[k] = {"ms": min(times[k]), "device_ops": _ops(fn, tries=3)}
    _log(label, f"kernels {name} {json.dumps(out['shape'])}: " + "; ".join(
        f"{k} {out[k]['ms']:.5f} ms, device ops {out[k]['device_ops']}"
        for k in calls))
    return out


def _to(cap: dict, dev) -> dict:
    return {k: v.to(dev) if hasattr(v, "to") else v for k, v in cap.items()}


def phase_kernels(cs, opts) -> dict:
    import inspect

    import torch

    from volcano_tpu_torch.ops import kernels

    caps = _caps(opts, lambda: _capture_kernels(cs))
    out = {}
    misses = {k: caps.pop(k) for k in list(caps) if k.startswith("miss:")}
    for key, cap in caps.items():
        row = cs.replay_kernels({key: cap}, {key: 1}, names=[key])[0]
        fn = cs._kernel_fn(key, cs._clone(cap), plain=False)
        fn()
        tr = _trace(fn)
        out[key] = {k: row.get(k) for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "yardstick", "yardstick_ms", "queued", "max_abs_err", "bytes")}
        out[key]["device_ops"] = {f: n for f, (_ms, n) in tr["funcs"].items()}
        _log(opts.label, f"kernels {key}: {row['ms']:.5f} ms (plain "
             f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.6f}), device "
             f"ops {out[key]['device_ops']}")
    gbf = caps["gang_block_fit"]
    out["gang_block_fit"]["shape"] = {
        "N": int(gbf["idle"].shape[0]), "R": int(gbf["idle"].shape[1]),
        "U": int(gbf["prof_req"].shape[0]), "B": int(gbf["n_blocks"])}
    spt = caps["scatter_profile_tables"]
    out["scatter_profile_tables"]["shape"] = {
        "U": int(spt["u"]), "E1": int(spt["e"]),
        "k": int(spt["rows"].shape[0])}
    if "cluster" in inspect.signature(kernels.gang_block_fit).parameters:
        c = gbf
        args = (c["idle"], c["ready"], c["ntasks"], c["max_tasks"],
                c["block_id"], c["prof_req"], c["prof_cnt"], c["eps"],
                c["n_blocks"])
        want = kernels.gang_block_fit(*args, plain=True)
        sweep = {}
        for C in (1, 2, 4, 8, 16):
            got = kernels.gang_block_fit(*args, cluster=C)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"gang_block_fit (cluster {C}) != plain")
            sweep[C] = min(cs._device_ms(
                [lambda C=C: kernels.gang_block_fit(*args, cluster=C)
                 for _ in range(20)])[0] for _ in range(2))
        out["gang_block_fit"]["clusters_ms"] = sweep
        _log(opts.label, f"kernels gang_block_fit by cluster size "
             f"{json.dumps(sweep)}")
    if hasattr(cs, "launch_floor"):
        out["launch_floor_ms"] = cs.launch_floor()
        _log(opts.label, f"kernels empty launch "
             f"{json.dumps(out['launch_floor_ms'])}")
    for key, cap in misses.items():
        out[key] = _miss_row(cs, cap, opts.label, key)
    return out


# ------------------------------------------------------- live steering

def _capture_steer(cs) -> dict:
    """The first computing ``aff_steer`` launch of config 5's cold cycle
    (``config5_cluster(10,000, 100,000)`` under ``CONF_BASE``) with
    ``VOLCANO_TPU_AFF_STEER=1``: a launch behind a clear steering byte is
    not captured (the byte is read on the host, during the capture only)."""
    from volcano_tpu_torch.ops import affkernels, kernels
    from volcano_tpu_torch.ops import wave as wave_mod

    capture = affkernels._capture

    def computing_only(name, **inputs):
        gate = inputs.get("gate")
        if name == "aff_steer" and gate is not None and not bool(gate[0]):
            return
        capture(name, **inputs)

    steer0 = wave_mod.AFF_STEER
    wave_mod.AFF_STEER = 1
    affkernels._capture = computing_only
    try:
        store = cs.config5_cluster(10000, 100000)
        kernels.CAPTURE = {}
        cs.run_aff_cycles("ab:steer", store, steady=0)
        got = kernels.CAPTURE
        store.close()
    finally:
        kernels.CAPTURE = None
        affkernels._capture = capture
        wave_mod.AFF_STEER = steer0
    if "aff_steer" not in got:
        raise AssertionError("[ab:steer] no computing aff_steer launch in "
                             "the cold cycle")
    return {"aff_steer": got["aff_steer"]}


def _steer_call(cs, cap: dict, gate: bool):
    """A zero-argument ``aff_steer`` call on a copy of ``cap`` with the
    steering byte ``gate``, writing into the copy's working plane."""
    import torch

    from volcano_tpu_torch.ops import affkernels

    c = cs._clone(cap)
    c["gate"] = torch.tensor([gate], device=c["ranked"].device)
    if c.get("out") is None:
        c["out"] = torch.zeros(tuple(c["ranked"].shape), dtype=torch.bool,
                               device=c["ranked"].device)
    return lambda: affkernels.aff_steer(c["ranked"], c["feas_att"],
                                        c["at"], gate=c["gate"],
                                        out=c["out"])


def phase_steer(cs, opts) -> dict:
    """``aff_steer`` on its captured launch, computing and gated: checked
    against the plain version (a gated call must leave the plane as it
    was), timed by ``chip_smoke._device_ms`` over 20 queued calls, best of
    two turns, with the device operations of one call (a trace) and the
    bound (``chip_smoke._work``)."""
    import torch

    from volcano_tpu_torch.ops import affkernels

    cap = _caps(opts, lambda: _capture_steer(cs))["aff_steer"]
    at = cap["at"]
    want = affkernels.aff_steer(cap["ranked"], cap["feas_att"], at,
                                plain=True)
    res = {}
    for gate, key in ((True, "ms"), (False, "gated_ms")):
        got = _steer_call(cs, cap, gate)()
        torch.cuda.synchronize()
        ref = want if gate else cap.get("out")
        if ref is not None and not torch.equal(got, ref):
            raise AssertionError(f"[ab:steer] gate {gate}: the plane != "
                                 f"its expected one")
        res[key] = min(cs._device_ms([_steer_call(cs, cap, gate)
                                      for _ in range(20)])[0]
                       for _ in range(2))
        res[key.replace("ms", "device_ops")] = _ops(
            _steer_call(cs, cap, gate), tries=3)
    nbytes, ops = cs._work("aff_steer", cap, (want,))
    UM, K = cap["ranked"].shape
    EW, D = at.cnt_a.shape
    res["shape"] = {"UM": int(UM), "K": int(K), "EW": int(EW), "D": int(D),
                    "pipelined": at.cnt_p is not None,
                    "self_terms": int((at.t_req_aff & at.t_matches)
                                      .any(dim=0).sum())}
    res["bound_ms"] = max(nbytes / cs.MEM_BPS, ops / cs.F32_OPS) * 1e3
    _log(opts.label, f"steer {json.dumps(res)}")
    return res


# ------------------------------------------------------- node-table delta

def phase_delta(cs, opts) -> dict:
    import dataclasses

    import torch

    from volcano_tpu_torch.framework import DEPLOYED_SCHEDULER_CONF
    from volcano_tpu_torch.ops import devsnap
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.synth import synthetic_cluster

    store = synthetic_cluster(n_nodes=10000, n_pods=100000, gang_size=8,
                              zones=16, seed=0)
    sched = Scheduler(store, conf_str=DEPLOYED_SCHEDULER_CONF)
    sched.run_once()
    torch.cuda.synchronize()
    # Every cycle re-places the pods of nodes 0-63, so it solves (and so
    # builds the solve's node planes).
    store.cycle_feed = cs.repend_feed(list(range(64)))
    m = store.mirror
    step = max(1, m.n_nodes // 100)
    node_planes = devsnap.DeviceSnapshot.node_planes
    host_ms, traces, tracing = [], [], [False]

    def timed(self, *a, **kw):
        before = self.delta_uploads
        if tracing[0]:
            holder = []
            ops = _ops(lambda: holder.append(node_planes(self, *a, **kw)))
            if self.delta_uploads != before:
                traces.append(ops)
            return holder[0]
        t0 = time.perf_counter()
        out = node_planes(self, *a, **kw)
        if self.delta_uploads != before:
            host_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    devsnap.DeviceSnapshot.node_planes = timed
    try:
        for i in range(opts.reps + 1):
            tracing[0] = i == opts.reps
            for row in range(0, step * 100, step):
                old = m.node_objs[row]
                cpu = str(int(float(old.allocatable["cpu"]) * 1.5))
                store.update_node(dataclasses.replace(
                    old, allocatable={**old.allocatable, "cpu": cpu},
                    capacity={**old.capacity, "cpu": cpu}))
            sched.run_once()
            torch.cuda.synchronize()
    finally:
        devsnap.DeviceSnapshot.node_planes = node_planes
    if len(host_ms) != opts.reps or len(traces) != 1:
        raise AssertionError(f"[ab:delta] {len(host_ms)} timed and "
                             f"{len(traces)} traced deltas")
    snap = store.device_snapshot
    cs.cycle_invariants(store, len(store.pods))
    store.close()
    out = {"host_ms": host_ms, "median_host_ms": statistics.median(host_ms),
           "delta_uploads": snap.delta_uploads, "device_ops": traces[0]}
    _log(opts.label, f"delta: node_planes host ms {host_ms} (median "
         f"{out['median_host_ms']:.4f}); traced device ops "
         f"{out['device_ops']}")
    return out


# ------------------------------------------- the rebalance planner's kernels

def _tool_chip_smoke():
    """The ``chip_smoke.py`` beside this tool, loaded as a module of its
    own: it imports the package only inside its functions, so they run
    the tree's code."""
    import importlib.util

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_tool", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture_frag(cs) -> dict:
    """The first ``frag_scores`` launch of the ``[rebalance]`` plan cycle
    and the first ``gang_block_fit`` launch of the ``[topology]`` cycle
    0."""
    import os

    from volcano_tpu_torch.cache import FakeBinder
    from volcano_tpu_torch.framework import REBALANCE_SCHEDULER_CONF
    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.sim import ClusterSimulator
    from volcano_tpu_torch.synth import fabric_cluster

    conf = REBALANCE_SCHEDULER_CONF
    os.environ["VOLCANO_TPU_REBALANCE_DRAIN_CAP"] = "5000"
    try:
        store = cs.rebalance_store(5000)
        sched = Scheduler(store, conf_str=conf)
        sim = ClusterSimulator(store, grace_steps=2)
        sched.run_once()
        sim.step()
        cs.add_bench_gang(store, 2500)
        kernels.CAPTURE = {}
        for _ in range(4):
            sched.run_once()
            sim.step()
            if "frag_scores" in kernels.CAPTURE:
                break
        reb, kernels.CAPTURE = kernels.CAPTURE, None
        store.close()
    finally:
        os.environ.pop("VOLCANO_TPU_REBALANCE_DRAIN_CAP", None)
    kernels.CAPTURE = {}
    store = fabric_cluster(racks=16, slices_per_rack=8, nodes_per_slice=64,
                           gang_tasks=128, topology="require-contiguous",
                           binder=FakeBinder())
    Scheduler(store, conf_str=conf).run_once()
    topo, kernels.CAPTURE = kernels.CAPTURE, None
    store.close()
    for key, got in (("frag_scores", reb), ("gang_block_fit", topo)):
        if key not in got:
            raise AssertionError(f"[ab:frag] no {key} launch captured")
    return {"frag_scores": reb["frag_scores"],
            "gang_block_fit": topo["gang_block_fit"]}


def _caps(opts, capture) -> dict:
    """Captured inputs: read from ``--caps`` when the file exists (written
    by this tool in the same call: trusted pickles), else captured and,
    with ``--caps``, written there."""
    import torch

    path = Path(opts.caps) if opts.caps else None
    if path is not None and path.exists():
        return {k: _to(v, "cuda") for k, v in torch.load(
            path, weights_only=False).items()}
    caps = capture()
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({k: _to(v, "cpu") for k, v in caps.items()}, path)
    return caps


def phase_frag(cs, opts) -> dict:
    import torch

    from volcano_tpu_torch.ops import rebalance as treb

    tool = _tool_chip_smoke()
    caps = _caps(opts, lambda: _capture_frag(cs))
    out = {}
    for key, cap in caps.items():
        row = cs.replay_kernels({key: cap}, {key: 1}, names=[key])[0]
        out[key] = {k: row.get(k) for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "queued", "bytes", "ops")}
        _log(opts.label, f"frag {key}: {row['ms']:.5f} ms (plain "
             f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.7f})")
    fs = caps["frag_scores"]
    out["frag_scores"]["shape"] = {
        "N": int(fs["idle"].shape[0]), "R": int(fs["idle"].shape[1]),
        "U": int(fs["prof_req"].shape[0]),
        "live": int((fs["prof_req"] > fs["eps"]).any(dim=1).sum())}
    planes = [fs[k].cpu().numpy() for k in (
        "idle", "alloc", "ready", "evictable", "prof_req", "eps")]

    def call():
        got = treb.frag_scores(*planes, device="cuda")
        if hasattr(type(got), "packed"):
            return got.packed.cpu()
        return torch.cat([got.frag.view(torch.int32), got.fit_now,
                          got.fit_freed]).cpu()

    call()
    walls = []
    for _ in range(opts.reps):
        t0 = time.perf_counter()
        for _ in range(10):
            call()
        walls.append((time.perf_counter() - t0) * 1e3 / 10)
    _res, ops, syncs = tool.sync_ops(call)
    out["frag_scores"]["call"] = {
        "host_ms": walls, "median_host_ms": statistics.median(walls),
        "device_ops": ops, "counts": tool.op_counts(ops), "syncs": syncs}
    _log(opts.label, f"frag frag_scores call + fetch: host ms {walls}; "
         f"device ops {ops}, {len(syncs)} syncs at {syncs}")
    tr = tool.plan_trace()
    out["plan_trace"] = {k: tr[k] for k in (
        "counts", "syncs", "ops", "syncs_each_try")}
    _log(opts.label, f"frag plan trace: {json.dumps(tr['counts'])}, "
         f"{len(tr['syncs'])} syncs (each try {tr['syncs_each_try']}) at "
         f"{tr['syncs']}")
    return out


# ---------------------------------------------------- the solve worker

def phase_worker(cs, opts) -> dict:
    import threading

    import torch

    from volcano_tpu_torch import pipeline as pl
    from volcano_tpu_torch.ops import wave
    from volcano_tpu_torch.synth import (solve_args_from_store,
                                         synthetic_cluster)

    store = synthetic_cluster(n_nodes=10000, n_pods=100000, gang_size=8,
                              zones=16, seed=0)
    args, _ = solve_args_from_store(store, binpack=True, nodeorder=True)
    dev = args[0].idle.device
    side = torch.cuda.Stream(dev)

    def direct():
        out = pl._pack(wave.solve_wave(*args, device=dev),
                       pl.SOLVE_FIELDS).cpu().numpy()
        return out, wave.LAST_TWOPHASE["fine_s"]

    def stream():
        with torch.cuda.stream(side):
            return direct()

    def thread():
        box = []
        t = threading.Thread(target=lambda: box.append(direct()))
        t.start()
        t.join()
        return box[0]

    def worker():
        job = pl.dispatch_solve(store, dev, args, pl.SOLVE_FIELDS)
        return job.result(), job.twophase["fine_s"]

    def worker_busy():
        job = pl.dispatch_solve(store, dev, args, pl.SOLVE_FIELDS)
        n = 0
        while not job.done.is_set():
            n += sum(range(2000))
        return job.result(), job.twophase["fine_s"]

    def worker_busy_si():
        old = sys.getswitchinterval()
        sys.setswitchinterval(0.0005)
        try:
            return worker_busy()
        finally:
            sys.setswitchinterval(old)

    variants = {"direct": direct, "stream": stream, "thread": thread,
                "worker": worker, "worker_busy": worker_busy,
                "worker_busy_si": worker_busy_si}
    ref = None
    for fn in variants.values():
        out, _ = fn()
        torch.cuda.synchronize()
        if ref is None:
            ref = out
        elif not (out == ref).all():
            raise AssertionError("port_ab worker: results differ")
    walls = {k: [] for k in variants}
    fines = {k: [] for k in variants}
    order = list(variants) + list(reversed(list(variants)))
    for _ in range(opts.reps):
        for k in order:
            t0 = time.perf_counter()
            out, fine = variants[k]()
            walls[k].append((time.perf_counter() - t0) * 1e3)
            fines[k].append(fine * 1e3)
            if not (out == ref).all():
                raise AssertionError(f"port_ab worker: {k} differs")
    out = {k: {"wall_ms_median": statistics.median(walls[k]),
               "wall_ms": walls[k],
               "fine_ms_median": statistics.median(fines[k])}
           for k in variants}
    _log(opts.label, "worker: " + "; ".join(
        f"{k} wall {v['wall_ms_median']:.3f} ms (fine "
        f"{v['fine_ms_median']:.3f})" for k, v in out.items()))
    store.close()
    return out


# ------------------------------------------------------------ pipeline

def phase_pipeline(cs, opts) -> dict:
    stats, rows = cs.pipeline_phase()
    out = {"cycles": [{k: c[k] for k in ("kind", "wall_s",
                                         "inflight_fetch_wait_ms")}
                      for c in stats["cycles"]],
           "traced": {k: stats["traced"][k] for k in ("busy_ms", "wall_ms")}
           if stats.get("traced") else None,
           "kernels": [r["name"] for r in rows]}
    _log(opts.label, f"pipeline {json.dumps(out)}")
    return out


def _lanes(stats) -> list:
    """Per cycle: the wall (s) and the preempt / reclaim lanes (ms)."""
    return [[c["wall_s"], c["lanes_ms"].get("preempt"),
             c["lanes_ms"].get("reclaim")] for c in stats["cycles"]]


def phase_evict(cs, opts) -> dict:
    import os

    from volcano_tpu_torch.cache import ClusterStore, FakeBinder, FakeEvictor
    from volcano_tpu_torch.sim import ClusterSimulator
    from volcano_tpu_torch.synth import preempt_cluster

    old = {k: os.environ.get(k) for k in ("VOLCANO_TPU_EVICT_DEVICE",
                                          "VOLCANO_TPU_EVICT_CAP")}
    out = {}
    try:
        os.environ["VOLCANO_TPU_EVICT_DEVICE"] = "1"
        os.environ.pop("VOLCANO_TPU_EVICT_CAP", None)
        store = preempt_cluster(n_nodes=10000, fill_per_node=4,
                                n_pending=20000, gang_size=4, seed=0)
        rstats = cs.run_evict_phase("reclaim", store, cs.CONF_PREEMPT,
                                    grace=2, cycles=6)[0]
        out["reclaim"] = _lanes(rstats)
        store.close()
        os.environ["VOLCANO_TPU_EVICT_CAP"] = "10000"
        store = ClusterStore(binder=FakeBinder(), evictor=FakeEvictor())
        ClusterSimulator.priority_tier_workload(store, workers=10000,
                                                serving_tasks=5000)

        def serving_bound(st):
            return sum(1 for p in st.pods.values()
                       if p.name.startswith("serving-") and p.node_name) \
                >= 5000

        pstats = cs.run_evict_phase("preempt", store, cs.CONF_PREEMPT_ONLY,
                                    grace=2, cycles=24,
                                    until=serving_bound)[0]
        if not serving_bound(store):
            raise AssertionError("[preempt] the serving gang did not bind")
        out["preempt"] = _lanes(pstats)
        store.close()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    _log(opts.label, f"evict {json.dumps(out)}")
    return out


def phase_walk(cs, opts) -> dict:
    if not hasattr(cs, "host_walk_phases"):
        return None
    res = cs.host_walk_phases()
    out = {k: res[k]["lanes"] for k in ("reclaim", "preempt")}
    _log(opts.label, f"walk {json.dumps(out)}")
    return out


RUN = {"solve": phase_solve, "cold": phase_cold,
       "shortlist": phase_shortlist, "seq": phase_seq,
       "seq-north-star": phase_seq_north_star, "seq-trace": phase_seq_trace,
       "victim": phase_victim, "kernels": phase_kernels,
       "steer": phase_steer, "delta": phase_delta, "frag": phase_frag, "worker": phase_worker,
       "pipeline": phase_pipeline, "evict": phase_evict,
       "walk": phase_walk}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--phase", action="append", choices=PHASES,
                    required=True)
    ap.add_argument("--solves", type=int, default=5)
    ap.add_argument("--cold", type=int, default=1)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cycles", type=int, default=4)
    ap.add_argument("--caps", help="kernels, frag, steer: file of captured "
                    "inputs (written when missing, read when present)")
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("port_ab: CUDA is not available", file=sys.stderr)
        return 2
    tree = Path(opts.tree).resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke
    from volcano_tpu_torch.ops import kernels

    if not Path(kernels.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"volcano_tpu_torch not loaded from {tree}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    t0 = time.perf_counter()
    kernels.load()
    out = {"label": opts.label, "card": card,
           "build_s": time.perf_counter() - t0}
    for phase in dict.fromkeys(opts.phase):
        out[phase] = RUN[phase](chip_smoke, opts)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
