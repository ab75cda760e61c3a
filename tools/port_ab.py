#!/usr/bin/env python3
"""Traced device time of the PyTorch port's kernels on two trees, for
comparing a change with its parent on one card.

Run on a machine with one CUDA card, once per tree and in turns (parent,
change, change, parent), each in its own process:

    python3 tools/port_ab.py --tree path/to/parent --label parent
    python3 tools/port_ab.py --tree . --label change

``--tree`` is a checkout of the repository (the package
``volcano_tpu_torch`` and ``chip_smoke.py`` at its root); its kernels are
built from its own sources into its own build directory.  The script
measures, with that tree's code:

- the north-star solve (``synthetic_cluster(10,000 nodes, 100,000 pods,
  gangs of 8, 16 zones)`` through ``solve_wave``): one warm-up solve, the
  median wall time of ``--solves`` (5; 0 skips the solve), and one solve
  traced with ``torch.profiler``;
- BASELINE config 5's cold cycle (``chip_smoke.config5_cluster(10,000,
  100,000)`` under ``CONF_BASE``, ``Scheduler(store).run_once()``):
  ``--cold`` untraced cycles (1), each on a fresh store (their wall times
  and ``device_fine`` lanes), then one traced cycle on another fresh store
  of the same seed.

For each trace: the device time and launch count summed per CUDA function
(every device event, named as the profiler names it), the card's busy time
and the cycle's or solve's wall time.  The last line of standard output is
one JSON object with the label, the card's name and power limit, and these
numbers.  Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


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
    spans, funcs = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
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
    return {"wall_ms": wall * 1e3, "busy_ms": busy / 1e3, "funcs": funcs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--solves", type=int, default=5)
    ap.add_argument("--cold", type=int, default=1)
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("port_ab: CUDA is not available", file=sys.stderr)
        return 2
    tree = Path(opts.tree).resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke
    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.ops.wave import LAST_TWOPHASE, solve_wave
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.synth import (solve_args_from_store,
                                         synthetic_cluster)

    if not Path(kernels.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"volcano_tpu_torch not loaded from {tree}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    t0 = time.perf_counter()
    kernels.load()
    build_s = time.perf_counter() - t0

    # The north-star solve.
    solve = None
    if opts.solves:
        store = synthetic_cluster(n_nodes=10000, n_pods=100000,
                                  gang_size=8, zones=16, seed=0)
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
        solve = {"median_s": statistics.median(walls), "walls_s": walls,
                 "syncs": syncs, "trace": _trace(lambda: solve_wave(*args))}
        del args, store

    # Config 5's cold cycle: untraced, then traced, each on a fresh store.
    cold = {"wall_s": [], "device_fine_ms": [], "syncs": []}
    for traced in [False] * opts.cold + [True]:
        st = chip_smoke.config5_cluster(10000, 100000)
        sched = Scheduler(st, conf_str=chip_smoke.CONF_BASE)
        if traced:
            cold["trace"] = _trace(sched.run_once)
            cold["traced_device_fine_ms"] = chip_smoke._lanes(st).get(
                "device_fine", 0.0)
        else:
            t0 = time.perf_counter()
            sched.run_once()
            torch.cuda.synchronize()
            cold["wall_s"].append(time.perf_counter() - t0)
            cold["device_fine_ms"].append(chip_smoke._lanes(st).get(
                "device_fine", 0.0))
            cold["syncs"].append(LAST_TWOPHASE["syncs"])
        chip_smoke.cycle_invariants(st, len(st.pods))
        st.close()

    out = {"label": opts.label, "card": card, "build_s": build_s,
           "north_star_solve": solve, "config5_cold": cold}
    traces = [("cold", cold["trace"])]
    if solve:
        traces.insert(0, ("solve", solve["trace"]))
    for what, tr in traces:
        top = sorted(tr["funcs"].items(), key=lambda kv: -kv[1][0])[:12]
        print(f"[{opts.label}:{what}] busy {tr['busy_ms']:.3f} of "
              f"{tr['wall_ms']:.3f} ms; "
              + ", ".join(f"{k} {ms:.3f} ms / {n}" for k, (ms, n) in top),
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
