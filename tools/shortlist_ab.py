#!/usr/bin/env python3
"""Device time of the block-form shortlist launches of one tree, for
comparing two builds of ``csrc/warm_shortlist.cu`` on one card.

Run on a machine with one CUDA card, once per tree and in turns (A, B,
B, A), each in its own process:

    python3 tools/shortlist_ab.py --tree path/to/a --label a
    python3 tools/shortlist_ab.py --tree path/to/b --label b

``--tree`` is a checkout of the repository (the package
``volcano_tpu_torch`` and ``chip_smoke.py`` at its root); its kernels are
built from its own sources into its own build directory.  With that
tree's code the script captures three launches on their real inputs:

- ``north_star``: the first ``coarse_shortlist`` launch (block form) of
  ``Scheduler(store).run_once()`` on the north-star store
  (``synthetic_cluster(10,000 nodes, 100,000 pods, gangs of 8, 16
  zones)``, the deployed conf);
- ``warm``: the first ``warm_shortlist`` launch of that store's steady
  cycles (pods on nodes 0-63 re-pended each cycle);
- ``config5_cold``: the block-form ``coarse_shortlist`` launch of BASELINE
  config 5's cold cycle (``chip_smoke.config5_cluster(10,000,
  100,000)`` under ``CONF_BASE``).

Each launch is checked against its plain version and timed as
``chip_smoke.replay_kernels`` times it (CUDA events around 20
back-to-back calls queued behind a sleep kernel; kernel, plain, plain,
kernel, best of each).  The last line of standard output is one JSON
object with the label, the card's name and power limit, and for each
launch its shape and times.  Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def _shape(cap: dict) -> dict:
    """(U profile rows, N nodes, B node blocks, S; ndb dirty blocks for a
    warm pass)."""
    U = int(cap["req"].shape[0])
    N = int(cap["idle"].shape[0])
    if "db" in cap:
        B = int(cap["cand_s"].shape[1])
        return {"U": U, "N": N, "B": B, "S": int(cap["S"]),
                "ndb": int(cap["db"].shape[0])}
    return {"U": U, "N": N, "B": int(cap["n_blocks"]), "S": int(cap["S"])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("shortlist_ab: CUDA is not available", file=sys.stderr)
        return 2
    tree = Path(opts.tree).resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke
    from volcano_tpu_torch.ops import kernels
    from volcano_tpu_torch.synth import synthetic_cluster

    if not Path(kernels.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"volcano_tpu_torch not loaded from {tree}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    kernels.load()

    caps = {}
    kernels.CAPTURE = {}
    store = synthetic_cluster(n_nodes=10000, n_pods=100000, gang_size=8,
                              zones=16, seed=0)
    chip_smoke.run_cycle("ab:cycle", store, 100000)
    cyc, kernels.CAPTURE = kernels.CAPTURE, None
    store.close()
    for name, key in (("north_star", "coarse_shortlist"),
                      ("warm", "warm_shortlist")):
        if key not in cyc or (key == "coarse_shortlist"
                              and not cyc[key]["n_blocks"]):
            raise AssertionError(f"[ab:cycle] no {name} launch captured")
        caps[name] = (key, cyc[key])

    kernels.CAPTURE = {}
    store = chip_smoke.config5_cluster(10000, 100000)
    stats, _ = chip_smoke.run_aff_cycles("ab:affinity", store, steady=0)
    c5, kernels.CAPTURE = kernels.CAPTURE, None
    store.close()
    keys = [k for k in stats["cycles"][0]["captured"]
            if k.startswith("coarse_shortlist")]
    if len(keys) != 1 or not c5[keys[0]]["n_blocks"]:
        raise AssertionError(f"[ab:affinity] captured {keys}: not one "
                             f"block-form launch")
    caps["config5_cold"] = ("coarse_shortlist", c5[keys[0]])

    out = {"label": opts.label, "card": card, "launches": {}}
    for name, (key, cap) in caps.items():
        row = chip_smoke.replay_kernels({key: cap}, {key: 1},
                                        names=[key])[0]
        out["launches"][name] = {
            "shape": _shape(cap), "ms": row["ms"], "plain_ms": row["plain_ms"],
            "queued": row["queued"], "max_abs_err": row["max_abs_err"]}
        print(f"[{opts.label}] {name} {json.dumps(_shape(cap))}: "
              f"{row['ms']:.5f} ms (plain {row['plain_ms']:.3f})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
