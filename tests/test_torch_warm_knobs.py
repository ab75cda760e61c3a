"""The warm-shortlist block knobs, read per solve as the JAX package reads
them (``VOLCANO_TPU_WARM_BLOCKS``, ``VOLCANO_TPU_WARM_BLOCK_ROWS``: each
rounded down to a power of two, 16 / 8,192 when the value does not parse).

Twin runs: the JAX ``Scheduler`` and the port's ``Scheduler(device="cpu")``
on ``synthetic_cluster(n_nodes=256, n_pods=1024, gang_size=4, seed=13)``,
pipeline off, the pods of nodes 0 and 1 re-pended every cycle, 6 cycles.
After each cycle the solve's warm-block geometry
(``LAST_TWOPHASE["devincr"]["blocks"]``), the binds, the warm / full / skip
counts and the ``volcano_device_incremental_solves_total{mode}`` deltas
must be equal, under every knob setting below.
"""

import itertools

import pytest

from test_torch_fixtures import repend_feed

import volcano_tpu
import volcano_tpu.api.spec as jax_spec
import volcano_tpu.ops.wave as jax_wave
import volcano_tpu.synth  # noqa: F401
from volcano_tpu.metrics import metrics as jax_metrics
from volcano_tpu.scheduler import Scheduler as JaxScheduler

import volcano_tpu_torch
import volcano_tpu_torch.api.spec as port_spec
import volcano_tpu_torch.ops.wave as port_wave
import volcano_tpu_torch.synth  # noqa: F401
from volcano_tpu_torch.metrics import metrics as port_metrics
from volcano_tpu_torch.ops import devincr as port_devincr
from volcano_tpu_torch.scheduler import Scheduler as PortScheduler

CYCLES = 6


def _run(pkg):
    for spec in (jax_spec, port_spec):
        spec._uid_counter = itertools.count(1)
        spec._ts_counter = itertools.count(1)
    store = pkg.synth.synthetic_cluster(n_nodes=256, n_pods=1024,
                                        gang_size=4, seed=13)
    if pkg is volcano_tpu:
        store.pipeline = False
        sched, wave, met = JaxScheduler(store), jax_wave, jax_metrics
    else:
        sched = PortScheduler(store, device="cpu")
        wave, met = port_wave, port_metrics
    store.cycle_feed = repend_feed([0, 1])
    counter = met.device_incremental_solves
    trace = []
    for _ in range(CYCLES):
        before = dict(counter.data)
        wave.LAST_TWOPHASE.clear()
        sched.run_once()
        dv = wave.LAST_TWOPHASE.get("devincr") or {}
        after = dict(counter.data)
        trace.append({
            "blocks": tuple(dv.get("blocks", ())),
            "binds": dict(store.binder.binds),
            "counts": dict(store._devincr_cache.counts),
            "solves": {k: after[k] - before.get(k, 0.0) for k in after
                       if after[k] != before.get(k, 0.0)},
        })
    store.close()
    return trace


KNOBS = [
    ("4", "64"),
    ("4", "8192"),
    ("32", "64"),
    ("32", "8192"),
    ("5", "100"),  # rounded down to 4 and 64
    ("many", "lots"),  # neither parses: 16 and 8,192
]


@pytest.mark.parametrize("blocks,rows", KNOBS)
def test_warm_knobs_equal_jax(blocks, rows, monkeypatch):
    monkeypatch.delenv("VOLCANO_TPU_DEVINCR", raising=False)
    monkeypatch.setenv("VOLCANO_TPU_WARM_BLOCKS", blocks)
    monkeypatch.setenv("VOLCANO_TPU_WARM_BLOCK_ROWS", rows)
    want = _run(volcano_tpu)
    got = _run(volcano_tpu_torch)
    for field in ("blocks", "binds", "counts", "solves"):
        for step, (a, b) in enumerate(zip(want, got)):
            assert a[field] == b[field], (field, step)
    # Not vacuous: the geometry is the knobs', and a cycle ran warm.
    assert got[-1]["counts"]["warm"] >= 1
    assert all(t["blocks"] for t in got)


@pytest.mark.parametrize("blocks,rows,want", [
    ("4", "8192", (4, 64)),
    ("32", "64", (32, 8)),
    ("4", "64", (4, 64)),  # 256 rows: 4 blocks of 64 already fit
    ("3", "8192", (2, 128)),
    ("0", "8192", (1, 256)),
    ("x", "y", (16, 16)),
])
def test_block_geometry_reads_knobs_per_call(blocks, rows, want,
                                             monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_WARM_BLOCKS", blocks)
    monkeypatch.setenv("VOLCANO_TPU_WARM_BLOCK_ROWS", rows)
    B, nlb, klb = port_devincr.block_geometry(256, 10)
    assert (B, nlb) == want
    assert klb == min(10, nlb)


def test_block_rows_knob_grows_block_count(monkeypatch):
    """Past the row bound the block count doubles (as the JAX package's
    shortlist does at the 100k tier)."""
    monkeypatch.setenv("VOLCANO_TPU_WARM_BLOCKS", "4")
    monkeypatch.setenv("VOLCANO_TPU_WARM_BLOCK_ROWS", "256")
    assert port_devincr.block_geometry(16384, 64)[:2] == (64, 256)
    monkeypatch.setenv("VOLCANO_TPU_WARM_BLOCK_ROWS", "8192")
    assert port_devincr.block_geometry(16384, 64)[:2] == (4, 4096)
