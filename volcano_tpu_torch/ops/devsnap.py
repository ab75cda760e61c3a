"""Device-resident snapshot planes with delta uploads.

The counterpart of the JAX package's ``ops/devsnap.py``.  Most node-side
solver planes -- allocatable capacity, max-task counts, readiness,
label/taint bit planes, the node-class id plane -- change only when the
NODE table changes (the mirror's epoch key), not per cycle.
``DeviceSnapshot`` keeps one persistent tensor per plane on the store's
device, keyed by the mirror epoch + plane shapes:

- key unchanged -> the cached tensors go straight to the solve: zero
  upload, zero host copy;
- epoch advanced with shapes intact -> only the rows the mirror recorded
  dirty (``StoreMirror.node_delta_rows``) are uploaded and written into
  the persistent tensors in place: per chunk of rows, every plane's
  values and the row ids packed into one pinned host buffer, one
  asynchronous copy to the card and one ``scatter_planes`` launch
  (``ops/kernels.py``) for all planes;
- shape changed / delta unprovable -> full re-upload (of one plane when
  only its delta is unprovable).

Chunking: the JAX package chunks each plane on its own, at the power of
two of rows whose values fit ``budget_bytes()``.  The port chunks the
planes together: a chunk is the power of two of rows whose row ids and
values of every plane fit the budget, so each chunk is one copy and one
launch and stays under the budget.  ``delta_chunks`` keeps the JAX
package's count beside that (the extra per-plane passes the JAX chunking
takes), so the two packages' counters stay equal.

Only ``scatter_planes`` writes a resident plane; the solve reads them (its
per-cycle state -- idle, pod counts, queue allocations -- lives in fresh
tensors).  A pipelined session's solve reads them on its worker thread and
stream (``pipeline.py``) while the cycle thread goes on: the dispatch
registers the solve as a reader (``add_reader``), and a delta waits for
every registered solve to finish before it scatters (``wait_readers``).
The JAX package orders the same write through ``donate_argnums``.  On the
CPU a plane is a copy of the host array it was built from, never a view.
The JAX package padded each delta to a power of two with duplicate rows so
one compiled scatter served many lengths; the port passes the unique row
list.

One snapshot lives per store (``store.device_snapshot``), created by the
fast path on first use.  The mesh-sharded placement is not ported
(ROADMAP.md, queue 1: multi-GPU).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import to_tensor
from . import kernels

# Above this fraction of rows dirty, a full re-upload beats the scatter.
DELTA_MAX_FRACTION = 0.25


def budget_bytes() -> int:
    """Per-scatter host-staging budget for delta uploads
    (``VOLCANO_TPU_DEVSNAP_BUDGET_MB``, default 256 MB): a delta's values
    are built and uploaded in chunks under it, so a churn burst peaks at
    one chunk of staging memory."""
    try:
        mb = float(os.environ.get("VOLCANO_TPU_DEVSNAP_BUDGET_MB", 256))
    except ValueError:
        mb = 256.0
    # Fractional MB are accepted so tests can force the chunked path at
    # toy shapes; the 4 KB floor keeps a typo'd value from degenerating
    # to row-at-a-time scatters.
    return max(4096, int(mb * 1_000_000))


def _chunk_rows_for(row_nbytes: int, slack: int = 0) -> int:
    """Rows per delta-scatter chunk under the budget less ``slack`` bytes
    (a power of two, as the JAX package sizes its per-plane chunks)."""
    rows = max(1, (budget_bytes() - slack) // max(1, row_nbytes))
    p = 1
    while p * 2 <= rows:
        p *= 2
    return p


class DeviceSnapshot:
    """Persistent per-device plane set for one store (see module doc)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        # name -> tensor, all planes sharing self._key.
        self._planes: Dict[str, torch.Tensor] = {}
        self._key: Optional[Tuple] = None
        # Two-phase class tables ([C, *], tiny), content-addressed.
        self._cls_planes: Dict[str, torch.Tensor] = {}
        self._cls_key: Optional[Tuple] = None
        # Telemetry: full vs delta vs hit counts.
        self.full_uploads = 0
        self.delta_uploads = 0
        self.hits = 0
        self.class_uploads = 0
        self.class_hits = 0
        # Extra scatter passes the JAX package's per-plane chunking takes
        # because a delta exceeded the staging budget (see budget_bytes
        # and the module doc; the port's launches are ``delta_launches``).
        self.delta_chunks = 0
        # Combined chunks written (one copy and one launch each), and
        # planes re-uploaded whole inside a delta (delta unprovable).
        self.delta_launches = 0
        self.plane_uploads = 0
        # Pipelined solves dispatched with these planes among their inputs
        # (pipeline.SolveJob), not yet known to be finished.
        self._readers: list = []

    def add_reader(self, job) -> None:
        self._readers = [j for j in self._readers if not j.done.is_set()]
        self._readers.append(job)

    def wait_readers(self) -> None:
        """Wait for every registered solve to finish (bounded, raising:
        ``pipeline.SolveJob.wait``) -- called before a plane is written in
        place.  A solve's device reads end before its host loop does."""
        readers, self._readers = self._readers, []
        for job in readers:
            job.wait()

    def _put_plane(self, a: np.ndarray) -> torch.Tensor:
        t = to_tensor(np.ascontiguousarray(a), self.device)
        # A CPU tensor from numpy shares the array's memory: copy it.
        return t.clone() if t.device.type == "cpu" else t

    def _delta_vals(self, name: str, rows: np.ndarray, vals) -> np.ndarray:
        """One plane's delta values, checked against the resident plane."""
        plane = self._planes[name]
        vals = np.ascontiguousarray(vals)
        if vals.dtype == np.uint32:
            vals = vals.view(np.int32)
        if (vals.shape != (len(rows), *plane.shape[1:])
                or torch.from_numpy(vals[:0]).dtype != plane.dtype):
            raise ValueError(f"delta of plane {name}: {vals.dtype} "
                             f"{vals.shape} rows for a {plane.dtype} "
                             f"{tuple(plane.shape)} plane")
        return vals

    # Called only from FastCycle._solve_inputs, inside the cycle's
    # ``with store._lock`` -- the mirror delta reads and resets below
    # mutate store-guarded state.
    # holds: _lock
    def node_planes(self, m, key: Tuple,
                    build: Dict[str, Callable[..., np.ndarray]]):
        """Return ``{name: tensor}`` for the node-side planes.

        ``key`` is ``(epoch, shape components...)`` with the epoch FIRST;
        ``build[name](rows)`` returns the full padded host plane when
        ``rows`` is None, or just those rows' values for a delta scatter
        (only called on upload -- a key hit touches no host memory).  All
        planes move together under one key."""
        if self._key == key and self._planes.keys() == build.keys():
            self.hits += 1
            return self._planes
        delta_rows = None
        if (
            self._key is not None
            and self._key[1:] == key[1:]
            and self._planes.keys() == build.keys()
        ):
            delta_rows = m.node_delta_rows(self._key[0])
            n_rows = key[1] if len(key) > 1 else 0
            if delta_rows is not None and (
                len(delta_rows) == 0
                or len(delta_rows) > max(1, int(n_rows))
                * DELTA_MAX_FRACTION
            ):
                delta_rows = None if len(delta_rows) else delta_rows
        if delta_rows is not None and len(delta_rows) == 0:
            # Epoch moved but no node rows recorded dirty: planes are
            # current.
            m.reset_node_delta()
            self._key = key
            self.hits += 1
            return self._planes
        if delta_rows is not None:
            delta_rows = np.unique(np.asarray(delta_rows, np.int64))
            n_plane = int(next(iter(self._planes.values())).shape[0])
            if delta_rows[0] < 0 or delta_rows[-1] >= n_plane:
                raise ValueError(
                    f"node delta rows outside [0, {n_plane}): "
                    f"{delta_rows[0]}..{delta_rows[-1]}")
            probes = {}
            for name, fn in build.items():
                # One-row probe sizes the plane's delta rows (and detects
                # the delta-unprovable answer) without materializing the
                # full values array first.
                probe = fn(delta_rows[:1])
                if probe is None:
                    # Plane-level delta unprovable (class ids after the
                    # class SET changed): re-upload just this plane.
                    self._planes[name] = self._put_plane(
                        np.asarray(fn(None)))
                    self.plane_uploads += 1
                    continue
                probes[name] = probe
                # The JAX package's per-plane chunking, counted.
                chunk = _chunk_rows_for(max(1, np.asarray(probe).nbytes))
                self.delta_chunks += max(
                    0, -(-len(delta_rows) // chunk) - 1)
            if probes:
                # The scatter writes resident planes in place.
                self.wait_readers()
                row_nb = 4 + sum(np.asarray(v).nbytes
                                 for v in probes.values())
                # The staged layout pads each plane's values to 16 bytes.
                chunk = _chunk_rows_for(row_nb, slack=16 * len(probes))
                bufs = [self._planes[name] for name in probes]
                for lo in range(0, len(delta_rows), chunk):
                    crows = delta_rows[lo:lo + chunk]
                    vals = [self._delta_vals(
                        name, crows,
                        probe if len(crows) == 1 and lo == 0
                        else build[name](crows))
                        for name, probe in probes.items()]
                    staged = kernels.stage_delta(crows, vals, self.device)
                    kernels.scatter_planes(bufs, staged, len(crows))
                    self.delta_launches += 1
            m.reset_node_delta()
            self._key = key
            self.delta_uploads += 1
            return self._planes
        self._planes = {
            name: self._put_plane(np.asarray(fn(None)))
            for name, fn in build.items()
        }
        m.reset_node_delta()
        self._key = key
        self.full_uploads += 1
        return self._planes

    def resident_bytes(self) -> int:
        """Device-resident footprint: the sum of every plane's (and class
        table's) bytes."""
        return sum(int(t.numel() * t.element_size())
                   for group in (self._planes, self._cls_planes)
                   for t in group.values())

    def class_tables(self, key: Tuple,
                     build: Dict[str, Callable[[], np.ndarray]]):
        """Device-resident node-class tables for the two-phase solve
        ([C, *] rows), content-addressed: epoch churn that leaves the
        class SET intact re-uploads nothing.  The [N] ``class_id`` plane
        rides ``node_planes``' delta machinery instead."""
        if self._cls_key == key:
            self.class_hits += 1
            return self._cls_planes
        self._cls_planes = {
            name: self._put_plane(np.asarray(fn()))
            for name, fn in build.items()
        }
        self._cls_key = key
        self.class_uploads += 1
        return self._cls_planes


def for_store(store, device, mesh=None) -> DeviceSnapshot:
    """The store's snapshot on ``device``, created on first use; a
    snapshot on another device is replaced wholesale."""
    if mesh is not None:
        from ..cache.store import not_ported

        raise not_ported("the mesh-sharded device snapshot", "multi-GPU")
    device = torch.device(device)
    snap = getattr(store, "device_snapshot", None)
    if snap is None or snap.device != device:
        snap = store.device_snapshot = DeviceSnapshot(device)
    return snap
