"""Observability the store wires and the fast cycle writes.

Six stdlib-only modules (numpy is imported lazily where mirror arrays are
read), so the store wires them unconditionally:

- ``trace``    -- the span API whose lane times land in
  ``store.last_cycle_lanes``;
- ``recorder`` -- the ring of per-cycle ``CycleRecord``s;
- ``export``   -- Chrome/Perfetto ``trace_event`` JSON of the records, with
  dispatch -> commit flow arrows, journey async tracks and one instant per
  audit anomaly;
- ``audit``    -- the always-on conservation auditor (``Auditor``): the
  double-entry pod-count ledger reconciled against a census every cycle,
  sampled coherence audits, the anomaly ring, ``health()``;
- ``slo``      -- per-lane latency windows with budgets and burn rates;
- ``journey``  -- the per-pod event timeline (``JourneyLog``): why-pending
  verdicts, time-to-bind, the conservation check.

Not ported: lockdep (the JAX package's ``obs/lockdep.py``, runtime
enforcement of ``# guarded-by:`` comments; ROADMAP.md, queue 1).
"""

from .audit import Anomaly, Auditor
from .journey import JourneyLog, journey_on
from .recorder import CycleRecord, FlightRecorder
from .slo import SLOTracker
from .trace import SpanRecord, Tracer, null_tracer, tracer_of

__all__ = [
    "Anomaly",
    "Auditor",
    "CycleRecord",
    "FlightRecorder",
    "JourneyLog",
    "journey_on",
    "SLOTracker",
    "SpanRecord",
    "Tracer",
    "null_tracer",
    "tracer_of",
]
