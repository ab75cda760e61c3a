"""Observability the fast cycle writes: trace spans (``trace``) whose lane
times land in ``store.last_cycle_lanes``, and the cycle flight recorder
(``recorder``).  Stdlib-only, so the store wires them unconditionally.

The JAX package's audit, SLO and journey modules are not ported: the
port's store leaves ``auditor`` and ``journey`` as None, which the cycle
tolerates (ROADMAP.md, queue 1)."""

from .recorder import CycleRecord, FlightRecorder
from .trace import SpanRecord, Tracer, null_tracer, tracer_of

__all__ = [
    "CycleRecord",
    "FlightRecorder",
    "SpanRecord",
    "Tracer",
    "null_tracer",
    "tracer_of",
]
