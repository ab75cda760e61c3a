"""Low-overhead trace spans for the scheduling cycle.

Design constraints: the hot path records ~30 spans per cycle
at a 100-300 ms cycle budget, so a span costs two
``time.perf_counter_ns()`` reads and ONE object append — no string
formatting, no dict merging, no allocation beyond the record itself.
The same span that traces a lane also accumulates the cycle's
``lanes[...]`` seconds (bench.py compatibility), so disabling tracing
(``VOLCANO_TPU_TRACE=0``) keeps the lane breakdown intact while
skipping the record append.

Threading model: ``span()`` (and the parent stack under it) belongs to
the single scheduling-cycle thread — exactly the thread that owns the
store lock for the cycle.  Other threads (the bind dispatcher, remote
RPC clients) contribute through ``event()``, which appends a
parentless record under the tracer's lock and never touches the stack.
``drain()`` hands the accumulated spans to the flight recorder at cycle
end.

Span timestamps are monotonic (``perf_counter_ns``) shifted to the
epoch by a per-tracer anchor captured at construction, so exported
traces from one process share one timeline.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Dict, List, Optional


class SpanRecord:
    """One completed span.  ``ts_ns`` is epoch nanoseconds; ``flow`` is
    the cross-cycle link id (the pipelined solve-id) or None; ``tid``
    names the logical track ("cycle" for the scheduling thread, "rpc" /
    "bind" for helper threads)."""

    __slots__ = ("name", "cat", "ts_ns", "dur_ns", "span_id",
                 "parent_id", "flow", "tid", "args")

    def __init__(self, name, cat, ts_ns, dur_ns, span_id, parent_id,
                 flow, tid, args):
        self.name = name
        self.cat = cat
        self.ts_ns = ts_ns
        self.dur_ns = dur_ns
        self.span_id = span_id
        self.parent_id = parent_id
        self.flow = flow
        self.tid = tid
        self.args = args

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "cat": self.cat,
            "ts_ns": self.ts_ns,
            "dur_ns": self.dur_ns,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "tid": self.tid,
        }
        if self.flow is not None:
            d["flow"] = self.flow
        if self.args:
            d["args"] = self.args
        return d


class _Span:
    """Context-manager handle; always times (the lane accumulation must
    survive tracing being disabled), appends a record only when the
    tracer is enabled."""

    __slots__ = ("tr", "name", "cat", "flow", "lanes", "lane", "args",
                 "t0", "span_id", "parent_id", "dur_ns")

    def __init__(self, tr, name, cat, flow, lanes, lane, args):
        self.tr = tr
        self.name = name
        self.cat = cat
        self.flow = flow
        self.lanes = lanes
        self.lane = lane
        self.args = args

    def __enter__(self):
        tr = self.tr
        if tr.enabled:
            # The parent stack exists only when recording: the shared
            # disabled tracer serves MANY stores (possibly from many
            # threads), so a disabled span must not touch shared state.
            stack = tr._stack
            self.parent_id = stack[-1] if stack else 0
            self.span_id = next(tr._ids)
            stack.append(self.span_id)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        tr = self.tr
        dur = self.dur_ns = t1 - self.t0
        lanes = self.lanes
        if lanes is not None:
            lane = self.lane
            lanes[lane] = lanes.get(lane, 0.0) + dur * 1e-9
        if tr.enabled:
            tr._stack.pop()
            args = self.args
            if exc_type is not None:
                args = dict(args) if args else {}
                args["error"] = exc_type.__name__
            tr._spans.append(SpanRecord(
                self.name, self.cat, tr._anchor_ns + self.t0, dur,
                self.span_id, self.parent_id, self.flow, "cycle", args,
            ))
        return False


class Tracer:
    """Per-store span sink.  One instance per ``ClusterStore``; the
    cycle thread records spans, ``drain()`` moves them into the flight
    recorder's per-cycle record."""

    def __init__(self, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("VOLCANO_TPU_TRACE", "1") != "0"
        self.enabled = bool(enabled)
        # epoch_ns = anchor + perf_counter_ns (captured together).
        self._anchor_ns = time.time_ns() - time.perf_counter_ns()
        self._spans: List[SpanRecord] = []
        self._stack: List[int] = []  # cycle-thread-only parent stack
        self._ids = itertools.count(1)
        # Guards _spans against cross-thread event() appends racing a
        # cycle-end drain(); span() itself stays lock-free (same thread
        # as drain()).
        self._lock = threading.Lock()

    # ------------------------------------------------------------- spans

    def span(self, name: str, cat: str = "cycle",
             flow: Optional[int] = None,
             lanes: Optional[Dict[str, float]] = None,
             lane: Optional[str] = None,
             args: Optional[dict] = None) -> _Span:
        """Cycle-thread span.  ``lanes``/``lane`` additionally
        accumulate the elapsed seconds into the cycle's lane dict (the
        bench-compatible ``last_cycle_lanes`` breakdown)."""
        return _Span(self, name, cat, flow, lanes,
                     lane if lane is not None else name, args)

    def event(self, name: str, cat: str, t0_ns: int, dur_ns: int,
              tid: str = "rpc", flow: Optional[int] = None,
              args: Optional[dict] = None) -> None:
        """Append a completed span from ANY thread (RPC clients, the
        bind dispatcher).  ``t0_ns`` is a ``perf_counter_ns`` reading."""
        if not self.enabled:
            return
        rec = SpanRecord(name, cat, self._anchor_ns + t0_ns, dur_ns,
                         next(self._ids), 0, flow, tid, args)
        with self._lock:
            self._spans.append(rec)

    def timed_event(self, name: str, cat: str = "rpc",
                    tid: str = "rpc", flow: Optional[int] = None,
                    args: Optional[dict] = None) -> "_TimedEvent":
        """Thread-safe time-this-block context manager over ``event()``
        — the one shared shape for RPC call sites (remote side-effect
        clients, the remote solver's send/fetch legs)."""
        return _TimedEvent(self, name, cat, tid, flow, args)

    def drain(self) -> List[SpanRecord]:
        """Hand the accumulated spans over (cycle end) and reset."""
        with self._lock:
            spans, self._spans = self._spans, []
        del self._stack[:]
        return spans


class _TimedEvent:
    """Times a block and appends it via ``Tracer.event`` (no parent
    stack, so safe from any thread and on the shared disabled
    tracer)."""

    __slots__ = ("tr", "name", "cat", "tid", "flow", "args", "t0")

    def __init__(self, tr, name, cat, tid, flow, args):
        self.tr = tr
        self.name = name
        self.cat = cat
        self.tid = tid
        self.flow = flow
        self.args = args

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self.tr
        if tr.enabled:
            tr.event(self.name, self.cat, self.t0,
                     time.perf_counter_ns() - self.t0, tid=self.tid,
                     flow=self.flow, args=self.args)
        return False


_NULL = Tracer(enabled=False)


def null_tracer() -> Tracer:
    """Shared disabled tracer for call sites whose cache object carries
    no tracer (bare test doubles standing in for a ClusterStore)."""
    return _NULL


def tracer_of(obj) -> Tracer:
    """The object's tracer, or the shared disabled one."""
    tr = getattr(obj, "tracer", None)
    return tr if tr is not None else _NULL
