"""Chrome/Perfetto ``trace_event`` export of flight-recorder cycles.

The counterpart of the JAX package's ``obs/export.py``; it reads the
port's own ``obs/recorder.CycleRecord``.

Produces the JSON object format (``{"traceEvents": [...]}``) that both
``chrome://tracing`` and https://ui.perfetto.dev load directly:

- every span becomes one complete event (``"ph": "X"``, microsecond
  ``ts``/``dur``); parent/child structure is conveyed by nesting on the
  same track, which the viewers reconstruct from the timestamps;
- spans sharing a ``flow`` id (the pipelined solve-id) are additionally
  linked with flow arrows: ``"ph": "s"`` at the first span of the flow
  (the dispatch in cycle N), ``"ph": "t"`` steps in between, and
  ``"ph": "f", "bp": "e"`` at the last (the commit in cycle N+1) — the
  visible dispatch→commit arrow across the cycle boundary;
- one instant event (``"ph": "i"``) per device event (crash /
  budget-degradation) and per drop-reason tally, so "17 rows dropped:
  capacity-taken" is readable at the cycle where it happened;
- metadata events name the process and the logical threads ("cycle",
  "rpc", "bind");
- pod journeys (obs/journey.py) export as ASYNC tracks: one
  ``"ph": "b"``/``"e"`` pair per pod uid bracketing its timeline, with
  one ``"ph": "n"`` instant per journey event (kind / shard /
  drop-reason args).  A journey event carrying a solve-id joins that
  solve's flow, so the arrow runs dispatch span → pod bind — the
  pod-centric view laid over the cycle-centric spans.

Spec: the Trace Event Format document (Google, monorail-hosted); only
the stable subset above is emitted.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

PID = 1
_TID_ORDER = ("cycle", "rpc", "bind")


def _tid_of(name: str, table: Dict[str, int]) -> int:
    tid = table.get(name)
    if tid is None:
        tid = table[name] = len(table) + 1
    return tid


def trace_events(records: Iterable,
                 journey: Optional[Iterable[dict]] = None) -> List[dict]:
    """Flatten CycleRecords into a trace_event list (ts in us).
    ``journey`` is an optional iterable of journey rows
    (``JourneyLog.trace_rows()``) exported as async per-pod tracks."""
    events: List[dict] = []
    tid_table: Dict[str, int] = {}
    for known in _TID_ORDER:
        _tid_of(known, tid_table)
    # flow id -> list of (ts_us, index into events) for arrow phases.
    flows: Dict[int, List[int]] = {}

    for rec in records:
        for span in rec.spans:
            ts_us = span.ts_ns / 1e3
            args = dict(span.args) if span.args else {}
            args.setdefault("cycle_seq", rec.seq)
            ev = {
                "name": span.name,
                "cat": span.cat,
                "ph": "X",
                "ts": ts_us,
                "dur": span.dur_ns / 1e3,
                "pid": PID,
                "tid": _tid_of(span.tid, tid_table),
                "args": args,
            }
            events.append(ev)
            if span.flow is not None:
                flows.setdefault(int(span.flow), []).append(
                    len(events) - 1
                )
        base_ts = rec.t_wall * 1e6
        for msg in rec.device_events:
            events.append({
                "name": msg, "cat": "device", "ph": "i", "s": "p",
                "ts": base_ts, "pid": PID,
                "tid": _tid_of("cycle", tid_table),
                "args": {"cycle_seq": rec.seq},
            })
        for reason, count in sorted(rec.drop_reasons.items()):
            events.append({
                "name": f"drop:{reason}", "cat": "staleness",
                "ph": "i", "s": "t", "ts": base_ts, "pid": PID,
                "tid": _tid_of("cycle", tid_table),
                "args": {"cycle_seq": rec.seq, "rows": count},
            })
        # Audit anomalies: one process-scoped instant per
        # finding, so a correctness failure is visible on the latency
        # timeline at the cycle where it was detected.
        for anom in getattr(rec, "anomalies", ()) or ():
            events.append({
                "name": f"anomaly:{anom.get('reason', '?')}",
                "cat": "audit", "ph": "i", "s": "p", "ts": base_ts,
                "pid": PID, "tid": _tid_of("cycle", tid_table),
                "args": {"cycle_seq": rec.seq,
                         "detail": anom.get("detail", {})},
            })

    # Pod-journey async tracks: rows are chronological per uid (the
    # ring preserves capture order); emitted BEFORE the flow arrows so
    # a solve-id-carrying journey instant joins its solve's flow.
    if journey:
        jtid = _tid_of("journey", tid_table)
        by_uid: Dict[str, List[dict]] = {}
        for row in journey:
            by_uid.setdefault(row["uid"], []).append(row)
        for uid, rows in by_uid.items():
            name = f"pod {uid}"
            events.append({
                "name": name, "cat": "journey", "ph": "b", "id": uid,
                "ts": rows[0]["ts_us"], "pid": PID, "tid": jtid,
            })
            for row in rows:
                args = {k: v for k, v in row.items()
                        if k not in ("uid", "ts_us")}
                events.append({
                    "name": row["kind"], "cat": "journey", "ph": "n",
                    "id": uid, "ts": row["ts_us"], "pid": PID,
                    "tid": jtid, "args": args,
                })
                sid = row.get("solve_id")
                if sid:
                    flows.setdefault(int(sid), []).append(
                        len(events) - 1)
            events.append({
                "name": name, "cat": "journey", "ph": "e", "id": uid,
                "ts": rows[-1]["ts_us"], "pid": PID, "tid": jtid,
            })

    # Flow arrows: start at the chronologically first span of each flow,
    # finish at the last, step through the middle.
    for flow_id, idxs in flows.items():
        idxs.sort(key=lambda i: events[i]["ts"])
        for pos, i in enumerate(idxs):
            src = events[i]
            ph = "s" if pos == 0 else (
                "f" if pos == len(idxs) - 1 else "t"
            )
            fev = {
                "name": "solve", "cat": "flow", "ph": ph,
                "id": flow_id, "ts": src["ts"], "pid": PID,
                "tid": src["tid"],
            }
            if ph == "f":
                fev["bp"] = "e"
            events.append(fev)

    # Metadata: process + track names.
    meta = [{
        "name": "process_name", "ph": "M", "pid": PID,
        "args": {"name": "volcano-tpu scheduler"},
    }]
    for name, tid in tid_table.items():
        meta.append({
            "name": "thread_name", "ph": "M", "pid": PID, "tid": tid,
            "args": {"name": name},
        })
    return meta + events


def perfetto_trace(records: Iterable,
                   journey: Optional[Iterable[dict]] = None) -> dict:
    """The JSON-object container both viewers accept."""
    return {
        "traceEvents": trace_events(records, journey=journey),
        "displayTimeUnit": "ms",
    }


def write_trace(path: str, records: Iterable,
                journey: Optional[Iterable[dict]] = None) -> str:
    """Dump records to ``path`` as Perfetto-loadable JSON; returns the
    path."""
    with open(path, "w") as f:
        json.dump(perfetto_trace(records, journey=journey), f)
    return path
