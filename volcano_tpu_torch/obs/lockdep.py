"""Annotation-derived runtime lock enforcement (``VOLCANO_TPU_LOCKDEP=1``).

The ``# guarded-by:`` comments of the port's lock files describe a runtime
contract: *this attribute is only touched while that lock is held*.  This
module turns them -- parsed by ``obs/annotations.py`` over its
``LOCK_FILES`` -- into live enforcement:

- ``enable_lockdep(store)`` installs class-level data descriptors over
  every ``# guarded-by:`` attribute of the ``LOCK_FILES`` classes.  A
  get/set on an **armed** instance asserts the declared lock is held by
  the current thread; a miss is reported to the store's auditor ring as
  a ``lockdep-violation`` anomaly (attribute, declared lock, thread
  name, trimmed stack) -- reported, never raised, so a probe cannot
  crash the scheduler it is observing.
- Every ``threading.Lock``/``RLock``/``Condition`` reachable from the
  store's object graph is wrapped in a ``_LockProxy`` that maintains a
  per-thread held-lock multiset plus a process-wide acquisition-order
  graph.  A new edge that closes a cycle (thread 1 takes A then B,
  thread 2 takes B then A) is reported once as a ``lock-order-cycle``
  anomaly with the offending path.

Lock identity is BY NAME (the attribute name the lock lives under):
same-name edges (``store._lock`` nesting ``auditor._lock``: both are
``_lock``) are skipped in the order graph, and holding any ``_lock``
satisfies a ``guarded-by: _lock``.

Static suppressions are honored at runtime: an access whose source line
(or contiguous comment block above) carries ``# vclint:
disable=VCL101/VCL102 -- reason`` is not reported.

The graph walk (``attach``) enters only objects whose class lives in
``volcano_tpu_torch`` (and containers): torch tensors, CUDA streams and
events, numpy arrays and the JAX package's objects are never entered.

Kill switch: everything here is gated on ``VOLCANO_TPU_LOCKDEP`` (off
by default).  When off, ``enable_lockdep`` returns False without
touching any class and the constructor-site ``attach`` hooks are a
single global-flag test.  Once installed, the descriptors stay on the
port's classes for the life of the process (inert while disarmed): every
access to a guarded attribute then goes through Python.

Stdlib only.
"""


from __future__ import annotations

import os
import re
import sys
import threading
import traceback
from typing import Dict, List, Optional, Set

# ------------------------------------------------------------------ switch

def lockdep_on() -> bool:
    return os.environ.get("VOLCANO_TPU_LOCKDEP", "0") not in ("0", "")


# Armed process-wide once enable_lockdep succeeds; reset() clears it.
# Checked FIRST on every hook so the off path costs one global load.
_active = False

MAX_REPORTS = 64  # process-wide anomaly cap: a hot broken site must
#                   not flood the ring that is trying to describe it

# ------------------------------------------------- per-thread held tracking


class _Held(threading.local):
    def __init__(self):
        self.counts: Dict[str, int] = {}  # lock name -> recursion depth
        self.order: List[str] = []        # distinct names, acquire order


_held = _Held()


def held_locks() -> Dict[str, int]:
    """Snapshot of the calling thread's held-lock multiset (tests)."""
    return dict(_held.counts)


def _holding(name: str) -> bool:
    return _held.counts.get(name, 0) > 0


def _note_acquire(name: str) -> None:
    depth = _held.counts.get(name, 0)
    _held.counts[name] = depth + 1
    if depth == 0:
        for prev in _held.order:
            if prev != name:  # same-name nesting: one lock by name
                _order_edge(prev, name)
        _held.order.append(name)


def _note_release(name: str) -> None:
    depth = _held.counts.get(name, 0)
    if depth <= 1:
        _held.counts.pop(name, None)
        try:
            _held.order.remove(name)
        except ValueError:
            pass
    else:
        _held.counts[name] = depth - 1


# ------------------------------------------------------- lock-order graph

_graph_lock = threading.Lock()
_edges: Dict[str, Set[str]] = {}      # guarded-by: _graph_lock
_reported_cycles: Set[tuple] = set()  # guarded-by: _graph_lock


def _reaches(src: str, dst: str) -> Optional[List[str]]:
    """Path src -> ... -> dst over ``_edges`` (caller holds
    ``_graph_lock``), or None."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _edges.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _order_edge(held: str, acquiring: str) -> None:
    with _graph_lock:
        succ = _edges.setdefault(held, set())
        if acquiring in succ:
            return
        succ.add(acquiring)
        back = _reaches(acquiring, held)
        if back is None:
            return
        key = (held, acquiring)
        if key in _reported_cycles:
            return
        _reported_cycles.add(key)
        cycle = back + [acquiring]
    _report_cycle(held, acquiring, cycle)


# ------------------------------------------------------------- lock proxy


class _LockProxy:
    """Wraps a Lock/RLock/Condition, tracking acquisition by the
    attribute NAME it was found under.  Unknown methods (``wait``,
    ``notify`` ...) delegate -- a Condition's internal release inside
    ``wait`` is deliberately not tracked: attributes guarded by the
    condition are owned for the whole ``with`` block, which is exactly
    the static annotation's semantics."""

    __slots__ = ("_vcld_lock", "_vcld_name")

    def __init__(self, lock, name: str):
        self._vcld_lock = lock
        self._vcld_name = name

    def acquire(self, *args, **kwargs):
        got = self._vcld_lock.acquire(*args, **kwargs)
        if got:
            _note_acquire(self._vcld_name)
        return got

    def release(self, *args, **kwargs):
        self._vcld_lock.release(*args, **kwargs)
        _note_release(self._vcld_name)

    def __enter__(self):
        got = self._vcld_lock.__enter__()
        _note_acquire(self._vcld_name)
        return got

    def __exit__(self, *exc):
        _note_release(self._vcld_name)
        return self._vcld_lock.__exit__(*exc)

    def __getattr__(self, item):
        return getattr(object.__getattribute__(self, "_vcld_lock"), item)

    def __repr__(self):
        return f"<lockdep proxy '{self._vcld_name}' {self._vcld_lock!r}>"


_LOCK_TYPES = (type(threading.Lock()), type(threading.RLock()),
               threading.Condition)


# -------------------------------------------------------------- reporting

_reporters_lock = threading.Lock()
_reporters: List[object] = []        # auditors; guarded-by: _reporters_lock
_report_count = 0                    # guarded-by: _reporters_lock
_seen_violations: Set[tuple] = set()  # guarded-by: _reporters_lock


def _deliver(anomaly) -> None:
    global _report_count
    with _reporters_lock:
        if _report_count >= MAX_REPORTS:
            return
        _report_count += 1
        targets = list(_reporters)
    for auditor in targets:
        try:
            auditor.report(anomaly)
        except Exception:
            pass  # the probe must never take down the probed


def _stack_summary(frame, limit: int = 6) -> List[str]:
    out = []
    for entry in traceback.extract_stack(frame, limit=limit):
        out.append(f"{entry.filename}:{entry.lineno}:{entry.name}")
    return out


def _report_cycle(held: str, acquiring: str, cycle: List[str]) -> None:
    from .audit import Anomaly

    _deliver(Anomaly("lock-order-cycle", {
        "held": held,
        "acquiring": acquiring,
        "cycle": cycle,
        "thread": threading.current_thread().name,
        "stack": _stack_summary(sys._getframe(2)),
    }))


# Split so the suppression scanner does not read this pattern itself
# as a (malformed) suppression comment.
_DISABLE_RE = re.compile(
    r"#\s*vclint:\s*"
    r"disable=([A-Za-z0-9,\s]+?)(?:--|$)")
_suppress_cache: Dict[tuple, bool] = {}


def _static_suppressed(filename: str, lineno: int, code: str) -> bool:
    """True when the access site carries a suppression for ``code`` --
    on the same line, or in a contiguous comment block directly above."""
    key = (filename, lineno, code)
    cached = _suppress_cache.get(key)
    if cached is not None:
        return cached
    import linecache

    def _match(text: str) -> bool:
        m = _DISABLE_RE.search(text)
        if not m:
            return False
        codes = {c.strip() for c in m.group(1).split(",")}
        return code in codes or "all" in codes

    lines = linecache.getlines(filename)
    hit = False
    if 0 < lineno <= len(lines):
        if _match(lines[lineno - 1]):
            hit = True
        else:
            i = lineno - 1
            while i >= 1 and lines[i - 1].lstrip().startswith("#"):
                if _match(lines[i - 1]):
                    hit = True
                    break
                i -= 1
    _suppress_cache[key] = hit
    return hit


# Methods exempt from guard checks: construction and teardown run before
# or after the object is shared.
_EXEMPT_FRAMES = {"__init__", "__new__", "__del__", "__repr__"}


def _report_violation(cls_name: str, attr: str, lock: str,
                      access: str, frame) -> None:
    code = "VCL102" if access == "write" else "VCL101"
    if frame is not None:
        if frame.f_code.co_name in _EXEMPT_FRAMES:
            return
        if _static_suppressed(frame.f_code.co_filename, frame.f_lineno,
                              code):
            return
    key = (cls_name, attr, access)
    with _reporters_lock:
        if key in _seen_violations:
            return
        _seen_violations.add(key)
    from .audit import Anomaly

    _deliver(Anomaly("lockdep-violation", {
        "class": cls_name,
        "attribute": attr,
        "lock": lock,
        "access": access,
        "thread": threading.current_thread().name,
        "held": sorted(_held.counts),
        "stack": _stack_summary(frame),
    }))


# ------------------------------------------------------------ descriptors

_MISSING = object()


class _GuardedDescriptor:
    """Class-level data descriptor over one ``# guarded-by:``
    attribute.  Values live in the instance ``__dict__`` under the same
    name (a data descriptor wins the lookup, so storage stays where
    debuggers and ``vars()`` expect it).  Enforcement fires only for
    instances armed by ``attach`` while lockdep is active -- everything
    else pays two dict probes."""

    __slots__ = ("attr", "lock", "cls_name", "default")

    def __init__(self, attr: str, lock: str, cls_name: str,
                 default=_MISSING):
        self.attr = attr
        self.lock = lock
        self.cls_name = cls_name
        self.default = default

    def __get__(self, obj, objtype=None):
        if obj is None:
            if self.default is _MISSING:
                return self
            return self.default
        d = obj.__dict__
        if _active and d.get("_vclockdep_armed") \
                and not _holding(self.lock):
            _report_violation(self.cls_name, self.attr, self.lock,
                              "read", sys._getframe(1))
        val = d.get(self.attr, _MISSING)
        if val is _MISSING:
            if self.default is _MISSING:
                raise AttributeError(
                    f"{self.cls_name} has no attribute {self.attr!r}")
            return self.default
        return val

    def __set__(self, obj, value):
        d = obj.__dict__
        if _active and d.get("_vclockdep_armed") \
                and not _holding(self.lock):
            _report_violation(self.cls_name, self.attr, self.lock,
                              "write", sys._getframe(1))
        d[self.attr] = value

    def __delete__(self, obj):
        obj.__dict__.pop(self.attr, None)


# ------------------------------------------------------------ installation

_install_lock = threading.Lock()
_installed = False
_wrapped_classes: Set[type] = set()  # guarded-by: _install_lock


def _class_allows_descriptors(cls: type) -> bool:
    # __slots__ classes have no instance __dict__ for value storage;
    # the runtime skips them.
    return not any("__slots__" in k.__dict__
                   for k in cls.__mro__ if k is not object)


def _install_descriptors(ann) -> None:
    global _installed
    with _install_lock:
        if _installed:
            return
        import importlib

        for rel in ann.LOCK_FILES:
            mod_name = rel[:-3].replace("/", ".")
            try:
                mod = importlib.import_module(mod_name)
                with open(mod.__file__, "r") as f:
                    source = f.read()
                model = ann.build_model(rel, source)
            except Exception:
                continue  # a missing optional module never blocks the rest
            for info in model.classes:
                cls = getattr(mod, info.name, None)
                if (not isinstance(cls, type) or not info.guarded
                        or not _class_allows_descriptors(cls)):
                    continue
                for attr, g in info.guarded.items():
                    existing = cls.__dict__.get(attr, _MISSING)
                    if existing is not _MISSING and (
                            hasattr(existing, "__get__")
                            or hasattr(existing, "__set__")):
                        continue  # property/slot: already mediated
                    setattr(cls, attr, _GuardedDescriptor(
                        attr, g.lock, f"{mod_name}.{info.name}",
                        default=existing))
                _wrapped_classes.add(cls)
        _installed = True


# ------------------------------------------------------------- attachment

def attach(obj) -> None:
    """Walk ``obj``'s object graph: wrap every reachable lock in a
    ``_LockProxy`` and arm every instance of a descriptor-wrapped
    class.  Constructor call sites (the store, the bind dispatcher)
    invoke this unconditionally -- the flag test below is the entire
    cost when lockdep is off."""
    if not _active:
        return
    seen = set()
    stack = [obj]
    while stack:
        o = stack.pop()
        if id(o) in seen:
            continue
        seen.add(id(o))
        if isinstance(o, (list, tuple, set, frozenset)):
            stack.extend(o)
            continue
        if isinstance(o, dict):
            stack.extend(o.values())
            continue
        cls = type(o)
        if not getattr(cls, "__module__", "").startswith(
                "volcano_tpu_torch"):
            continue
        d = getattr(o, "__dict__", None)
        if d is None:
            continue
        if cls in _wrapped_classes:
            d["_vclockdep_armed"] = True
        for name, val in list(d.items()):
            if isinstance(val, _LOCK_TYPES):
                d[name] = _LockProxy(val, name)
            elif isinstance(val, (_LockProxy, str, bytes, int, float,
                                  bool, type(None))):
                continue
            else:
                stack.append(val)


def register_reporter(auditor) -> None:
    with _reporters_lock:
        if auditor not in _reporters:
            _reporters.append(auditor)


def enable_lockdep(store) -> bool:
    """Arm lockdep over ``store``'s object graph.  Called at the tail
    of ``ClusterStore.__init__``; returns False (having changed
    nothing) when the kill switch is off."""
    global _active
    if not lockdep_on():
        return False
    from . import annotations

    _install_descriptors(annotations)
    _active = True
    register_reporter(store.auditor)
    attach(store)
    return True


def reset() -> None:
    """Disarm enforcement and drop accumulated state (tests).  Already
    installed descriptors and proxies stay in place -- with ``_active``
    cleared they are inert pass-throughs."""
    global _active, _report_count
    _active = False
    with _reporters_lock:
        _reporters.clear()
        _seen_violations.clear()
        _report_count = 0
    with _graph_lock:
        _edges.clear()
        _reported_cycles.clear()


def stats() -> dict:
    """Debug snapshot (tests, /debug handlers)."""
    with _reporters_lock:
        reports = _report_count
        violations = len(_seen_violations)
    with _graph_lock:
        edges = sum(len(v) for v in _edges.values())
        cycles = len(_reported_cycles)
    return {"active": _active, "reports": reports,
            "violations": violations, "order_edges": edges,
            "order_cycles": cycles}
