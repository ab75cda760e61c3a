"""Store checkpoint / restore.

The counterpart of the JAX package's ``persistence.py``.  The reference
keeps its durable state in the API server and rebuilds its caches from
informers on restart (``pkg/scheduler/cache/cache.go:376-417``); this
store is its own system of record, so durability is serializing the spec
objects and replaying them through the event API on load -- the informer
resync, replayed from a file.

Persisted: pods, pod groups, queues, nodes, priority classes, namespace
weights, batch jobs, commands, config maps, secrets, services, network
policies, and the claim records (the one entry with durable status: phase
and provisioned node).  Everything derived (JobInfo / NodeInfo, the array
mirror, the device-resident snapshot, the cycle's caches) rebuilds through
the normal mutation path; the cache attributes the mirror and the
resources attach to spec objects (``_CACHE_ATTRS``) are stripped.

Two rules of the port:

- A checkpoint holds no ``torch`` object: its pickle stream names no
  ``torch`` module (``save_store`` checks), so it loads on a host without
  a card.
- Loading never imports the JAX package: ``load_store`` unpickles with an
  unpickler that resolves only ``volcano_tpu_torch`` classes and the few
  stdlib ones the specs use, so a checkpoint written by the JAX package
  raises a ``ValueError`` saying so.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import io
import os
import pickle
import pickletools
import tempfile
from typing import Optional

from .cache import ClusterStore

FORMAT_VERSION = 1

# Derived caches attached to spec objects (mirror feature blobs, resource
# caches, the gang's min-resource vector).  Their interned indices are
# only valid for the store that created them, so they never enter a
# checkpoint.  None holds a tensor.
_CACHE_ATTRS = ("_mirror_feat", "_req_cache", "_init_req_cache",
                "_minres_vec")

_PACKAGE = "volcano_tpu_torch"
# The stdlib globals a checkpoint of the port's specs may name.
_STDLIB = {
    "builtins": {"set", "frozenset", "list", "dict", "tuple", "str",
                 "bytes", "bytearray", "int", "float", "complex", "bool",
                 "slice", "range", "object"},
    "collections": {"OrderedDict", "defaultdict", "deque"},
    "copyreg": {"_reconstructor"},
    "datetime": {"datetime", "date", "time", "timedelta", "timezone"},
    # Controller-plane records (batch jobs, commands) are the port's
    # ``controllers.apis`` classes; plain namespaces load too.
    "types": {"SimpleNamespace"},
}


@contextlib.contextmanager
def _gc_paused():
    """The cyclic GC suspended (when it was on), as ``Scheduler.run_once``
    suspends it: a checkpoint of a 100,000-pod store allocates millions of
    objects, and each generation-2 walk they trigger scans them all."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _clean(obj):
    o = copy.copy(obj)
    d = getattr(o, "__dict__", None)
    if d is not None:
        for attr in _CACHE_ATTRS:
            d.pop(attr, None)
    return o


_STRING_OPS = {"SHORT_BINUNICODE", "BINUNICODE", "UNICODE", "BINUNICODE8",
               "STRING", "BINSTRING", "SHORT_BINSTRING"}
_GET_OPS = {"GET", "BINGET", "LONG_BINGET"}
_PUT_OPS = {"PUT", "BINPUT", "LONG_BINPUT"}


def _globals(blob: bytes):
    """The (module, name) pairs a pickle stream names.  Only the pushes
    that can feed a ``STACK_GLOBAL`` are tracked: string literals and
    memo reads of them (a module string written once is read back from
    the memo for its next class)."""
    pushed = []  # recent pushes: the string, or None for anything else
    memo = {}
    for op, arg, _pos in pickletools.genops(blob):
        name = op.name
        if name in _STRING_OPS:
            pushed.append(arg)
        elif name in _GET_OPS:
            pushed.append(memo.get(arg))
        elif name == "MEMOIZE":
            memo[len(memo)] = pushed[-1] if pushed else None
        elif name in _PUT_OPS:
            memo[arg] = pushed[-1] if pushed else None
        elif name == "STACK_GLOBAL":
            if len(pushed) >= 2 and isinstance(pushed[-2], str):
                yield pushed[-2], pushed[-1]
            pushed.append(None)
        elif name in ("GLOBAL", "INST"):
            yield tuple(arg.split(" ", 1))
            pushed.append(None)
        else:
            pushed.append(None)
        if len(pushed) > 64:
            del pushed[:32]


def _check_no_torch(blob: bytes) -> None:
    """Raise when the stream names a ``torch`` module.  The full opcode
    walk runs only when the bytes ``torch`` occur at all (a pod or node
    name may hold them)."""
    if b"torch" not in blob:
        return
    for module, name in _globals(blob):
        if module == "torch" or module.startswith("torch."):
            raise TypeError(
                f"checkpoint would hold a torch object ({module}.{name}); "
                "spec objects must carry host values only")


class _Unpickler(pickle.Unpickler):
    """Resolves only the port's classes and ``_STDLIB``: a checkpoint of
    the JAX package (or anything else) is refused before any import."""

    def find_class(self, module, name):
        top = module.split(".")[0]
        if top == _PACKAGE:
            return super().find_class(module, name)
        if name in _STDLIB.get(module, ()):
            return super().find_class(module, name)
        if top == "volcano_tpu":
            raise ValueError(
                f"checkpoint written by the JAX package ({module}.{name}): "
                "volcano_tpu_torch loads only its own checkpoints")
        raise ValueError(
            f"checkpoint names {module}.{name}, which volcano_tpu_torch "
            "does not load")


def save_store(store: ClusterStore, path: str) -> None:
    """Atomically write a point-in-time snapshot of the store's specs."""
    with store._lock, _gc_paused():
        payload = {
            "version": FORMAT_VERSION,
            "nodes": [
                ni.node for ni in store.nodes.values() if ni.node is not None
            ],
            "queues": list(store.raw_queues.values()),
            "pod_groups": [_clean(pg) for pg in store.pod_groups.values()],
            "pods": [_clean(p) for p in store.pods.values()],
            "priority_classes": list(store.priority_classes.values()),
            "namespace_weights": dict(store.namespace_weights),
            "batch_jobs": list(store.batch_jobs.values()),
            "commands": list(store.commands.values()),
            "config_maps": dict(store.config_maps),
            "secrets": dict(store.secrets),
            "services": dict(store.services),
            "network_policies": dict(store.network_policies),
            "pvcs": dict(store.pvcs),
        }
        # Serialized while the lock is held: the payload holds live
        # objects that scheduler and controller threads mutate.
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    _check_no_torch(blob)
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".vctpu-ckpt-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_store(path: str,
               store: Optional[ClusterStore] = None) -> ClusterStore:
    """Rehydrate a store by replaying the snapshot through the event API
    (derived state rebuilds as it does for live events)."""
    with _gc_paused():
        with open(path, "rb") as f:
            payload = _Unpickler(io.BytesIO(f.read())).load()
        version = payload.get("version") if isinstance(payload, dict) \
            else None
        if version != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version!r}")
        store = store or ClusterStore()
        _replay(store, payload)
    return store


def _replay(store: ClusterStore, payload: dict) -> None:
    for node in payload["nodes"]:
        store.add_node(node)
    for queue in payload["queues"]:
        store.add_queue(queue)
    for pc in payload["priority_classes"]:
        store.add_priority_class(pc)
    for pg in payload["pod_groups"]:
        store.add_pod_group(pg)
    for pod in payload["pods"]:
        store.add_pod(pod)
    with store._lock:
        store.namespace_weights.update(payload["namespace_weights"])
        for job in payload["batch_jobs"]:
            store.batch_jobs[job.key] = job
        for cmd in payload["commands"]:
            store.commands[cmd.name] = cmd
        store.config_maps.update(payload["config_maps"])
        store.secrets.update(payload["secrets"])
        store.services.update(payload["services"])
        store.network_policies.update(payload.get("network_policies", {}))
        store.pvcs.update(payload.get("pvcs", {}))
