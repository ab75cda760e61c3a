"""Dense array schema: the device-side mirror of the cluster snapshot.

The device-side replacement for the reference's per-object data model
(``pkg/scheduler/api``): the Session snapshot (pending Tasks x Nodes x Queues)
is flattened into fixed-width struct-of-arrays so predicates, scorers, and the
assignment solver run as batched tensor programs.

Layout decisions (SURVEY.md section 7 array schema):
- Resources are fixed-width float32 vectors: slot 0 = milli-CPU,
  slot 1 = memory bytes, slots 2.. = extended scalar resources in
  milli-units.  The epsilon quanta of ``resource_info.go:70-72`` become a
  per-slot EPS vector so the fit kernels reproduce ``LessEqual``
  (resource_info.go:286-320) exactly.
- Label selectors / taints+tolerations / host ports are bitsets over
  session-scoped dictionaries (built per snapshot from the values that
  actually occur), so the predicate kernels are pure boolean algebra.
- Tasks are pre-sorted host-side into processing order with each job's tasks
  contiguous; ``task_job`` maps task row -> job row.  Shapes are padded to
  buckets (the JAX package's shapes, which the port keeps).

Host string<->index maps live in ``IndexMaps``; the authoritative object
store stays on host (``volcano_tpu_torch.cache``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..api import (
    CPU,
    FABRIC_LEVELS,
    MEMORY,
    MIN_MEMORY,
    MIN_MILLI_CPU,
    MIN_MILLI_SCALAR,
    ClusterInfo,
    JobInfo,
    NodeInfo,
    Resource,
    TaskInfo,
    TaskStatus,
)

F = np.float32
I = np.int32


# NumPy CSR helpers: the JAX package's ``native.py`` fallbacks
# (native.py:183-215); the port carries no C++ serializer.


def _pack_bits_rows(indices, offsets, rows: int, words: int) -> np.ndarray:
    """CSR -> [rows, words] uint32 bitsets."""
    idx = np.ascontiguousarray(indices, np.int32)
    off = np.ascontiguousarray(offsets, np.int64)
    out = np.zeros((rows, words), np.uint32)
    if len(idx):
        counts = np.diff(off)
        row_of = np.repeat(np.arange(rows, dtype=np.int64), counts)
        valid = (idx >= 0) & (idx < words * 32)
        r, b = row_of[valid], idx[valid].astype(np.int64)
        np.bitwise_or.at(out, (r, b >> 5), (1 << (b & 31)).astype(np.uint32))
    return out


def _scatter_rows_f32(slots, values, offsets, rows: int,
                      width: int) -> np.ndarray:
    """CSR (slot, value) pairs -> [rows, width] float32."""
    slot = np.ascontiguousarray(slots, np.int32)
    val = np.ascontiguousarray(values, np.float32)
    off = np.ascontiguousarray(offsets, np.int64)
    out = np.zeros((rows, width), np.float32)
    if len(slot):
        counts = np.diff(off)
        row_of = np.repeat(np.arange(rows, dtype=np.int64), counts)
        valid = (slot >= 0) & (slot < width)
        out[row_of[valid], slot[valid]] = val[valid]
    return out


class ResourceSlots:
    """Session-scoped mapping of resource names to vector slots."""

    def __init__(self, scalar_names: Sequence[str] = ()):  # noqa: D401
        self.scalar_names: List[str] = list(scalar_names)
        self.names: List[str] = [CPU, MEMORY] + self.scalar_names
        self.index: Dict[str, int] = {n: i for i, n in enumerate(self.names)}

    @property
    def width(self) -> int:
        return len(self.names)

    def eps(self) -> np.ndarray:
        """Per-slot minimum quanta (resource_info.go:70-72)."""
        e = np.full((self.width,), MIN_MILLI_SCALAR, dtype=F)
        e[0] = MIN_MILLI_CPU
        e[1] = MIN_MEMORY
        return e

    def is_scalar_slot(self) -> np.ndarray:
        """Mask of extended-resource slots (the ones LessEqual may skip)."""
        m = np.ones((self.width,), dtype=bool)
        m[0] = False
        m[1] = False
        return m

    def vec(self, r: Resource) -> np.ndarray:
        v = np.zeros((self.width,), dtype=F)
        v[0] = r.milli_cpu
        v[1] = r.memory
        if r.scalars:
            for name, quant in r.scalars.items():
                idx = self.index.get(name)
                if idx is not None:
                    v[idx] = quant
        return v

    def csr_append(self, r: Resource, slot_buf: list, val_buf: list) -> None:
        """Append the (slot, value) pairs of ``r`` to CSR buffers (consumed
        by ``_scatter_rows_f32``)."""
        if r.milli_cpu:
            slot_buf.append(0)
            val_buf.append(r.milli_cpu)
        if r.memory:
            slot_buf.append(1)
            val_buf.append(r.memory)
        if r.scalars:
            index = self.index
            for name, quant in r.scalars.items():
                idx = index.get(name)
                if idx is not None and quant:
                    slot_buf.append(idx)
                    val_buf.append(quant)

    @classmethod
    def for_cluster(cls, cluster: ClusterInfo) -> "ResourceSlots":
        names = set()
        for node in cluster.nodes.values():
            if node.allocatable.scalars:
                names.update(node.allocatable.scalars.keys())
        for job in cluster.jobs.values():
            for task in job.tasks.values():
                if task.resreq.scalars:
                    names.update(task.resreq.scalars.keys())
                if task.init_resreq.scalars:
                    names.update(task.init_resreq.scalars.keys())
        return cls(sorted(names))


def pad_dim(n: int, minimum: int = 8) -> int:
    """Bucket a dimension to limit distinct compiled shapes."""
    b = minimum
    while b < n:
        b *= 2
    return b


class NodeArrays(NamedTuple):
    """Struct-of-arrays over nodes.  All [N, R] float32 unless noted."""

    allocatable: np.ndarray  # [N, R]
    idle: np.ndarray  # [N, R]
    used: np.ndarray  # [N, R]
    releasing: np.ndarray  # [N, R]
    pipelined: np.ndarray  # [N, R]
    ready: np.ndarray  # [N] bool: Ready phase and schedulable
    real: np.ndarray  # [N] bool: row is a real node (not padding)
    max_tasks: np.ndarray  # [N] int32 (pods capacity; 0 = unlimited)
    num_tasks: np.ndarray  # [N] int32 resident task count
    label_bits: np.ndarray  # [N, LW] uint32 packed label-pair bitset
    taint_bits: np.ndarray  # [N, TW] uint32 packed NoSchedule/NoExecute taints
    port_bits: np.ndarray  # [N, PW] uint32 packed used host ports
    # Fabric coordinates (rack/slice/host codes from the
    # fabric.volcano-tpu/* labels, ops/FABRIC_LEVELS order);
    # -1 = coordinate absent.  Interned per encode in first-seen order
    # over the sorted node names, so identical clusters encode
    # identically.
    fabric: np.ndarray  # [N, FL] int32


class TaskArrays(NamedTuple):
    """Struct-of-arrays over the tasks handed to the solver (usually the
    pending tasks of schedulable jobs, in processing order)."""

    req: np.ndarray  # [P, R] Resreq
    init_req: np.ndarray  # [P, R] InitResreq
    job: np.ndarray  # [P] int32 -> job row
    priority: np.ndarray  # [P] int32
    real: np.ndarray  # [P] bool
    sel_bits: np.ndarray  # [P, LW] required node-label pairs (AND)
    has_selector: np.ndarray  # [P] bool
    # Required node-affinity: up to MAX_AFFINITY_TERMS OR-alternative label
    # bitsets per task (k8s nodeSelectorTerms are alternatives).
    aff_bits: np.ndarray  # [P, A, LW]
    aff_terms: np.ndarray  # [P] int32 number of alternatives (0 = none)
    tol_bits: np.ndarray  # [P, TW] tolerated taints
    port_bits: np.ndarray  # [P, PW] requested host ports
    # Preferred node affinity (soft): per-term label bitsets and scores
    # pre-normalized to [0, 10] (CalculateNodeAffinityPriority semantics).
    pref_bits: np.ndarray  # [P, AP, LW]
    pref_w: np.ndarray  # [P, AP] float32


class JobArrays(NamedTuple):
    min_available: np.ndarray  # [J] int32
    queue: np.ndarray  # [J] int32 -> queue row
    priority: np.ndarray  # [J] int32
    ready_base: np.ndarray  # [J] int32 ReadyTaskNum before this cycle
    real: np.ndarray  # [J] bool


class QueueArrays(NamedTuple):
    weight: np.ndarray  # [Q] float32
    capability: np.ndarray  # [Q, R]
    has_capability: np.ndarray  # [Q] bool
    reclaimable: np.ndarray  # [Q] bool
    deserved: np.ndarray  # [Q, R] (filled by the proportion plugin)
    allocated: np.ndarray  # [Q, R] allocated at session open
    real: np.ndarray  # [Q] bool


class ClusterArrays(NamedTuple):
    """The full device-side snapshot."""

    nodes: NodeArrays
    tasks: TaskArrays
    jobs: JobArrays
    queues: QueueArrays
    eps: np.ndarray  # [R] per-slot epsilon quanta
    scalar_slot: np.ndarray  # [R] bool mask of extended-resource slots


@dataclass
class IndexMaps:
    """Host-side string<->index maps for one encoded snapshot."""

    slots: ResourceSlots
    node_names: List[str] = field(default_factory=list)
    node_index: Dict[str, int] = field(default_factory=dict)
    task_uids: List[str] = field(default_factory=list)
    task_infos: List[TaskInfo] = field(default_factory=list)
    job_ids: List[str] = field(default_factory=list)
    job_index: Dict[str, int] = field(default_factory=dict)
    queue_names: List[str] = field(default_factory=list)
    queue_index: Dict[str, int] = field(default_factory=dict)
    label_dict: Dict[Tuple[str, str], int] = field(default_factory=dict)
    taint_dict: Dict[Tuple[str, str, str], int] = field(default_factory=dict)
    port_dict: Dict[int, int] = field(default_factory=dict)

    @property
    def n_nodes(self) -> int:
        return len(self.node_names)

    @property
    def n_tasks(self) -> int:
        return len(self.task_uids)

    @property
    def n_jobs(self) -> int:
        return len(self.job_ids)


def _pack_bits(indices: Sequence[int], words: int) -> np.ndarray:
    out = np.zeros((words,), dtype=np.uint32)
    for i in indices:
        out[i // 32] |= np.uint32(1 << (i % 32))
    return out


def encode_cluster(
    cluster: ClusterInfo,
    pending_tasks: Sequence[TaskInfo],
    job_order: Sequence[str],
    slots: Optional[ResourceSlots] = None,
) -> Tuple[ClusterArrays, IndexMaps]:
    """Flatten a snapshot into ClusterArrays.

    ``pending_tasks`` must already be in processing order with each job's
    tasks contiguous; ``job_order`` lists job ids in that same order.
    """
    slots = slots or ResourceSlots.for_cluster(cluster)
    maps = IndexMaps(slots=slots)
    R = slots.width

    # ---------------------------------------------------------------- dicts
    # Label-pair dictionary: every (k, v) appearing in a node label or a task
    # selector; taint dictionary from node taints; port dictionary from all
    # used/requested host ports.
    for node in cluster.nodes.values():
        if node.node is not None:
            for kv in node.node.labels.items():
                maps.label_dict.setdefault(kv, len(maps.label_dict))
            for t in node.node.taints:
                key = (t.key, t.value, t.effect)
                maps.taint_dict.setdefault(key, len(maps.taint_dict))
        for ti in node.tasks.values():
            for port in ti.pod.host_ports:
                maps.port_dict.setdefault(port, len(maps.port_dict))
    for ti in pending_tasks:
        for kv in ti.pod.node_selector.items():
            maps.label_dict.setdefault(kv, len(maps.label_dict))
        for req in ti.pod.required_node_affinity:
            for kv in req.items():
                maps.label_dict.setdefault(kv, len(maps.label_dict))
        for sel, _w in ti.pod.preferred_node_affinity:
            for kv in sel.items():
                maps.label_dict.setdefault(kv, len(maps.label_dict))
        for port in ti.pod.host_ports:
            maps.port_dict.setdefault(port, len(maps.port_dict))

    LW = max(1, (len(maps.label_dict) + 31) // 32)
    TW = max(1, (len(maps.taint_dict) + 31) // 32)
    PW = max(1, (len(maps.port_dict) + 31) // 32)

    # ---------------------------------------------------------------- queues
    queue_names = sorted(cluster.queues.keys())
    maps.queue_names = queue_names
    maps.queue_index = {n: i for i, n in enumerate(queue_names)}
    Q = pad_dim(len(queue_names), 4)
    q_weight = np.zeros((Q,), F)
    q_cap = np.zeros((Q, R), F)
    q_hascap = np.zeros((Q,), bool)
    q_reclaim = np.zeros((Q,), bool)
    q_real = np.zeros((Q,), bool)
    for i, name in enumerate(queue_names):
        q = cluster.queues[name]
        q_weight[i] = q.weight
        q_real[i] = True
        q_reclaim[i] = q.reclaimable()
        if q.queue.capability:
            q_hascap[i] = True
            q_cap[i] = slots.vec(Resource.from_resource_list(q.queue.capability))

    # ---------------------------------------------------------------- nodes
    # Columnar CSR assembly; the scatter/pack loops run in numpy.
    node_names = sorted(cluster.nodes.keys())
    maps.node_names = node_names
    maps.node_index = {n: i for i, n in enumerate(node_names)}
    n_nodes = len(node_names)
    N = pad_dim(n_nodes)
    res_bufs = {k: ([], [], [0]) for k in
                ("alloc", "idle", "used", "rel", "pip")}
    lbl_idx: List[int] = []
    lbl_off = [0]
    tnt_idx: List[int] = []
    tnt_off = [0]
    prt_idx: List[int] = []
    prt_off = [0]
    n_ready = np.zeros((N,), bool)
    n_real = np.zeros((N,), bool)
    n_maxtasks = np.zeros((N,), I)
    n_numtasks = np.zeros((N,), I)
    n_fabric = np.full((N, len(FABRIC_LEVELS)), -1, I)
    fabric_codes: Dict[Tuple[int, str], int] = {}
    label_dict = maps.label_dict
    taint_dict = maps.taint_dict
    port_dict = maps.port_dict
    for i, name in enumerate(node_names):
        node = cluster.nodes[name]
        for key, res in (
            ("alloc", node.allocatable), ("idle", node.idle),
            ("used", node.used), ("rel", node.releasing),
            ("pip", node.pipelined),
        ):
            sb, vb, ob = res_bufs[key]
            slots.csr_append(res, sb, vb)
            ob.append(len(sb))
        n_ready[i] = node.ready()
        n_real[i] = True
        n_maxtasks[i] = node.allocatable.max_task_num
        n_numtasks[i] = len(node.tasks)
        if node.node is not None:
            lbl_idx.extend(
                label_dict[kv] for kv in node.node.labels.items()
                if kv in label_dict
            )
            # Only NoSchedule/NoExecute taints gate placement
            # (PreferNoSchedule is a soft preference).
            tnt_idx.extend(
                taint_dict[(t.key, t.value, t.effect)]
                for t in node.node.taints
                if t.effect in ("NoSchedule", "NoExecute")
            )
            if node.node.unschedulable:
                n_ready[i] = False
            for li, lkey in enumerate(FABRIC_LEVELS):
                v = node.node.labels.get(lkey)
                if v is None:
                    continue
                code = fabric_codes.get((li, v))
                if code is None:
                    code = fabric_codes[(li, v)] = len(fabric_codes)
                n_fabric[i, li] = code
        lbl_off.append(len(lbl_idx))
        tnt_off.append(len(tnt_idx))
        prt_idx.extend(
            port_dict[p]
            for ti in node.tasks.values()
            for p in ti.pod.host_ports
            if p in port_dict
        )
        prt_off.append(len(prt_idx))

    def _res_rows(key: str, rows: int) -> np.ndarray:
        sb, vb, ob = res_bufs[key]
        ob = ob + [ob[-1]] * (rows - (len(ob) - 1))
        return _scatter_rows_f32(sb, vb, ob, rows, R)

    def _bit_rows(idx: List[int], off: List[int], rows: int,
                  words: int) -> np.ndarray:
        off = off + [off[-1]] * (rows - (len(off) - 1))
        return _pack_bits_rows(idx, off, rows, words)

    n_alloc = _res_rows("alloc", N)
    n_idle = _res_rows("idle", N)
    n_used = _res_rows("used", N)
    n_rel = _res_rows("rel", N)
    n_pip = _res_rows("pip", N)
    n_labels = _bit_rows(lbl_idx, lbl_off, N, LW)
    n_taints = _bit_rows(tnt_idx, tnt_off, N, TW)
    n_ports = _bit_rows(prt_idx, prt_off, N, PW)

    # ----------------------------------------------------------------- jobs
    maps.job_ids = list(job_order)
    maps.job_index = {j: i for i, j in enumerate(maps.job_ids)}
    J = pad_dim(max(1, len(maps.job_ids)), 4)
    j_min = np.zeros((J,), I)
    j_queue = np.zeros((J,), I)
    j_pri = np.zeros((J,), I)
    j_ready = np.zeros((J,), I)
    j_real = np.zeros((J,), bool)
    for i, jid in enumerate(maps.job_ids):
        job = cluster.jobs[jid]
        j_min[i] = job.min_available
        if job.queue not in maps.queue_index:
            # Jobs with unknown queues must be filtered by the caller
            # (allocate.go:67-71 skips them); never misattribute to row 0.
            raise ValueError(
                f"job {jid} references unknown queue {job.queue!r}; "
                "filter such jobs before encoding"
            )
        j_queue[i] = maps.queue_index[job.queue]
        j_pri[i] = job.priority
        j_ready[i] = job.ready_task_num()
        j_real[i] = True

    # ----------------------------------------------------------------- tasks
    maps.task_uids = [t.uid for t in pending_tasks]
    maps.task_infos = list(pending_tasks)
    P = pad_dim(max(1, len(pending_tasks)), 8)
    t_job = np.zeros((P,), I)
    t_pri = np.zeros((P,), I)
    t_real = np.zeros((P,), bool)
    A = max(1, max((len(t.pod.required_node_affinity) for t in pending_tasks),
                   default=1))
    AP = max(1, max((len(t.pod.preferred_node_affinity)
                     for t in pending_tasks), default=1))
    t_aff = np.zeros((P, A, LW), np.uint32)
    t_affn = np.zeros((P,), I)
    t_pref = np.zeros((P, AP, LW), np.uint32)
    t_prefw = np.zeros((P, AP), F)
    t_hassel = np.zeros((P,), bool)
    req_sb: List[int] = []
    req_vb: List[float] = []
    req_ob = [0]
    init_sb: List[int] = []
    init_vb: List[float] = []
    init_ob = [0]
    sel_idx: List[int] = []
    sel_off = [0]
    tol_idxs: List[int] = []
    tol_off = [0]
    tprt_idx: List[int] = []
    tprt_off = [0]
    # Distinct toleration lists are few; memoize their taint-bit matches.
    tol_cache: Dict[tuple, List[int]] = {}
    taint_items = list(maps.taint_dict.items())
    job_index = maps.job_index
    for i, ti in enumerate(pending_tasks):
        slots.csr_append(ti.resreq, req_sb, req_vb)
        req_ob.append(len(req_sb))
        slots.csr_append(ti.init_resreq, init_sb, init_vb)
        init_ob.append(len(init_sb))
        t_job[i] = job_index[ti.job]
        t_pri[i] = ti.priority
        t_real[i] = True
        sel_pairs = ti.pod.node_selector
        if sel_pairs:
            t_hassel[i] = True
            sel_idx.extend(
                label_dict[kv] for kv in sel_pairs.items()
                if kv in label_dict
            )
        sel_off.append(len(sel_idx))
        # Node-affinity terms are OR-alternatives: one bitset per term.
        t_affn[i] = len(ti.pod.required_node_affinity)
        for a, req_term in enumerate(ti.pod.required_node_affinity[:A]):
            t_aff[i, a] = _pack_bits(
                [maps.label_dict[kv] for kv in req_term.items()
                 if kv in maps.label_dict],
                LW,
            )
        # Preferred node affinity: normalize term weights to sum 10
        # (got/total * MaxPriority in the upstream priority).
        prefs = ti.pod.preferred_node_affinity
        if prefs:
            total_w = float(sum(w for _, w in prefs))
            if total_w > 0:
                for a, (sel, w) in enumerate(prefs[:AP]):
                    t_pref[i, a] = _pack_bits(
                        [maps.label_dict[kv] for kv in sel.items()
                         if kv in maps.label_dict],
                        LW,
                    )
                    t_prefw[i, a] = w / total_w * 10.0
        # Tolerations: a task tolerates a taint bit when any toleration
        # matches key(/value)(/effect) (predicates.go taint check).
        if ti.pod.tolerations:
            ckey = tuple(
                (t.key, t.operator, t.value, t.effect)
                for t in ti.pod.tolerations
            )
            hit = tol_cache.get(ckey)
            if hit is None:
                hit = []
                for key, idx in taint_items:
                    tkey, tval, teff = key
                    for tol in ti.pod.tolerations:
                        key_ok = tol.operator == "Exists" and (
                            tol.key == "" or tol.key == tkey
                        )
                        if tol.operator == "Equal":
                            key_ok = tol.key == tkey and tol.value == tval
                        eff_ok = tol.effect == "" or tol.effect == teff
                        if key_ok and eff_ok:
                            hit.append(idx)
                            break
                tol_cache[ckey] = hit
            tol_idxs.extend(hit)
        tol_off.append(len(tol_idxs))
        if ti.pod.host_ports:
            tprt_idx.extend(
                port_dict[p] for p in ti.pod.host_ports if p in port_dict
            )
        tprt_off.append(len(tprt_idx))

    req_ob += [req_ob[-1]] * (P - (len(req_ob) - 1))
    init_ob += [init_ob[-1]] * (P - (len(init_ob) - 1))
    t_req = _scatter_rows_f32(req_sb, req_vb, req_ob, P, R)
    t_init = _scatter_rows_f32(init_sb, init_vb, init_ob, P, R)
    t_sel = _bit_rows(sel_idx, sel_off, P, LW)
    t_tol = _bit_rows(tol_idxs, tol_off, P, TW)
    t_ports = _bit_rows(tprt_idx, tprt_off, P, PW)

    arrays = ClusterArrays(
        nodes=NodeArrays(
            allocatable=n_alloc,
            idle=n_idle,
            used=n_used,
            releasing=n_rel,
            pipelined=n_pip,
            ready=n_ready,
            real=n_real,
            max_tasks=n_maxtasks,
            num_tasks=n_numtasks,
            label_bits=n_labels,
            taint_bits=n_taints,
            port_bits=n_ports,
            fabric=n_fabric,
        ),
        tasks=TaskArrays(
            req=t_req,
            init_req=t_init,
            job=t_job,
            priority=t_pri,
            real=t_real,
            sel_bits=t_sel,
            has_selector=t_hassel,
            aff_bits=t_aff,
            aff_terms=t_affn,
            tol_bits=t_tol,
            port_bits=t_ports,
            pref_bits=t_pref,
            pref_w=t_prefw,
        ),
        jobs=JobArrays(
            min_available=j_min,
            queue=j_queue,
            priority=j_pri,
            ready_base=j_ready,
            real=j_real,
        ),
        queues=QueueArrays(
            weight=q_weight,
            capability=q_cap,
            has_capability=q_hascap,
            reclaimable=q_reclaim,
            deserved=np.zeros((Q, R), F),
            allocated=np.zeros((Q, R), F),
            real=q_real,
        ),
        eps=slots.eps(),
        scalar_slot=slots.is_scalar_slot(),
    )
    return arrays, maps
