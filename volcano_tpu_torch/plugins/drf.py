"""Dominant Resource Fairness plugin (pkg/scheduler/plugins/drf/drf.go).

Per-job share = max over resources of allocated/total (drf.go:317-329); job
order by share; optional weighted namespace DRF (namespace weight from the
quota annotation); preemptable when the preemptor's share stays below the
victim's post-eviction share (drf.go:121-200); event handlers keep shares
incremental during the cycle (drf.go:261-300).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List

from ..api import JobInfo, Resource, TaskInfo, allocated_status, share
from ..metrics import metrics

PLUGIN_NAME = "drf"
SHARE_DELTA = 0.000001


@dataclass
class _Attr:
    share: float = 0.0
    dominant_resource: str = ""
    allocated: Resource = field(default_factory=Resource.empty)


class DrfPlugin:
    def __init__(self, arguments):
        self.arguments = arguments
        self.total_resource = Resource.empty()
        self.job_attrs: Dict[str, _Attr] = {}
        self.namespace_opts: Dict[str, _Attr] = {}

    @property
    def name(self) -> str:
        return PLUGIN_NAME

    # ------------------------------------------------------------- helpers

    def _calculate_share(self, allocated: Resource, total: Resource):
        res = 0.0
        dominant = ""
        for rn in total.resource_names():
            s = share(allocated.get(rn), total.get(rn))
            if s > res:
                res = s
                dominant = rn
        return dominant, res

    def _update_share(self, attr: _Attr):
        attr.dominant_resource, attr.share = self._calculate_share(
            attr.allocated, self.total_resource
        )

    def _namespace_order_enabled(self, ssn) -> bool:
        for tier in ssn.tiers:
            for opt in tier.plugins:
                if opt.name == PLUGIN_NAME:
                    return bool(opt.enabled_namespace_order)
        return False

    # -------------------------------------------------------------- session

    def on_session_open(self, ssn) -> None:
        for node in ssn.nodes.values():
            self.total_resource.add(node.allocatable)

        ns_enabled = self._namespace_order_enabled(ssn)

        for job in ssn.jobs.values():
            attr = _Attr()
            for status, tasks in job.task_status_index.items():
                if allocated_status(status):
                    for t in tasks.values():
                        attr.allocated.add(t.resreq)
            self._update_share(attr)
            metrics.job_share.set(
                attr.share, job_ns=job.namespace, job_id=job.name
            )
            self.job_attrs[job.uid] = attr

            if ns_enabled:
                ns_opt = self.namespace_opts.setdefault(job.namespace, _Attr())
                ns_opt.allocated.add(attr.allocated)
                self._update_share(ns_opt)

        def preemptable_fn(preemptor: TaskInfo,
                           preemptees: List[TaskInfo]) -> List[TaskInfo]:
            victims: List[TaskInfo] = []

            if ns_enabled:
                l_weight = ssn.namespace_info.get(
                    preemptor.namespace
                ).get_weight() if preemptor.namespace in ssn.namespace_info else 1
                l_ns_att = self.namespace_opts.get(preemptor.namespace, _Attr())
                l_ns_alloc = l_ns_att.allocated.clone().add(preemptor.resreq)
                _, l_ns_share = self._calculate_share(
                    l_ns_alloc, self.total_resource
                )
                l_weighted = l_ns_share / float(l_weight)

                ns_allocations: Dict[str, Resource] = {}
                undecided: List[TaskInfo] = []
                for preemptee in preemptees:
                    if preemptor.namespace == preemptee.namespace:
                        undecided.append(preemptee)
                        continue
                    if preemptee.namespace not in ns_allocations:
                        r_att = self.namespace_opts.get(
                            preemptee.namespace, _Attr()
                        )
                        ns_allocations[preemptee.namespace] = (
                            r_att.allocated.clone()
                        )
                    r_weight = ssn.namespace_info.get(
                        preemptee.namespace
                    ).get_weight() if preemptee.namespace in ssn.namespace_info else 1
                    r_ns_alloc = ns_allocations[preemptee.namespace].sub(
                        preemptee.resreq
                    )
                    _, r_ns_share = self._calculate_share(
                        r_ns_alloc, self.total_resource
                    )
                    r_weighted = r_ns_share / float(r_weight)
                    # Avoid ping-pong: victim namespace must keep the higher
                    # weighted share after preemption (drf.go:162-173).
                    if l_weighted < r_weighted:
                        victims.append(preemptee)
                    if l_weighted - r_weighted > SHARE_DELTA:
                        continue
                    undecided.append(preemptee)
                preemptees = undecided

            l_att = self.job_attrs.get(preemptor.job, _Attr())
            l_alloc = l_att.allocated.clone().add(preemptor.resreq)
            _, ls = self._calculate_share(l_alloc, self.total_resource)

            allocations: Dict[str, Resource] = {}
            for preemptee in preemptees:
                if preemptee.job not in allocations:
                    r_att = self.job_attrs.get(preemptee.job, _Attr())
                    allocations[preemptee.job] = r_att.allocated.clone()
                r_alloc = allocations[preemptee.job].sub(preemptee.resreq)
                _, rs = self._calculate_share(r_alloc, self.total_resource)
                if ls < rs or abs(ls - rs) <= SHARE_DELTA:
                    victims.append(preemptee)
            return victims

        ssn.add_preemptable_fn(self.name, preemptable_fn)

        def job_order_fn(l: JobInfo, r: JobInfo) -> int:
            ls = self.job_attrs[l.uid].share
            rs = self.job_attrs[r.uid].share
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        ssn.add_job_order_fn(self.name, job_order_fn)

        def namespace_order_fn(l: str, r: str) -> int:
            l_opt = self.namespace_opts.get(l, _Attr())
            r_opt = self.namespace_opts.get(r, _Attr())
            l_weight = (
                ssn.namespace_info[l].get_weight()
                if l in ssn.namespace_info else 1
            )
            r_weight = (
                ssn.namespace_info[r].get_weight()
                if r in ssn.namespace_info else 1
            )
            lw = l_opt.share / float(l_weight)
            rw = r_opt.share / float(r_weight)
            metrics.namespace_weight.set(l_weight, namespace=l)
            metrics.namespace_weight.set(r_weight, namespace=r)
            metrics.namespace_weighted_share.set(lw, namespace=l)
            metrics.namespace_weighted_share.set(rw, namespace=r)
            if lw == rw:
                return 0
            return -1 if lw < rw else 1

        if ns_enabled:
            ssn.add_namespace_order_fn(self.name, namespace_order_fn)

        from ..framework.session import EventHandler

        def on_allocate(event):
            attr = self.job_attrs.get(event.task.job)
            if attr is None:
                return
            attr.allocated.add(event.task.resreq)
            self._update_share(attr)
            if ns_enabled:
                ns_opt = self.namespace_opts.setdefault(
                    event.task.namespace, _Attr()
                )
                ns_opt.allocated.add(event.task.resreq)
                self._update_share(ns_opt)

        def on_deallocate(event):
            attr = self.job_attrs.get(event.task.job)
            if attr is None:
                return
            attr.allocated.sub(event.task.resreq)
            self._update_share(attr)
            if ns_enabled:
                ns_opt = self.namespace_opts.setdefault(
                    event.task.namespace, _Attr()
                )
                ns_opt.allocated.sub(event.task.resreq)
                self._update_share(ns_opt)

        ssn.add_event_handler(
            EventHandler(allocate_func=on_allocate,
                         deallocate_func=on_deallocate)
        )

    def on_session_close(self, ssn) -> None:
        self.total_resource = Resource.empty()
        self.job_attrs = {}
