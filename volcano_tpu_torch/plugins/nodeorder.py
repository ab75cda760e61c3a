"""Node-order plugin (pkg/scheduler/plugins/nodeorder/nodeorder.go).

Wraps the classic priorities — LeastRequested, BalancedResourceAllocation,
NodeAffinity (preferred terms), MostRequested — with the 5 weight knobs
(nodeorder.go:95-124; defaults least=1, most=0, nodeaffinity=1,
podaffinity=1, balanced=1).  Registers host NodeOrderFn for the preempt path
and contributes the additive device ScoreWeights the allocate kernel uses.
"""

from __future__ import annotations

from ..api import NodeInfo, TaskInfo
from ..ops.scoring import MAX_PRIORITY

PLUGIN_NAME = "nodeorder"

NODE_AFFINITY_WEIGHT = "nodeaffinity.weight"
POD_AFFINITY_WEIGHT = "podaffinity.weight"
LEAST_REQUESTED_WEIGHT = "leastrequested.weight"
BALANCED_RESOURCE_WEIGHT = "balancedresource.weight"
MOST_REQUESTED_WEIGHT = "mostrequested.weight"


class NodeOrderPlugin:
    def __init__(self, arguments):
        self.arguments = arguments
        self.least_req = arguments.get_int(LEAST_REQUESTED_WEIGHT, 1)
        self.most_req = arguments.get_int(MOST_REQUESTED_WEIGHT, 0)
        self.node_affinity = arguments.get_int(NODE_AFFINITY_WEIGHT, 1)
        self.pod_affinity = arguments.get_int(POD_AFFINITY_WEIGHT, 1)
        self.balanced = arguments.get_int(BALANCED_RESOURCE_WEIGHT, 1)

    @property
    def name(self) -> str:
        return PLUGIN_NAME

    def on_session_open(self, ssn) -> None:
        def node_order_fn(task: TaskInfo, node: NodeInfo) -> float:
            score = 0.0
            cap_cpu = node.allocatable.milli_cpu
            cap_mem = node.allocatable.memory
            req_cpu = node.used.milli_cpu + task.resreq.milli_cpu
            req_mem = node.used.memory + task.resreq.memory
            # LeastRequested: (cap - req) * 10 / cap averaged over cpu+mem.
            if self.least_req:
                per = []
                for req, cap in ((req_cpu, cap_cpu), (req_mem, cap_mem)):
                    per.append(
                        max(cap - req, 0.0) * MAX_PRIORITY / cap if cap > 0 else 0.0
                    )
                score += (sum(per) / 2.0) * self.least_req
            # MostRequested.
            if self.most_req:
                per = []
                for req, cap in ((req_cpu, cap_cpu), (req_mem, cap_mem)):
                    per.append(
                        req * MAX_PRIORITY / cap if cap > 0 and req <= cap else 0.0
                    )
                score += (sum(per) / 2.0) * self.most_req
            # BalancedResourceAllocation.
            if self.balanced:
                cf = req_cpu / cap_cpu if cap_cpu > 0 else 1.0
                mf = req_mem / cap_mem if cap_mem > 0 else 1.0
                if cf > 1.0 or mf > 1.0:
                    bal = 0.0
                else:
                    bal = (1.0 - abs(cf - mf)) * MAX_PRIORITY
                score += bal * self.balanced
            # Preferred node affinity (CalculateNodeAffinityPriorityMap):
            # sum of weights of matching preferred terms, normalized later
            # by the reduce step in upstream; here scaled to [0,10] by the
            # task's total preference weight.
            if self.node_affinity and task.pod.preferred_node_affinity:
                total = sum(w for _, w in task.pod.preferred_node_affinity)
                got = 0
                labels = node.node.labels if node.node else {}
                for sel, w in task.pod.preferred_node_affinity:
                    if all(labels.get(k) == v for k, v in sel.items()):
                        got += w
                if total > 0:
                    score += (got / total) * MAX_PRIORITY * self.node_affinity
            return score

        ssn.add_node_order_fn(self.name, node_order_fn)

        # Device score weights for the allocate kernel.
        ssn.add_score_weight_fn(
            self.name,
            lambda: {
                "least_req_weight": float(self.least_req),
                "most_req_weight": float(self.most_req),
                "balanced_weight": float(self.balanced),
                "node_affinity_weight": float(self.node_affinity),
            },
        )

    def on_session_close(self, ssn) -> None:
        pass
