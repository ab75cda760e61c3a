"""Metrics registry (pkg/scheduler/metrics).

Same metric names as the reference so dashboards carry over
(metrics.go:38-110, queue.go, job.go, namespace.go), implemented as an
in-process registry with a Prometheus text-format exposition instead of
the Go prometheus client.  Device-native additions: device solve time
and host<->device transfer bytes.
"""

from .metrics import Metrics, metrics

__all__ = ["Metrics", "metrics"]
