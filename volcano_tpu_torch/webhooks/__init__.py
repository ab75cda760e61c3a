"""Admission validation/mutation (pkg/webhooks).

With no kube-apiserver, the reference's webhook services become request
validators at the framework's submission API: ``AdmittedStore`` wraps a
ClusterStore and applies /jobs/validate, /jobs/mutate, /queues/validate and
/pods rules before letting mutations through.
"""

from .admission import (
    AdmissionError,
    AdmittedStore,
    mutate_job,
    validate_job_create,
    validate_job_update,
    validate_pod_create,
    validate_queue,
    validate_queue_delete,
)

__all__ = [
    "AdmissionError",
    "AdmittedStore",
    "mutate_job",
    "validate_job_create",
    "validate_job_update",
    "validate_pod_create",
    "validate_queue",
    "validate_queue_delete",
]
