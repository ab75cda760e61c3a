"""Job plugins: distributed-workload rendezvous injection.

The reference's entire "distributed training support" is pod discovery
wiring: the **svc** plugin publishes a headless
service + per-task hosts ConfigMap mounted at /etc/volcano and
``<TASK>_HOSTS``/``<TASK>_NUM`` env (svc/svc.go:306-340), **ssh** generates a
per-job RSA keypair secret for passwordless MPI (ssh/ssh.go:76-199), and
**env** injects the task index (env/env.go:45).

The accelerator-native analog adds distributed bootstrap info: every pod
gets ``VC_COORDINATOR_ADDRESS`` (task-0's stable DNS name),
``VC_PROCESS_COUNT`` and ``VC_PROCESS_ID`` -- the master address, world size
and rank that ``torch.distributed.init_process_group`` needs (as
``tcp://<VC_COORDINATOR_ADDRESS>``) -- so a multi-host training job
scheduled by this framework can rendezvous the way MPI jobs rendezvous via
the reference's hostfiles.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List

from ..api import Pod

log = logging.getLogger(__name__)

CONFIG_MAP_MOUNT = "/etc/volcano"  # svc/const.go:28
TASK_INDEX_ENV = "VK_TASK_INDEX"  # env/env.go
SSH_SECRET_SUFFIX = "-ssh"


def _host_name(job, task_name: str, index: int) -> str:
    # Stable per-pod DNS-style name under the job's headless service.
    return f"{job.name}-{task_name}-{index}.{job.name}"


class EnvPlugin:
    """Task index env injection (plugins/env)."""

    name = "env"

    def __init__(self, arguments: List[str]):
        self.arguments = arguments

    def on_pod_create(self, pod: Pod, job) -> None:
        idx = pod.annotations.get("volcano-tpu/task-index", "0")
        pod.env[TASK_INDEX_ENV] = idx

    def on_job_add(self, job, store) -> None:
        pass

    def on_job_delete(self, job, store) -> None:
        pass


class SvcPlugin:
    """Headless service + hosts ConfigMap + rendezvous env (plugins/svc)."""

    name = "svc"

    def __init__(self, arguments: List[str]):
        self.arguments = arguments
        # Reference flag parity (svc.go:63-73): the plugin accepts
        # "--disable-network-policy" in its argument list.
        self.disable_network_policy = (
            "--disable-network-policy" in arguments
            or "--disable-network-policy=true" in arguments
        )

    def _hosts(self, job) -> Dict[str, str]:
        data = {}
        for task in job.tasks:
            hosts = [
                _host_name(job, task.name, i) for i in range(task.replicas)
            ]
            data[f"{task.name}.host"] = "\n".join(hosts)
        return data

    def on_job_add(self, job, store) -> None:
        store.put_config_map(job.namespace, f"{job.name}-svc", self._hosts(job))
        store.put_service(
            job.namespace,
            job.name,
            {"headless": True, "selector": {"volcano-tpu/job-name": job.name}},
        )
        if not self.disable_network_policy:
            # Pods of the job accept ingress only from pods of the same
            # job (svc.go:252-299: PodSelector = job labels, one Ingress
            # rule from the same selector, PolicyTypes=[Ingress]).
            selector = {"volcano-tpu/job-name": job.name,
                        "volcano-tpu/job-namespace": job.namespace}
            store.put_network_policy(
                job.namespace,
                job.name,
                {"pod_selector": selector,
                 "ingress_from": [selector],
                 "policy_types": ["Ingress"]},
            )
        job.status.controlled_resources["plugin-svc"] = "svc"

    def on_job_delete(self, job, store) -> None:
        store.delete_config_map(job.namespace, f"{job.name}-svc")
        store.delete_service(job.namespace, job.name)
        store.delete_network_policy(job.namespace, job.name)

    def on_pod_create(self, pod: Pod, job) -> None:
        total = job.total_tasks()
        # <TASK>_HOSTS / <TASK>_NUM for every task group (svc.go:306-340).
        for task in job.tasks:
            env_name = task.name.upper().replace("-", "_")
            pod.env[f"{env_name}_HOSTS"] = ",".join(
                _host_name(job, task.name, i) for i in range(task.replicas)
            )
            pod.env[f"{env_name}_NUM"] = str(task.replicas)
        # Rendezvous: torch.distributed.init_process_group inputs.
        if job.tasks:
            first = job.tasks[0]
            pod.env["VC_COORDINATOR_ADDRESS"] = (
                _host_name(job, first.name, 0) + ":8476"
            )
        pod.env["VC_PROCESS_COUNT"] = str(total)
        # Process id = global index across task groups in spec order.
        idx = int(pod.annotations.get("volcano-tpu/global-index", "0"))
        pod.env["VC_PROCESS_ID"] = str(idx)


class SshPlugin:
    """Per-job SSH keypair secret for passwordless MPI (plugins/ssh)."""

    name = "ssh"

    def __init__(self, arguments: List[str]):
        self.arguments = arguments

    def on_job_add(self, job, store) -> None:
        try:
            from cryptography.hazmat.primitives import serialization
            from cryptography.hazmat.primitives.asymmetric import rsa

            key = rsa.generate_private_key(
                public_exponent=65537, key_size=2048
            )
            private = key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.TraditionalOpenSSL,
                serialization.NoEncryption(),
            )
            public = key.public_key().public_bytes(
                serialization.Encoding.OpenSSH,
                serialization.PublicFormat.OpenSSH,
            )
        except Exception:  # pragma: no cover - crypto unavailable
            import secrets as pysecrets

            private = pysecrets.token_bytes(32)
            public = pysecrets.token_bytes(32)
        store.put_secret(
            job.namespace,
            job.name + SSH_SECRET_SUFFIX,
            {
                "id_rsa": private,
                "id_rsa.pub": public,
                "authorized_keys": public,
            },
        )
        job.status.controlled_resources["plugin-ssh"] = "ssh"

    def on_job_delete(self, job, store) -> None:
        store.delete_secret(job.namespace, job.name + SSH_SECRET_SUFFIX)

    def on_pod_create(self, pod: Pod, job) -> None:
        # Mount marker: the runtime mounts the secret at ~/.ssh.
        pod.annotations["volcano-tpu/ssh-secret"] = job.name + SSH_SECRET_SUFFIX


TPU_SLICE_KEY = "volcano-tpu/slice"


class TpuSlicePlugin:
    """Accelerator-native job plugin: pack a job's tasks onto nodes of the
    same slice (one fabric domain, ``volcano-tpu/slice``) so the gang's
    collectives ride the fast interconnect instead of the data-centre
    network.

    Nodes advertise slice membership via ``Node.topology["volcano-tpu/
    slice"]`` (topology coordinates fold into node labels); every pod of
    the job gets a soft self-affinity term over that key, so the wave
    solver's (term, domain) count tensors pull siblings toward the slice
    an earlier sibling picked -- the analog of the reference's wiring
    of workload placement hints through pod templates.

    Argument: ``--weight=<int>`` (default 10, the score weight of the
    injected term)."""

    name = "tpuslice"

    def __init__(self, arguments: List[str]):
        self.weight = 10
        for arg in arguments:
            if arg.startswith("--weight="):
                try:
                    self.weight = max(int(arg.split("=", 1)[1]), 1)
                except ValueError:
                    pass

    def on_job_add(self, job, store) -> None:
        pass

    def on_job_delete(self, job, store) -> None:
        pass

    def on_pod_create(self, pod: Pod, job) -> None:
        from ..api.spec import AffinityTerm

        pod.preferred_affinity.append((
            AffinityTerm(
                match_labels={"volcano-tpu/job-name": job.name},
                topology_key=TPU_SLICE_KEY,
            ),
            self.weight,
        ))


PLUGIN_BUILDERS: Dict[str, Callable] = {
    "env": EnvPlugin,
    "svc": SvcPlugin,
    "ssh": SshPlugin,
    "tpuslice": TpuSlicePlugin,
}


def get_job_plugin(name: str, arguments: List[str]):
    builder = PLUGIN_BUILDERS.get(name)
    if builder is None:
        log.warning("Unknown job plugin %s", name)
        return None
    return builder(arguments)
