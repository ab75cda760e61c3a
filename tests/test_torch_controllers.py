"""The port's control plane against the JAX package's.

Twins of ``tests/test_controllers.py``, ``test_job_controller_actions.py``,
``test_job_controller_handlers.py``, ``test_state_table.py``,
``test_gc_ttl.py`` and ``test_controller_cache.py``: every test function,
method and parametrized case of those modules runs twice -- once as
written against the JAX package, once with its imports pointing at
``volcano_tpu_torch`` and its ``Scheduler`` on the CPU
(``test_torch_fixtures.twin_module``) -- so each of its own assertions
holds on the port, and the store's control digest (job phases, retry
counts and versions, the pods' names, env, annotations and affinity,
PodGroups and their phases, queue states, binds, events, claims and the
plugins' objects; ``test_torch_fixtures.control_digest``) is recorded after
every controller pump, scheduler cycle and simulator tick of both runs:
the two sequences must be equal.  The uid and timestamp counters of both
packages restart before each run; the TTL cases inject their own clocks.

Also here: the lockstep script (``test_torch_fixtures.control_run``: both
example job files, a 4-queue mix, a ``tpuslice`` job, a failed pod and a
failed node, AbortJob / ResumeJob, a queue closed and opened, a job
collected by the TTL GC under one patched clock and a job deleted), equal
step by step, and ``ClusterSimulator.fail_pod`` / ``fail_node``.
"""

from pathlib import Path

import pytest

import volcano_tpu
import volcano_tpu_torch
from test_torch_fixtures import control_run, run_twin_case, twin_cases

ROOT = Path(__file__).resolve().parent

MODULES = ("test_controllers.py", "test_job_controller_actions.py",
           "test_job_controller_handlers.py", "test_state_table.py",
           "test_gc_ttl.py", "test_controller_cache.py")

CASES = [(m, c) for m in MODULES for c in twin_cases(ROOT / m)]


def assert_same_trace(want, got):
    """Equal (call, digest) sequences, the first difference named."""
    assert [w[0] for w in want] == [g[0] for g in got]
    for i, ((call, w), (_, g)) in enumerate(zip(want, got)):
        if w != g:
            keys = [k for k in w if w[k] != g.get(k)]
            raise AssertionError(f"step {i} ({call}): {keys} differ")


@pytest.mark.parametrize("module,case", CASES,
                         ids=[f"{m[5:-3]}::{c}" for m, c in CASES])
def test_jax_controller_case_twin(module, case, tmp_path_factory):
    tmp = lambda: tmp_path_factory.mktemp("twin")  # noqa: E731
    want = run_twin_case(ROOT / module, case, volcano_tpu, tmp)
    got = run_twin_case(ROOT / module, case, volcano_tpu_torch, tmp)
    assert_same_trace(want, got)


def test_twin_cases_cover_every_jax_test():
    """Every test of the six modules is twinned: the counts of their
    functions, methods and parametrized cases, read by pytest's own
    collection, equal the twin's."""
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", *[str(ROOT / m) for m in MODULES]],
        capture_output=True, text=True, cwd=ROOT.parent, timeout=300)
    collected = [ln for ln in out.stdout.splitlines() if "::" in ln]
    assert len(collected) == len(CASES), out.stdout[-2000:]


def test_lockstep_script_equals_jax():
    want = control_run(volcano_tpu, n_nodes=64)
    got = control_run(volcano_tpu_torch, n_nodes=64)
    assert_same_trace(want, got)
    final = got[-1][1]
    phases = {k: j["status"]["state"]["phase"]
              for k, j in final["jobs"].items()}
    # The script reached what it drives at: restarts counted, the TTL
    # job collected, the deleted job gone, everything else Running.
    assert "default/short" not in phases and "default/q8-j2" not in phases
    assert set(phases.values()) == {"Running"}
    retries = {k: j["status"]["retry_count"]
               for k, j in final["jobs"].items()}
    assert retries["default/dist-mnist"] == 1
    assert retries["default/q1-j0"] == 1
    assert retries["default/q2-j1"] == 1
    labels = [lbl for lbl, _ in got]
    abort = got[labels.index("abort") + 1][1]
    assert abort["jobs"]["default/q2-j1"]["status"]["state"]["phase"] \
        == "Aborted"
    close = got[labels.index("close-queue")][1]
    assert close["queues"]["q4"]["state"] in ("Closing", "Closed")
    assert got[labels.index("open-queue")][1]["queues"]["q4"]["state"] \
        == "Open"
    # The tpuslice job's pods carry the soft slice term; the svc plugin's
    # rendezvous env is on every pod of a job that names it.
    slice_pods = [p for p in final["pods"]
                  if p["owner_job"] == "default/slice-job"]
    assert len(slice_pods) == 8
    assert all(p["preferred_affinity"][0][0]["topology_key"]
               == "volcano-tpu/slice" for p in slice_pods)
    assert all(p["env"]["VC_PROCESS_COUNT"] == "8" for p in slice_pods)


@pytest.mark.parametrize("pkg", [volcano_tpu, volcano_tpu_torch],
                         ids=["jax", "port"])
def test_fail_pod_and_fail_node_inject(pkg):
    """``fail_pod`` fails one pod with its exit code; ``fail_node`` marks
    the node NotReady and fails every pod running on it with 255."""
    import importlib

    api = pkg.api
    sim_mod = importlib.import_module(f"{pkg.__name__}.sim")
    store = pkg.cache.ClusterStore()
    for i in range(2):
        store.add_node(api.Node(name=f"n{i}",
                                allocatable={"cpu": "4", "memory": "8Gi"}))
    for k, node in enumerate(("n0", "n0", "n1")):
        store.add_pod(api.Pod(name=f"p{k}", node_name=node,
                              phase=api.PodPhase.Running,
                              containers=[{"cpu": "1", "memory": "1Gi"}]))
    sim = sim_mod.ClusterSimulator(store)
    uid = next(p.uid for p in store.pods.values() if p.name == "p2")
    sim.fail_pod(uid, exit_code=137)
    sim.fail_node("n0")
    sim.fail_node("absent")  # no such node: nothing happens
    got = {p.name: (p.phase, p.exit_code) for p in store.pods.values()}
    assert got == {"p0": ("Failed", 255), "p1": ("Failed", 255),
                   "p2": ("Failed", 137)}
    assert store.nodes["n0"].node.ready is False
    assert store.nodes["n1"].node.ready is not False
    store.close()
