"""The solver replica pool (``volcano_tpu_torch/solver_pool.py``): the seven
contracts of ``tests/test_solver_pool.py`` on the port.

A pool of two child processes (with ``jax`` and ``volcano_tpu``
unimportable) binds what the port's local cycle binds; a pool of one is
bind, mirror, frame-kind and wire-byte equal to a single client; a
straggling primary is hedged and the hedge's reply commits, with the same
binds as an unhedged run; killing the primary costs one cycle's
lost-reply re-place and no pod; the what-if solve of preempt offloads to
an idle non-primary replica; without offload capacity the what-if lane
stays off; ``VOLCANO_TPU_SOLVER_POOL`` builds the pool or a plain client.

The hedge is ordered by an event, not by sleeps: the straggling child's
``solve_delay_fn`` holds its reply until the pool has resolved the hedged
fetch, so the hedge's reply is first by construction.
"""

import random
import threading

import pytest

import volcano_tpu_torch.api
import volcano_tpu_torch.synth
from volcano_tpu_torch.api import TaskStatus
from volcano_tpu_torch.scheduler import Scheduler
from volcano_tpu_torch.solver_pool import SolverPool, make_solver_client
from volcano_tpu_torch.solver_service import RemoteSolver, SolverServer

from test_torch_fixtures import churn as _churn
from test_torch_fixtures import mirror_state as _mirror_state
from test_torch_fixtures import repend_feed as _partial_feed
from test_torch_remote_solver import (TIMEOUT, local_run, reset_uids,
                                      spawn_child, stop_child)

ST_BOUND = int(TaskStatus.Bound)


@pytest.fixture()
def servers():
    """Two in-process port children on the CPU (each connection gets its
    own thread, mirror and devincr context, as a separate process would)."""
    out = []
    for _ in range(2):
        s = SolverServer(port=0, device="cpu")
        threading.Thread(target=s.serve_forever, daemon=True).start()
        out.append(s)
    yield out
    for s in out:
        try:
            s.shutdown()
        except OSError:
            pass


def _pool_loop(pool, *, cycles=8, seed=13, churn=True, n_nodes=24,
               n_pods=72):
    """The pipelined remote loop of ``test_torch_remote_solver`` on a
    pool: per-cycle mirror states and the final binds."""
    reset_uids()
    store = volcano_tpu_torch.synth.synthetic_cluster(
        n_nodes=n_nodes, n_pods=n_pods, gang_size=4, seed=seed)
    store.pipeline = True
    store.remote_solver = pool
    store.cycle_feed = _partial_feed([0, 1])
    sched = Scheduler(store, device="cpu")
    rng = random.Random(7)
    states = []
    for step in range(cycles):
        sched.run_once()
        states.append(_mirror_state(store))
        if churn and step % 2 == 1:
            _churn(volcano_tpu_torch.api, store, rng, step)
    store.flush_binds()
    binds = dict(store.binder.binds)
    store.close()
    return binds, states


def test_pool_two_process_churn_parity(monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_WIRE", "1")
    procs = []
    try:
        addrs = []
        for _ in range(2):
            proc, port = spawn_child()
            procs.append(proc)
            addrs.append(f"127.0.0.1:{port}")
        pool = SolverPool(addrs, timeout=TIMEOUT)
        binds_p, states_p = _pool_loop(pool, cycles=4)
        frames = pool.per_replica_frames()
        pool.close()
    finally:
        for proc in procs:
            stop_child(proc)
    local = local_run(pipeline=True, cycles=4)
    assert binds_p and binds_p == local[-1]["binds"]
    assert states_p == [c["mirror"] for c in local]
    assert all(f["full"] >= 1 for f in frames), frames
    assert any(f["delta"] >= 1 for f in frames), frames


def test_pool_of_one_bitwise_equal_to_single_client(servers, monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_WIRE", "1")
    addr = f"127.0.0.1:{servers[0].port}"
    pool = SolverPool([addr], size=1, timeout=TIMEOUT)
    binds_p, states_p = _pool_loop(pool)
    pool_frames = dict(pool.frame_counts)
    pool_bytes = dict(pool.frame_bytes)
    pool.close()
    client = RemoteSolver(addr, timeout=TIMEOUT)
    binds_s, states_s = _pool_loop(client)
    single_frames = dict(client.frame_counts)
    single_bytes = dict(client.frame_bytes)
    client.close()
    assert binds_p and binds_p == binds_s
    assert states_p == states_s
    assert pool_frames == single_frames
    assert pool_bytes == single_bytes


def test_hedged_dispatch_first_wins_and_drains(servers, monkeypatch):
    """Some replies are held back until the pool has resolved the hedged
    fetch: the identical frame goes to the other replica, whose reply
    commits first; the held reply is drained (never abandoned), and the
    binds equal an unhedged run's."""
    monkeypatch.setenv("VOLCANO_TPU_WIRE", "1")
    monkeypatch.setenv("VOLCANO_TPU_POOL_HEDGE_P99_MULT", "2.0")
    monkeypatch.setenv("VOLCANO_TPU_POOL_HEDGE_MIN_MS", "150")
    resolved = threading.Semaphore(0)
    count = {"n": 0}
    lock = threading.Lock()

    def straggle(_i):
        # Solves are numbered across both children.  Solves 8, 11 and 14
        # are primaries (each held one is followed by its hedge); they
        # wait until a hedged fetch resolves (bounded, so a fetch that
        # never hedges only costs time).
        with lock:
            count["n"] += 1
            n = count["n"]
        if n in (8, 11, 14):
            resolved.acquire(timeout=TIMEOUT)
        return 0.0

    for s in servers:
        s.solve_delay_fn = straggle
    real = SolverPool._fetch_hedged

    def hedged(self, *a, **k):
        try:
            return real(self, *a, **k)
        finally:
            resolved.release()

    monkeypatch.setattr(SolverPool, "_fetch_hedged", hedged)
    pool = SolverPool([f"127.0.0.1:{s.port}" for s in servers],
                      timeout=TIMEOUT)
    binds_h, states_h = _pool_loop(pool, cycles=16, churn=False)
    snap = pool.health_snapshot()
    assert snap["hedge_dispatches"] >= 1, snap
    assert snap["hedge_wins"] >= 1, snap
    assert pool.wire_fallbacks.get("abandon", 0) == 0
    for r in pool.replicas:
        pool._drain(r, block=True)
    snap = pool.health_snapshot()
    assert all(not r["draining"] for r in snap["replicas"]), snap
    pool.close()

    monkeypatch.setenv("VOLCANO_TPU_POOL_HEDGE_P99_MULT", "0")
    for s in servers:
        s.solve_delay_fn = None
    pool2 = SolverPool([f"127.0.0.1:{s.port}" for s in servers],
                       timeout=TIMEOUT)
    binds_n, states_n = _pool_loop(pool2, cycles=16, churn=False)
    assert pool2.health_snapshot()["hedge_dispatches"] == 0
    pool2.close()
    assert binds_h and binds_h == binds_n
    assert states_h == states_n


def test_failover_within_one_cycle_zero_lost_pods(servers, monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_WIRE", "1")
    reset_uids()
    pool = SolverPool([f"127.0.0.1:{s.port}" for s in servers],
                      timeout=TIMEOUT)
    store = volcano_tpu_torch.synth.synthetic_cluster(
        n_nodes=16, n_pods=48, gang_size=4, seed=37)
    store.pipeline = True
    store.remote_solver = pool
    store.cycle_feed = _partial_feed([0, 1])
    sched = Scheduler(store, device="cpu")
    for _ in range(5):
        sched.run_once()
    prim = pool.health_snapshot()["primary"]
    servers[prim].shutdown()
    victim = pool.replicas[prim].client
    with victim._lock:
        victim._close_locked("kill")
    other = 1 - prim
    sched.run_once()
    rec = store.flight.recent()[-1]
    assert rec.drop_reasons.get("lost-reply", 0) >= 1, rec.drop_reasons
    assert rec.error is None
    snap = pool.health_snapshot()
    assert snap["failovers"] >= 1, snap
    assert snap["primary"] == other, snap
    assert pool.replicas[other].client.frame_counts["full"] >= 1
    for _ in range(3):
        sched.run_once()
    store.cycle_feed = None
    for _ in range(3):
        sched.run_once()
    store.flush_binds()
    m = store.mirror
    not_bound = [
        m.p_uid[r] for r in range(m.n_pods)
        if m.p_uid[r] is not None and m.p_alive[r]
        and int(m.p_status[r]) != ST_BOUND
    ]
    assert not_bound == [], f"pods lost to the kill: {not_bound}"
    assert store.auditor.total_anomalies() == 0
    store.close()
    pool.close()


PREEMPT_CONF = """
actions: "enqueue, allocate, preempt, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""


def test_whatif_offload_overlap(servers, monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_EVICT_DEVICE", "1")
    from volcano_tpu_torch.cache import ClusterStore, FakeBinder, FakeEvictor
    from volcano_tpu_torch.metrics import metrics
    from volcano_tpu_torch.sim import ClusterSimulator

    def _whatif_dispatches():
        return sum(
            v for k, v in metrics.solver_pool_dispatch.data.items()
            if dict(k).get("kind") == "whatif"
        )

    before = _whatif_dispatches()
    pool = SolverPool([f"127.0.0.1:{s.port}" for s in servers],
                      timeout=TIMEOUT)
    store = ClusterStore(evictor=FakeEvictor(), binder=FakeBinder())
    store.pipeline = True
    store.remote_solver = pool
    ClusterSimulator.priority_tier_workload(store, workers=4,
                                            serving_tasks=2)
    with store._lock:
        n_logical = len(store.pods)
    sched = Scheduler(store, conf_str=PREEMPT_CONF, device="cpu")
    sim = ClusterSimulator(store, grace_steps=2)
    bound = 0
    for _ in range(16):
        sched.run_once()
        sim.step()
        with store._lock:
            bound = sum(1 for p in store.pods.values()
                        if p.name.startswith("serving-") and p.node_name)
        if bound >= 2:
            break
    assert bound >= 2, "serving gang did not bind"
    assert _whatif_dispatches() > before
    ledger = store.migrations
    assert ledger is not None and ledger.committed_plans >= 1
    with store._lock:
        assert len(store.pods) == n_logical
    assert store.auditor.total_anomalies() == 0
    store.close()
    pool.close()


def test_whatif_stays_off_without_offload_capacity(servers, monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_EVICT_DEVICE", "1")
    from volcano_tpu_torch import whatif
    from volcano_tpu_torch.cache import ClusterStore

    store = ClusterStore()
    store.remote_solver = RemoteSolver(f"127.0.0.1:{servers[0].port}")
    assert not whatif.evict_device_on(store)
    store.remote_solver = SolverPool(
        [f"127.0.0.1:{servers[0].port}"], size=1)
    assert not whatif.evict_device_on(store)
    store.remote_solver = SolverPool(
        [f"127.0.0.1:{s.port}" for s in servers])
    assert whatif.evict_device_on(store)
    store.remote_solver = None
    assert whatif.evict_device_on(store)
    store.close()


def test_kill_switch_builds_plain_client(monkeypatch):
    monkeypatch.delenv("VOLCANO_TPU_SOLVER_POOL", raising=False)
    c = make_solver_client("127.0.0.1:1")
    assert isinstance(c, RemoteSolver)
    monkeypatch.setenv("VOLCANO_TPU_SOLVER_POOL", "3")
    c = make_solver_client("127.0.0.1:1")
    assert isinstance(c, SolverPool) and c.size == 3
    monkeypatch.delenv("VOLCANO_TPU_SOLVER_POOL")
    c = make_solver_client("127.0.0.1:1,127.0.0.1:2")
    assert isinstance(c, SolverPool) and c.size == 2
    addrs = [(r.client.host, r.client.port) for r in c.replicas]
    assert addrs == [("127.0.0.1", 1), ("127.0.0.1", 2)]
