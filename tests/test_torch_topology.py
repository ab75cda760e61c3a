"""The port's fabric-topology hooks against the JAX package's.

1. ``gang_block_fit`` and ``fabric_frag``: the plain versions of the port's
   kernels against the JAX jits on 30 seeds of random planes
   (``test_torch_fixtures.block_fit_case``: blockless rows, pod-slot caps,
   not-ready nodes, padded profiles with count 0, R = 3..5).  ``cfit`` and
   ``whole`` must be identical; ``score`` and ``fabric_frag`` bit-equal --
   both sum integer-valued floats below 2^24, which is exact in any order,
   and ``fabric_frag`` then divides once; no tolerance is given.  The
   port's ``gang_block_fit`` also returns ``frag`` (its launch writes
   ``fabric_frag``'s plane): bit-equal to the JAX ``fabric_frag`` of the
   JAX block fit's ``cfit`` / ``whole``, on the same cases.
2. ``fabric_planes`` on a ``fabric_cluster`` mirror (coordinates, block
   ids, block count, the interners) and ``has_fabric``; ``select_block``
   and ``contig_bias`` on seeded planes and at their edges.
3. ``solve_wave`` with a node-order bias against the JAX ``solve_wave``
   with the same bias on the same args: every result field bit for bit.
4. Twin ``Scheduler.run_once()`` runs, port vs JAX, of ``fabric_cluster``
   under ``REBALANCE_SCHEDULER_CONF``: require-contiguous (pregated, one
   wave frees a block, the gang binds in it), prefer-contiguous (binds on
   cycle 0, steered by the bias), ``VOLCANO_TPU_TOPOLOGY=0`` (binds
   scattered on cycle 0), a 40-task gang no block can ever host
   (rejected-topology), and a two-profile gang that every block hosts
   per profile but none whole (the post-solve gate vetoes the scattered
   placement: drop reason topology-infeasible).  Per cycle: binds,
   evictions, restores, the ledger, plan outcomes, topology placement
   counters, drop reasons and counts, the gated set, mirror state.
"""

import jax
import numpy as np
import pytest

from test_torch_fixtures import block_fit_case, tonp
from test_torch_rebalance import assert_twins, rebalance_twin

import volcano_tpu
from volcano_tpu.ops import topology as jtopo
from volcano_tpu.ops.wave import solve_wave as jax_solve_wave
from volcano_tpu.synth import fabric_cluster as jax_fabric
from volcano_tpu.synth import solve_args_from_store as jax_args
from volcano_tpu.synth import synthetic_cluster as jax_cluster

import volcano_tpu_torch
from volcano_tpu_torch import interop
from volcano_tpu_torch.framework import REBALANCE_SCHEDULER_CONF
from volcano_tpu_torch.ops import topology as ttopo
from volcano_tpu_torch.ops.wave import solve_wave as port_solve_wave
from volcano_tpu_torch.synth import fabric_cluster as port_fabric


# ------------------------------------------------ gang_block_fit, fabric_frag


@pytest.mark.parametrize("seed", range(30))
def test_block_fit_and_fabric_frag_plain_match_jax(seed):
    c = block_fit_case(seed, N=150 + seed, R=3 + seed % 3,
                       n_blocks=8 * (1 + seed % 3))
    args = (c["idle"], c["ready"], c["ntasks"], c["max_tasks"],
            c["block_id"], c["prof_req"], c["prof_cnt"], c["eps"])
    want = [np.asarray(a) for a in jax.device_get(
        jtopo.gang_block_fit(*args, n_blocks=c["n_blocks"]))]
    got = [t.numpy() for t in ttopo.gang_block_fit(
        *args, n_blocks=c["n_blocks"], device="cpu")]
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes()
    jf = np.asarray(jax.device_get(
        jtopo.fabric_frag(want[0], want[1], c["prof_cnt"])))
    tf = ttopo.fabric_frag(got[0], got[1], c["prof_cnt"],
                           device="cpu").numpy()
    assert jf.dtype == tf.dtype and jf.tobytes() == tf.tobytes()


@pytest.mark.parametrize("seed,N,n_blocks", [
    (0, 1, 4), (1, 31, 4), (2, 300, 16), (3, 1025, 16), (4, 2049, 64),
    (5, 700, 8), (6, 4096, 32), (7, 333, 128)])
def test_block_fit_edges_plain_match_jax(seed, N, n_blocks):
    """The rows the card kernel skips or caps (``block_fit_edge_case``:
    block ids -1, -7, n_blocks and past it, nodes not ready, ``ntasks``
    past a positive ``max_tasks``, an all-zero profile row with and
    without a count), at node counts below and just past a multiple of
    the kernel's 1,024 threads: cfit, whole, score and fabric_frag
    bit-equal to the JAX jits."""
    from test_torch_fixtures import block_fit_edge_case

    c = block_fit_edge_case(seed, N=N, R=3 + seed % 3, n_blocks=n_blocks)
    args = (c["idle"], c["ready"], c["ntasks"], c["max_tasks"],
            c["block_id"], c["prof_req"], c["prof_cnt"], c["eps"])
    want = [np.asarray(a) for a in jax.device_get(
        jtopo.gang_block_fit(*args, n_blocks=n_blocks))]
    got = [t.numpy() for t in ttopo.gang_block_fit(
        *args, n_blocks=n_blocks, device="cpu")]
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes()
    jf = np.asarray(jax.device_get(
        jtopo.fabric_frag(want[0], want[1], c["prof_cnt"])))
    tf = ttopo.fabric_frag(got[0], got[1], c["prof_cnt"],
                           device="cpu").numpy()
    assert jf.dtype == tf.dtype and jf.tobytes() == tf.tobytes()
    if seed % 2:
        assert not want[1].any()


def test_block_fit_cases_are_not_vacuous():
    """Whole and partial blocks, stranded capacity and pod-slot caps all
    occur."""
    whole = partial = capped = 0
    for seed in range(30):
        c = block_fit_case(seed, N=150 + seed, R=3 + seed % 3,
                           n_blocks=8 * (1 + seed % 3))
        cfit, w, _score, _frag = (t.numpy() for t in ttopo.gang_block_fit(
            c["idle"], c["ready"], c["ntasks"], c["max_tasks"],
            c["block_id"], c["prof_req"], c["prof_cnt"], c["eps"],
            n_blocks=c["n_blocks"], device="cpu"))
        f = ttopo.fabric_frag(cfit, w, c["prof_cnt"], device="cpu").numpy()
        whole += int(w.sum())
        partial += int((f > 0).sum())
        capped += int(((c["max_tasks"] > 0)
                       & (c["max_tasks"] <= c["ntasks"])).sum())
    assert whole > 10 and partial > 10 and capped > 10


def _frag_cases():
    return ([(seed, 150 + seed, 3 + seed % 3, 8 * (1 + seed % 3), False)
             for seed in range(30)]
            + [(seed, N, 3 + seed % 3, n_blocks, True) for seed, N, n_blocks
               in ((0, 1, 4), (1, 31, 4), (2, 300, 16), (3, 1025, 16),
                   (4, 2049, 64), (5, 700, 8), (6, 4096, 32),
                   (7, 333, 128))])


@pytest.mark.parametrize("seed,N,R,n_blocks,edge", _frag_cases())
def test_block_fit_frag_plain_matches_jax_fabric_frag(seed, N, R, n_blocks,
                                                       edge):
    """The block fit's ``frag`` (the plain version of what its launch
    writes) against the JAX ``fabric_frag`` of the JAX block fit's cfit
    and whole, bytes compared (+0.0 and -0.0 told apart), on every case of
    the two tests above."""
    from test_torch_fixtures import block_fit_edge_case

    make = block_fit_edge_case if edge else block_fit_case
    c = make(seed, N=N, R=R, n_blocks=n_blocks)
    args = (c["idle"], c["ready"], c["ntasks"], c["max_tasks"],
            c["block_id"], c["prof_req"], c["prof_cnt"], c["eps"])
    jf = jtopo.gang_block_fit(*args, n_blocks=n_blocks)
    want = np.asarray(jax.device_get(
        jtopo.fabric_frag(jf.cfit, jf.whole, c["prof_cnt"])))
    got = ttopo.gang_block_fit(*args, n_blocks=n_blocks, device="cpu")
    assert got._fields[-1] == "frag"
    frag = got.frag.numpy()
    assert want.dtype == frag.dtype and want.tobytes() == frag.tobytes()


# ---------------------------------------------------------- mirror planes


def test_fabric_planes_equal_on_fabric_cluster():
    js = jax_fabric(racks=3, slices_per_rack=2, nodes_per_slice=8,
                    hosts_per_slice=4)
    ts = port_fabric(racks=3, slices_per_rack=2, nodes_per_slice=8,
                     hosts_per_slice=4)
    # A node without fabric labels joins no block.
    for pkg, store in ((volcano_tpu, js), (volcano_tpu_torch, ts)):
        store.add_node(pkg.api.Node(name="plain", allocatable={
            "cpu": "4", "memory": "16Gi"}))
    want = jtopo.fabric_planes(js.mirror)
    got = ttopo.fabric_planes(ts.mirror)
    assert np.array_equal(want[0], got[0]) and np.array_equal(want[1],
                                                              got[1])
    assert want[2] == got[2] == 6
    assert got[1][-1] == -1
    assert ts.mirror._fabric_vals == js.mirror._fabric_vals
    assert ts.mirror._fabric_blocks == js.mirror._fabric_blocks
    assert ttopo.has_fabric(ts.mirror) and jtopo.has_fabric(js.mirror)
    # Cached by node epoch: the same arrays until the node table moves.
    assert ttopo.fabric_planes(ts.mirror)[1] is got[1]
    bare = volcano_tpu_torch.cache.ClusterStore()
    bare.add_node(volcano_tpu_torch.api.Node(name="n", allocatable={
        "cpu": "1"}))
    assert not ttopo.has_fabric(bare.mirror)


@pytest.mark.parametrize("seed", range(10))
def test_select_block_and_contig_bias_match_jax(seed):
    rng = np.random.RandomState(seed)
    B = int(rng.randint(1, 20))
    whole = rng.rand(B) < 0.3
    score = rng.randint(0, 5, B).astype(np.float32)  # ties
    for require in (True, False):
        sel = ttopo.select_block(whole, score, require)
        assert sel == jtopo.select_block(whole, score, require)
        block = rng.randint(-1, B, 50).astype(np.int32)
        for weight in (None, 0.0, 2.5):
            want = jtopo.contig_bias(block, sel, 64, weight)
            got = ttopo.contig_bias(block, sel, 64, weight)
            assert want.dtype == got.dtype and np.array_equal(want, got)


def test_select_block_edges():
    assert ttopo.select_block(np.zeros(3, bool), np.ones(3), True) == -1
    assert ttopo.select_block(np.zeros(3, bool), np.ones(3), False) == 0
    assert not ttopo.contig_bias(np.zeros(4, np.int32), -1, 8).any()


# ------------------------------------------------------ biased solve


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_wave_with_node_bias_matches_jax(seed):
    """The same args and bias through both solves: every field equal bit
    for bit, and the bias changes the assignment."""
    rng = np.random.RandomState(seed)
    args, _ = jax_args(jax_cluster(n_nodes=48, n_pods=160, gang_size=4,
                                   n_queues=2, seed=seed), nodeorder=True)
    N = int(np.asarray(args[0].idle).shape[0])
    bias = np.where(rng.rand(N) < 0.25, 3.0, 0.0).astype(np.float32)
    jr = tonp(jax_solve_wave(*args, bias, wave=64))
    plain = tonp(jax_solve_wave(*args, wave=64))
    targs = interop.solve_args_from_numpy(tonp(args))
    tr = interop.result_to_numpy(
        port_solve_wave(*targs, bias, wave=64, device="cpu"))
    for f in ("assigned", "pipelined", "never_ready", "fit_failed", "idle",
              "q_alloc", "iters", "fb_exhausted", "fb_affinity"):
        a, b = np.asarray(getattr(jr, f)), np.asarray(getattr(tr, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert not np.array_equal(np.asarray(jr.assigned),
                              np.asarray(plain.assigned))


# ------------------------------------------------------------ twin cycles


def fabric(**kw):
    def make(pkg):
        return pkg.synth.fabric_cluster(binder=pkg.cache.FakeBinder(), **kw)
    return make


@pytest.fixture
def fabric_env(monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_EVICT_DEVICE", "1")
    for k in ("VOLCANO_TPU_REBALANCE", "VOLCANO_TPU_REBALANCE_MIN_GAIN",
              "VOLCANO_TPU_REBALANCE_MAX_UNAVAIL", "VOLCANO_TPU_TOPOLOGY",
              "VOLCANO_TPU_TOPO_WEIGHT", "VOLCANO_TPU_DEVINCR",
              "VOLCANO_TPU_DEVSNAP"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("VOLCANO_TPU_REBALANCE_DRAIN_CAP", "64")
    return monkeypatch


def _twins(*args):
    want = rebalance_twin(volcano_tpu, *args)
    got = rebalance_twin(volcano_tpu_torch, *args)
    assert_twins(want, got)
    return got


def _gang(t):
    return sorted(node for k, node in t["binds"].items()
                  if k.startswith("default/fabgang-"))


def _blocks(nodes, nodes_per_slice=16):
    return {int(n.split("-")[1]) // nodes_per_slice for n in nodes}


PLACEMENTS = "topology_placements"


def test_twin_require_contiguous_defrag(fabric_env):
    """The acceptance fabric: cycle 0 gates the gang and commits one
    wave; after the grace window all 32 tasks bind inside one block and
    every filler is bound again."""
    got = _twins(fabric(), REBALANCE_SCHEDULER_CONF, 2, 6)
    assert got[0]["gated"] == ["default/fabgang"] and not _gang(got[0])
    assert got[0]["rebalance"]["outcome"] == "committed"
    assert got[0]["series"][PLACEMENTS] == {
        (("outcome", "infeasible"),): 1.0}
    last = got[-1]
    assert len(_gang(last)) == 32 and len(_blocks(_gang(last))) == 1
    assert last["ledger"][0] == 1 and len(last["restored"]) == 2
    assert last["series"][PLACEMENTS][(("outcome", "contiguous"),)] == 1.0
    assert sum(k.startswith("default/filler-") for k in last["binds"]) == 2


@pytest.mark.parametrize("topology", ["require-contiguous",
                                      "prefer-contiguous"])
def test_twin_frag_gauges_equal(fabric_env, topology):
    """``volcano_topology_frag_score`` (read from the block fit's ``frag``
    in the port, from a ``fabric_frag`` call in the JAX package) and
    ``volcano_rebalance_frag_score`` after every cycle: equal in the two
    packages, and set on the require-contiguous fabric."""
    from volcano_tpu.metrics import metrics as jax_metrics

    from volcano_tpu_torch.metrics import metrics as port_metrics

    seen = {}

    def gauges(pkg):
        m = jax_metrics if pkg is volcano_tpu else port_metrics
        return m.topology_frag_score, m.rebalance_frag_score

    def setup(pkg, store, sched, sim):
        for g in gauges(pkg):
            g.data.clear()
        seen[pkg] = []

    def churn(pkg, store, rng):
        seen[pkg].append(tuple(dict(g.data) for g in gauges(pkg)))

    args = (fabric(topology=topology), REBALANCE_SCHEDULER_CONF, 2, 4,
            setup, churn)
    assert_twins(rebalance_twin(volcano_tpu, *args),
                 rebalance_twin(volcano_tpu_torch, *args))
    assert seen[volcano_tpu] == seen[volcano_tpu_torch]
    if topology == "require-contiguous":
        assert seen[volcano_tpu_torch][0][0], seen


def test_twin_prefer_contiguous_binds_first_cycle(fabric_env):
    """prefer-contiguous: no block can host the gang whole, so it binds on
    cycle 0 spread from the block the bias selects; counted scattered."""
    got = _twins(fabric(topology="prefer-contiguous"),
                 REBALANCE_SCHEDULER_CONF, 2, 3)
    assert len(_gang(got[0])) == 32 and got[0]["gated"] == []
    assert got[0]["series"][PLACEMENTS] == {
        (("outcome", "scattered"),): 1.0}
    assert got[-1]["ledger"] is None


def test_twin_prefer_contiguous_bias_fills_a_whole_block(fabric_env):
    """A prefer gang that fits one block binds inside it (the bias steers
    every task onto the selected block's nodes)."""
    got = _twins(fabric(topology="prefer-contiguous", gang_tasks=24),
                 REBALANCE_SCHEDULER_CONF, 2, 2)
    assert len(_gang(got[0])) == 24 and len(_blocks(_gang(got[0]))) == 1
    assert got[0]["series"][PLACEMENTS] == {
        (("outcome", "contiguous"),): 1.0}


def test_twin_topology_switched_off(fabric_env):
    """VOLCANO_TPU_TOPOLOGY=0: no gate, no bias, the require gang binds
    scattered on cycle 0 and nothing is counted."""
    fabric_env.setenv("VOLCANO_TPU_TOPOLOGY", "0")
    got = _twins(fabric(), REBALANCE_SCHEDULER_CONF, 2, 2)
    assert len(_gang(got[0])) == 32 and len(_blocks(_gang(got[0]))) > 1
    assert got[0]["series"][PLACEMENTS] == {}
    assert got[-1]["ledger"] is None


def test_twin_no_block_can_ever_host(fabric_env):
    """A 40-task gang on 16-node blocks (32 slots even when drained): the
    planner counts rejected-topology and backs off; nothing is evicted and
    the gang stays gated."""
    got = _twins(fabric(gang_tasks=40), REBALANCE_SCHEDULER_CONF, 2, 4)
    assert got[0]["rebalance"]["outcome"] == "rejected-topology"
    assert all(t["evictions"] == [] and not _gang(t) for t in got)
    assert all(t["gated"] == ["default/fabgang"] for t in got)
    assert got[-1]["series"]["whatif_plans"] == {
        (("action", "rebalance"), ("outcome", "rejected-topology")): 1.0}


def split_gang_fabric(pkg):
    """4 blocks of 16 four-cpu nodes, two 3-cpu fillers per block (28
    two-cpu slots a block), and a require-contiguous gang of 16 + 16
    two-cpu tasks in two memory profiles: each profile alone fits every
    block (``gang_block_fit`` counts profiles independently), the 32
    together fit none."""
    api = pkg.api
    store = pkg.cache.ClusterStore(binder=pkg.cache.FakeBinder())
    for i in range(64):
        store.add_node(api.Node(
            name=f"fab-{i:04d}",
            allocatable={"cpu": "4", "memory": "16Gi", "pods": 110},
            labels=pkg.synth.fabric_labels(i, nodes_per_host=2,
                                           hosts_per_slice=8,
                                           slices_per_rack=2)))
    for b in range(4):
        for k in range(2):
            name = f"filler-{b}-{k}"
            store.add_pod_group(api.PodGroup(name=name, min_member=1))
            store.add_pod(api.Pod(
                name=name, annotations={api.GROUP_NAME_ANNOTATION: name},
                containers=[{"cpu": "3", "memory": "1Gi"}],
                phase=api.PodPhase.Running, node_name=f"fab-{16 * b + k:04d}"))
    store.add_pod_group(api.PodGroup(name="fabgang", min_member=32,
                                     topology="require-contiguous"))
    for k in range(32):
        store.add_pod(api.Pod(
            name=f"fabgang-{k:03d}",
            annotations={api.GROUP_NAME_ANNOTATION: "fabgang"},
            containers=[{"cpu": "2",
                         "memory": "1Gi" if k < 16 else "2Gi"}]))
    return store


def test_twin_gate_vetoes_scattered_require_gang(fabric_env):
    """The pregate lets the two-profile gang through (every block is whole
    per profile); the solve spreads it over two blocks and the gate vetoes
    every row before commit, under topology-infeasible."""
    got = _twins(split_gang_fabric, REBALANCE_SCHEDULER_CONF, 2, 3)
    assert not _gang(got[0])
    assert got[0]["drops"] == (32, {"topology-infeasible": 32})
    assert got[0]["series"][PLACEMENTS] == {
        (("outcome", "infeasible"),): 1.0}
    assert got[0]["series"]["pipeline_stale_drops"] == {
        (("reason", "topology-infeasible"),): 32.0}
