"""The port's fault registry and its matrix: twins of the ``tests/test_faults.py``
MATRIX rows for the points whose sites the port has.

For every point in the port's registry a seeded single-fault run of the
port's batched scheduler over its store (in process, or over HTTP through
its apiserver) must converge, with the recovery visible in the port's
metrics, and its recovered bindings must equal the JAX package's under the
same seeded plan, and the fault-free oracle's: the exact pod→node map
where the recovery re-decides nothing, the per-node occupancy where it
requeues a pod (identical pods).  Both packages run the same world: six
nodes of pairwise non-proportional capacities (no score ties) created
directly, forty identical pods, no kubelets.

Two rows differ by design: ``backend.pallas.segment`` and
``backend.compact``.  The JAX backend degrades a failed segment down its
ladder (the XLA scan, then the oracle) and retries a failed frontier
segment at full width; the port has neither, so the injected failure
raises out of the wave, the scheduler requeues the drained pods, and the
next wave binds them.  Both end on the oracle's bindings.

Tolerance: exact equality of bindings (or of per-node counts where noted).
"""

import collections
import importlib
import time
import urllib.error
from types import SimpleNamespace

import pytest

from kubernetes_tpu_torch import faults
from kubernetes_tpu_torch.faults import FaultConfigError, FaultInjected, FaultPlan, FaultSpec

PORT, JAX = "kubernetes_tpu_torch", "kubernetes_tpu"
N_PODS = 40
NODE_SHAPES = [("3", "17Gi"), ("4", "6Gi"), ("5", "23Gi"),
               ("7", "9Gi"), ("11", "29Gi"), ("13", "12Gi")]


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def advance(self, dt):
        self.now += dt

    def __call__(self):
        return self.now


def _mods(pkg: str) -> SimpleNamespace:
    imp = importlib.import_module
    M = SimpleNamespace(
        pkg=pkg, faults=imp(f"{pkg}.faults"), Store=imp(f"{pkg}.store").Store,
        Clientset=imp(f"{pkg}.client").Clientset,
        RemoteStore=imp(f"{pkg}.client.remote").RemoteStore,
        Scheduler=imp(f"{pkg}.scheduler").Scheduler,
        GenericScheduler=imp(f"{pkg}.scheduler").GenericScheduler,
        make_node=imp(f"{pkg}.testutil").make_node, make_pod=imp(f"{pkg}.testutil").make_pod,
        tracing=imp(f"{pkg}.utils.tracing"), timeseries=imp(f"{pkg}.utils.timeseries"),
        telemetry=imp(f"{pkg}.utils.telemetry"))
    if pkg == PORT:
        M.APIServer = imp(f"{pkg}.apiserver.server").APIServer
        M.backend = lambda clock: imp(f"{pkg}.ops.backend").BatchBackend(
            algorithm=M.GenericScheduler(), device="cpu")
        M.remote = lambda server, **kw: M.RemoteStore(server.url, **kw)
    else:
        M.APIServer = imp(f"{pkg}.apiserver").APIServer
        M.backend = lambda clock: imp(f"{pkg}.ops").TPUBatchBackend(
            algorithm=M.GenericScheduler(), clock=clock)
        ClientMetrics = imp(f"{pkg}.utils.metrics").ClientMetrics
        M.remote = lambda server, **kw: M.RemoteStore(
            server.url, retry_backoff=0.005, retry_backoff_max=0.02, metrics=ClientMetrics(),
            **kw)
    return M


def _fast_sleep(s):
    time.sleep(min(s, 0.02))


def _nodes(M, cs):
    for i, (cpu, mem) in enumerate(NODE_SHAPES):
        cs.nodes.create(M.make_node(f"hollow-{i:05d}", cpu=cpu, memory=mem))


class World:
    """The matrix's world for package ``pkg``: the store (or an apiserver
    over it, the scheduler watching through ``RemoteStore``), the nodes,
    and a scheduler on the package's batch backend (the port's on the
    CPU's plain scan)."""

    def __init__(self, pkg, server=None, store=None):
        self.M = M = _mods(pkg)
        self.clock = FakeClock()
        self.server = server
        if server is not None:
            self.store = server.store
            self.remote = M.remote(server, sleep=_fast_sleep)
            sched_store = self.remote
        else:
            self.store = store if store is not None else M.Store()
            sched_store = self.store
        self.cs = M.Clientset(self.store)
        _nodes(M, self.cs)
        self.backend = M.backend(self.clock)
        self.sched = M.Scheduler(M.Clientset(sched_store), backend=self.backend, clock=self.clock)
        self.sched.start()
        self.raised = 0  # waves that raised out of schedule_pending_batch

    def create_workload(self, cs=None, names=range(N_PODS)):
        for i in names:
            (cs or self.cs).pods.create(self.M.make_pod(f"work-{i:03d}", cpu="200m",
                                                        memory="256Mi"))

    def bindings(self):
        return {p.meta.name: p.spec.node_name for p in self.cs.pods.list()[0]
                if p.meta.name.startswith("work-")}

    def converged(self):
        b = self.bindings()
        return len(b) == N_PODS and all(b.values())

    def wave(self):
        try:
            self.sched.schedule_pending_batch()
        except FaultInjected:
            # the port's kernel seam raises; the scheduler has requeued the
            # wave's drained pods
            self.raised += 1

    def drive(self, rounds=40, relist_every=5, realtime=False):
        for r in range(rounds):
            if realtime:
                time.sleep(0.03)  # let the watch threads deliver
            self.clock.advance(1.0)
            self.sched.pump()
            self.wave()
            self.sched.pump()
            if relist_every and (r + 1) % relist_every == 0:
                self.sched.informers.relist_all()
            if self.converged():
                return r
        return rounds


def _wait(pred, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def _oracle_baseline(pkg):
    """The fault-free per-pod oracle over the same world."""
    M = _mods(pkg)
    clock = FakeClock()
    cs = M.Clientset(M.Store())
    _nodes(M, cs)
    sched = M.Scheduler(cs, clock=clock)
    sched.start()
    for i in range(N_PODS):
        cs.pods.create(M.make_pod(f"work-{i:03d}", cpu="200m", memory="256Mi"))
    for _ in range(10):
        clock.advance(1.0)
        sched.pump()
        sched.run_pending()
    out = {p.meta.name: p.spec.node_name for p in cs.pods.list()[0]}
    assert len(out) == N_PODS and all(out.values())
    return out


@pytest.fixture(scope="module")
def oracle_bindings():
    port = _oracle_baseline(PORT)
    assert port == _oracle_baseline(JAX), "the two packages' oracles differ on the world"
    return port


def _counts(bindings):
    return dict(collections.Counter(bindings.values()))


# point -> (the port's spec, world, exact map?, the port's recovery check
# [, the JAX side's spec where its site differs]).  The JAX rows are
# tests/test_faults.py's MATRIX.
MATRIX = {
    # over the wire: the apiserver's panic filter turns the injected
    # store failure into a 500 and the client retries the same binds
    "store.commit": dict(
        spec=dict(mode="error", match={"op": "bind_many"}, first_n=1),
        world="remote", exact=True,
        check=lambda w: w.remote.metrics.remote_retries.value > 0),
    "scheduler.bind": dict(
        spec=dict(mode="drop", match={"via": "bind_many"}, first_n=1),
        world="local", exact=False,
        check=lambda w: w.sched.metrics.bind_requeues.value > 0),
    "informer.deliver": dict(
        spec=dict(mode="drop", match={"kind": "Pod", "type": "ADDED"}, first_n=1),
        world="local", exact=False,
        check=lambda w: (w.sched.informers.informer("Pod").stats["dropped_events"] > 0
                         and w.sched.informers.informer("Pod").stats["relists"] > 0)),
    "informer.decode": dict(
        spec=dict(mode="error", match={"kind": "Pod", "type": "ADDED"}, nth=5),
        world="local", exact=False,
        check=lambda w: (w.sched.informers.informer("Pod").stats["decode_errors"] > 0
                         and w.sched.informers.informer("Pod").stats["relists"] > 0)),
    # every Pod frame lost whole for the whole run: gaps and relists, no
    # decision re-made
    "informer.apply_batch": dict(
        spec=dict(mode="error", match={"kind": "Pod"}),
        world="local", exact=True,
        check=lambda w: (w.sched.pump() is not None
                         and w.sched.informers.informer("Pod").stats["batch_errors"] > 0
                         and w.sched.informers.informer("Pod").stats["relists"] > 0
                         and all(st[2] == "bound"
                                 for st in w.sched.cache._pod_states.values()))),
    # the port raises and requeues; the JAX backend degrades the segment
    "backend.pallas.segment": dict(
        spec=dict(mode="error", match={"impl": "cpu", "phase": "launch"}, first_n=1),
        jax_spec=dict(mode="error", match={"impl": "interpret"}, first_n=1),
        world="local", exact=True,
        check=lambda w: w.raised == 1 and w.backend.stats["oracle_pods"] == 0),
    # the frontier's prefilter seam: the port raises and requeues, the JAX
    # backend retries the segment at full width
    "backend.compact": dict(
        spec=dict(mode="error", match={"phase": "seed"}, first_n=1),
        world="local", exact=True,
        check=lambda w: w.raised == 1 and w.backend.stats["oracle_pods"] == 0),
    "scheduler.pipeline.prep": dict(
        spec=dict(mode="error", first_n=1),
        world="local", exact=True,
        check=lambda w: w.sched.metrics.pipeline_prep_failures.value > 0),
    "remote.request": dict(
        spec=dict(mode="error", first_n=2,
                  error_factory=lambda: urllib.error.URLError(ConnectionRefusedError("reset"))),
        world="remote", exact=True,
        check=lambda w: w.remote.metrics.remote_retries.value > 0),
    "remote.watch.stream": dict(
        spec=dict(mode="error", match={"phase": "event", "resource": "pods"}, nth=3,
                  error_factory=lambda: ConnectionResetError("cut")),
        world="remote", exact=True,
        check=lambda w: w.remote.metrics.watch_reconnects.value > 0),
    "telemetry.ship": dict(world="telemetry"),
    "apiserver.admit": dict(world="admit"),
}


def test_every_registered_point_has_a_matrix_scenario():
    assert set(MATRIX) == set(faults.registry()), (
        f"missing={set(faults.registry()) - set(MATRIX)} "
        f"stale={set(MATRIX) - set(faults.registry())}")


def test_the_registry_is_the_ported_points_and_apart_from_the_jax_one():
    """Every port point carries its JAX twin's name; the points whose
    sites are not ported are absent; the JAX registry is untouched."""
    from kubernetes_tpu import faults as jax_faults

    assert set(faults.registry()) < set(jax_faults.registry())
    assert set(jax_faults.registry()) - set(faults.registry()) == {
        "store.wal.append", "store.coalesce"}
    assert faults.registry() is not jax_faults.registry()
    assert faults.FaultPlan is not jax_faults.FaultPlan


def test_hit_is_noop_when_disarmed_and_plans_are_checked():
    assert faults.hit("scheduler.bind", pod="x") is None
    with pytest.raises(FaultConfigError, match="unknown fault point"):
        FaultPlan().on("store.wal.append", mode="error")  # not ported
    plan = FaultPlan()
    with plan.armed():
        with pytest.raises(FaultConfigError):
            faults.hit("no.such.point")
        with pytest.raises(FaultConfigError, match="already armed"):
            FaultPlan().armed().__enter__()
    assert faults.active_plan() is None


def test_triggers_are_seeded_and_exact():
    plan = FaultPlan(seed=3).on("remote.request", mode="error", nth=2, match={"method": "GET"})
    with plan.armed():
        assert faults.hit("remote.request", method="POST") is None
        assert faults.hit("remote.request", method="GET") is None
        with pytest.raises(FaultInjected):
            faults.hit("remote.request", method="GET")
        assert faults.hit("remote.request", method="GET") is None
    assert plan.fired == {"remote.request": 1} and plan.hits == {"remote.request": 4}

    def fires(seed):
        p = FaultPlan(seed=seed).on("informer.deliver", mode="drop", probability=0.5)
        with p.armed():
            return [faults.hit("informer.deliver") is not None for _ in range(32)]

    assert fires(7) == fires(7) and fires(7) != fires(8)


def _run_telemetry(pkg, oracle_bindings):
    """The collector is down for the whole run: every ship attempt faults,
    the batches go to the shipper's dead ring after retry and backoff, the
    flight recorder keeps its dumps, and the waves neither stall nor
    diverge."""
    w = World(pkg)
    M = w.M

    class _NeverSink:
        def ship(self, batch):
            raise AssertionError("sink reached while the collector fault is armed")

    M.tracing.enable()
    plan = M.faults.FaultPlan(seed=7).on("telemetry.ship", mode="error")
    try:
        store = M.timeseries.enable(w.sched.metrics.registry, interval_s=1.0, clock=w.clock,
                                    start_thread=False)
        shp = M.telemetry.enable(_NeverSink(), registry=w.sched.metrics.registry,
                                 start_thread=False, retries=2, backoff_s=0.0,
                                 sleep=lambda s: None)
        store.add_observer(M.telemetry.timeseries_observer(shp))
        with plan.armed():
            w.create_workload()
            w.drive()
            store.sample_once()
            snap = M.tracing.current().dump("telemetry-matrix", txn="telemetry-matrix-corr")
            shp.drain_all()
        stats = shp.stats()
        assert plan.fired["telemetry.ship"] > 0
        assert stats["shipped"] == 0 and stats["dead_lettered"] > 0
        assert stats["ship_retries"] > 0 and stats["queued"] == 0
        assert {"flight_dump", "timeseries"} <= {r.get("kind") for r in shp.dead}
        assert stats["feedback_dropped"] > 0
        assert snap in list(M.tracing.current().dumps)
        return w.bindings()
    finally:
        M.telemetry.disable()
        M.timeseries.disable()
        M.tracing.disable()


def _run_admit(pkg, oracle_bindings):
    """A throttle surge on the create path: 429 + Retry-After for the
    first two create attempts, honoured by the client; the delayed pods
    arrive mid-run and re-decide."""
    M = _mods(pkg)
    server = M.APIServer(M.Store())
    server.start()
    w = None
    try:
        w = World(pkg, server=server)
        rcs_store = M.remote(server, sleep=_fast_sleep)
        rcs = M.Clientset(rcs_store)
        plan = M.faults.FaultPlan(seed=11).on("apiserver.admit", mode="drop", value=0.05,
                                              first_n=2)
        with plan.armed():
            w.create_workload(rcs, range(N_PODS // 2))
            w.drive(rounds=6, realtime=True)
            w.create_workload(rcs, range(N_PODS // 2, N_PODS))
            w.drive(realtime=True)
        if not w.converged():
            _wait(lambda: (w.sched.pump(), w.drive(rounds=5, realtime=True), w.converged())[-1])
        assert w.converged()
        assert plan.fired["apiserver.admit"] == 2
        assert server.admission_throttled.value == 2
        assert rcs_store.metrics.retry_after_honored.value == 2
        return w.bindings()
    finally:
        if w is not None:
            w.sched.informers.stop_all()
        server.stop()


def _run_point(pkg, point, oracle_bindings):
    """One seeded single-fault run of ``point`` in ``pkg``; returns the
    recovered bindings after checking convergence and the recovery path."""
    scenario = MATRIX[point]
    if scenario["world"] == "telemetry":
        return _run_telemetry(pkg, oracle_bindings)
    if scenario["world"] == "admit":
        return _run_admit(pkg, oracle_bindings)
    M = _mods(pkg)
    server = None
    if scenario["world"] == "remote":
        server = M.APIServer(M.Store())
        server.start()
    w = None
    try:
        w = World(pkg, server=server)
        spec = scenario.get("jax_spec", scenario["spec"]) if pkg == JAX else scenario["spec"]
        plan = M.faults.FaultPlan(seed=42).on(point, M.faults.FaultSpec(**spec))
        with plan.armed():
            w.create_workload()
            w.drive(realtime=scenario["world"] == "remote")
        if not w.converged() and scenario["world"] == "remote":
            _wait(lambda: (w.sched.pump(), w.drive(rounds=5, realtime=True), w.converged())[-1])
        assert w.converged(), f"{pkg} {point}: never converged"
        assert plan.fired.get(point, 0) > 0, f"{pkg} {point}: the fault never fired"
        if pkg == PORT:
            assert scenario["check"](w), f"{point}: recovery not visible in the port's metrics"
        return w.bindings()
    finally:
        if server is not None:
            if w is not None:
                w.sched.informers.stop_all()
            server.stop()


@pytest.mark.parametrize("point", sorted(MATRIX))
def test_fault_matrix_recovers_as_the_jax_package(point, oracle_bindings):
    got = _run_point(PORT, point, oracle_bindings)
    want = _run_point(JAX, point, oracle_bindings)
    exact = MATRIX[point].get("exact", True) if MATRIX[point]["world"] != "admit" else False
    if exact:
        assert got == want == oracle_bindings, f"{point}: bindings differ"
    else:
        assert _counts(got) == _counts(want) == _counts(oracle_bindings), (
            f"{point}: per-node occupancy differs")
        assert set(got) == set(want) == set(oracle_bindings)


def test_the_kernel_seam_raises_and_requeues_at_finalize_too(oracle_bindings):
    """The seam's second site, the segment's finalize: the wave raises
    after the launch, no segment committed, every drained pod is requeued
    and the next wave binds them as the oracle does.  Nothing reroutes
    the segment."""
    w = World(PORT)
    plan = FaultPlan(seed=1).on("backend.pallas.segment",
                                FaultSpec(mode="error", match={"phase": "finalize"}, first_n=1))
    with plan.armed():
        w.create_workload()
        w.clock.advance(1.0)
        w.sched.pump()
        w.wave()
        assert w.raised == 1 and len(w.sched.queue) == N_PODS
        assert not any(w.bindings().values())
        w.drive()
    assert w.converged() and w.bindings() == oracle_bindings
    assert w.backend.stats["oracle_pods"] == 0 and plan.fired == {"backend.pallas.segment": 1}


def test_fault_injection_disruption_in_chaos_protocol():
    """``testing.chaos.FaultInjection``: bind failures for the chaos window,
    the workload heals after ``recover_at`` and every pod lands inside the
    nodes' capacity."""
    from kubernetes_tpu_torch.testing import ChaosMonkey, FaultInjection

    w = World(PORT)
    w.create_workload()
    plan = FaultPlan(seed=9).on("scheduler.bind", mode="drop", match={"via": "bind_many"},
                                probability=0.5)

    def tick(t):
        w.clock.advance(1.0)
        w.sched.pump()
        w.wave()
        w.sched.pump()

    cm = ChaosMonkey(tick, [FaultInjection(plan)], inject_at=0, recover_at=6,
                     done=w.converged, max_ticks=60)
    cm.run()
    assert cm.injected and cm.recovered and faults.active_plan() is None
    assert w.converged() and plan.fired.get("scheduler.bind", 0) > 0
    assert w.sched.metrics.bind_requeues.value > 0
    per_node = _counts(w.bindings())
    caps = {f"hollow-{i:05d}": int(cpu) * 5 for i, (cpu, _) in enumerate(NODE_SHAPES)}
    assert all(per_node[n] <= caps[n] for n in per_node)
