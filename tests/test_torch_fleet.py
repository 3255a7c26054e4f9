"""The port's serving fleet (``ompi_tpu_torch/serving/fleet.py``: the pool
specs, the fleet controller and its telemetry autoscaler, with tpurun's
``--pool`` and the ``fleet`` telemetry source) held against the JAX
package's ``ompi_tpu.serving.fleet`` on the CPU.

The same seeded inputs go through both packages:

* fair-share admission: the admitted tenants and request order of every
  tick under weighted round-robin, per-tenant FIFO with a tenant first seen
  at submit time, the invariant checker tripping on a poisoned log, and
  the weight check's error class;
* the autoscaler over one stub fleet: the per-pool cooldown, the per-pool
  cap and idle retirement (the reference's cases), and a seeded script of
  queue depths, telemetry samples (a per-pool p99 in the router rank's
  histogram delta, sample sequence numbers that stop advancing) and clock
  readings, whose every decision, capacity call and counter must equal
  the reference's;
* the fleet's one recovery over a stub comm: a ULFM error from any pool
  revokes and shrinks the shared comm once and rebinds every router;
* the fleet in process over ``as_rank`` views of
  ``ompi_tpu_torch.init(device="cpu")``: two pools and two tenants fed in
  waves (the same tokens, prefix hit and miss counts and per-tenant
  histogram families as the reference's fleet over its own world), the
  mixed Poisson driver end to end, histogram isolation, idle retirement
  and a p99-driven re-enlist in the trace ring, bad pools, stage pools,
  stage-aware retirement, the bare-router driver and the demo;
* ``tpurun``: the ``--pool`` psets (``-n 4``), the demo across five
  processes, and the bounded chaos soak (``-n 5``: a worker killed
  mid-load, zero dropped, prefix hits, a p99-driven spawn of
  ``python -m ompi_tpu_torch.serving.worker cpu`` whose rank reports its
  device); the full-length soak is ``slow``, as in the reference.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import ompi_tpu
import ompi_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("jax", "torch")


def _ns(which: str) -> SimpleNamespace:
    root = {"jax": "ompi_tpu", "torch": "ompi_tpu_torch"}[which]

    def mod(name):
        return __import__(f"{root}.{name}", fromlist=["x"])

    return SimpleNamespace(
        root=root, sched=mod("serving.scheduler"),
        fleet=mod("serving.fleet"), serving=mod("serving"),
        worker=mod("serving.worker"), router=mod("serving.router"),
        errors=mod("api.errors"), trace=mod("runtime.trace"),
        reg=mod("base.var").registry, telemetry=mod("runtime.telemetry"),
        rt=mod("runtime.init"), part=mod("mca.part"))


NS = {p: _ns(p) for p in PKGS}
T, J = NS["torch"], NS["jax"]


@pytest.fixture(scope="module", autouse=True)
def _restore_trace_pvars():
    """The drivers' latency histograms register MPI_T pvars that outlive
    the run.  Put both packages' pvar tables and histograms back as the
    module found them."""
    saved = [(ns.reg, dict(ns.reg._pvars)) for ns in (J, T)]
    yield
    for reg, pvars in saved:
        reg._pvars = pvars
    for ns in (J, T):
        ns.trace.reset_for_testing()


def _tpurun(n, argv, extra=(), timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for k in ("OTPU_RANK", "OTPU_NPROCS", "OTPU_COORD"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-n", str(n),
           *extra, sys.executable, *argv]
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, cwd=REPO, env=env)


def _exact_tokens(req) -> bool:
    return req.tokens == [J.worker.toy_token(req.rid, i)
                          for i in range(req.max_new_tokens)]


# ----------------------------------------------------- fair-share admission

def _burst_log(ns) -> list:
    s = ns.sched.ContinuousBatchScheduler(max_batch=2, max_batch_tokens=10000,
                                          tenants={"burst": 3, "light": 1})
    for _ in range(50):
        s.submit(ns.sched.ServeRequest(5, 5, tenant="burst"))
    for _ in range(5):
        s.submit(ns.sched.ServeRequest(5, 5, tenant="light"))
    admitted = []
    for _ in range(200):
        a, _e = s.tick()
        admitted.extend(r.tenant for r in a)
        s.check_invariants()
        for r in s.running():
            s.mark_done(r)
        if not s.depth() and not s.running():
            break
    assert not s.depth() and not s.running()
    return admitted


def test_fair_share_burst_cannot_starve_matches_reference():
    """One tenant floods 50 requests, the other trickles 5: the port
    admits the tenants in the reference's order, the light tenant lands
    in the first round-robin cycles and the 3:1 weights shape the head."""
    admitted = _burst_log(T)
    assert admitted == _burst_log(J)
    assert "light" in admitted[:8], admitted[:8]
    head = admitted[:20]
    assert head.count("burst") == 15 and head.count("light") == 5, head


def _fifo_case(ns) -> tuple:
    s = ns.sched.ContinuousBatchScheduler(max_batch=4, max_batch_tokens=10000,
                                          tenants={"a": 1})
    r1 = s.submit(ns.sched.ServeRequest(4, 4, tenant="a", rid=101))
    r2 = s.submit(ns.sched.ServeRequest(4, 4, tenant="newcomer", rid=102))
    r3 = s.submit(ns.sched.ServeRequest(4, 4, tenant="a", rid=103))
    a, _ = s.tick()
    s.check_invariants()
    assert {r.rid for r in a} == {r1.rid, r2.rid, r3.rid}
    return ([(r.rid, r.tenant) for r in a], s.tenant_depths())


def test_fair_share_per_tenant_fifo_and_dynamic_tenant_matches_reference():
    """A tenant first seen at submit time joins with weight 1; within a
    tenant the admission is FIFO; the order and depths are the
    reference's."""
    got = _fifo_case(T)
    assert got == _fifo_case(J)
    assert got[1] == {"": 0, "a": 0, "newcomer": 0}
    assert [rid for rid, t in got[0] if t == "a"] == [101, 103]


@pytest.mark.parametrize("pkg", PKGS)
def test_fair_share_invariant_trips_on_violation(pkg):
    """The checker detects starvation in a poisoned admission log."""
    ns = NS[pkg]
    s = ns.sched.ContinuousBatchScheduler(max_batch=2, max_batch_tokens=10000,
                                          tenants={"a": 1, "b": 1})
    with s._slock:
        for _ in range(10):     # "a" admitted 10x while b backlogged
            s._admit_log.append(("a", ("b",)))
    with pytest.raises(AssertionError, match="passed over"):
        s.check_invariants()


def test_tenant_weight_must_be_positive_matches_reference():
    got = []
    for ns in (T, J):
        with pytest.raises(ns.errors.MpiError) as ei:
            ns.sched.ContinuousBatchScheduler(tenants={"a": 0})
        got.append((ei.value.error_class.name, str(ei.value)))
    assert got[0] == got[1]


# ------------------------------------------------- autoscaler policy units

class _FakeSched:
    def __init__(self):
        self.queued = 0
        self.running_n = 0

    def stats(self):
        return {"queued": self.queued, "running": self.running_n}

    def depth(self):
        return self.queued


class _FakeRouter:
    def __init__(self, workers):
        self.workers = list(workers)
        self.sched = _FakeSched()
        self.registry = None


class _FakeGroup:
    world_ranks = list(range(64))

    @staticmethod
    def world_rank(r):
        return int(r)


class _FakeComm:
    rte = SimpleNamespace(client=None, my_world_rank=0)
    group = _FakeGroup()


class _FakeFleet:
    """Just enough fleet for FleetAutoscaler: routers, capacity hooks,
    decision log.  ``reserve`` feeds ``enlist``; ``spawnable`` fresh
    ranks feed ``spawn_into`` once the reserve is empty."""

    def __init__(self, reserve=(99,), spawnable=()):
        self.routers = {"a": _FakeRouter([1]), "b": _FakeRouter([2])}
        self.comm = _FakeComm()
        self.me = 0
        self.reserve = list(reserve)
        self.spawnable = list(spawnable)
        self.calls = []
        self.decisions = []

    @property
    def enlisted(self):
        return [p for c, p, _ in self.calls if c == "enlist" and _]

    @property
    def retired(self):
        return [p for c, p, _ in self.calls if c == "retire"]

    def enlist(self, pool):
        rank = self.reserve.pop(0) if self.reserve else None
        if rank is not None:
            self.routers[pool].workers.append(rank)
        self.calls.append(("enlist", pool, rank))
        return rank

    def spawn_into(self, pool, n=1):
        out = [self.spawnable.pop(0)] if self.spawnable else []
        self.routers[pool].workers.extend(out)
        self.calls.append(("spawn", pool, tuple(out)))
        return out

    def retire(self, pool):
        w = self.routers[pool].workers.pop()
        self.reserve.append(w)
        self.calls.append(("retire", pool, w))
        return w

    def note_decision(self, d):
        self.decisions.append(d)


def _policy(pkg, fleet, **kw):
    return NS[pkg].fleet.FleetAutoscaler(fleet, **kw)


def _cooldown_case(pkg) -> tuple:
    fleet = _FakeFleet(reserve=[99, 98])
    a = _policy(pkg, fleet, depth_high=0, patience=1, cooldown=10,
                poll_ticks=1, slo_p99_ms=0.0, watch_stale=False,
                idle_patience=10**9)
    fleet.routers["a"].sched.queued = 5          # only A is deep
    a.step()
    assert fleet.enlisted == ["a"]
    assert a._cooling["a"] == 10, "A must now cool down"
    fleet.routers["a"].sched.queued = 0
    fleet.routers["b"].sched.queued = 5          # B gets deep LATER
    a.step()
    assert fleet.enlisted == ["a", "b"], \
        "pool A's cooldown blocked pool B's needed scale-up"
    fleet.routers["a"].sched.queued = 9          # A, cooling, stays put
    a.step()
    assert fleet.enlisted == ["a", "b"]
    return fleet.calls, fleet.decisions, a.stats()


def test_autoscale_cooldown_is_per_pool():
    """With pool A cooling after its scale-up, pool B's burst still
    scales B, and A does not double-scale: the reference's decisions."""
    assert _cooldown_case("torch") == _cooldown_case("jax")


def _cap_case(pkg) -> tuple:
    fleet = _FakeFleet()
    a = _policy(pkg, fleet, depth_high=0, patience=1, cooldown=0,
                poll_ticks=1, slo_p99_ms=0.0, watch_stale=False,
                idle_patience=10**9, max_workers={"a": 1, "b": 3})
    fleet.routers["a"].sched.queued = 5
    fleet.routers["b"].sched.queued = 5
    a.step()
    assert fleet.enlisted == ["b"], "pool A is at its cap; only B may scale"
    return fleet.calls, fleet.decisions, a.stats()


def test_autoscale_max_workers_cap_is_per_pool():
    assert _cap_case("torch") == _cap_case("jax")


def _idle_case(pkg) -> tuple:
    fleet = _FakeFleet()
    fleet.routers["a"].workers = [1, 5]
    a = _policy(pkg, fleet, depth_high=None, poll_ticks=1, slo_p99_ms=0.0,
                watch_stale=False, idle_patience=3, cooldown=4,
                min_workers=1)
    for _ in range(3):
        a.step()
    assert fleet.retired == ["a"], "idle pool A should drain one rank"
    for _ in range(10):                  # B sits at min_workers
        a.step()
    assert fleet.retired.count("b") == 0
    assert a.stats()["downs"] == 1
    return fleet.calls, fleet.decisions, a.stats()


def test_autoscale_idle_retirement():
    assert _idle_case("torch") == _idle_case("jax")


def _scripted_case(pkg, seed: int, monkeypatch) -> tuple:
    """Every decision over a seeded script: per-pool depths and running
    counts, the router rank's per-pool p99 in its telemetry sample, the
    workers' sample sequence numbers (some stop advancing), and a fake
    clock."""
    ns = NS[pkg]
    now = [100.0]
    monkeypatch.setattr(ns.fleet, "time",
                        SimpleNamespace(monotonic=lambda: now[0]))
    rng = np.random.default_rng(seed)
    fleet = _FakeFleet(reserve=[40, 41], spawnable=[50, 51, 52])
    a = _policy(pkg, fleet, depth_high=2, patience=2, slo_p99_ms=5.0,
                cooldown=3, max_workers={"a": 4, "b": 3}, min_workers=1,
                idle_patience=4, poll_ticks=2, watch_stale=True)
    seqs = {r: 0 for r in range(64)}
    script = iter([])
    a._poll_samples = lambda: next(script)
    log = []
    # four phases: a slow tail (p99 signals up to the caps), idle
    # (retirement into the reserve), stalling samples (stale ranks), then
    # deep queues (depth after its patience)
    phases = [(60, 0.9, 4000.0, 1.0), (70, 0.0, 100.0, 1.0),
              (14, 0.0, 100.0, 0.3), (60, 0.9, 100.0, 1.0)]
    plan = [ph[1:] for ph in phases for _ in range(ph[0])]
    for step, (busy_p, p99_us, advance_p) in enumerate(plan):
        for name, router in fleet.routers.items():
            busy = rng.random() < busy_p
            router.sched.queued = int(rng.integers(0, 7)) if busy else 0
            router.sched.running_n = int(rng.integers(0, 3)) if busy else 0
        live = {0} | {w for r in fleet.routers.values() for w in r.workers}
        samples = {}
        for wr in sorted(live):
            if rng.random() < advance_p:
                seqs[wr] += 1
            samples[wr] = {"seq": seqs[wr], "interval_ms": 50}
        samples[0]["hist"] = {
            ns.router.POOL_HIST_PREFIX + p: {"p99_us": float(v)}
            for p, v in zip("ab", rng.exponential(p99_us, 2))}
        script = iter([samples])
        now[0] += 0.04
        a.step()
        log.append((step, a.stats(), sorted(a._over.items()),
                    sorted(a._idle.items())))
    return fleet.calls, fleet.decisions, log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_autoscale_scripted_signals_match_reference(seed, monkeypatch):
    """The three signals (p99 from the sample, stale ranks, depth with
    patience), the per-pool cooldown and cap, enlist before spawn and idle
    retirement: every capacity call, decision and counter the reference's
    policy makes over the same script."""
    got = _scripted_case("torch", seed, monkeypatch)
    want = _scripted_case("jax", seed, monkeypatch)
    assert got == want
    signals = {d["signal"] for d in got[1]}
    assert {"p99", "stale_rank", "depth", "idle"} <= signals, signals
    assert {c for c, _, _ in got[0]} == {"enlist", "spawn", "retire"}


# ------------------------------------------------------- the one recovery

class _StubRouter:
    def __init__(self, log, name, workers, fail):
        self.log, self.name, self.workers, self.fail = log, name, workers, fail
        self.me = 0

    def tick(self):
        self.log.append(("tick", self.name))
        if self.fail:
            raise self.fail

    def rebind(self, comm, table):
        self.log.append(("rebind", self.name, tuple(table), comm.tag))
        self.workers = list(table)


class _StubComm:
    def __init__(self, log, world_ranks, tag="old"):
        self.log, self.tag = log, tag
        self.rte = SimpleNamespace(client=None)
        self.group = SimpleNamespace(world_ranks=list(world_ranks))

    def revoke(self):
        self.log.append(("revoke", self.tag))

    def shrink(self):
        self.log.append(("shrink", self.tag))
        return _StubComm(self.log, [0, 1, 3, 4, 5], tag="new")

    def set_errhandler(self, eh):
        pass


def _recovery_case(pkg, exc: str) -> list:
    ns = NS[pkg]
    log = []
    fleet = ns.fleet.FleetController.__new__(ns.fleet.FleetController)
    fleet._lock = threading.Lock()
    fleet.comm = _StubComm(log, range(6))
    err = getattr(ns.errors, exc)("worker 2 died")
    fleet.routers = {"m_a": _StubRouter(log, "m_a", [1, 2], err),
                     "m_b": _StubRouter(log, "m_b", [3, 4], None)}
    fleet._pool_world = {"m_a": [1, 2], "m_b": [3, 4]}
    fleet._reserve = [5]
    fleet._publish = False
    fleet.frontdoor = None
    fleet.autoscaler = SimpleNamespace(step=lambda: log.append("step"))
    fleet.tick()
    log.append(("reserve", tuple(fleet._reserve), fleet.comm.tag))
    return log


@pytest.mark.parametrize("exc", ["ProcFailedError", "RevokedError"])
def test_fleet_recovers_once_for_every_pool(exc):
    """A ULFM error from one pool's router: the fleet revokes and shrinks
    the shared comm once (not once a pool), rebinds every router to the
    survivors' table and keeps the live reserve, as the reference does."""
    got = _recovery_case("torch", exc)
    assert got == _recovery_case("jax", exc)
    assert [e[0] for e in got if isinstance(e, tuple)].count("shrink") == 1
    assert ("rebind", "m_a", (1,), "new") in got
    assert ("rebind", "m_b", (2, 3), "new") in got


# ------------------------------------------------------------ in-process env

@pytest.fixture(scope="module")
def world():
    T.rt.reset_for_testing()
    w = ompi_tpu_torch.init(device="cpu")
    T.part.part_framework().open()
    yield w
    T.rt.reset_for_testing()


def _run_workers(workers):
    threads = [threading.Thread(target=wk.serve, daemon=True)
               for wk in workers]
    for t in threads:
        t.start()
    return threads


def _join(threads):
    for t in threads:
        t.join(timeout=10)


_WAVE_LOAD = {
    "ten_a": dict(model="m_a", rate_rps=600, n_requests=16,
                  prompt_lens=(4, 24), decode_lens=(2, 8),
                  prefixes=2, prefix_len=32),
    "ten_b": dict(model="m_b", rate_rps=400, n_requests=12,
                  prompt_lens=(4, 24), decode_lens=(2, 8),
                  prefixes=1, prefix_len=16),
}


def _waves(ns, w) -> tuple:
    """The driver's seeded arrivals fed in waves of four, each drained
    before the next: admission, routing and prefix reuse are then
    independent of thread timing."""
    workers = [ns.serving.ShardWorker(w.as_rank(r), router=0)
               for r in (1, 2, 3, 4)]
    threads = _run_workers(workers)
    fleet = ns.fleet.FleetController(w.as_rank(0), pools=[
        ns.fleet.PoolSpec("m_a", [1, 2], max_batch=4, max_batch_tokens=4096),
        ns.fleet.PoolSpec("m_b", [3, 4], max_batch=4, max_batch_tokens=4096),
    ], tenants={"ten_a": 2, "ten_b": 1})
    events = ns.serving.MixedPoissonDriver(_WAVE_LOAD, seed=7).events
    was = ns.trace.enabled
    ns.reg.set("otpu_trace_enable", True)
    try:
        for name in _WAVE_LOAD:
            ns.trace.hist_reset(ns.router.TENANT_HIST_PREFIX + name)
        order = []
        for i in range(0, len(events), 4):
            for k, (_, tenant, model, plen, dlen, prompt) in enumerate(
                    events[i:i + 4]):
                fleet.submit(tenant, model, prompt_len=plen,
                             max_new_tokens=dlen, prompt=prompt,
                             rid=1000 + i + k)
            done = fleet.serve_until_drained(max_ticks=20000,
                                             check_invariants=True)
            order.append(sorted(q.rid for q in done))
        hists = sorted({k[0] for k, v in ns.trace.hist_snapshot().items()
                        if k[0].startswith(ns.router.TENANT_HIST_PREFIX)
                        and v[0]})
    finally:
        fleet.shutdown()
        _join(threads)
        if not was:
            ns.reg.set("otpu_trace_enable", False)
    st = fleet.stats()
    done = sorted(fleet.completed(), key=lambda q: q.rid)
    return ([(q.rid, q.tenant, q.worker, q.tokens) for q in done],
            {p: (e["prefills"], e["prefix_hits"], e["prefix"]["hits"],
                 e["prefix"]["misses"]) for p, e in st["pools"].items()},
            hists, order)


def test_fleet_two_pools_two_tenants_matches_reference(world):
    """Two pools and two weighted tenants over the same seeded arrivals:
    the port's fleet serves every request on the reference's worker with
    the reference's tokens, counts the same prefix hits and misses and
    keeps the same per-tenant histogram families as the reference's fleet
    over its own device world."""
    J.rt.reset_for_testing()
    jw = ompi_tpu.init()
    if jw.size != 8:
        pytest.skip("needs 8 virtual devices")
    J.part.part_framework().open()
    try:
        want = _waves(J, jw)
    finally:
        J.rt.reset_for_testing()
    got = _waves(T, world)
    assert got == want
    assert all(_exact_tokens(SimpleNamespace(rid=r, tokens=t,
                                             max_new_tokens=len(t)))
               for r, _, _, t in got[0])
    assert len(got[0]) == 28
    assert got[1]["m_a"][1] > 0, "no prefix hit skipped a prefill"
    assert got[2] == ["serve_tenant_ten_a", "serve_tenant_ten_b"]


def test_fleet_two_pools_two_tenants_end_to_end(world):
    """Two model pools + two weighted tenants under mixed Poisson load:
    every token bit-exact, per-tenant percentiles isolated, prefix-cache
    hits measurably skipping prefill."""
    from ompi_tpu_torch.serving import (FleetController, MixedPoissonDriver,
                                        PoolSpec, ShardWorker)

    workers = [ShardWorker(world.as_rank(r), router=0) for r in (1, 2, 3, 4)]
    threads = _run_workers(workers)
    fleet = FleetController(world.as_rank(0), pools=[
        PoolSpec("m_a", [1, 2], max_batch=4, max_batch_tokens=4096),
        PoolSpec("m_b", [3, 4], max_batch=4, max_batch_tokens=4096),
    ], tenants={"ten_a": 2, "ten_b": 1})
    rep = MixedPoissonDriver(_WAVE_LOAD, seed=7).run(
        fleet, max_wall_s=90, check_invariants=True)
    fleet.shutdown()
    _join(threads)
    assert rep["requests"] == 28
    assert all(_exact_tokens(q) for q in fleet.completed())
    for name in ("ten_a", "ten_b"):
        tr = rep["tenants"][name]
        assert tr["requests"] == (16 if name == "ten_a" else 12)
        assert tr["p50_ms"] > 0 and tr["p99_ms"] > 0
        assert tr["p99_ms"] <= tr["p99_exact_ms"] * 2.0 + 1.0
        assert tr["p99_exact_ms"] <= tr["p99_ms"] * 2.0 + 1.0
    assert rep["prefix_hits"] > 0
    assert rep["prefills"] + rep["prefix_hits"] >= 28
    assert rep["prefills"] < 28, \
        "every request prefilled — the cache skipped nothing"
    st = fleet.stats()
    assert st["pools"]["m_a"]["prefix"]["hits"] > 0
    assert st["pools"]["m_a"]["workers"] == 2
    # the fleet's telemetry source publishes the same tables
    entry = T.telemetry._sources.get("fleet")
    assert entry is not None, "the fleet never registered its source"
    import weakref

    fn = entry() if isinstance(entry, weakref.WeakMethod) else entry
    assert set(fn()) == {"pools", "reserve", "decisions", "autoscale"}


def test_fleet_per_tenant_hist_reset_isolation(world):
    """A poisoned pre-run sample in the tenant's family does not leak
    into the run's percentiles."""
    from ompi_tpu_torch.serving import (FleetController, MixedPoissonDriver,
                                        PoolSpec, ShardWorker)

    threads = _run_workers([ShardWorker(world.as_rank(1), router=0)])
    fleet = FleetController(world.as_rank(0), pools=[PoolSpec("m_x", [1])],
                            tenants={"t0": 1})
    T.trace.hist_record(T.router.TENANT_HIST_PREFIX + "t0", 32, int(100e9))
    rep = MixedPoissonDriver({
        "t0": dict(model="m_x", rate_rps=500, n_requests=8,
                   prompt_lens=(4, 8), decode_lens=(2, 4))}, seed=2).run(
        fleet, max_wall_s=60)
    fleet.shutdown()
    _join(threads)
    assert rep["tenants"]["t0"]["p99_ms"] < 50_000, \
        "poisoned pre-run sample leaked into the tenant's percentiles"


def test_fleet_autoscaler_telemetry_decision_in_trace(world):
    """Idle retirement parks a rank in the reserve; a p99-SLO breach read
    from a telemetry sample re-enlists it, and the decision lands in the
    trace ring as a ``fleet_scale`` instant naming the signal."""
    from ompi_tpu_torch.serving import (FleetController, MixedPoissonDriver,
                                        PoolSpec, ShardWorker)

    threads = _run_workers([ShardWorker(world.as_rank(r), router=0)
                            for r in (1, 2, 3)])
    fleet = FleetController(
        world.as_rank(0),
        pools=[PoolSpec("m_a", [1, 2], max_batch=4, max_batch_tokens=4096),
               PoolSpec("m_b", [3], max_batch=4, max_batch_tokens=4096)],
        tenants={"ten_a": 1},
        autoscale=dict(poll_ticks=2, idle_patience=3, cooldown=4,
                       slo_p99_ms=0.0001, min_workers=1, watch_stale=False))
    for _ in range(30):
        fleet.tick()
    assert fleet.stats()["reserve"] >= 1
    assert len(fleet.routers["m_a"].workers) == 1
    was = T.trace.enabled
    if not was:
        T.reg.set("otpu_trace_enable", True)
    try:
        MixedPoissonDriver({
            "ten_a": dict(model="m_a", rate_rps=2000, n_requests=30,
                          prompt_lens=(8, 16), decode_lens=(4, 8))},
            seed=1).run(fleet, max_wall_s=60)
        ups = [d for d in fleet.stats()["decisions"] if d["dir"] == "up"]
        assert any(d["signal"] == "p99" for d in ups), ups
        ring = [e[6] for e in T.trace._ring if e is not None
                and e[1] == "fleet_scale"]
        assert any(d.get("signal") == "p99" and d.get("dir") == "up"
                   for d in ring), "no telemetry-driven decision in the ring"
        assert any(d["dir"] == "down" and d["signal"] == "idle"
                   for d in fleet.stats()["decisions"])
        assert len(fleet.routers["m_a"].workers) == 2, \
            "the reserve rank was not re-enlisted"
    finally:
        fleet.shutdown()
        _join(threads)
        if not was:
            T.reg.set("otpu_trace_enable", False)


def _bad_pools(ns, w) -> list:
    out = []

    def err(fn):
        with pytest.raises(ns.errors.MpiError) as ei:
            fn()
        out.append((ei.value.error_class.name, str(ei.value)))

    F, P = ns.fleet.FleetController, ns.fleet.PoolSpec
    err(lambda: F(w.as_rank(0), pools=[P("a", [1, 2]), P("b", [2, 3])]))
    err(lambda: F(w.as_rank(0), pools=[]))
    err(lambda: P("a", []))
    err(lambda: P("a", [1, 2], prefill=[1]))
    fleet = F(w.as_rank(0), pools=[P("a", [1])])
    err(lambda: fleet.submit("t", "nope", prompt_len=4, max_new_tokens=2))
    return out


def test_fleet_rejects_bad_pools(world):
    """Shared workers, no pool, an empty pool, a half-given stage split
    and an unknown model: the reference's error classes and messages."""
    J.rt.reset_for_testing()
    jw = ompi_tpu.init()
    try:
        want = _bad_pools(J, jw)
    finally:
        J.rt.reset_for_testing()
    got = _bad_pools(T, world)
    assert got == want
    assert [m for _, m in got][0].endswith("with another pool")


def test_fleet_stages_pool_sized_independently(world):
    """One prefill rank feeding two decode ranks: the prefill rank holds a
    slab pairing per decode peer and every token verifies."""
    from ompi_tpu_torch.serving import FleetController, PoolSpec, ShardWorker

    pre = ShardWorker(world.as_rank(1), router=0, role="prefill",
                      peer=[2, 3], slots=4, kv_elems=32)
    dec1 = ShardWorker(world.as_rank(2), router=0, role="decode",
                       peer=1, slots=4, kv_elems=32)
    dec2 = ShardWorker(world.as_rank(3), router=0, role="decode",
                       peer=1, slots=4, kv_elems=32)
    threads = _run_workers([pre, dec1, dec2])
    fleet = FleetController(world.as_rank(0), pools=[
        PoolSpec("m_s", [1, 2, 3], prefill=[1], decode=[2, 3],
                 max_batch=2, max_batch_tokens=4096, slots=4,
                 decode_chunk=2, kv_elems=32)])
    for i in range(8):
        fleet.submit("", "m_s", prompt_len=4 + i, max_new_tokens=3)
    done = fleet.serve_until_drained(max_ticks=5000)
    fleet.shutdown()
    _join(threads)
    assert len(done) == 8
    assert {q.worker for q in done} == {2, 3}, \
        "both decode ranks must take work"
    assert all(_exact_tokens(q) for q in done)


def _retire_case(ns, w) -> list:
    F, P = ns.fleet.FleetController, ns.fleet.PoolSpec
    fleet = F(w.as_rank(0), pools=[P("m_s", [1, 2, 3], prefill=[1],
                                     decode=[2])])
    fleet2 = F(w.as_rank(0), pools=[P("m_t", [4, 5, 6], prefill=[4],
                                      decode=[5, 6])])
    return [fleet.retire("m_s"), fleet.retire("m_s"),
            fleet.routers["m_s"].workers, fleet.stats()["reserve"],
            fleet2.retire("m_t"), fleet2.retire("m_t"),
            fleet2.pool_workers()]


def test_retire_is_stage_aware_matches_reference(world):
    """Colocated extras leave first, the last prefill and decode ranks are
    never taken, a wider decode pool gives its newest rank: the
    reference's choices."""
    J.rt.reset_for_testing()
    jw = ompi_tpu.init()
    try:
        want = _retire_case(J, jw)
    finally:
        J.rt.reset_for_testing()
    got = _retire_case(T, world)
    assert got == want
    assert got[:3] == [3, None, [1, 2]] and got[4:6] == [6, None]


def test_mixed_driver_drives_bare_router(world):
    """The mixed driver's bare-Router mode: same driver, no fleet."""
    from ompi_tpu_torch.serving import MixedPoissonDriver, Router, ShardWorker

    threads = _run_workers([ShardWorker(world.as_rank(7), router=0)])
    router = Router(world.as_rank(0), workers=[7], decode_chunk=4)
    rep = MixedPoissonDriver({
        "solo": dict(model="", rate_rps=500, n_requests=6,
                     prompt_lens=(4, 8), decode_lens=(2, 4))},
        seed=9).run(router, max_wall_s=60)
    router.shutdown()
    _join(threads)
    assert rep["requests"] == 6
    assert rep["tenants"]["solo"]["requests"] == 6
    assert all(_exact_tokens(q) for q in router.completed())


def _demo_ok(stdout: str) -> dict:
    line = next(ln for ln in stdout.splitlines() if "FLEET DEMO OK" in ln)
    return json.loads(line.split("FLEET DEMO OK ", 1)[1])


def test_fleet_demo_in_process():
    """The demo over the device world: 52 requests, prefix hits, the
    world's device reported."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for k in ("OTPU_RANK", "OTPU_NPROCS", "OTPU_COORD"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-m",
                        "ompi_tpu_torch.examples.fleet_demo", "--device",
                        "cpu"], capture_output=True, text=True, timeout=120,
                       cwd=REPO, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    ok = _demo_ok(r.stdout)
    assert ok["requests"] == 52 and ok["prefix_hits"] > 0
    assert ok["device"] == "cpu"
    assert "fleet pools: {'m_a': [1, 2], 'm_b': [3, 4]}" in r.stdout


# ------------------------------------------------------------- multiprocess

def test_tpurun_pool_psets_resolve(tmp_path):
    """--pool publishes mpi://serving/pool/<model> and
    pool_specs_from_psets resolves the tables from it."""
    script = tmp_path / "pools.py"
    script.write_text(textwrap.dedent("""
        import ompi_tpu_torch
        from ompi_tpu_torch.serving import pool_specs_from_psets

        w = ompi_tpu_torch.init(device="cpu")
        specs = {s.name: s.workers for s in pool_specs_from_psets(w)}
        assert specs == {"left": [1], "right": [2, 3]}, specs
        print(f"POOLS OK {w.rank}", flush=True)
    """))
    r = _tpurun(4, [str(script)], extra=("--pool", "left:1",
                                         "--pool", "right:2-3"))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("POOLS OK") == 4


def test_fleet_demo_under_tpurun():
    """The demo across five processes, its pools from the --pool psets."""
    r = _tpurun(5, ["-m", "ompi_tpu_torch.examples.fleet_demo", "--device",
                    "cpu"], extra=("--pool", "m_a:1,2", "--pool", "m_b:3,4"),
                timeout=180)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    ok = _demo_ok(r.stdout)
    assert ok["requests"] == 52 and ok["prefix_hits"] > 0
    assert "fleet pools: {'m_a': [1, 2], 'm_b': [3, 4]}" in r.stdout


_SOAK = """
import json
import sys
import time

import ompi_tpu_torch
from ompi_tpu_torch.base.var import registry
from ompi_tpu_torch.runtime import trace
from ompi_tpu_torch.serving import (FleetController, MixedPoissonDriver,
                                    ShardWorker)
from ompi_tpu_torch.serving.worker import toy_token

N_A, N_B, DEVICE = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
SETTLE_S = 1.0
w = ompi_tpu_torch.init(device=DEVICE)
if w.rank == 0:
    # pools resolve from the tpurun --pool psets (no explicit specs)
    fleet = FleetController(
        w, tenants={"ten_a": 2, "ten_b": 1},
        spawn_argv=[sys.executable, "-m", "ompi_tpu_torch.serving.worker",
                    DEVICE],
        autoscale=dict(poll_ticks=2, depth_high=None, cooldown=25,
                       slo_p99_ms=2.0, max_workers=3,
                       idle_patience=10**9))
    assert fleet.pool_workers() == {"m_a": [1, 2], "m_b": [3, 4]}, \\
        fleet.pool_workers()
    drv = MixedPoissonDriver({
        "ten_a": dict(model="m_a", rate_rps=300, n_requests=N_A,
                      prompt_lens=(4, 16), decode_lens=(4, 10),
                      prefixes=2, prefix_len=32),
        "ten_b": dict(model="m_b", rate_rps=200, n_requests=N_B,
                      prompt_lens=(4, 16), decode_lens=(4, 10),
                      prefixes=1, prefix_len=16),
    }, seed=3)
    registry.set("otpu_trace_enable", True)   # the ring outlives the run
    rep = drv.run(fleet, max_wall_s=150)
    # the control loop outlives the burst, as a deployed fleet's does: the
    # autoscaler reads the router's telemetry sample, which closes up to
    # one sampler interval (50 ms here) after the last completion
    t_end = time.monotonic() + SETTLE_S
    while time.monotonic() < t_end:
        fleet.tick()
        time.sleep(0.001)
    total = N_A + N_B
    # zero dropped: every admitted request completed, bit-exactly
    assert rep["requests"] == total, (rep["requests"], total)
    assert len({q.rid for q in fleet.completed()}) == total
    for q in fleet.completed():
        assert q.tokens == [toy_token(q.rid, i)
                            for i in range(q.max_new_tokens)], q
    assert rep["requeued"] > 0, "victim died, nothing requeued"
    assert rep["prefix_hits"] > 0, rep
    assert rep["prefills"] < total, rep
    # at least one scale-up came from a TELEMETRY sample, reached the
    # trace ring, and a spawned rank came up on the named device
    ring = [e[6] for e in trace._ring if e is not None
            and e[1] == "fleet_scale"]
    ups = [d for d in ring if d.get("dir") == "up"
           and d.get("signal") in ("p99", "stale_rank")]
    assert ups, ring
    spawned = [d["rank"] for d in ups if d.get("how") == "spawn"]
    assert spawned, ups
    devices = [w.rte.modex_get(fleet.comm.group.world_rank(r), "device")
               for r in spawned]
    assert all(d.split(":")[0] == DEVICE for d in devices), devices
    pools = fleet.pool_workers()
    assert any(r in pools[d["pool"]] for d in ups for r in spawned), pools
    st = fleet.stats()
    assert st["autoscale"]["ups"] >= 1
    fleet.shutdown()
    print("SOAK OK " + json.dumps(
        {"requeued": rep["requeued"], "hits": rep["prefix_hits"],
         "prefills": rep["prefills"], "ups": st["autoscale"]["ups"],
         "spawned": spawned, "devices": devices, "pools": pools}),
        flush=True)
else:
    if w.rank == 2:
        from ompi_tpu_torch.ft import chaos
        chaos.install_spec("kill:rank=2,site=serve_work,count=2")
    ShardWorker(w, router=0).serve()
    print(f"WORKER {w.rank} DONE", flush=True)
"""


def _soak(tmp_path, n_a, n_b, timeout):
    script = tmp_path / "fleet_soak.py"
    script.write_text(_SOAK)
    return _tpurun(5, [str(script), str(n_a), str(n_b), "cpu"],
                   extra=("--enable-recovery", "--pool", "m_a:1,2",
                          "--pool", "m_b:3,4",
                          "--mca", "otpu_telemetry_interval_ms", "50"),
                   timeout=timeout)


def test_fleet_chaos_soak_bounded(tmp_path):
    """Mixed two-tenant Poisson load over two --pool pools while a worker
    is chaos-killed mid-load: zero dropped requests, prefix hits, and a
    p99-driven scale-up spawning ``python -m ompi_tpu_torch.serving.worker
    cpu`` into its pool, whose rank reports the device it was named."""
    r = _soak(tmp_path, 24, 16, timeout=240)
    assert "SOAK OK" in r.stdout, r.stdout[-4000:] + r.stderr[-4000:]
    assert "rank 2 killed by schedule" in r.stdout + r.stderr


@pytest.mark.slow
def test_fleet_chaos_soak_full(tmp_path):
    """The full-length soak: same invariants, 4x the load."""
    r = _soak(tmp_path, 96, 64, timeout=480)
    assert "SOAK OK" in r.stdout, r.stdout[-4000:] + r.stderr[-4000:]


# ------------------------------------------ the request trace's fleet soak

_REQ_SOAK = """
import json
import sys

import ompi_tpu_torch

w = ompi_tpu_torch.init(device="cpu")
if w.rank == 0:
    from ompi_tpu_torch.runtime import telemetry
    from ompi_tpu_torch.serving import FleetController, MixedPoissonDriver
    fleet = FleetController(w, tenants={"ten_a": 2, "ten_b": 1})
    drv = MixedPoissonDriver({
        "ten_a": dict(model="m_a", rate_rps=300, n_requests=int(sys.argv[1]),
                      prompt_lens=(4, 16), decode_lens=(4, 10),
                      prefixes=2, prefix_len=16),
        "ten_b": dict(model="m_b", rate_rps=200, n_requests=int(sys.argv[2]),
                      prompt_lens=(4, 16), decode_lens=(4, 10),
                      prefixes=1, prefix_len=16),
    }, seed=7)
    rep = drv.run(fleet, max_wall_s=150)
    slo = telemetry.slo_snapshot()
    fleet.shutdown()
    print("REQSOAK " + json.dumps({"requests": rep["requests"],
                                   "slo": slo}), flush=True)
else:
    if w.rank == 2:
        from ompi_tpu_torch.ft import chaos
        chaos.install_spec("delay:ms=8,rank=2,site=serve_work")
    from ompi_tpu_torch.serving import ShardWorker
    ShardWorker(w, router=0).serve()
ompi_tpu_torch.finalize()
"""

_SLO_MS = 50.0


def test_request_soak_chaos_tail_and_slo(tmp_path):
    """Two pools and two tenants under mixed Poisson load with rank 2 (a
    pool-m_a worker) slowed by 8 ms a micro-batch, every rank tracing
    requests: over the merged timeline, read by the JAX package's
    ``otpu_analyze``, >=95% of the requests decompose into stages that
    reconcile against their own end-to-end time; a router->worker->router
    chain renders; the p99 tail cohort names a stage consistent with the
    slow worker and the tenant routed onto it; and the telemetry plane's
    rolling breach fraction agrees with the exact per-request one within
    the reference's band (25% relative + 0.05 absolute)."""
    from ompi_tpu.tools.otpu_analyze import load_events, requests_report

    script = tmp_path / "req_soak.py"
    script.write_text(_REQ_SOAK)
    td = tmp_path / "traces"
    n_a, n_b = 24, 16
    r = _tpurun(5, [str(script), str(n_a), str(n_b)],
                extra=("--pool", "m_a:1,2", "--pool", "m_b:3,4",
                       "--mca", "otpu_trace_enable", "1",
                       "--mca", "otpu_trace_requests", "1",
                       "--mca", "otpu_trace_dir", str(td),
                       "--mca", "otpu_serving_slo_p99_ms", str(_SLO_MS)),
                timeout=200)
    line = next((ln for ln in r.stdout.splitlines() if "REQSOAK" in ln),
                None)
    assert r.returncode == 0 and line, r.stdout[-4000:] + r.stderr[-4000:]
    soak = json.loads(line.split("REQSOAK ", 1)[1])
    assert soak["requests"] == n_a + n_b

    report = requests_report(load_events([str(td)]), slo_ms=_SLO_MS)
    assert report["requests_seen"] >= 0.95 * (n_a + n_b)
    assert report["decomposed_fraction"] >= 0.95, report
    band = report["stage_over_e2e"]
    assert 0.0 < band["min"] and band["max"] <= 1.25, band
    flows = report["flows"]
    assert flows["chains_complete"] >= 1, flows
    sample = flows["sample"]
    assert sample["hops"][0].startswith("0:r0->") \
        and sample["hops"][-1].endswith("->r0"), sample
    tail = report["tail"]
    assert tail["cohort"] >= 1
    assert tail["dominant_stage"] in ("decode", "queue"), tail
    assert tail["hottest_tenant"] == "ten_a", tail
    if tail["dominant_stage"] == "decode":
        assert tail["bounding_worker"] == 2, tail
    exact = report["slo_exact"]
    assert exact["target_ms"] == _SLO_MS
    slo = soak["slo"]
    assert slo and slo["target_ms"] == _SLO_MS
    tot = breaches = 0
    for tenants in slo["pools"].values():
        for cell in tenants.values():
            tot += cell["run_total"]
            breaches += cell["run_breaches"]
    assert tot >= 0.95 * (n_a + n_b)
    frac_t = breaches / max(1, tot)
    frac_e = exact["breach_fraction"]
    assert abs(frac_t - frac_e) <= 0.05 + 0.25 * frac_e, (
        f"telemetry breach fraction {frac_t:.4f} vs exact "
        f"{frac_e:.4f} — outside the declared band")
