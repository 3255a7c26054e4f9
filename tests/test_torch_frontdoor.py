"""The port's front door and speculative decode
(``ompi_tpu_torch/serving/frontdoor.py``, ``serving/worker.py``) held
against the JAX package's on the CPU.

The same seeded inputs go through both packages, and every comparison is
exact:

* the token bucket's arithmetic under an injected clock: every take's
  answer over a seeded sequence of times;
* the door's decisions over a seeded stream of submissions, pumps and
  scheduler ticks on a virtual clock: admitted or shed, the reason, the
  retry-after hint, the stats, the scheduler's queue and the module hooks
  (``enabled``, ``observe``, ``disarm``);
* preemption on an interactive-p99 breach: the requeued and withdrawn ids,
  the door's queues and stats, and every preempted id drained later;
* speculative decode: the draft's disagreement pattern, the tokens and the
  ``serve_spec_*`` counters, and a ``spec_k`` 0 / 4 A/B through the port's
  engine on one seeded stream whose counters equal the reference worker's
  over the same chunk schedule;
* a door in front of a live port router: overload sheds with honoured
  retry-after hints, a breach preempts running batch work, and every
  request completes with the reference's tokens;
* the fleet with its door armed, in process (sheds re-arrive, every
  request completes, the report splits shed, retried and completed per
  tenant and per SLO class, the ``frontdoor`` source publishes) and under
  ``tpurun -n 3 --enable-recovery --pool m_a:1,2`` (the overload soak with
  a worker chaos-killed mid-load: zero dropped, the interactive p99 held
  within the SLO target while the batch class sheds).
"""
import json
import os
import subprocess
import sys
import threading
import weakref

import numpy as np
import pytest

import ompi_tpu_torch
from ompi_tpu.serving import frontdoor as jfd
from ompi_tpu.serving import scheduler as jsched
from ompi_tpu.serving import worker as jworker
from ompi_tpu.base.var import registry as jreg
from ompi_tpu.runtime import spc as jspc
from ompi_tpu_torch.base.var import registry as treg
from ompi_tpu_torch.runtime import spc as tspc
from ompi_tpu_torch.serving import frontdoor as tfd
from ompi_tpu_torch.serving import scheduler as tsched
from ompi_tpu_torch.serving import worker as tworker

PKGS = ("jax", "torch")
NS = {"jax": (jfd, jsched, jworker, jreg, jspc),
      "torch": (tfd, tsched, tworker, treg, tspc)}


class _Pool:
    """Router stand-in: the door only touches ``.sched``."""

    def __init__(self, sched_mod, **kw):
        kw.setdefault("max_batch", 8)
        kw.setdefault("max_batch_tokens", 65536)
        self.sched = sched_mod.ContinuousBatchScheduler(**kw)


@pytest.fixture(scope="module", autouse=True)
def _restore_trace_pvars():
    """The drivers' latency histograms register MPI_T pvars that outlive
    the run.  Put both packages' pvar tables and histograms back as the
    module found them, so that a later module in the same process reads
    the same pvars from both packages."""
    from ompi_tpu.runtime import trace as jtrace
    from ompi_tpu_torch.runtime import trace as ttrace

    saved = [(reg, dict(reg._pvars)) for reg in (jreg, treg)]
    yield
    for reg, pvars in saved:
        reg._pvars = pvars
    for tr in (jtrace, ttrace):
        tr.reset_for_testing()


def _door(pkg, pools=("m",), **kw):
    fd_mod, sched_mod = NS[pkg][0], NS[pkg][1]
    routers = {p: _Pool(sched_mod) for p in pools}
    kw.setdefault("queue_cap", 4)
    kw.setdefault("rate_rps", 0.0)
    kw.setdefault("backlog", 64)
    clock = kw.pop("clock", None) or (lambda: 0.0)
    return fd_mod.FrontDoor(routers, clock=clock, **kw), routers


# ------------------------------------------------------------ token bucket

def _bucket_log(fd_mod, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(6):
        b = fd_mod.TokenBucket(rate=float(rng.uniform(0.5, 50.0)),
                               burst=float(rng.uniform(0.2, 6.0)),
                               now=float(rng.uniform(0, 2)))
        now = 0.0
        for _ in range(200):
            now += float(rng.exponential(0.05)) * (rng.random() < 0.9)
            out.append(b.try_take(now))
            out.append(b.tokens)
    return out


def test_token_bucket_matches_reference():
    """Refill, the burst cap, the exact deficit wait, clocks that stand
    still or step back: every answer and token count, bit for bit."""
    got = _bucket_log(tfd, 17)
    assert got == _bucket_log(jfd, 17)
    assert any(x > 0 for x in got[::2]) and 0.0 in got[::2]


@pytest.mark.parametrize("pkg", PKGS)
def test_token_bucket_deterministic_refill_math(pkg):
    fd_mod, MpiError = NS[pkg][0], _mpi_error(pkg)
    b = fd_mod.TokenBucket(rate=10.0, burst=2.0, now=0.0)
    assert b.try_take(0.0) == 0.0 and b.try_take(0.0) == 0.0
    assert b.try_take(0.0) == pytest.approx(0.1, abs=1e-12)
    assert b.try_take(0.05) == pytest.approx(0.05, abs=1e-12)
    assert b.try_take(0.05 + 0.1) == 0.0
    b2 = fd_mod.TokenBucket(rate=10.0, burst=2.0, now=0.0)
    for _ in range(2):
        assert b2.try_take(1000.0) == 0.0
    assert b2.try_take(1000.0) > 0.0
    with pytest.raises(MpiError):
        fd_mod.TokenBucket(rate=0.0, burst=1.0)


def _mpi_error(pkg):
    root = {"jax": "ompi_tpu", "torch": "ompi_tpu_torch"}[pkg]
    return __import__(f"{root}.api.errors", fromlist=["x"]).MpiError


# ---------------------------------------------------------- door decisions

def _door_log(pkg, seed: int) -> list:
    """A seeded stream of submissions (three tenants, two classes, two
    pools, a rate-limited tenant), pumps and scheduler ticks on a virtual
    clock: every decision, stats snapshot and queue."""
    fd_mod, spc = NS[pkg][0], NS[pkg][4]
    spc.init()
    rng = np.random.default_rng(seed)
    now = [0.0]
    fd, routers = _door(pkg, pools=("m", "n"), queue_cap=5, backlog=3,
                        retry_s=0.03, rates={"slow": (4.0, 2.0)},
                        clock=lambda: now[0])
    tenants = {"slow": "interactive", "int": "interactive", "bat": "batch"}
    names = sorted(tenants)
    shed0 = spc.read("serve_shed")
    log = [(fd_mod.enabled, fd_mod._active is fd)]
    rid = 0
    try:
        for _ in range(300):
            now[0] += float(rng.exponential(0.02))
            op = rng.random()
            if op < 0.6:
                t = names[int(rng.integers(len(names)))]
                dec = fd.submit(t, ("m", "n")[int(rng.integers(2))],
                                int(rng.integers(1, 30)),
                                int(rng.integers(1, 9)), slo=tenants[t],
                                rid=rid)
                rid += 1
                log.append((dec.admitted, dec.reason, dec.retry_after_s,
                            dec.request.rid if dec.admitted else None))
            elif op < 0.8:
                fd.pump()
                log.append(("pump", fd.depth()))
            else:
                for name, pool in sorted(routers.items()):
                    s = pool.sched
                    admitted, evicted = s.tick()
                    for r in s.running():
                        if rng.random() < 0.5:
                            s.mark_done(r)
                    log.append((name, [r.rid for r in admitted],
                                [r.rid for r in evicted], s.depth()))
            fd.check_invariants()
            log.append(fd.stats())
        log.append(spc.read("serve_shed") - shed0)
    finally:
        fd.close()
    log.append((fd_mod.enabled, fd_mod._active))
    return log


def test_door_decisions_match_reference():
    got = _door_log("torch", 3)
    assert got == _door_log("jax", 3)
    reasons = {e[1] for e in got if isinstance(e, tuple) and len(e) == 4
               and e[0] in (True, False)}
    assert reasons == {"admitted", "rate", "queue"}
    assert got[0] == (True, True) and got[-1] == (False, None)


@pytest.mark.parametrize("pkg", PKGS)
def test_door_binds_one_slo_class_per_tenant(pkg):
    MpiError = _mpi_error(pkg)
    fd, _ = _door(pkg)
    try:
        assert fd.submit("t", "m", 8, 4, slo="batch").admitted
        for args, kw in ((("t", "m", 8, 4), {"slo": "interactive"}),
                         (("u", "m", 8, 4), {"slo": "gold"}),
                         (("u", "nope", 8, 4), {})):
            with pytest.raises(MpiError):
                fd.submit(*args, **kw)
    finally:
        fd.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_door_forwards_interactive_first_below_backlog(pkg):
    fd, routers = _door(pkg, queue_cap=16, backlog=3)
    sched = routers["m"].sched
    try:
        for _ in range(4):
            assert fd.submit("bat", "m", 8, 4, slo="batch").admitted
        for _ in range(4):
            assert fd.submit("int", "m", 8, 4, slo="interactive").admitted
        fd.pump()
        assert sched.depth() == 3 and fd.depth() == 5
        assert all(r.slo == "interactive"
                   for q in sched._tq.values() for r in q)
        fd.check_invariants()
    finally:
        fd.close()


def test_module_hooks_match_reference():
    """observe forwards to the armed door only; a closed old door does not
    disarm its replacement."""
    def run(pkg):
        fd_mod = NS[pkg][0]
        a, _ = _door(pkg)
        b, _ = _door(pkg)
        out = [fd_mod._active is b]
        fd_mod.observe("m", "interactive", 5.0)
        out.append((len(a._lat["m"]), len(b._lat["m"])))
        a.close()
        out.append((fd_mod.enabled, fd_mod._active is b))
        fd_mod.disarm(b)
        out.append((fd_mod.enabled, fd_mod._active))
        fd_mod.observe("m", "interactive", 5.0)
        return out

    assert run("torch") == run("jax") == [True, (0, 1), (True, True),
                                          (False, None)]


# -------------------------------------------------------------- preemption

def _preempt_log(pkg) -> list:
    """The reference's breach scenario: 6 batch and 2 interactive requests
    running, 16 interactive completions far over a 10 ms target."""
    fd_mod, _, _, reg, spc = NS[pkg]
    spc.init()
    reg.set("otpu_serving_slo_p99_ms", 10.0)
    out = []
    try:
        fd, routers = _door(pkg, queue_cap=64, backlog=64, hold_ticks=3,
                            window=16)
        sched = routers["m"].sched
        try:
            bat = [fd.submit("bat", "m", 4, 2, slo="batch", rid=i).request
                   for i in range(6)]
            inter = [fd.submit("int", "m", 4, 2, slo="interactive",
                               rid=10 + i).request for i in range(2)]
            fd.pump()
            sched.tick()
            out.append(sorted(r.rid for r in sched.running()))
            for _ in range(16):
                fd.observe("m", "interactive", 50.0)
            pre0 = spc.read("serve_preempt")
            fd.pump()
            out.append(spc.read("serve_preempt") - pre0)
            out.append(sorted(r.rid for r in sched.running()))
            with fd._lock:
                out.append([r.rid for r in fd._q[("m", "batch")]])
            out.append(fd.stats())
            fd.check_invariants()
            done = []
            for _ in range(200):
                fd.pump()
                sched.tick()
                for r in list(sched.running()):
                    sched.mark_done(r)
                    done.append(r.rid)
                sched.tick()
                sched.check_invariants()
                if not fd.depth() and not sched.depth() \
                        and not sched.running():
                    break
            out.append(done)
            out.append({r.rid for r in bat + inter} <= set(done))
            out.append(fd.stats())
        finally:
            fd.close()
    finally:
        reg.set("otpu_serving_slo_p99_ms", 0.0)
    return out


def test_preemption_requeues_batch_never_drops():
    """A breach requeues the RUNNING batch work, withdraws it behind the
    door in arrival order, holds batch forwarding, counts serve_preempt;
    every preempted id drains later.  The same ids and stats as the
    reference's."""
    got = _preempt_log("torch")
    assert got == _preempt_log("jax")
    assert got[0] == [0, 1, 2, 3, 4, 5, 10, 11]
    assert got[1] == 6 and got[2] == [10, 11]
    assert got[3] == [0, 1, 2, 3, 4, 5]
    assert got[4]["preempts"] == 6 and got[4]["breaches"] == 1
    assert got[4]["holds"] == {"m": 3}
    assert got[6] is True


@pytest.mark.parametrize("pkg", PKGS)
def test_preemption_needs_a_real_window(pkg):
    reg = NS[pkg][3]
    fd, _ = _door(pkg, window=16)
    try:
        for _ in range(32):
            fd.observe("m", "interactive", 1e6)
        fd.pump()
        assert fd.stats()["breaches"] == 0        # no target set
    finally:
        fd.close()
    reg.set("otpu_serving_slo_p99_ms", 10.0)
    try:
        fd, _ = _door(pkg, window=16)
        try:
            for _ in range(8):
                fd.observe("m", "interactive", 1e6)
            for _ in range(32):
                fd.observe("m", "batch", 1e6)
            fd.pump()
            assert fd.stats()["breaches"] == 0
        finally:
            fd.close()
    finally:
        reg.set("otpu_serving_slo_p99_ms", 0.0)


# ------------------------------------------------------- speculative decode

def test_toy_draft_disagreement_pattern():
    for rid in (0, 7, 123):
        mismatches = [t for t in range(64)
                      if tworker.toy_draft_token(rid, t)
                      != tworker.toy_token(rid, t)]
        assert mismatches == [t for t in range(64) if (rid + t) % 8 == 5]
        assert all(tworker.toy_draft_token(rid, t)
                   == jworker.toy_draft_token(rid, t) for t in range(64))
    assert tworker._VOCAB == jworker._VOCAB


def _bare_worker(wmod, spec_k, rids=(7,), elems=64):
    w = wmod.ShardWorker.__new__(wmod.ShardWorker)
    w._kv = {rid: np.ones(elems, np.float32) for rid in rids}
    w.spec_k = spec_k
    return w


def _spec_log(pkg) -> list:
    _, _, wmod, _, spc = NS[pkg]
    spc.init()
    out = []
    for k in (0, 1, 3, 4, 8):
        a0 = spc.read("serve_spec_accepts")
        r0 = spc.read("serve_spec_rejects")
        w = _bare_worker(wmod, k, rids=(7, 8, 13))
        toks = [w._decode(rid, t0, n) for rid in (7, 8, 13)
                for t0, n in ((0, 16), (16, 3), (19, 4))]
        out.append((k, toks, spc.read("serve_spec_accepts") - a0,
                    spc.read("serve_spec_rejects") - r0))
    return out


def test_speculative_decode_matches_reference():
    """Tokens and the accept/reject counters for windows 0, 1, 3, 4 and 8
    over three requests in uneven chunks: the reference's, and every
    window's tokens equal the plain decode's."""
    got = _spec_log("torch")
    assert got == _spec_log("jax")
    plain = got[0][1]
    assert all(toks == plain for _, toks, _, _ in got)
    assert got[0][2:] == (0, 0)
    # the reference's pinned ledger for rid 7, 16 tokens, k=4: 12 and 5
    w = _bare_worker(tworker, 4)
    a0, r0 = tspc.read("serve_spec_accepts"), tspc.read("serve_spec_rejects")
    w._decode(7, 0, 16)
    assert (tspc.read("serve_spec_accepts") - a0,
            tspc.read("serve_spec_rejects") - r0) == (12, 5)


@pytest.fixture(scope="module")
def world():
    from ompi_tpu_torch.mca.part import part_framework
    from ompi_tpu_torch.runtime import init as rt

    rt.reset_for_testing()
    w = ompi_tpu_torch.init(device="cpu")
    part_framework().open()
    yield w
    rt.reset_for_testing()


def _serve(workers):
    threads = [threading.Thread(target=wk.serve, daemon=True)
               for wk in workers]
    for t in threads:
        t.start()
    return threads


def _join(threads):
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads), "a serve loop hung"


def _expected_spec(reqs, chunk: int, k: int) -> tuple:
    """The reference worker's accept/reject counts over the router's chunk
    schedule of ``reqs``."""
    jspc.init()
    a0, r0 = jspc.read("serve_spec_accepts"), jspc.read("serve_spec_rejects")
    w = _bare_worker(jworker, k, rids=[q.rid for q in reqs])
    for q in reqs:
        for t0 in range(0, q.max_new_tokens, chunk):
            w._decode(q.rid, t0, min(chunk, q.max_new_tokens - t0))
    return (jspc.read("serve_spec_accepts") - a0,
            jspc.read("serve_spec_rejects") - r0)


@pytest.mark.parametrize("stages", [False, True], ids=["colocated",
                                                       "staged"])
def test_speculative_ab_end_to_end(world, stages):
    """spec_k 0 then 4 on one seeded stream through the port's engine: the
    same tokens (the reference's), and the A run's counters equal the
    reference worker's over the same chunk schedule."""
    from ompi_tpu_torch.serving import (ContinuousBatchScheduler,
                                        PoissonDriver, Router, ShardWorker)

    runs = {}
    for k in (0, 4):
        if stages:
            ws = [ShardWorker(world.as_rank(1), router=0, role="prefill",
                              peer=2, slots=4, kv_elems=32),
                  ShardWorker(world.as_rank(2), router=0, role="decode",
                              peer=1, slots=4, kv_elems=32, spec_k=k)]
            kw = dict(prefill_ranks=[1], decode_ranks=[2])
        else:
            ws = [ShardWorker(world.as_rank(1), router=0, spec_k=k)]
            kw = {}
        threads = _serve(ws)
        r = Router(world.as_rank(0),
                   scheduler=ContinuousBatchScheduler(max_batch=4,
                                                      max_batch_tokens=4096,
                                                      slots=4),
                   workers=[w.comm.rank for w in ws], decode_chunk=4,
                   kv_elems=32, **kw)
        a0 = tspc.read("serve_spec_accepts")
        r0 = tspc.read("serve_spec_rejects")
        rep = PoissonDriver(rate_rps=400, n_requests=10,
                            decode_lens=(4, 14), seed=21).run(
            r, max_wall_s=90)
        r.shutdown()
        _join(threads)
        done = sorted(r.completed(), key=lambda q: q.arrival_ns)
        runs[k] = ([q.tokens for q in done],
                   [(q.prompt_len, q.max_new_tokens) for q in done],
                   (tspc.read("serve_spec_accepts") - a0,
                    tspc.read("serve_spec_rejects") - r0), done)
        assert rep["requests"] == 10
        for q in done:
            assert q.tokens == [jworker.toy_token(q.rid, i)
                                for i in range(q.max_new_tokens)]
    assert runs[0][1] == runs[4][1]
    assert runs[0][2] == (0, 0)
    assert runs[4][2] == _expected_spec(runs[4][3], 4, 4)
    assert runs[4][2][0] > 0 and runs[4][2][1] > 0


# ------------------------------------------------ a door before a live router

def test_door_before_live_router(world):
    """Sheds re-arrive after their hint on a virtual clock, a breach
    preempts running batch work through the router's completion feed, and
    every request completes once, with the reference's tokens."""
    from ompi_tpu_torch.runtime import telemetry
    from ompi_tpu_torch.serving import (ContinuousBatchScheduler, FrontDoor,
                                        Router, ShardWorker)

    threads = _serve([ShardWorker(world.as_rank(r), router=0)
                      for r in (1, 2)])
    router = Router(world.as_rank(0),
                    scheduler=ContinuousBatchScheduler(
                        max_batch=4, max_batch_tokens=4096,
                        tenants={"int": 2, "bat": 1}),
                    workers=[1, 2], decode_chunk=2, pool="m")
    now = [0.0]
    treg.set("otpu_serving_slo_p99_ms", 1e-6)
    fd = FrontDoor({"m": router}, queue_cap=3, backlog=2, retry_s=0.01,
                   hold_ticks=2, window=16, clock=lambda: now[0])
    pre0 = tspc.read("serve_preempt")
    try:
        assert telemetry._sources.get("frontdoor") is not None
        rng = np.random.default_rng(4)
        arrivals = sorted(
            [(float(t), "int", "interactive") for t in
             np.cumsum(rng.exponential(0.0005, 30))] +
            [(float(t), "bat", "batch") for t in
             np.cumsum(rng.exponential(0.001, 12))])
        pending, shed, ticks = list(arrivals), 0, 0
        while pending or fd.depth() or router.sched.depth() \
                or router.sched.running():
            due = [a for a in pending if a[0] <= now[0]]
            pending = [a for a in pending if a[0] > now[0]]
            for at, tenant, cls in due:
                dec = fd.submit(tenant, "m", 6, 6, slo=cls)
                if not dec.admitted:
                    shed += 1
                    pending.append((now[0] + dec.retry_after_s, tenant,
                                    cls))
            fd.pump()
            router.tick()
            router.sched.check_invariants()
            fd.check_invariants()
            now[0] += 0.002
            ticks += 1
            assert ticks < 20000, "the door and router never drained"
        st = fd.stats()
    finally:
        fd.close()
        treg.set("otpu_serving_slo_p99_ms", 0.0)
        router.shutdown()
        _join(threads)
    done = router.completed()
    assert len(done) == 42 and len({q.rid for q in done}) == 42
    assert shed > 0 and st["shed"] == shed
    assert st["breaches"] > 0
    assert tspc.read("serve_preempt") - pre0 == st["preempts"]
    assert {q.slo for q in done} == {"interactive", "batch"}
    for q in done:
        assert q.tokens == [jworker.toy_token(q.rid, i)
                            for i in range(q.max_new_tokens)]


# ------------------------------------------------ the fleet's armed door

def test_fleet_frontdoor_escalation_in_process(world):
    """Fleet + armed door end to end: overload sheds with retry-after (the
    driver re-arrives them), every request still completes with the
    reference's tokens, the report splits shed/retried/completed per
    tenant AND per SLO class, and the frontdoor telemetry source
    publishes."""
    from ompi_tpu_torch.runtime import telemetry
    from ompi_tpu_torch.serving import (FleetController, MixedPoissonDriver,
                                        PoolSpec, ShardWorker)

    threads = _serve([ShardWorker(world.as_rank(r), router=0)
                      for r in (1, 2)])
    fleet = FleetController(
        world.as_rank(0),
        pools=[PoolSpec("m_a", [1, 2], max_batch=4, max_batch_tokens=4096)],
        tenants={"int": 2, "bat": 1},
        frontdoor=dict(queue_cap=4, backlog=2, retry_s=0.02))
    assert fleet.frontdoor is not None
    drv = MixedPoissonDriver({
        "int": dict(model="m_a", rate_rps=800, n_requests=12,
                    prompt_lens=(4, 8), decode_lens=(2, 4),
                    slo="interactive"),
        "bat": dict(model="m_a", rate_rps=800, n_requests=10,
                    prompt_lens=(4, 8), decode_lens=(2, 4), slo="batch"),
    }, seed=11)
    rep = drv.run(fleet, max_wall_s=90, check_invariants=True)
    door_stats = fleet.frontdoor.stats()
    fleet.shutdown()
    _join(threads)
    assert rep["requests"] == 22
    for req in fleet.completed():
        assert req.tokens == [jworker.toy_token(req.rid, i)
                              for i in range(req.max_new_tokens)]
    assert rep["shed"] > 0 and rep["retried"] >= rep["shed"]
    for name in ("int", "bat"):
        tr = rep["tenants"][name]
        assert tr["retried"] >= tr["shed"]
    cls = rep["slo_classes"]
    assert cls["interactive"]["requests"] == 12
    assert cls["batch"]["requests"] == 10
    assert cls["interactive"]["shed"] + cls["batch"]["shed"] == rep["shed"]
    assert door_stats["shed"] == rep["shed"]
    entry = telemetry._sources.get("frontdoor")
    assert entry is not None, "frontdoor never registered its source"
    fn = entry() if isinstance(entry, weakref.WeakMethod) else entry
    assert isinstance(fn(), dict)


_OVERLOAD_SOAK = """
import json

import ompi_tpu_torch
from ompi_tpu_torch.base.var import registry
from ompi_tpu_torch.runtime import spc
from ompi_tpu_torch.serving import (FleetController, MixedPoissonDriver,
                                    ShardWorker)
from ompi_tpu_torch.serving.worker import toy_token

w = ompi_tpu_torch.init(device="cpu")
if w.rank == 0:
    registry.set("otpu_serving_slo_p99_ms", 800.0)
    fleet = FleetController(
        w, tenants={"int": 2, "bat": 1},
        autoscale=dict(poll_ticks=10**9, idle_patience=10**9),
        frontdoor=dict(queue_cap=6, backlog=3, retry_s=0.01,
                       hold_ticks=20, window=16))
    drv = MixedPoissonDriver({
        "int": dict(model="m_a", rate_rps=150, n_requests=28,
                    prompt_lens=(4, 8), decode_lens=(2, 4),
                    slo="interactive"),
        "bat": dict(model="m_a", rate_rps=400, n_requests=36,
                    prompt_lens=(4, 8), decode_lens=(6, 12),
                    slo="batch"),
    }, seed=13)
    rep = drv.run(fleet, max_wall_s=180, check_invariants=True)
    total = 28 + 36
    assert rep["requests"] == total, (rep["requests"], total)
    assert len({q.rid for q in fleet.completed()}) == total
    for q in fleet.completed():
        assert q.tokens == [toy_token(q.rid, i)
                            for i in range(q.max_new_tokens)], q
    assert rep["requeued"] > 0, "victim died, nothing requeued"
    assert rep["shed"] > 0, rep
    assert rep["retried"] >= rep["shed"], rep
    assert spc.read("serve_shed") == rep["shed"], \\
        (spc.read("serve_shed"), rep["shed"])
    cls = rep["slo_classes"]
    assert cls["interactive"]["p99_exact_ms"] <= 800.0, cls
    assert cls["batch"]["p99_exact_ms"] >= \\
        cls["interactive"]["p99_exact_ms"], cls
    assert cls["batch"]["shed"] > 0, cls
    st = fleet.frontdoor.stats()
    assert st["shed"] == rep["shed"]
    fleet.shutdown()
    print("OVERLOAD OK " + json.dumps(
        {"shed": rep["shed"], "retried": rep["retried"],
         "preempts": st["preempts"],
         "int_p99": cls["interactive"]["p99_exact_ms"],
         "bat_p99": cls["batch"]["p99_exact_ms"],
         "requeued": rep["requeued"]}), flush=True)
else:
    if w.rank == 2:
        from ompi_tpu_torch.ft import chaos
        chaos.install_spec("kill:rank=2,site=serve_work,count=1")
    ShardWorker(w, router=0).serve()
    print(f"WORKER {w.rank} DONE", flush=True)
"""


def test_frontdoor_overload_soak_chaos_armed(tmp_path):
    """Sustained overload across both SLO classes through the fleet's armed
    door, a worker chaos-killed mid-load: the interactive p99 held within
    the SLO target, the batch class degraded and shed with honoured
    retry-after, zero dropped requests."""
    script = tmp_path / "overload_soak.py"
    script.write_text(_OVERLOAD_SOAK)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for k in ("OTPU_RANK", "OTPU_NPROCS", "OTPU_COORD"):
        env.pop(k, None)
    r = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-n", "3",
         "--enable-recovery", "--pool", "m_a:1,2", sys.executable,
         str(script)], capture_output=True, text=True, timeout=240,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env)
    line = next((ln for ln in r.stdout.splitlines() if "OVERLOAD OK" in ln),
                None)
    assert line, r.stdout[-4000:] + r.stderr[-4000:]
    got = json.loads(line.split("OVERLOAD OK ", 1)[1])
    assert got["shed"] > 0 and got["requeued"] > 0
