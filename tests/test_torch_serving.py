"""The port's serving engine (``ompi_tpu_torch/serving``: the scheduler, the
KV stream, the shard worker, the router and the drivers, with coll/quant's
``kv_codec`` and tpurun's role flags) held against the JAX package's
``ompi_tpu.serving`` on the CPU.

The same seeded inputs go through both packages.  Every comparison here is
exact: the engine is host integer and numpy arithmetic in both packages.

* the scheduler: the admitted and evicted request ids, slots and token
  budget of every tick of a seeded stream (single queue and weighted
  round-robin across tenants), ``requeue`` and ``withdraw``, the error
  classes;
* the toy model (``toy_kv``, ``toy_token``, ``toy_draft_token``) and the
  drivers' seeded draws (arrivals, prompt and decode lengths);
* the KV slab's slot bytes for the raw, ``int8`` and ``bf16`` slabs: the
  port's sender slab, what its receiver lands over ``mca/part`` and the
  block it decodes, against the reference sender's slab and decode;
* the engines end to end over ``as_rank`` views of
  ``ompi_tpu_torch.init(device="cpu")``: colocated, staged with the
  receiver partitioned twice as finely as the sender (each codec), two
  pairs on staggered epochs and an odd worker; every token equal to the
  reference's ``toy_token``, every streamed block verified by the decode
  stage; the histogram p99 within the reference's factor-2 band of the
  exact p99;
* the fleet's hooks in the engine: a fleet-owned router's re-raise against
  the reference's, and the mixed driver over two pool routers;
* the request trace: the port's ``serve_req`` spans and flows through the
  reference's ``otpu_analyze.requests_report``;
* ``tpurun``: a worker killed mid-load under ``--enable-recovery`` (zero
  dropped, the dead worker's requests requeued), the role flags, the
  serving demo with and without them, and (slow, as in the reference) the
  autoscale through ``dpm.spawn`` of the port's worker and the Poisson
  soak.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu.tools.otpu_analyze import REQ_STAGES, requests_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("jax", "torch")
CODECS = ("", "int8", "bf16")


@pytest.fixture(scope="module", autouse=True)
def _restore_trace_pvars():
    """The drivers' latency histograms register MPI_T pvars that outlive
    the run.  Put both packages' pvar tables and histograms back as the
    module found them, so that a later module in the same process reads
    the same pvars from both packages."""
    from ompi_tpu.base.var import registry as jvars
    from ompi_tpu.runtime import trace as jtrace
    from ompi_tpu_torch.base.var import registry as tvars
    from ompi_tpu_torch.runtime import trace as ttrace

    saved = [(reg, dict(reg._pvars)) for reg in (jvars, tvars)]
    yield
    for reg, pvars in saved:
        reg._pvars = pvars
    for tr in (jtrace, ttrace):
        tr.reset_for_testing()


def _ns(which: str) -> SimpleNamespace:
    root = {"jax": "ompi_tpu", "torch": "ompi_tpu_torch"}[which]

    def mod(name):
        return __import__(f"{root}.{name}", fromlist=["x"])

    return SimpleNamespace(
        sched=mod("serving.scheduler"), kv=mod("serving.kv_stream"),
        worker=mod("serving.worker"), driver=mod("serving.driver"),
        quant=mod("mca.coll.quant"), errors=mod("api.errors"),
        spc=mod("runtime.spc"), serving=mod("serving"))


NS = {p: _ns(p) for p in PKGS}
T = NS["torch"]
J = NS["jax"]


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


# ---------------------------------------------------------------- scheduler

def _fuzz_log(ns, seed: int, tenants=None) -> list:
    """Every tick's (admitted, evicted, running slots, used tokens) of a
    seeded submit / tick / finish stream, with explicit request ids."""
    rng = np.random.default_rng(seed)
    s = ns.sched.ContinuousBatchScheduler(max_batch=4, max_batch_tokens=256,
                                          slots=6, tenants=tenants)
    names = sorted(tenants or {"": 1})
    log, rid = [], 0
    for _ in range(300):
        if rng.random() < 0.5:
            s.submit(ns.sched.ServeRequest(
                int(rng.integers(1, 60)), int(rng.integers(1, 60)), rid=rid,
                tenant=names[int(rng.integers(len(names)))]))
            rid += 1
        admitted, evicted = s.tick()
        s.check_invariants()
        running = s.running()
        log.append(([r.rid for r in admitted], [r.rid for r in evicted],
                    sorted((r.rid, r.slot) for r in running),
                    s.used_tokens()))
        if running and rng.random() < 0.6:
            s.mark_done(running[int(rng.integers(len(running)))])
    for _ in range(600):
        for r in s.running():
            s.mark_done(r)
        admitted, evicted = s.tick()
        s.check_invariants()
        log.append(([r.rid for r in admitted], [r.rid for r in evicted]))
        if not s.running() and not s.depth():
            break
    assert not s.running() and not s.depth()
    return log


@pytest.mark.parametrize("tenants", [None, {"a": 3, "b": 1, "c": 2}],
                         ids=["fifo", "weighted"])
def test_scheduler_ticks_match_reference(tenants):
    """The admission order, evictions, slots and token budget of every
    tick of a seeded stream: bit for bit the reference's."""
    got = _fuzz_log(T, 7, tenants)
    assert got == _fuzz_log(J, 7, tenants)
    assert sum(len(t[0]) for t in got) > 50


@pytest.mark.parametrize("pkg", PKGS)
def test_scheduler_fifo_admission_no_starvation(pkg):
    ns = NS[pkg]
    s = ns.sched.ContinuousBatchScheduler(max_batch=2, max_batch_tokens=100)
    reqs = [s.submit(ns.sched.ServeRequest(10, 10)) for _ in range(8)]
    order = []
    for _ in range(40):
        admitted, _ = s.tick()
        order.extend(r.rid for r in admitted)
        s.check_invariants()
        for r in s.running():
            s.mark_done(r)
        if s.done_count() == len(reqs):
            break
    assert s.done_count() == len(reqs), "a request starved"
    assert order == [r.rid for r in reqs], "admission broke arrival order"


def test_scheduler_errors_match_reference():
    def errors(ns):
        out = []
        s = ns.sched.ContinuousBatchScheduler(max_batch=2,
                                              max_batch_tokens=64)
        for fn in (lambda: s.submit(ns.sched.ServeRequest(60, 10)),
                   lambda: ns.sched.ServeRequest(0, 4),
                   lambda: ns.sched.ContinuousBatchScheduler(max_batch=4,
                                                             slots=2),
                   lambda: ns.sched.ContinuousBatchScheduler(
                       tenants={"t": 0})):
            with pytest.raises(ns.errors.MpiError) as ei:
                fn()
            out.append(ei.value.error_class.name)
        return out

    assert errors(T) == errors(J) == ["ERR_ARG"] * 4


@pytest.mark.parametrize("pkg", PKGS)
def test_scheduler_eviction_without_drain(pkg):
    ns = NS[pkg]
    s = ns.sched.ContinuousBatchScheduler(max_batch=2, max_batch_tokens=1000)
    long_req = s.submit(ns.sched.ServeRequest(10, 100))
    short1 = s.submit(ns.sched.ServeRequest(10, 1))
    short2 = s.submit(ns.sched.ServeRequest(10, 1))
    s.tick()
    assert short2.state is ns.sched.RequestState.QUEUED
    s.mark_done(short1)
    admitted, evicted = s.tick()
    assert evicted == [short1] and admitted == [short2]
    assert long_req.state is ns.sched.RequestState.RUNNING
    s.check_invariants()


def test_scheduler_requeue_and_withdraw_match_reference():
    """requeue skips a finished request and puts the rest back at the head
    in arrival order; withdraw pulls one SLO class out of every tenant
    queue — the same ids, states and queues in both packages."""
    def run(ns):
        s = ns.sched.ContinuousBatchScheduler(max_batch=4,
                                              max_batch_tokens=1000)
        reqs = [s.submit(ns.sched.ServeRequest(
            5, 5, rid=i, tenant="ab"[i % 2],
            slo=("batch", "interactive")[i % 3 == 0])) for i in range(9)]
        s.tick()
        s.mark_done(reqs[0])
        s.requeue(s.running())
        out = [[r.rid for r in s._tq[t]] for t in ("", "a", "b")]
        out.append([(r.rid, r.state.value, r.slot, r.prefilled)
                    for r in reqs])
        out.append([r.rid for r in s.withdraw("batch")])
        out.append([[r.rid for r in s._tq[t]] for t in ("a", "b")])
        s.tick()
        s.check_invariants()
        out.append(sorted(r.rid for r in s.running()))
        out.append(s.stats())
        return out

    got = run(T)
    assert got == run(J)
    # the finished request stays out; the requeued ones head their queues
    assert got[3][0] == (0, "done", 0, False)
    assert got[1][:2] == [2, 4] and got[2][:2] == [1, 3]


def test_toy_model_matches_reference():
    rids = list(range(0, 2000, 37)) + [10 ** 9 + 7]
    for rid in rids:
        np.testing.assert_array_equal(T.worker.toy_kv(rid, 300),
                                      J.worker.toy_kv(rid, 300))
        for t in range(40):
            assert T.worker.toy_token(rid, t) == J.worker.toy_token(rid, t)
            assert (T.worker.toy_draft_token(rid, t)
                    == J.worker.toy_draft_token(rid, t))
    assert (T.worker.TAG_CMD, T.worker.TAG_RES, T.worker.TAG_KV) == \
        (J.worker.TAG_CMD, J.worker.TAG_RES, J.worker.TAG_KV)


def test_driver_draws_match_reference():
    """The seeded arrival processes: the same arrivals, prompts, decodes
    and (mixed) tenant events in both packages."""
    a = T.driver.PoissonDriver(rate_rps=300, n_requests=64, seed=11)
    b = J.driver.PoissonDriver(rate_rps=300, n_requests=64, seed=11)
    assert a.arrivals_s.tobytes() == b.arrivals_s.tobytes()
    assert a.prompts.tolist() == b.prompts.tolist()
    assert a.decodes.tolist() == b.decodes.tolist()
    assert a.due(0.05) == b.due(0.05) and a.due(1e9) == b.due(1e9)
    conf = {"t1": dict(rate_rps=300, n_requests=12, prefixes=2,
                       prefix_len=8),
            "t2": dict(rate_rps=100, n_requests=5, slo="batch")}
    m, n = (ns.driver.MixedPoissonDriver(conf, seed=5) for ns in (T, J))
    assert m.events == n.events and m.tenants == n.tenants


def test_slo_target_var_matches_reference():
    """``otpu_serving_slo_p99_ms`` is registered by ``serving/fleet.py`` in
    both packages, with the reference's default, type and help, and the
    package exports the reference's names."""
    import inspect

    from ompi_tpu.base.var import registry as jreg
    from ompi_tpu_torch.base.var import registry as treg
    from ompi_tpu_torch.serving import fleet

    tv = treg.lookup("otpu_serving_slo_p99_ms")
    jv = jreg.lookup("otpu_serving_slo_p99_ms")
    assert (tv.default, tv.vtype.name, tv.help) == \
        (jv.default, jv.vtype.name, jv.help)
    assert fleet._slo_var is tv
    assert "slo_p99_ms" not in inspect.getsource(T.serving)
    assert T.serving.__all__ == J.serving.__all__
    assert all(hasattr(T.serving, name) for name in T.serving.__all__)


def test_worker_main_takes_its_device(monkeypatch):
    """An autoscaled worker binds its world to the device named by its
    first argument (the card when none is named), where the reference's
    ``init`` takes none; outside a spawn it exits as the reference's
    does."""
    seen = []
    monkeypatch.setattr(ompi_tpu_torch, "init",
                        lambda device=None: seen.append(device))
    monkeypatch.setattr(ompi_tpu_torch, "get_parent", lambda: None)
    for argv, want in ((["cpu"], "cpu"), ([], None)):
        with pytest.raises(SystemExit) as ei:
            T.worker.worker_main(argv)
        assert "not a spawned process" in str(ei.value)
        assert seen.pop() == want


# ---------------------------------------------------------------- KV slabs

class _StubComm:
    """Stands in for a comm where only the slab's bytes are compared."""

    def psend_init(self, buf, partitions, dest, tag):
        return SimpleNamespace(buf=buf)

    precv_init = psend_init


def _kv_blocks(elems: int) -> list:
    rng = np.random.default_rng(23)
    return [
        (rng.standard_normal(elems) * 3.0).astype(np.float32),
        np.zeros(elems, np.float32),
        (rng.standard_normal(elems - 77) * 1e30).astype(np.float32),  # pad
        (rng.standard_normal(elems + 50) * 1e-30).astype(np.float32),  # trim
        J.worker.toy_kv(41, elems),
    ]


@pytest.fixture(scope="module")
def world():
    from ompi_tpu_torch.mca.part import part_framework
    from ompi_tpu_torch.runtime import init as rt

    rt.reset_for_testing()
    w = ompi_tpu_torch.init(device="cpu")
    part_framework().open()
    yield w
    rt.reset_for_testing()


@pytest.mark.parametrize("codec", CODECS, ids=["raw", "int8", "bf16"])
def test_kv_slot_bytes_match_reference(world, codec):
    """Each slot's bytes: the port's sender slab equals the reference
    sender's, the port's receiver lands the same bytes over mca/part
    (receiver partitions twice the slots), and the decoded block equals
    the reference's decode of them.  Exact."""
    from ompi_tpu_torch.runtime.progress import progress

    elems, blocks = 300, _kv_blocks(300)
    slots = len(blocks)
    ref = J.kv.KvSlabSender(_StubComm(), 1, slots, elems, 0, codec=codec)
    snd = T.kv.KvSlabSender(world.as_rank(0), 1, slots, elems, 94,
                            codec=codec)
    rcv = T.kv.KvSlabReceiver(world.as_rank(1), 0, slots, elems, 94,
                              partitions=2 * slots, codec=codec)
    try:
        assert (snd.slot_nbytes, snd.slab.dtype, snd.slab.shape,
                snd.capacity_multiplier) == \
            (ref.slot_nbytes, ref.slab.dtype, ref.slab.shape,
             ref.capacity_multiplier)
        snd.begin_epoch(0)
        rcv.begin_epoch(0)
        for s, kv in enumerate(blocks):
            ref.write_slot(s, kv)
            snd.write_slot(s, kv)
            assert snd.slab[s].tobytes() == ref.slab[s].tobytes(), s
        snd.slot_ready(3)
        for _ in range(400):
            if rcv.slot_arrived(3):
                break
            progress()
        # a readied slot lands before the epoch's tail flush
        assert rcv.slot_arrived(3) and not rcv.slot_arrived(0)
        snd.finish_epoch(wait=True)
        rcv.finish_epoch()
        assert rcv.slab.tobytes() == ref.slab.tobytes()
        for s in range(slots):
            got = rcv.read_slot(s)
            if codec:
                want = J.quant.decode_f32(ref.slab[s], codec, elems,
                                          J.quant.block_elems())
            else:
                want = ref.slab[s]
            assert got.dtype == np.float32
            assert got.tobytes() == want.tobytes(), s
    finally:
        snd.free()
        rcv.free()


def test_kv_codec_var_matches_reference():
    """``otpu_coll_quant_kv_codec`` with the reference's default and type,
    read by the slabs when no codec is named."""
    from ompi_tpu.base.mca import framework as jfw
    from ompi_tpu.base.var import registry as jreg
    from ompi_tpu_torch.base.mca import framework as tfw
    from ompi_tpu_torch.base.var import registry as treg

    jfw("coll").open()
    tfw("coll").open()
    tv = treg.lookup("otpu_coll_quant_kv_codec")
    jv = jreg.lookup("otpu_coll_quant_kv_codec")
    assert (tv.default, tv.vtype.name, tv.help) == \
        (jv.default, jv.vtype.name, jv.help)
    assert T.quant.kv_codec() == J.quant.kv_codec() == ""
    treg.set("otpu_coll_quant_kv_codec", "bf16")
    try:
        assert T.quant.kv_codec() == "bf16"
        slab = T.kv.KvSlabSender(_StubComm(), 1, 2, 256, 0)
        assert slab.codec == "bf16" and slab.slab.dtype == np.uint8
        assert slab.slot_nbytes == 512
    finally:
        treg.set("otpu_coll_quant_kv_codec", "")
    assert T.kv.KvSlabSender(_StubComm(), 1, 2, 256, 0).codec == ""


def test_kv_stream_pready_per_sequence_and_mismatched_counts(world):
    """One stage pair on loopback, receiver partitions = 2x sender slots:
    a slot is visible as soon as ITS Pready lands, before the epoch's tail
    flush; the blocks are the reference's toy_kv bit for bit across
    restarted epochs."""
    from ompi_tpu_torch.runtime.progress import progress

    a, b = world.as_rank(0), world.as_rank(1)
    snd = T.kv.KvSlabSender(a, peer=1, slots=4, elems_per_slot=32, tag=77)
    rcv = T.kv.KvSlabReceiver(b, peer=0, slots=4, elems_per_slot=32, tag=77,
                              partitions=8)
    try:
        for epoch in range(3):
            snd.begin_epoch(epoch)
            rcv.begin_epoch(epoch)
            snd.write_slot(2, T.worker.toy_kv(epoch * 10 + 2, 32))
            snd.slot_ready(2)
            for _ in range(200):
                if rcv.slot_arrived(2):
                    break
                progress()
            assert rcv.slot_arrived(2), "readied slot never arrived"
            assert not rcv.req.parrived(0) and not rcv.slot_arrived(0)
            np.testing.assert_array_equal(
                rcv.read_slot(2), J.worker.toy_kv(epoch * 10 + 2, 32))
            snd.write_slot(0, T.worker.toy_kv(epoch * 10, 32))
            snd.slot_ready(0)
            snd.finish_epoch(wait=True)
            rcv.finish_epoch()
            np.testing.assert_array_equal(
                rcv.read_slot(0), J.worker.toy_kv(epoch * 10, 32))
    finally:
        snd.free()
        rcv.free()


def test_kv_stream_epoch_desync_is_loud(world):
    """The same error classes as the reference's for a skipped epoch, a
    receiver partition count that does not tile the slots, a bad slot and
    a read before arrival."""
    def classes(ns, a, b, tag):
        MpiError = ns.errors.MpiError
        out = []
        snd = ns.kv.KvSlabSender(a, peer=3, slots=2, elems_per_slot=8,
                                 tag=tag)
        for fn in (lambda: snd.begin_epoch(1),
                   lambda: ns.kv.KvSlabReceiver(b, 2, 2, 8, tag + 1,
                                                partitions=3),
                   lambda: snd.write_slot(2, np.zeros(8, np.float32)),
                   lambda: ns.kv.KvSlabSender(a, 3, 0, 8, tag + 2),
                   lambda: ns.kv.KvSlabSender(a, 3, 2, 8, tag + 3,
                                              codec="fp4")):
            with pytest.raises(MpiError) as ei:
                fn()
            out.append(ei.value.error_class.name)
        return out, snd

    want, _ = classes(J, _StubComm(), _StubComm(), 0)
    got, snd = classes(T, world.as_rank(2), world.as_rank(3), 78)
    assert got == want == ["ERR_REQUEST", "ERR_ARG", "ERR_ARG", "ERR_ARG",
                           "ERR_ARG"]
    rcv = T.kv.KvSlabReceiver(world.as_rank(3), peer=2, slots=2,
                              elems_per_slot=8, tag=78)
    snd.begin_epoch(0)
    rcv.begin_epoch(0)
    with pytest.raises(T.errors.MpiError) as ei:
        rcv.read_slot(0)
    assert ei.value.error_class.name == "ERR_REQUEST"
    snd.finish_epoch(wait=True)
    rcv.finish_epoch()
    snd.free()
    rcv.free()


def test_kv_decode_worker_verifies_within_band(world):
    """A decode-stage worker with an int8 receiver takes the in-band block
    as its decode state: the reference's decode of the reference sender's
    bytes, bit for bit."""
    a, b = world.as_rank(2), world.as_rank(3)
    wk = T.worker.ShardWorker(b, router=2, role="decode", peer=2, slots=4,
                              kv_elems=256, kv_codec="int8")
    snd = T.kv.KvSlabSender(a, peer=3, slots=4, elems_per_slot=256,
                            tag=T.worker.TAG_KV, codec="int8")
    ref = J.kv.KvSlabSender(_StubComm(), 3, 4, 256, 0, codec="int8")
    try:
        snd.begin_epoch(0)
        snd.write_slot(1, T.worker.toy_kv(77, 256))
        ref.write_slot(1, J.worker.toy_kv(77, 256))
        snd.slot_ready(1)
        snd.finish_epoch(wait=True)
        wk._on_kv(0, [(77, 1)])
        want = J.quant.decode_f32(ref.slab[1], "int8", 256, 128)
        assert wk._kv[77].tobytes() == want.tobytes()
        kind, epoch, rids = a.recv_obj(3, T.worker.TAG_RES)
        assert (kind, epoch, rids) == ("kv_ready", 0, [77])
    finally:
        snd.free()
        wk._receiver.free()


# ------------------------------------------------------------- end to end

def _run_workers(workers):
    threads = [threading.Thread(target=wk.serve, daemon=True)
               for wk in workers]
    for t in threads:
        t.start()
    return threads


def _join(threads):
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads), "a serve loop hung"


def test_colocated_engine_end_to_end(world):
    from ompi_tpu_torch.serving import (ContinuousBatchScheduler,
                                        PoissonDriver, Router, ShardWorker)

    workers = [ShardWorker(world.as_rank(r), router=0) for r in (1, 2)]
    threads = _run_workers(workers)
    r = Router(world.as_rank(0),
               scheduler=ContinuousBatchScheduler(max_batch=4,
                                                  max_batch_tokens=4096),
               workers=[1, 2], decode_chunk=4)
    rep = PoissonDriver(rate_rps=800, n_requests=24, seed=3).run(
        r, max_wall_s=90)
    r.shutdown()
    _join(threads)
    assert rep["requests"] == 24 and rep["requeued"] == 0
    assert rep["tokens"] == sum(
        int(d) for d in J.driver.PoissonDriver(rate_rps=800, n_requests=24,
                                               seed=3).decodes)
    assert rep["tokens_per_s"] > 0
    # the log2-histogram percentiles hold the reference's factor-2 band
    # against the exact p99 over the driver's own samples
    assert rep["p50_ms"] > 0 and rep["p99_ms"] > 0
    assert rep["p99_ms"] <= rep["p99_exact_ms"] * 2.0 + 1.0
    assert rep["p99_exact_ms"] <= rep["p99_ms"] * 2.0 + 1.0
    assert all(_exact_tokens(q) for q in r.completed())
    assert {q.worker for q in r.completed()} == {1, 2}


@pytest.mark.parametrize("codec", CODECS, ids=["raw", "int8", "bf16"])
def test_stages_engine_kv_streams_end_to_end(world, codec):
    """A prefill/decode pair with receiver partitions at twice the sender's
    slots: the decode stage verifies every block (exactly raw, within the
    codec's band quantized; it raises otherwise), the router every token."""
    from ompi_tpu_torch.serving import (ContinuousBatchScheduler,
                                        PoissonDriver, Router, ShardWorker)

    epochs0 = T.spc.read("serve_kv_epochs")
    pre = ShardWorker(world.as_rank(1), router=0, role="prefill", peer=2,
                      slots=8, kv_elems=64, kv_codec=codec)
    dec = ShardWorker(world.as_rank(2), router=0, role="decode", peer=1,
                      slots=8, kv_elems=64, kv_partitions=16,
                      kv_codec=codec)
    threads = _run_workers([pre, dec])
    r = Router(world.as_rank(0),
               scheduler=ContinuousBatchScheduler(max_batch=8,
                                                  max_batch_tokens=8192,
                                                  slots=8),
               workers=[1, 2], stages=True, decode_chunk=3, kv_elems=64)
    rep = PoissonDriver(rate_rps=800, n_requests=16, seed=4).run(
        r, max_wall_s=90)
    r.shutdown()
    _join(threads)
    assert rep["requests"] == 16
    assert T.spc.read("serve_kv_epochs") > epochs0, "never streamed"
    assert all(_exact_tokens(q) for q in r.completed())
    assert {q.worker for q in r.completed()} == {2}


def test_stages_two_pairs_staggered_epochs(world):
    from ompi_tpu_torch.serving import (ContinuousBatchScheduler, Router,
                                        ShardWorker)

    ws = [ShardWorker(world.as_rank(1), router=0, role="prefill", peer=3,
                      slots=4, kv_elems=32),
          ShardWorker(world.as_rank(2), router=0, role="prefill", peer=4,
                      slots=4, kv_elems=32),
          ShardWorker(world.as_rank(3), router=0, role="decode", peer=1,
                      slots=4, kv_elems=32),
          ShardWorker(world.as_rank(4), router=0, role="decode", peer=2,
                      slots=4, kv_elems=32)]
    threads = _run_workers(ws)
    r = Router(world.as_rank(0),
               scheduler=ContinuousBatchScheduler(max_batch=2,
                                                  max_batch_tokens=4096,
                                                  slots=4),
               workers=[1, 2, 3, 4], stages=True, decode_chunk=2,
               kv_elems=32)
    for i in range(8):
        r.submit(4 + i, 2 + (i % 5))
    done = r.serve_until_drained(max_ticks=5000, check_invariants=True)
    r.shutdown()
    _join(threads)
    assert len(done) == 8 and all(_exact_tokens(q) for q in done)
    assert {q.worker for q in done} == {3, 4}


def test_stages_odd_worker_serves_colocated(world):
    from ompi_tpu_torch.serving import (ContinuousBatchScheduler, Router,
                                        ShardWorker)

    ws = [ShardWorker(world.as_rank(1), router=0, role="prefill", peer=2,
                      slots=4, kv_elems=32),
          ShardWorker(world.as_rank(2), router=0, role="decode", peer=1,
                      slots=4, kv_elems=32),
          ShardWorker(world.as_rank(3), router=0)]
    threads = _run_workers(ws)
    r = Router(world.as_rank(0),
               scheduler=ContinuousBatchScheduler(max_batch=4,
                                                  max_batch_tokens=4096,
                                                  slots=4),
               workers=[1, 2, 3], stages=True, decode_chunk=2, kv_elems=32)
    for _ in range(10):
        r.submit(6, 4)
    done = r.serve_until_drained(max_ticks=5000)
    r.shutdown()
    _join(threads)
    assert len(done) == 10 and all(_exact_tokens(q) for q in done)
    assert {q.worker for q in done} >= {2, 3}, "the leftover rank idled"


def test_expert_table_matches_reference(world):
    """The expert-sharded decode pool's table and each request's expert:
    the same arithmetic as the reference's (``partition`` slices)."""
    from ompi_tpu.serving.router import Router as JRouter
    from ompi_tpu_torch.serving import Router

    def table(cls, comm):
        r = cls.__new__(cls)
        r.stages, r.workers, r.experts = False, [1, 2, 3], 8
        r._prefill = r._decode = None
        reqs = [SimpleNamespace(prompt=tuple(range(i, i + 5)), rid=i)
                for i in range(12)] + [SimpleNamespace(prompt=None, rid=9)]
        return r.expert_table(), [r.expert_of(q) for q in reqs]

    assert table(Router, world) == table(JRouter, None)


@pytest.mark.parametrize("manage", [True, False],
                         ids=["own_recovery", "fleet_owned"])
@pytest.mark.parametrize("exc", ["ProcFailedError", "RevokedError"])
def test_tick_recovery_ownership_matches_reference(manage, exc):
    """A ULFM error inside the tick: a standalone router recovers itself,
    a fleet-owned one (``manage_recovery=False``) re-raises for the fleet
    controller to shrink the shared comm once, in both packages."""
    from ompi_tpu.serving.router import Router as JRouter
    from ompi_tpu_torch.serving import Router

    def outcome(cls, ns):
        r = cls.__new__(cls)
        r.manage_recovery = manage
        recovered = []

        def fail():
            raise getattr(ns.errors, exc)("worker 2 died")

        r._tick_inner = fail
        r._recover = lambda: recovered.append(True)
        try:
            r.tick()
        except ns.errors.MpiError as e:
            return "raised", e.error_class.name, recovered
        return "recovered", None, recovered

    got = outcome(Router, T)
    assert got == outcome(JRouter, J)
    assert got[0] == ("recovered" if manage else "raised")


class _TwoPoolFleet:
    """What :class:`MixedPoissonDriver` reads of a fleet (``routers`` by
    model, model-first ``submit``, ``tick``, ``completed``, ``depth``,
    ``running``, ``lost_and_requeued``), over two pool routers that share the router's comm as
    the fleet's do."""

    def __init__(self, routers: dict) -> None:
        self.routers = routers

    def submit(self, tenant, model, prompt_len, max_new_tokens, prompt=None,
               slo=""):
        return self.routers[model].submit(prompt_len, max_new_tokens,
                                          tenant=tenant, prompt=prompt,
                                          slo=slo)

    def tick(self) -> None:
        for r in self.routers.values():
            r.tick()

    def completed(self) -> list:
        return [q for r in self.routers.values() for q in r.completed()]

    def depth(self) -> int:
        return sum(r.sched.depth() for r in self.routers.values())

    def running(self) -> list:
        return [q for r in self.routers.values() for q in r.sched.running()]

    @property
    def lost_and_requeued(self) -> int:
        return sum(r.lost_and_requeued for r in self.routers.values())


def test_mixed_driver_over_pool_routers(world):
    """The driver's fleet branches (model-first submit, invariants on every
    pool router, prefix counts summed over the pools) over two
    ``manage_recovery=False`` pool routers: every request lands in its
    model's pool with the reference's tokens."""
    from ompi_tpu_torch.serving import (ContinuousBatchScheduler,
                                        MixedPoissonDriver, PrefixRegistry,
                                        Router, ShardWorker)

    threads = _run_workers([ShardWorker(world.as_rank(w), router=0,
                                        kv_elems=32) for w in (1, 2)])
    tenants = {"a": 1, "b": 1}
    fleet = _TwoPoolFleet({
        model: Router(world.as_rank(0),
                      scheduler=ContinuousBatchScheduler(
                          max_batch=4, max_batch_tokens=4096, slots=4,
                          tenants=tenants),
                      workers=[w], prefix_registry=PrefixRegistry(),
                      pool=model, manage_recovery=False, decode_chunk=4,
                      kv_elems=32)
        for model, w in (("m_a", 1), ("m_b", 2))})
    conf = {"a": dict(model="m_a", rate_rps=400, n_requests=12, prefixes=2,
                      prefix_len=32, prompt_lens=(4, 12)),
            "b": dict(model="m_b", rate_rps=300, n_requests=8,
                      prompt_lens=(4, 12))}
    rep = MixedPoissonDriver(conf, seed=6).run(fleet, max_wall_s=90,
                                               check_invariants=True)
    for r in fleet.routers.values():
        r.shutdown()
    _join(threads)
    assert rep["requests"] == 20
    assert rep["tenants"]["a"]["requests"] == 12
    assert rep["tenants"]["b"]["requests"] == 8
    assert rep["prefills"] + rep["prefix_hits"] == 20
    for model, w in (("m_a", 1), ("m_b", 2)):
        done = fleet.routers[model].completed()
        assert {q.worker for q in done} == {w}
        assert all(_exact_tokens(q) for q in done)


@pytest.mark.slow
def test_poisson_soak_invariants(world):
    """Long open-loop soak: heavy offered load, invariants every tick,
    every request complete and bit-exact."""
    from ompi_tpu_torch.serving import (ContinuousBatchScheduler,
                                        PoissonDriver, Router, ShardWorker)

    workers = [ShardWorker(world.as_rank(r), router=0) for r in (1, 2, 3)]
    threads = _run_workers(workers)
    sched = ContinuousBatchScheduler(max_batch=6, max_batch_tokens=4096)
    r = Router(world.as_rank(0), scheduler=sched, workers=[1, 2, 3],
               decode_chunk=2)
    drv = PoissonDriver(rate_rps=300, n_requests=200, prompt_lens=(4, 96),
                        decode_lens=(1, 48), seed=11)
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        assert elapsed < 300, "soak did not drain"
        for p, d in drv.due(elapsed):
            r.submit(p, d)
        r.tick()
        sched.check_invariants()
        if drv.exhausted and not sched.depth() and not sched.running():
            break
    r.shutdown()
    _join(threads)
    assert len(r.completed()) == 200
    assert all(_exact_tokens(q) for q in r.completed())


# ----------------------------------------------------------- request trace

@pytest.fixture()
def requests_on():
    from ompi_tpu_torch.base.var import registry
    from ompi_tpu_torch.runtime import trace

    registry.set("otpu_trace_enable", True)
    registry.set("otpu_trace_requests", True)
    trace.reset_for_testing()
    registry.set("otpu_trace_enable", True)
    registry.set("otpu_trace_requests", True)
    assert trace.requests_enabled
    yield trace
    registry.set("otpu_trace_enable", False)
    registry.set("otpu_trace_requests", False)
    trace.reset_for_testing()


def _run_traced(world, stages: bool, n: int):
    from ompi_tpu_torch.serving import (ContinuousBatchScheduler,
                                        PoissonDriver, Router, ShardWorker)

    if stages:
        workers = [ShardWorker(world.as_rank(1), router=0, role="prefill",
                               peer=2, slots=8, kv_elems=64),
                   ShardWorker(world.as_rank(2), router=0, role="decode",
                               peer=1, slots=8, kv_elems=64,
                               kv_partitions=16)]
    else:
        workers = [ShardWorker(world.as_rank(r), router=0) for r in (1, 2)]
    threads = _run_workers(workers)
    r = Router(world.as_rank(0),
               scheduler=ContinuousBatchScheduler(max_batch=8,
                                                  max_batch_tokens=8192,
                                                  slots=8),
               workers=[1, 2], stages=stages, decode_chunk=3, kv_elems=64)
    rep = PoissonDriver(rate_rps=800, n_requests=n, seed=6).run(
        r, max_wall_s=90)
    r.shutdown()
    _join(threads)
    return rep


def test_colocated_requests_decompose(world, requests_on):
    """The port's serve_req spans and flows decompose under the
    reference's analysis: six stages a request, the stage sum within
    (0, 1.25] of its own e2e, one complete arrow chain a request."""
    traced0 = T.spc.read("req_traced")
    rep = _run_traced(world, stages=False, n=16)
    report = requests_report(requests_on.chrome_events())
    assert report["requests_seen"] == rep["requests"] == 16
    assert report["decomposed"] == 16
    assert set(report["stage_median_us"]) == set(REQ_STAGES)
    band = report["stage_over_e2e"]
    assert 0.0 < band["min"] and band["max"] <= 1.25, band
    assert report["flows"]["chains_complete"] == 16
    assert T.spc.read("req_traced") - traced0 == 16


def test_staged_requests_full_chain(world, requests_on):
    """Staged: the chain's middle hop rides the KV slab's Pready key, so
    each chain has three hops and the kv stage is a measured wait."""
    rep = _run_traced(world, stages=True, n=12)
    report = requests_report(requests_on.chrome_events())
    assert report["requests_seen"] == rep["requests"] == 12
    assert report["decomposed"] == 12
    band = report["stage_over_e2e"]
    assert 0.0 < band["min"] and band["max"] <= 1.25, band
    assert report["flows"]["chains_complete"] == 12
    assert len(report["flows"]["sample"]["hops"]) == 3
    assert report["stage_median_us"]["kv"] > 0


def test_requests_off_emits_nothing(world):
    """With otpu_trace_requests off the engine stamps no stage and emits
    no serve_req event (the zero-overhead identity of the reference)."""
    from ompi_tpu_torch.runtime import trace

    stages0, traced0 = T.spc.read("req_stages"), T.spc.read("req_traced")
    rep = _run_traced(world, stages=True, n=6)
    assert rep["requests"] == 6
    assert not [e for e in trace.chrome_events()
                if e.get("cat") == "serve_req"
                or e.get("name") == "serve_req"]
    assert (T.spc.read("req_stages"), T.spc.read("req_traced")) == \
        (stages0, traced0)


# ------------------------------------------------------------ multiprocess

_FAIL = """
import sys
import ompi_tpu_torch
from ompi_tpu_torch.serving import ContinuousBatchScheduler, Router, ShardWorker
from ompi_tpu_torch.serving.worker import toy_token

w = ompi_tpu_torch.init(device="cpu")
if w.rank == 0:
    r = Router(w, scheduler=ContinuousBatchScheduler(
                   max_batch=6, max_batch_tokens=1 << 14), decode_chunk=2)
    subs = [r.submit(8 + (i % 5), 6 + (i % 7)) for i in range(24)]
    done = r.serve_until_drained(max_ticks=20000)
    assert len(done) == 24, (len(done), 24)
    assert len({q.rid for q in done}) == 24, "duplicate finishes"
    for q in subs:
        assert q.tokens == [toy_token(q.rid, i)
                            for i in range(q.max_new_tokens)], q
    assert r.lost_and_requeued > 0, "victim died, nothing requeued"
    assert len(r.workers) == 2, r.workers
    s = ompi_tpu_torch.Session.init()
    assert "mpi://surviving" in s.psets()
    assert 2 not in s.group_from_pset("mpi://surviving").world_ranks
    s.finalize()
    r.shutdown()
    print(f"ROUTER OK requeued={r.lost_and_requeued}", flush=True)
else:
    if w.rank == 2:
        # permit 2 micro-batches, die on the 3rd: mid-load, results unsent
        from ompi_tpu_torch.ft import chaos
        chaos.install_spec("kill:rank=2,site=serve_work,count=2")
    ShardWorker(w, router=0).serve()
    print(f"WORKER {w.rank} OK", flush=True)
"""


def test_serve_through_failure_zero_dropped(tmp_path):
    """A worker killed at the chaos ``serve_work`` kill point under
    ``--enable-recovery``: the router revokes, shrinks to
    ``mpi://surviving``, re-shards and requeues; every request completes
    bit for bit, none twice."""
    script = tmp_path / "serve_fail.py"
    script.write_text(_FAIL)
    r = _tpurun(4, [str(script)], extra=("--enable-recovery",))
    out = r.stdout + r.stderr
    assert "ROUTER OK" in r.stdout, out[-4000:]
    assert r.stdout.count("WORKER") == 2, out[-4000:]
    assert "rank 2 killed by schedule" in out


def test_tpurun_serving_role_flags(tmp_path):
    """--router-ranks/--worker-ranks publish the serving psets and roles()
    resolves placement from them (the router is not rank 0 here)."""
    script = tmp_path / "roles.py"
    script.write_text(textwrap.dedent("""
        import ompi_tpu_torch
        from ompi_tpu_torch import serving

        w = ompi_tpu_torch.init(device="cpu")
        router, workers = serving.roles(w)
        assert router == 1, (router, workers)
        assert workers == [0, 2], (router, workers)
        sub = w.split(0 if w.rank != 0 else 1)
        if w.rank != 0:
            # members outside the comm are ignored: the world's rank 2 is
            # the sub-comm's rank 1
            assert serving.roles(sub) == (0, [1]), serving.roles(sub)
        print(f"ROLES OK {w.rank}", flush=True)
    """))
    r = _tpurun(3, [str(script)],
                extra=("--router-ranks", "1", "--worker-ranks", "0,2"))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("ROLES OK") == 3


def _demo_lines(r) -> tuple:
    roles = [json.loads(ln.split("ROLES ", 1)[1])
             for ln in r.stdout.splitlines() if "ROLES {" in ln]
    ok = [json.loads(ln.split("SERVING DEMO OK ", 1)[1])
          for ln in r.stdout.splitlines() if "SERVING DEMO OK" in ln]
    return roles, ok


@pytest.mark.parametrize("flags", [(), ("--router-ranks", "0",
                                        "--worker-ranks", "1,2")],
                         ids=["default_split", "role_flags"])
def test_serving_demo_under_tpurun(flags):
    """The port's demo across three processes: rank 0 routes, rank 1
    prefills, rank 2 decodes, every rank reporting that placement."""
    r = _tpurun(3, ["-m", "ompi_tpu_torch.examples.serving_demo",
                    "--device", "cpu"], extra=flags)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    roles, ok = _demo_lines(r)
    assert sorted(x["rank"] for x in roles) == [0, 1, 2]
    assert all((x["router"], x["workers"]) == (0, [1, 2]) for x in roles)
    assert len(ok) == 1 and ok[0]["requests"] == 32


def test_serving_demo_in_process():
    """The demo in the device world, the MCA vars arming the int8 slabs and
    speculative decode as they do in the reference's."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               OTPU_MCA_coll_quant_kv_codec="int8",
               OTPU_MCA_serving_spec_k="4", OTPU_MCA_trace_enable="1")
    for k in ("OTPU_RANK", "OTPU_NPROCS", "OTPU_COORD"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent("""
        from ompi_tpu_torch.examples import serving_demo
        from ompi_tpu_torch.runtime import spc
        serving_demo.main(["--device", "cpu"])
        print("SPEC", spc.read("serve_spec_accepts"),
              spc.read("quant_encodes"))
    """)], capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    roles, ok = _demo_lines(r)
    assert roles == [{"rank": 0, "router": 0, "workers": [1, 2]}]
    assert len(ok) == 1 and ok[0]["requests"] == 32
    spec = r.stdout.split("SPEC ", 1)[1].split()
    assert int(float(spec[0])) > 0 and int(float(spec[1])) >= 32, spec


@pytest.mark.slow
def test_autoscale_spawns_workers_via_job_pset(tmp_path):
    """Queue depth above the watermark spawns the port's worker
    (``python -m ompi_tpu_torch.serving.worker cpu``), verified against the
    dynamic ``mpi://job/<id>`` pset before it merges."""
    script = tmp_path / "serve_scale.py"
    script.write_text(textwrap.dedent("""
        import sys
        import ompi_tpu_torch
        from ompi_tpu_torch.runtime import spc
        from ompi_tpu_torch.serving import (ContinuousBatchScheduler, Router,
                                            ShardWorker)
        from ompi_tpu_torch.serving.worker import toy_token

        w = ompi_tpu_torch.init(device="cpu")
        if w.rank == 0:
            r = Router(w, scheduler=ContinuousBatchScheduler(
                           max_batch=2, max_batch_tokens=1 << 13),
                       decode_chunk=2, scale_watermark=3, scale_step=1,
                       scale_patience=2,
                       scale_argv=[sys.executable, "-m",
                                   "ompi_tpu_torch.serving.worker", "cpu"])
            subs = [r.submit(8, 8) for _ in range(12)]
            done = r.serve_until_drained(max_ticks=20000)
            assert len(done) == 12, len(done)
            for q in subs:
                assert q.tokens == [toy_token(q.rid, i)
                                    for i in range(q.max_new_tokens)]
            assert spc.read("serve_scaleups") >= 1, "never scaled"
            assert len(r.workers) == 2 and r.comm.size == 3
            r.shutdown()
            print(f"SCALE OK workers={r.workers}", flush=True)
        else:
            ShardWorker(w, router=0).serve()
            print("BASE WORKER OK", flush=True)
    """))
    r = _tpurun(2, [str(script)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "SCALE OK" in r.stdout, r.stdout + r.stderr
