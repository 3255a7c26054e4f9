"""The port's stage clocks and sampling profiler (``runtime/profile.py``),
with their sites in the staging pool, pml/ob1 and coll/quant's host codec,
held against the JAX package's.

The pure functions take the same durations in both packages and are
compared exactly: the closed ``STAGES`` table, ``stage_stats`` and
``stage_delta_stats``, the export payload's stage table and the ``profile``
telemetry source's interval deltas.  An undeclared stage raises in both.
The sampling profiler classifies the same frames the same way (a parked
wait, a ``@hot_path`` function, the reactor's ``_native_drain``), and its
thread samples and stops.  The same device-world calls record the same
stage names; the staging pool records the same spans and stage in both
and, under ``OTPU_SANITIZE``, fails a non-contiguous or a double release
in both.
"""
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu.base.var import registry as jreg
from ompi_tpu.mca.accelerator import jax_acc
from ompi_tpu.mca.coll import quant as jquant
from ompi_tpu.runtime import hotpath as jhot
from ompi_tpu.runtime import profile as jprof
from ompi_tpu.runtime import sanitizer as jsan
from ompi_tpu.runtime import trace as jtrace
from ompi_tpu_torch.base.var import registry as treg
from ompi_tpu_torch.mca.accelerator import torch_acc
from ompi_tpu_torch.mca.coll import quant as tquant
from ompi_tpu_torch.runtime import hotpath as thot
from ompi_tpu_torch.runtime import profile as tprof
from ompi_tpu_torch.runtime import reactor as treactor
from ompi_tpu_torch.runtime import sanitizer as tsan
from ompi_tpu_torch.runtime import trace as ttrace

PKGS = {
    "jax": SimpleNamespace(prof=jprof, reg=jreg, acc=jax_acc, quant=jquant,
                           san=jsan, trace=jtrace, pkg=ompi_tpu, hot=jhot),
    "torch": SimpleNamespace(prof=tprof, reg=treg, acc=torch_acc,
                             quant=tquant, san=tsan, trace=ttrace,
                             pkg=ompi_tpu_torch, hot=thot)}


def _both(fn):
    got = {name: fn(ns) for name, ns in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _arm(on: bool) -> None:
    for ns in PKGS.values():
        ns.reg.set("otpu_profile_stages", on)
        ns.prof.reset_for_testing()


@pytest.fixture
def stages():
    _arm(True)
    yield
    _arm(False)


def test_tables_are_the_references():
    for name in ("STAGES", "_HOST_STAGES", "_BLOCKED_FILES",
                 "_BLOCKED_NAMES", "_NATIVE_NAMES"):
        assert getattr(tprof, name) == getattr(jprof, name), name
    assert hasattr(treactor, "_native_drain")


def _durations(seed: int) -> list:
    rng = np.random.default_rng(seed)
    names = sorted(tprof.STAGES)
    return [(names[int(rng.integers(len(names)))],
             int(2 ** rng.uniform(6, 22))) for _ in range(300)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stage_stats_match(stages, seed):
    pop = _durations(seed)

    def run(ns):
        p = ns.prof
        for stage, dur in pop[:120]:
            p.stage_span(stage, 1000, 1000 + dur)
        prev = p.stage_snapshot()
        for stage, dur in pop[120:]:
            p.stage_span(stage, 1000, 1000 + dur)
        p.stage_mark("send.queue")
        p.stage_span("send.pack", 0, 5000)          # t0 0: ignored
        cur = p.stage_snapshot()
        return (p.stage_stats(cur), p.stage_stats(prev),
                p.stage_delta_stats(prev, cur), p.stage_delta_stats(cur, cur),
                p.export_payload()["stages"])

    stats, _, delta, empty, exported = _both(run)
    assert empty == {} and exported == stats
    assert sum(row["n"] for row in stats.values()) == len(pop) + 1


def test_undeclared_stage_raises(stages):
    def run(ns):
        with pytest.raises(ValueError) as ei:
            ns.prof.stage_span("send.bogus", 1, 2)
        with pytest.raises(ValueError):
            ns.prof.stage_mark("recv.bogus")
        return str(ei.value)

    assert "not declared" in _both(run)


def test_disabled_stage_clocks_record_nothing():
    _arm(False)

    def run(ns):
        ns.prof.stage_span("send.pack", 1, 2)
        ns.prof.stage_mark("send.pack")
        return ns.prof.stage_snapshot(), ns.prof.export_payload(), \
            ns.prof._telemetry_stats()

    assert _both(run) == ({}, None, None)


def test_telemetry_source_deltas_match(stages):
    def run(ns):
        p = ns.prof
        p._last_tele_snap = {}
        for stage, dur in _durations(5):
            p.stage_span(stage, 10, 10 + dur)
        first = p._telemetry_stats()
        second = p._telemetry_stats()
        return first, second

    first, second = _both(run)
    assert first["host_us"] > 0 and second == {"host_us": 0.0, "stages": {}}


def _park(stop, ready, halt):
    ready.set()
    stop.wait(10)


def _spin(stop, ready, halt):
    # a plain list flag: Event.is_set's frame lies in threading.py, which
    # the profiler counts as a parked wait
    ready.set()
    while not halt:
        pass


def _classify_thread(target, name):
    """(phase, released) the package's profiler gives a thread running
    ``target``."""
    stop, ready, halt = threading.Event(), threading.Event(), []
    t = threading.Thread(target=target, args=(stop, ready, halt),
                         daemon=True)
    t.start()
    ready.wait(5)
    time.sleep(0.05)
    try:
        frame = sys._current_frames()[t.ident]
        return PKGS[name].prof.HostProfiler(0, 5)._classify(frame)
    finally:
        halt.append(True)
        stop.set()
        t.join(5)


def _hot_spin(name):
    """A spin loop tagged with the package's @hot_path (its phase label)."""
    def hot_loop(stop, ready, halt):
        ready.set()
        while not halt:
            pass
    hot_loop.__qualname__ = "hot_loop"
    return PKGS[name].hot.hot_path(hot_loop)


def _native_drain(stop, ready, halt):
    ready.set()
    while not halt:
        pass


def test_profiler_classifies_frames_alike():
    def run(name):
        return [_classify_thread(_park, name),
                _classify_thread(_spin, name),
                _classify_thread(_hot_spin(name), name),
                _classify_thread(_native_drain, name)]

    got = {name: run(name) for name in PKGS}
    assert got["torch"] == got["jax"]
    assert got["torch"] == [("idle", True), ("other", False),
                            ("hot_loop", False), ("native", True)]


def test_sampling_profiler_samples_and_stops():
    def run(ns):
        ns.reg.set("otpu_profile_interval_ms", 5)
        try:
            rte = SimpleNamespace(my_world_rank=3)
            started = ns.prof.start(rte)
            again = ns.prof.start(rte)              # idempotent
            deadline = time.time() + 5
            while (ns.prof.profiler_stats() or {}).get("samples", 0) < 5 \
                    and time.time() < deadline:
                time.sleep(0.02)
            stats = ns.prof.profiler_stats()
            thread = ns.prof._profiler._thread
            ns.prof.stop()
            return (started, again, sorted(stats), stats["samples"] >= 5,
                    0.0 <= stats["gil_released"] <= 1.0,
                    thread.is_alive(), ns.prof._profiler,
                    ns.prof.profiler_stats())
        finally:
            ns.reg.set("otpu_profile_interval_ms", 0)
            ns.prof.reset_for_testing()

    assert _both(run) == (True, True, ["gil_released", "gil_wait", "phases",
                                       "samples"], True, True, False, None,
                          None)


def test_no_profiler_without_an_interval():
    assert _both(lambda ns: (ns.prof.start(SimpleNamespace()),
                             ns.prof._profiler)) == (False, None)


# -- the stage sites -----------------------------------------------------

@pytest.fixture(scope="module")
def worlds():
    from ompi_tpu.runtime import init as jrt
    from ompi_tpu_torch.runtime import init as trt

    jrt.reset_for_testing()
    trt.reset_for_testing()
    jw = ompi_tpu.init()
    if jw.size != 8:
        pytest.skip("needs 8 virtual devices")
    yield {"jax": jw, "torch": ompi_tpu_torch.init(device="cpu")}
    jrt.reset_for_testing()
    trt.reset_for_testing()


def test_point_to_point_stage_names_match(worlds, stages):
    def run(ns):
        name = "torch" if ns.pkg is ompi_tpu_torch else "jax"
        w = worlds[name]
        for n in (3, 3000):
            w.as_rank(0).send(np.arange(float(n)), dest=2, tag=n)
            w.as_rank(2).recv(np.zeros(n), source=0, tag=n)
        req = w.as_rank(1).issend(np.ones(10), dest=3, tag=1)
        w.as_rank(3).recv(np.zeros(10), source=1, tag=1)
        req.wait()
        return {s: row["n"] for s, row in ns.prof.stage_stats().items()}

    assert _both(run) == {"send.pack": 3, "recv.deliver": 3,
                          "recv.complete": 3}


def test_host_codec_stage_names_match(stages):
    x = np.random.default_rng(4).standard_normal(1000).astype(np.float32)

    def run(ns):
        for codec in ("int8", "bf16"):
            enc = ns.quant.encode_f32(x, codec)
            ns.quant.decode_f32(enc, codec, x.size)
        return {s: row["n"] for s, row in ns.prof.stage_stats().items()}

    assert _both(run) == {"quant.encode": 2, "quant.decode": 2}


def test_staging_pool_spans_and_stage_match(stages, tmp_path):
    for ns in PKGS.values():
        ns.reg.set("otpu_trace_dir", str(tmp_path))
        ns.reg.set("otpu_trace_enable", True)
        ns.trace.reset_for_testing()
    try:
        def run(ns):
            pool = ns.acc._StagingPool()
            a = pool.acquire((1000,), np.float32)
            pool.release(a)
            b = pool.acquire((900,), np.float32)      # the same class: hit
            pool.release(b)
            spans = [(e["name"], e["cat"], e["args"])
                     for e in ns.trace.chrome_events()]
            return spans, sorted(ns.trace.histograms()), pool.stats(), \
                {s: row["n"] for s, row in ns.prof.stage_stats().items()}

        spans, hists, stats, stage = _both(run)
        assert [s[0] for s in spans] == ["staging_miss", "staging_hit"]
        assert stage == {"send.staging": 2} and stats["hits"] == 1
    finally:
        for ns in PKGS.values():
            ns.reg.set("otpu_trace_enable", False)
            ns.trace.reset_for_testing()


def test_staging_release_fails_under_the_sanitizer(monkeypatch):
    def run(ns):
        monkeypatch.setattr(ns.san, "enabled", True)
        pool = ns.acc._StagingPool()
        a = pool.acquire((64, 64), np.float32)
        out = []
        with pytest.raises(ns.san.SanitizeError) as ei:
            pool.release(a.T)                      # not C-contiguous
        out.append("non-C-contiguous" in str(ei.value))
        foreign = np.empty(1 << 16, np.uint8)
        pool.release(foreign)                      # adopted
        with pytest.raises(ns.san.SanitizeError) as ei:
            pool.release(foreign)                  # twice
        out.append("double release" in str(ei.value))
        monkeypatch.undo()
        return out

    assert _both(run) == [True, True]


def test_staging_source_is_registered():
    import weakref

    from ompi_tpu.runtime import telemetry as jtele
    from ompi_tpu_torch.runtime import telemetry as ttele

    for tele, acc in ((ttele, torch_acc), (jtele, jax_acc)):
        with tele._lock:
            entry = tele._sources.get("staging")
        fn = entry() if isinstance(entry, weakref.WeakMethod) else entry
        assert fn() == acc.staging.stats()


def test_profiler_lets_go_of_sampled_frames():
    """The port's profiler drops each sample's frames before it sleeps: a
    function that returned while sampled leaves nothing alive behind (the
    reference keeps the last sample's frames, and with them their locals,
    until its next tick).  A kept view of a shared segment made the
    teardown's unmap fail."""
    import gc
    import weakref

    class Payload:
        pass

    tprof._interval_var.set(200)
    try:
        assert tprof.start(SimpleNamespace(my_world_rank=0))

        def sampled():
            obj = Payload()
            ref = weakref.ref(obj)
            deadline = time.time() + 5
            while (tprof.profiler_stats() or {}).get("samples", 0) < 1 \
                    and time.time() < deadline:
                time.sleep(0.005)
            return ref

        ref = sampled()
        gc.collect()
        assert (tprof.profiler_stats() or {}).get("samples", 0) >= 1
        assert ref() is None
    finally:
        tprof.stop()
        tprof._interval_var.set(0)
        tprof.reset_for_testing()
