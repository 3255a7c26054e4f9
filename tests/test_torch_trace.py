"""The port's trace runtime (``runtime/trace.py``), its clock-offset
estimator (``tools/mpisync.py``) and ``base/timer.py``, held against the
JAX package's.

The pure functions take the same seeded inputs in both packages and are
compared exactly: the log2 bins and their labels, the histograms, their
percentiles and pvars, ``hist_delta_stats``, ``merge_timelines`` and
``skew_report`` on fixed payloads, the Chrome payload's schema, the
declared tables and ``estimate_offset`` on a fake exchange.  In the device
world (the reference's 8-device CPU mesh, the port's CPU lane) one program
of ``allreduce_array``, ``bcast_array``, a persistent handle, a window's put
and accumulate and a point-to-point message records the same multiset of
span names, categories and ``nbytes`` args, and the same ``pml_msg`` flow
keys; with tracing off the coll wrapper records nothing and calls its slot
once.  Across processes, one ``tpurun -n 2`` job a package over btl/sm and
one over btl/tcp (tracing and the stage clocks on) give the same flow keys
and stage names, every ``pml_msg`` flow start has its finish, and the
launcher writes the merged timeline and the skew report.  Every subprocess
has its own ``timeout=``.

Both boots record the same four spans, ``jax_distributed_init`` among
them: the reference's name, kept by the port for the boot of its
multi-process device world (``torch.distributed``), recorded on every boot
as the reference records it.
"""
import json
import os
import signal
import subprocess
import sys
import threading
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu.base import timer as jtimer
from ompi_tpu.base.var import registry as jreg
from ompi_tpu.runtime import trace as jtrace
from ompi_tpu.tools import mpisync as jsync
from ompi_tpu_torch.base import timer as ttimer
from ompi_tpu_torch.base.var import registry as treg
from ompi_tpu_torch.runtime import trace as ttrace
from ompi_tpu_torch.tools import mpisync as tsync

REPO = Path(__file__).resolve().parent.parent
PKGS = {"jax": SimpleNamespace(trace=jtrace, reg=jreg, pkg=ompi_tpu),
        "torch": SimpleNamespace(trace=ttrace, reg=treg, pkg=ompi_tpu_torch)}


def _both(fn):
    """``fn(ns)`` on both packages; the results must be equal."""
    got = {name: fn(ns) for name, ns in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _arm(on: bool, tdir=None) -> None:
    for ns in PKGS.values():
        if tdir is not None:
            ns.reg.set("otpu_trace_dir", str(tdir))
        ns.reg.set("otpu_trace_enable", on)
        ns.trace.reset_for_testing()


@pytest.fixture
def tracers(tmp_path):
    """Both tracers armed, with the histogram pvars that earlier tests in
    this process registered (each package its own) set aside, so that each
    test compares the pvars its own records create; the tables are put back
    after it."""
    saved = [(ns.reg, dict(ns.reg._pvars)) for ns in PKGS.values()]
    for ns in PKGS.values():
        ns.reg._pvars = {k: v for k, v in ns.reg._pvars.items()
                         if not k.startswith("otpu_trace_hist_")}
    _arm(True, tmp_path)
    yield PKGS
    _arm(False, "")
    for reg, pvars in saved:
        reg._pvars = pvars


class _FakeComm:
    cid = 42

    def __init__(self):
        self.c_coll = {}


# -- the declared tables and the pure functions --------------------------

def test_tables_are_the_references():
    for name in ("CATEGORIES", "FLOW_CATEGORIES", "_SIZED_COLLS",
                 "_KV_KEY", "_DEFAULT_DIR"):
        assert getattr(ttrace, name) == getattr(jtrace, name), name


def test_bin_labels_match():
    labels = _both(lambda ns: [ns.trace._bin_label(b) for b in range(48)])
    assert labels[:4] == ["0", "1b", "2b", "4b"] and labels[11] == "1k"


def _population(seed: int):
    """(coll, nbytes, duration ns) triples from a seed: log-uniform sizes
    and durations over several bins, a few collectives."""
    rng = np.random.default_rng(seed)
    colls = ["allreduce", "bcast_array", "btl_sendmsg"]
    return [(colls[int(rng.integers(3))],
             int(2 ** rng.uniform(0, 24)),
             int(2 ** rng.uniform(8, 26)))
            for _ in range(400)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histograms_and_percentiles_match(tracers, seed):
    pop = _population(seed)

    def run(ns):
        tr = ns.trace
        for coll, nbytes, dur in pop:
            tr.hist_record(coll, nbytes, dur)
        pv = {p.name: p for p in ns.reg.all_pvars()
              if p.name.startswith("otpu_trace_hist_")}
        pvars = {name: pv[name].read() for name in sorted(pv)}
        pct = [tr.hist_percentile(c, q, nb) for c in
               ("allreduce", "bcast_array", "btl_sendmsg", "absent")
               for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0)
               for nb in (None, 1, 4096, 1 << 20)]
        return tr.histograms(), tr.hist_snapshot(), pct, pvars

    hists, snap, pct, pvars = _both(run)
    assert sum(c[0] for c in hists.values()) == len(pop)
    assert any(v > 0 for k, v in pvars.items() if k.endswith("_p99_us"))
    with pytest.raises(ValueError):
        ttrace.hist_percentile("allreduce", 1.5)


@pytest.mark.parametrize("seed", [3, 4])
def test_hist_delta_stats_and_reset_match(tracers, seed):
    pop = _population(seed)

    def run(ns):
        tr = ns.trace
        for coll, nbytes, dur in pop[:150]:
            tr.hist_record(coll, nbytes, dur)
        prev = tr.hist_snapshot()
        for coll, nbytes, dur in pop[150:]:
            tr.hist_record(coll, nbytes, dur)
        cur = tr.hist_snapshot()
        out = [tr.hist_delta_stats(prev, cur), tr.hist_delta_stats({}, cur),
               tr.hist_delta_stats(cur, cur)]
        tr.hist_reset("bcast_array")
        out.append(sorted(tr.histograms()))
        return out

    deltas = _both(run)
    assert deltas[2] == {} and all(k[0] != "bcast_array" for k in deltas[3])


def _payloads(seed: int, nranks: int = 3) -> list:
    """Per-rank Chrome payloads from a seed: coll spans on two comms (one
    rank missing rounds of one collective), pml spans and flow events,
    each rank with its own clock offset."""
    rng = np.random.default_rng(seed)
    out = []
    for rank in range(nranks):
        events = []
        t = 1e6 + float(rng.uniform(0, 50))
        for k in range(6):
            for name, cid in (("allreduce", 0), ("bcast", 3)):
                if name == "bcast" and rank == 2 and k < 2:
                    continue                    # lost to the ring on rank 2
                dur = float(rng.uniform(5, 500))
                events.append({"ph": "X", "name": name, "cat": "coll",
                               "ts": t, "dur": dur, "tid": 1,
                               "args": {"nbytes": int(2 ** rng.integers(0, 22)),
                                        "cid": cid, "cseq": k}})
                t += dur + float(rng.uniform(1, 20))
        events.append({"ph": "X", "name": "send", "cat": "pml", "ts": t,
                       "dur": 3.0, "tid": 1, "args": {"nbytes": 8}})
        events.append({"ph": "s", "name": "pml_msg", "cat": "flow",
                       "ts": t + 3.0, "tid": 1, "id": f"0.{rank}.0.0"})
        rng.shuffle(events)
        out.append({"traceEvents": events,
                    "metadata": {"rank": rank,
                                 "clock_offset_us": float(rng.normal(0, 30)),
                                 "events_overwritten": int(rank == 2)}})
    return out


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_merge_timelines_and_skew_report_match(seed):
    payloads = _payloads(seed)
    merged, report = _both(lambda ns: (
        ns.trace.merge_timelines(json.loads(json.dumps(payloads))),
        ns.trace.skew_report(json.loads(json.dumps(payloads)))))
    assert [e["ts"] for e in merged] == sorted(e["ts"] for e in merged)
    assert "events overwritten" in report and "bcast" in report


def test_chrome_payload_schema_matches(tracers):
    def run(ns):
        tr = ns.trace
        base = tr.now()
        tr.span("allreduce", "coll", base, base + 2500,
                args={"nbytes": 64, "cid": 0, "cseq": 0})
        tr.span("win_fence", "osc", base + 3000, base + 4000,
                args={"win": "w"})
        tr.flow_start("pml_msg", (0, 1, 2, 7), base + 5000)
        tr.flow_finish("pml_msg", "0.1.2.7", base + 6000)
        tr.flow_start("coll_round", (3, 4), base + 7000)
        events = tr.chrome_events()
        # wall-clock microseconds carry a quarter-microsecond ulp: the
        # offsets from the first span, whole microseconds, compare exactly
        zero = tr._wall_us(base)
        for ev in events:
            ev["ts"] = round(ev["ts"] - zero)
        payload = tr.chrome_payload(5, clock_offset_us=1.5,
                                    extra_meta={"profile": {"x": 1}})
        meta = dict(payload["metadata"])
        meta.pop("trace_dir")
        return events, sorted(payload), meta, tr.recorded_count(), \
            {e["pid"] for e in payload["traceEvents"]}

    events, keys, meta, recorded, pids = _both(run)
    assert keys == ["metadata", "traceEvents"] and pids == {5}
    assert recorded == 5 and [e["ph"] for e in events] == [
        "X", "X", "s", "f", "s"]
    assert events[3]["bp"] == "e" and events[2]["id"] == "0.1.2.7"
    assert meta["events_overwritten"] == 0 and meta["clock_offset_us"] == 1.5


def test_ring_overwrite_matches(tmp_path):
    for ns in PKGS.values():
        ns.reg.set("otpu_trace_buffer_events", 1024)
    try:
        _arm(True, tmp_path)

        def run(ns):
            for i in range(1500):
                ns.trace.span(f"op{i % 7}", "coll", i, i + 1)
            p = ns.trace.chrome_payload(0)
            return (ns.trace.recorded_count(), len(p["traceEvents"]),
                    p["metadata"]["events_overwritten"])

        assert _both(run) == (1500, 1024, 476)
    finally:
        for ns in PKGS.values():
            ns.reg.set("otpu_trace_buffer_events", 65536)
        _arm(False, "")


def test_estimate_offset_on_a_fake_exchange(monkeypatch):
    """The min-RTT filter: the offset is taken at the round with the
    smallest round trip, theirs - (t_send + rtt/2)."""
    def run(mod):
        clock = iter(np.cumsum(np.random.default_rng(8).uniform(
            1e-4, 3e-3, 64)) + 1000.0)
        replies = iter(np.random.default_rng(9).uniform(1000.0, 1000.2, 32))
        monkeypatch.setattr(mod, "time", SimpleNamespace(
            time=lambda: float(next(clock))))
        got = mod.estimate_offset(lambda: float(next(replies)), iters=12)
        monkeypatch.undo()
        return got

    got = run(tsync)
    assert got == run(jsync)
    t = np.cumsum(np.random.default_rng(8).uniform(1e-4, 3e-3, 64)) + 1000.0
    theirs = np.random.default_rng(9).uniform(1000.0, 1000.2, 32)
    rtts = [t[2 * i + 1] - t[2 * i] for i in range(12)]
    best = int(np.argmin(rtts))
    assert got == (float(theirs[best]) - (t[2 * best] + rtts[best] / 2),
                   rtts[best])


def test_interval_stats_match():
    def run(mod):
        st = mod.IntervalStats()
        for dt in (5, 17, 3, 100):
            st.record(dt)
        with st:
            pass
        return st.count, st.min_ns, st.max_ns >= 100, \
            mod.IntervalStats().mean_ns, type(mod.now_ns()).__name__

    assert run(ttimer) == run(jtimer) == (5, 3, True, 0.0, "int")


def test_concurrent_recording_is_consistent(tracers):
    def worker(i):
        for _ in range(300):
            ttrace.span(f"op{i}", "coll", ttrace.now())
            ttrace.hist_record("allreduce", 1024, 1000)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ttrace.histograms()[("allreduce", "1k")][0] == 1200
    assert ttrace.recorded_count() == len(ttrace.chrome_events()) == 1200


# -- the coll-table wrapper ----------------------------------------------

def _slot(calls: list):
    class Module:
        def allreduce(self, comm, x):
            calls.append(len(x))
            return x * 2
    fn = Module().allreduce
    return fn


def test_disabled_wrapper_records_nothing_and_calls_once(tmp_path):
    _arm(False, tmp_path)

    def run(ns):
        calls = []
        comm = _FakeComm()
        comm.c_coll["allreduce"] = inner = _slot(calls)
        ns.trace.wrap_coll_table(comm)
        wrapped = comm.c_coll["allreduce"]
        ns.trace.wrap_coll_table(comm)             # no second layer
        out = wrapped(comm, np.ones(4))
        return (calls, out.tolist(), ns.trace.recorded_count(),
                ns.trace.histograms(), wrapped.__wrapped__ is inner,
                wrapped.__self__ is inner.__self__, wrapped.__traced__,
                comm.c_coll["allreduce"] is wrapped)

    assert _both(run) == ([4], [2.0] * 4, 0, {}, True, True, True, True)


def test_enabled_wrapper_records_span_histogram_and_round(tracers):
    def run(ns):
        comm = _FakeComm()
        comm.c_coll["allreduce"] = _slot([])
        ns.trace.wrap_coll_table(comm)
        x = np.ones(1 << 12, np.float32)

        def count():    # pvars stay registered and cumulative across tests
            return sum(p.read() for p in ns.reg.all_pvars()
                       if p.name == "otpu_trace_hist_allreduce_16k_count")

        before = count()
        for _ in range(5):
            comm.c_coll["allreduce"](comm, x)
        spans = [(e["name"], e["cat"], e["args"]) for e in
                 ns.trace.chrome_events()]
        return spans, sorted(ns.trace.histograms()), count() - before

    spans, keys, counted = _both(run)
    assert [s[2]["cseq"] for s in spans] == [0, 1, 2, 3, 4]
    assert keys == [("allreduce", "16k")] and counted == 5


# -- the device world ----------------------------------------------------

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
    _arm(False, "")
    jrt.reset_for_testing()
    trt.reset_for_testing()


def _device_array(name, host):
    if name == "torch":
        return torch.from_numpy(host)
    import jax.numpy as jnp

    return jnp.asarray(host)


def device_program(name, w, pkg) -> None:
    """The same calls on either package's device world: allreduce_array,
    bcast_array, a persistent allreduce handle called twice, a device
    window's put and accumulate, and one point-to-point message."""
    rng = np.random.default_rng(11)
    x = _device_array(name, rng.integers(-8, 8, (8, 256)).astype(np.float32))
    w.allreduce_array(x)
    w.bcast_array(x, root=3)
    h = w.allreduce_array_init(x)
    h(x)
    h(x)
    win = pkg.Win.create(w, size=16, dtype=np.float32, device=True)
    win.fence()
    win.put(np.arange(4, dtype=np.float32), 2, offset=1)
    win.accumulate(np.ones(3, np.float32), 5, offset=0)
    win.fence()
    win.free()
    w.as_rank(0).send(np.arange(6.0), dest=4, tag=9)
    got = np.zeros(6)
    w.as_rank(4).recv(got, source=0, tag=9)


def test_device_world_spans_match(worlds, tmp_path):
    _arm(True, tmp_path)
    try:
        def run(name):
            device_program(name, worlds[name], PKGS[name].pkg)
            return Counter(
                (e["name"], e["cat"], (e.get("args") or {}).get("nbytes"))
                for e in PKGS[name].trace.chrome_events()
                if e["ph"] == "X")

        got = {name: run(name) for name in PKGS}
        assert got["torch"] == got["jax"]
        names = {k[0] for k in got["torch"]}
        assert {"allreduce_array", "xla_allreduce", "bcast_array",
                "xla_bcast", "persistent_coll", "win_fence", "send",
                "recv"} <= names
        assert got["torch"][("xla_allreduce", "device", 8 * 256 * 4)] == 4
    finally:
        _arm(False, "")


def test_device_world_flows_match(worlds, tmp_path):
    _arm(True, tmp_path)
    try:
        def run(name):
            device_program(name, worlds[name], PKGS[name].pkg)
            flows = sorted((e["ph"], e["name"], e["id"])
                           for e in PKGS[name].trace.chrome_events()
                           if e["ph"] in ("s", "f"))
            rounds = sorted((e["name"], e["args"]["cid"], e["args"]["cseq"])
                            for e in PKGS[name].trace.chrome_events()
                            if e["cat"] == "coll")
            return flows, rounds

        got = {name: run(name) for name in PKGS}
        assert got["torch"] == got["jax"]
        flows, rounds = got["torch"]
        starts = {i for ph, _, i in flows if ph == "s"}
        assert starts and starts == {i for ph, _, i in flows if ph == "f"}
        assert rounds
    finally:
        _arm(False, "")


def test_device_world_boot_spans(tmp_path):
    """Re-init with tracing on: the boot spans of both packages are equal,
    the device world's ``jax_distributed_init`` among them."""
    from ompi_tpu.runtime import init as jrt
    from ompi_tpu_torch.runtime import init as trt

    _arm(True, tmp_path)
    try:
        jrt.reset_for_testing()
        trt.reset_for_testing()
        _arm(True, tmp_path)
        ompi_tpu.init()
        ompi_tpu_torch.init(device="cpu")
        got = {name: sorted(e["name"] for e in ns.trace.chrome_events()
                            if e["cat"] == "boot")
               for name, ns in PKGS.items()}
        assert got["jax"] == got["torch"]
        assert got["torch"] == ["coord_connect", "instance_boot",
                                "jax_distributed_init", "modex_fence"]
        # finalize writes this rank's Chrome file into the trace dir
        trt.reset_for_testing()
        payload = json.loads((tmp_path / "trace_rank0.json").read_text())
        assert payload["metadata"]["rank"] == 0
    finally:
        _arm(False, "")
        jrt.reset_for_testing()
        trt.reset_for_testing()


# -- the multi-process world ---------------------------------------------

JOB = r'''
import sys
import numpy as np

pkg = sys.argv[1]
if pkg == "torch":
    import ompi_tpu_torch as m
    w = m.init(device="cpu")
else:
    import ompi_tpu as m
    w = m.init()
r = w.rank
peer = 1 - r
for n in (1, 1, 1, 40000, 300000):      # eager, RNDV (sm and tcp), RGET
    buf = np.zeros(n)
    if r == 0:
        w.send(np.arange(n, dtype=np.float64), dest=peer, tag=n % 100)
        w.recv(buf, source=peer, tag=n % 100)
    else:
        w.recv(buf, source=peer, tag=n % 100)
        w.send(buf + 1.0, dest=peer, tag=n % 100)
out = w.allreduce(np.full(1000, r + 1.0))
w.barrier()
print("done", float(out[0]), flush=True)
m.finalize()
'''


def _tpurun(pkg, args, timeout=240):
    env = dict(os.environ)
    env.pop("OTPU_RANK", None)
    env.pop("OTPU_NPROCS", None)
    launcher = "ompi_tpu_torch.tools.tpurun" if pkg == "torch" \
        else "ompi_tpu.tools.tpurun"
    p = subprocess.Popen(
        [sys.executable, "-m", launcher, "-n", "2", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=env, start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    return subprocess.CompletedProcess(p.args, p.returncode, out, err)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """One -n 2 job a package over btl/sm and one over btl/tcp, tracing and
    the stage clocks on: {(pkg, btl): (process, trace dir)}."""
    root = tmp_path_factory.mktemp("trace_jobs")
    script = root / "job.py"
    script.write_text(JOB)
    out = {}
    for btl, extra in (("sm", []), ("tcp", ["--mca", "btl", "tcp,self"])):
        for pkg in ("torch", "jax"):
            tdir = root / f"{pkg}_{btl}"
            out[(pkg, btl)] = (_tpurun(pkg, [
                *extra, "--mca", "otpu_trace_enable", "1",
                "--mca", "otpu_trace_dir", str(tdir),
                "--mca", "otpu_profile_stages", "1",
                sys.executable, str(script), pkg]), tdir)
    return out


def _rank_payloads(tdir):
    return [json.loads((tdir / f"trace_rank{r}.json").read_text())
            for r in range(2)]


def _flow_keys(tdir):
    keys = set()
    for p in _rank_payloads(tdir):
        for e in p["traceEvents"]:
            if e["ph"] in ("s", "f"):
                keys.add((p["metadata"]["rank"], e["ph"], e["name"],
                          e["id"]))
            elif e["cat"] == "pml" and "fid" in e.get("args", {}):
                keys.add((p["metadata"]["rank"], e["name"], "fid",
                          tuple(e["args"]["fid"])))
    return keys


@pytest.mark.parametrize("btl", ["sm", "tcp"])
def test_jobs_ran(jobs, btl):
    for pkg in ("torch", "jax"):
        proc, _ = jobs[(pkg, btl)]
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert proc.stdout.count("done 3.0") == 2, proc.stdout


@pytest.mark.parametrize("btl", ["sm", "tcp"])
def test_job_flow_keys_match(jobs, btl):
    got, want = (_flow_keys(jobs[(pkg, btl)][1]) for pkg in ("torch", "jax"))
    assert got == want
    assert any(k[2] == "pml_msg" for k in got)


@pytest.mark.parametrize("btl", ["sm", "tcp"])
def test_job_every_flow_start_has_its_finish(jobs, btl):
    merged = json.loads(
        (jobs[("torch", btl)][1] / "trace_merged.json").read_text())
    starts = Counter(e["id"] for e in merged["traceEvents"]
                     if e["ph"] == "s" and e["name"] == "pml_msg")
    finishes = Counter(e["id"] for e in merged["traceEvents"]
                       if e["ph"] == "f" and e["name"] == "pml_msg")
    assert starts and starts == finishes


@pytest.mark.parametrize("btl", ["sm", "tcp"])
def test_job_stage_names_match(jobs, btl):
    def stages(pkg):
        return [sorted(p["metadata"]["profile"]["stages"])
                for p in _rank_payloads(jobs[(pkg, btl)][1])]

    got = stages("torch")
    assert got == stages("jax")
    for names in got:
        assert {"send.pack", "send.queue", "send.wire", "recv.parse",
                "recv.deliver", "recv.complete"} <= set(names)


@pytest.mark.parametrize("btl", ["sm", "tcp"])
def test_job_merged_timeline_and_skew_report(jobs, btl):
    proc, tdir = jobs[("torch", btl)]
    assert "merged timeline of 2 ranks" in proc.stderr
    merged = json.loads((tdir / "trace_merged.json").read_text())
    assert merged["metadata"]["ranks"] == [0, 1]
    assert merged["metadata"]["clock"] == "coord-server"
    assert {e["pid"] for e in merged["traceEvents"]} == {0, 1}
    report = (tdir / "trace_skew.txt").read_text()
    assert report.startswith("otpu-trace skew report — 2 ranks (0, 1)")
    wire = "btl_ringpush" if btl == "sm" else "btl_sendmsg"
    for payload in _rank_payloads(tdir):
        assert any(e["name"] == wire for e in payload["traceEvents"])
        assert "clock_offset_us" in payload["metadata"]
