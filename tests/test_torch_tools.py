"""The operator tools and the last surfaces of the host tier, held against
the JAX package on the CPU:

* ``base/containers.py``: the reference suite's cases (``Fifo``, ``Lifo``,
  ``PointerArray``, ``Bitmap``, ``RingBuffer``, ``Hotel``,
  ``IntervalTree``, ``Graph``) on both packages, results equal;
* the template btl and pml: out of every job by default, and the enabled
  loopbacks deliver what the reference's deliver;
* ``otpu_perf``: ``--check``, ``--diff`` (an injected slowdown exits 3),
  ``--parsable`` and the summary on the same histories, output and exit
  codes equal; the default history is the port's own file;
* ``otpu_info``: each section lists the reference's rows, apart from the
  package name; ``--lint`` exits 2 (the static analyzer is not ported);
* ``otpu_top``: the table, the parsable rows and the stale flag from canned
  samples equal to the reference's, exit 2 on an unreachable coordination
  service, and one live attach to a port ``tpurun -n 2`` job;
* ``otpu_analyze``: equal reports on fixed payloads (a designed slow rank,
  message edges, per-request stages) and on the trace of that port job;
  ``--suggest-ladder`` drafts both packages' ``_load_rules`` read alike;
  ``--diff`` equal;
* ``cuda_aot``: its cases cover every C entry of ``_build.LIBRARIES`` and
  every Triton kernel of ``ops/``; without ``nvcc`` it exits non-zero with
  the reason and writes no row.
"""
import contextlib
import importlib
import io
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
PKGS = ("ompi_tpu", "ompi_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _both(fn):
    """``fn(pkg)`` for both packages; the results must be equal."""
    got = [fn(pkg) for pkg in PKGS]
    assert got[1] == got[0]
    return got[1]


def _run_main(main, argv) -> tuple:
    """(exit code, stdout) of a tool's ``main(argv)`` in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


# -- base/containers -------------------------------------------------------

def _fifo(c):
    f = c.Fifo()
    for i in range(5):
        f.push(i)
    return [f.pop() for _ in range(6)]


def _lifo(c):
    s = c.Lifo()
    for i in range(5):
        s.push(i)
    return [s.pop() for _ in range(6)], len(s)


def _pointer_array(c):
    pa = c.PointerArray(lowest_free=2)
    i = pa.add("x")
    j = pa.add("y")
    pa.remove(i)
    k = pa.add("z")
    return i, j, k, pa.get(j), dict(iter(pa)), len(pa)


def _bitmap(c):
    b = c.Bitmap(8)
    b.set(3)
    b.set(7)
    first = b.find_and_set_first_unset()
    b.clear(3)
    listed = list(b)
    b.set_all()
    return first, listed, b.is_set(3), b.popcount(), b.size


def _ring_buffer(c):
    r = c.RingBuffer(3)
    for i in range(5):
        r.push(i)
    snap = r.snapshot()
    return snap, r.pop(), len(r), r.snapshot()


def _hotel(c):
    evicted = []
    h = c.Hotel(2, eviction_s=0.0,
                on_evict=lambda room, occ: evicted.append((room, occ)))
    r1, r2 = h.checkin("a"), h.checkin("b")
    full = h.checkin("c")
    out = h.checkout(r1)
    n = h.sweep(now=time.monotonic() + 1)
    return r1, r2, full, out, n, evicted, len(h), h.checkout(r2)


def _interval_tree(c):
    t = c.IntervalTree()
    t.insert(0, 100, "big")
    t.insert(10, 20, "small")
    over = sorted(v for *_, v in t.find_overlapping(15, 30))
    small = t.find_containing(12, 18)[2]
    big = t.find_containing(50, 60)[2]
    t.delete(10, 20)
    return over, small, big, t.find_containing(12, 18)[2], len(t)


def _graph(c):
    g = c.Graph()
    g.add_edge("a", "b", 1)
    g.add_edge("b", "c", 1)
    g.add_edge("a", "c", 5)
    g.add_vertex("d")
    return (g.shortest_path("a", "c"), g.shortest_path("c", "a"),
            g.shortest_path("a", "d"), sorted(g.vertices()),
            dict(g.neighbors("a")))


CONTAINER_CASES = {"fifo": (_fifo, [0, 1, 2, 3, 4, None]),
                   "lifo": (_lifo, ([4, 3, 2, 1, 0, None], 0)),
                   "pointer_array": (_pointer_array, None),
                   "bitmap": (_bitmap, (0, [0, 7], True, 8, 8)),
                   "ring_buffer": (_ring_buffer, ([2, 3, 4], 2, 2, [3, 4])),
                   "hotel": (_hotel, (0, 1, -1, "a", 1, [(1, "b")], 0,
                                      None)),
                   "interval_tree": (_interval_tree,
                                     (["big", "small"], "small", "big",
                                      "big", 1)),
                   "graph": (_graph, (["a", "b", "c"], None, None,
                                      ["a", "b", "c", "d"],
                                      {"b": 1, "c": 5}))}


@pytest.mark.parametrize("case", sorted(CONTAINER_CASES))
def test_containers_match_reference(case):
    """The reference suite's container cases: the port's results equal the
    JAX package's, and the suite's expected values."""
    fn, want = CONTAINER_CASES[case]
    got = _both(lambda pkg: fn(_mod(pkg, "base.containers")))
    if want is not None:
        assert got == want
    else:
        assert got[:4] == (2, 3, 2, "y") and got[4] == {3: "y", 2: "z"}


# -- the template btl and pml ----------------------------------------------

@pytest.fixture
def fresh_frameworks():
    from ompi_tpu.runtime import init as jrt
    from ompi_tpu_torch.runtime import init as trt

    for rt in (jrt, trt):
        rt.reset_for_testing()
    _mod("ompi_tpu", "base.mca").reset_for_testing()
    yield
    for rt in (jrt, trt):
        rt.reset_for_testing()
    _mod("ompi_tpu", "base.mca").reset_for_testing()


def _framework(pkg: str, name: str, **kw):
    """A framework of ``pkg`` made to open anew (the port keeps one per
    name; the JAX package's were reset by the fixture)."""
    fw = _mod(pkg, "base.mca").framework(name, **kw)
    fw.close()
    return fw


@pytest.mark.parametrize("name", ["btl", "pml"])
def test_templates_out_of_jobs_by_default(fresh_frameworks, name):
    def run(pkg):
        fw = _framework(pkg, name, multi_select=name == "btl")
        fw.open()
        avail = sorted(c.name for c in fw.available)
        picked = fw.select().name if name == "pml" else None
        prio = fw.components["template"].priority
        fw.close()
        return avail, picked, prio

    avail, picked, prio = _both(run)
    assert "template" not in avail and prio == -1
    assert picked in (None, "ob1")


def test_template_btl_loopback_matches(fresh_frameworks):
    def run(pkg):
        registry = _mod(pkg, "base.var").registry
        frag_cls = _mod(pkg, "mca.btl.base").Frag
        tpl = _mod(pkg, "mca.btl.template").COMPONENT
        fw = _framework(pkg, "btl", multi_select=True)
        fw.discover()
        registry.set("otpu_btl_template_enable", True)
        try:
            fw.open()
            enabled = tpl in fw.available

            class FakeRte:
                my_world_rank = 0
                is_device_world = False

            got = []
            tpl.set_recv_callback(got.append)
            tpl.setup(FakeRte())
            ep = tpl.reachable(0, FakeRte())
            far = tpl.reachable(1, FakeRte())
            for tag, data in ((7, b"hi"), (8, bytes(range(40)))):
                tpl.send(ep, frag_cls(0, 0, 0, tag, 0, 0, data))
            before = len(got)
            made = tpl.progress()
            out = [(f.tag, bytes(f.data)) for f in got]
            limits = (tpl.eager_limit, tpl.rndv_eager_limit,
                      tpl.max_send_size, tpl.latency, tpl.bandwidth)
            tpl.close()
            fw.close()
            return enabled, far, before, made, out, limits
        finally:
            registry.set("otpu_btl_template_enable", False)

    enabled, far, before, made, out, _ = _both(run)
    assert enabled and far is None and before == 0 and made == 2
    assert out == [(7, b"hi"), (8, bytes(range(40)))]


def test_template_pml_loopback_matches(fresh_frameworks):
    def run(pkg):
        registry = _mod(pkg, "base.var").registry
        tpl = _mod(pkg, "mca.pml.template").COMPONENT
        fw = _framework(pkg, "pml")
        fw.discover()
        registry.set("otpu_pml_template_enable", True)
        try:
            fw.open()
            enabled = tpl in fw.available

            class FakeComm:
                cid = 0
                rank = 0

            pml = tpl.get_module(rte=None)
            comm = FakeComm()
            pml.add_comm(comm)
            data = np.arange(6, dtype=np.float32)
            pml.send(comm, data, dest=0, tag=9)
            pml.send(comm, data[::-1].copy(), dest=0, tag=4)
            a = np.zeros(6, np.float32)
            st_a = pml.recv(comm, a, source=-1, tag=4)
            b = np.zeros(6, np.float32)
            st_b = pml.irecv(comm, b, source=0, tag=-1).wait()
            errors = []
            for call in (lambda: pml.isend(comm, data, dest=1, tag=0),
                         lambda: pml.recv(comm, a, source=0, tag=1)):
                with pytest.raises(RuntimeError) as e:
                    call()
                errors.append(str(e.value))
            pml.finalize()
            fw.close()
            return (enabled, a.tolist(), b.tolist(),
                    [(s.MPI_SOURCE, s.MPI_TAG, s.count) for s in (st_a, st_b)],
                    errors)
        finally:
            registry.set("otpu_pml_template_enable", False)

    enabled, a, b, statuses, errors = _both(run)
    assert enabled and a == [5, 4, 3, 2, 1, 0] and b == [0, 1, 2, 3, 4, 5]
    assert statuses == [(0, 4, 6), (0, 9, 6)] and len(errors) == 2


# -- otpu_perf ---------------------------------------------------------------

def _row(run, t, key, lat, kind="bench", **extra):
    row = {"v": 1, "kind": kind, "run": run, "t": t, "lat_us": lat, "k": 3}
    row.update({"key": key} if kind == "bench" else extra)
    return row


def _history(scenario: str) -> list:
    rng = np.random.default_rng(25)
    rows = []
    for i, run in enumerate(("r1", "r2", "r3", "r4")):
        for key in ("allreduce_8B", "allreduce_16MB", "bcast_4MB"):
            lat = float(100 + 20 * rng.random())
            if scenario == "slow" and run == "r4" and key == "bcast_4MB":
                lat *= 10.0
            rows.append(_row(run, i, key, lat))
        rows.append(_row(run, i, None, float(50 + rng.random()),
                         kind="ladder", topology="1x4", coll="allreduce",
                         nbytes=4096, algorithm="ring"))
    if scenario == "new_key":
        rows.append(_row("r4", 3, "gather_1MB", 80.0))
    return rows


PERF_CASES = {
    "diff_clean": ("clean", ["--diff"]),
    "diff_slowdown": ("slow", ["--diff"]),
    "diff_slowdown_parsable": ("slow", ["--diff", "--parsable"]),
    "diff_new_key": ("new_key", ["--diff", "--window", "2"]),
    "diff_ladder": ("clean", ["--diff", "--kind", "ladder"]),
    "check_ok": ("clean", ["--check"]),
    "check_malformed": ("malformed", ["--check"]),
    "summary": ("clean", []),
    "missing_file": ("missing", []),
    "missing_file_check": ("missing", ["--check"]),
}


@pytest.mark.parametrize("case", sorted(PERF_CASES))
def test_otpu_perf_matches_reference(case, tmp_path):
    scenario, flags = PERF_CASES[case]
    path = tmp_path / "history.jsonl"
    if scenario == "malformed":
        path.write_text(json.dumps(_row("r1", 0, "x", 10.0)) + "\nnot json\n"
                        + json.dumps({"v": 9, "kind": "bench"}) + "\n")
    elif scenario != "missing":
        path.write_text("".join(json.dumps(r) + "\n"
                                for r in _history(scenario)))
    rc, out = _both(lambda pkg: _run_main(
        _mod(pkg, "tools.otpu_perf").main, [str(path), *flags]))
    want = {"diff_slowdown": 3, "diff_slowdown_parsable": 3,
            "check_malformed": 1, "missing_file": 1,
            "missing_file_check": 1}.get(case, 0)
    assert rc == want, out
    if case == "diff_slowdown":
        assert "REGRESSED" in out and "regressions: 1" in out


def test_otpu_perf_default_history_is_the_ports(monkeypatch, tmp_path):
    """The default history is the port's own ``BENCH_CUDA_HISTORY.jsonl``
    at the repo root, never the JAX package's; a missing default file
    behaves as the reference does on a missing file."""
    from ompi_tpu.tools import otpu_perf as jperf
    from ompi_tpu_torch.tools import otpu_perf as tperf

    assert Path(tperf.DEFAULT_HISTORY) == REPO / "BENCH_CUDA_HISTORY.jsonl"
    assert Path(jperf.DEFAULT_HISTORY) == REPO / "BENCH_HISTORY.jsonl"
    missing = tmp_path / "BENCH_CUDA_HISTORY.jsonl"
    monkeypatch.setattr(tperf, "DEFAULT_HISTORY", str(missing))
    for flags in ([], ["--check"], ["--diff"]):
        assert _run_main(tperf.main, flags) == _run_main(
            jperf.main, [str(missing), *flags])
    assert tperf.self_test() is None and tperf.SCHEMA_V == jperf.SCHEMA_V


# -- otpu_info ---------------------------------------------------------------

def _info_keys(pkg: str, flags: list) -> tuple:
    """(exit code, the rows' keys) of ``otpu_info flags`` but the package
    rows and the component rows (``mca <framework>``: the JAX-only
    components are not the port's, ROADMAP A's map)."""
    rc, out = _run_main(_mod(pkg, "tools.otpu_info").main, flags)
    keys = [ln.split(":", 1)[0] for ln in out.splitlines()
            if not ln.startswith(("package:", "version:"))]
    return rc, sorted(k for k in keys if not re.fullmatch(r"mca \w+", k))


@pytest.mark.parametrize("flags", [
    ["--param", "coll", "tuned"], ["--param", "btl", "tcp", "--parsable"],
    ["--parsable", "--telemetry"], ["--parsable", "--trace"],
    ["--parsable", "--serving"], ["--parsable", "--profile"],
    ["--parsable", "--quant"], ["--parsable", "--moe"],
    ["--parsable", "--psets"]], ids=lambda f: "_".join(
        x.strip("-") for x in f))
def test_otpu_info_sections_match_reference(flags):
    """The section lists the reference's rows (var names, schema keys,
    categories, stages, counters, psets)."""
    rc, keys = _both(lambda pkg: _info_keys(pkg, flags))
    assert rc == 0 and keys


def test_otpu_info_all_and_package():
    """``--all --parsable`` has the reference's sections but lint's; the
    package row names the port; ``--lint`` exits 2 with the reason."""
    from ompi_tpu_torch.tools import otpu_info

    def sections(pkg):
        rc, keys = _info_keys(pkg, ["--all", "--parsable"])
        # a row's section: the key without its last word (the item)
        return rc, sorted({k.rsplit(" ", 1)[0] for k in keys
                           if not k.startswith("lint pass")})

    rc, secs = _both(sections)
    assert rc == 0 and "mca var" in secs and "pvar" in secs
    rc, out = _run_main(otpu_info.main, ["--parsable"])
    assert rc == 0 and out.splitlines()[0] == (
        "package:ompi_tpu_torch (PyTorch/CUDA MPI)")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert _run_main(otpu_info.main, ["--lint"]) == (2, "")
    assert "not ported" in err.getvalue()
    mca_names = {ln.split(":", 2)[1].split(" (")[0]
                 for ln in _run_main(otpu_info.main, ["--parsable"])[1]
                 .splitlines() if ln.startswith("mca pml")}
    assert mca_names == {"ob1", "template"}


# -- otpu_top ----------------------------------------------------------------

def _samples(now: float) -> dict:
    hist = {"allreduce": {"n": 40, "bytes": 163840, "p50_us": 812.0,
                          "p99_us": 2210.0},
            "bcast": {"n": 4, "bytes": 4096, "p50_us": 90.0, "p99_us": 95.0}}
    full = {"seq": 7, "t": now, "rank": 0, "interval_ms": 100,
            "spc_delta": {"send": 30, "recv": 29, "allreduce": 4,
                          "bytes_sent": 123456},
            "hist": hist, "tcp": {"outq_frags": 3},
            "staging": {"bytes": 2 << 20}, "serving": {"queued": 5},
            "chaos": {"delay": 4, "drop": 1},
            "profile": {"host_us": 25000.0, "gil_released": 0.42},
            "fleet": {"pools": {"m_a": {"queued": 2, "prefix": {
                "hits": 13, "misses": 2}}, "m_b": {"queued": 1}}},
            "slo": {"pools": {"m_a": {"t0": {"burn": 0.6},
                                      "t1": {"burn": 1.4}}}},
            "frontdoor": {"queued": {"m_a": 2, "m_b": 1}, "shed": 14,
                          "holds": ["m_a"]}}
    plain = {"seq": 3, "t": now, "rank": 1, "interval_ms": 100,
             "spc_delta": {"isend": 5}}
    old = {"seq": 9, "t": now - 100.0, "rank": 2, "interval_ms": 100}
    return {0: full, 1: plain, 2: old, 3: None}


class _CannedClient:
    def __init__(self, samples):
        self.samples = samples

    def get(self, rank, key, wait=False):
        s = self.samples.get(rank)
        return json.dumps(s) if s is not None else None


def test_otpu_top_rendering_matches_reference():
    """The table and the parsable rows of canned samples, the stale flag
    (no sample, an old sample, a sequence number that stopped) equal to
    the reference's."""
    def render(pkg):
        top = _mod(pkg, "tools.otpu_top")
        assert top._KV_KEY == "otpu_telemetry"
        canned = _samples(time.time())
        session = top.TopSession(_CannedClient(canned), 4)
        first = session.poll()
        canned[0] = dict(canned[0], seq=8)
        second = session.poll()
        out = [top.render_table(session, s, coll, parsable)
               for s in (first, second) for coll in ("allreduce", "bcast")
               for parsable in (False, True)]
        # rank 1 stops advancing: stale once two intervals have passed
        session._last_advance[1] -= 1.0
        stale = [session.stale(r, second[r]) for r in range(4)]
        return out, stale

    out, stale = _both(render)
    assert stale == [False, True, True, True]
    assert "q3/87%" in out[0] and "1.4x" in out[0] and "d3/s14!" in out[0]
    assert out[1].splitlines()[3] == "3:-:-:-:-:-:-:-:-:-:-:1"


def test_otpu_top_unreachable_coord_exits_2():
    from ompi_tpu_torch.tools.tpurun import _free_port

    port = _free_port()

    def run(pkg):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc, out = _run_main(_mod(pkg, "tools.otpu_top").main,
                                ["--coord", f"127.0.0.1:{port}"])
        return rc, out, "cannot reach coordination service" in err.getvalue()

    assert _both(run) == (2, "", True)


@pytest.fixture(scope="module")
def port_job(tmp_path_factory):
    """One live port job: ``tpurun -n 2`` of ``otpu_top_demo``'s worker for
    3 s on the CPU with telemetry and tracing on; ``otpu_top --json --count
    1`` attached from outside until every rank shows a new sample."""
    from ompi_tpu_torch.examples import otpu_top_demo as demo
    from ompi_tpu_torch.tools import otpu_top
    from ompi_tpu_torch.tools.tpurun import _free_port

    tdir = tmp_path_factory.mktemp("otpu_job")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("OTPU_RANK", "OTPU_NPROCS", "OTPU_COORD")}
    job = subprocess.Popen(
        demo.job_argv(port, str(tdir / "trace"), "cpu", 3.0, nprocs=2),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(REPO))
    polls, seen, fresh = [], {}, set()
    try:
        deadline = time.monotonic() + 60
        while len(fresh) < 2 and time.monotonic() < deadline \
                and job.poll() is None:
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc, out = _run_main(otpu_top.main, [
                    "--coord", f"127.0.0.1:{port}", "--json", "--count", "1"])
            if rc == 2 or not out.strip():
                time.sleep(0.2)        # not listening yet
                continue
            poll = json.loads(out.strip().splitlines()[-1])
            polls.append(poll)
            for rank, sample in poll["ranks"].items():
                if sample is not None:
                    if rank in seen and sample["seq"] > seen[rank]:
                        fresh.add(rank)
                    seen.setdefault(rank, sample["seq"])
            time.sleep(0.15)
        out, err = job.communicate(timeout=120)
    finally:
        if job.poll() is None:
            job.kill()
            job.wait()
    return {"rc": job.returncode, "out": out, "err": err, "polls": polls,
            "fresh": fresh, "trace": tdir / "trace"}


def test_otpu_top_attaches_to_a_port_job(port_job):
    assert port_job["rc"] == 0, port_job["out"][-2000:] + port_job["err"][-2000:]
    assert port_job["fresh"] == {"0", "1"}, port_job["polls"][-1:]
    last = port_job["polls"][-1]
    assert last["nprocs"] == 2 and set(last["ranks"]) == {"0", "1"}
    ranks = [json.loads(ln.split("OTPU TOP DEMO WORKER ", 1)[1])
             for ln in port_job["out"].splitlines()
             if "OTPU TOP DEMO WORKER " in ln]
    assert sorted(r["rank"] for r in ranks) == [0, 1]
    assert all(r["exact"] and r["steps"] > 0 and r["launches"] == {}
               for r in ranks)          # the CPU lane launches no kernel


# -- otpu_analyze --------------------------------------------------------------

def _span(pid, name, cat, ts, dur, args=None):
    e = {"ph": "X", "pid": pid, "tid": 1, "name": name, "cat": cat,
         "ts": float(ts), "dur": float(dur)}
    if args:
        e["args"] = args
    return e


def _slow_rank_timeline(steps=6, slow=2, nranks=3, nbytes=4096):
    events = []
    for k in range(steps):
        t0 = k * 125.0
        for r in range(nranks):
            late = r == slow
            events.append(_span(r, "step", "step", t0,
                                121.0 if late else 122.0, {"step": k}))
            events.append(_span(r, "allreduce", "coll",
                                t0 + (100 if late else 10),
                                20.0 if late else 110.0,
                                {"cid": 0, "cseq": k, "nbytes": nbytes}))
            events.append(_span(r, "bcast", "coll", t0 + 121.5, 2.0 + r,
                                {"cid": 1, "cseq": k, "nbytes": 1 << 20}))
    return sorted(events, key=lambda e: e["ts"])


def _message_timeline(steps=4):
    events = []
    for k in range(steps):
        t0 = k * 1000.0
        events.append(_span(0, "step", "step", t0, 205.0, {"step": k}))
        events.append(_span(0, "send", "pml", t0 + 190, 10.0,
                            {"cid": 0, "fid": [0, 0, 1, k], "nbytes": 4096}))
        events.append(_span(1, "step", "step", t0, 206.0, {"step": k}))
        events.append(_span(1, "recv", "pml", t0 + 2, 200.0,
                            {"cid": 0, "fid": [0, 0, 1, k], "nbytes": 4096}))
    return sorted(events, key=lambda e: e["ts"])


_STAGE_SPANS = ("req_queue", "req_dispatch", "req_prefill", "req_kv",
                "req_decode", "req_stream")


def _request_timeline(n=40, seed=25):
    """Per-request stage spans (router rank 0, workers 1 and 2) and each
    request's flow arrows; a few requests lose a stage or a flow half."""
    rng = np.random.default_rng(seed)
    events = []
    for rid in range(n):
        t = float(rid * 500)
        worker = 1 + rid % 2
        tenant = f"t{rid % 3}"
        durs = rng.uniform(5, 60, size=6) * (8 if rid % 11 == 0 else 1)
        for stage, d in zip(_STAGE_SPANS, durs):
            if rid == 7 and stage == "req_prefill":
                continue                     # not reconstructable
            pid = worker if stage in ("req_prefill", "req_kv") else 0
            events.append(_span(pid, stage, "serve_req", t, float(d),
                                {"rid": rid, "tenant": tenant, "pool": "m_a",
                                 "worker": worker}))
            t += float(d)
        for hop in range(2 if rid != 9 else 1):
            events.append({"ph": "s", "pid": 0, "tid": 1, "name": "serve_req",
                           "cat": "serve_req", "id": f"{rid}.{hop}",
                           "ts": float(rid * 500 + hop)})
            if not (rid == 13 and hop == 1):
                events.append({"ph": "f", "pid": worker, "tid": 1,
                               "name": "serve_req", "cat": "serve_req",
                               "id": f"{rid}.{hop}", "bp": "e",
                               "ts": float(rid * 500 + hop + 3)})
    return sorted(events, key=lambda e: e["ts"])


ANALYZE_CASES = {
    "slow_rank": lambda: (_slow_rank_timeline(), {"critical_path": True}),
    "slow_rank_1": lambda: (_slow_rank_timeline(slow=1, nbytes=1 << 18),
                            {"critical_path": True}),
    "messages": lambda: (_message_timeline(), {"critical_path": True}),
    "requests": lambda: (_request_timeline(), {"requests": True,
                                               "slo_ms": 0.2}),
    "no_steps": lambda: ([_span(0, "allreduce", "coll", 0.0, 5.0,
                                {"cid": 0, "cseq": 0, "nbytes": 64}),
                          _span(1, "allreduce", "coll", 1.0, 4.0,
                                {"cid": 0, "cseq": 0, "nbytes": 64})],
                         {"critical_path": True}),
}


def _analyze(pkg, events, kw):
    oa = _mod(pkg, "tools.otpu_analyze")
    rep = oa.analyze(json.loads(json.dumps(events)), **kw)
    return json.loads(json.dumps(rep)), oa.render_text(rep), oa.render_text(
        rep, parsable=True)


@pytest.mark.parametrize("case", sorted(ANALYZE_CASES))
def test_otpu_analyze_reports_match_reference(case):
    events, kw = ANALYZE_CASES[case]()
    rep, _, _ = _both(lambda pkg: _analyze(pkg, events, kw))
    if case == "slow_rank":
        assert rep["critical_path"]["bound_by"]["rank"] == 2
    if case == "requests":
        assert rep["requests"]["decomposed"] == 39


def _write_payloads(tmp_path, events) -> Path:
    """The events as per-rank trace payloads, as a job's ranks write them."""
    d = tmp_path / "trace"
    d.mkdir()
    for pid in sorted({e["pid"] for e in events}):
        (d / f"trace_rank{pid}.json").write_text(json.dumps(
            {"traceEvents": [e for e in events if e["pid"] == pid],
             "metadata": {"rank": pid, "dropped": 0}}))
    return d


def test_otpu_analyze_cli_and_ladder_match_reference(tmp_path):
    """The CLI over the same payload files: the JSON report, the text, the
    ``--suggest-ladder`` draft (both packages' ``_load_rules`` read it
    alike, and the port's loader reads the reference's draft) and
    ``--diff``."""
    d = _write_payloads(tmp_path, _slow_rank_timeline())

    def cli(pkg):
        oa = _mod(pkg, "tools.otpu_analyze")
        rep, ladder = tmp_path / f"{pkg}.json", tmp_path / f"{pkg}.rules"
        rc, text = _run_main(oa.main, [str(d), "--critical-path",
                                       "--suggest-ladder", str(ladder),
                                       "--json", str(rep)])
        return rc, text, json.loads(rep.read_text())

    rc, text, rep = _both(cli)
    assert rc == 0 and rep["critical_path"]["bound_by"]["rank"] == 2
    loads = {}
    for pkg in PKGS:
        tuned = _mod(pkg, "mca.coll.tuned")
        loads[pkg] = [tuned._load_rules(str(tmp_path / f"{p}.rules"))
                      for p in PKGS]
    assert loads["ompi_tpu_torch"] == loads["ompi_tpu"]
    rules = loads["ompi_tpu_torch"][1]
    assert {r[0] for r in rules} == {"allreduce", "bcast"}
    assert all(r[1] == 3 for r in rules)
    old = tmp_path / "old.json"
    old.write_text(json.dumps(_analyze("ompi_tpu", _slow_rank_timeline(
        slow=1), {"critical_path": True})[0]))
    got = _both(lambda pkg: _run_main(_mod(pkg, "tools.otpu_analyze").main,
                                      [str(d), "--critical-path", "--diff",
                                       str(old)]))
    assert got[0] == 0 and "straggler" in got[1]


def test_otpu_analyze_reads_a_port_job_alike(port_job):
    """The trace files the live port job wrote, through both analyzers:
    the same report, critical path and requests section included."""
    assert port_job["rc"] == 0
    merged = port_job["trace"] / "trace_merged.json"
    assert merged.exists()

    def run(pkg):
        oa = _mod(pkg, "tools.otpu_analyze")
        events, profiles, meta = oa.load_run([str(port_job["trace"])])
        rep = oa.analyze(events, profiles=profiles, meta=meta,
                         critical_path=True)
        # the rules and their measured annotations (the header's prose
        # names each package's benchmark)
        text = oa.suggest_ladder(rep, comm_size=2)
        return json.loads(json.dumps(rep)), [
            ln for ln in text.splitlines()
            if not ln.startswith("#") or ln.startswith("# critical_us")]

    rep, ladder = _both(run)
    assert rep["critical_path"]["steps"] and sorted(map(str, rep["ranks"])) == ["0", "1"]
    assert any(not ln.startswith("#") for ln in ladder)


# -- cuda_aot --------------------------------------------------------------------

def test_cuda_aot_cases_cover_every_kernel():
    """Every C entry of ``_build.LIBRARIES`` has a case (the kernels it
    launches), no case names an entry that is gone, and every Triton
    kernel of ``ops/`` (a ``triton.jit`` source that reads its program id)
    has cases for each op and dtype the port launches it with."""
    from ompi_tpu_torch.ops import _build, reduce
    from ompi_tpu_torch.tools import cuda_aot

    entries = {e for _src, fns in _build.LIBRARIES.values() for e in fns}
    assert set(cuda_aot.C_ENTRIES) == entries
    for lib, (source, fns) in _build.LIBRARIES.items():
        text = (_build.CSRC / source).read_text()
        for frags in (cuda_aot.C_ENTRIES[e] for e in fns):
            for frag in frags:
                assert re.search(rf"\b{frag}\b", text + "".join(
                    p.read_text() for p in _build.CSRC.glob("*.cuh"))), frag
    kernels = set()
    for path in (REPO / "ompi_tpu_torch" / "ops").glob("*.py"):
        text = path.read_text()
        for src in re.findall(r"triton\.jit\((\w+)\)", text):
            body = text[text.index(f"def {src}("):]
            body = body[:body.index("\ndef ", 1)]
            if "program_id" in body:
                kernels.add(src)
    assert kernels == set(cuda_aot.TRITON_KERNELS)
    cases = cuda_aot.triton_cases()
    assert {k for k, _m, _c in cases} == kernels
    folds = {(op, str(dt).replace("torch.", ""))
             for op in reduce.supported_ops() for dt in reduce._KERNEL_DTYPES
             if reduce.device_fold(op, dt) is not None}
    for src in ("_combine2_src", "_stack_src"):
        assert {(c["op"], c["dtype"]) for k, _m, c in cases
                if k == src} == folds
    assert len({cuda_aot._case_name(k, c) for k, _m, c in cases}) == len(cases)


def test_cuda_aot_reads_ptxas_and_holds_the_requirements():
    """The ``-Xptxas -v`` parser on the report's form, and the smoke's
    requirements: they pass on a build that meets them and name each
    failure."""
    from ompi_tpu_torch.tools import cuda_aot

    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z12mover_kernel8PairCopy' for 'sm_90a'
ptxas info    : Function properties for _Z12mover_kernel8PairCopy
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 384 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, 360 bytes cmem[0]
"""
    got = cuda_aot.parse_ptxas(log)
    assert got == {
        "_Z12mover_kernel8PairCopy": {"registers": 40, "shared_bytes": 384,
                                      "stack_bytes": 0, "spill_stores": 0,
                                      "spill_loads": 0},
        "_Z3fooPf": {"registers": 255, "shared_bytes": 0, "stack_bytes": 16,
                     "spill_stores": 8, "spill_loads": 4}}

    def row(lib, name, spill=0, **sass):
        return {"kernel": name, "library": lib, "route": "cuda",
                "compiled": True, "registers": 32, "shared_bytes": 0,
                "stack_bytes": spill, "spill_bytes": spill, "sass": sass}

    good = ([row("fused_matmul", "_Z18fused_matmul_wgmma", HGMMA=64,
                 UTMALDG=4), row("fused_matmul", "_Z16fused_matmul_f32",
                                 spill=8)]
            + [row(lib, f"_Z12mover_kernelILi{i}E", UBLKCP=2)
               for lib in ("ring_copy", "exchange") for i in (0, 1)]
            + [row("flash_block", f"_Z18flash_block_kernelILi{i}E", FFMA=9,
                   **{"LDS.128": 3, "LDGSTS": 2}) for i in range(8)])
    assert cuda_aot.requirements(good) == []
    bad = [dict(r) for r in good]
    bad[2] = row("ring_copy", "_Z12mover_kernelILi0E", spill=4, UBLKCP=2)
    bad[-1] = row("flash_block", "_Z18flash_block_kernelILi7E", FFMA=9)
    problems = cuda_aot.requirements(bad)
    assert len(problems) == 2
    assert "copy kernel spills" in problems[0]
    assert "flash_block_kernel" in problems[1]


def test_cuda_aot_without_nvcc_exits_with_the_reason(tmp_path):
    """No ``nvcc`` on the path nor under ``CUDA_HOME``: a non-zero exit
    with the reason, no row, no report file."""
    out = tmp_path / "report.json"
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME=str(tmp_path), CUDA_PATH=str(tmp_path))
    r = subprocess.run([sys.executable, "-m", "ompi_tpu_torch.tools.cuda_aot",
                        "--out", str(out)], capture_output=True, text=True,
                       timeout=120, cwd=str(REPO), env=env)
    assert r.returncode != 0 and r.stdout == "" and not out.exists()
    assert "nvcc not found" in r.stderr
