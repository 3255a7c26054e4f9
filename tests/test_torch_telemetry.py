"""The port's live telemetry sampler (``runtime/telemetry.py``) and its
component sources, held against the JAX package's.

The declared schema, the source registry's checks (a name outside the
schema or a built-in key raises; a bound method is held weakly and drops
out with its owner) and ``SloAccountant``'s accounting are compared
between the packages.  Each package's ``Sampler`` builds the same built-in
keys and the same histogram deltas from the same trace records, and, armed
against a coordination server in this process, publishes samples into its
KV space under the reference's key on its own client and stops cleanly.
One ``tpurun -n 2`` job a package with coll/tuned's ladder, the stage clocks,
the sampling profiler and the sampler on reads back its own published
sample, one taken after its traffic: the same sample keys and the same
stage names (``coll.decide`` and ``coll.alg`` among them) in both.  Every subprocess has its own
``timeout=``.
"""
import json
import os
import signal
import subprocess
import sys
import time
import weakref
from pathlib import Path
from types import SimpleNamespace

import pytest

from ompi_tpu.base.var import VarType as JVarType
from ompi_tpu.base.var import registry as jreg
from ompi_tpu.rte import coord as jcoord
from ompi_tpu.runtime import progress as jprogress
from ompi_tpu.runtime import telemetry as jtele
from ompi_tpu.runtime import trace as jtrace
from ompi_tpu_torch.base.var import VarType as TVarType
from ompi_tpu_torch.base.var import registry as treg
from ompi_tpu_torch.rte import coord as tcoord
from ompi_tpu_torch.runtime import progress as tprogress
from ompi_tpu_torch.runtime import telemetry as ttele
from ompi_tpu_torch.runtime import trace as ttrace

REPO = Path(__file__).resolve().parent.parent
PKGS = {
    "jax": SimpleNamespace(tele=jtele, reg=jreg, coord=jcoord, trace=jtrace,
                           progress=jprogress, VarType=JVarType),
    "torch": SimpleNamespace(tele=ttele, reg=treg, coord=tcoord,
                             trace=ttrace, progress=tprogress,
                             VarType=TVarType)}
BUILTIN = ["hist", "interval_ms", "rank", "seq", "spc", "spc_delta", "t"]


def _both(fn):
    got = {name: fn(ns) for name, ns in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def test_schema_is_the_references():
    for name in ("SCHEMA", "_BUILTIN", "_KV_KEY", "SLO_BUDGET"):
        assert getattr(ttele, name) == getattr(jtele, name), name
    assert sorted(ttele._BUILTIN) == BUILTIN


@pytest.mark.parametrize("bad", ["seq", "hist", "not_a_key"])
def test_a_source_outside_the_schema_raises(bad):
    def run(ns):
        with pytest.raises(ValueError) as ei:
            ns.tele.register_source(bad, lambda: {})
        return str(ei.value)

    assert "not a declared SCHEMA key" in _both(run)


def test_bound_sources_are_held_weakly():
    class Owner:
        def stats(self):
            return {"depth": 3}

    def run(ns):
        owner = Owner()
        ns.tele.register_source("serving", owner.stats)
        ns.tele.register_source("chaos", lambda: {"drops": 1})
        with ns.tele._lock:
            weak = isinstance(ns.tele._sources["serving"],
                              weakref.WeakMethod)
        first = ns.tele.Sampler(0, 100)._sample_once()
        del owner
        second = ns.tele.Sampler(0, 100)._sample_once()
        with ns.tele._lock:
            gone = "serving" not in ns.tele._sources
        ns.tele.unregister_source("chaos")
        return (weak, first.get("serving"), first.get("chaos"),
                "serving" in second, gone)

    assert _both(run) == (True, {"depth": 3}, {"drops": 1}, False, True)


def test_sample_builtins_and_histogram_deltas_match(tmp_path):
    for ns in PKGS.values():
        ns.reg.set("otpu_trace_dir", str(tmp_path))
        ns.reg.set("otpu_trace_enable", True)
        ns.trace.reset_for_testing()
    try:
        def run(ns):
            s = ns.tele.Sampler(5, 250)
            for dur in (1000, 5000, 90000):
                ns.trace.hist_record("allreduce", 4096, dur)
            first = s._sample_once()
            ns.trace.hist_record("bcast", 64, 700)
            second = s._sample_once()
            third = s._sample_once()
            return ([sorted(k for k in x if k in BUILTIN)
                     for x in (first, second)],
                    [(x["seq"], x["rank"], x["interval_ms"], x["hist"])
                     for x in (first, second, third)])

        keys, samples = _both(run)
        assert keys == [BUILTIN, BUILTIN]
        assert samples[0][3]["allreduce"]["n"] == 3
        assert list(samples[1][3]) == ["bcast"] and samples[2][3] == {}
    finally:
        for ns in PKGS.values():
            ns.reg.set("otpu_trace_enable", False)
            ns.trace.reset_for_testing()


def test_sampler_publishes_on_its_own_client_and_stops(monkeypatch):
    def run(ns):
        server = ns.coord.CoordServer(1)
        host, port = server.addr
        monkeypatch.setenv("OTPU_COORD", f"{host}:{port}")
        client = ns.coord.CoordClient()
        ns.reg.set("otpu_telemetry_interval_ms", 20)
        try:
            rte = SimpleNamespace(client=client, my_world_rank=0)
            out = [ns.tele.start(rte), ns.tele.start(rte), ns.tele.enabled]
            deadline = time.time() + 10
            got = {}
            while time.time() < deadline:
                got = server.collect(ns.tele._KV_KEY)
                if got and json.loads(got[0])["seq"] >= 2:
                    break
                time.sleep(0.02)
            sample = json.loads(got[0])
            thread = ns.tele._sampler._thread
            ns.tele.stop()
            out += [sorted(got), sorted(k for k in sample if k in BUILTIN),
                    sample["rank"], sample["interval_ms"],
                    thread.is_alive(), ns.tele.enabled, ns.tele._sampler]
            return out
        finally:
            ns.tele.stop()
            ns.reg.set("otpu_telemetry_interval_ms", 0)
            client.close()
            server.close()
            monkeypatch.delenv("OTPU_COORD")

    assert _both(run) == [True, True, True, [0], BUILTIN, 0, 20, False,
                          False, None]


def test_no_sampler_without_an_interval_or_a_client():
    def run(ns):
        off = ns.tele.start(SimpleNamespace(client=object(),
                                            my_world_rank=0))
        ns.reg.set("otpu_telemetry_interval_ms", 50)
        try:
            no_client = ns.tele.start(SimpleNamespace(my_world_rank=0))
        finally:
            ns.reg.set("otpu_telemetry_interval_ms", 0)
        return off, no_client, ns.tele.enabled, ns.tele._sampler

    assert _both(run) == (False, False, False, None)


def _slo_target(ns):
    var = ns.reg.lookup("otpu_serving_slo_p99_ms")
    if var is None:
        var = ns.reg.register("serving", None, "slo_p99_ms",
                              vtype=ns.VarType.FLOAT, default=0.0)
    return var


def test_slo_accountant_matches():
    def run(ns):
        acct = ns.tele.SloAccountant()
        inert = [acct.observe("p", "t", 5.0), acct.snapshot()]
        _slo_target(ns).set(10.0)
        try:
            ok = [acct.observe(pool, tenant, dur) for pool, tenant, dur in (
                ("a", "x", 4.0), ("a", "x", 12.0), ("a", "y", 9.9),
                ("b", "", 30.0), ("b", "", 1.0))]
            snap = acct.snapshot()
            for tenants in snap["pools"].values():
                for row in tenants.values():
                    row.pop("goodput_rps")
            acct.reset()
            return inert, ok, snap, acct.snapshot()
        finally:
            _slo_target(ns).set(0.0)

    inert, ok, snap, after = _both(run)
    assert inert == [True, None] and ok == [True, False, True, False, True]
    assert snap["pools"]["a"]["x"]["burn"] == 50.0 and after is None


def test_progress_source_keys_match():
    assert _both(lambda ns: sorted(ns.progress._telemetry_stats())) == [
        "callbacks", "low_priority", "reactor_active", "waiters"]


# -- a multi-process job -------------------------------------------------

JOB = r'''
import json, sys, time
import numpy as np

pkg = sys.argv[1]
if pkg == "torch":
    import ompi_tpu_torch as m
    from ompi_tpu_torch.rte.coord import CoordClient
    from ompi_tpu_torch.runtime import profile, telemetry
    w = m.init(device="cpu")
else:
    import ompi_tpu as m
    from ompi_tpu.rte.coord import CoordClient
    from ompi_tpu.runtime import profile, telemetry
    w = m.init()
r = w.rank
for n in (100, 70000):
    w.allreduce(np.full(n, r + 1.0))
buf = np.zeros(4)
if r == 0:
    w.send(np.arange(4.0), dest=1, tag=1)
else:
    w.recv(buf, source=0, tag=1)
client = CoordClient()
# a sample taken after the traffic above: its seq is past the last one
# published before this read
raw = client.get(r, telemetry._KV_KEY, wait=False)
after = json.loads(raw).get("seq", 0) + 1 if raw else 0
sample = {}
waited = False
deadline = time.time() + 20
while time.time() < deadline:
    raw = client.get(r, telemetry._KV_KEY, wait=False)
    sample = json.loads(raw) if raw else {}
    if sample.get("seq", 0) >= max(2, after) and "profile" in sample \
            and (profile.profiler_stats() or {}).get("samples", 0) >= 3:
        waited = True
        break
    time.sleep(0.05)
client.close()
print(json.dumps({
    "waited": waited,
    "keys": sorted(sample),
    "stages": sorted(profile.stage_stats()),
    "profile_keys": sorted(sample.get("profile", {})),
    "profiler": (profile.profiler_stats() or {}).get("samples", 0) > 0,
    "sampler": telemetry.enabled}), flush=True)
m.finalize()
print(json.dumps({"after_finalize": [telemetry.enabled,
                                     telemetry._sampler is None,
                                     profile._profiler is None]}),
      flush=True)
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
def job(tmp_path_factory):
    script = tmp_path_factory.mktemp("telemetry") / "job.py"
    script.write_text(JOB)
    out = {}
    for pkg in ("torch", "jax"):
        proc = _tpurun(pkg, [
            "--mca", "coll", "tuned,basic,self_coll",
            "--mca", "otpu_profile_stages", "1",
            "--mca", "otpu_profile_interval_ms", "10",
            "--mca", "otpu_telemetry_interval_ms", "50",
            sys.executable, str(script), pkg])
        assert proc.returncode == 0, proc.stdout + proc.stderr
        lines = {}
        for line in proc.stdout.splitlines():
            if line.startswith("[") and "] {" in line:
                rank, _, rest = line.partition("] ")
                lines.setdefault(int(rank[1:]), []).append(json.loads(rest))
        for rank in (0, 1):
            assert lines[rank][0]["waited"], (pkg, rank, lines[rank][0])
        out[pkg] = lines
    return out


def test_job_samples_match(job):
    for rank in (0, 1):
        got, want = job["torch"][rank][0], job["jax"][rank][0]
        assert got["keys"] == want["keys"]
        assert set(BUILTIN) | {"profile", "progress", "tcp"} <= \
            set(got["keys"])
        assert got["profile_keys"] == want["profile_keys"]
        assert got["profiler"] and got["sampler"]


def test_job_stage_names_match(job):
    for rank in (0, 1):
        got, want = job["torch"][rank][0], job["jax"][rank][0]
        assert got["stages"] == want["stages"]
        assert {"coll.decide", "coll.alg"} <= set(got["stages"])


def test_job_threads_stop_at_finalize(job):
    for pkg in ("torch", "jax"):
        for rank in (0, 1):
            assert job[pkg][rank][1] == {"after_finalize": [False, True,
                                                            True]}
