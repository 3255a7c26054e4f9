"""runtime/flight — the crash-time flight recorder in the port, held against
the JAX package.

* the payload: a dump of each package in one process, from the same
  trigger, carries the same keys (no more, no fewer) and the same reason
  vocabulary;
* the once guard: one dump a death, with the ``sanitize`` exception (a
  later fatal reason supersedes it), nothing while disarmed or disabled;
* the hooks: ``abort`` dumps before it exits, a sanitizer trip dumps on a
  thread of its own;
* the bundle: each package's ``tpurun --enable-recovery`` job with a chaos
  kill writes ``<otpu_flight_dir>/bundle.json`` holding the killed rank's
  ``chaos-kill`` dump beside the survivors' ``proc-failed`` ones and the
  coordination service's view; the two bundles have the same shape.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKGS = ("ompi_tpu", "ompi_tpu_torch")


class _Rte:
    my_world_rank = 3
    client = None


def _mods(pkg):
    flight = __import__(f"{pkg}.runtime.flight", fromlist=["x"])
    var = __import__(f"{pkg}.base.var", fromlist=["x"])
    return flight, var.registry


def _clear_chaos():
    """Both packages' chaos disarmed and their event logs (process-wide
    tails that other tests of the worker may have filled) emptied."""
    for pkg in PKGS:
        chaos = __import__(f"{pkg}.ft.chaos", fromlist=["x"])
        chaos.uninstall()
        with chaos._log_lock:
            chaos._log.clear()


@pytest.fixture
def armed(tmp_path, monkeypatch):
    """Both packages' recorders armed on a stand-in rte, dumping under
    ``tmp_path/<pkg>``; no coordination service (the offset is 0)."""
    monkeypatch.delenv("OTPU_COORD", raising=False)
    _clear_chaos()
    out = {}
    for pkg in PKGS:
        flight, registry = _mods(pkg)
        old = registry.lookup("otpu_flight_dir").value
        flight.reset_for_testing()
        registry.set("otpu_flight_dir", str(tmp_path / pkg))
        flight.arm(_Rte())
        out[pkg] = (flight, old, registry)
    yield {pkg: v[0] for pkg, v in out.items()}
    for pkg, (flight, old, registry) in out.items():
        flight.reset_for_testing()
        registry.set("otpu_flight_dir", old)
    _clear_chaos()


def _read(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("reason", ["abort", "chaos-kill", "uncaught",
                                    "proc-failed", "sanitize"])
def test_payload_keys_equal_the_reference(armed, reason):
    """The same keys; the same values where both packages hold the same
    state: the same injected faults (their times aside), the process's
    failed ranks, no coordination RPCs and no clock offset."""
    dumps = {}
    for pkg, flight in armed.items():
        chaos = __import__(f"{pkg}.ft.chaos", fromlist=["x"])
        chaos.install_spec("corrupt:p=1,n=2;stall:p=1,ms=0", rank=3)
        for _ in range(3):
            chaos.wire_recv("tcp", False)
        chaos.coord_stall("put")
        chaos.uninstall()
        path = flight.dump(reason, detail="why")
        assert path is not None and path.endswith("rank3.json"), pkg
        dumps[pkg] = _read(path)
        state = __import__(f"{pkg}.ft.state", fromlist=["x"])
        assert dumps[pkg]["failed_ranks"] == sorted(state.failed_ranks())
    port, ref = dumps["ompi_tpu_torch"], dumps["ompi_tpu"]
    assert set(port) == set(ref)
    for key in ("rank", "reason", "detail", "clock_offset_us",
                "coord_rpcs"):
        assert port[key] == ref[key], key
    assert [e[1:] for e in port["chaos_events"]] == \
        [e[1:] for e in ref["chaos_events"]] == [
            ["corrupt", "tcp:recv"], ["corrupt", "tcp:recv"],
            ["stall", "coord:put"]]
    assert port["rank"] == 3 and port["reason"] == reason


def test_once_guard_and_sanitize_superseded(armed):
    flight = armed["ompi_tpu_torch"]
    ref = armed["ompi_tpu"]
    got = {}
    for name, fl in (("port", flight), ("ref", ref)):
        seq = [fl.dump("sanitize", "trip") is not None,
               fl.dump("sanitize", "again") is not None,
               fl.dump("abort", "fatal") is not None,
               fl.dump("chaos-kill", "late") is not None,
               fl.dump("uncaught", "late") is not None]
        got[name] = seq
    assert got["port"] == got["ref"] == [True, False, True, False, False]
    # the file holds the fatal dump, which superseded the sanitizer's
    path = os.path.join(flight.flight_dir(), "rank3.json")
    assert _read(path)["reason"] == "abort"


def test_disarmed_or_disabled_dumps_nothing(armed):
    flight, registry = _mods("ompi_tpu_torch")
    registry.set("otpu_flight_enable", False)
    try:
        assert flight.dump("abort") is None
    finally:
        registry.set("otpu_flight_enable", True)
    flight.disarm()
    assert flight.dump("abort") is None
    flight.reset_for_testing()
    assert flight.dump("abort") is None        # never armed since


def test_reason_vocabulary_is_the_reference(armed):
    port = __import__("ompi_tpu_torch.base.output", fromlist=["x"])
    ref = __import__("ompi_tpu.base.output", fromlist=["x"])

    def vocab(mod):
        return {k: v for k, v in mod._help_topics.items()
                if k[0] == "help-flight"}

    assert vocab(port) == vocab(ref)
    assert {k[1] for k in vocab(port)} == {
        "abort", "proc-failed", "sanitize", "uncaught", "chaos-kill"}
    flight = armed["ompi_tpu_torch"]
    assert flight._FATAL == armed["ompi_tpu"]._FATAL


def test_excepthook_classifies_by_observed_failures(armed, monkeypatch):
    from ompi_tpu_torch.ft import state as ft_state

    flight = armed["ompi_tpu_torch"]
    assert sys.excepthook is not sys.__excepthook__
    seen = []
    monkeypatch.setattr(flight, "_orig_excepthook",
                        lambda *a: seen.append(a[1]))
    ft_state.mark_failed(5)
    try:
        err = RuntimeError("secondary fallout")
        flight._excepthook(RuntimeError, err, None)
    finally:
        ft_state.reset_for_testing()
    dump = _read(os.path.join(flight.flight_dir(), "rank3.json"))
    assert dump["reason"] == "proc-failed" and dump["failed_ranks"] == [5]
    assert dump["detail"].startswith("5 (then") and seen == [err]


def test_sanitizer_trip_dumps_on_its_own_thread(armed):
    from ompi_tpu_torch.runtime import sanitizer

    flight = armed["ompi_tpu_torch"]
    with pytest.raises(sanitizer.SanitizeError):
        sanitizer.fail("broken invariant")
    path = os.path.join(flight.flight_dir(), "rank3.json")
    deadline = time.time() + 10
    while not os.path.exists(path):
        assert time.time() < deadline, "no sanitize dump"
        time.sleep(0.01)
    time.sleep(0.1)
    dump = _read(path)
    assert dump["reason"] == "sanitize" \
        and dump["detail"] == "broken invariant"


# -------------------------------------------------------- the tpurun bundle

KILL_JOB = textwrap.dedent('''
    import sys, time
    PKG = sys.argv[1]
    if PKG == "torch":
        import ompi_tpu_torch as m
        from ompi_tpu_torch.ft import chaos, state as ft_state
        w = m.init(device="cpu")
    else:
        import ompi_tpu as m
        from ompi_tpu.ft import chaos, state as ft_state
        w = m.init()
    assert chaos.enabled
    for step in range(4):
        chaos.kill_point("step", n=step)
        if step < 2:
            w.barrier()
    deadline = time.time() + 60
    while not ft_state.is_failed(1):
        assert time.time() < deadline, "the kill was never detected"
        time.sleep(0.02)
    print("SURVIVED", w.rank, flush=True)
    m.finalize()
''')


def _run_kill_job(pkg, tmp_path, timeout=120):
    script = tmp_path / "kill.py"
    script.write_text(KILL_JOB)
    fdir = tmp_path / f"flight-{pkg}"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("OTPU_RANK", None)
    env.pop("OTPU_NPROCS", None)
    launcher = ("ompi_tpu_torch.tools.tpurun" if pkg == "torch"
                else "ompi_tpu.tools.tpurun")
    cmd = [sys.executable, "-m", launcher, "-n", "3", "--enable-recovery",
           "--mca", "otpu_chaos_spec", "kill:rank=1,step=2",
           "--mca", "otpu_flight_dir", str(fdir),
           sys.executable, str(script), pkg]
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, cwd=REPO, env=env,
                         start_new_session=True)
    try:
        o, e = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
    return p.returncode, o, e, fdir


def test_bundle_after_a_chaos_kill(tmp_path):
    bundles = {}
    for pkg in ("torch", "jax"):
        rc, out, err, fdir = _run_kill_job(pkg, tmp_path)
        assert rc == 0, (pkg, out[-3000:], err[-3000:])
        assert out.count("SURVIVED") == 2, (pkg, out)
        assert "rank 1 failed (exit 7)" in err, (pkg, err)
        assert "flight-recorder bundle of 3 dump(s)" in err, (pkg, err)
        bundles[pkg] = _read(fdir / "bundle.json")
    port, ref = bundles["torch"], bundles["jax"]
    assert set(port) == set(ref) == {"dumps", "coord", "merged_tail",
                                     "clock"}
    reasons = {r: d["reason"] for r, d in port["dumps"].items()}
    assert reasons == {r: d["reason"] for r, d in ref["dumps"].items()} \
        == {"0": "proc-failed", "1": "chaos-kill", "2": "proc-failed"}
    killed = port["dumps"]["1"]
    assert killed["detail"] == "kill:rank=1,step=2"
    assert ["kill", "{'fault': 'kill', 'rank': 1, 'step': 2}"] == \
        killed["chaos_events"][-1][1:]
    assert set(killed) == set(ref["dumps"]["1"])
    assert set(port["coord"]) == set(ref["coord"])
    assert port["coord"]["failed"] == ref["coord"]["failed"] == [1]
    assert any(e["name"] == "proc_failed" for e in port["coord"]["events"])
    for d in port["dumps"].values():
        assert d["coord_rpcs"] and all(len(row) == 4
                                       for row in d["coord_rpcs"])
