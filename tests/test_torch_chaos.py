"""ft/chaos in the port, held against the JAX package.

* the spec grammar: round trip and loud errors, the same rules in both
  packages;
* determinism: one spec and one seed give the identical event log in both
  packages (the engine draws from ``random.Random`` as the reference
  does); the ``n=`` caps, events that cannot apply consume no cap, the
  kill-point counts, rank-scoped rules, and every hook inert with chaos
  off;
* the coordination client under an injected mid-RPC disconnect: the
  fetch-add applied exactly once, a fence completed;
* btl/tcp's armed checksum: a frame corrupted by chaos is a loud,
  attributed error on the selector lane and on the native reactor's RAW
  lane; the send side arms the crc under chaos;
* the wire hooks in real jobs: each package's ``tpurun -n 2`` over tcp
  (with the native core and with ``OTPU_NATIVE_DISABLE=1``) and over sm
  under a seeded wire spec either completes with exact results or fails
  loudly with an attributed crc error — and ``corrupt:p=1,n=1`` always
  fails loudly, in both packages.
"""
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKGS = ("ompi_tpu", "ompi_tpu_torch")


def _chaos(pkg):
    return __import__(f"{pkg}.ft.chaos", fromlist=["x"])


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for pkg in PKGS:
        ch = _chaos(pkg)
        ch.uninstall()
        with ch._log_lock:
            ch._log.clear()


# ------------------------------------------------------------------ spec

SPECS = ["drop:p=0.01;delay:ms=5,p=0.05;kill:rank=2,step=7",
         " drop:p=0.5 ;; ",
         "delay:ms=8,p=1,rank=2,site=step;stall:ms=3,n=2",
         "kill:rank=1,site=agree_prepare,count=2;corrupt:p=0.25,n=4",
         "reset:p=0.1,rank=3;disconnect:p=0.5;dup:p=0.2,n=1"]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_round_trip_same_in_both(spec):
    ref, port = _chaos("ompi_tpu"), _chaos("ompi_tpu_torch")
    rules = port.parse_spec(spec)
    assert rules == ref.parse_spec(spec)
    assert port.format_spec(rules) == ref.format_spec(rules)
    assert port.parse_spec(port.format_spec(rules)) == rules


@pytest.mark.parametrize("bad", ["explode:p=1", "drop:ms=2", "delay:ms=abc",
                                 "drop:p", "kill:rank=2"])
def test_spec_errors_are_loud_in_both(bad):
    for pkg in PKGS:
        ch = _chaos(pkg)
        with pytest.raises(ch.ChaosSpecError):
            ch.parse_spec(bad)


# ----------------------------------------------------------- determinism

def _drive(ch, events: int = 60) -> list:
    """One fixed sequence of hook calls; the (fault, site) event log (a
    256-entry tail: the sequence stays inside it)."""
    for i in range(events):
        ch.wire_send("tcp", i % 3 == 0)
        ch.wire_recv("tcp", False)
        ch.wire_send("sm", i % 2 == 0)
        ch.wire_recv("sm", i % 5 == 0)
        if i % 7 == 0:
            ch.coord_stall("put")
            ch.coord_disconnect("fetch_add")
    return [(f, s) for _t, f, s in ch.event_log()]


@pytest.mark.parametrize("seed,rank", [(0, 0), (11, 0), (11, 1), (7, 3)])
def test_identical_event_log_in_both(seed, rank):
    spec = ("drop:p=0.3;delay:p=0.2,ms=0;dup:p=0.2;corrupt:p=0.1,n=5;"
            "reset:p=0.05,n=2;stall:p=0.5,ms=0;disconnect:p=0.3")
    logs = {}
    for pkg in PKGS:
        ch = _chaos(pkg)
        ch.install_spec(spec, rank=rank, seed=seed)
        logs[pkg] = _drive(ch)
        ch.uninstall()
    assert logs["ompi_tpu_torch"] == logs["ompi_tpu"]
    faults = {f for f, _ in logs["ompi_tpu_torch"]}
    assert faults == {"drop", "delay", "dup", "corrupt", "reset", "stall",
                      "disconnect"}, faults
    # the whole sequence is in the tail, and the caps hold there
    assert len(logs["ompi_tpu_torch"]) < 256
    assert sum(f == "corrupt" for f, _ in logs["ompi_tpu_torch"]) <= 5
    assert sum(f == "reset" for f, _ in logs["ompi_tpu_torch"]) <= 2


def test_engine_streams_match_per_site():
    """The per-(seed, rank, site) streams: the same decision trace in
    both packages, and a different seed, rank or site is another."""
    def trace(pkg, seed, rank, site):
        ch = _chaos(pkg)
        eng = ch._Engine(ch.parse_spec(
            "drop:p=0.3;delay:p=0.2,ms=1;corrupt:p=0.1"), seed, rank)
        out = []
        for _ in range(200):
            r = eng.match(eng.wire_rules, site)
            out.append(None if r is None else r["fault"])
        return out

    a = trace("ompi_tpu_torch", 11, 0, "tcp:send")
    assert a == trace("ompi_tpu", 11, 0, "tcp:send")
    assert any(x is not None for x in a)
    assert a != trace("ompi_tpu_torch", 12, 0, "tcp:send")
    assert a != trace("ompi_tpu_torch", 11, 1, "tcp:send")
    assert a != trace("ompi_tpu_torch", 11, 0, "tcp:recv")


@pytest.mark.parametrize("pkg", PKGS)
def test_n_cap_and_inapplicable_events(pkg):
    ch = _chaos(pkg)
    eng = ch._Engine(ch.parse_spec("drop:p=1,n=3"), 0, 0)
    fired = [eng.match(eng.wire_rules, "s") for _ in range(10)]
    assert [r is not None for r in fired] == [True] * 3 + [False] * 7
    # a capped tcp-only fault offered first to sm events still fires on
    # the first tcp event: inapplicable events never burn the budget
    ch.install_spec("reset:p=1,n=1", rank=0)
    for _ in range(5):
        assert ch.wire_send("sm", False) is None
    assert ch.wire_send("tcp", False)["fault"] == "reset"
    assert ch.wire_send("tcp", False) is None


def test_wire_hook_semantics():
    ch = _chaos("ompi_tpu_torch")
    ch.install_spec("drop:p=1", rank=0)
    assert ch.wire_send("tcp", True)["fault"] == "drop"
    assert ch.wire_send("tcp", False) is None    # reliable traffic
    ch.install_spec("reset:p=1", rank=0)
    assert ch.wire_send("tcp", False)["fault"] == "reset"
    assert ch.wire_send("sm", False) is None
    assert ch.wire_recv("tcp", False) is None    # the peer's send fault
    ch.install_spec("corrupt:p=1", rank=0)
    assert ch.wire_recv("tcp", False)["fault"] == "corrupt"
    assert ch.wire_send("sm", True) is None      # sm is host memory


@pytest.mark.parametrize("pkg", PKGS)
def test_kill_point_counts(pkg, monkeypatch):
    ch = _chaos(pkg)
    killed = []
    monkeypatch.setattr(ch, "_exit", lambda code: killed.append(code))
    ch.install_spec("kill:rank=0,site=agree_prepare,count=2", rank=0)
    ch.kill_point("agree_prepare")
    ch.kill_point("agree_prepare")
    assert not killed                            # 2 hits permitted
    ch.kill_point("agree_prepare")
    assert killed == [ch.KILL_EXIT_CODE] == [7]  # dies on the 3rd
    killed.clear()
    ch.install_spec("kill:rank=0,step=7", rank=0)
    for s in range(7):
        ch.kill_point("step", n=s)
    assert not killed
    ch.kill_point("step", n=7)
    assert killed == [7]
    killed.clear()
    ch.install_spec("kill:rank=3,step=1", rank=0)   # another rank's rule
    ch.kill_point("step", n=1)
    assert not killed
    assert ("kill", "agree_prepare") in [(f, s) for _t, f, s
                                         in ch.event_log()]


@pytest.mark.parametrize("pkg", PKGS)
def test_rank_scoped_wire_and_pace_rules(pkg):
    ch = _chaos(pkg)
    ch.install_spec("delay:ms=1,p=1,rank=2", rank=2)
    assert ch.wire_send("tcp", False)["fault"] == "delay"
    ch.install_spec("delay:ms=1,p=1,rank=2", rank=0)
    assert ch.wire_send("tcp", False) is None
    # a site-scoped delay never fires on the wire, only at its pace point
    ch.install_spec("delay:ms=1,p=1,rank=0,site=step", rank=0)
    assert ch.wire_send("tcp", False) is None
    t0 = time.perf_counter()
    ch.pace("step")
    assert time.perf_counter() - t0 >= 0.8e-3
    ch.pace("other_site")
    assert [(f, s) for _t, f, s in ch.event_log()] == [
        ("delay", "tcp:send"), ("delay", "pace:step")]


def test_chaos_off_hooks_are_inert():
    """With chaos unset every hook site is one ``if chaos.enabled`` test,
    and the hooks themselves do nothing."""
    ch = _chaos("ompi_tpu_torch")
    assert ch.enabled is False and ch._engine is None
    assert ch.wire_send("tcp", True) is None
    assert ch.wire_recv("sm", True) is None
    assert ch.coord_stall("put") is None
    assert ch.coord_disconnect("put") is False
    ch.kill_point("step", n=0)
    ch.pace("step")
    assert ch.event_log() == []
    assert ch.install() is False                 # empty spec: not armed
    from ompi_tpu_torch.mca.btl import tcp

    assert tcp._cksum_armed() is __import__(
        "ompi_tpu_torch.runtime.sanitizer", fromlist=["x"]).enabled


def test_hook_sites_guard_on_the_module_bool():
    """Every hook site in the port reads ``chaos.enabled`` first (the
    reference's sites, the same guards)."""
    import inspect

    from ompi_tpu_torch.ft import agreement
    from ompi_tpu_torch.mca.btl import sm, tcp
    from ompi_tpu_torch.parallel import elastic
    from ompi_tpu_torch.rte import coord, proc

    sites = {
        tcp.TcpBtl.send: 1, tcp.TcpBtl._reactor_event: 1,
        tcp.TcpBtl._reactor_raw: 1, tcp.TcpBtl._on_bytes: 1,
        sm.SmBtl.send: 1, sm.SmBtl.progress: 1,
        coord.CoordClient._rpc_locked: 2, coord.CoordServer._maybe_stall: 1,
        agreement._p2p_send: 1, elastic.ElasticTrainer.train: 1,
    }
    for fn, n in sites.items():
        src = inspect.getsource(fn)
        assert src.count("chaos.enabled") == n, fn.__qualname__
    assert "chaos.install(rank=" in inspect.getsource(proc.ProcRte.__init__)
    assert "chaos.enabled or sanitizer.enabled" in inspect.getsource(
        tcp._cksum_armed)


def test_rget_control_frames_are_not_loss_eligible_divergence_pinned():
    """Loss faults are for best-effort CTL frames only (the reference's own
    rule): ob1 flags its RGET control frames ``meta["reliable"]`` (they
    complete a transfer with no retransmit) and ``loss_ok`` keeps any frame
    so flagged out of drop and dup, whatever its protocol's name.  The
    reference offers every CTL frame (``frag.kind == CTL``), so a drop
    there can leave an RGET send pending for ever."""
    import inspect

    from ompi_tpu.mca.btl import sm as ref_sm
    from ompi_tpu.mca.btl import tcp as ref_tcp
    from ompi_tpu_torch.mca.btl.base import CTL, MATCH, Frag, loss_ok
    from ompi_tpu_torch.mca.pml import ob1

    def frag(kind, proto=None, **flags):
        meta = None if proto is None else {"proto": proto, **flags}
        return Frag(0, 0, 1, -1, 0, kind, meta=meta)

    for proto in ("ft_hb", "ft_prop", "ft_rev", "ftagree_p2p", "ob1_rget_done",
                  "osc_ctl", None):
        assert loss_ok(frag(CTL, proto)), proto
    for proto in ("ob1_rget_done", "ob1_rget_pull", "any_new_proto"):
        assert not loss_ok(frag(CTL, proto, reliable=True)), proto
    assert not loss_ok(frag(MATCH))
    # ob1 sets the flag on both of its RGET control frames
    src = inspect.getsource(ob1.Ob1Pml)
    for proto in ("ob1_rget_done", "ob1_rget_pull"):
        assert f'"proto": "{proto}", "reliable": True' in src, proto
    assert 'wire_send("tcp", frag.kind == CTL)' in inspect.getsource(
        ref_tcp.TcpBtl.send)
    assert 'wire_send("sm", frag.kind == CTL)' in inspect.getsource(
        ref_sm.SmBtl.send)


# ------------------------------------------- self-healing coord client

@pytest.fixture
def coord_server(monkeypatch):
    from ompi_tpu_torch.rte.coord import CoordServer

    srv = CoordServer(2)
    monkeypatch.setenv("OTPU_COORD", f"{srv.addr[0]}:{srv.addr[1]}")
    yield srv
    srv.close()


def test_coord_fetch_add_exactly_once_across_disconnect(coord_server):
    """A mid-RPC disconnect (reply lost after the server applied the op)
    must not double-apply on retry."""
    from ompi_tpu_torch.rte.coord import CoordClient

    ch = _chaos("ompi_tpu_torch")
    c = CoordClient(retries=8)
    ch.install_spec("disconnect:n=2", rank=0)
    assert c.fetch_add(-1, "ctr", 1) == 0        # injected reset, healed
    assert c.fetch_add(-1, "ctr", 1) == 1        # applied exactly once
    ch.uninstall()
    assert c.fetch_add(-1, "ctr", 1) == 2
    assert [(f, s) for _t, f, s in ch.event_log()] == [
        ("disconnect", "coord:fetch_add")] * 2
    # the flight recorder's RPC ring saw each completed call once
    ops = [row[1] for row in c.recent_rpcs()]
    assert ops == ["fetch_add"] * 3 and all(row[3] for row in
                                            c.recent_rpcs())
    c.close()


def test_coord_fence_survives_mid_rpc_disconnect(coord_server):
    from ompi_tpu_torch.rte.coord import CoordClient

    ch = _chaos("ompi_tpu_torch")
    a = CoordClient(retries=8)
    b = CoordClient(retries=8)
    ch.install_spec("disconnect:n=1", rank=0)
    done = []
    t1 = threading.Thread(target=lambda: (a.fence("F", rank=0),
                                          done.append(0)))
    t2 = threading.Thread(target=lambda: (b.fence("F", rank=1),
                                          done.append(1)))
    t1.start()
    t2.start()
    t1.join(30)
    t2.join(30)
    assert sorted(done) == [0, 1], done
    a.put(0, "k", "v")
    assert b.get(0, "k") == "v"
    a.close()
    b.close()


def test_coord_stall_counts_and_flight_view(coord_server):
    from ompi_tpu_torch.rte.coord import CoordClient
    from ompi_tpu_torch.runtime import spc

    spc.init()
    before = spc.read("chaos_stall")
    c = CoordClient(retries=2)
    _chaos("ompi_tpu_torch").install_spec("stall:p=1,ms=1,n=3", rank=0)
    for _ in range(5):
        c.put(0, "k", 1)
    assert spc.read("chaos_stall") == before + 3
    coord_server.publish("proc_failed", {"rank": 1, "origin": "test"})
    view = coord_server.flight_view()
    assert set(view) == {"events", "failed", "psets", "nprocs", "aborted",
                         "t"}
    assert view["failed"] == [1] and view["events"][0]["name"] \
        == "proc_failed" and view["events"][0]["t"] > 0
    c.close()


# --------------------------------------------------- wire checksum (tcp)

def _ck_frame(tcp_mod, payload: bytes) -> bytearray:
    """A checksummed fast-header frame, built the way send() builds it
    (the length prefix included)."""
    import zlib

    from ompi_tpu_torch.mca.btl.base import MATCH, Frag

    hdr = tcp_mod._fast_header(Frag(0, 9, 0, 5, 1, MATCH, payload))
    crc = zlib.crc32(payload, zlib.crc32(hdr))
    frame_len = 1 + tcp_mod._CKSUM.size + len(hdr) + len(payload)
    return bytearray(
        tcp_mod._LEN.pack(frame_len)
        + bytes((tcp_mod._H_FAST + tcp_mod._H_CK_BASE,))
        + tcp_mod._CKSUM.pack(crc) + hdr + payload)


@pytest.mark.parametrize("lane", ["selector", "reactor_raw"])
def test_chaos_corrupt_frame_is_loud_and_attributed(lane, capsys,
                                                    monkeypatch):
    """``corrupt`` on the receive side flips a byte of a checksummed frame
    before its crc check, on either lane where frames reach Python: the
    trip is loud, counted and names the peer."""
    import socket

    from ompi_tpu_torch.base import output
    from ompi_tpu_torch.mca.btl import tcp as tcp_mod
    from ompi_tpu_torch.runtime import sanitizer, spc

    # show_help prints a message once a process: start from unseen
    monkeypatch.setattr(output, "_help_seen", {})

    spc.init()
    before = spc.read("wire_cksum_fail")
    s1, s2 = socket.socketpair()
    conn = tcp_mod._Conn(s1)
    conn.rank = 9
    btl = tcp_mod.TcpBtl()
    got = []
    btl.set_recv_callback(got.append)
    deliver = (btl._on_bytes if lane == "selector"
               else lambda c, v: btl._reactor_raw(c, v[tcp_mod._LEN.size:]))
    try:
        # unarmed: the frame verifies and delivers
        assert deliver(conn, memoryview(_ck_frame(tcp_mod, b"kv"))) == 1
        assert bytes(got[0].data) == b"kv"
        _chaos("ompi_tpu_torch").install_spec("corrupt:p=1,n=1", rank=0)
        with pytest.raises(sanitizer.SanitizeError) as ei:
            deliver(conn, memoryview(_ck_frame(tcp_mod, b"kv")))
        assert "rank 9" in str(ei.value) and "crc32" in str(ei.value)
        assert spc.read("wire_cksum_fail") == before + 1
        assert "corrupted on the wire" in capsys.readouterr().err
        # the cap is spent: the next frame delivers again
        assert deliver(conn, memoryview(_ck_frame(tcp_mod, b"ok"))) == 1
        assert spc.read("chaos_corrupt") >= 1
    finally:
        s1.close()
        s2.close()


# ------------------------------------------------- wire hooks in real jobs

JOB = r'''
import sys
import numpy as np

PKG = sys.argv[1]
if PKG == "torch":
    import ompi_tpu_torch as m
    w = m.init(device="cpu")
else:
    import ompi_tpu as m
    w = m.init()
r, n = w.rank, w.size
for it in range(6):
    x = np.arange(5000, dtype=np.float64) * (r + 1) + it
    tot = np.asarray(w.allreduce(x))
    want = sum(np.arange(5000, dtype=np.float64) * (k + 1) + it
               for k in range(n))
    assert np.array_equal(tot, want), it
    b = np.asarray(w.bcast(np.full(3000, float(it + r)), root=it % n))
    assert np.array_equal(b, np.full(3000, float(it + it % n))), it
    buf = np.zeros(70000, np.float32)
    w.sendrecv(np.full(70000, float(r), np.float32), (r + 1) % n,
               recvbuf=buf, source=(r - 1) % n)
    assert np.array_equal(buf, np.full(70000, float((r - 1) % n))), it
print("WIRE OK", r, flush=True)
m.finalize()
'''


def _wire_job(pkg, tmp_path, spec, seed, btl, native, timeout=120):
    script = tmp_path / "wire.py"
    script.write_text(JOB)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("OTPU_RANK", None)
    env.pop("OTPU_NPROCS", None)
    if not native:
        env["OTPU_NATIVE_DISABLE"] = "1"
    launcher = ("ompi_tpu_torch.tools.tpurun" if pkg == "torch"
                else "ompi_tpu.tools.tpurun")
    cmd = [sys.executable, "-m", launcher, "-n", "2",
           "--mca", "otpu_chaos_spec", spec,
           "--mca", "otpu_chaos_seed", str(seed),
           "--mca", "otpu_flight_dir", str(tmp_path / f"crash-{pkg}")]
    if btl == "tcp":
        cmd += ["--mca", "btl", "tcp,self"]
    cmd += [sys.executable, str(script), pkg]
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, cwd=REPO, env=env,
                         start_new_session=True)
    try:
        o, e = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
    return p.returncode, o + e


def _loud(out: str) -> bool:
    return "crc32" in out and "corrupted on the wire" in out


@pytest.mark.parametrize("btl,native", [("tcp", True), ("tcp", False),
                                        ("sm", True)])
def test_wire_chaos_job_completes_or_fails_loudly(tmp_path, btl, native):
    """A seeded wire spec in a real job: it completes with exact results
    or fails loudly with an attributed crc error, never a wrong answer and
    never a hang (each job has its own timeout)."""
    spec = "drop:p=0.02;delay:ms=2,p=0.05;corrupt:p=0.01;dup:p=0.05"
    rc, out = _wire_job("torch", tmp_path, spec, 5, btl, native)
    if rc == 0:
        assert out.count("WIRE OK") == 2, out[-3000:]
    else:
        assert _loud(out), out[-3000:]


@pytest.mark.parametrize("native", [True, False])
def test_corrupt_on_the_wire_fails_loudly_in_both(tmp_path, native):
    """``corrupt:p=1,n=1`` over tcp corrupts one frame after its crc was
    computed: in both packages the receiver fails loudly and attributed,
    the job ends non-zero, and no rank reports a result."""
    for pkg in ("torch", "jax"):
        rc, out = _wire_job(pkg, tmp_path, "corrupt:p=1,n=1", 0, "tcp",
                            native)
        assert rc != 0 and _loud(out) and "WIRE OK" not in out, \
            (pkg, out[-3000:])
