"""pml/v with vprotocol/pessimist in the port
(``ompi_tpu_torch/mca/pml/vprotocol.py``) held against the JAX package's.

* the four vars, ``maybe_wrap_pml``'s choice (replay before logging, nothing
  without a coordination client) and the boot's order (vprotocol outside
  pml/monitoring) in both packages;
* the logging wrapper on a stand-in pml: the same seeded numpy payloads
  (the port's also as tensors) give the same log lines, key for key (``ev``,
  ``sc``, ``sha``, ``payload``), and a tensor reaches the pml staged once;
* replay on stand-ins: a receive satisfied from the sender's logged payload,
  a send suppressed where the receiver's log proves delivery, and every
  divergence (``ReplayDivergence``) with the reference's message;
* ``tests/test_vprotocol_replay.py``'s scenarios in one ``-n 3`` program of
  the port: a ring over two communicators whose consumption order crosses
  the peer's emission order, rank 1 killed between its two receives (one
  message in flight), then every rank replayed from the logs and finished
  live; the final states bit for bit against the local recurrence;
* one deterministic 3-rank program logged with payloads by both packages'
  ``tpurun``: the event logs are equal line for line.

Every comparison is exact: logging does no arithmetic, and the recurrences
are the same float64 operations in the same order.
"""
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ompi_tpu.mca.pml import vprotocol as jvp
from ompi_tpu_torch.mca.pml import vprotocol as tvp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARS = ("log", "log_payloads", "replay", "replay_rank")
PKGS = {"torch": tvp, "jax": jvp}


def _var(mod, name):
    reg = mod.registry
    return reg.lookup(f"otpu_vprotocol_pessimist_{name}")


@pytest.mark.parametrize("name", VARS)
def test_vars_match_the_reference(name):
    j, t = _var(jvp, name), _var(tvp, name)
    assert (t.vtype.value, t.default, t.help) == \
        (j.vtype.value, j.default, j.help)


class _Group:
    def __init__(self, ranks):
        self.world_ranks = tuple(ranks)

    def world_rank(self, r):
        return self.world_ranks[r]

    def rank_of(self, w):
        return self.world_ranks.index(w)


class _Comm:
    """The slice of a communicator the wrappers read."""

    def __init__(self, cid, ranks=(0, 1, 2)):
        self.cid = cid
        self.group = _Group(ranks)
        self.remote_group = None
        self.is_inter = False


class _Pml:
    """A stand-in inner pml recording what reaches it."""

    def __init__(self):
        self.calls = []

    def send(self, comm, buf, dest, tag, **kw):
        self.calls.append(("send", comm.cid, type(buf).__name__,
                           np.asarray(buf).tobytes(), dest, tag))

    def isend(self, comm, buf, dest, tag, **kw):
        self.send(comm, buf, dest, tag)
        return "isend-request"

    def recv(self, comm, buf, source, tag):
        self.calls.append(("recv", comm.cid, source, tag))
        return SimpleNamespace(source=source, tag=tag)

    def finalize(self):
        self.calls.append(("finalize",))


def _set(mod, **values):
    """Set vprotocol vars; returns the undo."""
    old = {k: _var(mod, k).value for k in values}
    for k, v in values.items():
        _var(mod, k).set(v)
    return lambda: [_var(mod, k).set(v) for k, v in old.items()]


def _payloads(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(5), rng.integers(-9, 9, 7, dtype=np.int32),
            rng.standard_normal((2, 3)).astype(np.float32)]


def _log_program(pml, as_tensor, seed=3):
    """One rank-0 program against a logging wrapper: sends on two comms and
    tags, receives, one irecv-style match."""
    w, d = _Comm(0), _Comm(4)
    for i, x in enumerate(_payloads(seed)):
        buf = torch.from_numpy(x) if as_tensor else x
        (pml.send if i % 2 else pml.isend)(w if i < 2 else d, buf,
                                           1 + i % 2, 7)
    pml.recv(w, np.zeros(5), 2, 7)
    pml.recv(d, np.zeros(5), 1, 9)
    pml._log_match_st(w, SimpleNamespace(source=2, tag=7))


def _log_lines(tmp_path, mod, as_tensor=False, payloads=True):
    logdir = tmp_path / f"log_{mod.__name__.split('.')[0]}_{as_tensor}"
    undo = _set(mod, log=str(logdir), log_payloads=payloads)
    try:
        inner = _Pml()
        pml = mod.maybe_wrap_pml(inner, SimpleNamespace(client=object(),
                                                        my_world_rank=0))
        assert type(pml).__name__ == "PessimistPml"
        _log_program(pml, as_tensor)
        pml.finalize()
    finally:
        undo()
    return (logdir / "events.0.log").read_text().splitlines(), inner.calls


@pytest.mark.parametrize("payloads", [True, False])
def test_log_lines_equal_the_references(tmp_path, payloads):
    """The same program on the same numpy payloads logs the same lines;
    the port's tensors log the host bytes, and the pml gets the staged
    array (never the tensor, so it stages nothing a second time)."""
    j, jcalls = _log_lines(tmp_path, jvp, payloads=payloads)
    t, tcalls = _log_lines(tmp_path, tvp, payloads=payloads)
    tt, ttcalls = _log_lines(tmp_path, tvp, as_tensor=True,
                             payloads=payloads)
    assert t == j and tt == j
    assert [json.loads(x)["ev"] for x in j] == list(range(1, len(j) + 1))
    assert [json.loads(x).get("sc") for x in j] == [0, 0, 0, 0, 0, 1]
    assert all(("payload" in json.loads(x)) == payloads
               for x in j if '"send"' in x)
    assert tcalls == jcalls
    assert [c[2] for c in ttcalls if c[0] == "send"] == ["ndarray"] * 3
    assert [c[3] for c in ttcalls if c[0] == "send"] == \
        [c[3] for c in tcalls if c[0] == "send"]


@pytest.mark.parametrize("mode", ["off", "log", "replay", "both",
                                  "no_client"])
def test_maybe_wrap_pml_chooses_as_the_reference(tmp_path, mode):
    got = {}
    for name, mod in PKGS.items():
        logdir = tmp_path / name
        logdir.mkdir()
        (logdir / "events.0.log").write_text("")
        vals = {"off": {}, "log": {"log": str(logdir)},
                "replay": {"replay": str(logdir)},
                "both": {"log": str(logdir), "replay": str(logdir)},
                "no_client": {"log": str(logdir)}}[mode]
        undo = _set(mod, **vals)
        try:
            rte = SimpleNamespace(
                client=None if mode == "no_client" else object(),
                my_world_rank=0)
            inner = _Pml()
            out = mod.maybe_wrap_pml(inner, rte)
            got[name] = "inner" if out is inner else type(out).__name__
            if hasattr(out, "_fh"):
                out._fh.close()
        finally:
            undo()
    assert got["torch"] == got["jax"] == {
        "off": "inner", "log": "PessimistPml", "replay": "ReplayPml",
        "both": "ReplayPml", "no_client": "inner"}[mode]


def _write_logs(directory, logs: dict):
    directory.mkdir(exist_ok=True)
    for rank, events in logs.items():
        with open(directory / f"events.{rank}.log", "w") as f:
            for i, e in enumerate(events):
                f.write(json.dumps({**e, "ev": i + 1}) + "\n")


def _send_ev(dst, cid, tag, x, sc):
    import hashlib

    x = np.ascontiguousarray(x)
    return dict(kind="send", cid=cid, dst=dst, tag=tag, nbytes=x.nbytes,
                sha=hashlib.sha1(x.view(np.uint8)).hexdigest()[:16],
                payload=x.view(np.uint8).tobytes().hex(), sc=sc)


def _replay_logs(tmp_path):
    x0, x1 = np.arange(4.0), np.arange(4.0) * 3
    logs = {
        # rank 0 sent twice to 1 on (cid 0, tag 7); rank 1 matched once
        0: [_send_ev(1, 0, 7, x0, 0), _send_ev(1, 0, 7, x1, 1)],
        1: [dict(kind="recv", cid=0, src=0, tag=7, sc=0),
            dict(kind="recv", cid=0, src=0, tag=7, sc=1)],
    }
    _write_logs(tmp_path / "logs", logs)
    return tmp_path / "logs", x0, x1


def _replay(mod, logdir, rank):
    undo = _set(mod, replay=str(logdir), replay_rank=-1)
    try:
        inner = _Pml()
        pml = mod.maybe_wrap_pml(inner, SimpleNamespace(client=object(),
                                                        my_world_rank=rank))
    finally:
        undo()
    return pml, inner


def test_replay_satisfies_receives_from_the_senders_log(tmp_path):
    logdir, x0, x1 = _replay_logs(tmp_path)
    got = {}
    for name, mod in PKGS.items():
        pml, inner = _replay(mod, logdir, 1)
        bufs = [np.zeros(4), np.zeros(4)]
        st0 = pml.recv(_Comm(0), bufs[0], -1, 7)            # ANY_SOURCE
        req = pml.irecv(_Comm(0), bufs[1], 0, 7)
        st1 = req.status
        tail = pml.recv(_Comm(0), np.zeros(4), 0, 7)        # log exhausted
        got[name] = ([b.tobytes() for b in bufs],
                     [(s.source, s.tag, s._nbytes) for s in (st0, st1)],
                     req.complete_flag, pml.replay_active(),
                     (tail.source, tail.tag), inner.calls)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [x0.tobytes(), x1.tobytes()]
    assert got["torch"][-1] == [("recv", 0, 0, 7)]


def test_replay_suppresses_delivered_sends_and_resends_the_rest(tmp_path):
    logdir, x0, x1 = _replay_logs(tmp_path)
    # rank 1's log shows only the first send matched
    _write_logs(logdir, {1: [dict(kind="recv", cid=0, src=0, tag=7, sc=0)]})
    got = {}
    for name, mod in PKGS.items():
        pml, inner = _replay(mod, logdir, 0)
        a = torch.from_numpy(x0) if mod is tvp else x0
        r1 = pml.isend(_Comm(0), a, 1, 7)            # delivered: suppressed
        pml.send(_Comm(0), x1, 1, 7)                 # in flight: re-sent
        pml.send(_Comm(0), x1, 1, 8)                 # log exhausted: live
        got[name] = (r1.complete_flag, inner.calls)
    assert got["torch"] == got["jax"]
    assert [c[5] for c in got["torch"][1]] == [7, 8]


DIVERGENT = {
    "send_tag": lambda pml, x: pml.send(_Comm(0), x, 1, 99),
    "send_dst": lambda pml, x: pml.send(_Comm(0), x, 2, 7),
    "send_cid": lambda pml, x: pml.send(_Comm(3), x, 1, 7),
    "send_nbytes": lambda pml, x: pml.send(_Comm(0), x[:2], 1, 7),
    "send_sha": lambda pml, x: pml.send(_Comm(0), x + 1, 1, 7),
}
DIVERGENT_RECV = {
    "recv_source": lambda pml: pml.recv(_Comm(0), np.zeros(4), 2, 7),
    "recv_tag": lambda pml: pml.recv(_Comm(0), np.zeros(4), 0, 8),
    "recv_cid": lambda pml: pml.recv(_Comm(5), np.zeros(4), 0, 7),
}


@pytest.mark.parametrize("case", sorted(DIVERGENT) + sorted(DIVERGENT_RECV)
                         + ["no_payload", "clock"])
def test_divergence_is_detected_with_the_references_message(tmp_path, case):
    """A re-execution that does not match the log fails loudly, with
    ``ReplayDivergence`` and the reference's message, before anything
    reaches the pml."""
    logdir, x0, _ = _replay_logs(tmp_path)
    if case == "no_payload":
        ev = _send_ev(1, 0, 7, x0, 0)
        del ev["payload"]
        _write_logs(logdir, {0: [ev]})
    elif case == "clock":
        _write_logs(logdir, {0: [_send_ev(1, 0, 7, x0, 5)]})
    got = {}
    for name, mod in PKGS.items():
        rank = 0 if case in DIVERGENT else 1
        pml, inner = _replay(mod, logdir, rank)
        with pytest.raises(mod.ReplayDivergence) as exc:
            if case in DIVERGENT:
                DIVERGENT[case](pml, torch.from_numpy(x0.copy())
                                if mod is tvp else x0.copy())
            elif case in DIVERGENT_RECV:
                DIVERGENT_RECV[case](pml)
            else:
                pml.recv(_Comm(0), np.zeros(4), 0, 7)
        got[name] = (str(exc.value), inner.calls)
    assert got["torch"] == got["jax"] and got["torch"][1] == []


def test_the_boot_wraps_vprotocol_outside_monitoring(tmp_path, monkeypatch):
    """With logging and monitoring both on, the instance's pml is
    vprotocol's wrapper around monitoring's (a replayed receive never
    reaches monitoring), in both packages."""
    import ompi_tpu
    import ompi_tpu_torch
    from ompi_tpu_torch.rte.coord import CoordServer

    got = {}
    for name, pkg in (("torch", ompi_tpu_torch), ("jax", ompi_tpu)):
        srv = CoordServer(1)
        monkeypatch.setenv("OTPU_COORD", f"{srv.addr[0]}:{srv.addr[1]}")
        monkeypatch.setenv("OTPU_RANK", "0")
        monkeypatch.setenv("OTPU_NPROCS", "1")
        root = pkg.__name__
        rt = __import__(f"{root}.runtime.init", fromlist=["x"])
        inst = __import__(f"{root}.instance", fromlist=["x"])
        reg = __import__(f"{root}.base.var", fromlist=["x"]).registry
        __import__(f"{root}.runtime.monitoring", fromlist=["x"])
        rt.reset_for_testing()
        undo = _set(PKGS[name], log=str(tmp_path / name))
        reg.set("otpu_monitoring_enable", True)
        try:
            pkg.init(device="cpu") if pkg is ompi_tpu_torch else pkg.init()
            pml = inst.current().pml
            got[name] = (type(pml).__name__, type(pml._inner).__name__)
        finally:
            rt.reset_for_testing()
            reg.set("otpu_monitoring_enable", False)
            undo()
            srv.close()
    assert got == {"torch": ("PessimistPml", "MonitoringPml"),
                   "jax": ("PessimistPml", "MonitoringPml")}


# -- the reference's replay scenarios, in tpurun jobs -----------------------

NITER_TOTAL = 5
DIE_ROUND = 2

#: ``test_vprotocol_replay.py``'s two programs as one: a ring over ``w``
#: and its dup ``d``; the even ranks emit w then d, the odd ranks d then w,
#: and each consumes in the other order from its odd or even neighbour, so
#: every pairing crosses channels.  Rank 1 dies between its two receives of
#: round DIE_ROUND, with the w message of that round in flight.
REPLAY_PROGRAM = textwrap.dedent("""
    import os
    import numpy as np
    import torch
    import ompi_tpu_torch

    niter = int(os.environ["VP_NITER"])
    die = os.environ.get("VP_DIE", "") == "1"
    w = ompi_tpu_torch.init(device="cpu")
    d = w.dup()
    n, r = w.size, w.rank
    nxt, prv = (r + 1) % n, (r - 1) % n
    state = torch.full((4,), float(r + 1), dtype=torch.float64)
    for it in range(niter):
        a = 0.5 * state + float(it)          # the w-channel payload
        b = 0.25 * state - float(it)         # the d-channel payload
        if r % 2 == 0:
            q1 = w.isend(a, dest=nxt, tag=7)
            q2 = d.isend(b, dest=nxt, tag=7)
        else:
            q2 = d.isend(b, dest=nxt, tag=7)
            q1 = w.isend(a, dest=nxt, tag=7)
        in_a, in_b = np.empty(4), np.empty(4)
        if prv % 2 == 0:                     # prv emitted w then d
            d.recv(in_b, source=prv, tag=7)
            if die and r == 1 and it == DIE_ROUND:
                os._exit(9)                  # w of this round in flight
            w.recv(in_a, source=prv, tag=7)
        else:                                # prv emitted d then w
            w.recv(in_a, source=prv, tag=7)
            d.recv(in_b, source=prv, tag=7)
        q1.wait()
        q2.wait()
        state = (0.3 * state + 0.6 * torch.from_numpy(in_a)
                 - 0.2 * torch.from_numpy(in_b) + float(it))
    np.save(os.environ["VP_OUT"] + f".{r}.npy", state.numpy())
    pml = w.pml
    print(f"PML {r} {type(pml).__name__} {getattr(pml, '_si', -1)} "
          f"{getattr(pml, '_ri', -1)}", flush=True)
    print(f"DONE {r}", flush=True)
    ompi_tpu_torch.finalize()
""").replace("DIE_ROUND", str(DIE_ROUND))


def _expected(niter, n=3):
    states = [torch.full((4,), float(r + 1), dtype=torch.float64)
              for r in range(n)]
    for it in range(niter):
        prev = list(states)
        for r in range(n):
            p = prev[(r - 1) % n]
            in_a = (0.5 * p + float(it)).numpy()
            in_b = (0.25 * p - float(it)).numpy()
            states[r] = (0.3 * prev[r] + 0.6 * torch.from_numpy(in_a)
                         - 0.2 * torch.from_numpy(in_b) + float(it))
    return [s.numpy() for s in states]


def _tpurun(launcher, n, script, env_extra, mca=(), timeout=120):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("OTPU_RANK", None)
    env.pop("OTPU_NPROCS", None)
    env.update(env_extra)
    cmd = [sys.executable, "-m", launcher, "-n", str(n), "--enable-recovery"]
    for k, v in mca:
        cmd += ["--mca", k, v]
    cmd += [sys.executable, str(script)]
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, cwd=REPO, env=env)


def _pml_lines(stdout):
    """The ``PML`` lines of a job: (rank, pml class, sends verified against
    the log, receives replayed from it), -1 where the pml keeps no count."""
    out = []
    for line in stdout.splitlines():
        if "PML " in line:
            r, name, si, ri = line.split("PML ", 1)[1].split()
            out.append((int(r), name, int(si), int(ri)))
    return out


def test_replay_after_a_midround_death_across_two_comms(tmp_path):
    """Phase A logs with payloads until rank 1 dies mid-round; phase B
    re-drives every rank from the logs (suppressed sends where delivery is
    proven, a live re-send of the message in flight, receives from the
    senders' logged payloads paired by channel clock across the two
    comms), then finishes live.  Final states bit for bit."""
    logdir = tmp_path / "logs"
    prog = tmp_path / "prog.py"
    prog.write_text(REPLAY_PROGRAM)
    ra = _tpurun("ompi_tpu_torch.tools.tpurun", 3, prog,
                 {"VP_NITER": str(DIE_ROUND + 1), "VP_DIE": "1",
                  "VP_OUT": str(tmp_path / "a")},
                 mca=[("vprotocol_pessimist_log", str(logdir)),
                      ("vprotocol_pessimist_log_payloads", "1"),
                      ("ft_detector", "true"),
                      ("ft_detector_period", "0.2"),
                      ("ft_detector_timeout", "1.5")])
    assert ra.stdout.count("DONE") == 2, ra.stdout[-3000:] + ra.stderr[-3000:]
    assert not (tmp_path / "a.1.npy").exists()       # rank 1 really died
    want_a = _expected(DIE_ROUND + 1)
    for r in (0, 2):
        assert np.load(tmp_path / f"a.{r}.npy").tobytes() == \
            want_a[r].tobytes()
    logged = tvp.read_log(str(logdir), 1)
    assert [e["kind"] for e in logged[-3:]] == ["send", "send", "recv"]

    rb = _tpurun("ompi_tpu_torch.tools.tpurun", 3, prog,
                 {"VP_NITER": str(NITER_TOTAL), "VP_DIE": "0",
                  "VP_OUT": str(tmp_path / "b")},
                 mca=[("vprotocol_pessimist_replay", str(logdir))])
    assert rb.returncode == 0, rb.stdout[-3000:] + rb.stderr[-3000:]
    assert rb.stdout.count("DONE") == 3
    # every rank really ran under ReplayPml and consumed its whole log: a
    # live rerun of the (deterministic) program would end in the same states
    assert sorted(_pml_lines(ra.stdout)) == [
        (0, "PessimistPml", -1, -1), (2, "PessimistPml", -1, -1)]
    replayed = sorted(_pml_lines(rb.stdout))
    for r in range(3):
        events = tvp.read_log(str(logdir), r)
        sends = sum(e["kind"] == "send" for e in events)
        recvs = sum(e["kind"] == "recv" for e in events)
        assert sends and recvs
        assert replayed[r] == (r, "ReplayPml", sends, recvs), replayed
    want = _expected(NITER_TOTAL)
    for r in range(3):
        assert np.load(tmp_path / f"b.{r}.npy").tobytes() == \
            want[r].tobytes(), f"rank {r} diverged after replay"


LOG_PROGRAM = textwrap.dedent("""
    import sys
    import numpy as np
    PKG = sys.argv[1]
    if PKG == "torch":
        import torch
        import ompi_tpu_torch as m
        w = m.init(device="cpu")
        wrap = torch.from_numpy
    else:
        import ompi_tpu as m
        w = m.init()
        wrap = np.asarray
    d = w.dup()
    n, r = w.size, w.rank
    rng = np.random.default_rng(100 + r)
    for it in range(3):
        x = rng.standard_normal(6)
        q = w.isend(wrap(x), dest=(r + 1) % n, tag=7)
        inbuf = np.empty(6)
        w.recv(inbuf, source=(r - 1) % n, tag=7)
        q.wait()
        y = rng.integers(-5, 5, 3 + it, dtype=np.int32)
        q = d.isend(wrap(y), dest=(r - 1) % n, tag=it)
        got = np.empty(3 + it, np.int32)
        d.recv(got, source=(r + 1) % n, tag=it)
        q.wait()
    print("LOGGED", r, flush=True)
    m.finalize()
""")


def test_event_logs_equal_between_the_packages(tmp_path):
    """One deterministic 3-rank program (tensors in the port, numpy in the
    reference, the same values), logged with payloads by each package's
    ``tpurun``: every rank's log is the same, line for line."""
    script = tmp_path / "logprog.py"
    script.write_text(LOG_PROGRAM)
    logs = {}
    for pkg, launcher in (("torch", "ompi_tpu_torch.tools.tpurun"),
                          ("jax", "ompi_tpu.tools.tpurun")):
        logdir = tmp_path / f"logs_{pkg}"
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("OTPU_RANK", None)
        env.pop("OTPU_NPROCS", None)
        r = subprocess.run(
            [sys.executable, "-m", launcher, "-n", "3",
             "--mca", "vprotocol_pessimist_log", str(logdir),
             "--mca", "vprotocol_pessimist_log_payloads", "1",
             sys.executable, str(script), pkg],
            capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
        assert r.returncode == 0, (pkg, r.stdout[-3000:], r.stderr[-3000:])
        logs[pkg] = {rank: (logdir / f"events.{rank}.log").read_text()
                     for rank in range(3)}
    assert logs["torch"] == logs["jax"]
    events = [json.loads(x) for x in logs["torch"][0].splitlines()]
    # four operations a round, after the dup's CID agreement over the pml
    user = [e for e in events if e["tag"] >= 0]
    assert len(user) == 12 and all("payload" in e for e in events
                                   if e["kind"] == "send")
    assert {e["cid"] for e in user} == {0, events[-1]["cid"]} \
        and events[-1]["cid"] != 0
