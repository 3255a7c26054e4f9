"""ULFM and topologies in the multi-process world, held against the JAX
package: the reference's ``tests/test_ft.py`` and ``tests/test_topo.py``
jobs, each run by both packages' ``tpurun`` in turn (the port's ranks bind
``--device cpu``), with the same script and the same expected outcome.

Jobs: the launcher detects a death and the survivors shrink; ``agree``
with a failure (``ProcFailedError`` with the agreed flag, then agreement
after ``ack_failed``); revocation between processes, and over the p2p
flood with the event bus down; the heartbeat detector finds a silent
peer, and ranks blocked in a receive keep their heartbeats flowing over
btl/sm and btl/tcp's reactor lane with the coordination carrier gagged;
the ERA agreement survives its root's death with the coordination
service gagged; a double failure; the ``tree`` and ``kv`` algorithms; a
halo exchange on a ``-n 4`` cart; a recovery job traced, whose merged
timeline holds the ``ft`` instants and the ``agree_*`` spans under the
reference's names.  The port's own jobs: a dead RGET puller (the sender's
request completes in error, its numpy buffer is writable again and its
segment back in the pool, and its next send works) and a dead member in a
coll/sm allreduce (the survivors raise ``ProcFailedError``, shrink, and
none hangs).  Every subprocess has its own ``timeout=``.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

PRELUDE = '''
import os, sys, time
import numpy as np

PKG = sys.argv[1]
if PKG == "torch":
    import ompi_tpu_torch as m
    from ompi_tpu_torch.api.errhandler import ERRORS_RETURN
    from ompi_tpu_torch.api.errors import ProcFailedError, RevokedError
    from ompi_tpu_torch.ft import propagator
    from ompi_tpu_torch.ft import state as ft_state
    from ompi_tpu_torch.runtime.progress import progress

    def init():
        return m.init(device="cpu")
else:
    import ompi_tpu as m
    from ompi_tpu.api.errhandler import ERRORS_RETURN
    from ompi_tpu.api.errors import ProcFailedError, RevokedError
    from ompi_tpu.ft import propagator
    from ompi_tpu.ft import state as ft_state
    from ompi_tpu.runtime.progress import progress

    def init():
        return m.init()


def wait_failed(*ranks):
    deadline = time.time() + 60
    while not all(ft_state.is_failed(r) for r in ranks):
        if time.time() > deadline:
            sys.exit(f"failure of {ranks} never detected")
        time.sleep(0.05)
'''

SCRIPTS = {
    "shrink": '''
        w = init()
        w.barrier()
        if w.rank == 1:
            os._exit(13)  # sudden death, no cleanup
        wait_failed(1)
        assert w.get_failed().size == 1
        s = w.shrink()
        assert s.size == 3, s.size
        assert s.epoch == 1
        out = s.allreduce(np.array([float(s.rank + 1)]))
        assert out[0] == 6.0, out
        print("FT SHRINK OK", s.rank, list(s.group.world_ranks), flush=True)
        m.finalize()
    ''',
    "agree": '''
        w = init()
        w.set_errhandler(ERRORS_RETURN)
        got = w.agree(0b1110 if w.rank else 0b0111)
        assert got == 0b0110, got
        w.barrier()
        if w.rank == 2:
            os._exit(7)
        wait_failed(2)
        try:
            w.agree(0b11)
            sys.exit("expected ProcFailedError")
        except ProcFailedError as e:
            assert e.flag == 0b11, e.flag
            failed = list(e.failed_ranks)
        w.ack_failed()
        assert w.agree(0b11) == 0b11
        print("FT AGREE OK", w.rank, failed, flush=True)
        m.finalize()
    ''',
    "revoke": '''
        w = init()
        w.set_errhandler(ERRORS_RETURN)
        d = w.dup()
        if w.rank == 0:
            d.revoke()
        deadline = time.time() + 60
        while not d.is_revoked():
            if time.time() > deadline:
                sys.exit("revocation never arrived")
            time.sleep(0.05)
        try:
            d.barrier()
            sys.exit("expected RevokedError")
        except RevokedError:
            pass
        w.barrier()  # the parent comm is unaffected
        print("FT REVOKE OK", w.rank, flush=True)
        m.finalize()
    ''',
    "revflood": '''
        w = init()
        w.set_errhandler(ERRORS_RETURN)
        d = w.dup()
        # kill the event-bus leg everywhere: only the p2p flood remains
        propagator._poller.stop()
        w.barrier()
        if w.rank == 0:
            d.revoke()
        deadline = time.time() + 60
        while not d.is_revoked():
            if time.time() > deadline:
                sys.exit("revocation never arrived over p2p")
            progress()
            time.sleep(0.002)
        try:
            d.barrier()
            sys.exit("expected RevokedError")
        except RevokedError:
            pass
        print("REVFLOOD OK", w.rank, flush=True)
        m.finalize()
    ''',
    "detector": '''
        w = init()
        w.barrier()
        if w.rank == 1:
            # a hang: alive (the launcher sees nothing) but silent; the
            # emitter stops WITHOUT the clean-exit tombstone
            propagator._detector._stop.set()
            time.sleep(4)
            sys.exit(0)
        wait_failed(1)
        print("FT DETECTOR OK", w.rank, flush=True)
        m.finalize()
    ''',
    "rootdeath": '''
        w = init()
        w.barrier()
        if w.rank == 0:
            time.sleep(0.3)
            os._exit(11)   # the agreement tree's root dies
        # gag the shared coord client's KV surface: any decision-path use
        # of the coordination service now fails loudly
        client = w.rte.client
        def _gagged(*a, **k):
            raise AssertionError("agreement touched the coord service")
        client.get = _gagged
        client.put_new = _gagged
        client.delete = _gagged
        got = w.agree(0b1101 if w.rank == 1 else 0b0111)
        assert got == 0b0101, got
        wait_failed(0)
        w.ack_failed()
        got2 = w.agree(0b11)
        assert got2 == 0b11, got2
        print("ROOTDEATH OK", w.rank, flush=True)
        m.finalize()
    ''',
    "double": '''
        w = init()
        w.barrier()
        if w.rank in (1, 2):
            time.sleep(0.5)
            os._exit(1)          # both die abruptly, no tombstone
        wait_failed(1, 2)
        print("DOUBLE OK", w.rank, flush=True)
        m.finalize()
    ''',
    "alg": '''
        w = init()
        got = w.agree(0b1011 if w.rank % 2 else 0b1110)
        assert got == 0b1010, bin(got)
        print("ALG OK", w.rank, flush=True)
        m.finalize()
    ''',
    "halo": '''
        w = init()
        cart = w.cart_create([2, 2], periods=[True, True])
        dims, periods, coords = cart.cart_get()
        local = np.full(4, float(cart.rank))
        halos = []
        for d in range(2):
            src, dst = cart.cart_shift(d, 1)
            halo = np.zeros(4)
            cart.sendrecv(local, dst, halo, src)
            expect = cart.cart_rank(
                [(c - (1 if i == d else 0)) % dims[i]
                 for i, c in enumerate(coords)])
            assert halo[0] == float(expect), (d, halo, expect)
            halos.append(int(halo[0]))
        got = cart.neighbor_allgather(local)
        a2a = cart.neighbor_alltoall(
            [np.array([cart.rank * 10 + k], np.int64) for k in range(4)])
        sub = cart.cart_sub([False, True])
        row = sub.allreduce(np.array([cart.rank], np.int64))
        st = w.split_type("shared")
        print("HALO", cart.rank, coords, halos,
              [int(g[0]) for g in got], [int(x[0]) for x in a2a],
              sub.size, int(row[0]), st.size, w.cart_map([2, 2])
              if hasattr(w, "cart_map") else None, flush=True)
        m.finalize()
    ''',
    "traced": '''
        w = init()
        w.set_errhandler(ERRORS_RETURN)
        w.barrier()
        if w.rank == 1:
            propagator._detector._stop.set()   # silent, no tombstone
            time.sleep(6)
            os._exit(0)
        wait_failed(1)
        try:
            w.agree(1)
            sys.exit("expected ProcFailedError")
        except ProcFailedError:
            pass
        w.ack_failed()
        assert w.agree(1) == 1
        s = w.shrink()
        out = s.allreduce(np.array([1.0]))
        assert out[0] == 2.0, out
        print("TRACED OK", w.rank, flush=True)
        m.finalize()
    ''',
    "blocked": '''
        w = init()
        w.barrier()
        # the coordination service's carrier gagged on the detector: only
        # the heartbeat frames over the btl keep the ring quiet
        def _gagged(*a, **k):
            raise ConnectionError("gagged")
        propagator._detector.client.put = _gagged
        propagator._detector.client.get = _gagged
        if w.rank == 2:
            until = time.time() + 4
            while time.time() < until:     # busy, but progressing
                progress()
                time.sleep(0.01)
            for dest in (0, 1):
                w.send(np.array([7.0]), dest=dest, tag=9)
        else:
            got = np.zeros(1)
            w.recv(got, source=2, tag=9)   # blocked for ~4 s
            assert got[0] == 7.0
        w.barrier()
        print("BLOCKED", w.rank, sorted(ft_state.failed_ranks()), flush=True)
        m.finalize()
    ''',
    "rget": '''
        w = init()
        w.set_errhandler(ERRORS_RETURN)
        big = np.arange(1 << 19, dtype=np.float32)     # 2 MB: the RGET rung
        w.barrier()
        if w.rank == 0:
            req = w.isend(big, dest=1, tag=5)
            assert not big.flags.writeable           # the memchecker guard
            w.send(np.zeros(1), dest=1, tag=6)       # rank 1 may die now
            wait_failed(1)
            try:
                req.wait()
                sys.exit("expected ProcFailedError")
            except ProcFailedError:
                pass
            from_pml = w.pml
            while not hasattr(from_pml, "bml"):
                from_pml = from_pml._inner
            exposed = [len(getattr(b, "_exposed", {}))
                       for b in from_pml.bml.btls]
            w.send(big, dest=2, tag=7)               # the next send works
            print("RGET", w.rank, bool(big.flags.writeable), exposed,
                  flush=True)
        elif w.rank == 1:
            w.recv(np.zeros(1), source=0, tag=6)
            os._exit(9)                              # never pulls
        else:
            got = np.zeros(1 << 19, np.float32)
            w.recv(got, source=0, tag=7)
            print("RGET", w.rank, bool(np.array_equal(got, big)), flush=True)
        m.finalize()
    ''',
    "collsm": '''
        w = init()
        w.set_errhandler(ERRORS_RETURN)
        owner = type(w.c_coll["allreduce"].__self__).__name__
        x = np.full(256, float(w.rank + 1))
        assert w.allreduce(x)[0] == 6.0
        if w.rank == 2:
            os._exit(5)
        try:
            w.allreduce(x)
            sys.exit("expected ProcFailedError")
        except ProcFailedError as e:
            failed = list(e.failed_ranks)
        s = w.shrink()
        out = s.allreduce(x)
        print("COLLSM", w.rank, owner, failed, s.size, float(out[0]),
              flush=True)
        m.finalize()
    ''',
}

DETECTOR = ["--mca", "ft_detector", "true",
            "--mca", "ft_detector_period", "0.2",
            "--mca", "ft_detector_timeout", "1.5"]
GRACE = ["--mca", "ft_detector_startup_grace", "2.0"]


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ftmp")
    out = {}
    for name, body in SCRIPTS.items():
        path = d / f"{name}.py"
        path.write_text(PRELUDE + textwrap.dedent(body))
        out[name] = path
    return out


def _launch(pkg, n, args):
    env = dict(os.environ)
    env.pop("OTPU_RANK", None)
    env.pop("OTPU_NPROCS", None)
    launcher = "ompi_tpu_torch.tools.tpurun" if pkg == "torch" \
        else "ompi_tpu.tools.tpurun"
    return subprocess.Popen(
        [sys.executable, "-m", launcher, "-n", str(n), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=env, start_new_session=True)


def _run(pkg, n, args, timeout):
    """One job to its end; on a timeout the launcher's whole process group
    is killed first."""
    p = _launch(pkg, n, args)
    try:
        o, e = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
    return subprocess.CompletedProcess(p.args, p.returncode, o, e)


def _both(scripts, name, n, args=(), timeout=120):
    """Both packages' jobs, one after the other (the detector's timeouts
    must not meet a doubled load); {pkg: CompletedProcess}."""
    return {pkg: _run(pkg, n, [*args, sys.executable, str(scripts[name]),
                               pkg], timeout)
            for pkg in ("torch", "jax")}


def _tagged(stdout, tag):
    """Sorted lines of the job's output that start with ``tag`` (the rank
    prefix dropped)."""
    rows = []
    for line in stdout.splitlines():
        _, _, rest = line.partition("] ")
        if rest.startswith(tag):
            rows.append(rest)
    return sorted(rows)


def _same(res, tag, count):
    t, j = _tagged(res["torch"].stdout, tag), _tagged(res["jax"].stdout, tag)
    assert len(t) == count, res["torch"].stdout + res["torch"].stderr
    assert t == j, (t, j, res["jax"].stdout + res["jax"].stderr)
    for pkg in ("torch", "jax"):
        assert res[pkg].returncode == 0, (pkg, res[pkg].stdout
                                          + res[pkg].stderr)
    return t


def test_launcher_detects_death_survivors_shrink(scripts):
    res = _both(scripts, "shrink", 4, ["--enable-recovery"])
    rows = _same(res, "FT SHRINK OK", 3)
    assert rows == ["FT SHRINK OK 0 [0, 2, 3]", "FT SHRINK OK 1 [0, 2, 3]",
                    "FT SHRINK OK 2 [0, 2, 3]"]
    assert "rank 1 failed (exit 13); continuing (recovery)" \
        in res["torch"].stderr


def test_agree_with_failure_and_ack(scripts):
    rows = _same(_both(scripts, "agree", 3, ["--enable-recovery"]),
                 "FT AGREE OK", 2)
    assert rows == ["FT AGREE OK 0 [2]", "FT AGREE OK 1 [2]"]


def test_revoke_propagates_between_processes(scripts):
    _same(_both(scripts, "revoke", 3), "FT REVOKE OK", 3)


def test_revoke_floods_with_event_bus_down(scripts):
    _same(_both(scripts, "revflood", 3), "REVFLOOD OK", 3)


def test_heartbeat_detector_finds_silent_peer(scripts):
    _same(_both(scripts, "detector", 3, ["--enable-recovery", *DETECTOR]),
          "FT DETECTOR OK", 2)


@pytest.mark.parametrize("btl", ["sm", "tcp"])
def test_a_blocked_receiver_keeps_its_heartbeats(scripts, btl):
    """Ranks blocked for 4 s in a receive (and one busy rank that only
    progresses) with the detector's coordination carrier gagged: the
    emitter threads' frames over btl/sm, or btl/tcp's reactor lane, keep
    every observer fed, so no rank is declared failed."""
    args = ["--mca", "btl", "tcp,self"] if btl == "tcp" else []
    rows = _same(_both(scripts, "blocked", 3, [*args, *DETECTOR, *GRACE]),
                 "BLOCKED", 3)
    assert rows == ["BLOCKED 0 []", "BLOCKED 1 []", "BLOCKED 2 []"]


def test_agree_survives_root_death_with_coord_gagged(scripts):
    _same(_both(scripts, "rootdeath", 4,
                ["--enable-recovery", *DETECTOR, *GRACE], timeout=150),
          "ROOTDEATH OK", 3)


def test_detector_survives_double_failure(scripts):
    res = _both(scripts, "double", 4,
                ["--enable-recovery", *DETECTOR, *GRACE], timeout=150)
    assert _tagged(res["torch"].stdout, "DOUBLE OK") == \
        _tagged(res["jax"].stdout, "DOUBLE OK") == ["DOUBLE OK 0",
                                                   "DOUBLE OK 3"]


@pytest.mark.parametrize("alg", ["tree", "kv"])
def test_alternate_algorithms_agree(scripts, alg):
    _same(_both(scripts, "alg", 3, ["--mca", "coll_ftagree_algorithm", alg]),
          "ALG OK", 3)


def test_halo_exchange_on_a_cart(scripts):
    rows = _same(_both(scripts, "halo", 4), "HALO", 4)
    assert rows[0].startswith("HALO 0 [0, 0] [2, 1] [2, 2, 1, 1]")


def test_a_traced_recovery_has_the_ft_spans(scripts, tmp_path):
    """The heartbeat ring reports the silent rank (``ft_report_failure`` on
    its observer), the event bus delivers it to the others
    (``ft_event_delivered``), and the agreements and the shrink are
    ``agree_p2p`` and ``agree_kv`` spans: the same names in both merged
    timelines."""
    names = {}
    for pkg in ("torch", "jax"):
        tdir = tmp_path / pkg
        r = _run(pkg, 3, [
            "--enable-recovery", *DETECTOR, "--mca", "otpu_trace_enable", "1",
            "--mca", "otpu_trace_dir", str(tdir), sys.executable,
            str(scripts["traced"]), pkg], 150)
        assert r.returncode == 0, (pkg, r.stdout + r.stderr)
        assert len(_tagged(r.stdout, "TRACED OK")) == 2, (pkg, r.stdout
                                                          + r.stderr)
        merged = json.loads((tdir / "trace_merged.json").read_text())
        names[pkg] = {(ev["name"], ev.get("ph")) for ev in
                      merged["traceEvents"] if ev.get("cat") == "ft"}
    for pkg in names:
        got = {n for n, _ in names[pkg]}
        assert {"ft_report_failure", "ft_event_delivered", "agree_p2p",
                "agree_kv"} <= got, (pkg, names[pkg])
    assert names["torch"] == names["jax"]


def test_a_dead_rget_puller_releases_the_sender(scripts):
    rows = _same(_both(scripts, "rget", 3, [
        "--enable-recovery", "--mca", "otpu_memchecker_enable", "1"]),
        "RGET", 2)
    assert rows[0].startswith("RGET 0 True [") and rows[1] == "RGET 2 True"
    exposed = json.loads(rows[0].split(" ", 3)[3])
    assert exposed and not any(exposed), rows


def test_a_dead_member_of_a_coll_sm_allreduce(scripts):
    res = _both(scripts, "collsm", 3, ["--enable-recovery"])
    rows = _same(res, "COLLSM", 2)
    assert rows == ["COLLSM 0 SmCollModule [2] 2 3.0",
                    "COLLSM 1 SmCollModule [2] 2 3.0"]
    # the survivors unmap the world's segment at finalize
    for r in res.values():
        assert "BufferError" not in r.stdout + r.stderr, r.stdout + r.stderr
