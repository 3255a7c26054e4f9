"""Dynamic process management in the port (``ompi_tpu_torch/dpm.py``, the
coordination service's ``spawn``, ``tpurun``'s spawn handler, the rte's job
identity, intercommunicators and coll/inter), held against the JAX package,
after ``tests/test_dpm.py``.

Each job runs with both packages' ``tpurun`` in turn (the port's ranks
bind ``device="cpu"``) and the tagged lines they print must be equal:
parent and children ping-pong over the spawn intercomm, allreduce across it
(each side gets the other side's sum), merge (children after parents) and
allreduce on the merged comm, then ``spawn_multiple`` with one argv a child
and the ``mpi://job/<id>`` psets; two halves of a job meet by
``publish_name``/``lookup_name`` and ``accept``/``connect``, exchange over
the intercomm, merge, and find the service gone after ``unpublish_name``
(``ERR_NAME``); two ranks meet by ``dpm.join`` over a socket pair and by
``create_intercomm`` over two 1-rank comms bridged by the world, exchange
and allreduce across each, and merge the second; the ULFM recovery loop (a rank dies, the survivors revoke,
shrink, spawn a replacement and merge back to full size); a child that dies
in its join (``ERR_SPAWN``, the parent's world still works).  In one
process, with a coordination client that allocates too few ranks or never
sees the children join: ``ERR_SPAWN`` and the bridge CID given back, in
both packages.  Integer data, so every sum is exact.  Every subprocess has
its own ``timeout=``.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import ompi_tpu
import ompi_tpu_torch

REPO = Path(__file__).resolve().parent.parent

PRELUDE = '''
import json, os, sys, time
import numpy as np

PKG = sys.argv[1]
HERE = os.path.dirname(os.path.abspath(__file__))
if PKG == "torch":
    import ompi_tpu_torch as m
    from ompi_tpu_torch import dpm
    from ompi_tpu_torch.api.errors import MpiError
    from ompi_tpu_torch.base.var import registry
    KW = {"device": "cpu"}
else:
    import ompi_tpu as m
    from ompi_tpu import dpm
    from ompi_tpu.api.errors import MpiError
    from ompi_tpu.base.var import registry
    KW = {}


def out(tag, *vals):
    print(tag, json.dumps(vals), flush=True)


def ints(a):
    return np.asarray(a).astype(np.int64).ravel().tolist()


def script(name, *args):
    return [sys.executable, os.path.join(HERE, name + ".py"), PKG, *args]
'''

SCRIPTS = {
    "child": '''
        w = m.init(**KW)
        parent = m.get_parent()
        tag = sys.argv[2] if len(sys.argv) > 2 else "-"
        if w.rank == 0 and tag == "-":
            buf = np.zeros(4, np.int64)
            parent.recv(buf, 0, tag=5)
            parent.send(buf * 2, 0, tag=6)
        red = parent.allreduce(np.array([100 * (w.rank + 1), 1], np.int64))
        full = parent.merge(high=True)
        tot = full.allreduce(np.array([full.rank + 1], np.int64))
        out("CHILD", tag, w.rank, w.size, list(w.group.world_ranks),
            parent.is_inter, parent.remote_size, ints(red), full.size,
            full.rank, ints(tot))
        m.finalize()
    ''',
    "spawn": '''
        w = m.init(**KW)
        inter = w.spawn(script("child"), 2)
        got = np.zeros(4, np.int64)
        if w.rank == 0:
            inter.send(np.arange(4, dtype=np.int64) + 21, 0, tag=5)
            inter.recv(got, 0, tag=6)
        red = inter.allreduce(np.array([w.rank + 1, 10], np.int64))
        full = inter.merge(high=False)
        tot = full.allreduce(np.array([full.rank + 1], np.int64))
        out("PARENT", w.rank, inter.is_inter, inter.size, inter.remote_size,
            list(inter.remote_group.world_ranks), inter.spawn_job,
            ints(got), ints(red), full.size, full.rank, ints(tot),
            list(full.group.world_ranks))
        multi = w.spawn_multiple([script("child", "a"), script("child", "b")],
                                 [1, 1])
        red2 = multi.allreduce(np.array([w.rank + 1, 10], np.int64))
        full2 = multi.merge(high=False)
        tot2 = full2.allreduce(np.array([full2.rank + 1], np.int64))
        s = m.Session.init(**KW)
        jobs = [[n, s.get_pset_info(n).get("otpu_members"),
                 s.get_pset_info(n).get("otpu_source")]
                for n in s.psets() if n.startswith("mpi://job/")]
        out("MULTI", w.rank, multi.remote_size, multi.spawn_job,
            list(multi.remote_group.world_ranks), ints(red2), full2.size,
            ints(tot2), sorted(jobs))
        s.finalize()
        m.finalize()
    ''',
    "connect": '''
        w = m.init(**KW)
        side = w.split(0 if w.rank < 2 else 1)
        if w.rank < 2:
            port = dpm.open_port(w)
            if side.rank == 0:
                dpm.publish_name("calc-svc", port, w)
            inter = side.accept(port)
        else:
            port = dpm.lookup_name("calc-svc", w, wait=True)
            inter = side.connect(port)
        got = np.zeros(2, np.int64)
        if side.rank == 0:
            if w.rank < 2:
                inter.recv(got, 0, tag=1)
            else:
                inter.send(np.array([77, w.rank], np.int64), 0, tag=1)
        red = inter.allreduce(np.array([w.rank + 1], np.int64))
        full = inter.merge(high=w.rank >= 2)
        tot = full.allreduce(np.array([w.rank * 10], np.int64))
        w.barrier()
        err = None
        if w.rank == 0:
            dpm.unpublish_name("calc-svc", w)
            try:
                dpm.lookup_name("calc-svc", w)
            except MpiError as exc:
                err = exc.error_class.name
        out("CONNECT", w.rank, port.startswith("otpu-port-"), inter.is_inter,
            inter.remote_size, list(inter.remote_group.world_ranks),
            ints(got), ints(red), full.size, full.rank, ints(tot), err)
        m.finalize()
    ''',
    "replacement": '''
        w = m.init(**KW)
        full = m.get_parent().merge(high=True)
        tot = full.allreduce(np.array([full.rank + 1], np.int64))
        out("REPLACED", w.rank, list(w.group.world_ranks), full.size,
            full.rank, ints(tot))
        m.finalize()
    ''',
    "recover": '''
        w = m.init(**KW)
        r = w.rank
        w.barrier()
        if r == 1:
            os._exit(1)                     # die before doing anything
        deadline = time.time() + 60
        while not w.get_failed().size:
            assert time.time() < deadline, "failure never detected"
            time.sleep(0.05)
        w.revoke()
        survivors = w.shrink()
        inter = survivors.spawn(script("replacement"), 1)
        full = inter.merge(high=False)
        tot = full.allreduce(np.array([full.rank + 1], np.int64))
        s = m.Session.init(**KW)
        names = s.psets()
        out("RECOVERED", r, survivors.size, list(inter.remote_group.world_ranks),
            full.size, full.rank, list(full.group.world_ranks), ints(tot),
            "mpi://surviving" in names,
            f"mpi://shrunk/{survivors.cid}" in names)
        s.finalize()
        m.finalize()
    ''',
    "join": '''
        import socket
        w = m.init(**KW)
        if w.rank == 0:                  # a plain connected socket pair
            srv = socket.create_server(("127.0.0.1", 0))
            w.send_obj(srv.getsockname(), 1, tag=9)
            sock, _ = srv.accept()
        else:
            sock = socket.create_connection(tuple(w.recv_obj(0, tag=9)))
        inter = dpm.join(sock)
        got = np.zeros(2, np.int64)
        if w.rank == 0:
            inter.send(np.array([42, 7], np.int64), 0, tag=1)
        else:
            inter.recv(got, 0, tag=1)
        red = inter.allreduce(np.array([w.rank + 1, 5], np.int64))
        half = w.split(w.rank)           # two 1-rank comms bridged over w
        inter2 = half.create_intercomm(0, w, 1 - w.rank, tag=3)
        got2 = np.zeros(3, np.int64)
        if w.rank == 0:
            inter2.send(np.arange(3, dtype=np.int64) + 10, 0, tag=2)
        else:
            inter2.recv(got2, 0, tag=2)
        red2 = inter2.allreduce(np.array([10 * (w.rank + 1)], np.int64))
        full = inter2.merge(high=w.rank == 1)
        tot = full.allreduce(np.array([full.rank + 1], np.int64))
        out("JOIN", w.rank, inter.is_inter, inter.size, inter.remote_size,
            list(inter.remote_group.world_ranks), ints(got), ints(red),
            inter.cid == inter2.cid, inter2.is_inter, inter2.remote_size,
            list(inter2.remote_group.world_ranks), ints(got2), ints(red2),
            full.size, full.rank, ints(tot), m.COMM_WORLD.compare(inter2))
        sock.close()
        m.finalize()
    ''',
    "deadchild": '''
        w = m.init(**KW)
        registry.set("otpu_dpm_spawn_timeout", 30.0)
        try:
            w.spawn([sys.executable, "-c", "import sys; sys.exit(3)"], 1)
            err = None
        except MpiError as exc:
            err = exc.error_class.name
        out("DEADCHILD", w.rank, err, ints(w.allreduce(np.ones(1))))
        m.finalize()
    ''',
}


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    d = tmp_path_factory.mktemp("dpmmp")
    out = {}
    for name, body in SCRIPTS.items():
        path = d / f"{name}.py"
        path.write_text(PRELUDE + textwrap.dedent(body))
        out[name] = path
    return out


def _run(pkg, n, args, timeout=120):
    """One job of ``pkg``'s own tpurun to its end; on a timeout the
    launcher's process group is killed first."""
    env = dict(os.environ)
    env.pop("OTPU_RANK", None)
    env.pop("OTPU_NPROCS", None)
    launcher = "ompi_tpu_torch.tools.tpurun" if pkg == "torch" \
        else "ompi_tpu.tools.tpurun"
    p = subprocess.Popen(
        [sys.executable, "-m", launcher, "-n", str(n), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=env, start_new_session=True)
    try:
        o, e = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
    return subprocess.CompletedProcess(p.args, p.returncode, o, e)


def _jobs(scripts, name, n, args=()):
    """Both packages' jobs in turn: {tag: sorted rows}, equal between the
    packages."""
    got = {}
    for pkg in ("torch", "jax"):
        res = _run(pkg, n, [*args, sys.executable, str(scripts[name]), pkg])
        assert res.returncode == 0, (pkg, res.stdout + res.stderr)
        rows: dict = {}
        for line in res.stdout.splitlines():
            _, _, rest = line.partition("] ")
            tag, _, vals = rest.partition(" ")
            if tag.isupper() and vals.startswith("["):
                rows.setdefault(tag, []).append(json.loads(vals))
        got[pkg] = {t: sorted(v, key=json.dumps) for t, v in rows.items()}
    assert got["torch"] == got["jax"], got
    return got["torch"]


@pytest.fixture(scope="module")
def spawn_job(scripts):
    return _jobs(scripts, "spawn", 2)


def test_spawn_pingpong_intercomm_allreduce_and_merge(spawn_job):
    parents = {row[0]: row[1:] for row in spawn_job["PARENT"]}
    assert sorted(parents) == [0, 1]
    for r, (is_inter, size, rsize, remote, job, got, red, fsize, frank,
            tot, members) in parents.items():
        assert is_inter and size == rsize == 2 and remote == [2, 3]
        assert job == "job1" and red == [100 + 200, 2]
        assert (fsize, frank, tot, members) == (4, r, [10], [0, 1, 2, 3])
    assert parents[0][5] == [42, 44, 46, 48] and parents[1][5] == [0] * 4
    kids = [row for row in spawn_job["CHILD"] if row[0] == "-"]
    assert len(kids) == 2
    for _, rank, size, world, is_inter, rsize, red, fsize, frank, tot in kids:
        assert (size, world, is_inter, rsize) == (2, [2, 3], True, 2)
        assert red == [1 + 2, 20] and (fsize, frank, tot) == (4, 2 + rank, [10])


def test_spawn_multiple_and_job_psets(spawn_job):
    for r, rsize, job, remote, red, fsize, tot, jobs in spawn_job["MULTI"]:
        assert (rsize, job, remote, red, fsize, tot) == (
            2, "job2", [4, 5], [300, 2], 4, [10])
        assert jobs == [["mpi://job/job1", "2,3", "spawn"],
                        ["mpi://job/job2", "4,5", "spawn"]]
    tags = sorted(row[0] for row in spawn_job["CHILD"] if row[0] != "-")
    assert tags == ["a", "b"]


def test_publish_lookup_accept_connect_and_merge(scripts):
    rows = {row[0]: row[1:] for row in _jobs(scripts, "connect", 4)
            ["CONNECT"]}
    assert sorted(rows) == [0, 1, 2, 3]
    for r, (is_port, is_inter, rsize, remote, got, red, fsize, frank, tot,
            err) in rows.items():
        assert is_port and is_inter and rsize == 2 and fsize == 4
        assert remote == ([2, 3] if r < 2 else [0, 1])
        assert red == ([3 + 4] if r < 2 else [1 + 2]) and tot == [60]
        assert frank == r and err == ("ERR_NAME" if r == 0 else None)
    assert rows[0][4] == [77, 2] and rows[1][4] == [0, 0]


def test_recovery_shrink_spawn_merge(scripts):
    got = _jobs(scripts, "recover", 3, ["--enable-recovery"])
    rows = {row[0]: row[1:] for row in got["RECOVERED"]}
    assert sorted(rows) == [0, 2]
    for r, (ssize, remote, fsize, frank, members, tot, surv,
            shrunk) in rows.items():
        assert (ssize, remote, fsize, members, tot) == (2, [3], 3, [0, 2, 3],
                                                        [6])
        assert frank == (0 if r == 0 else 1) and surv and shrunk
    assert got["REPLACED"] == [[0, [3], 3, 2, [6]]]


def test_join_and_intercomm_create(scripts):
    rows = {row[0]: row[1:] for row in _jobs(scripts, "join", 2)["JOIN"]}
    assert sorted(rows) == [0, 1]
    for r, (is_inter, size, rsize, remote, got, red, same_cid, is_inter2,
            rsize2, remote2, got2, red2, fsize, frank, tot,
            cmp) in rows.items():
        assert is_inter and is_inter2 and size == rsize == rsize2 == 1
        assert remote == remote2 == [1 - r] and not same_cid
        assert red == [(1 - r) + 1, 5] and red2 == [10 * (2 - r)]
        assert (fsize, frank, tot) == (2, r, [3])
    assert rows[1][4] == [42, 7] and rows[0][4] == [0, 0]
    assert rows[1][10] == [10, 11, 12] and rows[0][10] == [0, 0, 0]


def test_a_child_dying_in_its_join_fails_the_spawn(scripts):
    got = _jobs(scripts, "deadchild", 1, ["--enable-recovery"])
    assert got["DEADCHILD"] == [[0, "ERR_SPAWN", [1]]]


# -- the spawn's failure paths in one process --------------------------------

class _FakeSpawnClient:
    """Coordination-client stand-in: a configurable rank allocation and a
    join key that never appears."""

    def __init__(self, ranks, job="job9"):
        self._ranks, self._job = list(ranks), job

    def fetch_add(self, rank, key, delta):
        return 0                      # the first bridge CID

    def spawn(self, cmd, n, env=None):
        return list(self._ranks), self._job

    def get(self, rank, key, wait=True, timeout=60.0):
        return None


@pytest.mark.parametrize("ranks,timeout,words", [
    ([100], 60.0, "allocated 1 of 2"),
    ([100, 101], 0.2, "did not join"),
])
def test_a_failed_spawn_releases_its_cid(ranks, timeout, words):
    got = {}
    for pkg, m in (("jax", ompi_tpu), ("torch", ompi_tpu_torch)):
        dpm = __import__(f"{m.__name__}.dpm", fromlist=["x"])
        rt = __import__(f"{m.__name__}.runtime.init", fromlist=["x"])
        reg = __import__(f"{m.__name__}.base.var", fromlist=["x"]).registry
        errors = __import__(f"{m.__name__}.api.errors", fromlist=["x"])
        rt.reset_for_testing()
        w = m.init(device="cpu") if pkg == "torch" else m.init()
        var = reg.lookup("otpu_dpm_spawn_timeout")
        old = var.value
        var.set(timeout)
        w.rte.client = _FakeSpawnClient(ranks)
        try:
            with pytest.raises(errors.MpiError) as ei:
                w.spawn([sys.executable, "-c", "pass"], 2)
            got[pkg] = [ei.value.error_class.name, words in str(ei.value),
                        rt.is_cid_free(dpm._DPM_CID_BASE),
                        dpm._DPM_CID_BASE]
        finally:
            var.set(old)
            w.rte.client = None
            rt.reset_for_testing()
    assert got["torch"] == got["jax"] == ["ERR_SPAWN", True, True, 1 << 20]


def test_dpm_needs_the_coordination_service():
    got = {}
    for pkg, m in (("jax", ompi_tpu), ("torch", ompi_tpu_torch)):
        dpm = __import__(f"{m.__name__}.dpm", fromlist=["x"])
        rt = __import__(f"{m.__name__}.runtime.init", fromlist=["x"])
        errors = __import__(f"{m.__name__}.api.errors", fromlist=["x"])
        rt.reset_for_testing()
        w = m.init(device="cpu") if pkg == "torch" else m.init()
        try:
            row = []
            for call in (lambda: dpm.open_port(w),
                         lambda: w.spawn(["true"], 1),
                         lambda: dpm.lookup_name("x", w),
                         lambda: w.accept("p")):
                try:
                    call()
                    row.append(None)
                except errors.MpiError as exc:
                    row.append(exc.error_class.name)
            row.append(dpm.get_parent() is None)
            row.append(_merge_error(w, errors))
            got[pkg] = row
        finally:
            rt.reset_for_testing()
    assert got["torch"] == got["jax"]
    assert got["torch"][:4] == ["ERR_UNSUPPORTED_OPERATION"] * 4


def _merge_error(w, errors):
    try:
        w.merge()
    except errors.MpiError as exc:
        return exc.error_class.name
    return None
