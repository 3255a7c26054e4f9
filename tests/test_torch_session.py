"""MPI-4 Sessions in the port (``ompi_tpu_torch/instance``,
``api/session.py``, ``Comm.create_from_group``,
``Comm.create_intercomm_from_groups``, the coordination service's psets,
``tpurun --pset`` and ``--fake-nodes``' per-node sets), held against the
JAX package, after ``tests/test_session.py``.

In one process (the device world: 8 virtual CPU devices in the reference,
8 virtual ranks on the CPU lane in the port), each case runs in both
packages on the same inputs and their results are compared: a session
boots without ``init``; world init joins the session's boot; ``init``
after ``finalize``; seeded interleavings of session and world owners
(refcounts and a full teardown in every order); the error classes
(``ERR_SESSION`` after a session's finalize or without an instance,
``ERR_ARG`` for an unknown pset, ``ERR_GROUP`` for overlapping groups);
session-built comms and intercomms.  The data is integer-valued, so every
sum is exact and compared bit for bit.

Between processes, one ``tpurun -n 4 --pset app:0-1 --pset io:2-3
--fake-nodes 2`` job a package, no ``init`` anywhere: the pset list (names,
members, sources), comms from ``mpi://WORLD``, ``app`` and ``io``,
coll/inter's collectives on the ``app``/``io`` intercomm (``ROOT`` and
``PROC_NULL`` roots), ``compare`` on intercomms, point-to-point across it,
and world init joining the session; then a ``--enable-recovery`` job whose
rank 1 dies: ``mpi://surviving`` and shrink's ``mpi://shrunk/<cid>``.
The lines each job prints must be equal between the packages.  Every
subprocess has its own ``timeout=``.
"""
import json
import os
import random
import signal
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import ompi_tpu
import ompi_tpu_torch

REPO = Path(__file__).resolve().parent.parent


def _ns(pkg):
    if pkg == "torch":
        from ompi_tpu_torch import instance
        from ompi_tpu_torch.api.errhandler import ERRORS_RETURN
        from ompi_tpu_torch.api.errors import ErrorClass, MpiError
        from ompi_tpu_torch.api.info import Info
        from ompi_tpu_torch.runtime import init as rt

        return SimpleNamespace(m=ompi_tpu_torch, inst=instance, rt=rt,
                               RET=ERRORS_RETURN, EC=ErrorClass,
                               MpiError=MpiError, Info=Info,
                               kw={"device": "cpu"})
    from ompi_tpu import instance
    from ompi_tpu.api.errhandler import ERRORS_RETURN
    from ompi_tpu.api.errors import ErrorClass, MpiError
    from ompi_tpu.api.info import Info
    from ompi_tpu.runtime import init as rt

    return SimpleNamespace(m=ompi_tpu, inst=instance, rt=rt,
                           RET=ERRORS_RETURN, EC=ErrorClass,
                           MpiError=MpiError, Info=Info, kw={})


def _session(ns, **kw):
    return ns.m.Session.init(errhandler=ns.RET, **kw, **ns.kw)


def _init(ns):
    return ns.m.init(**ns.kw)


def _both(fn):
    """``fn(ns)`` in each package on a fresh runtime; the results must be
    equal, and are returned."""
    got = {}
    for pkg in ("jax", "torch"):
        ns = _ns(pkg)
        ns.rt.reset_for_testing()
        try:
            got[pkg] = fn(ns)
        finally:
            ns.rt.reset_for_testing()
    assert got["torch"] == got["jax"], got
    return got["torch"]


def _err(ns, fn):
    """The MPI error class name a call raises (None when it returns)."""
    try:
        fn()
    except ns.MpiError as exc:
        return exc.error_class.name
    return None


def _sum0(y):
    from ompi_tpu_torch.base import cudaenv

    import torch

    arr = cudaenv.to_numpy(y) if isinstance(y, torch.Tensor) \
        else np.asarray(y)
    return arr.ravel().tolist()


@pytest.fixture(autouse=True, scope="module")
def _eight_devices():
    from ompi_tpu.runtime import init as jrt

    jrt.reset_for_testing()
    if ompi_tpu.init().size != 8:
        pytest.skip("needs 8 virtual devices")
    jrt.reset_for_testing()


# -- sessions without init ------------------------------------------------

def test_session_boots_without_world_init():
    def run(ns):
        s = _session(ns)
        names = s.psets()
        info = s.get_pset_info("mpi://WORLD")
        g = ns.m.Group.from_session_pset(s, "mpi://SELF")
        out = [ns.m.initialized(), ns.inst.refcount(), names,
               s.get_num_psets(), s.get_nth_pset(0),
               info.get("mpi_size"), info.get("otpu_members"),
               info.get("otpu_source"),
               len(s.group_from_pset("mpi://WORLD")), g.world_ranks,
               s.get_pset_info("mpi://SELF").get("otpu_source")]
        s.finalize()
        return out + [ns.inst.refcount(), ns.inst.current() is None]

    got = _both(run)
    assert got[:3] == [False, 1, ["mpi://WORLD", "mpi://SELF"]]


def test_session_comms_and_their_collectives():
    """Comms from psets (the whole world, two disjoint halves, four rows),
    CIDs above the reserved 0 and 1, integer sums bit for bit; a session's
    finalize leaves its comms working while another session lives."""
    x = np.random.default_rng(0).integers(-50, 50, (8, 6)).astype(np.float32)

    def run(ns):
        s1, s2 = _session(ns), _session(ns)
        world = s1.group_from_pset("mpi://WORLD")
        c = ns.m.Comm.create_from_group(world, "t0")
        lo = ns.m.Comm.create_from_group(world.incl(range(4)), "lo")
        hi = ns.m.Comm.create_from_group(world.incl(range(4, 8)), "hi")
        four = ns.m.Comm.create_from_group(world.incl([0, 2, 4, 6]), "four")
        out = [[cm.size, cm.rank, cm.cid >= 2] for cm in (c, lo, hi, four)]
        out.append(len({c.cid, lo.cid, hi.cid, four.cid}))
        out.append(_sum0(c.allreduce_array(x)))
        out.append(_sum0(lo.allreduce_array(x[:4])))
        out.append(_sum0(four.allreduce_array(x[::2])))
        s1.finalize()
        out.append(_sum0(lo.allreduce_array(x[4:])))
        out.append(ns.inst.refcount())
        for cm in (c, lo, hi, four):
            cm.free()
        s2.finalize()
        return out

    got = _both(run)
    assert got[4] == 4 and got[5] == x.sum(0).tolist()


def test_intercomm_from_groups_in_one_process():
    def run(ns):
        s = _session(ns)
        world = s.group_from_pset("mpi://WORLD")
        lo, hi = world.incl(range(4)), world.incl(range(4, 8))
        inter = ns.m.Comm.create_intercomm_from_groups(lo, 0, hi, 0, "br")
        twin = ns.m.Comm.create_intercomm_from_groups(lo, 0, hi, 0, "br2")
        other = ns.m.Comm.create_intercomm_from_groups(
            lo, 0, hi.incl([3, 2, 1, 0]), 0, "br3")
        c = ns.m.Comm.create_from_group(lo, "intra")
        out = [inter.is_inter, inter.size, inter.remote_size,
               inter.local_comm.size, inter.compare(inter),
               inter.compare(twin), inter.compare(other), inter.compare(c),
               c.compare(inter), c.is_inter, c.remote_size,
               _err(ns, lambda: ns.m.Comm.create_intercomm_from_groups(
                   lo, 0, world, 0, "overlap"))]
        for cm in (inter, twin, other, c):
            cm.free()
        s.finalize()
        return out

    got = _both(run)
    assert got[4:9] == [0, 1, 2, 3, 3] and got[-1] == "ERR_GROUP"


# -- the world and the sessions: one refcounted boot ------------------------

def test_world_and_session_share_one_boot():
    def run(ns):
        s = _session(ns)
        before = ns.inst.current()
        w = _init(ns)
        out = [ns.inst.current() is before, ns.inst.refcount(),
               w.rte is before.rte, w.size]
        ns.m.finalize()
        out += [ns.m.finalized(), ns.inst.refcount()]
        g = s.group_from_pset("mpi://WORLD")
        c = ns.m.Comm.create_from_group(g, "post-finalize")
        out.append(_sum0(c.allreduce_array(np.ones((c.size, 1),
                                                   np.float32))))
        c.free()
        s.finalize()
        return out + [ns.inst.refcount(), ns.inst.current() is None]

    assert _both(run)[:3] == [True, 2, True]


def test_init_finalize_init_under_refcounting():
    def run(ns):
        out = []
        for _ in range(2):
            w = _init(ns)
            out.append([ns.m.initialized(), ns.m.finalized(),
                        np.asarray(w.allreduce(np.ones((w.size, 1))))
                        .ravel().tolist(), ns.inst.refcount()])
            ns.m.finalize()
            out.append([ns.m.finalized(), ns.inst.refcount()])
        return out

    _both(run)


@pytest.mark.parametrize("seed", [7, 11])
def test_finalize_order_fuzz(seed):
    """Seeded interleavings of session opens and finalizes with world init
    and finalize: the refcount after every step, a full teardown at the
    end of each round, and the next round boots."""
    def run(ns):
        rng = random.Random(seed)
        trace = []
        for _ in range(4):
            owners = []
            world_open = False
            for _ in range(rng.randint(1, 4)):
                if not world_open and rng.random() < 0.4:
                    _init(ns)
                    owners.append(("world", ns.m.finalize))
                    world_open = True
                else:
                    owners.append(("session", _session(ns).finalize))
                trace.append(ns.inst.refcount())
            rng.shuffle(owners)
            for kind, close in owners:
                close()
                trace.append((kind, ns.inst.refcount()))
            trace.append(ns.inst.current() is None)
        return trace

    got = _both(run)
    assert all(t is True for t in got if isinstance(t, bool))


# -- error paths ------------------------------------------------------------

def test_session_error_paths():
    def run(ns):
        s = _session(ns)
        out = [_err(ns, lambda: s.get_pset_info("mpi://no-such-set")),
               _err(ns, lambda: s.group_from_pset("mpi://no-such-set")),
               _err(ns, lambda: s.get_nth_pset(10 ** 6))]
        s.finalize()
        for call in (s.finalize, s.get_num_psets, s.psets,
                     lambda: s.group_from_pset("mpi://WORLD"),
                     lambda: s.get_pset_info("mpi://WORLD"), s.get_info):
            out.append(_err(ns, call))
        out.append(s.finalized)
        return out

    got = _both(run)
    assert got[:3] == ["ERR_ARG"] * 3 and got[3:9] == ["ERR_SESSION"] * 6


def test_construction_needs_an_instance():
    def run(ns):
        g = ns.m.Group([0])
        return [_err(ns, lambda: ns.m.Comm.create_from_group(g, "orphan")),
                _err(ns, lambda: ns.m.Comm.create_intercomm_from_groups(
                    g, 0, ns.m.Group([1]), 0, "orphan"))]

    assert _both(run) == ["ERR_SESSION", "ERR_SESSION"]


def test_session_info_and_errhandler():
    def run(ns):
        s = ns.m.Session.init(info=ns.Info({"app": "test"}),
                              errhandler=ns.RET, **ns.kw)
        got = s.get_info()
        out = [got.get("app"), got.get("thread_level"),
               s.get_errhandler() is ns.RET,
               _err(ns, lambda: s.call_errhandler(int(ns.EC.ERR_OTHER))),
               repr(s).endswith("active)")]
        s.finalize()
        return out + [repr(s).endswith("finalized)")]

    assert _both(run)[:2] == ["test", "MPI_THREAD_MULTIPLE"]


def test_error_classes_are_the_references():
    from ompi_tpu.api.errors import ErrorClass as J
    from ompi_tpu_torch.api.errors import ErrorClass as T

    for name in ("ERR_SESSION", "ERR_SPAWN", "ERR_PORT", "ERR_NAME",
                 "ERR_GROUP", "ERR_ARG"):
        assert int(getattr(T, name)) == int(getattr(J, name)), name
    from ompi_tpu.api.status import ROOT as JROOT
    from ompi_tpu_torch.api.status import ROOT as TROOT

    assert TROOT == JROOT


@pytest.mark.parametrize("spec", [
    "workers:0,2-3", "a:3", "w:0-3", "bad", ":1", "x:", "x:1-0", "x:a",
    "x:0,0", "x:4", "x:1-", "x:-1"])
def test_parse_pset_matches_the_reference(spec):
    """``tpurun --pset NAME:RANKS``: the parsed set, or the same message
    on the same malformed spec, for a 4-rank job."""
    from ompi_tpu.tools import tpurun as jrun
    from ompi_tpu_torch.tools import tpurun as trun

    def parse(mod):
        try:
            return mod._parse_pset(spec, 4)
        except SystemExit as exc:
            return str(exc)

    assert parse(trun) == parse(jrun)


# -- between processes ------------------------------------------------------

PRELUDE = '''
import json, os, sys, time
import numpy as np

PKG = sys.argv[1]
if PKG == "torch":
    import ompi_tpu_torch as m
    from ompi_tpu_torch.api.errhandler import ERRORS_RETURN
    from ompi_tpu_torch.api.status import PROC_NULL, ROOT
    from ompi_tpu_torch.ft import state as ft_state
    KW = {"device": "cpu"}
else:
    import ompi_tpu as m
    from ompi_tpu.api.errhandler import ERRORS_RETURN
    from ompi_tpu.api.status import PROC_NULL, ROOT
    from ompi_tpu.ft import state as ft_state
    KW = {}


def out(tag, *vals):
    print(tag, json.dumps(vals), flush=True)


def ints(a):
    return np.asarray(a).astype(np.int64).ravel().tolist()


def tensor(a):
    """The port's ranks hand a (CPU) tensor where the reference's hand
    numpy: coll/inter stages it and returns numpy, as the reference's
    np.ascontiguousarray does with an array."""
    if PKG == "torch":
        import torch
        return torch.from_numpy(a)
    return a
'''

SCRIPTS = {
    "psets": '''
        s = m.Session.init(errhandler=ERRORS_RETURN, **KW)
        inited = m.initialized()
        rows = []
        for name in s.psets():
            info = s.get_pset_info(name)
            rows.append([name, info.get("mpi_size"),
                         info.get("otpu_members"), info.get("otpu_source")])
        out("PSETS", inited, s.get_num_psets(), rows)
        world = m.Group.from_session_pset(s, "mpi://WORLD")
        app, io = s.group_from_pset("app"), s.group_from_pset("io")
        wc = m.Comm.create_from_group(world, "all")
        r = wc.rank
        ca = m.Comm.create_from_group(app, "app")
        ci = m.Comm.create_from_group(io, "io")
        mine = ca if ca is not None else ci
        x = np.arange(4096, dtype=np.int64) * (r + 1)
        out("COMMS", r, wc.size, wc.cid >= 2, ca is None, ci is None,
            mine.size, mine.rank, ints(mine.allreduce(x))[:3],
            int(np.asarray(mine.allreduce(x)).sum()),
            ints(wc.allreduce(np.array([r + 1]))))
        mg, og = (app, io) if ca is not None else (io, app)
        inter = m.Comm.create_intercomm_from_groups(mg, 0, og, 0, "ai")
        twin = m.Comm.create_intercomm_from_groups(mg, 0, og, 0, "ai2")
        rev = og.incl(list(range(og.size))[::-1]) if ca is not None else og
        other = m.Comm.create_intercomm_from_groups(mg, 0, rev, 0, "ai3")
        lr = inter.rank
        red = inter.allreduce(tensor(np.array([10 * (r + 1), r], np.int64)))
        gat = inter.allgather(np.array([r, r * r], np.int64))
        # bcast rooted at app's rank 0; reduce rooted at io's rank 0
        if ca is not None:
            broot = ROOT if lr == 0 else PROC_NULL
            rroot = 0
        else:
            broot = 0
            rroot = ROOT if lr == 0 else PROC_NULL
        bc = inter.bcast(np.full(5, 100 + r, np.int64), broot)
        rd = inter.reduce(np.array([r + 1, 2 * r], np.int64), root=rroot)
        inter.barrier()
        if lr == 0:
            inter.send(np.array([r * 7], np.int64), dest=0, tag=4)
        buf = np.zeros(1, np.int64)
        if lr == 0:
            inter.recv(buf, source=0, tag=4)
        out("INTER", r, inter.is_inter, inter.size, inter.remote_size,
            inter.local_comm.size, type(red).__name__, ints(red),
            ints(gat), ints(bc),
            None if rd is None else ints(rd), ints(buf),
            inter.compare(inter), inter.compare(twin),
            inter.compare(other), inter.compare(wc))
        for c in (inter, twin, other, mine, wc):
            c.free()
        w = m.init(**KW)
        from importlib import import_module
        inst = import_module(m.__name__ + ".instance")
        out("WORLD", r, w.rank, w.size, inst.refcount(),
            w.rte is inst.current().rte)
        m.finalize()
        s.finalize()
        out("DONE", r, inst.refcount(), inst.current() is None)
    ''',
    "surviving": '''
        w = m.init(**KW)
        w.barrier()
        if w.rank == 1:
            os._exit(17)          # die without finalize
        deadline = time.time() + 60
        while not ft_state.is_failed(1):
            time.sleep(0.05)
            assert time.time() < deadline, "failure never detected"
        sub = w.shrink()
        s = m.Session.init(**KW)
        names = s.psets()
        surv = s.group_from_pset("mpi://surviving")
        shrunk = [n for n in names if n.startswith("mpi://shrunk/")]
        g2 = s.group_from_pset(shrunk[0])
        out("SURVIVING", w.rank, sorted(names)[:4], list(surv.world_ranks),
            len(shrunk), shrunk[0] == f"mpi://shrunk/{sub.cid}",
            list(g2.world_ranks) == list(sub.group.world_ranks),
            s.get_pset_info("mpi://surviving").get("otpu_source"),
            s.get_pset_info(shrunk[0]).get("otpu_source"))
        s.finalize()
        m.finalize()
    ''',
}


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    d = tmp_path_factory.mktemp("sessmp")
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


def _lines(res):
    """{tag: sorted rows} of a job's tagged lines (rank prefix dropped)."""
    rows: dict = {}
    for line in res.stdout.splitlines():
        _, _, rest = line.partition("] ")
        tag, _, vals = rest.partition(" ")
        if tag.isupper() and vals.startswith("["):
            rows.setdefault(tag, []).append(json.loads(vals))
    return {t: sorted(v, key=json.dumps) for t, v in rows.items()}


def _jobs(scripts, name, n, args=()):
    """Both packages' jobs in turn; their tagged lines must be equal."""
    got = {}
    for pkg in ("torch", "jax"):
        res = _run(pkg, n, [*args, sys.executable, str(scripts[name]), pkg])
        assert res.returncode == 0, (pkg, res.stdout + res.stderr)
        got[pkg] = _lines(res)
    assert got["torch"] == got["jax"], got
    return got["torch"]


@pytest.fixture(scope="module")
def pset_job(scripts):
    return _jobs(scripts, "psets", 4, ["--pset", "app:0-1",
                                       "--pset", "io:2-3",
                                       "--fake-nodes", "2"])


def test_pset_list_matches_the_reference(pset_job):
    rows = pset_job["PSETS"]
    assert len(rows) == 4
    inited, count, table = rows[0]
    assert inited is False and count == len(table)
    by_name = {row[0]: row[1:] for row in table}
    assert by_name["app"] == ["2", "0,1", "user"]
    assert by_name["io"] == ["2", "2,3", "user"]
    assert by_name["mpi://host/node0"] == ["2", "0,1", "host"]
    assert by_name["mpi://host/node1"] == ["2", "2,3", "host"]
    assert by_name["mpi://WORLD"] == ["4", "0,1,2,3", "builtin"]


def test_session_comms_between_processes(pset_job):
    rows = pset_job["COMMS"]
    assert len(rows) == 4
    x = np.arange(4096, dtype=np.int64)
    for r, size, high, no_app, no_io, msize, mrank, head, total, wsum in rows:
        assert size == 4 and high and msize == 2 and wsum == [10]
        assert (no_app, no_io) == ((True, False) if r >= 2 else (False, True))
        ranks = (2, 3) if r >= 2 else (0, 1)
        assert total == int((x * sum(q + 1 for q in ranks)).sum())


def test_inter_collectives_between_processes(pset_job):
    rows = {row[0]: row[1:] for row in pset_job["INTER"]}
    assert len(rows) == 4
    for r, (is_inter, size, rsize, lsize, kind, red, gat, bc, rd, buf,
            ident, congruent, other, intra) in rows.items():
        assert is_inter and size == rsize == lsize == 2 and kind == "ndarray"
        peers = (2, 3) if r < 2 else (0, 1)
        assert red == [sum(10 * (q + 1) for q in peers), sum(peers)]
        assert gat == [v for q in peers for v in (q, q * q)]
        assert bc == ([101] * 5 if r == 1 else [100] * 5)
        assert (ident, congruent, intra) == (0, 1, 3)
        assert other == (2 if r < 2 else 1)
    assert rows[2][8] == [1 + 2, 0 + 2] and rows[3][8] is None
    assert rows[0][8] is None and rows[0][9] == [14] and rows[2][9] == [0]


def test_world_init_joins_the_session(pset_job):
    for _, rank, size, refs, same in pset_job["WORLD"]:
        assert size == 4 and refs == 2 and same
    assert [row[1:] for row in pset_job["DONE"]] == [[0, True]] * 4


def test_shrink_and_failure_publish_psets(scripts):
    rows = _jobs(scripts, "surviving", 3,
                 ["--enable-recovery"])["SURVIVING"]
    assert len(rows) == 2
    for r, names, surv, n_shrunk, named, same, src_s, src_k in rows:
        assert surv == [0, 2] and n_shrunk == 1 and named and same
        assert src_s == src_k == "dynamic"
