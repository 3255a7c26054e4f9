"""The MPI environment surface of the port, held against the JAX package's:
``tests/test_core_objects.py:190-263`` (generalized requests,
``init_thread``, the interlib guard of ``finalize``, ``wtime`` and its
friends, user error classes, ``compare`` and ``idup``), error handlers,
the package's top-level names, and two jobs under each package's
``tpurun -n 2``: ``abort`` ends the job with its code, and ranks that
return without ``finalize`` (the first rank with sends still queued) end
the job 0 with every message delivered, through the exit hook the first
``init`` arms.
"""
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import ompi_tpu
import ompi_tpu_torch

REPO = Path(__file__).resolve().parent.parent
PKGS = {"jax": ompi_tpu, "torch": ompi_tpu_torch}


def _mod(pkg, name):
    return __import__(f"{pkg.__name__}.{name}", fromlist=["x"])


def _init(pkg):
    return pkg.init(device="cpu") if pkg is ompi_tpu_torch else pkg.init()


@pytest.fixture
def fresh():
    """Both packages' runtimes torn down before and after the test."""
    for pkg in PKGS.values():
        _mod(pkg, "runtime.init").reset_for_testing()
    yield
    for pkg in PKGS.values():
        _mod(pkg, "runtime.init").reset_for_testing()


def _both(case):
    got = {name: case(pkg) for name, pkg in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def test_generalized_request():
    def case(pkg):
        req = _mod(pkg, "api.request")
        dt = _mod(pkg, "datatype")
        calls = []
        r = req.GeneralizedRequest(
            query_fn=lambda st: st.set_elements(dt.FLOAT32, 3),
            free_fn=lambda: calls.append("free"),
            cancel_fn=lambda done: calls.append(("cancel", done)))
        before = r.complete_flag
        r.grequest_complete()
        st = r.wait()
        r.cancel()
        r.free()
        return before, st.get_count(dt.FLOAT32), r.complete_flag, calls

    assert _both(case) == (False, 3, False, ["free"])   # freed: inactive


def test_init_thread_provided(fresh):
    def case(pkg):
        if pkg is ompi_tpu_torch:
            w, provided = pkg.init_thread(pkg.THREAD_MULTIPLE, device="cpu")
        else:
            w, provided = pkg.init_thread(pkg.THREAD_MULTIPLE)
        got = (provided, pkg.THREAD_MULTIPLE, w.size >= 1,
               pkg.query_thread(), pkg.is_thread_main(),
               [pkg.THREAD_SINGLE, pkg.THREAD_FUNNELED,
                pkg.THREAD_SERIALIZED])
        _mod(pkg, "runtime.init").reset_for_testing()
        return got

    assert _both(case) == (3, 3, True, 3, True, [0, 1, 2])


def test_interlib_blocks_finalize(fresh):
    def case(pkg):
        interlib = _mod(pkg, "runtime.interlib")
        _init(pkg)
        interlib.register(interlib.THREAD_SERIALIZED)
        pkg.finalize()
        held = pkg.initialized()          # the library still registered
        left = interlib.deregister()
        pkg.finalize()
        return held, left, pkg.finalized()

    assert _both(case) == (True, 0, True)


def test_wtime_and_friends():
    def case(pkg):
        env = _mod(pkg, "api.env")
        t0 = env.wtime()
        buf = env.alloc_mem(128)
        env.free_mem(buf)
        return (env.wtime() >= t0, 0 < env.wtick() < 1,
                env.get_processor_name(), env.get_version(),
                "ompi_tpu" in env.get_library_version(),
                (str(buf.dtype), buf.nbytes, int(buf.sum())),
                pkg.wtime is env.wtime, pkg.get_version())

    got = _both(case)
    assert got[0:2] == (True, True) and got[3] == (4, 0)
    assert ompi_tpu_torch.get_library_version().startswith("ompi_tpu_torch")


def test_user_error_classes():
    def case(pkg):
        errors = _mod(pkg, "api.errors")
        cls = errors.add_error_class()
        code = errors.add_error_code(cls, "my failure mode")
        errors.add_error_string(cls, "my class")
        with pytest.raises(errors.MpiError) as ei:
            errors.add_error_string(10 ** 9, "nobody")
        return (errors.error_string(cls), errors.error_string(code),
                errors.error_class_of(code) == cls, code - cls,
                errors.error_class_of(errors.ErrorClass.ERR_TRUNCATE),
                errors.error_string(errors.ErrorClass.ERR_TRUNCATE),
                ei.value.error_class.name)

    assert _both(case) == ("my class", "my failure mode", True, 1, 15,
                           "ERR_TRUNCATE", "ERR_ARG")


def test_comm_compare_and_idup(fresh):
    def case(pkg):
        w = _init(pkg)
        got = [w.compare(w) == w.IDENT]
        d = w.dup()
        got.append(w.compare(d) == w.CONGRUENT)
        sub = w.create_group(pkg.Group(list(w.group.world_ranks[:1])))
        got.append(sub is not None and w.compare(sub) == w.UNEQUAL)
        c2, req = w.idup()
        st = req.wait()
        got += [w.compare(c2) == w.CONGRUENT, req.result is c2,
                c2.cid > d.cid, st.source, st.tag]
        c2.free()
        d.free()
        return got

    assert _both(case)[:5] == [True, True, True, True, True]


def test_errhandlers(fresh):
    """``set_errhandler``/``get_errhandler``/``call_errhandler``: the fatal
    default, ERRORS_RETURN raising to the caller, a user handler receiving
    the class, and a dup inheriting its parent's handler."""
    def case(pkg):
        eh = _mod(pkg, "api.errhandler")
        errors = _mod(pkg, "api.errors")
        w = _init(pkg)
        got = [w.get_errhandler() is eh.ERRORS_ARE_FATAL]
        w.set_errhandler(eh.ERRORS_RETURN)
        with pytest.raises(errors.MpiError) as ei:
            w.call_errhandler(errors.ErrorClass.ERR_ARG)
        got.append(str(ei.value))
        with pytest.raises(errors.MpiError) as ei:
            w.call_errhandler(12345)       # no such class: ERR_OTHER
        got.append(ei.value.error_class.name)
        seen = []
        user = eh.create(lambda comm, cls: seen.append(int(cls)))
        w.set_errhandler(user)
        d = w.dup()
        with pytest.raises(errors.MpiError):   # raised after the handler
            d.call_errhandler(errors.ErrorClass.ERR_TAG)
        got += [d.get_errhandler() is user, seen, user.name.startswith(
            "user_")]
        d.free()
        w.set_errhandler(eh.ERRORS_ARE_FATAL)
        return got

    assert _both(case) == [True, "ERR_ARG: user-raised code 13", "ERR_OTHER",
                           True, [4], True]


def test_top_level_names():
    """The names of ``ompi_tpu/__init__.py:19-68`` that have a port resolve
    to the same kind of object in both packages (``Session``, ``File``,
    ``get_parent`` and ``open_port``:
    ``tests/test_torch_pml.py::test_copied_now``)."""
    names = ["init_thread", "query_thread", "is_thread_main", "wtime",
             "wtick", "get_processor_name", "get_version",
             "get_library_version", "alloc_mem", "free_mem", "Request",
             "Datatype", "Info", "Win", "Status", "THREAD_SINGLE",
             "THREAD_FUNNELED", "THREAD_SERIALIZED", "THREAD_MULTIPLE"]

    def case(pkg):
        return [(n, type(getattr(pkg, n)).__name__,
                 getattr(getattr(pkg, n), "__name__", getattr(pkg, n)))
                for n in names]

    _both(case)


# -- jobs ------------------------------------------------------------------

EXIT = r'''
import sys, time
import numpy as np
if sys.argv[1] == "torch":
    import ompi_tpu_torch as m
    w = m.init(device="cpu")
else:
    import ompi_tpu as m
    w = m.init()
if sys.argv[2] == "abort":
    w.barrier()
    if w.rank == 1:
        __import__(m.__name__ + ".runtime.init", fromlist=["x"]).abort(w, 7)
    time.sleep(60)
elif w.rank == 0:
    for i in range(20):     # 5 MB of eager sends: more than a 4 MB ring holds
        w.send(np.full(1 << 16, i, np.float32), dest=1, tag=1)
    print("sent", flush=True)
else:
    time.sleep(1.0)         # rank 0 returns with frames still queued
    buf = np.zeros(1 << 16, np.float32)
    ok = True
    for i in range(20):
        w.recv(buf, source=0, tag=1)
        ok = ok and bool(np.all(buf == i))
    print("received", ok, flush=True)
# no finalize: the exit hook drains, fences and releases
'''


def _tpurun(pkg, n, args, timeout):
    """Run a job; on a timeout the launcher's whole process group (its
    ranks too) is killed before the error propagates."""
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
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    return subprocess.CompletedProcess(p.args, p.returncode, out, err)


def _own_lines(stdout):
    """{rank: the job's own lines} (the launcher's and the runtime's
    messages left out)."""
    out = {}
    for line in stdout.splitlines():
        rank, _, rest = line.partition("] ")
        if line.startswith("[") and rest.startswith(("sent", "received")):
            out.setdefault(int(rank[1:]), []).append(rest)
    return out


#: a rank that never reaches the final fence costs its peers the fence's
#: timeout (``otpu_coord_final_timeout``, 10 s by default)
FAST_FENCE = ["--mca", "coord_final_timeout", "2"]


@pytest.fixture(scope="module")
def exit_job(tmp_path_factory):
    path = tmp_path_factory.mktemp("env") / "exit.py"
    path.write_text(EXIT)
    return path


def test_ranks_that_return_without_finalize(exit_job):
    """Rank 0 returns with frames still queued for rank 1 (which is asleep)
    and neither rank calls ``finalize``: in both packages the exit hook
    delivers every message and the job ends 0.  (The reference fences
    first, so its rank 0 waits out the final fence's timeout and says so;
    the port drains first and fences at once.)"""
    got = _tpurun("torch", 2, [*FAST_FENCE, sys.executable, str(exit_job),
                               "torch", "exit"], timeout=90)
    want = _tpurun("jax", 2, [*FAST_FENCE, sys.executable, str(exit_job),
                              "jax", "exit"], timeout=90)
    assert got.returncode == want.returncode == 0, got.stdout + want.stdout
    assert _own_lines(got.stdout) == _own_lines(want.stdout) == \
        {0: ["sent"], 1: ["received True"]}
    assert "expired" in want.stdout and "expired" not in got.stdout


def test_abort_ends_the_job_with_its_code(exit_job):
    """``abort`` on rank 1 (rank 0 asleep): both launchers end the job
    with the code."""
    got = _tpurun("torch", 2, [*FAST_FENCE, sys.executable, str(exit_job),
                               "torch", "abort"], timeout=90)
    want = _tpurun("jax", 2, [*FAST_FENCE, sys.executable, str(exit_job),
                              "jax", "abort"], timeout=90)
    assert got.returncode == want.returncode == 7
    assert "MPI_Abort on Comm(COMM_WORLD" in got.stdout
    assert "MPI_Abort on Comm(COMM_WORLD" in want.stdout
