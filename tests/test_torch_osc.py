"""mca/osc and ``Win`` in the port, held against the JAX package's.

The device world's windows run in this process on both packages' worlds
(the reference's 8-device CPU mesh, the port's CPU lane) with the same
inputs: ``tests/test_osc.py``'s local windows (osc/local) and
``tests/test_osc_device.py``'s window on the device (osc/device).  The
multi-process windows (``tests/test_osc.py:84-249`` and
``tests/test_osc_rdma.py``'s six) run as one ``tpurun -n 4`` job a
package for each osc selection, every scenario one after the other in it:
osc/rdma's mapped segments on one node (the default), osc/pt2pt's agent
with ``--mca osc ^rdma`` over btl/tcp, and osc/pt2pt across
``--fake-nodes 4`` (one rank a node).  Every rank's lines of a scenario are
equal between the packages.  The port's ranks bind ``--device cpu``; every
subprocess has its own ``timeout=``.

osc/pt2pt over btl/sm runs in the port only: the agent thread and the
application thread both drive the progress engine, and the reference's
btl/sm lets both pop one single-consumer ring, so its job loses a frame and
hangs (the port serializes the ring's producers and consumer).

One divergence is pinned: the reference's device window is a
``jax.device_put`` of the base, so without ``jax_enable_x64`` a float64
base gives a float32 window; the port's window keeps float64.
"""
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def worlds():
    from ompi_tpu.runtime import init as jrt
    from ompi_tpu_torch.runtime import init as trt

    jrt.reset_for_testing()
    trt.reset_for_testing()
    jw = ompi_tpu.init()
    if jw.size != 8:
        pytest.skip("needs 8 virtual devices")
    yield {"jax": (jw, ompi_tpu), "torch": (ompi_tpu_torch.init(device="cpu"),
                                            ompi_tpu_torch)}
    jrt.reset_for_testing()
    trt.reset_for_testing()


def _both(worlds, case):
    """Run ``case(world, pkg)`` on both packages; the results must match."""
    got = {name: case(w, pkg) for name, (w, pkg) in worlds.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _win(pkg):
    return __import__(f"{pkg.__name__}.api.win", fromlist=["x"]).Win


# -- osc/local: the device world's windows (tests/test_osc.py:26-70) -----

def test_local_create_put_get(worlds):
    def case(w, pkg):
        win = pkg.Win.create(w, size=8)
        win.put(np.arange(4, dtype=np.float64), target=1, offset=2)
        got = win.get(4, target=1, offset=2)
        first = win.get(1, target=1, offset=0)[0]
        name = type(win.module).__name__
        win.free()
        return name, got.tolist(), float(first)

    assert _both(worlds, case) == ("LocalModule", [0.0, 1.0, 2.0, 3.0], 0.0)


def test_local_accumulate_and_fetch(worlds):
    def case(w, pkg):
        win = pkg.Win.create(w, size=4)
        win.accumulate(np.ones(4), target=0)
        win.accumulate(np.ones(4) * 2, target=0)
        a = win.get(4, target=0).tolist()
        old = win.get_accumulate(np.ones(4), target=0).tolist()
        b = win.get(4, target=0).tolist()
        win.accumulate(np.full(4, 2.5), target=3, op=pkg.MAX)
        win.accumulate(np.array([1.0, -1.0, 7.0, 0.5]), target=3,
                       op=pkg.MIN)
        c = win.get(4, target=3).tolist()
        win.free()
        return a, old, b, c

    assert _both(worlds, case)[:3] == ([3.0] * 4, [3.0] * 4, [4.0] * 4)


def test_local_fetch_and_op_cas(worlds):
    def case(w, pkg):
        win = pkg.Win.create(w, size=2)
        got = [float(win.fetch_and_op(5.0, target=0)),
               float(win.fetch_and_op(3.0, target=0)),
               float(win.compare_and_swap(9.0, compare=8.0, target=0)),
               float(win.get(1, target=0)[0])]
        win.free()
        return got

    assert _both(worlds, case) == [0.0, 5.0, 8.0, 9.0]


def test_local_expose_existing_base(worlds):
    def case(w, pkg):
        base = np.arange(6, dtype=np.int64)
        win = pkg.Win.create(w, base=base)
        got = win.get(3, target=w.rank, offset=3).tolist()
        win.put(np.array([99]), target=w.rank, offset=0)
        win.free()
        return got, int(base[0])   # the window exposes, not copies, it

    assert _both(worlds, case) == ([3, 4, 5], 99)


def test_local_sync_noops_and_free(worlds):
    def case(w, pkg):
        win = pkg.Win.create(w, size=2)
        win.fence()
        win.lock(0)
        win.unlock(0)
        win.lock_all()
        win.unlock_all()
        win.flush_all()
        win.post(w.group)
        win.start(w.group)
        win.complete()
        win.wait()
        win.free()
        with pytest.raises(Exception) as ei:
            win.put(np.zeros(1), 0)
        return str(ei.value)

    assert _both(worlds, case) == "ERR_WIN: window was freed"


# -- osc/device (tests/test_osc_device.py) --------------------------------

def test_device_window_put_get_accumulate(worlds):
    def case(w, pkg):
        win = pkg.Win.create(w, size=8, dtype=np.float32, device=True)
        res = [type(win.module).__name__, tuple(win.device_array.shape),
               win.local is None]
        win.put(np.array([3.5, 4.5], np.float32), 1, offset=2)
        res.append(win.get(2, 1, offset=2).tolist())
        win.accumulate(np.array([1.0], np.float32), 1, offset=2)
        res.append(float(win.get(1, 1, offset=2)[0]))
        old = win.get_accumulate(np.array([10.0], np.float32), 0, offset=0)
        res.append([float(old[0]), float(win.get(1, 0, offset=0)[0])])
        old = win.compare_and_swap(7.0, 10.0, 0, offset=0)
        res.append([float(old), float(win.get(1, 0, offset=0)[0])])
        old = win.compare_and_swap(1.0, 99.0, 0, offset=0)   # no swap
        res.append([float(old), float(win.get(1, 0, offset=0)[0])])
        x = np.random.default_rng(3).standard_normal(6).astype(np.float32)
        for op in (pkg.SUM, pkg.MAX, pkg.MIN, pkg.PROD, pkg.REPLACE):
            win.accumulate(x, 5, offset=1, op=op)
            res.append(win.get(8, 5).tobytes().hex())
        with pytest.raises(Exception) as ei:
            win.accumulate(x, 5, op=pkg.BAND)
        res.append(str(ei.value).split(":")[0])
        if pkg is ompi_tpu_torch:
            assert isinstance(win.device_array, torch.Tensor)
        else:
            import jax

            assert isinstance(win.device_array, jax.Array)
        win.fence()
        win.free()
        return res

    res = _both(worlds, case)
    assert res[:7] == ["DeviceModule", (8, 8), True, [3.5, 4.5], 4.5,
                       [0.0, 10.0], [10.0, 7.0]]
    assert res[-1] == "ERR_OP"


def test_device_window_dtype_divergence_pinned(worlds):
    """A float64 base (``Win.create``'s default dtype): the reference's
    window is float32 (``jax.device_put`` without x64), the port's float64.
    The values of a dyadic put agree."""
    def case(w, pkg):
        win = pkg.Win.create(w, size=4, device=True)
        win.put(np.array([0.5, 1.25]), 2, offset=1)
        got = win.get(4, 2)
        dtype = str(win.device_array.dtype).replace("torch.", "")
        win.free()
        return dtype, str(got.dtype), got.tolist()

    got = {name: case(w, pkg) for name, (w, pkg) in worlds.items()}
    assert got["jax"][:2] == ("float32", "float32")
    assert got["torch"][:2] == ("float64", "float64")
    assert got["jax"][2] == got["torch"][2] == [0.0, 0.5, 1.25, 0.0]


# -- the multi-process windows -------------------------------------------

WORKER = r'''
import json, sys
import numpy as np

pkg = sys.argv[1]
if pkg == "torch":
    import ompi_tpu_torch as m
    from ompi_tpu_torch.api.errors import MpiError
    from ompi_tpu_torch.api.group import Group
    w = m.init(device="cpu")
else:
    import ompi_tpu as m
    from ompi_tpu.api.errors import MpiError
    from ompi_tpu.api.group import Group
    w = m.init()
Win = m.Win
r, n = w.rank, w.size
scenario = None


def out(key, value):
    print(json.dumps([scenario, key, value]), flush=True)


def module(win):
    out("module", [type(win.module).__name__, hasattr(win.module, "_agent")])


# tests/test_osc.py:84-249 -------------------------------------------------
scenario = "fence"
win = Win.create(w, size=8)
module(win)
win.fence()
win.put(np.array([float(r)]), target=(r + 1) % n, offset=r)
win.fence()
left = (r - 1) % n
got = win.get(1, target=left, offset=(left - 1) % n)
out("local", [win.local.tolist(), float(got[0])])
win.fence()
win.free()

scenario = "lock_shared_accumulate"
win = Win.create(w, size=1)
for _ in range(10):
    win.lock(0, win.LOCK_SHARED)
    win.accumulate(np.ones(1), target=0)
    win.unlock(0)
w.barrier()
out("counter", win.local.tolist() if r == 0 else None)
win.free()

scenario = "lock_exclusive_rmw"
win = Win.create(w, size=1)
for _ in range(5):
    win.lock(0, win.LOCK_EXCLUSIVE)
    cur = win.get(1, target=0)[0]
    win.put(np.array([cur + 1.0]), target=0)
    win.unlock(0)
w.barrier()
out("counter", win.local.tolist() if r == 0 else None)
win.free()

scenario = "fetch_and_op_tickets"
win = Win.create(w, size=1, dtype=np.int64)
tickets = [int(win.fetch_and_op(1, target=0)) for _ in range(5)]
w.barrier()
flat = sorted(np.asarray(w.allgather(np.array(tickets, np.int64)))
              .ravel().tolist())
out("tickets", flat)
win.free()

scenario = "pscw_all"
win = Win.create(w, size=4)
others = Group([x for x in range(n) if x != r])
win.post(others)
win.start(others)
for t in range(n):
    if t != r:
        win.put(np.array([float(r)]), target=t, offset=r % 4)
win.complete()
win.wait()
out("local", win.local.tolist())
win.free()

scenario = "dynamic"
win = Win.create_dynamic(w)
module(win)
mem = np.full(4, r * 10.0)
h = win.attach_region(mem)
handles = [int(np.ravel(x)[0])
           for x in np.asarray(w.allgather(np.array([h], np.int64)))]
w.barrier()
peer = (r + 1) % n
out("get", win.get(4, peer, offset=0, region=handles[peer]).tolist())
win.put(np.array([99.0]), peer, offset=1, region=handles[peer])
win.fence()
w.barrier()
out("mem", mem.tolist())
win.detach_region(h)
w.barrier()
try:
    win.get(4, peer, offset=0, region=handles[peer])
    out("detached get", "succeeded")
except MpiError as exc:
    out("detached get", exc.error_class.name)
w.barrier()
win.free()

# tests/test_osc_rdma.py ---------------------------------------------------
scenario = "accumulate_and_fetch_op"
win = Win.create(w, size=2, dtype=np.int64)
module(win)
win.fence()
for _ in range(50):
    win.accumulate(np.array([1], np.int64), 0, offset=0)
win.fence()
counter = int(win.local[0]) if r == 0 else None
t = int(win.fetch_and_op(1, 0, offset=1))
win.fence()
out("counters", [counter, 0 <= t < n, int(win.local[1]) if r == 0 else None])
win.free()

scenario = "lock_and_cas"
win = Win.create(w, size=4, dtype=np.int64)
win.fence()
for _ in range(25):
    win.lock(0, Win.LOCK_EXCLUSIVE)
    v = win.get(1, 0, offset=0)
    win.put(v + 1, 0, offset=0)
    win.unlock(0)
w.barrier()
counter = int(win.local[0]) if r == 0 else None
old = win.compare_and_swap(r + 1, 0, 0, offset=2)
wins = np.asarray(w.allgather(np.array([1 if old == 0 else 0], np.int64)))
out("election", [counter, int(wins.sum())])
win.fence()
win.free()

scenario = "pscw_pair"
win = Win.create(w, size=4, dtype=np.float64)
if r == 1:
    win.post(Group([w.group.world_rank(0)]))
    win.wait()
    out("local", win.local.tolist())
elif r == 0:
    win.start(Group([w.group.world_rank(1)]))
    win.put(np.array([77.5]), 1, offset=2)
    win.complete()
w.barrier()
win.free()

scenario = "shared_query_and_request_rma"
win, buf = Win.allocate_shared(w, 8, np.float64)
buf[:] = r * 100.0
win.fence()
peer = (r + 1) % n
try:
    out("view", float(win.shared_query(peer)[0]))
except MpiError as exc:
    out("view", exc.error_class.name)
win.fence()
q = win.rput(np.array([7.0]), peer, offset=1)
q.wait()
win.flush(peer)
q = win.rget(2, peer, offset=0)
q.wait()
out("rget", q.result.tolist())
win.fence()
win.free()
m.finalize()
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


def _scenarios(stdout):
    """{scenario: {rank: [its (key, value) lines]}} of a job's output."""
    import json

    out = {}
    for line in stdout.splitlines():
        rank, _, rest = line.partition("] ")
        if line.startswith("[") and rest.startswith('["'):
            scenario, key, value = json.loads(rest)
            out.setdefault(scenario, {}).setdefault(int(rank[1:]), []) \
                .append([key, value])
    return out


#: the osc selections: (tpurun arguments, the module of a static window)
SELECTIONS = {
    "rdma": ([], "RdmaModule"),
    "pt2pt": (["--mca", "osc", "^rdma", "--mca", "btl", "tcp,self"],
              "Pt2ptModule"),
    "pt2pt_nodes": (["--fake-nodes", "4"], "Pt2ptModule"),
}

_jobs: dict = {}


def _job(tmp_path_factory, selection):
    """Both packages' job under one selection, run once for the module."""
    if selection not in _jobs:
        path = tmp_path_factory.mktemp("osc") / "worker.py"
        path.write_text(WORKER)
        args = SELECTIONS[selection][0]
        got = _tpurun("torch", 4, [*args, sys.executable, str(path),
                                   "torch"], timeout=150)
        want = _tpurun("jax", 4, [*args, sys.executable, str(path), "jax"],
                       timeout=150)
        _jobs[selection] = got, want
    got, want = _jobs[selection]
    assert got.returncode == 0, got.stdout + got.stderr
    assert want.returncode == 0, want.stdout + want.stderr
    return _scenarios(got.stdout), _scenarios(want.stdout)


def _equal(tmp_path_factory, selection, scenario):
    got, want = _job(tmp_path_factory, selection)
    assert sorted(got[scenario]) == sorted(want[scenario])
    for rank in got[scenario]:
        assert got[scenario][rank] == want[scenario][rank], rank
    return got[scenario]


@pytest.mark.parametrize("selection", sorted(SELECTIONS))
def test_put_get_fence(tmp_path_factory, selection):
    lines = _equal(tmp_path_factory, selection, "fence")
    module = SELECTIONS[selection][1]
    assert lines[0][0] == ["module", [module, module == "Pt2ptModule"]]
    # rank 3 wrote 3.0 at offset 3 of rank 0's region, and rank 0 read what
    # rank 2 wrote into rank 3's
    assert lines[0][1] == ["local", [[0.0, 0.0, 0.0, 3.0] + [0.0] * 4, 2.0]]


@pytest.mark.parametrize("selection", sorted(SELECTIONS))
def test_passive_lock_accumulate(tmp_path_factory, selection):
    lines = _equal(tmp_path_factory, selection, "lock_shared_accumulate")
    assert lines[0] == [["counter", [40.0]]]


@pytest.mark.parametrize("selection", sorted(SELECTIONS))
def test_exclusive_lock_read_modify_write(tmp_path_factory, selection):
    lines = _equal(tmp_path_factory, selection, "lock_exclusive_rmw")
    assert lines[0] == [["counter", [20.0]]]


@pytest.mark.parametrize("selection", sorted(SELECTIONS))
def test_fetch_and_op_global_counter(tmp_path_factory, selection):
    lines = _equal(tmp_path_factory, selection, "fetch_and_op_tickets")
    assert lines[2] == [["tickets", list(range(20))]]


@pytest.mark.parametrize("selection", sorted(SELECTIONS))
def test_pscw(tmp_path_factory, selection):
    lines = _equal(tmp_path_factory, selection, "pscw_all")
    assert lines[1] == [["local", [0.0, 0.0, 2.0, 3.0]]]


@pytest.mark.parametrize("selection", sorted(SELECTIONS))
def test_dynamic_window_attach_detach(tmp_path_factory, selection):
    lines = _equal(tmp_path_factory, selection, "dynamic")
    assert lines[0] == [["module", ["Pt2ptModule", True]],
                        ["get", [10.0] * 4], ["mem", [0.0, 99.0, 0.0, 0.0]],
                        ["detached get", "ERR_RMA_CONFLICT"]]


@pytest.mark.parametrize("selection", sorted(SELECTIONS))
def test_accumulate_and_fetch_op(tmp_path_factory, selection):
    lines = _equal(tmp_path_factory, selection, "accumulate_and_fetch_op")
    assert lines[0][1] == ["counters", [200, True, 4]]


@pytest.mark.parametrize("selection", sorted(SELECTIONS))
def test_passive_lock_and_cas(tmp_path_factory, selection):
    lines = _equal(tmp_path_factory, selection, "lock_and_cas")
    assert lines[0] == [["election", [100, 1]]]


@pytest.mark.parametrize("selection", sorted(SELECTIONS))
def test_pscw_pair(tmp_path_factory, selection):
    lines = _equal(tmp_path_factory, selection, "pscw_pair")
    assert lines[1] == [["local", [0.0, 0.0, 77.5, 0.0]]]


@pytest.mark.parametrize("selection", sorted(SELECTIONS))
def test_shared_query_and_request_rma(tmp_path_factory, selection):
    lines = _equal(tmp_path_factory, selection,
                   "shared_query_and_request_rma")
    view = 100.0 if selection == "rdma" else "ERR_RMA_CONFLICT"
    assert lines[0] == [["view", view], ["rget", [100.0, 7.0]]]


def test_pt2pt_over_sm_is_steady(tmp_path):
    """osc/pt2pt between the ranks of one node (``--mca osc ^rdma``, btl/sm),
    the port alone: every scenario's lines are the ones the two-package
    selections hold (see the module docstring for the reference's hang)."""
    path = tmp_path / "worker.py"
    path.write_text(WORKER)
    got = _tpurun("torch", 4, ["--mca", "osc", "^rdma", sys.executable,
                               str(path), "torch"], timeout=150)
    assert got.returncode == 0, got.stdout + got.stderr
    lines = _scenarios(got.stdout)
    assert lines["fence"][0][0] == ["module", ["Pt2ptModule", True]]
    assert lines["lock_shared_accumulate"][0] == [["counter", [40.0]]]
    assert lines["lock_exclusive_rmw"][0] == [["counter", [20.0]]]
    assert lines["fetch_and_op_tickets"][2] == [["tickets", list(range(20))]]
    assert lines["accumulate_and_fetch_op"][0][1] == \
        ["counters", [200, True, 4]]
    assert lines["lock_and_cas"][0] == [["election", [100, 1]]]
    assert lines["pscw_pair"][1] == [["local", [0.0, 0.0, 77.5, 0.0]]]


BOTH_THREADS = r'''
import json, sys
import numpy as np
import ompi_tpu_torch as m
from ompi_tpu_torch.runtime import spc
w = m.init(device="cpu")
r, peer = w.rank, 1 - w.rank
half = (1 << 20) // 8                  # 1 MB of float64: above rget_limit
win = m.Win.create(w, size=2 * half)
win.local[:half] = r + 1
win.fence()
rounds, right = 12, True
for i in range(rounds):
    # my get's reply leaves the peer's agent thread while the peer's
    # application thread sends me its put: both above rget_limit over sm
    win.lock(peer, win.LOCK_SHARED)
    got = win.get(half, peer)
    win.put(np.full(half, 100.0 * r + i), peer, offset=half)
    win.unlock(peer)
    right &= bool(np.all(got == peer + 1))
w.barrier()
print(json.dumps({"module": type(win.module).__name__, "gets": right,
                  "puts": bool(np.all(win.local[half:]
                                      == 100.0 * peer + rounds - 1)),
                  "rget_msgs": spc.read("rget_msgs") >= 2 * rounds}),
      flush=True)
win.free()
m.finalize()
'''


def test_pt2pt_agent_and_application_both_rget_over_sm(tmp_path):
    """osc/pt2pt over btl/sm, the port alone: each rank's agent thread
    replies to 1 MB gets while its application thread sends 1 MB puts, both
    by RGET from btl/sm's segments; every reply and every put arrives."""
    path = tmp_path / "both_threads.py"
    path.write_text(BOTH_THREADS)
    got = _tpurun("torch", 2, ["--mca", "osc", "^rdma", sys.executable,
                               str(path)], timeout=120)
    assert got.returncode == 0, got.stdout + got.stderr
    want = '{"module": "Pt2ptModule", "gets": true, "puts": true, ' \
        '"rget_msgs": true}'
    assert sorted(line.partition("] ")[2] for line in got.stdout.splitlines()
                  if line.startswith("[")) == [want, want]
