"""The port's multi-process world on the CPU lane, held against the JAX
package's: the same jobs launched by each package's ``tpurun`` (the
coordination service, ProcRte, btl/self + btl/sm, pml/ob1, the coll
components), their per-rank outputs compared line for line.  The first
jobs run both packages with ``--mca coll basic,self_coll``; the
reference's ranks keep their own btls (its btl/sm pulls messages above
512 KB one-sidedly, the port's streams them: the same bytes).  The port's
ranks bind ``--device cpu``.

Jobs: the ring (``tpurun -n 4`` of each package's ``ring`` example); the
host collectives and ``split``/``dup``/``create_group`` under ``-n 4``; a
rendezvous message of 2 MB under ``-n 2``; tensors (the reference's
``jax.Array``) as send buffers of point-to-point and of coll/basic's
allreduce; and the failure teardown (a rank that exits 3 brings the job
down with 3).  The default-selection jobs run both packages with no
``--mca coll`` list at ``-n 2``, ``3`` and ``4`` (coll/tuned's picks,
coll/libnbc's ``i*``), and at ``-n 4`` and ``5`` across ``--fake-nodes 2``
(coll/han).  Every subprocess has its own ``timeout=``.
"""
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

WORKER = r'''
import json, sys
import numpy as np

pkg, mode = sys.argv[1], sys.argv[2]
if pkg == "torch":
    import ompi_tpu_torch as m
    from ompi_tpu_torch.api.status import ANY_SOURCE
    w = m.init(device="cpu")
else:
    import ompi_tpu as m
    from ompi_tpu.api.status import ANY_SOURCE
    w = m.init()
r, n = w.rank, w.size


def out(key, value):
    print(json.dumps([key, value]), flush=True)


def hexed(a):
    a = np.ascontiguousarray(a)
    return [str(a.dtype), list(a.shape), a.tobytes().hex()]


def tensor(host):
    """A device buffer of this package (a tensor / a jax.Array)."""
    if pkg == "torch":
        import torch
        return torch.from_numpy(host)
    import jax.numpy as jnp
    return jnp.asarray(host)


rng = np.random.default_rng(11)          # the same data on every rank
base = rng.standard_normal((n, 8)).astype(np.float32)
mine = base[r]
if mode == "coll":
    out("allreduce", hexed(w.allreduce(mine)))
    out("allreduce_max", hexed(w.allreduce(mine, m.MAX)))
    red = w.reduce(mine, m.PROD, 2)
    out("reduce", hexed(red) if r == 2 else red)
    out("allgather", hexed(w.allgather(mine)))
    gat = w.gather(mine, 1)
    out("gather", hexed(gat) if r == 1 else gat)
    out("scatter", hexed(w.scatter(base if r == 3 else mine, 3)))
    out("scan", hexed(w.scan(mine)))
    out("exscan", hexed(w.exscan(mine)))
    out("alltoall", hexed(w.alltoall(base * (r + 1))))
    cnts = rng.integers(0, 6, (n, n))
    got = w.alltoallv([base[r, :cnts[r][j]] for j in range(n)])
    out("alltoallv", [hexed(g) for g in got])
    out("bcast", hexed(w.bcast(base[2] if r == 2 else np.zeros(8, np.float32),
                               root=2)))
    out("reduce_scatter", hexed(w.reduce_scatter(np.tile(mine, n))))
    gv = w.gatherv(base[r, :r + 1], 0)
    out("gatherv", [hexed(g) for g in gv] if r == 0 else gv)
    out("allgatherv", [hexed(g) for g in w.allgatherv(base[r, :r + 2])])
    sub = w.split(color=r % 2, key=-r)
    out("split", [sub.size, sub.rank, sub.cid,
                  hexed(sub.allreduce(mine))])
    d = w.dup()
    out("dup", [d.cid, hexed(d.allgather(np.array([r])))])
    g = w.create_group(w.group.incl([0, 2, 3])) if r != 1 else None
    out("create_group", None if g is None else [g.cid, g.size, g.rank])
    w.barrier()
    out("agree", w.agree(0b1011 if r else 0b1111))
elif mode == "p2p":
    k = 1 << 18                       # 2 MB of float64: above every eager limit
    if r == 0:
        w.send(np.arange(k, dtype=np.float64), dest=1, tag=5)
        w.send(tensor(base[0]), dest=1, tag=6)
        st = w.probe(source=1, tag=7)
        buf = np.zeros(st._nbytes, np.uint8)
        st = w.recv(buf, source=ANY_SOURCE, tag=7)
        out("back", [st.source, st.tag, st._nbytes, buf.tobytes().hex()])
    else:
        big = np.zeros(k, np.float64)
        st = w.recv(big, source=0, tag=5)
        out("rndv", [st.source, st._nbytes, bool(np.all(big == np.arange(k)))])
        small = np.zeros(8, np.float32)
        st = w.recv(small, source=0, tag=6)
        out("tensor", [st._nbytes, hexed(small)])
        w.ssend(np.arange(5, dtype=np.int16), dest=0, tag=7)
    out("allreduce_tensor", hexed(w.allreduce(tensor(mine))))
m.finalize()
'''

#: the default-selection jobs: which component owns each slot, tuned's
#: picks across its thresholds (and every allreduce entry forced through
#: the var), the twelve ``i*`` schedules of libnbc, a tensor in and numpy
#: out, and with ``--fake-nodes 2`` han's compositions, its decline on a
#: comm with one rank a node, and its sub-comms freed with their parent
DEFAULT = r'''
import hashlib, json, sys
import numpy as np

pkg, mode = sys.argv[1], sys.argv[2]
if pkg == "torch":
    import ompi_tpu_torch as m
    from ompi_tpu_torch.api import op as op_mod
    from ompi_tpu_torch.base.var import registry
    from ompi_tpu_torch.mca.coll import algorithms as algs
    w = m.init(device="cpu")
else:
    import ompi_tpu as m
    from ompi_tpu.api import op as op_mod
    from ompi_tpu.base.var import registry
    from ompi_tpu.mca.coll import algorithms as algs
    w = m.init()
r, n = w.rank, w.size
SLOTS = ("barrier", "bcast", "gather", "gatherv", "scatter", "scatterv",
         "allgather", "allgatherv", "alltoall", "alltoallv", "alltoallw",
         "reduce", "allreduce", "reduce_scatter", "scan", "exscan",
         "ibarrier", "ibcast", "igather", "iscatter", "iallgather",
         "ialltoall", "ireduce", "iallreduce", "ireduce_scatter", "iscan",
         "iexscan")


def out(key, value):
    print(json.dumps([key, value]), flush=True)


def hexed(a):
    # a digest keeps every line short: the launchers' output pumps may
    # interleave lines of several ranks that run past the pipe's buffer
    if a is None:
        return None
    if isinstance(a, list):
        return [hexed(x) for x in a]
    a = np.ascontiguousarray(a)
    return [str(a.dtype), list(a.shape),
            hashlib.sha256(a.tobytes()).hexdigest()]


def owners(c):
    # agree is coll/ftagree's in the reference (ROADMAP A 6), basic's here;
    # a slot coll/demo or coll/sync wrapped names its wrapper
    return {k: type(getattr(c.c_coll[k], "__self__", None)
                    or c.c_coll[k]).__name__ for k in SLOTS
            if k in c.c_coll}


def signed_product(invec, inoutvec, datatype=None):
    np.multiply(invec, np.abs(inoutvec), out=inoutvec)


nc = op_mod.create(signed_product, commute=False)
rng = np.random.default_rng(17)           # the same data on every rank


def data(k, dtype=np.float32):
    return rng.standard_normal((n, k)).astype(dtype)


out("owners", owners(w))
if mode == "default":
    for k in (3, 1000, 20000, 200000):
        x = data(k)
        out(f"allreduce {k}", hexed(w.allreduce(x[r])))
        out(f"allreduce nc {k}", hexed(w.allreduce(
            np.abs(x[r]) + 0.5, nc)))
        out(f"reduce_scatter {k}", hexed(w.reduce_scatter(x[r])))
    for k in (100, 20000):
        x = data(k)
        out(f"reduce {k}", hexed(w.reduce(x[r], m.SUM, n - 1)))
        out(f"reduce nc {k}", hexed(w.reduce(np.abs(x[r]) + 0.5, nc, 0)))
        out(f"gather {k}", hexed(w.gather(x[r], 0)))
        out(f"scatter {k}", hexed(w.scatter(x if r == 1 else x[r], 1)))
    for k in (100, 1000, 300000):
        x = data(k)
        out(f"bcast {k}", hexed(w.bcast(x[0] if r == 0 else x[r] * 0, 0)))
    for k in (10, 1000, 150000):
        out(f"allgather {k}", hexed(w.allgather(data(k)[r])))
    for k in (4, 128):
        out(f"alltoall {k}", hexed(w.alltoall(data(n * k).reshape(
            n, n, k)[r])))
    w.barrier()
    x = data(16384)
    registry.set("otpu_coll_tuned_allreduce_segsize", 8192)
    for alg in sorted(algs.ALLREDUCE):
        registry.set("otpu_coll_tuned_allreduce_algorithm", alg)
        out(f"forced {alg}", hexed(w.allreduce(x[r])))
    registry.set("otpu_coll_tuned_allreduce_algorithm", "")
    x = data(40)
    reqs = [("ibarrier", w.ibarrier()),
            ("ibcast", w.ibcast(x[1] if r == 1 else x[r] * 0, 1)),
            ("iallreduce", w.iallreduce(x[r])),
            ("iallreduce nc", w.iallreduce(np.abs(x[r]) + 0.5, nc)),
            ("iallgather", w.iallgather(x[r])),
            ("ialltoall", w.ialltoall(data(n * 3).reshape(n, n, 3)[r])),
            ("ireduce", w.ireduce(x[r], m.SUM, n - 1)),
            ("igather", w.igather(x[r], 0)),
            ("iscatter", w.iscatter(x if r == 0 else x[r], 0)),
            ("ireduce_scatter", w.ireduce_scatter(x[r])),
            ("iscan", w.iscan(x[r])),
            ("iexscan", w.iexscan(x[r]))]
    for name, q in reversed(reqs):
        q.wait()
    for name, q in reqs:
        out(name, hexed(q.result))
    sub = w.split(r % 2, key=-r)
    out("split", [sub.size, sub.rank, sub.cid, hexed(sub.allreduce(x[r]))])
elif mode == "interpose":
    # coll/adapt raised (4 KB segments), coll/sync's barrier every 3 rooted
    # calls, coll/demo announcing each wrapped slot on the coll stream
    x = data(3000)
    out("bcast", hexed(w.bcast(x[2] if r == 2 else x[r] * 0, 2)))
    out("reduce", hexed(w.reduce(x[r], m.SUM, 1)))
    out("reduce nc", hexed(w.reduce(np.abs(x[r]) + 0.5, nc, 0)))
    q = w.ibcast(x[0].astype(np.float64) if r == 0 else np.zeros(3000), 0)
    q.wait()
    out("ibcast", hexed(q.result))
    q = w.ireduce(x[r], m.MAX, 3)
    q.wait()
    out("ireduce", hexed(q.result))
    for i in range(4):
        out(f"scatter {i}", hexed(w.scatter(x[:, :5] if r == i else
                                            x[r][:5], i)))
    out("allreduce", hexed(w.allreduce(x[r])))
else:
    x = data(64)
    out("han sym", hexed(w.allreduce(x[r])))
    out("han leader", hexed(w.allreduce(x[r][:7])))
    out("han max", hexed(w.allreduce(x[r], m.MAX)))
    out("han nc", hexed(w.allreduce(np.abs(x[r]) + 0.5, nc)))
    out("han bcast", hexed(w.bcast(x[1] if r == 1 else x[r] * 0, 1)))
    out("han bcast leader", hexed(w.bcast(x[2] if r == 2 else x[r] * 0, 2)))
    out("han reduce", hexed(w.reduce(x[r], m.SUM, n - 1)))
    out("han allgather", hexed(w.allgather(x[r][:5])))
    w.barrier()
    out("han gather", hexed(w.gather(x[r][:3], n - 2)))
    out("han scatter", hexed(w.scatter(x[:, :4] if r == 1 else x[r][:4], 1)))
    out("han alltoall", hexed(w.alltoall(data(n * 2).reshape(n, n, 2)[r])))
    q = w.iallreduce(x[r])
    q.wait()
    out("han iallreduce", hexed(q.result))
    mod = w.c_coll["allreduce"].__self__
    out("subs", [c.size for c in (mod._low, mod._up, mod._leaders)
                 if c is not None])
    one = w.split(0 if r in (0, n - 1) else 1)
    out("one a node", [type(one.c_coll["allreduce"].__self__).__name__,
                       hexed(one.allreduce(x[r]))])
    d = w.dup()
    out("dup", [d.cid, hexed(d.allreduce(x[r]))])
    dm = d.c_coll["allreduce"].__self__
    subs = [c for c in (dm._low, dm._up, dm._leaders) if c is not None]
    d.free()
    out("freed", [dm._low is None, [c.freed for c in subs]])
    out("after", [w.dup().cid, hexed(w.allreduce(x[r]))])
m.finalize()
'''

DRAIN = r'''
import time
import numpy as np
import ompi_tpu_torch as m
w = m.init(device="cpu")
n = 2 << 20                 # 8 MB of float32: more than a 4 MB sm ring holds
if w.rank == 0:
    w.send(np.arange(n, dtype=np.float32), dest=1, tag=1)
else:
    time.sleep(1.0)         # rank 0 reaches finalize with frames queued
    buf = np.zeros(n, np.float32)
    w.recv(buf, source=0, tag=1)
    print("drained", bool(np.all(buf == np.arange(n))), flush=True)
m.finalize()
'''

NO_DRAIN = r'''
import time
import numpy as np
import ompi_tpu_torch as m
from ompi_tpu_torch.mca.btl import sm
sm.FLUSH_TIMEOUT_S = 1.0
w = m.init(device="cpu")
if w.rank == 0:
    for i in range(20):     # 5 MB of eager sends: more than the 4 MB ring
        w.send(np.full(1 << 16, i, np.float32), dest=1, tag=1)
    print("sent", flush=True)
    m.finalize()
else:
    time.sleep(60)          # never drains: the launcher ends this rank
'''

FAIL = r'''
import os, sys, time
if int(os.environ["OTPU_RANK"]) == 1:
    sys.exit(3)
time.sleep(30)
'''


def _tpurun(pkg, n, args, timeout, extra_env=None):
    """Run a job; on a timeout the launcher's whole process group (its
    ranks too) is killed before the error propagates."""
    env = dict(os.environ)
    env.pop("OTPU_RANK", None)
    env.pop("OTPU_NPROCS", None)
    env.update(extra_env or {})
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


def _lines(stdout):
    """{rank: [its lines]} of a job's rank-prefixed output."""
    out = {}
    for line in stdout.splitlines():
        if line.startswith("["):
            rank, _, rest = line.partition("] ")
            out.setdefault(int(rank[1:]), []).append(rest)
    return out


@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    path = tmp_path_factory.mktemp("mp") / "worker.py"
    path.write_text(WORKER)
    return path


def test_ring_matches_the_reference():
    got = _tpurun("torch", 4, [sys.executable, "-m",
                               "ompi_tpu_torch.examples.ring", "--device",
                               "cpu"], timeout=120)
    want = _tpurun("jax", 4, [sys.executable, "examples/ring.py"],
                   timeout=120)
    assert got.returncode == 0, got.stdout + got.stderr
    assert want.returncode == 0, want.stdout + want.stderr
    assert _lines(got.stdout) == _lines(want.stdout)
    assert _lines(got.stdout)[0] == [f"rank 0: token now {t}"
                                     for t in range(9, -1, -1)] + \
        ["rank 0 exiting"]


@pytest.mark.parametrize("mode,n", [("coll", 4), ("p2p", 2)])
def test_jobs_match_the_reference(worker, mode, n):
    got = _tpurun("torch", n, ["--mca", "coll", "basic,self_coll",
                               sys.executable, str(worker), "torch", mode],
                  timeout=150)
    want = _tpurun("jax", n, ["--mca", "coll", "basic,self_coll",
                              sys.executable, str(worker), "jax", mode],
                   timeout=150)
    assert got.returncode == 0, got.stdout + got.stderr
    assert want.returncode == 0, want.stdout + want.stderr
    got_l, want_l = _lines(got.stdout), _lines(want.stdout)
    assert sorted(got_l) == list(range(n))
    for rank in range(n):
        assert got_l[rank] == want_l[rank], rank
    if mode == "p2p":
        assert '"rndv", [0, 2097152, true]' in got_l[1][0]


@pytest.fixture(scope="module")
def default_worker(tmp_path_factory):
    path = tmp_path_factory.mktemp("mp") / "default.py"
    path.write_text(DEFAULT)
    return path


@pytest.mark.parametrize("mode,n", [("default", 2), ("default", 3),
                                    ("default", 4), ("han", 4), ("han", 5),
                                    ("interpose", 4)])
def test_default_selection_matches_the_reference(default_worker, mode, n):
    """Both packages under default selection: the same component owns
    every slot (tuned, libnbc, basic; han across ``--fake-nodes 2``, 2+2
    and 3+2 ranks), and every line of the job is equal.  The reference runs
    without its native core (``OTPU_NATIVE_DISABLE``), as the port has
    none: its coll/sm would take single-node comms (ROADMAP A 4)."""
    extra = {"han": ["--fake-nodes", "2"],
             "interpose": ["--mca", "coll_adapt_priority", "60",
                           "--mca", "coll_adapt_segsize", "4k",
                           "--mca", "coll_sync_barrier_after", "3",
                           "--mca", "coll_demo_priority", "100",
                           "--mca", "coll_base_verbose", "1"]}.get(mode, [])
    got = _tpurun("torch", n, [*extra, sys.executable, str(default_worker),
                               "torch", mode], timeout=150)
    want = _tpurun("jax", n, [*extra, sys.executable, str(default_worker),
                              "jax", mode], timeout=150,
                   extra_env={"OTPU_NATIVE_DISABLE": "1"})
    assert got.returncode == 0, got.stdout + got.stderr
    assert want.returncode == 0, want.stdout + want.stderr
    got_l, want_l = _lines(got.stdout), _lines(want.stdout)
    assert sorted(got_l) == list(range(n))
    for rank in range(n):
        assert got_l[rank] == want_l[rank], rank
    owners = got_l[0][0]
    if mode == "interpose":
        # demo wraps the slots it announces; adapt owns ibcast and ireduce
        assert '"ibcast": "AdaptModule"' in owners
        assert '"iallgather": "LibnbcModule"' in owners
        assert any(x.startswith("demo: bcast on COMM_WORLD (rank 0)")
                   or "demo: bcast on COMM_WORLD (rank 0)" in x
                   for x in got_l[0])
        return
    if mode == "han":
        assert '"allreduce": "HanModule"' in owners
        assert '"freed", [true, [true, true' in got_l[0][-2]
    else:
        assert '"allreduce": "TunedModule"' in owners
    assert '"iallgather": "LibnbcModule"' in owners
    assert '"scan": "BasicCollModule"' in owners


def test_finalize_drains_queued_sends(tmp_path):
    """A send completes once its frames are packed; over btl/sm the last
    of an 8 MB stream can still wait for ring space when the sender
    reaches finalize, and the finalize fence stops the sender's progress.
    The port drains the btls before that fence, so the job ends without
    waiting out the fence's 10 s timeout.  (The reference fences first and
    relies on its native reactor's progress thread, or on RGET, to move
    those frames; ROADMAP C.)"""
    script = tmp_path / "drain.py"
    script.write_text(DRAIN)
    r = _tpurun("torch", 2, [sys.executable, str(script)], timeout=90)
    assert r.returncode == 0, r.stdout + r.stderr
    assert _lines(r.stdout)[1] == ["drained True"]
    assert "expired" not in r.stdout


def test_undeliverable_frames_fail_the_job(tmp_path):
    """Eager sends complete locally; when their receiver never drains, the
    frames the ring cannot hold stay queued.  Finalize's flush then fails
    the sending rank (MPI ``ERR_OTHER``) instead of dropping them and
    exiting 0, and the launcher brings the job down with that code."""
    script = tmp_path / "nodrain.py"
    script.write_text(NO_DRAIN)
    r = _tpurun("torch", 2, [sys.executable, str(script)], timeout=90)
    assert r.returncode == 1, r.stdout + r.stderr
    assert _lines(r.stdout)[0][0] == "sent"
    assert "frames still queued for world ranks {1:" in r.stdout + r.stderr
    assert "terminated with exit code 1" in r.stderr


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_failure_teardown(tmp_path, pkg):
    script = tmp_path / "fail.py"
    script.write_text(FAIL)
    r = _tpurun(pkg, 3, [sys.executable, str(script)], timeout=60)
    assert r.returncode == 3
    assert "terminated with exit code 3" in r.stderr


def test_a_rank_without_a_card_raises():
    """Under tpurun a rank's ``init()`` binds the card; with none visible
    and no ``device="cpu"`` it raises, never falling back to the CPU."""
    r = _tpurun("torch", 2, [sys.executable, "-c",
                             "import ompi_tpu_torch; ompi_tpu_torch.init()"],
                timeout=60, extra_env={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stdout


def test_the_launcher_imports_no_torch():
    """The launcher (and the coordination server it runs) never imports
    torch, so it creates no CUDA context: each rank binds its own card."""
    code = ("import sys, ompi_tpu_torch, ompi_tpu_torch.tools.tpurun, "
            "ompi_tpu_torch.rte.coord; print('torch' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60, cwd=REPO)
    assert r.returncode == 0 and r.stdout.strip() == "False", r.stderr


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_sm_ring_frames_match_the_reference(writer):
    """btl/sm's ring layout is the reference's: frames one package pushes
    (across the ring's wrap, with the payload cut at odd sizes) pop whole
    and byte-exact from the other's ring over the same segment."""
    from multiprocessing import shared_memory

    import numpy as np

    from ompi_tpu.mca.btl import sm as jsm
    from ompi_tpu_torch.mca.btl import sm as tsm

    shm = shared_memory.SharedMemory(create=True, size=4096 + 16)
    push = pop = None
    try:
        mods = {"torch": tsm, "jax": jsm}
        push = mods[writer]._Ring(shm, owner=True)
        pop = mods["jax" if writer == "torch" else "torch"]._Ring(
            shm, owner=False)
        rng = np.random.default_rng(9)
        for size in (1000, 1500, 3, 2000, 0, 1777, 999, 2500):
            hdr = rng.integers(0, 255, 40, dtype=np.uint8).tobytes()
            body = rng.integers(0, 255, size, dtype=np.uint8)
            assert push.push_frame(hdr, body)
            frame = pop.pop_frame()
            assert bytes(frame[:4]) == len(hdr).to_bytes(4, "little")
            assert bytes(frame[4:44]) == hdr and bytes(frame[44:]) == \
                body.tobytes()
            assert pop.pop_frame() is None
        assert not push.push_frame(b"x", np.zeros(5000, np.uint8))
    finally:
        push = pop = None     # the rings' views of the segment go first
        shm.close()
        shm.unlink()
