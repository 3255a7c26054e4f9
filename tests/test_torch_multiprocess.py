"""The port's multi-process world on the CPU lane, held against the JAX
package's: the same jobs launched by each package's ``tpurun`` (the
coordination service, ProcRte, btl/self + btl/sm, pml/ob1, the coll
components), their per-rank outputs compared line for line.  The first
jobs run both packages with ``--mca coll basic,self_coll``; both pull
messages above 512 KB one-sidedly over btl/sm (ob1's RGET rung).  The
port's ranks bind ``--device cpu``.

Jobs: the ring (``tpurun -n 4`` of each package's ``ring`` example); the
host collectives and ``split``/``dup``/``create_group`` under ``-n 4``; a
rendezvous message of 2 MB under ``-n 2``; tensors (the reference's
``jax.Array``) as send buffers of point-to-point and of coll/basic's
allreduce; and the failure teardown (a rank that exits 3 brings the job
down with 3).  The default-selection jobs run both packages with no
``--mca coll`` list at ``-n 2``, ``3`` and ``4`` (coll/tuned's picks,
coll/libnbc's ``i*``; coll/sm with the native core), and at ``-n 4`` and
``5`` across ``--fake-nodes 2`` (coll/han), with the native core on in
both packages and, in two cases, off in both.  The transport jobs run a
``-n 2 --mca btl tcp,self`` ping-pong, the ``--fake-nodes 2`` transport
matrix (btl/sm within a node, btl/tcp between), the quantized wire's 4 MB
allreduce, a 16 MB stream striped over sm and tcp, and coll/sm's slots.
Every subprocess has its own ``timeout=``.
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
    # agree is coll/ftagree's in the reference (ROADMAP A 4), basic's here;
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
    # coll/adapt folds a commutative op's segments in ARRIVAL order (both
    # packages), so a float SUM's rounding follows the scheduler: integer
    # values make every order exact, and the bits comparable
    out("reduce", hexed(w.reduce(np.round(x[r] * 64), m.SUM, 1)))
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

#: the host transports' jobs: a ping-pong at 8 B (eager) and 4 MB
#: (rendezvous) with each rank's transport to its peer, the transport
#: matrix, the quantized wire's 4 MB allreduce, and coll/sm's slots
TRANSPORT = r'''
import hashlib, json, sys
import numpy as np

pkg, mode = sys.argv[1], sys.argv[2]
if pkg == "torch":
    import ompi_tpu_torch as m
    from ompi_tpu_torch.mca.coll import quant
    from ompi_tpu_torch.runtime import spc
    w = m.init(device="cpu")
else:
    import ompi_tpu as m
    from ompi_tpu.mca.coll import quant
    from ompi_tpu.runtime import spc
    w = m.init()
r, n = w.rank, w.size


def out(key, value):
    print(json.dumps([key, value]), flush=True)


def digest(a):
    a = np.ascontiguousarray(a)
    return [str(a.dtype), list(a.shape),
            hashlib.sha256(a.tobytes()).hexdigest()[:32]]


rng = np.random.default_rng(29)
out("eps", {p: w.pml.bml.endpoint(p).btl.name for p in range(n) if p != r})
if mode == "pingpong":
    peer = (r + n // 2) % n
    for k in (2, 1 << 20):                  # 8 B and 4 MB of float32
        a = rng.standard_normal((n, k)).astype(np.float32)
        b = np.empty(k, np.float32)
        for _ in range(3):
            if r < n // 2:
                w.send(a[r], peer, 7)
                st = w.recv(b, peer, 7)
            else:
                st = w.recv(b, peer, 7)
                w.send(a[r], peer, 7)
        out(f"pingpong {4 * k}", [st.source, st._nbytes, digest(b),
                                  b.tobytes() == a[peer].tobytes()])
    # the last sender waits for its peer's ack, so it reaches finalize
    # with nothing queued (the reference fences before it drains)
    ack = np.zeros(1, np.int32)
    if r < n // 2:
        w.send(ack, peer, 9)
    else:
        w.recv(ack, peer, 9)
elif mode == "stripe":
    # 16 MB in one message between the ranks of one node: by RGET, or with
    # RGET off in one rendezvous stream whose FRAGs stripe over btl/sm and
    # btl/tcp by bandwidth; the tcp frames the sender framed show how many
    # took the second rail
    # (the receiver's ack keeps the sender out of finalize until every
    # frame is delivered: the reference fences before it drains)
    x = rng.standard_normal(1 << 22).astype(np.float32)
    ack = np.zeros(1, np.int32)
    if r == 0:
        before = spc.read("fastpath_hdr_fast")
        w.send(x, 1, 3)
        w.recv(ack, 1, 4)
        out("tcp frags", spc.read("fastpath_hdr_fast") - before)
        out("rget, striped", [spc.read("rget_msgs"),
                              spc.read("striped_msgs")])
    else:
        y = np.empty_like(x)
        w.recv(y, 0, 3)
        w.send(ack, 0, 4)
        out("received", [digest(y), y.tobytes() == x.tobytes()])
elif mode == "quantwire":
    x = rng.standard_normal((n, 1 << 20)).astype(np.float32)   # 4 MB
    got = w.allreduce(x[r])
    exact = x.astype(np.float64).sum(0)
    out("allreduce", [digest(got), float(np.abs(got - exact).max()
                                         / np.abs(exact).max())])
    out("wire_stats", quant.wire_stats())
else:
    owners = {k: type(w.c_coll[k].__self__).__name__
              for k in ("allreduce", "bcast", "barrier", "reduce")}
    out("owners", owners)
    for k in (3, 1000, 200000, 700000):       # the last above the 2 MB slot
        x = rng.standard_normal((n, k)).astype(np.float32)
        out(f"allreduce {k}", digest(w.allreduce(x[r])))
        out(f"allreduce max {k}", digest(w.allreduce(x[r], m.MAX)))
        out(f"bcast {k}", digest(w.bcast(x[1] if r == 1 else x[r] * 0, 1)))
        red = w.reduce(x[r], m.SUM, n - 1)
        out(f"reduce {k}", digest(red) if r == n - 1 else red)
        w.barrier()
    for i in range(5):
        w.barrier()
    out("after barriers", digest(w.allreduce(np.arange(5.0) + r)))
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
    w.recv(np.zeros(1, np.int32), source=1, tag=2)
    for i in range(20):     # 5 MB of eager sends: more than the 4 MB ring
        w.send(np.full(1 << 16, i, np.float32), dest=1, tag=1)
    print("sent", flush=True)
    m.finalize()
else:
    # ready only once init is behind it: no progress of this rank drains
    # the ring after the ack
    w.send(np.zeros(1, np.int32), dest=0, tag=2)
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


@pytest.mark.parametrize("mode,n,native", [
    ("default", 2, "on"), ("default", 3, "on"), ("default", 4, "on"),
    ("han", 4, "on"), ("han", 5, "on"), ("interpose", 4, "on"),
    ("default", 4, "off"), ("han", 4, "off")])
def test_default_selection_matches_the_reference(default_worker, mode, n,
                                                 native):
    """Both packages under default selection: the same component owns
    every slot and every line of the job is equal.  With the native core
    on in both (``native="on"``), coll/sm owns the single-node comms'
    allreduce, bcast, reduce and barrier (tuned the rest, libnbc the
    ``i*``, basic scan); across ``--fake-nodes 2`` (2+2 and 3+2 ranks) han
    owns the world, with btl/tcp between the nodes and btl/sm within them.
    With ``OTPU_NATIVE_DISABLE`` in both (``native="off"``) the pure-Python
    lanes carry the same jobs and coll/tuned takes coll/sm's slots."""
    extra = {"han": ["--fake-nodes", "2"],
             "interpose": ["--mca", "coll_adapt_priority", "60",
                           "--mca", "coll_adapt_segsize", "4k",
                           "--mca", "coll_sync_barrier_after", "3",
                           "--mca", "coll_demo_priority", "100",
                           "--mca", "coll_base_verbose", "1"]}.get(mode, [])
    env = {"OTPU_NATIVE_DISABLE": "1"} if native == "off" else {}
    got = _tpurun("torch", n, [*extra, sys.executable, str(default_worker),
                               "torch", mode], timeout=150, extra_env=env)
    want = _tpurun("jax", n, [*extra, sys.executable, str(default_worker),
                              "jax", mode], timeout=150, extra_env=env)
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
    elif native == "on":
        assert '"allreduce": "SmCollModule"' in owners
        assert '"barrier": "SmCollModule"' in owners
        assert '"allgather": "TunedModule"' in owners
    else:
        assert '"allreduce": "TunedModule"' in owners
    assert '"iallgather": "LibnbcModule"' in owners
    assert '"scan": "BasicCollModule"' in owners


@pytest.fixture(scope="module")
def transport_worker(tmp_path_factory):
    path = tmp_path_factory.mktemp("mp") / "transport.py"
    path.write_text(TRANSPORT)
    return path


def _both(worker, n, args, mode, native="on"):
    """Run the TRANSPORT worker under both packages' tpurun; per-rank
    lines, equal between the packages."""
    env = {"OTPU_NATIVE_DISABLE": "1"} if native == "off" else {}
    got = _tpurun("torch", n, [*args, sys.executable, str(worker), "torch",
                               mode], timeout=120, extra_env=env)
    want = _tpurun("jax", n, [*args, sys.executable, str(worker), "jax",
                              mode], timeout=120, extra_env=env)
    assert got.returncode == 0, got.stdout + got.stderr
    assert want.returncode == 0, want.stdout + want.stderr
    got_l, want_l = _lines(got.stdout), _lines(want.stdout)
    assert sorted(got_l) == list(range(n))
    for rank in range(n):
        assert got_l[rank] == want_l[rank], rank
    return got_l


@pytest.mark.parametrize("native", ["on", "off"])
def test_tcp_pingpong_matches_the_reference(transport_worker, native):
    """``-n 2 --mca btl tcp,self``: btl/tcp carries an 8 B (eager) and a
    4 MB (rendezvous, 128 KB fragments) ping-pong, through the native
    reactor or the selector lane, byte for byte as the reference's."""
    lines = _both(transport_worker, 2, ["--mca", "btl", "tcp,self"],
                  "pingpong", native)
    assert lines[0][0] == '["eps", {"1": "tcp"}]'
    assert all(x.endswith("true]]") for x in lines[1][1:])


def test_the_transport_matrix_across_fake_nodes(transport_worker):
    """``-n 4 --fake-nodes 2``: btl/sm within a node, btl/tcp between
    them, as the reference's (the repaired node key of btl/sm)."""
    lines = _both(transport_worker, 4, ["--fake-nodes", "2"], "pingpong")
    assert lines[0][0] == '["eps", {"1": "sm", "2": "tcp", "3": "tcp"}]'
    assert lines[3][0] == '["eps", {"0": "tcp", "1": "tcp", "2": "sm"}]'


def test_quant_wire_allreduce_matches_the_reference(transport_worker):
    """``--fake-nodes 2 --mca otpu_coll_quant_wire 1``: a 4 MB float32
    allreduce whose traffic between the nodes goes int8-encoded over
    btl/tcp; the result, its error and ``quant.wire_stats()`` (original and
    encoded bytes) are the reference's on every rank, and the result is
    one per node in both (pinned below)."""
    lines = _both(transport_worker, 4, ["--fake-nodes", "2", "--mca",
                                        "otpu_coll_quant_wire", "1"],
                  "quantwire")
    import json

    # a divergence of both packages from MPI: each han leader adds its own
    # exact part to the other leader's decoded one, so the result is one
    # per node: equal within a node, different between the nodes
    digests = [json.loads(lines[rank][1])[1][0] for rank in range(4)]
    assert digests[0] == digests[1] and digests[2] == digests[3]
    assert digests[0] != digests[2]
    for rank in range(4):
        stats = json.loads(lines[rank][2])[1]
        err = json.loads(lines[rank][1])[1][1]
        assert err <= 1 / 127
        if stats["enc"]:
            assert stats["orig"] / stats["enc"] > 3.5
    assert any(json.loads(lines[r][2])[1]["enc"] for r in range(4))


def test_a_large_stream_stripes_like_the_reference(transport_worker):
    """A 16 MB message between two ranks of one node.  By default both
    packages pull it by RGET from btl/sm's mapped segment: no fragment
    takes tcp, ``rget_msgs`` 1 and ``striped_msgs`` 0 on the sender.  With
    RGET off (``pml_ob1_rget_limit 0``) its rendezvous stream stripes its
    FRAGs over btl/sm and btl/tcp (bml/r2's rails, finish-time greedy by
    bandwidth): the same number of fragments takes tcp in both packages,
    and ``striped_msgs`` is 1 in both."""
    lines = _both(transport_worker, 2, [], "stripe")
    assert lines[0][:3] == ['["eps", {"1": "sm"}]', '["tcp frags", 0]',
                            '["rget, striped", [1, 0]]']
    assert lines[1][1].endswith("true]]")
    lines = _both(transport_worker, 2, ["--mca", "pml_ob1_rget_limit", "0"],
                  "stripe")
    assert lines[0][0] == '["eps", {"1": "sm"}]'
    assert lines[0][1].startswith('["tcp frags", ') and \
        lines[0][1] != '["tcp frags", 0]'
    assert lines[0][2] == '["rget, striped", [0, 1]]'
    assert lines[1][1].endswith("true]]")


@pytest.mark.parametrize("n", [3, 4])
def test_coll_sm_matches_the_reference(transport_worker, n):
    """coll/sm owns a single-node comm's allreduce, bcast, reduce and
    barrier with the native core; a payload above its 2 MB slot falls
    through to coll/tuned; every result is the reference's."""
    lines = _both(transport_worker, n, [], "smcoll")
    assert lines[0][1] == ('["owners", {"allreduce": "SmCollModule", '
                           '"bcast": "SmCollModule", "barrier": '
                           '"SmCollModule", "reduce": "SmCollModule"}]')


def test_finalize_drains_queued_sends(tmp_path):
    """A send completes once its frames are packed; over btl/sm the last
    of an 8 MB stream (RGET off: the stream rung) can still wait for ring
    space when the sender reaches finalize, and the finalize fence stops
    the sender's progress.
    The port drains the btls before that fence, so the job ends without
    waiting out the fence's 10 s timeout.  (The reference fences first and
    relies on its native reactor's progress thread, or on RGET, to move
    those frames; ROADMAP C.)"""
    script = tmp_path / "drain.py"
    script.write_text(DRAIN)
    r = _tpurun("torch", 2, ["--mca", "pml_ob1_rget_limit", "0",
                             sys.executable, str(script)], timeout=90)
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
