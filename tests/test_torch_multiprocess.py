"""The port's multi-process world on the CPU lane, held against the JAX
package's: the same jobs launched by each package's ``tpurun`` (the
coordination service, ProcRte, btl/self + btl/sm, pml/ob1, coll/basic),
their per-rank outputs compared line for line.  The reference runs with
``--mca coll basic,self_coll``, the components the port has; its ranks
keep their own btls (its btl/sm pulls messages above 512 KB one-sidedly,
the port's streams them: the same bytes).  The port's ranks bind
``--device cpu``.

Jobs: the ring (``tpurun -n 4`` of each package's ``ring`` example); the
host collectives and ``split``/``dup``/``create_group`` under ``-n 4``; a
rendezvous message of 2 MB under ``-n 2``; tensors (the reference's
``jax.Array``) as send buffers of point-to-point and of coll/basic's
allreduce; and the failure teardown (a rank that exits 3 brings the job
down with 3).  Every subprocess has its own ``timeout=``.
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
    got = _tpurun("torch", n, [sys.executable, str(worker), "torch", mode],
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
