"""ob1's RGET rung and btl/sm's one-sided triple, held against the JAX
package's (``tests/test_rget.py``'s rungs).

Each job runs under both packages' ``tpurun -n 2``, and every rank's lines
are equal between them, ``rget_msgs`` included:

- btl/sm (one node): a 3 MB float64 message and a vector-typed one (RGET
  exposes the packed temporary) go by RGET, the receiver pulling from the
  sender's mapped segment; so does a 1 MB tensor (the reference's
  ``jax.Array``), staged to the host first;
- with ``--mca pml_ob1_rget_limit 0`` the same messages go by RNDV/FRAG;
- across ``--fake-nodes 2`` btl/tcp carries them: by its FRAG stream by
  default (RGET's pull emulation is opt-in), and by RGET's emulated pull
  with ``--mca pml_ob1_rget_emulate 1``;
- btl/sm's raw ``prepare_src``/``get``/``put``/``release_src`` between the
  ranks, and (the port alone) from several threads of one process at
  once, as osc/pt2pt's agent and the application thread send.

The port's ranks bind ``--device cpu``.  Every subprocess has its own
``timeout=``.
"""
import os
import signal
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

WORKER = r'''
import hashlib, json, pickle, sys
import numpy as np

pkg, mode = sys.argv[1], sys.argv[2]
if pkg == "torch":
    import torch
    import ompi_tpu_torch as m
    from ompi_tpu_torch.datatype import core
    from ompi_tpu_torch.runtime import spc
    w = m.init(device="cpu")
    tensor = torch.from_numpy
else:
    import jax.numpy as jnp
    import ompi_tpu as m
    from ompi_tpu.datatype import core
    from ompi_tpu.runtime import spc
    w = m.init()
    tensor = jnp.asarray
r = w.rank


def out(key, value):
    print(json.dumps([key, value]), flush=True)


def digest(a):
    a = np.ascontiguousarray(a)
    return [str(a.dtype), list(a.shape),
            hashlib.sha256(a.tobytes()).hexdigest()[:32]]


peer = 1 - r
out("eps", w.pml.bml.endpoint(peer).btl.name)
if mode == "large":
    n = (3 << 20) // 8                     # 3 MB of float64
    nblk = n // 4
    dt = core.vector(nblk, 2, 4, core.FLOAT64)   # 2-of-4 stride pattern
    t = np.random.default_rng(5).standard_normal(1 << 18).astype(np.float32)
    if r == 0:
        w.send(np.arange(n, dtype=np.float64), dest=1, tag=3)
        # a derived type: pack_borrow cannot lend a view, so RGET exposes
        # the packed temporary
        w.send((np.arange(4 * nblk, dtype=np.float64), 1, dt), dest=1, tag=4)
        w.send(tensor(t), dest=1, tag=5)     # 1 MB tensor, staged
    else:
        x = np.empty(n, np.float64)
        st = w.recv(x, source=0, tag=3)
        out("contiguous", [st.source, st._nbytes, digest(x),
                           bool(np.array_equal(x, np.arange(n)))])
        y = np.empty(2 * nblk, np.float64)
        w.recv(y, source=0, tag=4)
        out("vector", [digest(y), y[:4].tolist(), float(y[-1])])
        z = np.empty_like(t)
        w.recv(z, source=0, tag=5)
        out("tensor", [digest(z), z.tobytes() == t.tobytes()])
    out("rget_msgs", spc.read("rget_msgs"))
else:
    # btl/sm's raw one-sided triple: expose, swap keys over p2p, pull,
    # overwrite the peer's region, pull again
    ep = w.pml.bml.endpoint(peer)
    out("rdma", bool(ep.btl.rdma))
    src = np.arange(1024, dtype=np.uint8)
    key = ep.btl.prepare_src(ep, src)
    out("key", [key["btl"], key["size"], key["nbytes"]])
    w.send_obj(key, dest=peer, tag=9)
    peer_key = w.recv_obj(source=peer, tag=9)
    dst = np.zeros(1024, np.uint8)
    ep.btl.get(ep, dst, peer_key)
    out("get", bool(np.array_equal(dst, src)))
    ep.btl.put(ep, dst[::-1].copy(), peer_key)
    w.barrier()
    chk = np.zeros(1024, np.uint8)
    ep.btl.get(ep, chk, peer_key)
    out("put", [int(chk[0]), int(chk[-1])])
    w.barrier()
    ep.btl.release_src(key)
    out("released", sorted(len(v) for v in ep.btl._rma_pool.values()))
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
    path = tmp_path_factory.mktemp("rget") / "worker.py"
    path.write_text(WORKER)
    return path


def _both(worker, mode, args):
    got = _tpurun("torch", 2, [*args, sys.executable, str(worker), "torch",
                               mode], timeout=120)
    want = _tpurun("jax", 2, [*args, sys.executable, str(worker), "jax",
                              mode], timeout=120)
    assert got.returncode == 0, got.stdout + got.stderr
    assert want.returncode == 0, want.stdout + want.stderr
    got_l, want_l = _lines(got.stdout), _lines(want.stdout)
    assert sorted(got_l) == [0, 1]
    for rank in range(2):
        assert got_l[rank] == want_l[rank], rank
    return got_l


#: (extra tpurun arguments, the btl, the sender's rget_msgs)
RUNGS = {
    "sm_rget": ([], "sm", 3),
    "sm_rget_off": (["--mca", "pml_ob1_rget_limit", "0"], "sm", 0),
    "tcp_frag": (["--fake-nodes", "2"], "tcp", 0),
    "tcp_emulated_pull": (["--fake-nodes", "2", "--mca",
                           "pml_ob1_rget_emulate", "1"], "tcp", 3),
}


@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_large_messages_take_the_reference_rung(worker, rung):
    """Three messages above the 512 KB ``rget_limit``: the same bytes, and
    the same count of RGET messages on the sender, in both packages."""
    args, btl, rgets = RUNGS[rung]
    lines = _both(worker, "large", args)
    assert lines[0][0] == f'["eps", "{btl}"]'
    assert lines[0][-1] == f'["rget_msgs", {rgets}]'
    assert lines[1][-1] == '["rget_msgs", 0]'
    assert lines[1][1].endswith("true]]") and lines[1][3].endswith("true]]")


def test_btl_sm_one_sided_surface(worker):
    """prepare_src/get/put/release_src between two ranks of one node: the
    key's pow2 size class (64 KB floor), the pulled and overwritten bytes
    and the pooled segment after release are the reference's."""
    lines = _both(worker, "surface", [])
    assert lines[0][:6] == ['["eps", "sm"]', '["rdma", true]',
                            '["key", ["sm", 65536, 1024]]', '["get", true]',
                            '["put", [255, 0]]', '["released", [1]]']


def test_btl_sm_exposes_from_several_threads(monkeypatch):
    """prepare_src from eight threads at once, all 80 segments held at one
    time before any is released: every segment is its sender's alone (a
    name of its own, its own bytes), and release and close unlink them
    all.  The
    name's pid lookup sleeps a millisecond here, so the threads interleave
    between picking a segment's number and creating it."""
    from ompi_tpu_torch.mca.btl import sm

    def slow_getpid():
        time.sleep(1e-3)
        return os.getpid()

    btl = sm.SmBtl()
    btl._rte = types.SimpleNamespace(my_world_rank=0)
    monkeypatch.setattr(sm, "os", types.SimpleNamespace(getpid=slow_getpid))
    errors, names = [], []
    held = threading.Barrier(8)

    def sender(k):
        src = np.full(600 << 10, k, np.uint8)        # a 1 MB size class
        try:
            keys = [btl.prepare_src(None, src) for _ in range(10)]
            held.wait(timeout=30)       # all 80 segments held at once
            for key in keys:
                names.append(key["seg"])
                seg = np.frombuffer(btl._exposed[key["seg"]].buf, np.uint8,
                                    count=len(src))
                if not np.array_equal(seg, src):
                    raise AssertionError(f"thread {k}: {key['seg']} shared")
                del seg
            for key in keys:
                btl.release_src(key)
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)
            held.abort()

    try:
        threads = [threading.Thread(target=sender, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        btl.close()
    assert errors == []
    assert len(names) == len(set(names)) == 80
    assert all(n.startswith(f"{sm.NAME_PREFIX}_rg_0_") for n in names)
    assert not [n for n in names if os.path.exists(f"/dev/shm/{n}")]
