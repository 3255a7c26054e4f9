"""The port's monitoring (``runtime/monitoring.py``: pml/monitoring,
coll/monitoring, osc/monitoring, the finalize publish and the launcher's
merge), held against the JAX package's.

A buffer's bytes: the port reads a tensor's ``nbytes`` attribute, with no
host copy; the reference's ``np.asarray(x).nbytes`` of a ``jax.Array``
gives the same number (its host copy's size), and both take numpy's count
for buffers without the attribute.  In the device world one program of
``allreduce_array``, ``bcast_array``, a persistent handle, a window's put,
get, accumulate and compare-and-swap and point-to-point sends of numpy and
device buffers records the same p2p matrix and coll and osc counters.  With
monitoring off nothing is wrapped.  The coll wrapper carries ``__self__``
under trace's wrapper.  The summaries are the reference's on fixed
payloads, and one ``tpurun -n 2`` job a package publishes its matrices at
finalize and the launcher prints the same job-wide table.  A card tensor's
bytes are checked on the card (``cuda``), with no host copy.
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
from ompi_tpu.base.var import registry as jreg
from ompi_tpu.runtime import monitoring as jmon
from ompi_tpu.runtime import trace as jtrace
from ompi_tpu_torch.base.var import registry as treg
from ompi_tpu_torch.runtime import monitoring as tmon
from ompi_tpu_torch.runtime import trace as ttrace

REPO = Path(__file__).resolve().parent.parent
MON = {"jax": jmon, "torch": tmon}
REG = {"jax": jreg, "torch": treg}
PKG = {"jax": ompi_tpu, "torch": ompi_tpu_torch}


def _both(fn):
    got = {name: fn(name) for name in MON}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _device(name, host):
    if name == "torch":
        return torch.from_numpy(np.ascontiguousarray(host))
    import jax.numpy as jnp

    return jnp.asarray(host)


@pytest.fixture
def monitoring():
    for name in MON:
        REG[name].set("otpu_monitoring_enable", True)
        MON[name].reset()
    yield
    for name in MON:
        REG[name].set("otpu_monitoring_enable", False)
        MON[name].reset()


def test_tables_are_the_references():
    for attr in ("_COLL_BYTES_ARG", "_KV_KEY"):
        assert getattr(tmon, attr) == getattr(jmon, attr), attr
    assert tmon._enable_var.name == jmon._enable_var.name
    assert tmon._dump_var.name == jmon._dump_var.name


@pytest.mark.parametrize("host", [
    np.arange(10, dtype=np.float32), np.zeros((3, 5), np.int8),
    np.ones((2, 2, 2), np.int32)], ids=["f32", "i8", "i32"])
def test_tensor_bytes_are_the_references(host):
    """The port's count of a tensor equals the reference's host-copy count
    of the same jax.Array, with no conversion."""
    got = tmon.nbytes_of(torch.from_numpy(host))
    want = int(np.asarray(_device("jax", host)).nbytes)
    assert got == want == host.nbytes


@pytest.mark.parametrize("buf", [[1.0, 2.0, 3.0], 7, b"abcde", (1, 2)],
                         ids=["list", "int", "bytes", "tuple"])
def test_buffers_without_nbytes_take_numpys_count(buf):
    assert tmon.nbytes_of(buf) == int(np.asarray(buf).nbytes)


@pytest.fixture(scope="module")
def worlds():
    from ompi_tpu.runtime import init as jrt
    from ompi_tpu_torch.runtime import init as trt

    jrt.reset_for_testing()
    trt.reset_for_testing()
    jw = ompi_tpu.init()
    if jw.size != 8:
        pytest.skip("needs 8 virtual devices")
    yield {"jax": jw, "torch": ompi_tpu_torch.init(device="cpu")}
    jrt.reset_for_testing()
    trt.reset_for_testing()


def _program(name, w):
    rng = np.random.default_rng(31)
    x = _device(name, rng.integers(-4, 4, (8, 128)).astype(np.float32))
    w.allreduce_array(x)
    w.bcast_array(x, root=2)
    h = w.allreduce_array_init(x)
    h(x)
    win = PKG[name].Win.create(w, size=16, dtype=np.float32, device=True)
    win.fence()
    win.put(np.arange(5, dtype=np.float32), 1, offset=2)
    win.get(4, 1, offset=0)
    win.accumulate(np.ones(3, np.float32), 6, offset=1)
    win.compare_and_swap(np.float32(1.0), np.float32(0.0), 6, offset=0)
    win.fence()
    win.free()
    w.as_rank(0).send(np.arange(6.0), dest=3, tag=1)
    w.as_rank(3).recv(np.zeros(6), source=0, tag=1)
    w.as_rank(5).send(_device(name, np.arange(9, dtype=np.float32)),
                      dest=2, tag=2)
    w.as_rank(2).recv(np.zeros(9, np.float32), source=5, tag=2)


def test_device_world_counters_match(worlds, monitoring):
    from ompi_tpu.runtime import init as jrt
    from ompi_tpu_torch.runtime import init as trt

    # pml/monitoring interposes at init: re-init both worlds with it on
    jrt.reset_for_testing()
    trt.reset_for_testing()
    fresh = {"jax": ompi_tpu.init(), "torch": ompi_tpu_torch.init(
        device="cpu")}
    try:
        def run(name):
            w = fresh[name]
            _program(name, w)
            msgs, byts = MON[name].p2p_matrix(8)
            return (type(w.pml).__name__, msgs.tolist(), byts.tolist(),
                    MON[name].coll_counters(), MON[name].osc_counters(),
                    MON[name].summary())

        got = _both(run)
        assert got[0] == "MonitoringPml"
        assert got[2][5][2] == 36 and got[2][0][3] == 48
        assert got[3]["allreduce_array"] == (1, 8 * 128 * 4)
        assert got[4]["put"] == (1, 20) and got[4]["get"] == (1, 16)
    finally:
        for name in MON:
            REG[name].set("otpu_monitoring_enable", False)
        jrt.reset_for_testing()
        trt.reset_for_testing()
        worlds["jax"] = ompi_tpu.init()
        worlds["torch"] = ompi_tpu_torch.init(device="cpu")


def test_disabled_monitoring_wraps_nothing(worlds):
    def run(name):
        class Comm:
            cid = 1

            def __init__(self):
                self.c_coll = {"allreduce": lambda c, x: x}

        c = Comm()
        slot = c.c_coll["allreduce"]
        MON[name].wrap_coll_table(c)
        pml = object()
        return (c.c_coll["allreduce"] is slot,
                MON[name].maybe_wrap_pml(pml) is pml,
                type(worlds[name].pml).__name__)

    assert _both(run) == (True, True, "Ob1Pml")


def test_wrappers_carry_the_slots_markers(monitoring):
    trace = {"jax": jtrace, "torch": ttrace}

    def run(name):
        class Module:
            def allreduce(self, comm, x):
                return x + 1

        class Comm:
            cid = 3

            def __init__(self):
                self.c_coll = {}

        m, c = Module(), Comm()
        c.c_coll["allreduce"] = m.allreduce
        MON[name].wrap_coll_table(c)
        trace[name].wrap_coll_table(c)
        outer = c.c_coll["allreduce"]
        out = outer(c, np.ones(4, np.float32))
        return (outer.__self__ is m, outer.__monitored__, outer.__traced__,
                outer.__wrapped__.__self__ is m, out.tolist(),
                MON[name].coll_counters())

    assert _both(run) == (True, True, True, True, [2.0] * 4,
                          {"allreduce": (1, 16)})


def _payloads(seed):
    rng = np.random.default_rng(seed)
    out = []
    for rank in range(3):
        out.append({
            "rank": rank,
            "p2p": [[rank, int(d), int(rng.integers(1, 9)),
                     int(rng.integers(0, 1 << 20))]
                    for d in range(3) if d != rank],
            "coll": {"allreduce": [int(rng.integers(1, 5)),
                                   int(rng.integers(0, 9999))],
                     "bcast": [1, 64]},
            "osc": {}})
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_merged_summary_matches(seed):
    payloads = _payloads(seed)
    text = _both(lambda name: MON[name].merged_summary(payloads, 3))
    assert text.startswith("monitoring: job-wide p2p matrix (3 ranks, "
                           "3 reporting")


def test_publish_payload_matches(monitoring):
    class Client:
        def __init__(self):
            self.put_args = None

        def put(self, rank, key, value):
            self.put_args = (rank, key, value)

    class Rte:
        my_world_rank = 2

        def __init__(self):
            self.client = Client()

    def run(name):
        m = MON[name]
        m.record_p2p(2, 0, 100)
        m.record_p2p(2, 0, 28)
        m.record_coll("allreduce", 64)
        m.record_osc("put", 8)
        rte = Rte()
        m.finalize_publish(rte)
        return rte.client.put_args

    rank, key, value = _both(run)
    assert (rank, key) == (2, "otpu_monitoring") and '"p2p"' in value


JOB = r'''
import sys
import numpy as np

pkg = sys.argv[1]
if pkg == "torch":
    import ompi_tpu_torch as m
    w = m.init(device="cpu")
else:
    import ompi_tpu as m
    w = m.init()
r = w.rank
if r == 0:
    w.send(np.arange(10.0), dest=1, tag=1)
    w.send(np.arange(5000.0), dest=1, tag=2)
else:
    w.recv(np.zeros(10), source=0, tag=1)
    w.recv(np.zeros(5000), source=0, tag=2)
w.allreduce(np.ones(16))
w.bcast(np.ones(4), root=0)
m.finalize()
'''


def _tpurun(pkg, args, timeout=240):
    env = dict(os.environ)
    env.pop("OTPU_RANK", None)
    env.pop("OTPU_NPROCS", None)
    launcher = "ompi_tpu_torch.tools.tpurun" if pkg == "torch" \
        else "ompi_tpu.tools.tpurun"
    p = subprocess.Popen(
        [sys.executable, "-m", launcher, "-n", "2", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=env, start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    return subprocess.CompletedProcess(p.args, p.returncode, out, err)


def _merged(stderr: str) -> list:
    lines = stderr.splitlines()
    start = next(i for i, x in enumerate(lines)
                 if x.startswith("tpurun: monitoring: job-wide"))
    out = [lines[start]]
    for x in lines[start + 1:]:
        if not x.startswith("  "):
            break
        out.append(x)
    return out


def test_launcher_merges_the_job_matrix(tmp_path):
    script = tmp_path / "job.py"
    script.write_text(JOB)
    got = {}
    for pkg in ("torch", "jax"):
        proc = _tpurun(pkg, ["--mca", "otpu_monitoring_enable", "1",
                             sys.executable, str(script), pkg])
        assert proc.returncode == 0, proc.stdout + proc.stderr
        got[pkg] = _merged(proc.stderr)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == ("tpurun: monitoring: job-wide p2p matrix (2 "
                               "ranks, 2 reporting; src -> dst: msgs/bytes)")
    # the two sends' 40080 bytes and the collectives' own messages
    assert "  0 -> 1: 3 msgs, 40088 bytes" in got["torch"]
    assert "  coll allreduce: 2 calls, 256 bytes" in got["torch"]


@pytest.mark.cuda
def test_card_tensor_bytes_without_a_host_copy(monitoring):
    """A send of a card tensor with monitoring on records the tensor's
    bytes (the reference's coll wrapper would swallow a failed conversion
    and record 0; its pml wrapper would raise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.arange(1000, dtype=torch.float32, device="cuda")
    assert tmon.nbytes_of(x) == 4000

    class Comm:
        cid = 5

        def __init__(self):
            self.c_coll = {"allreduce_array": lambda c, t: t}

    c = Comm()
    tmon.wrap_coll_table(c)
    c.c_coll["allreduce_array"](c, x.reshape(8, 125))
    assert tmon.coll_counters()["allreduce_array"] == (1, 4000)
