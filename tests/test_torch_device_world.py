"""The port's multi-process device world on the CPU lane (the reference's
``tests/test_device_world.py``): ``tpurun --device-world --local-devices
4`` boots ``torch.distributed`` (gloo) in every rank through the instance
layer, coll/builtin's cross-process module serves the ``*_array`` slots of
a communicator built by ``Group.from_session_pset`` and
``Comm.create_from_group`` with no ``init()`` anywhere, and the flagship
step runs over the global mesh of 2 × 4 ranks.

* The slots, each rank's inputs rebuilt here from the seed: every result
  equals the fold in rank order that the reference's body computes
  (``acc = fold(g[i], acc)``), bit for bit on integer and dyadic inputs:
  SUM, MAX, MIN, PROD and BAND (the gather-and-fold ops), bcast from the
  other process, allgather, reduce_scatter (SUM and PROD, and its
  ``ERR_BUFFER``), ``device_barrier``.
* A ``create_from_group`` over a subset (ranks 0 and 2 of 3) returns while
  the non-member never calls it, and its slots cross between the two.
* The multi-process step: two steps (parameters carried across) of the
  default spec (dp spans the processes) and of ``dp=1,pp=2,sp=2,tp=2``
  (pp spans them: the pipeline's ``ppermute`` crosses the boundary, in the
  backward too) over 2 × 4 ranks, and of the default spec over 4 × 2 (dp
  and sp span: ring attention's K/V rotation crosses it).  Their losses equal the port's single-process 8-rank
  step's bit for bit (one rank a process on the spanning axis: the
  cross-process sum is the single process's one IEEE addition, and on the
  CPU the 4-rank batched products give the 8-rank ones' bits), and are
  within the parity band of ``tests/test_torch_parallel.py`` (1e-5
  relative) of the JAX package's step over its 8 virtual CPU devices.
  ZeRO-1 (``psum_scatter`` over dp across the processes) is held the same
  way.  The reference's own multi-process job is not re-run here: its
  ``tests/test_device_world.py`` holds it, and it compiles for minutes.
* The layout guard: process blocks that are not contiguous in the leading
  axes raise ``ERR_UNSUPPORTED_OPERATION``, and so does an all-to-all over
  an axis that spans processes (ROADMAP C).
* Re-init in one process reuses the live process group; the dry run's
  multi-process mode prints two ``dryrun ok`` lines.

Every subprocess has its own ``timeout=``.
"""
import json
import math
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

from ompi_tpu_torch.api.errors import MpiError
from ompi_tpu_torch.parallel import dryrun
from ompi_tpu_torch.parallel.mesh import MeshSpec, process_block

REPO = Path(__file__).resolve().parent.parent
SEED = 17


def _tpurun(args, timeout=170):
    env = dict(os.environ)
    for k in ("OTPU_RANK", "OTPU_NPROCS", "OTPU_COORD", "OTPU_DEVICE_WORLD",
              "OTPU_DIST_COORD"):
        env.pop(k, None)
    p = subprocess.Popen(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=env, start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    return subprocess.CompletedProcess(p.args, p.returncode, out, err)


def _records(stdout):
    """{rank: {key: value}} of the ranks' JSON lines."""
    out = {}
    for line in stdout.splitlines():
        head, _, rest = line.partition("] ")
        if head.startswith("[") and rest.startswith("{"):
            out.setdefault(int(head[1:]), {}).update(json.loads(rest))
    return out


def _inputs(rank):
    """A rank's inputs, the same in the job and here."""
    rng = np.random.default_rng([SEED, rank])
    return {
        "f": (rng.integers(-64, 64, (5, 3)) / 4.0).astype(np.float32),
        "i": rng.integers(1, 1 << 12, (7,)).astype(np.int32),
        "p": rng.integers(-3, 4, (6,)).astype(np.int32),
        "rs": (rng.integers(-64, 64, (2, 4)) / 8.0).astype(np.float32),
        "rsp": rng.integers(-2, 3, (2, 3)).astype(np.int64),
    }


SLOTS_JOB = textwrap.dedent('''
    import json, sys
    import numpy as np
    import torch
    import ompi_tpu_torch as m
    from ompi_tpu_torch.api.errhandler import ERRORS_RETURN
    from ompi_tpu_torch.api.errors import MpiError
    from ompi_tpu_torch.mca.coll.builtin import MpCollModule

    SEED = int(sys.argv[1])

    def out(**kv):
        print(json.dumps(kv), flush=True)

    # the sessions model only: init() never runs in this program
    s = m.Session.init(errhandler=ERRORS_RETURN, device="cpu")
    assert not m.initialized()
    g = m.Group.from_session_pset(s, "mpi://WORLD")
    comm = m.Comm.create_from_group(g, "dw-slots")
    slot = comm.c_coll["allreduce_array"]
    while hasattr(slot, "__wrapped__"):
        slot = slot.__wrapped__
    out(module=type(slot.__self__).__name__, size=comm.size,
        booted=bool(comm.rte.device_world_booted),
        global_ranks=comm.rte.global_ranks, local_ranks=comm.rte.local_ranks)
    rng = np.random.default_rng([SEED, comm.rank])
    f = torch.from_numpy((rng.integers(-64, 64, (5, 3)) / 4.0).astype(np.float32))
    i = torch.from_numpy(rng.integers(1, 1 << 12, (7,)).astype(np.int32))
    p = torch.from_numpy(rng.integers(-3, 4, (6,)).astype(np.int32))
    rs = torch.from_numpy((rng.integers(-64, 64, (2, 4)) / 8.0).astype(np.float32))
    rsp = torch.from_numpy(rng.integers(-2, 3, (2, 3)).astype(np.int64))

    def enc(t):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        return [str(t.dtype), list(t.shape), t.numpy().tobytes().hex()]

    out(sum=enc(comm.allreduce_array(f)),
        max=enc(comm.allreduce_array(f, m.MAX)),
        min=enc(comm.allreduce_array(i, m.MIN)),
        prod=enc(comm.allreduce_array(p, m.PROD)),
        band=enc(comm.allreduce_array(i, m.BAND)),
        bcast=enc(comm.bcast_array(f, root=1)),
        allgather=enc(comm.allgather_array(i)),
        rs=enc(comm.reduce_scatter_array(rs)),
        rsp=enc(comm.reduce_scatter_array(rsp, m.PROD)),
        psum_scatter=enc(comm.c_coll["psum_scatter_array"](comm, rs)))
    nz = torch.tensor([-0.0, 1.0]) if comm.rank == 1 else torch.zeros(2)
    out(negzero=enc(comm.bcast_array(nz, root=1)))
    try:
        comm.reduce_scatter_array(torch.zeros(3, 4))
        out(err="none")
    except MpiError as exc:
        out(err=exc.error_class.name)
    comm.c_coll["device_barrier"](comm)
    # a second call of a slot is the cached one: same bits
    out(again=enc(comm.allreduce_array(f)) == enc(comm.allreduce_array(f)))
    comm.free()
    s.finalize()
''')


@pytest.fixture(scope="module")
def slots_job(tmp_path_factory):
    path = tmp_path_factory.mktemp("dw") / "slots.py"
    path.write_text(SLOTS_JOB)
    r = _tpurun(["-n", "2", "--device-world", "--local-devices", "4",
                 sys.executable, str(path), str(SEED)])
    assert r.returncode == 0, r.stdout + r.stderr
    rec = _records(r.stdout)
    assert sorted(rec) == [0, 1], r.stdout + r.stderr
    return rec


def _dec(enc):
    dtype, shape, hexed = enc
    np_dtype = {"torch.float32": np.float32, "torch.int32": np.int32,
                "torch.int64": np.int64}[dtype]
    return np.frombuffer(bytes.fromhex(hexed), np_dtype).reshape(shape)


def _fold(parts, fn):
    """The reference's body: ``acc = fold(g[i], acc)`` in rank order."""
    acc = parts[0]
    for g in parts[1:]:
        acc = fn(g, acc)
    return acc


def test_the_job_boots_and_selects_the_cross_process_module(slots_job):
    for rank, rec in slots_job.items():
        assert rec["module"] == "MpCollModule"
        assert rec["size"] == 2 and rec["booted"]
        assert rec["global_ranks"] == list(range(8))
        assert rec["local_ranks"] == list(range(4 * rank, 4 * rank + 4))


SLOT_WANT = {
    "sum": lambda x: _fold([a["f"] for a in x], np.add),
    "max": lambda x: _fold([a["f"] for a in x], np.maximum),
    "min": lambda x: _fold([a["i"] for a in x], np.minimum),
    "prod": lambda x: _fold([a["p"] for a in x], np.multiply),
    "band": lambda x: _fold([a["i"] for a in x], np.bitwise_and),
    "bcast": lambda x: x[1]["f"],
    "allgather": lambda x: np.stack([a["i"] for a in x]),
}


@pytest.mark.parametrize("slot", sorted(SLOT_WANT))
def test_slot_is_the_rank_order_fold(slots_job, slot):
    x = [_inputs(r) for r in range(2)]
    want = SLOT_WANT[slot](x)
    for rec in slots_job.values():
        got = _dec(rec[slot])
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("slot,key,fn", [
    ("rs", "rs", np.add), ("psum_scatter", "rs", np.add),
    ("rsp", "rsp", np.multiply)])
def test_reduce_scatter_returns_this_members_block(slots_job, slot, key, fn):
    full = _fold([_inputs(r)[key] for r in range(2)], fn)
    for rank, rec in slots_job.items():
        got = _dec(rec[slot])
        assert got.shape == (1,) + full.shape[1:]
        assert got.tobytes() == full[rank:rank + 1].tobytes()


def test_reduce_scatter_checks_its_leading_axis(slots_job):
    assert all(rec["err"] == "ERR_BUFFER" for rec in slots_job.values())
    assert all(rec["again"] for rec in slots_job.values())


def test_bcast_negative_zero_divergence_pinned(slots_job):
    """Root's -0.0 arrives as -0.0: the group's broadcast delivers root's
    bytes.  The reference's body masks the other members to zeros and
    psums (``xla.py:835-838``), so its -0.0 + 0.0 arrives as +0.0; the
    port does not copy the sign flip, as for the single-process bcast
    (ROADMAP C)."""
    for rec in slots_job.values():
        got = _dec(rec["negzero"])
        assert np.signbit(got[0]) and got.tolist() == [0.0, 1.0]


SUBSET_JOB = textwrap.dedent('''
    import json, os
    import torch
    import ompi_tpu_torch as m

    s = m.Session.init(device="cpu")
    g = m.Group.from_session_pset(s, "mpi://WORLD")
    me = int(os.environ["OTPU_RANK"])
    if me in (0, 2):
        sub = m.Comm.create_from_group(g.incl([0, 2]), "subset")
        y = sub.allreduce_array(torch.tensor([float(me + 1)]))
        b = sub.bcast_array(torch.tensor([10.0 * me]), root=1)
        print(json.dumps({"member": True, "size": sub.size,
                          "sum": y.tolist(), "bcast": b.tolist(),
                          "module": type(sub.c_coll["allreduce_array"]
                                         .__self__).__name__}), flush=True)
        sub.free()
    else:
        # the non-member never calls create_from_group
        print(json.dumps({"member": False}), flush=True)
    s.finalize()
''')


def test_create_from_group_over_a_subset(tmp_path):
    path = tmp_path / "subset.py"
    path.write_text(SUBSET_JOB)
    r = _tpurun(["-n", "3", "--device-world", "--local-devices", "1",
                 sys.executable, str(path)])
    assert r.returncode == 0, r.stdout + r.stderr
    rec = _records(r.stdout)
    assert rec[1] == {"member": False}
    for rank in (0, 2):
        assert rec[rank] == {"member": True, "size": 2, "sum": [4.0],
                             "bcast": [20.0], "module": "MpCollModule"}


STEP_JOB = textwrap.dedent('''
    import json, sys
    import torch.distributed as dist
    import ompi_tpu_torch as m
    from ompi_tpu_torch.api.errors import MpiError
    from ompi_tpu_torch.base.var import registry
    from ompi_tpu_torch.parallel import dryrun, train  # noqa: F401 (its vars)

    spec = dryrun.parse_spec(sys.argv[1]) if sys.argv[1] else None
    w = m.init(device="cpu")
    procs = (dist.get_world_size(), dist.get_rank())
    for zero1 in (False, True):
        registry.lookup("otpu_parallel_zero1").set(zero1)
        step, (p, x), ms = dryrun.make_step_and_args(
            "cpu", spec, ranks=len(w.rte.global_ranks), procs=procs)
        p2, l1 = step(p, x)
        _, l2 = step(p2, x)
        print(json.dumps({f"loss{int(zero1)}": [float(l1), float(l2)],
                          "mesh": ms.sizes()}), flush=True)
    registry.lookup("otpu_parallel_zero1").set(False)
    # tp spanning the processes: the MoE block's all-to-all refuses
    step, (p, x), _ = dryrun.make_step_and_args(
        "cpu", dryrun.parse_spec("tp=8"), ranks=8, procs=procs)
    try:
        step(p, x)
        print(json.dumps({"tp_spans": "ran"}), flush=True)
    except MpiError as exc:
        print(json.dumps({"tp_spans": exc.error_class.name}), flush=True)
    m.finalize()
''')

#: (processes, ranks a process, spec): dp spans 2 processes; pp spans
#: them; dp and sp span 4 (sp's ring attention crosses the boundary)
STEP_SPECS = {"default": (2, 4, ""), "pp2": (2, 4, "dp=1,pp=2,sp=2,tp=2"),
              "default_4procs": (4, 2, "")}


@pytest.fixture(scope="module")
def step_jobs(tmp_path_factory):
    path = tmp_path_factory.mktemp("dwstep") / "step.py"
    path.write_text(STEP_JOB)
    out = {}
    for name, (n, k, text) in STEP_SPECS.items():
        r = _tpurun(["-n", str(n), "--device-world", "--local-devices",
                     str(k), sys.executable, str(path), text])
        assert r.returncode == 0, r.stdout + r.stderr
        out[name] = _records(r.stdout)
    return out


def _single_process(text, zero1):
    from ompi_tpu_torch.base.var import registry
    from ompi_tpu_torch.parallel import train  # noqa: F401 (its vars)

    var = registry.lookup("otpu_parallel_zero1")
    old = bool(var.value)
    var.set(zero1)
    try:
        step, (p, x), _ = dryrun.make_step_and_args(
            "cpu", dryrun.parse_spec(text) if text else None, ranks=8)
        p2, l1 = step(p, x)
        _, l2 = step(p2, x)
    finally:
        var.set(old)
    return [float(l1), float(l2)]


def _jax_steps(text, zero1):
    from ompi_tpu.base.var import registry as jreg
    from ompi_tpu.parallel import dryrun as jdry
    from ompi_tpu.parallel import train as jtrain  # noqa: F401 (its vars)

    var = jreg.lookup("otpu_parallel_zero1")
    old = bool(var.value)
    var.set(zero1)
    try:
        step, (p, x), _ = jdry.make_step_and_args(
            jax.devices()[:8], jdry.parse_spec(text) if text else None)
        p2, l1 = step(p, x)
        _, l2 = step(p2, x)
    finally:
        var.set(old)
    return [float(l1), float(l2)]


@pytest.mark.parametrize("zero1", [False, True], ids=["sgd", "zero1"])
@pytest.mark.parametrize("spec", sorted(STEP_SPECS))
def test_mp_step_matches_the_single_process_step(step_jobs, spec, zero1):
    key = f"loss{int(zero1)}"
    rec = step_jobs[spec]
    n, _, text = STEP_SPECS[spec]
    want = _single_process(text, zero1)
    assert sorted(rec) == list(range(n))
    for rank in range(n):
        got = rec[rank][key]
        assert all(math.isfinite(v) for v in got)
        assert got[1] < got[0], got            # the step descends
        assert got == want, (rank, got, want)  # bit for bit


@pytest.mark.parametrize("zero1", [False, True], ids=["sgd", "zero1"])
@pytest.mark.parametrize("spec", sorted(STEP_SPECS))
def test_mp_step_matches_the_jax_step(step_jobs, spec, zero1):
    want = _jax_steps(STEP_SPECS[spec][2], zero1)
    got = step_jobs[spec][0][f"loss{int(zero1)}"]
    for g, j in zip(got, want):
        assert abs(g - j) <= 1e-5 * abs(j), (got, want)


def test_spanning_all_to_all_refuses_divergence_pinned(step_jobs):
    """With tp spanning the processes the MoE block's all-to-all raises
    ``ERR_UNSUPPORTED_OPERATION`` in every rank, where the reference's
    global mesh runs it (ROADMAP C)."""
    for name, (n, _, _) in STEP_SPECS.items():
        assert [step_jobs[name][r]["tp_spans"] for r in range(n)] == \
            ["ERR_UNSUPPORTED_OPERATION"] * n


@pytest.mark.parametrize("sizes,nprocs", [
    ({"sp": 3, "tp": 2}, 2),     # 3 ranks a process: no box
    ({"dp": 2, "sp": 2, "tp": 2}, 3),
    ({"pp": 2, "sp": 3, "tp": 2}, 4)])
def test_layout_guard_divergence_pinned(sizes, nprocs):
    """The reference lays any device list out over the mesh; the port
    needs each process's ranks to be a box of whole trailing axes, and
    raises otherwise."""
    with pytest.raises(MpiError) as ei:
        process_block(MeshSpec(**sizes), nprocs, 0, device="cpu")
    assert ei.value.error_class.name == "ERR_UNSUPPORTED_OPERATION"


@pytest.mark.parametrize("sizes,nprocs,proc,origin,block", [
    ({"dp": 2, "sp": 2, "tp": 2}, 2, 1, (1, 0, 0, 0), (1, 1, 2, 2)),
    ({"pp": 2, "sp": 2, "tp": 2}, 2, 1, (0, 1, 0, 0), (1, 1, 2, 2)),
    ({"dp": 2, "sp": 2, "tp": 2}, 4, 3, (1, 0, 1, 0), (1, 1, 1, 2))])
def test_process_block_is_process_major(sizes, nprocs, proc, origin, block):
    mesh, _ = process_block(MeshSpec(**sizes), nprocs, proc, device="cpu")
    assert mesh.origin == origin and mesh.local_dims == block
    k = math.prod(block)
    # the block's ranks are the row-major ranks proc*k .. proc*k + k - 1
    flat = [int(np.ravel_multi_index(c, mesh.dims)) for c in mesh.ranks()]
    assert flat == list(range(proc * k, proc * k + k))


REINIT_JOB = textwrap.dedent('''
    import torch
    import torch.distributed as dist
    import ompi_tpu_torch as m

    w = m.init(device="cpu")
    assert w.rte.device_world_booted
    group = w.rte.process_group
    y = w.allreduce_array(torch.ones(1))
    assert float(y[0]) == 2.0, y
    m.finalize()
    w = m.init(device="cpu")          # second boot, the same group
    assert w.rte.device_world_booted and w.rte.process_group is group
    assert dist.is_initialized()
    y = w.allreduce_array(torch.full((1,), 2.0))
    assert float(y[0]) == 4.0, y
    print(f"DWREINIT OK {w.rank}", flush=True)
    m.finalize()
''')


def test_device_world_reinit_same_process(tmp_path):
    path = tmp_path / "reinit.py"
    path.write_text(REINIT_JOB)
    r = _tpurun(["-n", "2", "--device-world", "--local-devices", "4",
                 sys.executable, str(path)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("DWREINIT OK") == 2, r.stdout + r.stderr


def test_dryrun_multichip_two_process_mode(capfd):
    dryrun.dryrun_multichip(8, 2, device="cpu", timeout=170)
    out = capfd.readouterr().out
    assert out.count("dryrun ok") == 2, out
    assert "mesh={'dp': 2, 'pp': 1, 'sp': 2, 'tp': 2}" in out


def test_no_rendezvous_fails_loudly(tmp_path):
    """OTPU_DEVICE_WORLD with no address (no override, no coordination
    client to read the key from): the boot raises, naming the launcher's
    flag."""
    from ompi_tpu_torch import instance

    class Rte:
        is_device_world = False
        job = "0"
        client = None

    inst = instance.Instance()
    inst.rte = Rte()
    old = {k: os.environ.get(k) for k in ("OTPU_DEVICE_WORLD",
                                          "OTPU_DIST_COORD")}
    os.environ["OTPU_DEVICE_WORLD"] = "1"
    os.environ.pop("OTPU_DIST_COORD", None)
    try:
        with pytest.raises(RuntimeError, match="no rendezvous address"):
            inst._boot_device_world()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
