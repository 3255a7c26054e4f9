"""API completeness of the port: the twin of
``tests/test_api_completeness.py`` on ``ompi_tpu_torch`` (the remaining
reference bindings, ``ompi/mpi/c``: spawn_multiple, intercomm_create,
comm_join, reduce_scatter_block, nonblocking v-variants, neighbor v/w
variants, persistent buffered/ready sends, imrecv, MPI_Win_test,
cart/graph_map, type_match_size, MPI_Pcontrol, MPI_Register_datarep and
external32 file views, sessions, partitions, MPI_T), the same checks on the
CPU lane (``device="cpu"`` in the device world, host buffers between
``tpurun``'s processes).  Beside them: ``MPIX_Get_affinity``,
``MPIX_Query_cuda_support`` (false on the CPU lane and before ``init``),
``COMM_WORLD()``/``COMM_SELF()`` and ``Comm.abort``, whose job exits with
the code given."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import ompi_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tpurun(n, script, extra=(), timeout=300):
    env = {k: v for k, v in os.environ.items()
           if k not in ("OTPU_RANK", "OTPU_NPROCS", "OTPU_COORD")}
    cmd = [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-n", str(n),
           *extra, sys.executable, str(script)]
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, cwd=REPO, env=env)


@pytest.fixture(scope="module")
def world():
    from ompi_tpu_torch.runtime import init as rt

    rt.reset_for_testing()
    w = ompi_tpu_torch.init(device="cpu")
    yield w
    rt.reset_for_testing()


def test_dup_with_info_and_compare(world):
    from ompi_tpu_torch.api.info import Info

    info = Info()
    info.set("foo", "bar")
    d = world.dup_with_info(info)
    assert d.get_info().get("foo") == "bar"
    assert world.get_info().get("foo") is None
    assert world.compare(d) == world.CONGRUENT
    d.free()


def test_reduce_scatter_block_device_world(world):
    n = world.size
    x = np.arange(n * n * 3, dtype=np.float64).reshape(n, n * 3)
    out = world.reduce_scatter_block(x)
    want = x.sum(0).reshape(n, 3)
    np.testing.assert_allclose(np.asarray(out), want)


def test_nonblocking_variants_smoke(world):
    n = world.size
    x = np.arange(n * 4, dtype=np.float64).reshape(n, 4)
    r = world.iscan(x)
    np.testing.assert_allclose(
        np.asarray(r.result), np.cumsum(x, axis=0))
    r = world.iexscan(x)
    assert np.asarray(r.result)[0].sum() == 0
    r = world.igatherv(list(x))
    assert len(r.result) == n
    r = world.ireduce_scatter_block(np.ones((n, n * 2)))
    np.testing.assert_allclose(np.asarray(r.result),
                               np.full((n, 2), float(n)))


def test_neighbor_v_variants_cart(world):
    cart = world.cart_create([world.size], periods=[True])
    # device world: table of per-rank buffers with DIFFERENT sizes
    table = [np.arange(r + 1, dtype=np.float64) * (r + 1)
             for r in range(world.size)]
    out = cart.neighbor_allgatherv(table)
    srcs, _ = cart.topo.neighbors(cart.rank)
    for got, s in zip(out, srcs):
        np.testing.assert_allclose(got, table[s])
    r = cart.ineighbor_allgatherv(table)
    for got, s in zip(r.result, srcs):
        np.testing.assert_allclose(got, table[s])
    cart.free()


def test_cart_and_graph_map(world):
    from ompi_tpu_torch.api.status import UNDEFINED

    n = world.size
    assert world.cart_map([n]) == world.rank
    assert world.cart_map([1]) == (0 if world.rank == 0 else UNDEFINED)
    assert world.graph_map([2, 3], [1, 0, 0]) in (world.rank, UNDEFINED)


def test_type_match_size():
    from ompi_tpu_torch.datatype import core

    assert core.match_size("integer", 4) is core.INT32
    assert core.match_size("real", 8) is core.FLOAT64
    assert core.match_size("complex", 16) is core.COMPLEX128
    with pytest.raises(ValueError):
        core.match_size("integer", 3)


def test_pcontrol():
    from ompi_tpu_torch.api import env

    env.pcontrol(0)
    assert env.pcontrol_level() == 0
    env.pcontrol(2, "extra", "args")
    assert env.pcontrol_level() == 2
    env.pcontrol()
    assert env.pcontrol_level() == 1


def test_file_external32_and_register_datarep(tmp_path, world):
    from ompi_tpu_torch.api import file as fmod
    from ompi_tpu_torch.datatype import core

    path = str(tmp_path / "ext32.bin")
    f = fmod.File.open(None, path,
                       fmod.MODE_CREATE | fmod.MODE_RDWR)
    f.set_view(etype=core.INT32, datarep="external32")
    data = np.array([1, 2, 3, 4], np.int32)
    f.write_at(0, data)
    raw = open(path, "rb").read()
    assert raw == data.byteswap().tobytes()   # big-endian on disk
    out = np.zeros(4, np.int32)
    f.read_at(0, out)
    np.testing.assert_array_equal(out, data)
    f.close()

    # user-registered rep: xor-masked stream both ways
    def mask(data, etype):
        return bytes(b ^ 0x5A for b in data)

    fmod.register_datarep("xor5a", mask, mask)
    path2 = str(tmp_path / "xor.bin")
    f = fmod.File.open(None, path2,
                       fmod.MODE_CREATE | fmod.MODE_RDWR)
    f.set_view(datarep="xor5a")
    payload = np.frombuffer(b"hello-datarep!", np.uint8)
    f.write_at(0, payload)
    assert open(path2, "rb").read() == mask(payload.tobytes(), None)
    back = np.zeros(payload.size, np.uint8)
    f.read_at(0, back)
    np.testing.assert_array_equal(back, payload)
    f.close()
    with pytest.raises(Exception):
        fmod.register_datarep("external32", mask, mask)


def test_win_pscw_test_rdma(tmp_path):
    script = tmp_path / "wtest.py"
    script.write_text(textwrap.dedent("""
        import time
        import numpy as np, ompi_tpu_torch
        from ompi_tpu_torch.api.win import Win

        w = ompi_tpu_torch.init(device="cpu")
        win = Win.create(w, size=8, dtype=np.float64)
        grp_other = w.group.incl([1 - w.rank])
        if w.rank == 0:
            win.post(grp_other)
            spins = 0
            while not win.test():        # MPI_Win_test polling loop
                time.sleep(0.005)
                spins += 1
                assert spins < 2000, "win.test never completed"
            assert win.local[0] == 7.0, win.local
            print("WTEST OK", flush=True)
        else:
            win.start(grp_other)
            win.put(np.array([7.0]), 0, 0)
            time.sleep(0.2)   # target must poll test() a few times
            win.complete()
        win.free()
        ompi_tpu_torch.finalize()
    """))
    r = _tpurun(2, script)
    assert "WTEST OK" in r.stdout, r.stdout + r.stderr
    assert r.returncode == 0, r.stdout + r.stderr


def test_spawn_multiple_and_join(tmp_path):
    childa = tmp_path / "childa.py"
    childa.write_text(textwrap.dedent("""
        import ompi_tpu_torch
        w = ompi_tpu_torch.init(device="cpu")
        inter = ompi_tpu_torch.get_parent()
        full = inter.merge(high=True)
        import numpy as np
        out = full.allreduce(np.array([1.0]))
        print(f"CHILD-A rank {w.rank} of {w.size} sum {out[0]}",
              flush=True)
    """))
    childb = tmp_path / "childb.py"
    childb.write_text(childa.read_text().replace("CHILD-A", "CHILD-B"))
    script = tmp_path / "spawnm.py"
    script.write_text(textwrap.dedent(f"""
        import sys
        import numpy as np, ompi_tpu_torch
        w = ompi_tpu_torch.init(device="cpu")
        inter = w.spawn_multiple(
            [[sys.executable, {str(childa)!r}],
             [sys.executable, {str(childb)!r}]], [2, 1])
        assert inter.remote_size == 3
        full = inter.merge(high=False)
        out = full.allreduce(np.array([1.0]))
        assert out[0] == 5.0, out    # 2 parents + 3 children
        print("SPAWNM OK", flush=True)
    """))
    r = _tpurun(2, script, timeout=300)
    assert "SPAWNM OK" in r.stdout, r.stdout + r.stderr
    # one child WORLD of 3 spanning both commands
    assert "CHILD-A rank" in r.stdout and "of 3" in r.stdout
    assert "CHILD-B rank" in r.stdout


def test_comm_join_and_intercomm_create(tmp_path):
    script = tmp_path / "join.py"
    script.write_text(textwrap.dedent("""
        import socket
        import numpy as np, ompi_tpu_torch
        from ompi_tpu_torch import dpm

        w = ompi_tpu_torch.init(device="cpu")
        # build a plain connected socket pair between ranks 0 and 1
        if w.rank == 0:
            srv = socket.create_server(("127.0.0.1", 0))
            w.send_obj(srv.getsockname(), 1, tag=9)
            sock, _ = srv.accept()
        else:
            addr = w.recv_obj(0, tag=9)
            sock = socket.create_connection(tuple(addr))
        inter = dpm.join(sock)
        assert inter.is_inter and inter.remote_size == 1
        # talk across it
        if w.rank == 0:
            inter.send(np.array([42.0]), dest=0, tag=1)
        else:
            buf = np.zeros(1)
            inter.recv(buf, source=0, tag=1)
            assert buf[0] == 42.0
        # MPI_Intercomm_create: two SELF "groups" bridged over world
        half = w.split(w.rank)         # 1-rank comms
        inter2 = half.create_intercomm(0, w, 1 - w.rank, tag=3)
        assert inter2.is_inter and inter2.remote_size == 1
        if w.rank == 0:
            inter2.send(np.array([7.0]), dest=0, tag=2)
        else:
            buf = np.zeros(1)
            inter2.recv(buf, source=0, tag=2)
            assert buf[0] == 7.0
        print(f"JOIN OK {w.rank}", flush=True)
        ompi_tpu_torch.finalize()
    """))
    r = _tpurun(2, script)
    assert r.stdout.count("JOIN OK") == 2, r.stdout + r.stderr
    assert r.returncode == 0, r.stdout + r.stderr


def test_imrecv_and_persistent_send_modes(tmp_path):
    script = tmp_path / "imrecv.py"
    script.write_text(textwrap.dedent("""
        import numpy as np, ompi_tpu_torch
        from ompi_tpu_torch.api import buffer as bsendbuf

        w = ompi_tpu_torch.init(device="cpu")
        if w.rank == 0:
            bsendbuf.attach(1 << 16)
            req = w.bsend_init(np.arange(8.0), dest=1, tag=4)
            req.start(); req.wait()
            req.start(); req.wait()
            rreq = w.rsend_init(np.arange(4.0) * 2, dest=1, tag=5)
            rreq.start(); rreq.wait()
            bsendbuf.detach()
        else:
            for _ in range(2):
                msg = w.mprobe(source=0, tag=4)
                buf = np.zeros(8)
                r = msg.irecv(buf)        # MPI_Imrecv
                r.wait()
                assert buf.tolist() == list(range(8)), buf
            buf = np.zeros(4)
            w.recv(buf, source=0, tag=5)
            assert buf[3] == 6.0
        print(f"IMRECV OK {w.rank}", flush=True)
        ompi_tpu_torch.finalize()
    """))
    r = _tpurun(2, script)
    assert r.stdout.count("IMRECV OK") == 2, r.stdout + r.stderr
    assert r.returncode == 0, r.stdout + r.stderr


def test_neighbor_v_variants_multiprocess(tmp_path):
    script = tmp_path / "nv.py"
    script.write_text(textwrap.dedent("""
        import numpy as np, ompi_tpu_torch

        w = ompi_tpu_torch.init(device="cpu")
        cart = w.cart_create([w.size], periods=[True])
        r = cart.rank
        mine = np.arange(r + 1, dtype=np.float64) * (r + 1)
        out = cart.neighbor_allgatherv(mine)
        srcs, dsts = cart.topo.neighbors(r)
        for got, s in zip(out, srcs):
            want = np.arange(s + 1, dtype=np.float64) * (s + 1)
            assert np.allclose(got, want), (r, s, got)
        # alltoallv: distinct payload per destination, varying sizes
        sends = [np.full(d + 2, float(r * 10 + d)) for d in dsts]
        got = cart.neighbor_alltoallv(sends)
        for g, s in zip(got, srcs):
            # the peer s sent us a buffer labeled s*10 + (my rank)
            assert g[0] == s * 10 + r and len(g) == r + 2, (r, s, g)
        # alltoallw: reinterpret received bytes per source
        gotw = cart.neighbor_alltoallw(
            [b.view(np.uint8) for b in sends], recvtypes=np.float64)
        for g, s in zip(gotw, srcs):
            assert g.dtype == np.float64 and g[0] == s * 10 + r
        print(f"NV OK {r}", flush=True)
        ompi_tpu_torch.finalize()
    """))
    r = _tpurun(3, script)
    assert r.stdout.count("NV OK") == 3, r.stdout + r.stderr
    assert r.returncode == 0, r.stdout + r.stderr


def test_session_api_surface(world):
    """MPI-4 Sessions bindings (``ompi/mpi/c/session_*.c``): init/
    finalize, info + errhandler, pset enumeration, and the sessions-
    model construction chain Group_from_session_pset →
    Comm_create_from_group (full lifecycle coverage in
    test_session.py; device-world crossing in test_device_world.py)."""
    from ompi_tpu_torch.api.errhandler import ERRORS_RETURN
    from ompi_tpu_torch.api.session import Session

    s = Session.init(errhandler=ERRORS_RETURN)
    try:
        n = s.get_num_psets()
        names = [s.get_nth_pset(i) for i in range(n)]
        assert "mpi://WORLD" in names and "mpi://SELF" in names
        info = s.get_pset_info("mpi://WORLD")
        g = ompi_tpu_torch.Group.from_session_pset(s, "mpi://WORLD")
        assert int(info.get("mpi_size")) == g.size
        comm = ompi_tpu_torch.Comm.create_from_group(g, "completeness")
        assert comm.size == g.size and comm.cid >= 2
        np.testing.assert_allclose(
            np.asarray(comm.allreduce_array(
                np.ones((comm.size, 2), np.float32))).ravel(),
            comm.size)
        comm.free()
        lo = g.incl(range(g.size // 2))
        hi = g.difference(lo)
        inter = ompi_tpu_torch.Comm.create_intercomm_from_groups(
            lo, 0, hi, 0, "completeness-inter")
        assert inter.is_inter and inter.remote_size == hi.size
        inter.free()
    finally:
        s.finalize()


def test_partitioned_communication(world):
    """MPI-4 partitioned p2p (Psend_init/Precv_init/Pready/Pready_range/
    Pready_list/Parrived — mca/part/persist); full coverage in
    test_part.py."""
    a, b = world.as_rank(0), world.as_rank(1)
    x = np.arange(24.0)
    y = np.zeros(24)
    s = a.psend_init(x, 6, dest=1, tag=21)
    r = b.precv_init(y, 4, source=0, tag=21)   # mismatched counts
    from ompi_tpu_torch.api.request import start_all

    start_all([s, r])
    s.pready(5)
    s.pready_range(0, 1)
    assert not r.parrived(2)
    s.pready_list([3, 2, 4])
    s.wait()
    r.wait()
    np.testing.assert_array_equal(y, x)
    assert all(r.parrived(p) for p in range(4))


def test_partitioned_collective_init(world):
    """Pallreduce_init analog: bucketed persistent allreduce released
    bucket-by-bucket with Pready."""
    n = world.size
    buckets = [np.full((n, 2), float(i), np.float64) for i in range(1, 4)]
    req = world.pallreduce_init(buckets)
    req.start()
    req.pready_list([2, 0, 1])
    req.wait()
    for i, got in enumerate(req.result):
        np.testing.assert_allclose(np.asarray(got), (i + 1) * n)


def test_host_persistent_collective_and_ext_queries(tmp_path):
    """mpiext analogs: pcollreq on the host path (restartable persistent
    collective), MPIX_Get_affinity, MPIX_Query_cuda_support."""
    from ompi_tpu_torch.api import env

    aff = env.get_affinity()
    assert isinstance(aff, list)
    assert isinstance(env.query_accelerator_support(), bool)

    script = tmp_path / "pcoll.py"
    script.write_text(textwrap.dedent("""
        import numpy as np, ompi_tpu_torch

        w = ompi_tpu_torch.init(device="cpu")
        x = np.full(4, float(w.rank + 1))
        req = w.coll_init("allreduce", x)
        for _ in range(3):                 # restartable: MPI_Start loop
            req.start()
            req.wait()
        total = w.size * (w.size + 1) / 2
        assert np.allclose(req.result, total), req.result
        print(f"PCOLL OK {w.rank}", flush=True)
        ompi_tpu_torch.finalize()
    """))
    r = _tpurun(3, script)
    assert r.stdout.count("PCOLL OK") == 3, r.stdout + r.stderr
    assert r.returncode == 0, r.stdout + r.stderr


def test_mpi_t_pvar_discoverability_complete():
    """MPI_T completeness (otpu-top satellite): every SPC counter and
    every otpu-trace histogram pvar must be discoverable AND readable
    through an ``api/tool.py`` PvarSession — the contract otpu_top and
    external MPI_T tools rely on.  The histogram pvars register lazily
    per touched (coll, size-bin) cell, so the test records one cell
    first, then demands the full family (count/sum/p50/p99)."""
    from ompi_tpu_torch.api import tool
    from ompi_tpu_torch.runtime import spc, trace

    spc.init()
    trace.init()
    trace.hist_record("allreduce", 4096, 1_500_000)   # 4k bin, 1.5ms
    tool.init_thread()
    try:
        n = tool.pvar_get_num()
        names = {tool.pvar_get_info(i).name: i for i in range(n)}
        # every declared SPC counter is discoverable
        for counter in spc._COUNTERS:
            assert f"otpu_runtime_spc_{counter}" in names, counter
        # the tracer's own pvar and the touched histogram cell's family
        assert "otpu_trace_events_recorded" in names
        for suffix in ("count", "sum_us", "p50_us", "p99_us"):
            assert f"otpu_trace_hist_allreduce_4k_{suffix}" in names, \
                suffix
        # ...and every one of them is readable through a session handle
        session = tool.pvar_session_create()
        for pname, idx in names.items():
            if not (pname.startswith("otpu_runtime_spc_")
                    or pname.startswith("otpu_trace_")):
                continue
            h = session.handle_alloc(idx)
            h.start()
            val = h.read()
            assert isinstance(val, (int, float)), pname
            h.stop()
            session.handle_free(h)
        # the percentile pvars derive from the live population
        p50 = tool.pvar_get_info(
            names["otpu_trace_hist_allreduce_4k_p50_us"]).read()
        assert p50 > 0, "percentile pvar read 0 after a recorded cell"
        tool.pvar_session_free(session)
    finally:
        tool.finalize()


def test_pcontrol_level_is_the_references():
    from ompi_tpu.api import env as jenv
    from ompi_tpu_torch.api import env

    for level in (0, 3, 1):
        env.pcontrol(level)
        jenv.pcontrol(level)
        assert env.pcontrol_level() == jenv.pcontrol_level() == level


def test_get_affinity_is_the_references():
    from ompi_tpu.api import env as jenv
    from ompi_tpu_torch.api import env

    assert env.get_affinity() == jenv.get_affinity()
    assert env.get_affinity() == sorted(os.sched_getaffinity(0))


def test_query_accelerator_support_on_the_cpu_lane():
    """False before ``init`` (the query initializes nothing) and in a world
    bound to the CPU."""
    from ompi_tpu_torch.api import env
    from ompi_tpu_torch.runtime import init as rt

    rt.reset_for_testing()
    try:
        assert env.query_accelerator_support() is False
        assert not rt.initialized()
        ompi_tpu_torch.init(device="cpu")
        assert env.query_accelerator_support() is False
    finally:
        rt.reset_for_testing()


def test_comm_world_and_comm_self_aliases():
    from ompi_tpu_torch.runtime import init as rt

    rt.reset_for_testing()
    try:
        world = ompi_tpu_torch.init(device="cpu")
        assert rt.COMM_WORLD() is rt.comm_world() is world
        assert rt.COMM_SELF() is rt.comm_self()
        assert rt.COMM_SELF().size == 1
        assert ompi_tpu_torch.COMM_WORLD is world
    finally:
        rt.reset_for_testing()


def test_output_and_progress_queries():
    from ompi_tpu_torch.base import output
    from ompi_tpu_torch.runtime import progress

    sid = output.open_stream("completeness", verbosity=3)
    assert output.get_verbosity("completeness") == 3
    assert output.get_verbosity(sid) == 3
    assert output.get_verbosity("no-such-stream") == 0
    output.show_help("help-completeness", "key")
    assert output.help_seen_counts()[("help-completeness", "key")] >= 1

    def cb():
        return 0

    before = progress.callback_count()
    progress.register(cb)
    try:
        assert progress.callback_count() == before + 1
    finally:
        progress.unregister(cb)
    assert progress.callback_count() == before


@pytest.mark.parametrize("code", [3, 7])
def test_comm_abort_exits_the_job_with_its_code(tmp_path, code):
    script = tmp_path / "abort.py"
    script.write_text(textwrap.dedent(f"""
        import time
        import ompi_tpu_torch

        w = ompi_tpu_torch.init(device="cpu")
        assert ompi_tpu_torch.COMM_WORLD is w
        if w.rank == 1:
            w.abort({code})
        time.sleep(60)       # rank 0 waits to be torn down with the job
    """))
    r = _tpurun(2, script, timeout=120)
    assert r.returncode == code, r.stdout + r.stderr
    said = r.stdout + r.stderr
    assert "MPI_Abort" in said and f"with code {code}" in said
    assert f"job terminated with exit code {code}" in r.stderr
