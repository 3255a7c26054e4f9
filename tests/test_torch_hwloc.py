"""The port's hwloc analog (``base/hwloc.py``) and hook/comm_method, held
against the JAX package's (the reference's
``tests/test_hwloc_peruse.py::TestHwloc`` and
``tests/test_breadth.py::test_hook_comm_method_matrix``).

The pure functions take the same inputs in both packages and are compared
exactly: the host topology, ``_parse_cpulist``, the ``--bind-to core``
partition (of a given topology and of the process's original mask), the
locality tiers and the summary's host line.  Off a TPU, ``ici_mesh_shape``
is None in both; the port's ``device_topology`` lists CUDA devices, none
here.  Across processes, a ``--bind-to core`` job of the port's tpurun
gives its ranks disjoint affinities (plain and over a hostfile), and one
``-n 3`` job a package with ``otpu_hook_comm_method_display`` prints the
same ``[comm_method]`` matrix.  Every subprocess has its own ``timeout=``.
"""
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from ompi_tpu.base import hwloc as jh
from ompi_tpu_torch.base import hwloc as th

REPO = Path(__file__).resolve().parent.parent

TOPO = dict(hostname="h", ncpus_online=8, cpus_allowed=tuple(range(8)),
            numa_nodes=((0, tuple(range(4))), (1, tuple(range(4, 8)))))


def _tpurun(pkg, args, timeout=150):
    env = dict(os.environ)
    for k in ("OTPU_RANK", "OTPU_NPROCS", "OTPU_COORD"):
        env.pop(k, None)
    launcher = f"{pkg}.tools.tpurun"
    p = subprocess.Popen([sys.executable, "-m", launcher, *args],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, cwd=REPO, env=env,
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    return subprocess.CompletedProcess(p.args, p.returncode, out, err)


def test_host_topology_matches_the_reference():
    a = jh.host_topology(refresh=True)
    b = th.host_topology(refresh=True)
    assert (a.hostname, a.ncpus_online, a.cpus_allowed, a.numa_nodes,
            a.nnuma) == (b.hostname, b.ncpus_online, b.cpus_allowed,
                         b.numa_nodes, b.nnuma)
    assert b.ncpus_online >= 1 and len(b.cpus_allowed) >= 1 and b.hostname


@pytest.mark.parametrize("text", ["0", "0-3", "0-3,8-11", " 1 , 4-5,", "",
                                  "7,2,5-6"])
def test_parse_cpulist_matches_the_reference(text):
    assert th._parse_cpulist(text) == jh._parse_cpulist(text)


@pytest.mark.parametrize("rank,nranks", [(0, 2), (1, 2), (0, 3), (2, 3),
                                         (3, 8), (7, 8), (3, 16)])
def test_binding_partition_matches_the_reference(rank, nranks):
    jt, tt = jh.HostTopology(**TOPO), th.HostTopology(**TOPO)
    got = th.compute_binding(rank, nranks, tt)
    assert got == jh.compute_binding(rank, nranks, jt)
    if nranks > 8:      # oversubscribed: unbound, every cpu
        assert got == tuple(range(8))
    # without a topology both partition the process's original mask
    assert th.compute_binding(rank, nranks) == \
        jh.compute_binding(rank, nranks)


def test_binding_blocks_are_disjoint_and_cover_in_order():
    tt = th.HostTopology(**TOPO)
    blocks = [th.compute_binding(r, 2, tt) for r in range(2)]
    assert blocks == [(0, 1, 2, 3), (4, 5, 6, 7)]


LOCALITY_CASES = {
    "other_node": (("a", "b"), {}),
    "same_node": (("a", "a"), {}),
    "same_numa": (("a", "a", (0,), (1,)), {"ncpus": 4}),
    "same_core": (("a", "a", (0, 1), (1,)), {"ncpus": 4}),
    "different_numa": (("a", "a", (0,), (2,)), {"ncpus": 4}),
    "unbound": (("a", "a", (0, 1, 2, 3), (0, 1, 2, 3)), {"ncpus": 4}),
}


@pytest.mark.parametrize("case", sorted(LOCALITY_CASES))
def test_locality_tiers_match_the_reference(case):
    numa = ((0, (0, 1)), (1, (2, 3)))
    args, kw = LOCALITY_CASES[case]
    extra = {"numa_nodes": numa} if len(args) > 2 else {}
    got = th.locality(*args, **extra, **kw)
    assert got == jh.locality(*args, **extra, **kw)
    want = {"other_node": th.LOC_DIFFERENT_NODE, "same_node": th.LOC_SAME_NODE,
            "same_numa": th.LOC_SAME_NUMA, "same_core": th.LOC_SAME_CORE,
            "different_numa": th.LOC_SAME_NODE,
            "unbound": th.LOC_SAME_NODE}[case]
    assert got == want
    assert (th.LOC_DIFFERENT_NODE, th.LOC_SAME_NODE, th.LOC_SAME_NUMA,
            th.LOC_SAME_CORE) == (jh.LOC_DIFFERENT_NODE, jh.LOC_SAME_NODE,
                                  jh.LOC_SAME_NUMA, jh.LOC_SAME_CORE)


def test_summary_host_line_matches_the_reference():
    t, j = th.summary(), jh.summary()
    assert t.startswith("host:")
    assert t.splitlines()[0] == j.splitlines()[0]


def test_ici_mesh_shape_is_none_off_tpu():
    """A CPU mesh (and a GPU) has no interconnect coordinates: the shape
    is None, not garbage, in both packages."""
    assert all(d.coords is None for d in jh.device_topology())
    assert jh.ici_mesh_shape() is None
    assert th.ici_mesh_shape() is None


@pytest.mark.skipif(torch.cuda.is_available(), reason="no card expected")
def test_device_topology_without_a_card_is_empty():
    assert th.device_topology() == []
    assert "devices: none" in th.summary()


BIND_JOB = textwrap.dedent("""
    import os
    import ompi_tpu_torch
    w = ompi_tpu_torch.init(device="cpu")
    cpus = sorted(os.sched_getaffinity(0))
    print(f"BIND {w.rank} {os.environ.get('OTPU_NODE_ID', '-')} "
          f"{','.join(map(str, cpus))}", flush=True)
    ompi_tpu_torch.finalize()
""")


def _affinities(stdout):
    out = {}
    for line in stdout.splitlines():
        if "BIND " in line:
            rank, node, cpus = line.split("BIND ", 1)[1].split(" ")
            out[int(rank)] = (node, set(map(int, cpus.split(","))))
    return out


@pytest.mark.parametrize("layout", ["plain", "hostfile"])
def test_bind_to_core_gives_disjoint_affinities(tmp_path, layout):
    allowed = sorted(os.sched_getaffinity(0))
    if len(allowed) < 2:
        pytest.skip("one allowed cpu: --bind-to core cannot partition it")
    script = tmp_path / "bind.py"
    script.write_text(BIND_JOB)
    args = ["-n", "4", "--bind-to", "core"]
    if layout == "hostfile":
        hf = tmp_path / "hosts.txt"
        hf.write_text("alpha slots=2\nbeta slots=2\n")
        args += ["--hostfile", str(hf), "--launch-agent", "local"]
    r = _tpurun("ompi_tpu_torch", args + [sys.executable, str(script)])
    assert r.returncode == 0, r.stdout + r.stderr
    got = _affinities(r.stdout)
    assert sorted(got) == [0, 1, 2, 3], r.stdout
    groups = ({"alpha": [0, 1], "beta": [2, 3]} if layout == "hostfile"
              else {"-": [0, 1, 2, 3]})
    per = len(allowed) // (2 if layout == "hostfile" else 4)
    for node, ranks in groups.items():
        sets = [got[r][1] for r in ranks]
        assert all(got[r][0] == node for r in ranks)
        if per == 0:      # fewer cores than ranks: unbound
            assert all(s == set(allowed) for s in sets)
            continue
        for i, a in enumerate(sets):
            assert len(a) == per and a <= set(allowed)
            for b in sets[i + 1:]:
                assert not a & b, (node, sets)


HOOK_JOB = {
    "ompi_tpu_torch": "import ompi_tpu_torch as m; m.init(device='cpu'); "
                      "m.finalize()\n",
    "ompi_tpu": "import ompi_tpu as m; m.init(); m.finalize()\n",
}


def test_hook_comm_method_matrix_matches_the_reference(tmp_path):
    """Every rank prints its transport row; sm serves the same-host peers
    and the locality tier is the node's, in both packages alike."""
    rows = {}
    for pkg, body in HOOK_JOB.items():
        script = tmp_path / f"hook_{pkg}.py"
        script.write_text(body)
        r = _tpurun(pkg, ["-n", "3", "--mca", "hook_comm_method_display",
                          "1", sys.executable, str(script)])
        assert r.returncode == 0, r.stdout + r.stderr
        rows[pkg] = sorted(ln.split("] ", 1)[1] for ln in r.stdout.splitlines()
                           if "[comm_method]" in ln)
    assert len(rows["ompi_tpu_torch"]) == 3
    assert "sm" in rows["ompi_tpu_torch"][0]
    assert rows["ompi_tpu_torch"] == rows["ompi_tpu"]
