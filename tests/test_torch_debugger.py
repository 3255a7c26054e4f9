"""The port's debugger views (``ompi_tpu_torch/runtime/debugger.py``, with
the live-communicator registry of ``api/comm.py``) held against the JAX
package's ``ompi_tpu.runtime.debugger`` on the CPU.

* the communicator table: the world and a dup, in both packages' device
  worlds, give rows equal key for key; a freed comm drops out and a
  collected one leaves the registry;
* the message queues: the same sends and receives driven into both
  packages' ob1 give the same posted and unexpected rows;
* the proc table: the port lists every world rank with its device, where
  the reference lists rank 0 alone (its ``proc_table`` reads an
  ``rte.nprocs`` that its rte does not have); rank 0's row carries the
  reference's keys and values; ``dump`` has the reference's sections;
* across processes (``tpurun -n 2``): a rendezvous send left unmatched and
  a receive left unsent show as an active send request (in the row of
  active send and receive requests), an unexpected rendezvous fragment
  and a posted receive, each row with the reference's keys.
"""
import gc
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu.runtime import debugger as jdbg
from ompi_tpu_torch.runtime import debugger as tdbg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def worlds():
    from ompi_tpu.runtime import init as jrt
    from ompi_tpu_torch.runtime import init as trt

    jrt.reset_for_testing()
    trt.reset_for_testing()
    # the JAX package's registry keeps a comm of an earlier test's world
    # that a reference cycle holds until the collector runs; the port's
    # teardown empties its own (test_teardown_empties_the_registry)
    gc.collect()
    jw = ompi_tpu.init()
    if jw.size != 8:
        pytest.skip("needs 8 virtual devices")
    yield {"jax": (jw, jdbg), "torch": (ompi_tpu_torch.init(device="cpu"),
                                        tdbg)}
    jrt.reset_for_testing()
    trt.reset_for_testing()


def _rows(dbg, cids) -> list:
    return [r for r in dbg.comm_table() if r["cid"] in cids]


def test_comm_table_lists_world_and_dup(worlds):
    got = {}
    for pkg, (w, dbg) in worlds.items():
        rows = dbg.comm_table()
        me = next(r for r in rows if r["cid"] == w.cid)
        assert me["size"] == w.size and me["rank"] == w.rank
        assert me["peers"] == list(range(w.size))
        dup = w.dup()
        dup.set_name("dup_for_debugger")
        with_dup = _rows(dbg, {w.cid, dup.cid})
        dup.free()
        assert dup.cid not in {r["cid"] for r in dbg.comm_table()}
        got[pkg] = [dict(r, cid=r["cid"] - w.cid) for r in with_dup]
    assert got["torch"] == got["jax"]
    assert [r["name"] for r in got["torch"]] == ["COMM_WORLD",
                                                 "dup_for_debugger"]


def test_live_registry_is_weak(worlds):
    """A comm that nothing holds leaves the registry: registration never
    keeps a communicator alive."""
    from ompi_tpu_torch.api.comm import live_comms

    w, _ = worlds["torch"]
    n0 = len(live_comms())
    dup = w.dup()
    assert dup in live_comms() and len(live_comms()) == n0 + 1
    del dup
    gc.collect()
    assert len(live_comms()) == n0


def test_teardown_empties_the_registry():
    """A comm that a reference cycle keeps uncollected across a teardown:
    the port's teardown empties the registry, so the next world's table
    lists its own comms alone; the JAX package's registry keeps the old
    dup until the collector takes it (pinned divergence)."""
    from ompi_tpu.runtime import init as jrt
    from ompi_tpu_torch.runtime import init as trt

    tables = {}
    gc.collect()
    gc.disable()
    try:
        for pkg, rt, dbg, boot in (
                ("jax", jrt, jdbg, ompi_tpu.init),
                ("torch", trt, tdbg,
                 lambda: ompi_tpu_torch.init(device="cpu"))):
            rt.reset_for_testing()
            dup = boot().dup()
            dup.set_name("held_by_a_cycle")
            dup.cycle = dup
            del dup
            rt.reset_for_testing()
            boot()
            tables[pkg] = [r["name"] for r in dbg.comm_table()]
            rt.reset_for_testing()
    finally:
        gc.enable()
        gc.collect()
    assert tables["torch"] == ["COMM_WORLD", "COMM_SELF"]
    assert tables["jax"] == ["COMM_WORLD", "COMM_SELF", "held_by_a_cycle"]


def _queues(w, dbg) -> list:
    c = w.dup()
    snaps = []

    def flat(key):
        return [dict(x, cid=None) if "cid" in x else x
                for r in dbg.message_queues(c) for x in r.get(key, [])]

    c.as_rank(0).send(np.arange(4, dtype=np.int32), dest=1, tag=77)
    snaps.append(("unexpected", flat("unexpected")))
    buf = np.zeros(4, np.int32)
    c.as_rank(1).recv(buf, source=0, tag=77)
    snaps.append(("drained", flat("unexpected")))
    req = c.as_rank(1).irecv(np.zeros(2, np.int32), source=0, tag=88)
    snaps.append(("posted", flat("posted_recvs")))
    snaps.append(("rows", sorted((r["rank"], sorted(r))
                                 for r in dbg.message_queues(c)
                                 if "rank" in r)))
    c.as_rank(0).send(np.ones(2, np.int32), dest=1, tag=88)
    req.wait()
    snaps.append(("after", flat("posted_recvs")))
    c.free()
    return snaps


def test_message_queues_match_reference(worlds):
    """Drive ob1 into a known queue state (an unexpected send, then a
    posted receive) and read it back: the port's rows equal the
    reference's."""
    got = _queues(*worlds["torch"])
    assert got == _queues(*worlds["jax"])
    snaps = dict(got)
    assert snaps["unexpected"] == [{"src": 0, "tag": 77, "seq": 0,
                                    "nbytes": 16, "kind": "match"}]
    assert snaps["drained"] == [] and snaps["after"] == []
    assert [p["tag"] for p in snaps["posted"]] == [88]
    assert snaps["rows"][0][1] == ["cid", "out_of_order", "posted_recvs",
                                   "rank", "unexpected"]


def test_proc_table_and_dump(worlds):
    """Every world rank with its device; rank 0's row has the reference's
    keys and values; ``dump`` has the reference's sections."""
    tw, _ = worlds["torch"]
    procs = tdbg.proc_table()
    ref = jdbg.proc_table()
    assert [p["rank"] for p in procs] == list(range(tw.size))
    assert len(ref) == 1              # the reference lists rank 0 alone
    assert {k: procs[0][k] for k in ref[0]} == ref[0]
    assert sum(1 for p in procs if p["is_me"]) == 1
    assert {p["device"] for p in procs} == {"cpu"}
    d = tdbg.dump()
    assert set(d) == set(jdbg.dump()) == {"comms", "message_queues",
                                          "procs"}
    assert tw.cid in {r["cid"] for r in d["comms"]}


_JOB = """
import json
import time

import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch.runtime import debugger
from ompi_tpu_torch.runtime.progress import progress

w = ompi_tpu_torch.init(device="cpu")
big = np.arange(1 << 18, dtype=np.float64)           # 2 MiB: rendezvous


def rows(key):
    return [x for r in debugger.message_queues(w) for x in r.get(key, [])]


if w.rank == 0:
    req = w.isend(big, dest=1, tag=5)
    active = rows("active_send_requests")
    assert any(a["tag"] == 5 for a in active), active
    active_row = next(r for r in debugger.message_queues(w)
                      if "active_send_requests" in r)
    w.send(np.zeros(1), dest=1, tag=6)                # "look now"
    w.recv(np.zeros(1), source=1, tag=7)              # "seen"
    req.wait()
    w.send(np.ones(2, np.int32), dest=1, tag=9)
    out = {"active_send": sorted(active[0]),
           "active_row": sorted(active_row)}
else:
    w.recv(np.zeros(1), source=0, tag=6)
    deadline = time.time() + 30
    while not any(f["tag"] == 5 for f in rows("unexpected")):
        progress()
        assert time.time() < deadline, debugger.message_queues(w)
    unexp = [f for f in rows("unexpected") if f["tag"] == 5]
    assert unexp[0]["kind"] in ("rndv", "rget"), unexp
    req = w.irecv(np.zeros(2, np.int32), source=0, tag=9)
    posted = rows("posted_recvs")
    assert [p["tag"] for p in posted] == [9], posted
    w.send(np.zeros(1), dest=0, tag=7)
    buf = np.zeros_like(big)
    w.recv(buf, source=0, tag=5)
    assert np.array_equal(buf, big)
    req.wait()
    assert rows("posted_recvs") == []
    out = {"unexpected": sorted(unexp[0]), "posted": sorted(posted[0]),
           "queue": sorted(next(r for r in debugger.message_queues(w)
                                if "rank" in r))}
print("DBG " + json.dumps(dict(out, rank=w.rank)), flush=True)
ompi_tpu_torch.finalize()
"""


def test_message_queues_across_processes(tmp_path):
    """An unmatched rendezvous send and an unsent receive between two
    processes: every queue view a debugger walks, with the reference's
    row keys."""
    import json

    from ompi_tpu.runtime.debugger import _frag_row, _req_row

    script = tmp_path / "dbg.py"
    script.write_text(textwrap.dedent(_JOB))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for k in ("OTPU_RANK", "OTPU_NPROCS", "OTPU_COORD"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-m", "ompi_tpu_torch.tools.tpurun",
                        "-n", "2", sys.executable, str(script)],
                       capture_output=True, text=True, timeout=120, cwd=REPO,
                       env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    outs = {}
    for ln in r.stdout.splitlines():
        if "DBG " in ln:
            d = json.loads(ln.split("DBG ", 1)[1])
            outs[d.pop("rank")] = d

    class _Frag:
        src = tag = seq = kind = data = None

    class _Req:
        pass

    frag_keys = sorted(_frag_row(_Frag()))
    req_keys = sorted(_req_row(_Req()))
    assert outs[0] == {"active_send": req_keys,
                       "active_row": ["active_recv_requests",
                                      "active_send_requests", "cid"]}
    assert outs[1] == {"unexpected": frag_keys, "posted": req_keys,
                       "queue": ["cid", "out_of_order", "posted_recvs",
                                 "rank", "unexpected"]}
