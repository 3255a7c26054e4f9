"""parallel/elastic in the port — train through failure — held against the
JAX package.

* the integer gradient field and its partitions: the same float64 bits in
  both packages, whatever the partition;
* the trainer in one process (a one-rank ``ProcRte`` world): train,
  checkpoint, restore and replay in both packages, the same parameters bit
  for bit and the same checkpoint files byte for byte;
* the acceptance scenario: ``tpurun -n 4 --enable-recovery --mca
  otpu_chaos_spec 'kill:rank=2,step=7'`` with the trainer in respawn mode
  ends at width 4 with parameters bit-identical to the JAX package's
  ``reference_run`` from the restored step (read by the JAX package's own
  ``checkpoint.load``), the six recovery phases in the merged trace, and
  the killed rank's ``chaos-kill`` dump in the flight bundle;
* shrink only: 3 → 2 ranks, also bit-exact;
* the divergence the trainer needs: a revocation completes the revoked
  comm's pending receives with ``RevokedError`` in the port (ULFM's
  revoke), where the reference leaves them pending.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from ompi_tpu.parallel import elastic as ref_elastic
from ompi_tpu_torch.parallel import elastic

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("step,dims,seed", [(3, 16, 0), (0, 12, 0),
                                            (9, 5, 4)])
def test_grad_field_partitions_match_the_reference(step, dims, seed):
    full = elastic.grad_field(step, 0, 32, dims, seed)
    assert full.tobytes() == ref_elastic.grad_field(step, 0, 32, dims,
                                                    seed).tobytes()
    for width in (1, 2, 3, 4, 5, 7):
        parts = np.zeros(dims, np.float64)
        for r in range(width):
            lo, hi = elastic.partition(r, width, 32)
            assert (lo, hi) == ref_elastic.partition(r, width, 32)
            parts = parts + elastic.grad_field(step, lo, hi, dims, seed)
        assert parts.tobytes() == full.tobytes(), width
    w0 = np.linspace(-1, 1, dims)
    assert elastic.reference_run(w0, 2, 9, 24, seed=seed).tobytes() == \
        ref_elastic.reference_run(w0, 2, 9, 24, seed=seed).tobytes()


def _one_rank_world(pkg, monkeypatch):
    from ompi_tpu_torch.rte.coord import CoordServer

    srv = CoordServer(1)
    monkeypatch.setenv("OTPU_COORD", f"{srv.addr[0]}:{srv.addr[1]}")
    monkeypatch.setenv("OTPU_RANK", "0")
    monkeypatch.setenv("OTPU_NPROCS", "1")
    rt = __import__(f"{pkg}.runtime.init", fromlist=["x"])
    rt.reset_for_testing()
    return srv, rt


def test_trainer_in_process_matches_the_reference(tmp_path, monkeypatch):
    """Train, checkpoint every 4 steps, restore the latest and replay, in
    each package: the same parameter bits and the same files."""
    import torch

    import ompi_tpu
    import ompi_tpu_torch

    got = {}
    for pkg in ("ompi_tpu_torch", "ompi_tpu"):
        srv, rt = _one_rank_world(pkg, monkeypatch)
        try:
            if pkg == "ompi_tpu_torch":
                w = ompi_tpu_torch.init(device="cpu")
                tr = elastic.ElasticTrainer(
                    w, ckpt_dir=str(tmp_path / pkg), model_size=8,
                    global_batch=12, ckpt_every=4, device="cpu")
            else:
                w = ompi_tpu.init()
                tr = ref_elastic.ElasticTrainer(
                    w, ckpt_dir=str(tmp_path / pkg), model_size=8,
                    global_batch=12, ckpt_every=4)
            first = tr.train(9)
            step = tr.latest_complete_step()
            tr._restore(step)
            restored = tr.step
            again = tr.train(9)
            if pkg == "ompi_tpu_torch":
                assert isinstance(first, torch.Tensor) \
                    and first.dtype == torch.float64 \
                    and first.device.type == "cpu"
                first, again = first.numpy(), again.numpy()
            got[pkg] = (first.tobytes(), step, restored, again.tobytes(),
                        tr.report()["w"])
        finally:
            rt.reset_for_testing()
            srv.close()
    assert got["ompi_tpu_torch"] == got["ompi_tpu"]
    want = ref_elastic.reference_run(np.zeros(8), 0, 9, 12)
    assert got["ompi_tpu_torch"][0] == want.tobytes()
    assert got["ompi_tpu_torch"][1:3] == (8, 8)
    for name in ("step000000", "step000004", "step000008"):
        for leaf in ("manifest.json", "w.bin", "step.bin", "COMPLETE"):
            assert (tmp_path / "ompi_tpu_torch" / name / leaf).read_bytes() \
                == (tmp_path / "ompi_tpu" / name / leaf).read_bytes()


ELASTIC_JOB = textwrap.dedent("""
    import json, sys
    import ompi_tpu_torch
    from ompi_tpu_torch.parallel.elastic import ElasticTrainer

    w = ompi_tpu_torch.init(device="cpu")
    tr = ElasticTrainer(w, ckpt_dir=sys.argv[1], model_size=12,
                        global_batch=24, ckpt_every=5,
                        respawn=(sys.argv[2] == "respawn"), device="cpu")
    tr.train(15)
    if tr.comm.rank == 0:
        print("ELASTIC " + json.dumps(tr.report()), flush=True)
    ompi_tpu_torch.finalize()
""")


def _run_elastic(tmp_path, n, kill_spec, mode, extra_mca=(), timeout=240,
                 fake_nodes=None):
    script = tmp_path / "job.py"
    script.write_text(ELASTIC_JOB)
    ckpt = tmp_path / "ckpt"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("OTPU_RANK", None)
    env.pop("OTPU_NPROCS", None)
    cmd = [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-n", str(n),
           "--enable-recovery", "--mca", "otpu_chaos_spec", kill_spec,
           "--mca", "otpu_flight_dir", str(tmp_path / "crash")]
    for k, v in extra_mca:
        cmd += ["--mca", k, v]
    if fake_nodes is not None:
        cmd += ["--fake-nodes", str(fake_nodes)]
    cmd += [sys.executable, str(script), str(ckpt), mode]
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, cwd=REPO, env=env,
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
    line = next((ln for ln in out.splitlines() if "ELASTIC " in ln), None)
    assert p.returncode == 0 and line is not None, out[-4000:] + err[-4000:]
    return json.loads(line.split("ELASTIC ", 1)[1]), ckpt, err


def _check_bitexact(rep, ckpt, failed_rank):
    """The final parameters against the JAX package's oracle, replayed
    from the checkpoint the recovery restored (read by the JAX package)."""
    from ompi_tpu.parallel import checkpoint

    recs = rep["recoveries"]
    assert recs and set(recs[0]["failed"]) <= {failed_rank}
    tree = checkpoint.load(str(ckpt / f"step{recs[0]['resume_step']:06d}"))
    assert int(np.asarray(tree["step"]).ravel()[0]) \
        == recs[0]["resume_step"]
    want = ref_elastic.reference_run(np.asarray(tree["w"]),
                                     recs[0]["resume_step"], 15, 24)
    assert rep["w"] == want.tolist(), "parameter continuation diverged"
    assert rep["step"] == 15
    return recs


def test_elastic_kill_respawn_bitexact(tmp_path):
    tdir = tmp_path / "trace"
    rep, ckpt, err = _run_elastic(
        tmp_path, 4, "kill:rank=2,step=7", "respawn",
        extra_mca=(("otpu_trace_enable", "1"),
                   ("otpu_trace_dir", str(tdir))))
    assert rep["world_size"] == 4, "never respawned to full width"
    recs = _check_bitexact(rep, ckpt, 2)
    assert recs[0]["detect_step"] == 7 and recs[0]["resume_step"] == 5
    assert "respawn_ms" in recs[0] and recs[0]["total_ms"] > 0
    assert "rank 2 failed (exit 7)" in err
    names = {e.get("name") for e in json.loads(
        (tdir / "trace_merged.json").read_text())["traceEvents"]}
    for span in ("elastic_detect", "elastic_agree", "elastic_shrink",
                 "elastic_respawn", "elastic_restore", "elastic_resume"):
        assert span in names, (span, sorted(names))
    bundle = json.loads((tmp_path / "crash" / "bundle.json").read_text())
    assert bundle["dumps"]["2"]["reason"] == "chaos-kill"
    assert bundle["dumps"]["2"]["detail"] == "kill:rank=2,step=7"
    assert {d["reason"] for r, d in bundle["dumps"].items() if r != "2"} \
        == {"proc-failed"}


def test_elastic_across_fake_nodes_under_wire_chaos_bitexact(tmp_path):
    """The respawn job across two emulated nodes (coll/han's two levels,
    btl/tcp between the nodes) under drop and delay on the wire: only the
    killed rank is replaced, the job ends at width 4, bit for bit."""
    rep, ckpt, err = _run_elastic(
        tmp_path, 4, "kill:rank=2,step=7;drop:p=0.02;delay:ms=2,p=0.05",
        "respawn", extra_mca=(("otpu_chaos_seed", "1234"),),
        fake_nodes=2)
    assert rep["world_size"] == 4
    recs = _check_bitexact(rep, ckpt, 2)
    assert len(recs) == 1 and recs[0]["resume_step"] == 5
    assert "rank 2 failed (exit 7)" in err
    assert "failed (exit 1)" not in err, "a survivor was lost"


def test_elastic_shrink_only_degraded_width(tmp_path):
    rep, ckpt, _ = _run_elastic(tmp_path, 3, "kill:rank=1,step=6", "shrink")
    assert rep["world_size"] == 2, "shrink-only run changed width"
    recs = _check_bitexact(rep, ckpt, 1)
    assert all("respawn_ms" not in rec for rec in recs)


REVOKE_JOB = textwrap.dedent("""
    import sys, time
    import numpy as np
    PKG = sys.argv[1]
    if PKG == "torch":
        import ompi_tpu_torch as m
        from ompi_tpu_torch.api.errhandler import ERRORS_RETURN
        from ompi_tpu_torch.api.errors import RevokedError
        w = m.init(device="cpu")
    else:
        import ompi_tpu as m
        from ompi_tpu.api.errhandler import ERRORS_RETURN
        from ompi_tpu.api.errors import RevokedError
        w = m.init()
    d = w.dup()
    d.set_errhandler(ERRORS_RETURN)
    if w.rank == 0:
        # a receive from a live peer that never sends: rank 1 revokes
        req = d.irecv(np.zeros(4), source=1, tag=5)
        try:
            req.wait(timeout=10)
            out = "COMPLETED"
        except RevokedError:
            out = "REVOKED"
        except TimeoutError:
            out = "PENDING"
        print("RECV", out, flush=True)
    else:
        time.sleep(0.5)
        d.revoke()
    w.barrier()
    m.finalize()
""")


def test_revoke_completes_pending_receives_divergence_pinned(tmp_path):
    """ULFM's revoke completes the comm's pending operations with
    ERR_REVOKED (``comm_ft_revoke.c``).  The port does
    (``ob1._comm_revoked``); the reference leaves a posted receive from a
    live peer pending (the trainer's survivor that waits on a neighbour
    gone to recover then waits for the agreement's timeout)."""
    script = tmp_path / "revoke.py"
    script.write_text(REVOKE_JOB)
    got = {}
    for pkg, launcher in (("torch", "ompi_tpu_torch.tools.tpurun"),
                          ("jax", "ompi_tpu.tools.tpurun")):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("OTPU_RANK", None)
        env.pop("OTPU_NPROCS", None)
        r = subprocess.run([sys.executable, "-m", launcher, "-n", "2",
                            sys.executable, str(script), pkg],
                           capture_output=True, text=True, timeout=120,
                           cwd=REPO, env=env)
        assert r.returncode == 0, (pkg, r.stdout[-3000:], r.stderr[-3000:])
        got[pkg] = [ln.partition("] ")[2] for ln in r.stdout.splitlines()
                    if "RECV " in ln]
    assert got == {"torch": ["RECV REVOKED"], "jax": ["RECV PENDING"]}


HAN_REVOKE_JOB = textwrap.dedent("""
    import os, sys, threading
    import numpy as np
    PKG = sys.argv[1]
    if PKG == "torch":
        import ompi_tpu_torch as m
        from ompi_tpu_torch.api.errhandler import ERRORS_RETURN
        from ompi_tpu_torch.api.errors import RevokedError
        w = m.init(device="cpu")
    else:
        import ompi_tpu as m
        from ompi_tpu.api.errhandler import ERRORS_RETURN
        from ompi_tpu.api.errors import RevokedError
        w = m.init()
    done, in_bcast = threading.Event(), threading.Event()

    def watchdog():
        # still blocked: report it and leave (the reference never returns)
        if not done.wait(8):
            if in_bcast.is_set():
                print("BCAST PENDING", flush=True)
            os._exit(0)

    threading.Thread(target=watchdog, daemon=True).start()
    d = w.dup()
    d.set_errhandler(ERRORS_RETURN)
    d.barrier()             # coll/han builds its two levels here
    print("MODULE", type(getattr(d.c_coll["bcast"], "__self__", None))
          .__name__, flush=True)
    if w.rank == 0:
        # the root leaves the bcast and revokes: rank 1 waits in han's
        # node-local level, rank 2 in the leaders' level, rank 3 in its
        # node's, each on a live peer
        threading.Event().wait(0.5)
        d.revoke()
    else:
        in_bcast.set()
        try:
            d.bcast(np.zeros(4), root=0)
            print("BCAST COMPLETED", flush=True)
        except RevokedError:
            print("BCAST REVOKED", flush=True)
        in_bcast.clear()
    w.barrier()
    done.set()
    m.finalize()
""")


def test_revoke_reaches_han_sub_comms_divergence_pinned(tmp_path):
    """ULFM's revoke completes every pending operation of the comm, a
    collective's included.  The port revokes coll/han's sub-communicators
    with the comm (``ft_state.link_revocation``), so members blocked in
    either level on a live peer are released; the reference revokes the
    comm alone, and they wait there for ever (across emulated nodes its
    trainer's survivors then time out in the agreement)."""
    script = tmp_path / "han_revoke.py"
    script.write_text(HAN_REVOKE_JOB)
    got = {}
    for pkg, launcher in (("torch", "ompi_tpu_torch.tools.tpurun"),
                          ("jax", "ompi_tpu.tools.tpurun")):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("OTPU_RANK", None)
        env.pop("OTPU_NPROCS", None)
        r = subprocess.run([sys.executable, "-m", launcher, "-n", "4",
                            "--fake-nodes", "2", sys.executable,
                            str(script), pkg],
                           capture_output=True, text=True, timeout=120,
                           cwd=REPO, env=env)
        lines = [ln.partition("] ")[2] for ln in r.stdout.splitlines()]
        assert lines.count("MODULE HanModule") == 4, (pkg, r.stdout[-3000:],
                                                      r.stderr[-3000:])
        got[pkg] = sorted(ln for ln in lines if ln.startswith("BCAST "))
        if pkg == "torch":
            assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    assert got == {"torch": ["BCAST REVOKED"] * 3,
                   "jax": ["BCAST PENDING"] * 3}
