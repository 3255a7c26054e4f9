"""The port's multi-host launch path, held against the reference's
``tests/test_multihost_launch.py`` (all five cases): ``tpurun --hostfile``
drives one child launcher a host; ``--launch-agent local`` runs the same
head → child → coordination-service protocol as plain subprocesses (real
child launchers, distinct node ids, one world through the head's
coordination service) without sshd, and a fake ssh shim checks the
default agent's contract.  ``_parse_hostfile`` and ``_assign_ranks`` are
held against the reference's functions on the same inputs.  The port's
ranks bind ``device="cpu"``.  Every subprocess has its own ``timeout=``.
"""
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from ompi_tpu.tools import tpurun as jrun
from ompi_tpu_torch.tools import tpurun as trun

REPO = Path(__file__).resolve().parent.parent
RING = [sys.executable, "-m", "ompi_tpu_torch.examples.ring", "--device",
        "cpu"]


def _tpurun(extra, timeout=150, env=None):
    env = dict(os.environ if env is None else env)
    for k in ("OTPU_RANK", "OTPU_NPROCS", "OTPU_COORD"):
        env.pop(k, None)
    p = subprocess.Popen(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=env, start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    return subprocess.CompletedProcess(p.args, p.returncode, out, err)


HOSTFILES = {
    "two_nodes": "nodeA slots=4\nnodeB slots=4\n",
    "comments": "# two emulated nodes\nalpha slots=2  # first\n\nbeta  slots=2\n",
    "default_slot": "one\ntwo slots=3\nthree\n",
    "extra_tokens": "h1 slots=2 max_slots=4\nh2 cpu=1 slots=1\n",
}


@pytest.mark.parametrize("name", sorted(HOSTFILES))
def test_parse_hostfile_matches_the_reference(tmp_path, name):
    hf = tmp_path / "h.txt"
    hf.write_text(HOSTFILES[name])
    assert trun._parse_hostfile(str(hf)) == jrun._parse_hostfile(str(hf))


def test_empty_hostfile_refused_like_the_reference(tmp_path):
    hf = tmp_path / "h.txt"
    hf.write_text("# nothing\n\n")
    with pytest.raises(SystemExit) as t:
        trun._parse_hostfile(str(hf))
    with pytest.raises(SystemExit) as j:
        jrun._parse_hostfile(str(hf))
    assert str(t.value) == str(j.value)


ASSIGN_CASES = [
    ([("a", 4), ("b", 4)], 8, False),
    ([("a", 2), ("b", 2)], 3, False),
    ([("a", 1), ("b", 1)], 4, True),
    ([("a", 3), ("b", 1), ("c", 2)], 11, True),
    ([("a", 0), ("b", 2)], 2, False),
    ([("a", 2)], 1, False),
]


@pytest.mark.parametrize("hosts,nprocs,over", ASSIGN_CASES)
def test_assign_ranks_matches_the_reference(hosts, nprocs, over):
    assert trun._assign_ranks(hosts, nprocs, over) == \
        jrun._assign_ranks(hosts, nprocs, over)


@pytest.mark.parametrize("hosts,nprocs", [([("a", 1), ("b", 1)], 4),
                                          ([("a", 0)], 1)])
def test_assign_ranks_refusals_match_the_reference(hosts, nprocs):
    with pytest.raises(SystemExit) as t:
        trun._assign_ranks(hosts, nprocs, False)
    with pytest.raises(SystemExit) as j:
        jrun._assign_ranks(hosts, nprocs, False)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("host", ["localhost", "127.0.0.1", "::1",
                                  "ghost-host-x"])
def test_is_local_host_matches_the_reference(host):
    assert trun._is_local_host(host) == jrun._is_local_host(host)


def test_hostfile_ring_end_to_end(tmp_path):
    """``tpurun --hostfile h.txt -n 8`` of the ring works end to end."""
    hf = tmp_path / "h.txt"
    hf.write_text("nodeA slots=4\nnodeB slots=4\n")
    r = _tpurun(["--hostfile", str(hf), "--launch-agent", "local", "-n", "8",
                 *RING])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "token now 0" in r.stdout
    assert r.stdout.count("exiting") == 8


def test_hostfile_node_ids_and_world(tmp_path):
    """Ranks land on their hosts (byslot), see distinct node ids, and
    still form ONE world through the head's coordination service."""
    hf = tmp_path / "hosts.txt"
    hf.write_text("# two emulated nodes\nalpha slots=2\nbeta  slots=2\n")
    script = tmp_path / "whoami.py"
    script.write_text(textwrap.dedent("""
        import os
        import numpy as np
        import ompi_tpu_torch
        w = ompi_tpu_torch.init(device="cpu")
        node = os.environ.get("OTPU_NODE_ID")
        out = w.allgather(np.array([w.rank], np.int64))
        print(f"RANK {w.rank} NODE {node} SUM "
              f"{int(np.asarray(out).sum())}")
        ompi_tpu_torch.finalize()
    """))
    r = _tpurun(["--hostfile", str(hf), "--launch-agent", "local",
                 "-n", "4", sys.executable, str(script)])
    assert r.returncode == 0, r.stdout + r.stderr
    lines = sorted(ln.split("] ", 1)[1] for ln in r.stdout.splitlines()
                   if "RANK" in ln)
    assert lines == [
        "RANK 0 NODE alpha SUM 6", "RANK 1 NODE alpha SUM 6",
        "RANK 2 NODE beta SUM 6", "RANK 3 NODE beta SUM 6"], lines


def test_hostfile_slot_guard_and_oversubscribe(tmp_path):
    hf = tmp_path / "small.txt"
    hf.write_text("one slots=1\ntwo slots=1\n")
    script = tmp_path / "ok.py"
    script.write_text("import ompi_tpu_torch as m; w = m.init(device='cpu'); "
                      "print('R', w.rank); m.finalize()")
    # 4 ranks > 2 slots: refused, like mpirun without --oversubscribe
    r = _tpurun(["--hostfile", str(hf), "--launch-agent", "local",
                 "-n", "4", sys.executable, str(script)])
    assert r.returncode != 0
    assert "oversubscribe" in (r.stdout + r.stderr)
    # with the flag the ranks wrap around the hosts
    r = _tpurun(["--hostfile", str(hf), "--launch-agent", "local",
                 "-n", "4", "--oversubscribe", sys.executable, str(script)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("R ") == 4


SHIM = textwrap.dedent("""
    import os, subprocess, sys

    def fail(msg):
        print("FAKESSH ASSERT:", msg, file=sys.stderr, flush=True)
        sys.exit(99)

    args = sys.argv[1:]
    # tpurun split the agent string into words; ours ends with the
    # ssh-style option so the whole ssh argv shape is exercised
    if args[:2] != ["-o", "BatchMode=yes"]:
        fail(f"agent words not forwarded: {args[:2]}")
    if len(args) != 4:
        fail(f"expected '<opts> <host> <command>', got {args}")
    host, command = args[2], args[3]
    if host not in ("ghostA", "ghostB"):
        fail(f"unexpected host {host}")
    wdir = os.environ["FAKESSH_WDIR"]
    if not command.startswith(f"cd {wdir} && "):
        fail(f"command must cd into the launch cwd: {command[:80]}")
    for needle in ("-m ompi_tpu_torch.tools.tpurun", "--child-of",
                   "--ranks", "--node-id " + host):
        if needle not in command:
            fail(f"{needle!r} missing from: {command}")
    if "OTPU_" in command:
        fail("identity must ride flags, not exported env")
    with open(os.environ["FAKESSH_LOG"], "a") as log:
        print(host, file=log, flush=True)
    # exec like sshd: a fresh login-ish env, nothing marshalled
    env = {k: v for k, v in os.environ.items()
           if k in ("PATH", "HOME", "LANG")}
    sys.exit(subprocess.run(["/bin/sh", "-c", command],
                            env=env).returncode)
""")


def test_fake_ssh_agent_contract(tmp_path):
    """The DEFAULT multi-host path (``--launch-agent ssh``) without sshd: a
    shim stands in for ssh and checks the contract the head relies on
    (``<agent words> <host> <ONE shell command>``, a ``cd`` into the launch
    directory first, the child described by its command line alone), then
    runs the command through a scrubbed environment."""
    shim = tmp_path / "fakessh.py"
    shim.write_text(SHIM)
    hf = tmp_path / "hosts.txt"
    hf.write_text("ghostA slots=2\nghostB slots=2\n")
    log = tmp_path / "shim.log"
    env = dict(os.environ, FAKESSH_LOG=str(log), FAKESSH_WDIR=str(REPO))
    r = _tpurun(["--hostfile", str(hf), "--launch-agent",
                 f"{sys.executable} {shim} -o BatchMode=yes",
                 "--remote-python", sys.executable, "-n", "4", *RING],
                env=env)
    assert "FAKESSH ASSERT" not in r.stderr, r.stderr
    assert r.returncode == 0, r.stdout + r.stderr
    assert "token now 0" in r.stdout, r.stdout
    assert r.stdout.count("exiting") == 4
    # one agent invocation a remote host
    assert sorted(log.read_text().split()) == ["ghostA", "ghostB"]


def test_hostfile_child_failure_tears_down(tmp_path):
    hf = tmp_path / "hosts.txt"
    hf.write_text("n1 slots=2\nn2 slots=2\n")
    script = tmp_path / "die.py"
    script.write_text(textwrap.dedent("""
        import sys, time
        import ompi_tpu_torch
        w = ompi_tpu_torch.init(device="cpu")
        if w.rank == 3:
            sys.exit(7)        # a rank on the SECOND child dies
        time.sleep(30)         # the others would sleep on
    """))
    r = _tpurun(["--hostfile", str(hf), "--launch-agent", "local",
                 "-n", "4", sys.executable, str(script)], timeout=120)
    # the child reports exit 7, the head tears the whole job down
    assert r.returncode == 7, r.stdout + r.stderr
    assert "terminated" in r.stderr


def test_child_failure_under_recovery_is_published(tmp_path):
    """The child launcher's recovery branch: a rank's death is published
    as ``proc_failed`` and its group runs on; the survivors see it."""
    hf = tmp_path / "hosts.txt"
    hf.write_text("n1 slots=2\nn2 slots=2\n")
    script = tmp_path / "ft.py"
    script.write_text(textwrap.dedent("""
        import os, time
        import ompi_tpu_torch
        from ompi_tpu_torch.ft import state
        w = ompi_tpu_torch.init(device="cpu")
        if w.rank == 3:
            os._exit(5)
        deadline = time.time() + 30
        while time.time() < deadline and not state.is_failed(3):
            time.sleep(0.05)
        print(f"SAW {w.rank} {state.is_failed(3)}", flush=True)
        os._exit(0)
    """))
    r = _tpurun(["--hostfile", str(hf), "--launch-agent", "local",
                 "--enable-recovery", "-n", "4", sys.executable,
                 str(script)], timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert sorted(ln.split("] ", 1)[1] for ln in r.stdout.splitlines()
                  if "SAW" in ln) == ["SAW 0 True", "SAW 1 True",
                                      "SAW 2 True"], r.stdout + r.stderr
    # the child launcher's report rides its output to the head
    assert "tpurun[child]: rank 3 failed (exit 5)" in r.stdout


def test_child_launcher_imports_no_torch():
    """The child launcher, like the head, never imports torch."""
    code = ("import sys; from ompi_tpu_torch.tools import tpurun; "
            "print('torch' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60, cwd=REPO)
    assert r.returncode == 0 and r.stdout.strip() == "False", r.stderr
