"""The port's multi-process examples run end to end under its ``tpurun``
(``--device cpu``), each report held against the JAX package's example on
the same configuration under the reference's ``tpurun``.

* ``hello``, ``connectivity`` under ``-n 3``: the same lines, the package
  name aside;
* ``partitioned_pingpong`` under ``-n 2``: every partition arrives and each
  rank's ``part_msgs`` / ``part_bytes`` are the reference's;
* ``trace_demo`` under ``-n 4``: the merged timeline and the skew report,
  and rank 0's live histogram pvars name the reference's cells with the
  same counts;
* ``profile_demo``: the analyzer's matched rounds and the ``otpu_perf
  --diff`` exit code are the reference's;
* ``moe_train_demo`` (the reference's ``CONF``): dispatched and dropped
  tokens, the blamed rank and ``YES`` are the reference's;
* ``elastic_train_demo``: the recovery resumes from the reference's step,
  the final parameters equal the reference's bit for bit, and ``YES``.

Every subprocess has a timeout; on expiry its process group is killed.
"""
import json
import os
import re
import signal
import subprocess
import sys
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("OTPU_RANK", "OTPU_NPROCS", "OTPU_COORD")}
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = REPO + (os.pathsep + path if path else "")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _run(argv: list, timeout: int = 120) -> str:
    """Run a command from the repo root; its stdout, or a failure."""
    p = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, cwd=REPO, env=_env(),
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    assert p.returncode == 0, out + err
    return out


def _port_job(n: int, example: str, *args, mca=()) -> str:
    return _run([sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-n",
                 str(n), *mca, sys.executable, "-m",
                 f"ompi_tpu_torch.examples.{example}", *CPU, *args])


def _reference_job(n: int, example: str, mca=()) -> str:
    return _run([sys.executable, "-m", "ompi_tpu.tools.tpurun", "-n", str(n),
                 *mca, sys.executable, os.path.join("examples",
                                                    f"{example}.py")])


def _port_demo(example: str) -> str:
    return _run([sys.executable, "-m", f"ompi_tpu_torch.examples.{example}",
                 *CPU], timeout=300)


def _reference_demo(example: str) -> str:
    return _run([sys.executable, os.path.join("examples", f"{example}.py")],
                timeout=300)


@pytest.mark.parametrize("example", ["hello", "connectivity"])
def test_lines_under_tpurun_match_reference(example):
    got = sorted(_port_job(3, example).splitlines())
    want = sorted(_reference_job(3, example).replace(
        "(ompi_tpu ", "(ompi_tpu_torch ").splitlines())
    assert got == want
    assert any(ln.startswith(("[0] Hello, world, I am 0 of 3",
                              "[0] connectivity OK: 3 ranks")) for ln in got)


def _part_counters(stdout: str) -> dict:
    return dict(re.findall(r"\[rank (\d)\] (part_msgs=\d+ part_bytes=\d+)",
                           stdout))


def test_partitioned_pingpong_matches_reference():
    got = _port_job(2, "partitioned_pingpong")
    want = _reference_job(2, "partitioned_pingpong")
    assert all(f"[rank 1] partition {p} arrived" in got for p in range(8))
    assert "[rank 1] complete" in got and "[rank 0] all partitions sent" in got
    assert _part_counters(got) == _part_counters(want)
    assert len(_part_counters(got)) == 2


def _hist_counts(stdout: str) -> dict:
    return dict(re.findall(r"pvar otpu_(trace_hist_\w+_count):(\d+)", stdout))


def test_trace_demo_matches_reference():
    with tempfile.TemporaryDirectory() as port_dir, \
            tempfile.TemporaryDirectory() as ref_dir:
        got = _port_job(4, "trace_demo", mca=(
            "--mca", "trace_enable", "1", "--mca", "trace_dir", port_dir))
        want = _reference_job(4, "trace_demo", mca=(
            "--mca", "trace_enable", "1", "--mca", "trace_dir", ref_dir))
        merged = json.load(open(os.path.join(port_dir, "trace_merged.json")))
        assert os.path.exists(os.path.join(port_dir, "trace_skew.txt"))
    events = merged["traceEvents"] if isinstance(merged, dict) else merged
    assert {e.get("pid") for e in events if "pid" in e} >= {0, 1, 2, 3}
    assert "live pvar histograms (otpu_info --pvars):" in got
    assert _hist_counts(got) == _hist_counts(want)
    assert _hist_counts(got)["trace_hist_allreduce_16k_count"] == "3"


def _profile_facts(stdout: str) -> tuple:
    rounds = re.search(r"(\d+) ranks, (\d+) matched collective rounds", stdout)
    code = re.search(r"otpu_perf --diff exit code: (\d+)", stdout)
    return rounds.groups(), code.group(1)


def test_profile_demo_matches_reference():
    got = _port_demo("profile_demo")
    want = _reference_demo("profile_demo")
    assert _profile_facts(got) == _profile_facts(want) == (("3", "30"), "3")
    assert "host-overhead decomposition" in got
    assert got.count("REGRESSED") == 2


def _moe_facts(stdout: str) -> tuple:
    tokens = re.search(r"dispatched (\d+) tokens, dropped (\d+)", stdout)
    blamed = re.search(r"critical path: rank (\d+) bounds", stdout)
    yes = re.search(r"hot-expert rank blamed: (\w+)", stdout)
    return tokens.groups(), blamed.group(1), yes.group(1)


def test_moe_train_demo_matches_reference():
    got, want = _port_demo("moe_train_demo"), _reference_demo("moe_train_demo")
    assert _moe_facts(got) == _moe_facts(want)
    assert _moe_facts(got)[1:] == ("2", "YES")


def _elastic_report(stdout: str) -> dict:
    line = next(ln for ln in stdout.splitlines() if "ELASTIC " in ln)
    return json.loads(line.split("ELASTIC ", 1)[1])


def test_elastic_train_demo_matches_reference():
    got = _port_demo("elastic_train_demo")
    want = _reference_demo("elastic_train_demo")
    assert "bit-exact vs failure-free restore: YES" in got
    assert "bit-exact vs failure-free restore: YES" in want
    g, w = _elastic_report(got), _elastic_report(want)
    assert g["w"] == w["w"] and g["step"] == w["step"] == 15
    assert g["world_size"] == w["world_size"] == 4
    first = ("detect_step", "resume_step", "world_size")
    assert [g["recoveries"][0][k] for k in first] == \
        [w["recoveries"][0][k] for k in first] == [7, 5, 4]
    assert g["device"] == "cpu"
