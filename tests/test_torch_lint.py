"""The port's lint gate and its ``otpu_lint`` CLI, held against the JAX
package's on the CPU:

* the gate, a twin of ``tests/test_lint_clean.py``: every pass over every
  file of ``ompi_tpu_torch/``, no finding, no parse error, no unused
  baseline entry, every entry justified, inside the same 20 s budget (the
  tree is linted once per module and the AST cache is reused);
* the baseline ``ompi_tpu_torch/lint_suppressions.txt`` carries exactly the
  port's deliberate families, each with its reason;
* the acceptance command ``python -m ompi_tpu_torch.tools.otpu_lint
  ompi_tpu_torch/`` exits 0 with ``0 finding(s)``;
* the framework cases of ``tests/test_lint.py`` on the port: the registry
  (the reference's eight passes, names and descriptions equal), the
  suppressions file's round trip, unused and malformed entries, partial
  runs, one parse a file, ``--list`` equal, the exit codes and
  ``--write-suppressions``, ``--parsable --timings``;
* the two defaults that diverge from the reference: the default path is
  the port's package and the default baseline is the package's own file,
  found from any directory.
"""
import ast as ast_mod
import contextlib
import io
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from ompi_tpu import analysis as janalysis
from ompi_tpu.tools import otpu_lint as jlint
from ompi_tpu_torch import analysis
from ompi_tpu_torch.tools import otpu_lint

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "ompi_tpu_torch"
BASELINE = PORT / "lint_suppressions.txt"
FIXTURES = Path(__file__).resolve().parent / "lint_fixtures"

PASSES = ["buffer-ownership", "lock-discipline", "hot-path",
          "observability", "mca-conformance", "view-escape",
          "mpi-typestate", "collective-matching"]


def _cli(module, argv, cwd=REPO, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", module, *argv],
                          capture_output=True, text=True, cwd=cwd,
                          timeout=timeout, env=env)


def _run_main(main, argv) -> tuple:
    """(exit code, stdout) of ``main(argv)`` in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def gate():
    """The whole package linted once against its baseline, timed."""
    sup = analysis.Suppressions.load(str(BASELINE))
    t0 = time.monotonic()
    res = analysis.lint([str(PORT)], suppressions=sup)
    return res, sup, time.monotonic() - t0


# -- the gate ---------------------------------------------------------------

def test_package_is_lint_clean_in_budget(gate):
    """Every pass over every package file, < 20 s (the reference's
    budget); on a blown budget the per-pass breakdown names the slow
    pass."""
    res, sup, elapsed = gate
    assert res.passes == 8
    assert res.files > 100          # the whole package, not a subtree
    assert not res.errors, [f.format() for f in res.errors]
    assert not res.findings, "\n".join(f.format() for f in res.findings)
    assert not sup.unused(), [
        f"{BASELINE}:{e.line_no} suppresses nothing — remove it"
        for e in sup.unused()]
    assert res.unused_suppressions(sup) == []
    assert elapsed < 20.0, (
        f"lint took {elapsed:.1f}s (budget 20s) — per-pass breakdown:\n"
        + res.format_timings())
    assert len(res.timings) == res.passes
    assert all(t >= 0 for _n, t in res.timings)


def test_baseline_carries_the_ports_deliberate_families(gate):
    """What the baseline shelters, finding by finding: btl/tcp's pickle
    header, vprotocol's own variable group (four registrations) and the
    three reverted scenario classes — the reference's families, on the
    port's paths."""
    res, _sup, _t = gate
    got = sorted((f.rule, f.path.replace(os.sep, "/").split(
        "ompi_tpu_torch/", 1)[1], f.symbol) for f in res.suppressed)
    assert got == sorted(
        [("hot-path", "mca/btl/tcp.py", "TcpBtl.send")]
        + [("mca-conformance", "mca/pml/vprotocol.py", "")] * 4
        + [("mpi-typestate", "analysis/scenarios.py",
            "_RevertedCheckoutPool.acquire"),
           ("lock-discipline", "analysis/scenarios.py",
            "_RevertedCheckoutPool._checkout_window"),
           ("lock-discipline", "analysis/scenarios.py",
            "_RevertedDropBtl._drop_conn"),
           ("lock-discipline", "analysis/scenarios.py",
            "_RevertedDropBtl._drop_conn")])


def test_baseline_entries_are_justified():
    """Every baseline entry carries a comment: either trailing on the line
    or in the comment block immediately above it."""
    lines = BASELINE.read_text().splitlines()
    entries = 0
    for i, raw in enumerate(lines):
        code = raw.split("#", 1)[0].strip()
        if not code:
            continue
        entries += 1
        has_trailing = "#" in raw
        has_block_above = i > 0 and lines[i - 1].strip().startswith("#")
        assert has_trailing or has_block_above, (
            f"{BASELINE}:{i + 1}: suppression {code!r} has no "
            "justification comment")
        assert code.split()[1].startswith("ompi_tpu_torch/"), code
    assert entries == 5


def test_acceptance_command_exits_zero():
    """The exact acceptance invocation, from the repo root."""
    r = _cli("ompi_tpu_torch.tools.otpu_lint", ["ompi_tpu_torch/"],
             timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 finding(s)" in r.stdout
    assert "0 unused suppression(s) [8 passes over" in r.stdout


# -- the two defaults (divergences from the reference) ----------------------

def test_default_path_is_the_port(monkeypatch):
    """With no path the port lints ``ompi_tpu_torch`` and the reference
    ``ompi_tpu``: the run covers every file of its own package."""
    monkeypatch.chdir(REPO)

    def n_files(pkg):
        return sum(f.endswith(".py") for root, dirs, files
                   in os.walk(REPO / pkg) for f in files
                   if "__pycache__" not in root and "/." not in root)

    for main, pkg in ((otpu_lint.main, "ompi_tpu_torch"),
                      (jlint.main, "ompi_tpu")):
        rc, out = _run_main(main, ["--select", "mca-conformance",
                                   "--no-suppressions"])
        assert out.rstrip().endswith(
            f"[1 passes over {n_files(pkg)} files]"), out


def test_default_baseline_is_the_packages_own(tmp_path):
    """The port's default baseline is ``ompi_tpu_torch/lint_suppressions.txt``
    wherever the CLI runs; the reference's is ``./lint_suppressions.txt``,
    so from another directory its btl/tcp finding is not sheltered.  The
    root baseline (the JAX package's) matches no port path."""
    assert Path(otpu_lint.DEFAULT_SUPPRESSIONS).resolve() == BASELINE
    assert jlint.DEFAULT_SUPPRESSIONS == "lint_suppressions.txt"
    r = _cli("ompi_tpu_torch.tools.otpu_lint",
             [str(PORT / "mca" / "btl" / "tcp.py"), "--select", "hot-path"],
             cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 finding(s), 1 suppressed" in r.stdout
    r = _cli("ompi_tpu.tools.otpu_lint",
             [str(REPO / "ompi_tpu" / "mca" / "btl" / "tcp.py"),
              "--select", "hot-path"], cwd=tmp_path)
    assert r.returncode == 1 and "[hot-path]" in r.stdout, r.stdout
    root = analysis.Suppressions.load(str(REPO / "lint_suppressions.txt"))
    res = analysis.lint([str(PORT / "mca" / "btl" / "tcp.py")],
                        select=["hot-path"], suppressions=root)
    assert [f.rule for f in res.findings] == ["hot-path"]


# -- the framework cases of tests/test_lint.py on the port ------------------

def test_registry_has_the_references_eight_passes():
    got = [(p.name, p.description) for p in analysis.all_passes()]
    assert [n for n, _d in got] == PASSES
    assert got == [(p.name, p.description) for p in janalysis.all_passes()]
    assert all(d for _n, d in got)


def test_suppressions_round_trip(tmp_path):
    res = analysis.lint([str(FIXTURES / "hot" / "bad.py")],
                        select=["hot-path"])
    findings = res.findings
    assert findings
    text = analysis.Suppressions.render(findings)
    assert text == janalysis.Suppressions.render(findings)
    sup = analysis.Suppressions.parse(text)
    res = analysis.lint([str(FIXTURES / "hot" / "bad.py")],
                        select=["hot-path"], suppressions=sup)
    assert not res.findings, res.findings
    assert len(res.suppressed) == len(findings)
    assert not sup.unused()
    p = tmp_path / "baseline.txt"
    p.write_text(text)
    sup2 = analysis.Suppressions.load(str(p))
    assert [(e.rule, e.path, e.symbol) for e in sup2.entries] \
        == [(e.rule, e.path, e.symbol) for e in sup.entries]


def test_suppressions_unused_and_malformed():
    sup = analysis.Suppressions.parse(
        "hot-path nonexistent/file.py:nowhere  # stale\n")
    res = analysis.lint([str(FIXTURES / "hot" / "good.py")],
                        select=["hot-path"], suppressions=sup)
    assert res.clean
    assert len(sup.unused()) == 1
    for pkg in (analysis, janalysis):
        with pytest.raises(ValueError):
            pkg.Suppressions.parse("too many words on this line\n")


def test_partial_runs_do_not_flag_out_of_scope_suppressions(tmp_path):
    """Linting one file with the port's baseline demands no baseline edit
    the run cannot justify; a full-scope run that stops matching does."""
    sup = analysis.Suppressions.load(str(BASELINE))
    coord = PORT / "rte" / "coord.py"
    res = analysis.lint([str(coord)], suppressions=sup)
    assert res.clean
    assert res.unused_suppressions(sup) == []
    r = _cli("ompi_tpu_torch.tools.otpu_lint", ["ompi_tpu_torch/rte/coord.py"])
    assert r.returncode == 0, r.stdout + r.stderr
    stale = analysis.Suppressions.parse(
        "observability ompi_tpu_torch/rte/coord.py  # stale\n")
    res = analysis.lint([str(coord)], suppressions=stale)
    assert len(res.unused_suppressions(stale)) == 1


def test_ast_cache_parses_each_file_once(monkeypatch):
    analysis._ast_cache.clear()
    calls = []
    real_parse = ast_mod.parse
    monkeypatch.setattr(
        ast_mod, "parse",
        lambda *a, **kw: calls.append(1) or real_parse(*a, **kw))
    target = str(FIXTURES / "hot")
    analysis.lint([target])              # all passes share one parse
    assert len(calls) == 2               # bad.py + good.py
    analysis.lint([target])              # second run: pure cache hits
    assert len(calls) == 2


def test_cli_list_matches_the_reference():
    for argv in (["--list"], ["--list", "--parsable"]):
        rcs, outs = zip(*(_run_main(m, argv)
                          for m in (otpu_lint.main, jlint.main)))
        assert rcs == (0, 0) and outs[0] == outs[1]
    assert [ln.split(":", 1)[0] for ln in outs[0].splitlines()] == PASSES


def test_cli_exit_codes_and_written_baseline(tmp_path):
    """Findings exit 1; a baseline written by ``--write-suppressions``
    and fed back exits 0; the findings print as the reference's."""
    bad_dir = str(FIXTURES / "hot")
    r = _cli("ompi_tpu_torch.tools.otpu_lint", [bad_dir, "--no-suppressions"])
    assert r.returncode == 1 and "[hot-path]" in r.stdout
    rc, ref = _run_main(jlint.main, [bad_dir, "--no-suppressions"])
    assert rc == 1 and r.stdout == ref
    base = tmp_path / "base.txt"
    r = _cli("ompi_tpu_torch.tools.otpu_lint",
             [bad_dir, "--write-suppressions", str(base)])
    assert r.returncode == 0, r.stdout + r.stderr
    r = _cli("ompi_tpu_torch.tools.otpu_lint",
             [bad_dir, "--suppressions", str(base)])
    assert r.returncode == 0, r.stdout + r.stderr
    rc, _ = _run_main(otpu_lint.main, [bad_dir, "--select", "no-such-pass"])
    assert rc == 1


def test_lint_parsable_timings_keep_stdout_clean():
    """``--timings`` under ``--parsable`` rides on stderr."""
    r = _cli("ompi_tpu_torch.tools.otpu_lint",
             [str(FIXTURES / "hot" / "good.py"), "--no-suppressions",
              "--parsable", "--timings"])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ms" not in r.stdout, r.stdout
    assert "total:" in r.stderr, r.stderr
