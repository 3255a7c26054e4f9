"""The port's static analyzer (``ompi_tpu_torch/analysis/``) held against
the JAX package's on the CPU:

* every fixture pair under ``tests/lint_fixtures/`` and every pass: the
  port reports the reference's findings (rule, path, line, column, symbol
  and message), and the good twins stay quiet for their own pass;
* the port's own tree: the port's analyzer and the reference's report the
  same findings over ``ompi_tpu_torch/``, and the same over ``ompi_tpu/``
  with the root baseline;
* the call graph: the load-bearing shapes resolve, a circular re-export is
  no crash, and ``module_name`` keys every port file by its dotted name
  (the reference keys them by bare stem, so ``base.py`` and every
  ``__init__.py`` collide there), while the JAX package's files get the
  reference's names;
* the lock declarations (``_guarded_by``/``_GUARDED_BY``) of every module
  are the reference's;
* weave: the toy races, the replay, the schedule string round trip, the
  lock wrappers, and identity outside a run on the port's staging pool;
* the scenarios over the port's classes: each reverted race fails with the
  reference's replay string, each fixed twin is exhausted clean in the
  reference's number of schedules (14, 14, 287), the reverted shapes are
  re-found statically, and the scenarios' CLI exits 0.
"""
import ast
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from ompi_tpu import analysis as janalysis
from ompi_tpu.analysis import callgraph as jcallgraph
from ompi_tpu.analysis import scenarios as jscenarios
from ompi_tpu.analysis import weave as jweave
from ompi_tpu_torch import analysis
from ompi_tpu_torch.analysis import callgraph, scenarios, weave

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "ompi_tpu_torch"
FIXTURES = Path(__file__).resolve().parent / "lint_fixtures"

PASSES = ["buffer-ownership", "lock-discipline", "hot-path",
          "observability", "mca-conformance", "view-escape",
          "mpi-typestate", "collective-matching"]

#: the pass each fixture pair was written for
OWN_PASS = {
    "buf_escape": "buffer-ownership", "buf_staging": "buffer-ownership",
    "coll_match": "collective-matching", "escape_ip": "view-escape",
    "hot": "hot-path", "lock_block": "lock-discipline",
    "lock_conflict": "lock-discipline", "lock_mut": "lock-discipline",
    "lock_order": "lock-discipline", "mca_case": "mca-conformance",
    "obs": "observability", "typestate": "mpi-typestate",
}


def _fixture_sides(name: str) -> dict:
    """The lint targets of a fixture, as the reference's tests lint them:
    bad and good apart (with the observability schema files beside each),
    the mca tree whole."""
    d = FIXTURES / name
    if name == "mca_case":
        return {"tree": [d]}
    extra = [d / f for f in ("spc.py", "telemetry.py", "profile.py",
                             "trace.py")] if name == "obs" else []
    sides = {"bad": [d / "bad.py", *extra]}
    if (d / "good.py").exists():
        sides["good"] = [d / "good.py", *extra]
    return sides


def _rows(pkg, paths, select=None, suppressions=None):
    res = pkg.lint([str(p) for p in paths], select=select,
                   suppressions=suppressions)
    assert not res.errors, res.errors
    return [(f.rule, f.path, f.line, f.col, f.symbol, f.message)
            for f in res.findings], res


def test_fixture_table_is_the_tree():
    assert sorted(OWN_PASS) == sorted(
        p.name for p in FIXTURES.iterdir() if p.is_dir())


@pytest.mark.parametrize("pass_name", PASSES)
@pytest.mark.parametrize("fixture", sorted(OWN_PASS))
def test_fixture_findings_match_the_reference(fixture, pass_name):
    for side, paths in _fixture_sides(fixture).items():
        port, _ = _rows(analysis, paths, select=[pass_name])
        ref, _ = _rows(janalysis, paths, select=[pass_name])
        assert port == ref, (side, port, ref)
        if pass_name != OWN_PASS[fixture]:
            continue
        if side == "good":
            assert port == [], port
        elif side == "tree":
            assert port and not any("/good_" in r[1] for r in port), port
        else:
            assert port, side


# -- the trees ---------------------------------------------------------------

def test_port_tree_findings_match_the_reference():
    """Over ``ompi_tpu_torch/`` with no baseline, both analyzers find the
    same nine: btl/tcp's pickle header, vprotocol's four registrations in
    its own group and the scenarios' reverted classes.  The port's
    root-aware call graph adds no finding."""
    port, _ = _rows(analysis, [PORT])
    ref, _ = _rows(janalysis, [PORT])
    assert port == ref
    assert len(port) == 9
    assert {(r[0], r[1].split("ompi_tpu_torch/", 1)[1]) for r in port} == {
        ("hot-path", "mca/btl/tcp.py"),
        ("mca-conformance", "mca/pml/vprotocol.py"),
        ("mpi-typestate", "analysis/scenarios.py"),
        ("lock-discipline", "analysis/scenarios.py")}


def test_reference_tree_lints_alike():
    """Over ``ompi_tpu/`` with the root baseline, the port's analyzer
    keeps and shelters what the reference's does: nothing kept, the same
    findings suppressed, no unused entry."""
    base = str(REPO / "lint_suppressions.txt")
    port, pres = _rows(analysis, [REPO / "ompi_tpu"],
                       suppressions=analysis.Suppressions.load(base))
    ref, rres = _rows(janalysis, [REPO / "ompi_tpu"],
                      suppressions=janalysis.Suppressions.load(base))
    assert port == ref == []
    assert pres.suppressed == [
        analysis.Finding(f.rule, f.path, f.line, f.col, f.message, f.symbol)
        for f in rres.suppressed]
    assert pres.files == rres.files > 100


# -- the call graph ----------------------------------------------------------

def _py_files(root: Path) -> list:
    return sorted(str(p.relative_to(REPO)) for p in root.rglob("*.py")
                  if "__pycache__" not in p.parts)


def test_module_names_are_dotted_from_the_ports_root():
    """Every port file gets its own dotted name, starting at the port's
    root; the reference keys them by stem, and they collide."""
    files = _py_files(PORT)
    names = [callgraph.module_name(f) for f in files]
    assert len(set(names)) == len(files)
    assert callgraph.module_name("ompi_tpu_torch/mca/btl/tcp.py") \
        == "ompi_tpu_torch.mca.btl.tcp"
    assert callgraph.module_name("/x/ompi_tpu_torch/ompi_tpu_torch/ops/"
                                 "__init__.py") == "ompi_tpu_torch.ops"
    ref = [jcallgraph.module_name(f) for f in files]
    assert ref[files.index("ompi_tpu_torch/mca/btl/tcp.py")] == "tcp"
    assert len(set(ref)) < len(files)
    # the JAX package and the fixture trees: the reference's keys
    for f in _py_files(REPO / "ompi_tpu") + _py_files(FIXTURES):
        assert callgraph.module_name(f) == jcallgraph.module_name(f), f


def test_callgraph_resolves_the_load_bearing_shapes():
    pkg = analysis.load_package(
        [str(PORT / "analysis"),
         str(PORT / "mca" / "accelerator" / "torch_acc.py")])
    graph = callgraph.build(pkg)
    mod = pkg.find("analysis/scenarios.py")
    info = graph.function_at(mod, "_RevertedCheckoutPool.acquire")
    calls = [n for n in ast.walk(info.node) if isinstance(n, ast.Call)]
    resolved = {graph.resolve_call(info, c).qual
                for c in calls if graph.resolve_call(info, c) is not None}
    assert "_RevertedCheckoutPool._checkout_window" in resolved
    assert "_StagingPool._class_of" in resolved
    assert callgraph.build(pkg) is graph


def test_callgraph_survives_circular_reexports(tmp_path):
    (tmp_path / "a.py").write_text(
        "from b import helper\n\ndef use(x):\n    return helper(x)\n")
    (tmp_path / "b.py").write_text("from a import helper\n")
    res = analysis.lint([str(tmp_path)],
                        select=["view-escape", "mpi-typestate"])
    assert not res.errors and not res.findings


def test_typestate_annotation_overrides_defaults(tmp_path):
    """The request automaton is read from the tree's ``_TYPESTATE``, in
    both packages alike."""
    (tmp_path / "request.py").write_text(
        '_TYPESTATE = {"create_active": ["fire"]}\n')
    (tmp_path / "use.py").write_text(
        "def f(comm, buf):\n    comm.fire(buf)\n")
    port, _ = _rows(analysis, [tmp_path], select=["mpi-typestate"])
    assert port == _rows(janalysis, [tmp_path], select=["mpi-typestate"])[0]
    assert len(port) == 1 and "'fire()' request is discarded" in port[0][5]
    (tmp_path / "request.py").write_text("_X = 1\n")
    assert _rows(analysis, [tmp_path], select=["mpi-typestate"])[0] == []


# -- the lock declarations ---------------------------------------------------

def _declarations(root: Path) -> dict:
    """{(module path, class or None): guard map} of every declaration."""
    out = {}
    for rel in _py_files(root):
        if "/analysis/" in rel:
            continue
        tree = ast.parse((REPO / rel).read_text())
        key = rel.split("/", 1)[1].replace("jax_acc", "torch_acc")
        for node in ast.walk(tree):
            body = node.body if isinstance(
                node, (ast.Module, ast.ClassDef)) else []
            for stmt in body:
                if isinstance(stmt, ast.Assign) and any(
                        getattr(t, "id", "") in ("_guarded_by",
                                                 "_GUARDED_BY")
                        for t in stmt.targets):
                    owner = getattr(node, "name", None)
                    out[(key, owner)] = ast.literal_eval(stmt.value)
    return out


def test_lock_declarations_are_the_references():
    """The same maps for the same attributes, module by module and class
    by class.  The port's progress engine has no low-priority list and
    cadence counter yet, so its map names only what it has."""
    port = _declarations(PORT)
    ref = _declarations(REPO / "ompi_tpu")
    assert set(port) == set(ref) and len(port) == 17
    key = ("runtime/progress.py", None)
    dropped = {a: ref[key][a] for a in set(ref[key]) - set(port[key])}
    assert dropped == {"_lp_callbacks": "_lock", "_counter": "_lock"}
    from ompi_tpu_torch.runtime import progress

    assert not any(hasattr(progress, a) for a in dropped)
    assert {k: {a: lk for a, lk in v.items() if k != key or a not in dropped}
            for k, v in ref.items()} == port
    for k in [("base/output.py", None), ("runtime/reactor.py", None),
              ("mca/btl/tcp.py", "_Conn"), ("mca/btl/tcp.py", "TcpBtl"),
              ("mca/pml/ob1.py", "Ob1Pml")]:
        assert port[k] == ref[k], k


# -- weave -------------------------------------------------------------------

class _Box:
    pass


def _toy_scenario(w, bound=2):
    def setup():
        s = _Box()
        s.counter = 0
        return s

    def bump(s):
        v = s.counter
        w.pause("rmw")
        s.counter = v + 1

    def check(s):
        assert s.counter == 2, f"lost update: {s.counter}"

    return w.Scenario("toy-rmw", setup, [bump, bump], check=check,
                      preemption_bound=bound)


def test_weave_finds_toy_race_and_replays_it():
    res = weave.explore(_toy_scenario(weave))
    assert res.failed and res.kind == "check"
    assert res.schedule and res.schedule.startswith("toy-rmw@pb2:")
    rep = weave.replay(_toy_scenario(weave), res.schedule)
    assert rep.failed and rep.kind == "check"
    assert rep.schedule == res.schedule
    ref = jweave.explore(_toy_scenario(jweave))
    assert (res.schedule, res.schedules) == (ref.schedule, ref.schedules)
    again = weave.explore(_toy_scenario(weave))
    assert (again.failed, again.schedule, again.schedules) \
        == (res.failed, res.schedule, res.schedules)


def test_weave_locked_twin_exhausts_clean():
    def setup():
        s = _Box()
        s.counter = 0
        s.lock = weave.make_lock("ctr")
        return s

    def bump(s):
        with s.lock:
            v = s.counter
            weave.pause("rmw")
            s.counter = v + 1

    def check(s):
        assert s.counter == 2

    res = weave.explore(weave.Scenario("toy-rmw-locked", setup, [bump, bump],
                                       check=check, preemption_bound=3))
    assert not res.failed and res.exhausted
    assert res.schedules > 1


def test_weave_detects_deadlock_with_description():
    def setup():
        s = _Box()
        s.a = weave.make_lock("a")
        s.b = weave.make_lock("b")
        return s

    def ab(s):
        with s.a:
            weave.pause("mid")
            with s.b:
                pass

    def ba(s):
        with s.b:
            weave.pause("mid")
            with s.a:
                pass

    sc = weave.Scenario("toy-deadlock", setup, [ab, ba], preemption_bound=1)
    res = weave.explore(sc)
    assert res.failed and res.kind == "deadlock"
    assert "waiting-lock" in str(res.error)
    rep = weave.replay(sc, res.schedule)
    assert rep.failed and rep.kind == "deadlock"


def test_weave_schedule_string_round_trip():
    s = weave.format_schedule("staging-checkout", 2, [0, 0, 1, 1, 0])
    assert s == "staging-checkout@pb2:0.0.1.1.0"
    assert weave.parse_schedule(s) == ("staging-checkout", 2,
                                       [0, 0, 1, 1, 0])
    with pytest.raises(ValueError):
        weave.parse_schedule("no-bound:0.1")
    res = weave.replay(_toy_scenario(weave), "toy-rmw@pb2:0.7.7.7")
    assert res.failed and res.kind == "replay-mismatch"
    with pytest.raises(ValueError):
        weave.replay(_toy_scenario(weave), "other-scenario@pb2:0")


@pytest.mark.parametrize("timed", [False, True])
def test_weave_try_and_timed_acquire_decline(timed):
    """``acquire(blocking=False)`` and ``acquire(timeout=...)`` on a held
    instrumented lock decline instead of parking."""
    def setup():
        s = _Box()
        s.lock = weave.make_lock("l")
        s.got = []
        return s

    def holder(s):
        with s.lock:
            weave.pause("held")
            weave.pause("held2")

    def prober(s):
        got = s.lock.acquire(timeout=0.5) if timed \
            else s.lock.acquire(blocking=False)
        s.got.append(got)
        if got:
            s.lock.release()

    res = weave.explore(weave.Scenario("probe", setup, [holder, prober],
                                       preemption_bound=2))
    assert not res.failed, res.summary()
    assert res.exhausted


def test_weave_instrument_skips_condition_guards():
    class _CondGuarded:
        _guarded_by = {"_kv": "_kv_cond", "_q": "_qlock"}

        def __init__(self):
            self._kv_cond = threading.Condition()
            self._qlock = threading.Lock()

    seen = {}

    def setup():
        obj = weave.instrument(_CondGuarded())
        seen["cond"] = obj._kv_cond
        seen["lock"] = obj._qlock
        return obj

    res = weave.explore(weave.Scenario("cond-skip", setup, [lambda s: None],
                                       preemption_bound=0))
    assert not res.failed
    assert isinstance(seen["cond"], threading.Condition)
    assert isinstance(seen["lock"], weave.WeaveLock)


def test_weave_primitives_are_identity_outside_a_run():
    from ompi_tpu_torch.mca.accelerator.torch_acc import _StagingPool

    assert weave.active() is None
    weave.pause("nothing")
    weave.signal("nothing")
    assert isinstance(weave.make_lock("plain"), type(threading.RLock()))
    pool = _StagingPool(max_bytes=1 << 20, enabled=True)
    before = pool._lock
    assert weave.instrument(pool) is pool
    assert pool._lock is before


def test_weave_teardown_leaves_no_threads_behind():
    t0 = time.monotonic()
    res = weave.explore(scenarios.get("coord-fence"))
    elapsed = time.monotonic() - t0
    assert res.failed and res.kind == "deadlock"
    leaked = [t.name for t in threading.enumerate()
              if t.name.startswith("weave-")]
    assert not leaked, leaked
    assert elapsed < 4.0, f"teardown stalled: {elapsed:.2f}s"


# -- the scenarios over the port's classes ----------------------------------

@pytest.mark.parametrize("name,kind,schedule", [
    ("staging-checkout", "check", "staging-checkout@pb2:0.0.0.1.1.1.0"),
    ("tcp-conns", "exception", "tcp-conns@pb2:0.0.1.1.1.0"),
    ("coord-fence", "deadlock", "coord-fence@pb1:0.0.1.2"),
])
def test_reverted_race_fails_with_the_references_schedule(name, kind,
                                                          schedule):
    res = weave.explore(scenarios.get(name))
    assert res.failed and res.kind == kind, res.summary()
    assert res.schedule == schedule
    ref = jweave.explore(jscenarios.get(name))
    assert (ref.kind, ref.schedule, ref.schedules) \
        == (kind, schedule, res.schedules)
    for _ in range(2):
        rep = weave.replay(scenarios.get(name), schedule)
        assert rep.failed and rep.kind == kind, rep.summary()


@pytest.mark.parametrize("name,schedules", [
    ("staging-checkout-fixed", 14), ("tcp-conns-fixed", 14),
    ("coord-fence-fixed", 287)])
def test_fixed_twin_exhausts_the_references_schedules(name, schedules):
    """Exact counts: a declared lock the instrumentation no longer wraps
    (a dropped ``_guarded_by``) explores fewer schedules."""
    res = weave.explore(scenarios.get(name))
    assert not res.failed, res.summary()
    assert res.exhausted and res.schedules == schedules
    assert jweave.explore(jscenarios.get(name)).schedules == schedules


def test_an_undeclared_lock_shrinks_the_fixed_twin(monkeypatch):
    """Without btl/tcp's declaration weave wraps no lock of the fixed
    twin: it 'passes' after 2 schedules instead of 14."""
    from ompi_tpu_torch.mca.btl.tcp import TcpBtl

    monkeypatch.setattr(TcpBtl, "_guarded_by", {})
    res = weave.explore(scenarios.get("tcp-conns-fixed"))
    assert not res.failed and res.schedules == 2


def test_reverted_shapes_refound_statically():
    """lock-discipline on the naked insert, mpi-typestate's guarded
    handoff on the pop -> re-register window; the real pool is clean."""
    res = analysis.lint([str(PORT / "analysis" / "scenarios.py")],
                        select=["mpi-typestate", "lock-discipline"])
    handoff = [f for f in res.findings if f.rule == "mpi-typestate"
               and "guarded handoff" in f.message]
    assert [f.symbol for f in handoff] == ["_RevertedCheckoutPool.acquire"]
    assert any(f.rule == "lock-discipline"
               and f.symbol == "_RevertedCheckoutPool._checkout_window"
               for f in res.findings), res.findings
    res = analysis.lint([str(PORT / "mca" / "accelerator" / "torch_acc.py")],
                        select=["mpi-typestate", "lock-discipline"])
    assert not res.findings, [f.format() for f in res.findings]


def _scenarios_cli(argv):
    return subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.analysis.scenarios", *argv],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO)))


def test_scenarios_cli_expectations_hold():
    r = _scenarios_cli([])
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("ok   ") == 6, r.stdout
    for s in ("staging-checkout@pb2:0.0.0.1.1.1.0",
              "tcp-conns@pb2:0.0.1.1.1.0", "coord-fence@pb1:0.0.1.2"):
        assert f"replay: {s}" in r.stdout
    for n in (14, 14, 287):
        assert f"PASS — {n} schedule(s)" in r.stdout
    r = _scenarios_cli(["--replay", "tcp-conns@pb2:0.0.1.1.1.0"])
    assert r.returncode == 0 and "FAIL" in r.stdout, r.stdout
    r = _scenarios_cli(["--list"])
    assert r.returncode == 0 and r.stdout.count("expect FAIL") == 3


def test_scenarios_cli_bad_input_is_friendly():
    for argv in (["no-such-scenario"],
                 ["--replay", "no-such-scenario@pb2:0.0"],
                 ["--replay", "not-a-schedule"]):
        r = _scenarios_cli(argv)
        assert r.returncode == 2, (argv, r.returncode, r.stderr)
        assert "Traceback" not in r.stderr, (argv, r.stderr)
