"""weave — a systematic interleaving explorer for the declared-lock layer.

Copy of ``ompi_tpu/analysis/weave.py``; its runs arm the port's sanitizer.

Static passes prove what is provable from source; races live in the
*schedules*.  The three concurrency bugs of the scenarios (staging
checkout window, unguarded tcp rail lists, coord reply under the fence
condition) were each found by imagining one specific interleaving by
hand — weave enumerates the interleavings instead, CHESS-style:

- Scenario threads run fully **serialized**: exactly one thread executes
  between *yield points* (``pause()``, every :class:`WeaveLock`
  acquire/release, ``block()``/``signal()`` event edges).  With all
  scheduling decisions at yield points, a run is a pure function of its
  choice sequence — the *schedule*.
- The explorer drives a bounded-preemption DFS over schedules: the
  default policy runs each thread until it blocks; every alternative
  choice at a yield point costs one preemption, up to the scenario's
  bound.  Most real races need 1-2 preemptions (the CHESS result), so a
  small bound finds them in tens of schedules, deterministically.
- A failing run — uncaught exception, deadlock among ``must_finish``
  threads, or a failed ``check()`` — reports a **replayable schedule
  string** (``staging-checkout@pb2:0.0.1.1.0``).  :func:`replay` re-runs
  exactly that schedule; because execution is serialized, the failure
  reproduces every time.

Locks come from the same ``_guarded_by`` convention the lock-discipline
pass enforces: :func:`instrument` reads a class's declaration and swaps
the named plain-mutex attributes for :class:`WeaveLock` wrappers **only
while a run is active** (Condition guards are left untouched — model
their wait/notify protocol with ``block()``/``signal()``).  Outside a run every primitive is identity —
``instrument`` returns the object untouched, ``pause`` is an immediate
return, ``make_lock`` hands back a plain ``threading.RLock`` — so the
production hot paths never see a wrapper (pinned next to
``test_sanitizer_off_zero_overhead``).

Runs are wired to ``OTPU_SANITIZE``: the explorer arms
``sanitizer.enabled`` for the duration of every run, so the dynamic
ownership assertions (staging double-release, framing desync) act as
failure oracles inside the exploration; scenario threads that
*deliberately* provoke a guarded error swallow the expected
``SanitizeError`` — a schedule where the guard catches the bug is a
PASSING schedule, a schedule where it slips past is the race.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

__all__ = ["Scenario", "WeaveLock", "WeaveResult", "ReplayMismatch",
           "block", "explore", "format_schedule", "instrument",
           "make_lock", "parse_schedule", "pause", "replay", "signal",
           "active"]

RUNNABLE = "runnable"
DONE = "done"


class ReplayMismatch(Exception):
    """A forced schedule choice named a thread that is not runnable —
    the schedule string does not belong to this scenario/build."""


class _Killed(BaseException):
    """Raised inside leftover scenario threads during run teardown.
    BaseException so scenario code's ``except Exception`` can't eat it."""


@dataclass
class Scenario:
    """One weave-explorable situation.

    ``setup()`` builds the shared state (instrument locks here);
    ``threads`` are callables taking that state, each run as one
    serialized weave thread; ``check(state)`` (optional) asserts the
    invariant after all threads finish; ``must_finish`` names the thread
    indices whose failure to terminate is a deadlock (default: all).
    """

    name: str
    setup: Callable
    threads: Sequence[Callable]
    check: Optional[Callable] = None
    must_finish: Optional[Sequence[int]] = None
    preemption_bound: int = 2
    max_steps: int = 2000
    max_schedules: int = 20000
    description: str = ""

    def required(self) -> set:
        if self.must_finish is None:
            return set(range(len(self.threads)))
        return set(self.must_finish)


@dataclass
class WeaveResult:
    scenario: str
    failed: bool
    schedule: Optional[str] = None      # replayable string when failed
    kind: str = ""                      # exception|deadlock|check|step-limit
    error: Optional[BaseException] = None
    schedules: int = 0                  # schedules executed
    exhausted: bool = True              # full bounded space covered

    def summary(self) -> str:
        if not self.failed:
            return (f"weave[{self.scenario}]: PASS — {self.schedules} "
                    f"schedule(s), no failing interleaving"
                    + ("" if self.exhausted else " (budget hit)"))
        return (f"weave[{self.scenario}]: FAIL ({self.kind}: {self.error!r})"
                f" after {self.schedules} schedule(s)\n"
                f"  replay: {self.schedule}")


# ---------------------------------------------------------------------------
# schedule strings
# ---------------------------------------------------------------------------

def format_schedule(name: str, bound: int, choices: Sequence[int]) -> str:
    return f"{name}@pb{bound}:" + ".".join(str(c) for c in choices)


def parse_schedule(s: str) -> tuple[str, int, list[int]]:
    head, _, tail = s.partition(":")
    name, _, pb = head.partition("@pb")
    if not name or not pb.isdigit():
        raise ValueError(f"bad weave schedule string {s!r} "
                         "(want name@pb<bound>:c0.c1...)")
    choices = [int(c) for c in tail.split(".") if c != ""]
    return name, int(pb), choices


# ---------------------------------------------------------------------------
# the serialized run
# ---------------------------------------------------------------------------

_current: Optional["_Run"] = None


def active() -> Optional["_Run"]:
    """The in-flight run, or None — every public primitive is identity
    when this is None (the zero-overhead-off contract)."""
    return _current


class _WThread:
    __slots__ = ("idx", "fn", "thread", "go", "state", "waiting")

    def __init__(self, idx: int, fn):
        self.idx = idx
        self.fn = fn
        self.thread: Optional[threading.Thread] = None
        self.go = threading.Semaphore(0)
        self.state = RUNNABLE
        self.waiting = None         # ("lock", WeaveLock) | ("event", tag)


class WeaveLock:
    """Deterministic mutex (re-entrant, like the pool's RLock): acquire
    and full release are yield points; a thread waiting on a held lock
    is not runnable until the holder lets go."""

    __slots__ = ("_run", "name", "owner", "depth")

    def __init__(self, run: "_Run", name: str = "lock"):
        self._run = run
        self.name = name
        self.owner = None
        self.depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # non-blocking probes AND timed acquires keep their may-fail
        # contract: both become a choice point followed by
        # take-or-decline, so exploration reaches the real code's
        # timed-out fallback path instead of mis-reporting a deadlock
        if not blocking or (timeout is not None and timeout >= 0):
            return self._run._lock_try_acquire(self)
        self._run._lock_acquire(self)
        return True

    def release(self) -> None:
        self._run._lock_release(self)

    def locked(self) -> bool:
        return self.owner is not None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class _Run:
    def __init__(self, scenario: Scenario, prefix: Sequence[int]):
        self.scenario = scenario
        self.prefix = list(prefix)
        self.threads: list[_WThread] = []
        self.by_ident: dict[int, _WThread] = {}
        self.events: set = set()
        self.choices: list[int] = []
        self.options: list[list[int]] = []
        self.errors: list = []
        self.failure: Optional[tuple] = None     # (kind, error)
        self.ctl = threading.Semaphore(0)
        self.current: Optional[_WThread] = None
        self.killing = False
        self.state_obj = None

    # -- worker-side primitives ------------------------------------------
    def _me(self) -> Optional[_WThread]:
        return self.by_ident.get(threading.get_ident())

    def _yield(self, t: _WThread) -> None:
        if self.killing:
            # teardown already woke this thread once; a re-entry (e.g.
            # WeaveLock.__exit__ running while _Killed unwinds a with
            # block) must NOT park again — nobody will wake it
            raise _Killed()
        self.ctl.release()
        t.go.acquire()
        if self.killing:
            raise _Killed()

    def _yield_runnable(self, t: _WThread) -> None:
        """A pure choice point: the thread stays runnable."""
        t.waiting = None
        self._yield(t)

    def _lock_acquire(self, lock: WeaveLock) -> None:
        t = self._me()
        if t is None:                    # controller (setup/check phase)
            if lock.owner is None or lock.owner == "controller":
                lock.owner = "controller"
                lock.depth += 1
                return
            raise RuntimeError(
                f"weave lock '{lock.name}' still held by a scenario "
                "thread at check time")
        if lock.owner is t:
            lock.depth += 1              # re-entrant
            return
        t.waiting = ("lock", lock)
        self._yield(t)                   # scheduled only when free
        lock.owner = t
        lock.depth = 1

    def _lock_try_acquire(self, lock: WeaveLock) -> bool:
        """Non-blocking probe (``acquire(blocking=False)``): a choice
        point, then take-or-decline — never a wait.  Preserves the
        try-acquire semantics of instrumented code instead of silently
        turning the probe into a blocking wait."""
        t = self._me()
        if t is None:
            if lock.owner is None or lock.owner == "controller":
                lock.owner = "controller"
                lock.depth += 1
                return True
            return False
        if lock.owner is t:
            lock.depth += 1
            return True
        self._yield_runnable(t)          # let contenders race the probe
        if lock.owner is None:
            lock.owner = t
            lock.depth = 1
            return True
        return False

    def _lock_release(self, lock: WeaveLock) -> None:
        t = self._me()
        if t is None:
            lock.depth -= 1
            if lock.depth == 0:
                lock.owner = None
            return
        if lock.owner is not t:
            raise RuntimeError(
                f"weave lock '{lock.name}' released by thread "
                f"{t.idx} which does not hold it")
        lock.depth -= 1
        if lock.depth > 0:
            return
        lock.owner = None
        # full release is a yield point: the first instant a waiter
        # could jump in (the _HookLock family of races lives here)
        self._yield(t)

    # -- scheduling -------------------------------------------------------
    def _runnable(self, t: _WThread) -> bool:
        if t.state == DONE:
            return False
        if t.waiting is None:
            return True
        kind, what = t.waiting
        if kind == "lock":
            return what.owner is None
        return what in self.events       # ("event", tag)

    def _decide(self, runnable: list) -> _WThread:
        step = len(self.choices)
        if step < len(self.prefix):
            want = self.prefix[step]
            for t in runnable:
                if t.idx == want:
                    return t
            raise ReplayMismatch(
                f"schedule step {step} wants thread {want}, but only "
                f"{[t.idx for t in runnable]} are runnable — the "
                "schedule string does not match this scenario/build")
        if self.current is not None and self.current in runnable:
            return self.current          # default: run until blocked
        return runnable[0]

    def _worker(self, t: _WThread) -> None:
        t.go.acquire()
        if self.killing:
            t.state = DONE
            self.ctl.release()
            return
        try:
            t.fn(self.state_obj)
        except _Killed:
            pass
        except BaseException as exc:     # the failure oracle
            self.errors.append((t.idx, exc))
        finally:
            t.state = DONE
            self.ctl.release()

    def execute(self) -> None:
        global _current
        from ompi_tpu_torch.runtime import sanitizer

        prev_current, _current = _current, self
        prev_sanitize = sanitizer.enabled
        sanitizer.enabled = True         # OTPU_SANITIZE oracles armed
        try:
            self.state_obj = self.scenario.setup()
            for i, fn in enumerate(self.scenario.threads):
                t = _WThread(i, fn)
                t.thread = threading.Thread(
                    target=self._worker, args=(t,),
                    name=f"weave-{self.scenario.name}-{i}", daemon=True)
                self.threads.append(t)
            for t in self.threads:
                t.thread.start()
                self.by_ident[t.thread.ident] = t
            self._schedule_loop()
            self._teardown()
            if self.failure is None and self.scenario.check is not None:
                try:
                    self.scenario.check(self.state_obj)
                except BaseException as exc:
                    self.failure = ("check", exc)
        finally:
            sanitizer.enabled = prev_sanitize
            _current = prev_current

    def _schedule_loop(self) -> None:
        required = self.scenario.required()
        while True:
            undone = [t for t in self.threads if t.state != DONE]
            if not undone:
                break
            runnable = [t for t in undone if self._runnable(t)]
            if not runnable:
                stuck = sorted(t.idx for t in undone
                               if t.idx in required)
                if stuck:
                    self.failure = ("deadlock", RuntimeError(
                        f"threads {stuck} blocked with no runnable "
                        "thread: "
                        + ", ".join(self._describe(t) for t in undone)))
                break                    # optional threads may stay parked
            if len(self.choices) >= self.scenario.max_steps:
                self.failure = ("step-limit", RuntimeError(
                    f"run exceeded {self.scenario.max_steps} yield "
                    "points — livelock or unbounded loop"))
                break
            try:
                choice = self._decide(runnable)
            except ReplayMismatch as exc:
                self.failure = ("replay-mismatch", exc)
                break
            self.options.append(sorted(t.idx for t in runnable))
            self.choices.append(choice.idx)
            choice.waiting = None
            self.current = choice
            choice.go.release()
            self.ctl.acquire()
            if self.errors and self.failure is None:
                idx, exc = self.errors[0]
                self.failure = ("exception", exc)
                break

    def _describe(self, t: _WThread) -> str:
        if t.waiting is None:
            return f"t{t.idx}:runnable"
        kind, what = t.waiting
        label = what.name if kind == "lock" else what
        return f"t{t.idx}:waiting-{kind}({label})"

    def _teardown(self) -> None:
        self.killing = True
        for t in self.threads:
            if t.state != DONE:
                t.go.release()
                self.ctl.acquire()
        for t in self.threads:
            if t.thread is not None:
                t.thread.join(timeout=5.0)


# ---------------------------------------------------------------------------
# public primitives (identity when no run is active)
# ---------------------------------------------------------------------------

def pause(tag: str = "") -> None:
    """A pure yield point (plant at the instants a preempted thread
    would expose a window — the documented revert sites)."""
    run = _current
    if run is None:
        return
    t = run._me()
    if t is not None:
        run._yield(t)


def block(tag: str) -> None:
    """Park until :func:`signal` publishes ``tag`` (models externally
    gated blocking ops: a peer's read, a socket drain)."""
    run = _current
    if run is None:
        return
    t = run._me()
    if t is None:
        return
    while tag not in run.events:
        t.waiting = ("event", tag)
        run._yield(t)


def signal(tag: str) -> None:
    """Publish ``tag`` (and yield: waiters race the signaller's
    continuation)."""
    run = _current
    if run is None:
        return
    run.events.add(tag)
    t = run._me()
    if t is not None:
        run._yield(t)


def make_lock(name: str = "lock"):
    """A lock for scenario-local state: a :class:`WeaveLock` inside a
    run, a plain ``threading.RLock`` outside (identity-off)."""
    run = _current
    if run is None:
        return threading.RLock()
    return WeaveLock(run, name)


def instrument(obj):
    """Swap ``obj``'s ``_guarded_by``-declared lock attributes for
    :class:`WeaveLock` wrappers — ONLY while a run is active.  Outside a
    run this returns ``obj`` untouched (no wrapper on any Lock acquire:
    the zero-overhead-off pin)."""
    run = _current
    if run is None:
        return obj
    declared = getattr(type(obj), "_guarded_by", None)
    if not declared:
        return obj
    for lock_attr in sorted(set(declared.values())):
        cur = getattr(obj, lock_attr, None)
        if cur is None or isinstance(cur, WeaveLock):
            continue
        if hasattr(cur, "notify"):
            # a Condition guard (CoordServer's _kv_cond/_fence_cond
            # family): WeaveLock has no wait()/notify() — clobbering it
            # would crash the first wait mid-schedule.  Left untouched;
            # model condition protocols with block()/signal() instead
            # (the coord-fence scenario is the worked example).
            continue
        setattr(obj, lock_attr,
                WeaveLock(run, f"{type(obj).__name__}.{lock_attr}"))
    return obj


# ---------------------------------------------------------------------------
# exploration + replay
# ---------------------------------------------------------------------------

def _preemptions(choices: Sequence[int],
                 options: Sequence[Sequence[int]]) -> int:
    """Schedule cost: switching away from a still-runnable thread."""
    count = 0
    for i in range(1, len(choices)):
        if choices[i] != choices[i - 1] and choices[i - 1] in options[i]:
            count += 1
    return count


def _execute(scenario: Scenario, prefix: Sequence[int]) -> _Run:
    run = _Run(scenario, prefix)
    run.execute()
    return run


def explore(scenario: Scenario) -> WeaveResult:
    """Bounded-preemption DFS over schedules.  Returns on the FIRST
    failing schedule (with its replay string) or after covering the
    bounded space."""
    stack: list[tuple] = [()]
    executed = 0
    while stack:
        if executed >= scenario.max_schedules:
            return WeaveResult(scenario.name, False, schedules=executed,
                               exhausted=False)
        prefix = stack.pop()
        run = _execute(scenario, list(prefix))
        executed += 1
        if run.failure is not None:
            kind, error = run.failure
            return WeaveResult(
                scenario.name, True,
                schedule=format_schedule(scenario.name,
                                         scenario.preemption_bound,
                                         run.choices),
                kind=kind, error=error, schedules=executed)
        # branch: alternatives beyond the forced prefix, innermost last
        # so the DFS extends the deepest divergence first
        for i in range(len(prefix), len(run.choices)):
            opts = run.options[i]
            for alt in opts:
                if alt == run.choices[i]:
                    continue
                cand = tuple(run.choices[:i]) + (alt,)
                if _preemptions(cand, run.options[:i + 1]) \
                        <= scenario.preemption_bound:
                    stack.append(cand)
    return WeaveResult(scenario.name, False, schedules=executed)


def replay(scenario: Scenario, schedule: str) -> WeaveResult:
    """Re-run one exact schedule from its printed string.  The run is
    serialized, so a failing schedule fails identically every time."""
    name, bound, choices = parse_schedule(schedule)
    if name != scenario.name:
        raise ValueError(f"schedule is for scenario {name!r}, "
                         f"not {scenario.name!r}")
    run = _execute(scenario, choices)
    if run.failure is not None:
        kind, error = run.failure
        return WeaveResult(
            scenario.name, True,
            schedule=format_schedule(scenario.name, bound, run.choices),
            kind=kind, error=error, schedules=1)
    return WeaveResult(scenario.name, False, schedules=1)
