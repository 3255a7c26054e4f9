"""Weave scenarios for the three fixed race sites — with the fixes
REVERTED, so the explorer proves it re-finds each bug deterministically.

Copy of ``ompi_tpu/analysis/scenarios.py`` over the port's classes: the
staging pool of ``mca/accelerator/torch_acc.py``, btl/tcp's ``TcpBtl`` and
``_Conn``, and the port's sanitizer.  The fixed twins explore the
reference's number of schedules (14, 14 and 287): fewer means a declared
lock is no longer wrapped.

Every scenario here exists in two flavors:

- the **reverted** scenario carries a faithful reimplementation of the
  pre-fix code shape (the exact window the fix closed), with
  ``weave.pause()`` planted at the instants the original unlocked code
  could be preempted.  ``explore()`` must FAIL it and print a replayable
  schedule string.
- the **fixed twin** drives the same threads through the real (fixed)
  classes under weave-instrumented ``_guarded_by`` locks.  ``explore()``
  must exhaust the bounded schedule space with no failure.

The reverted classes are *deliberately buggy*: the otpu-verify static
layer flags them too (lock-discipline on the naked guarded mutations,
mpi-typestate guarded-handoff on the pop -> re-register window), which
is the point — each shape is re-detected both statically and
dynamically.  Their findings are carried in ``lint_suppressions.txt``
(the port's ``ompi_tpu_torch/lint_suppressions.txt``) with per-entry
justifications; everything else in this module is clean.

Run them all::

    python -m ompi_tpu_torch.analysis.scenarios    # expects revert=FAIL,
                                                   # fixed twin=PASS
    python -m ompi_tpu_torch.analysis.scenarios staging-checkout --replay \
        'staging-checkout@pb2:0.0.0.1.1.1.0'       # one exact schedule
"""
from __future__ import annotations

import weakref

import numpy as np

from ompi_tpu_torch.analysis import weave
from ompi_tpu_torch.mca.accelerator.torch_acc import _StagingPool
from ompi_tpu_torch.mca.btl.tcp import TcpBtl, _Conn
from ompi_tpu_torch.runtime.sanitizer import SanitizeError


# ---------------------------------------------------------------------------
# 1. staging checkout window (fix #1 reverted)
# ---------------------------------------------------------------------------

class _RevertedCheckoutPool(_StagingPool):
    """Fix #1 reverted: the checkout registration runs OUTSIDE the
    critical section that popped the owner from its free bin.  In the
    window the owner is observable as neither free nor checked out, so a
    stale concurrent release of the same owner passes the double-release
    guard and repools bytes that are in use (the staging aliasing family).
    """

    # same contract as the parent — redeclared so the static passes see
    # this module's (deliberately violated) guard declarations
    _guarded_by = {"_free": "_lock", "_out": "_lock",
                   "_adopted": "_lock", "_bytes": "_lock"}

    def acquire(self, shape, dtype):            # pre-fix shape
        shape = (int(shape),) if isinstance(shape, (int, np.integer)) \
            else tuple(int(s) for s in shape)
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize if shape \
            else dtype.itemsize
        cls = self._class_of(nbytes)
        raw = None
        with self._lock:
            dq = self._free.get(cls)
            if dq:
                raw = dq.pop()
                if not dq:
                    del self._free[cls]
                if raw.base is not None:
                    self._adopted.discard(id(raw.base))
                self._bytes -= raw.nbytes
        if raw is None:
            raw = np.empty(cls, np.uint8)
        weave.pause("staging.checkout-window")  # the revert's window
        return self._checkout_window(raw, shape, dtype)

    def _checkout_window(self, raw, shape, dtype):
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize \
            if shape else np.dtype(dtype).itemsize
        view = raw[:nbytes].view(dtype).reshape(shape)
        token = id(view)
        # naked guarded mutation: the pre-fix bug under test
        self._out[token] = (
            weakref.ref(view, lambda _r, t=token: self._purge(t)), raw)
        return view


class _PoolState:
    __slots__ = ("pool", "owner", "view")


def _staging_setup(pool_cls):
    def setup():
        s = _PoolState()
        s.pool = weave.instrument(pool_cls(max_bytes=1 << 20,
                                           enabled=True))
        s.owner = np.empty(4096, np.uint8)
        s.pool.release(s.owner)          # adopt into the free bin
        s.view = None
        return s
    return setup


def _staging_acquirer(s):
    s.view = s.pool.acquire(4096, np.uint8)
    s.view[:] = 7


def _staging_stale_release(s):
    try:
        s.pool.release(s.owner)          # the stale double release
    except SanitizeError:
        pass    # guard caught it — that is CORRECT behavior; only a
                # schedule where it slips through should fail


def _staging_check(s):
    other = s.pool.acquire(4096, np.uint8)
    other[:] = 0
    assert s.view is not None and int(s.view.sum()) == 7 * 4096, \
        "stale double release aliased the live checkout"


# ---------------------------------------------------------------------------
# 2. tcp rail lists without _conns_lock (fix #2 reverted)
# ---------------------------------------------------------------------------

class _RevertedDropBtl(TcpBtl):
    """Fix #2 reverted: ``_drop_conn`` mutates the per-rank rail
    list with no common lock.  Two threads dropping rails for one peer
    race the membership check against the remove: the loser's
    ``list.remove`` raises ValueError (or the rank-bin pop KeyErrors),
    exactly the corruption the ``_conns_lock`` fix closed."""

    _guarded_by = {"_by_rank": "_conns_lock", "_suspects": "_conns_lock"}

    def _drop_conn(self, conn):                 # pre-fix shape
        if conn.rank is None:
            return
        conns = self._by_rank.get(conn.rank)
        weave.pause("tcp.drop-check")           # check...
        if conns and conn in conns:
            weave.pause("tcp.drop-remove")      # ...then act
            conns.remove(conn)
            if not conns:
                self._by_rank.pop(conn.rank, None)
        self._suspects.append(conn.rank)


class _BtlState:
    __slots__ = ("btl", "conn")


def _tcp_setup(btl_cls):
    def setup():
        s = _BtlState()
        btl = btl_cls.__new__(btl_cls)
        btl_cls.__init__(btl)
        s.btl = weave.instrument(btl)
        conn = _Conn.__new__(_Conn)
        conn.rank = 3
        s.conn = conn
        with s.btl._conns_lock:
            s.btl._by_rank.setdefault(3, []).append(conn)
        return s
    return setup


def _tcp_dropper(s):
    s.btl._drop_conn(s.conn)


def _tcp_check(s):
    assert 3 not in s.btl._by_rank, "dropped rail list survived"


# ---------------------------------------------------------------------------
# 3. coord fence reply under _fence_cond (fix #3 reverted)
# ---------------------------------------------------------------------------

class _FenceModel:
    """The one-shot-fence late-arrival path, modeled with weave
    primitives: the reply to a slow-reading client is a blocking
    ``sendall`` that returns only when the client reads
    (``block('client0-reads')``), and the slow client reads only after
    its app-level dependency on rank 1's fence resolves — the cycle one
    lock-holder closes."""

    __slots__ = ("cond_lock", "fence_done", "arrived", "reverted")

    def __init__(self, reverted: bool):
        self.cond_lock = weave.make_lock("fence-cond")
        self.fence_done = set()
        self.arrived = set()
        self.reverted = reverted


def _fence_setup(reverted):
    def setup():
        return _FenceModel(reverted)
    return setup


def _fence_late_reply(s):
    # server: late arrival of rank 0 to a completed one-shot fence
    if s.reverted:
        with s.cond_lock:                       # pre-fix: reply rides
            s.fence_done.add("shutdown")        # under the cond
            weave.block("client0-reads")        # blocking sendall
    else:
        with s.cond_lock:                       # fixed: bookkeeping
            s.fence_done.add("shutdown")        # under the cond,
        weave.block("client0-reads")            # reply after release


def _fence_enter(s):
    # server: rank 1's fence arrival needs the cond
    with s.cond_lock:
        s.arrived.add(1)
    weave.signal("rank1-fenced")


def _fence_slow_client(s):
    # client 0 drains its socket only after rank 1's fence resolves
    weave.block("rank1-fenced")
    weave.signal("client0-reads")


def _fence_check(s):
    assert "shutdown" in s.fence_done and 1 in s.arrived


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _build() -> dict:
    return {
        "staging-checkout": weave.Scenario(
            "staging-checkout",
            _staging_setup(_RevertedCheckoutPool),
            [_staging_acquirer, _staging_stale_release],
            check=_staging_check, preemption_bound=2,
            description="staging fix reverted: checkout "
                        "registration outside the popping critical "
                        "section"),
        "staging-checkout-fixed": weave.Scenario(
            "staging-checkout-fixed",
            _staging_setup(_StagingPool),
            [_staging_acquirer, _staging_stale_release],
            check=_staging_check, preemption_bound=2,
            description="same threads on the real pool: no schedule "
                        "fails"),
        "tcp-conns": weave.Scenario(
            "tcp-conns",
            _tcp_setup(_RevertedDropBtl),
            [_tcp_dropper, _tcp_dropper],
            check=_tcp_check, preemption_bound=2,
            description="tcp fix reverted: rail-list drop with no "
                        "_conns_lock"),
        "tcp-conns-fixed": weave.Scenario(
            "tcp-conns-fixed",
            _tcp_setup(TcpBtl),
            [_tcp_dropper, _tcp_dropper],
            check=_tcp_check, preemption_bound=2,
            description="same double drop on the real btl: no schedule "
                        "fails"),
        "coord-fence": weave.Scenario(
            "coord-fence",
            _fence_setup(True),
            [_fence_late_reply, _fence_enter, _fence_slow_client],
            check=_fence_check, preemption_bound=1,
            description="coord fix reverted: blocking reply under "
                        "_fence_cond"),
        "coord-fence-fixed": weave.Scenario(
            "coord-fence-fixed",
            _fence_setup(False),
            [_fence_late_reply, _fence_enter, _fence_slow_client],
            check=_fence_check, preemption_bound=2,
            description="reply sent after the cond is released: no "
                        "schedule deadlocks"),
    }


SCENARIOS = _build()


def get(name: str) -> weave.Scenario:
    return SCENARIOS[name]


def expected_to_fail(name: str) -> bool:
    """Reverted scenarios must fail; their fixed twins must not."""
    return not name.endswith("-fixed")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m ompi_tpu_torch.analysis.scenarios",
        description="Explore (or replay) the reverted-race weave "
                    "scenarios")
    ap.add_argument("names", nargs="*", default=None,
                    help="Scenario names (default: all)")
    ap.add_argument("--replay", metavar="SCHEDULE",
                    help="Replay one exact schedule string instead of "
                         "exploring")
    ap.add_argument("--list", action="store_true",
                    help="List scenarios and exit")
    args = ap.parse_args(argv)
    if args.list:
        for name, sc in SCENARIOS.items():
            expect = "expect FAIL" if expected_to_fail(name) \
                else "expect pass"
            print(f"{name + ':':<26} [{expect}] {sc.description}")
        return 0
    names = args.names or list(SCENARIOS)
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        ap.error(f"unknown scenario(s): {', '.join(unknown)} "
                 f"(--list shows the catalog)")
    if args.replay:
        try:
            sname, _b, _c = weave.parse_schedule(args.replay)
        except ValueError as exc:
            ap.error(str(exc))
        if sname not in SCENARIOS:
            ap.error(f"schedule names unknown scenario {sname!r} "
                     f"(--list shows the catalog)")
        res = weave.replay(SCENARIOS[sname], args.replay)
        print(res.summary())
        return 0 if res.failed == expected_to_fail(sname) else 1
    bad = 0
    for name in names:
        res = weave.explore(SCENARIOS[name])
        ok = res.failed == expected_to_fail(name)
        print(("ok   " if ok else "BAD  ") + res.summary())
        if not ok:
            bad += 1
    return 1 if bad else 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
