"""OTPU_SANITIZE=1 — the runtime half of the ownership and framing checks.

Copy of ``ompi_tpu/runtime/sanitizer.py``.  The mode turns the dynamic
invariants into hard assertions:

- the tcp wire's borrowed contract: after a borrowed send returns, no
  out-queue entry may still alias the caller's buffer;
- inbound framing asserts frame sanity before parse (a desynced stream
  fails at the first bad length, not three messages later);
- btl/tcp arms its crc32 frame variants on the send side, so silent wire
  corruption becomes a loud, attributed error.

The native progress reactor never engages under the sanitizer: its strict
checks run on the pure-Python lane.  ``enabled`` is a module bool read once
at import from the environment (``tpurun``'s ranks inherit it); every check
site is on an error path or behind ``if sanitizer.enabled``.  Tests may flip
``sanitizer.enabled`` directly (consumers read it at use time).  The
staging pool's release checks (a non-contiguous buffer, a double release)
and the memchecker's guard (forced on under the mode) read it too.  Not
copied: the flight recorder's crash dump on a trip (ROADMAP A 4.4).
"""
from __future__ import annotations

import os

#: read once at import; tpurun-spawned ranks inherit the launcher's env
enabled = os.environ.get("OTPU_SANITIZE", "").strip() not in ("", "0")


class SanitizeError(AssertionError):
    """An ownership/framing invariant the sanitizer enforces was broken."""


def fail(msg: str) -> None:
    raise SanitizeError(msg)
