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
and the memchecker's guard (forced on under the mode) read it too.  A trip
writes the flight recorder's ``sanitize`` dump on a thread of its own
(``sanitizer.py:59``): ``fail`` fires inside hot paths holding locks, and
the dump dials the coordination service for a clock offset.
"""
from __future__ import annotations

import os

#: read once at import; tpurun-spawned ranks inherit the launcher's env
enabled = os.environ.get("OTPU_SANITIZE", "").strip() not in ("", "0")


class SanitizeError(AssertionError):
    """An ownership/framing invariant the sanitizer enforces was broken."""


def fail(msg: str) -> None:
    try:
        # crash-time post-mortem (a no-op unless the flight recorder is
        # armed), off the caller's thread: the dump's seconds of blocking
        # coordination I/O must not run under the caller's locks
        import threading

        from ompi_tpu_torch.runtime import flight

        threading.Thread(target=flight.dump, args=("sanitize",),
                         kwargs={"detail": msg},
                         name="otpu-flight-sanitize",
                         daemon=True).start()
    except Exception:
        pass
    raise SanitizeError(msg)
