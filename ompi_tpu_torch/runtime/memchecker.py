"""memchecker — buffer-ownership checking (the valgrind-annotation analog).

Copy of ``ompi_tpu/runtime/memchecker.py`` (after the reference's
``opal/mca/memchecker/memchecker.h:25-52``):
the reference marks user buffers "owned by MPI" with valgrind client
requests so a data race with an in-flight nonblocking operation is caught
at the faulty access.  Python's analog is numpy's writeable flag: while a
rendezvous isend is in flight, the user's send buffer is flipped
read-only, so the classic bug — writing into a buffer before the request
completes — raises ``ValueError: assignment destination is read-only`` AT
THE RACY WRITE instead of silently corrupting the message.

Debug aid, off by default (``otpu_memchecker_enable=1``); eager sends
copy at post time and need no guard, exactly as the reference only
annotates buffers MPI still references.

Only a numpy send buffer is guarded, as in the reference.  A torch tensor,
on the CPU or the card, has no read-only flag and is staged to the host at
the send's entry, so the port leaves a tensor send buffer unguarded: a
racy write to it changes the tensor, never the message in flight.  The
reference's immutable ``jax.Array`` cannot race at all.
"""
from __future__ import annotations

import numpy as np

from ompi_tpu_torch.base.var import VarType, registry
from ompi_tpu_torch.runtime import sanitizer

_enable_var = registry.register(
    "memchecker", None, "enable", vtype=VarType.BOOL, default=False,
    help="Mark in-flight nonblocking send buffers read-only so user "
         "writes race-fail loudly (valgrind memchecker analog)")


def enabled() -> bool:
    # OTPU_SANITIZE=1 force-enables the guard: the sanitizer mode turns
    # every ownership invariant — this one included — into a hard check
    return bool(_enable_var.value) or sanitizer.enabled


def protect_send(req, buf) -> None:
    """Freeze ``buf`` until ``req`` completes (no-op when disabled or the
    buffer isn't a plain writable ndarray)."""
    if not enabled():
        return
    if not isinstance(buf, np.ndarray) or not buf.flags.writeable:
        return
    try:
        buf.setflags(write=False)
    except ValueError:
        return   # base array not owned: cannot guard this view

    def _release(_req) -> None:
        try:
            buf.setflags(write=True)
        except ValueError:
            pass

    req.on_complete(_release)
