"""Error handlers (``ompi/errhandler/errhandler.c``).

Copy of ``ompi_tpu/api/errhandler.py``: ERRORS_ARE_FATAL, ERRORS_RETURN
(raise to Python), ERRORS_ABORT and user handlers.  A fatal handler calls
``runtime.init.abort``.
"""
from __future__ import annotations

import sys
from typing import Callable, Optional

from ompi_tpu_torch.api.errors import MpiError


class Errhandler:
    def __init__(self, name: str, fn: Optional[Callable] = None):
        self.name = name
        self._fn = fn

    def invoke(self, obj, error: MpiError) -> None:
        if self._fn is not None:
            self._fn(obj, error.error_class)
            return
        if self.name == "ERRORS_RETURN":
            raise error
        # ERRORS_ARE_FATAL / ERRORS_ABORT
        print(f"[ompi_tpu_torch] fatal error on {obj!r}: {error}",
              file=sys.stderr)
        from ompi_tpu_torch.runtime import init as rt

        rt.abort(obj, int(error.error_class))


ERRORS_ARE_FATAL = Errhandler("ERRORS_ARE_FATAL")
ERRORS_RETURN = Errhandler("ERRORS_RETURN")
ERRORS_ABORT = Errhandler("ERRORS_ABORT")


def create(fn: Callable) -> Errhandler:
    return Errhandler(f"user_{id(fn):x}", fn)
