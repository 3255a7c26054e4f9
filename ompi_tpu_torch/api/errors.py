"""MPI error classes and exception types.

Copy of ``ompi_tpu/api/errors.py``: the reference's MPI_ERR_* table
(``ompi/include/mpi.h.in``) with the ULFM classes, the exceptions the API
raises (``ProcFailedError`` completes an RGET receive whose sender is gone)
and the user error classes (``MPI_Add_error_class`` and its family).
"""
from __future__ import annotations

import enum


class ErrorClass(enum.IntEnum):
    SUCCESS = 0
    ERR_BUFFER = 1
    ERR_COUNT = 2
    ERR_TYPE = 3
    ERR_TAG = 4
    ERR_COMM = 5
    ERR_RANK = 6
    ERR_REQUEST = 7
    ERR_ROOT = 8
    ERR_GROUP = 9
    ERR_OP = 10
    ERR_TOPOLOGY = 11
    ERR_DIMS = 12
    ERR_ARG = 13
    ERR_UNKNOWN = 14
    ERR_TRUNCATE = 15
    ERR_OTHER = 16
    ERR_INTERN = 17
    ERR_IN_STATUS = 18
    ERR_PENDING = 19
    ERR_KEYVAL = 20
    ERR_NO_MEM = 21
    ERR_INFO = 22
    ERR_INFO_KEY = 23
    ERR_INFO_VALUE = 24
    ERR_INFO_NOKEY = 25
    ERR_WIN = 26
    ERR_FILE = 27
    ERR_RMA_CONFLICT = 28
    ERR_RMA_SYNC = 29
    ERR_IO = 30
    ERR_NOT_SAME = 31
    ERR_AMODE = 32
    ERR_UNSUPPORTED_OPERATION = 33
    ERR_NO_SPACE = 34
    ERR_NO_SUCH_FILE = 35
    ERR_SPAWN = 36
    ERR_PORT = 37
    ERR_SERVICE = 38
    ERR_NAME = 39
    ERR_SESSION = 40
    # ULFM fault-tolerance classes
    ERR_PROC_FAILED = 75
    ERR_PROC_FAILED_PENDING = 76
    ERR_REVOKED = 77


class MpiError(Exception):
    """Raised by the ERRORS_RETURN-style paths and re-raised to Python."""

    def __init__(self, error_class: ErrorClass, message: str = ""):
        self.error_class = ErrorClass(error_class)
        super().__init__(f"{self.error_class.name}: {message}" if message
                         else self.error_class.name)


class ProcFailedError(MpiError):
    """A peer involved in the operation has failed (ULFM)."""

    def __init__(self, message: str = "", failed_ranks: tuple = ()):
        super().__init__(ErrorClass.ERR_PROC_FAILED, message)
        self.failed_ranks = failed_ranks


class RevokedError(MpiError):
    """The communicator has been revoked (ULFM)."""

    def __init__(self, message: str = ""):
        super().__init__(ErrorClass.ERR_REVOKED, message)


_user_classes: dict[int, str] = {}
_user_codes: dict[int, tuple[int, str]] = {}
_next_user = 100


def add_error_class(msg: str = "") -> int:
    """``MPI_Add_error_class``: allocate a user error class."""
    global _next_user
    cls = _next_user
    _next_user += 1
    _user_classes[cls] = msg or f"user error class {cls}"
    return cls


def add_error_code(error_class: int, msg: str = "") -> int:
    """``MPI_Add_error_code``: a code within a (user) class."""
    global _next_user
    code = _next_user
    _next_user += 1
    _user_codes[code] = (error_class, msg or f"user error code {code}")
    return code


def add_error_string(code: int, string: str) -> None:
    """``MPI_Add_error_string``."""
    if code in _user_classes:
        _user_classes[code] = string
    elif code in _user_codes:
        _user_codes[code] = (_user_codes[code][0], string)
    else:
        raise MpiError(ErrorClass.ERR_ARG, f"unknown error code {code}")


def error_string(error_class) -> str:
    """``MPI_Error_string``."""
    code = int(error_class)
    if code in _user_classes:
        return _user_classes[code]
    if code in _user_codes:
        return _user_codes[code][1]
    return ErrorClass(error_class).name


def error_class_of(code) -> int:
    """``MPI_Error_class``: map a code back to its class."""
    c = int(code)
    if c in _user_codes:
        return _user_codes[c][0]
    return c
