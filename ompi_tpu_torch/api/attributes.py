"""Attribute keyvals on comm/datatype objects (``ompi/attribute/``):
keyval create/free with copy & delete callbacks, get/set/delete.

Copy of ``ompi_tpu/api/attributes.py``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from ompi_tpu_torch.base.containers import PointerArray

KEYVAL_INVALID = -1


def _dup_fn(obj, keyval, extra, value):
    return True, value


def _null_copy_fn(obj, keyval, extra, value):
    return False, None


def _null_delete_fn(obj, keyval, value, extra):
    pass


_keyvals = PointerArray(lowest_free=1)


class _Keyval:
    def __init__(self, copy_fn, delete_fn, extra_state):
        self.copy_fn = copy_fn or _null_copy_fn
        self.delete_fn = delete_fn or _null_delete_fn
        self.extra_state = extra_state


def keyval_create(copy_fn: Optional[Callable] = None,
                  delete_fn: Optional[Callable] = None,
                  extra_state: Any = None) -> int:
    return _keyvals.add(_Keyval(copy_fn, delete_fn, extra_state))


def keyval_free(keyval: int) -> None:
    _keyvals.remove(keyval)


DUP_FN = _dup_fn
NULL_COPY_FN = _null_copy_fn
NULL_DELETE_FN = _null_delete_fn


class AttributeHost:
    """Mixin giving an object MPI attribute semantics."""

    def _attrs(self) -> dict:
        if not hasattr(self, "_attributes"):
            self._attributes: dict[int, Any] = {}
        return self._attributes

    def attr_put(self, keyval: int, value: Any) -> None:
        if _keyvals.get(keyval) is None:
            raise KeyError(f"invalid keyval {keyval}")
        self._attrs()[keyval] = value

    def attr_get(self, keyval: int) -> tuple[bool, Any]:
        a = self._attrs()
        if keyval in a:
            return True, a[keyval]
        return False, None

    def attr_delete(self, keyval: int) -> None:
        kv: _Keyval = _keyvals.get(keyval)
        a = self._attrs()
        if keyval in a:
            if kv is not None:
                kv.delete_fn(self, keyval, a[keyval], kv.extra_state)
            del a[keyval]

    def _attrs_copy_to(self, other: "AttributeHost") -> None:
        """Run copy callbacks on dup (``ompi_attr_copy_all``)."""
        for keyval, value in list(self._attrs().items()):
            kv: _Keyval = _keyvals.get(keyval)
            if kv is None:
                continue
            keep, newval = kv.copy_fn(self, keyval, kv.extra_state, value)
            if keep:
                other._attrs()[keyval] = newval

    def _attrs_delete_all(self) -> None:
        for keyval in list(self._attrs()):
            self.attr_delete(keyval)
