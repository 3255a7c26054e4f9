"""The C entry points of ``ompi_tpu_torch/csrc`` against their ctypes
bindings in ``ompi_tpu_torch/ops/_build.py`` (runs on the CPU).

``ctypes`` passes whatever its ``argtypes`` list says: a list one short or
one long, or an int where the C side takes a pointer, is not refused, and
on the card the kernel then reads garbage arguments.  So every entry point
that ``_build.LIBRARIES`` names must be declared ``extern "C"`` in its
source with as many parameters as its argtypes list, each of the matching
kind: a pointer for ``c_void_p``, ``long long`` for ``c_longlong``, ``int``
for ``c_int``.
"""
import ctypes
import re

import pytest

from ompi_tpu_torch.ops import _build

_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_longlong: "long long",
          ctypes.c_int: "int"}


def _declarations(source: str) -> dict:
    """``extern "C"`` function name -> list of parameter declarations."""
    found = {}
    for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', source):
        params = [p.strip() for p in m.group(2).split(",") if p.strip()]
        found[m.group(1)] = params
    return found


def _kind(param: str) -> str:
    if "*" in param:
        return "pointer"
    words = param.split()[:-1]       # drop the parameter's name
    return " ".join(w for w in words if w not in ("const", "unsigned"))


def _mismatches(source: str, entries: dict) -> list:
    """Every way ``entries`` ({name: argtypes}) disagrees with ``source``."""
    decls, bad = _declarations(source), []
    for name, argtypes in entries.items():
        if name not in decls:
            bad.append(f"{name}: no extern \"C\" declaration")
            continue
        params = decls[name]
        if len(params) != len(argtypes):
            bad.append(f"{name}: {len(params)} parameters, {len(argtypes)} "
                       "argtypes")
            continue
        for i, (param, ctype) in enumerate(zip(params, argtypes)):
            if _kind(param) != _KINDS[ctype]:
                bad.append(f"{name}: parameter {i} {param!r} is bound as "
                           f"{ctype.__name__}")
    return bad


@pytest.mark.parametrize("library", sorted(_build.LIBRARIES))
def test_entry_points_match_their_argtypes(library):
    source, entries = _build.LIBRARIES[library]
    text = (_build.CSRC / source).read_text()
    assert entries
    assert _mismatches(text, entries) == []


@pytest.mark.parametrize("library", sorted(_build.LIBRARIES))
def test_every_entry_point_of_a_source_is_bound(library):
    """No ``extern "C"`` function of a source is left without argtypes."""
    source, entries = _build.LIBRARIES[library]
    decls = _declarations((_build.CSRC / source).read_text())
    assert sorted(decls) == sorted(entries)


@pytest.mark.parametrize("edit, what", [
    (lambda p: p[:-1], "parameters"),                     # one argtype short
    (lambda p: p + [ctypes.c_int], "parameters"),         # one too many
    (lambda p: [ctypes.c_int] + p[1:], "bound as c_int"),  # pointer as int
])
def test_a_mismatch_is_found(edit, what):
    source, entries = _build.LIBRARIES["ring_fused"]
    text = (_build.CSRC / source).read_text()
    name = "otpu_ring_seg"
    bad = _mismatches(text, {name: edit(list(entries[name]))})
    assert len(bad) == 1 and what in bad[0], bad
