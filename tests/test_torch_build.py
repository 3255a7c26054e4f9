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


#: the byte mover's entries, each with a counter pointer before its stream
MOVER_ENTRIES = {"otpu_ring_all_gather": "ring_copy",
                 "otpu_ring_all_gather_bidi": "ring_copy",
                 "otpu_ring_right_permute": "ring_copy",
                 "otpu_all_to_all": "exchange",
                 "otpu_all_to_all_v": "exchange",
                 "otpu_all_gather_v": "exchange"}


@pytest.mark.parametrize("entry", sorted(MOVER_ENTRIES))
def test_a_mover_entry_bound_without_its_counter_is_found(entry):
    """A mover entry ends ``(..., int vec, void* counter, void* stream)``:
    bound as it was before the counter (the counter's pointer dropped),
    or with the counter bound as an int, it is caught."""
    source, entries = _build.LIBRARIES[MOVER_ENTRIES[entry]]
    text = (_build.CSRC / source).read_text()
    argtypes = list(entries[entry])
    assert argtypes[-3:] == [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    assert _declarations(text)[entry][-2:] == ["void* counter", "void* stream"]
    short = _mismatches(text, {entry: argtypes[:-2] + argtypes[-1:]})
    assert len(short) == 1 and "parameters" in short[0], short
    as_int = _mismatches(text, {entry: argtypes[:-2] + [ctypes.c_int,
                                                        argtypes[-1]]})
    assert len(as_int) == 1 and "bound as c_int" in as_int[0], as_int


#: the mover libraries' probes of their round-robin pool, which take nothing
PROBES = {"otpu_ring_copy_tickets_dealt": "ring_copy",
          "otpu_exchange_tickets_dealt": "exchange"}


@pytest.mark.parametrize("entry", sorted(PROBES))
def test_a_pool_probe_bound_with_an_argument_is_found(entry):
    """A probe ``int f()`` is bound with no argtypes; bound with one it is
    caught."""
    source, entries = _build.LIBRARIES[PROBES[entry]]
    text = (_build.CSRC / source).read_text()
    assert entries[entry] == [] and _declarations(text)[entry] == []
    bad = _mismatches(text, {entry: [ctypes.c_int]})
    assert len(bad) == 1 and "parameters" in bad[0], bad
