"""hook — init/finalize interposition framework.

Copy of ``ompi_tpu/mca/hook/__init__.py`` (after ``ompi/mca/hook/``, the
framework whose one shipping component, ``hook/comm_method``, prints the
selected transport matrix at init): components register callbacks that the
runtime invokes at well-known points; ``runtime/init.py`` runs the
``init`` point once the world is built.
"""
from __future__ import annotations

from ompi_tpu_torch.base import mca


def hook_framework() -> mca.Framework:
    return mca.framework("hook", "init/finalize interposition",
                         multi_select=True)


def run_hooks(point: str, *args) -> None:
    """Invoke every component's ``at_<point>`` callback; a failing hook is
    reported on the framework's stream and never fails the caller."""
    fw = hook_framework()
    for comp in fw.select_all():
        fn = getattr(comp, f"at_{point}", None)
        if fn is not None:
            try:
                fn(*args)
            except Exception as exc:
                from ompi_tpu_torch.base import output as _o

                _o.output(fw.stream, 1, "hook %s/%s failed: %s",
                          comp.name, point, exc)
