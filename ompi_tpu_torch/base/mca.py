"""Modular Component Architecture: frameworks, components, priority selection.

Copy of ``ompi_tpu/base/mca.py`` re-pointed at this package: component
discovery imports the submodules of ``ompi_tpu_torch.mca.<fw>``, each
exporting a ``COMPONENT`` object (the analog of the reference's dlopen of
``mca_<fw>_<comp>.so``), applies the include/exclude selection list and
selects by priority.  Every framework registers its ``otpu_<fw>`` selection
var and ``otpu_<fw>_base_verbose`` stream var.
"""
from __future__ import annotations

import importlib
import pkgutil
import threading
from typing import Any, Optional

from ompi_tpu_torch.base import output as _output
from ompi_tpu_torch.base.var import VarType, registry

#: the package whose subpackages are the frameworks
MCA_PACKAGE = "ompi_tpu_torch.mca"


class Component:
    """Base class for MCA components.

    Subclasses set ``name``/``priority`` and may override ``register_vars``
    (register tunables), ``open``/``close`` (resource lifecycle) and
    ``init_query`` (return a module object, or ``None`` to opt out).
    Frameworks with per-object selection, like coll, add their own query
    hooks.
    """

    name: str = "base"
    priority: int = 0

    def __init__(self) -> None:
        self.framework: Optional["Framework"] = None
        self.opened = False

    def register_vars(self, fw: "Framework") -> None:  # pragma: no cover - hook
        pass

    def open(self) -> bool:
        """Return False to disqualify the component."""
        return True

    def close(self) -> None:  # pragma: no cover - hook
        pass

    def init_query(self) -> Optional[Any]:
        return self

    def register_var(self, name: str, **kw) -> Any:
        fw_name = self.framework.name if self.framework else ""
        return registry.register(fw_name, self.name, name, **kw)


class Framework:
    """A named plugin point holding competing components."""

    def __init__(self, name: str, description: str = "", multi_select: bool = False):
        self.name = name
        self.description = description
        self.multi_select = multi_select
        self.components: dict[str, Component] = {}
        self.available: list[Component] = []
        self.opened = False
        self._lock = threading.RLock()
        self.stream = _output.open_stream(name)
        self.select_var = registry.register(
            name, "", "",
            vtype=VarType.STRING, default="",
            help=f"Comma-separated components to use for the {name} framework "
                 f"(prefix with ^ to exclude instead)",
        )
        registry.register(
            name, "base", "verbose",
            vtype=VarType.INT, default=0,
            help=f"Verbosity for the {name} framework",
            on_set=lambda v, s=self.stream: _output.set_verbosity(s, v),
        )

    # -- registration / discovery ---------------------------------------
    def register(self, component: Component) -> Component:
        with self._lock:
            component.framework = self
            self.components[component.name] = component
        return component

    def discover(self) -> None:
        """Import ``ompi_tpu_torch.mca.<name>.*`` modules exporting ``COMPONENT``."""
        pkg_name = f"{MCA_PACKAGE}.{self.name}"
        try:
            pkg = importlib.import_module(pkg_name)
        except ImportError:
            return
        for info in pkgutil.iter_modules(pkg.__path__):
            if info.name.startswith("_") or info.name == "base":
                continue
            try:
                mod = importlib.import_module(f"{pkg_name}.{info.name}")
            except Exception as exc:  # component failing to import is skipped
                _output.output(self.stream, 1, "component %s failed import: %s",
                               info.name, exc)
                continue
            comp = getattr(mod, "COMPONENT", None)
            if comp is not None and comp.name not in self.components:
                self.register(comp)

    # -- selection -------------------------------------------------------
    def _filter(self) -> list[Component]:
        """Apply the include/exclude list from the ``otpu_<fw>`` var.

        Reference semantics (``mca_base_components_filter``): a plain list is
        an *exclusive include*; a ``^``-prefixed list excludes; mixing is an
        error.
        """
        spec = (self.select_var.value or "").strip()
        comps = list(self.components.values())
        if not spec:
            return comps
        negate = spec.startswith("^")
        names = [n.strip() for n in spec.lstrip("^").split(",") if n.strip()]
        if any(n.startswith("^") for n in names):
            _output.show_help("help-mca", "mixed-include-exclude",
                              framework=self.name, spec=spec)
            raise ValueError(f"cannot mix include and exclude in {self.name} = {spec!r}")
        if negate:
            return [c for c in comps if c.name not in names]
        return [c for c in comps if c.name in names]

    def open(self) -> None:
        with self._lock:
            if self.opened:
                return
            self.discover()
            self.available = []
            for comp in self._filter():
                comp.register_vars(self)
                try:
                    ok = comp.open()
                except Exception as exc:
                    _output.output(self.stream, 1, "component %s failed open: %s",
                                   comp.name, exc)
                    ok = False
                if ok:
                    comp.opened = True
                    self.available.append(comp)
                    _output.output(self.stream, 2, "component %s opened "
                                   "(priority %d)", comp.name, comp.priority)
            self.opened = True

    def _query(self, comp: Component):
        """init_query with the same failure-is-disqualification policy as open."""
        try:
            return comp.init_query()
        except Exception as exc:
            _output.output(self.stream, 1, "component %s failed init_query: %s",
                           comp.name, exc)
            return None

    def select(self) -> Optional[Component]:
        """The highest-priority available component answering init_query
        (single-select frameworks: pml, threads)."""
        with self._lock:
            if not self.opened:
                self.open()
            candidates = [c for c in self.available
                          if self._query(c) is not None]
            candidates.sort(key=lambda c: c.priority, reverse=True)
            chosen = candidates[0] if candidates else None
            if chosen is not None:
                _output.output(self.stream, 1, "selected component %s",
                               chosen.name)
            return chosen

    def select_all(self) -> list[Component]:
        """All available components in descending priority (multi-select fws)."""
        with self._lock:
            if not self.opened:
                self.open()
            out = [c for c in self.available if self._query(c) is not None]
            out.sort(key=lambda c: c.priority, reverse=True)
            return out

    def close(self) -> None:
        with self._lock:
            for comp in self.available:
                if comp.opened:
                    try:
                        comp.close()
                    finally:
                        comp.opened = False
            self.available = []
            self.opened = False


_frameworks: dict[str, Framework] = {}
_fw_lock = threading.Lock()


def framework(name: str, description: str = "", multi_select: bool = False) -> Framework:
    """Get-or-create the process-global framework singleton ``name``."""
    with _fw_lock:
        fw = _frameworks.get(name)
        if fw is None:
            fw = Framework(name, description, multi_select)
            _frameworks[name] = fw
        return fw


def all_frameworks() -> list[Framework]:
    with _fw_lock:
        return sorted(_frameworks.values(), key=lambda f: f.name)


def close_all() -> None:
    with _fw_lock:
        for fw in _frameworks.values():
            fw.close()


_output.register_help(
    "help-mca",
    "mixed-include-exclude",
    "The {framework} framework selection list {spec!r} mixes include and "
    "exclude entries; use either 'a,b' or '^a,b', not both.",
)
