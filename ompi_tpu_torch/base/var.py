"""Typed variable (config/flag) registry — the port's single tunable surface.

Copy of ``ompi_tpu/base/var.py`` (the JAX package's registry) cut to what
the port uses: every tunable is a registered typed variable addressable as
``otpu_<framework>_<component>_<name>``, settable (in increasing priority)
from defaults, parameter files named by ``OTPU_PARAM_FILES``, the
environment (``OTPU_MCA_<name>``), the command line (``--mca <name>
<value>``) and the API, with source tracking.  Both packages read the same
``OTPU_MCA_*`` names, each through its own registry.  Performance
variables (pvars, ``opal/mca/base/mca_base_pvar.c``) back the SPC counters
(``runtime/spc.py``).
"""
from __future__ import annotations

import enum
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

ENV_PREFIX = "OTPU_MCA_"
PARAM_FILE_ENV = "OTPU_PARAM_FILES"


class VarSource(enum.IntEnum):
    """Where a variable's current value came from; higher sources win."""

    DEFAULT = 0
    FILE = 1
    ENV = 2
    CLI = 3
    API = 4


class VarType(enum.Enum):
    INT = "int"
    UNSIGNED = "unsigned"
    SIZE = "size"        # accepts 16k / 4m / 1g suffixes
    FLOAT = "float"
    BOOL = "bool"
    STRING = "string"
    LIST = "list"        # comma-separated string list


class VarScope(enum.Enum):
    CONSTANT = "constant"      # never settable
    READONLY = "readonly"      # settable only before init
    LOCAL = "local"            # settable any time, affects this process
    ALL = "all"                # settable any time, should match across ranks


_runtime_init_flag = False


def mark_runtime_initialized(state: bool = True) -> None:
    """Called by the runtime init/finalize state machine; freezes READONLY vars."""
    global _runtime_init_flag
    _runtime_init_flag = state


_SIZE_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}
_TRUE = {"1", "true", "yes", "on", "enabled", "t", "y"}
_FALSE = {"0", "false", "no", "off", "disabled", "f", "n"}


def _convert(vtype: VarType, raw: Any, enum_values: Optional[dict] = None) -> Any:
    if enum_values is not None:
        if isinstance(raw, str) and raw in enum_values:
            return raw
        # allow setting by enum integer value
        for k, v in enum_values.items():
            if str(raw) == str(v):
                return k
        raise ValueError(f"invalid enum value {raw!r}; choices: {sorted(enum_values)}")
    if vtype is VarType.INT or vtype is VarType.UNSIGNED:
        val = int(str(raw), 0)
        if vtype is VarType.UNSIGNED and val < 0:
            raise ValueError(f"negative value {val} for unsigned var")
        return val
    if vtype is VarType.SIZE:
        s = str(raw).strip().lower()
        if s and s[-1] in _SIZE_SUFFIX:
            return int(float(s[:-1]) * _SIZE_SUFFIX[s[-1]])
        return int(s, 0)
    if vtype is VarType.FLOAT:
        return float(raw)
    if vtype is VarType.BOOL:
        if isinstance(raw, bool):
            return raw
        s = str(raw).strip().lower()
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
        raise ValueError(f"invalid boolean {raw!r}")
    if vtype is VarType.LIST:
        if isinstance(raw, (list, tuple)):
            return list(raw)
        return [p for p in str(raw).split(",") if p]
    return str(raw)


@dataclass
class Var:
    """One registered tunable."""

    name: str                      # full name: otpu_<fw>_<comp>_<var>
    vtype: VarType
    default: Any
    help: str = ""
    scope: VarScope = VarScope.LOCAL
    enum_values: Optional[dict] = None   # {name: int} when enum-typed
    aliases: tuple = ()
    group: str = ""                # "<framework>" or "<framework>/<component>"
    _value: Any = None
    _source: VarSource = VarSource.DEFAULT
    _source_detail: str = ""
    on_set: Optional[Callable[[Any], None]] = None

    @property
    def value(self) -> Any:
        return self._value

    @property
    def source(self) -> VarSource:
        return self._source

    def _set(self, raw: Any, source: VarSource, detail: str = "") -> bool:
        """Apply a value if ``source`` outranks the current source."""
        if self.scope is VarScope.CONSTANT and source is not VarSource.DEFAULT:
            return False
        if (self.scope is VarScope.READONLY and source is VarSource.API
                and _runtime_init_flag):
            raise RuntimeError(
                f"variable {self.name} is read-only after runtime init")
        if source < self._source:
            return False
        self._value = _convert(self.vtype, raw, self.enum_values)
        self._source = source
        self._source_detail = detail
        if self.on_set is not None:
            self.on_set(self._value)
        return True

    def set(self, raw: Any) -> None:
        self._set(raw, VarSource.API, "api")


class PvarClass(enum.Enum):
    """Performance-variable classes (``mca_base_pvar.h`` equivalents)."""

    COUNTER = "counter"
    TIMER = "timer"
    LEVEL = "level"
    SIZE = "size"
    HIGHWATERMARK = "highwatermark"
    LOWWATERMARK = "lowwatermark"
    STATE = "state"
    AGGREGATE = "aggregate"


@dataclass
class Pvar:
    """A performance variable (copy of ``ompi_tpu/base/var.py:Pvar``)."""

    name: str
    pclass: PvarClass
    help: str = ""
    bind: str = ""                 # object class this binds to ("comm", ...)
    on_read: Optional[Callable] = None   # pre-read hook (flush deferred adds)
    _value: float = 0
    _touched: bool = False
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def add(self, delta: float = 1) -> None:
        with self._lock:
            self._value += delta
            self._touched = True

    def add_relaxed(self, delta: float = 1) -> None:
        """Unlocked add for hot paths; racing adds may drop counts (the
        reference's SPC counters make the same accuracy/cost trade)."""
        self._value += delta
        self._touched = True

    def set(self, value: float) -> None:
        with self._lock:
            if self.pclass is PvarClass.HIGHWATERMARK:
                self._value = max(self._value, value) if self._touched else value
            elif self.pclass is PvarClass.LOWWATERMARK:
                self._value = min(self._value, value) if self._touched else value
            else:
                self._value = value
            self._touched = True

    def read(self) -> float:
        if self.on_read is not None:
            self.on_read()
        return self._value

    def reset(self) -> None:
        if self.on_read is not None:
            self.on_read()   # fold deferred adds in before zeroing
        with self._lock:
            self._value = 0
            self._touched = False


class VarRegistry:
    """Process-global registry of vars and pvars with reflection."""

    def __init__(self) -> None:
        self._vars: dict[str, Var] = {}
        self._alias: dict[str, str] = {}
        self._pvars: dict[str, Pvar] = {}
        self._cli: dict[str, str] = {}
        self._file: dict[str, tuple[str, str]] = {}  # name -> (value, path)
        self._files_loaded = False
        self._lock = threading.RLock()

    def register(
        self,
        framework: str,
        component: str,
        name: str,
        *,
        vtype: VarType = VarType.STRING,
        default: Any = None,
        help: str = "",
        scope: VarScope = VarScope.LOCAL,
        enum_values: Optional[dict] = None,
        aliases: Iterable[str] = (),
        on_set: Optional[Callable[[Any], None]] = None,
    ) -> Var:
        parts = [p for p in ("otpu", framework, component, name) if p]
        full = "_".join(parts)
        with self._lock:
            if full in self._vars:
                return self._vars[full]
            var = Var(
                name=full,
                vtype=vtype,
                default=default,
                help=help,
                scope=scope,
                enum_values=enum_values,
                aliases=tuple(aliases),
                group="/".join(p for p in (framework, component) if p),
                on_set=on_set,
            )
            if default is not None:
                var._set(default, VarSource.DEFAULT, "default")
            self._vars[full] = var
            for a in var.aliases:
                self._alias[a] = full
            self._apply_external(var)
            return var

    def register_pvar(
        self,
        framework: str,
        component: str,
        name: str,
        *,
        pclass: PvarClass = PvarClass.COUNTER,
        help: str = "",
        bind: str = "",
    ) -> Pvar:
        parts = [p for p in ("otpu", framework, component, name) if p]
        full = "_".join(parts)
        with self._lock:
            if full not in self._pvars:
                self._pvars[full] = Pvar(name=full, pclass=pclass, help=help,
                                         bind=bind)
            return self._pvars[full]

    # -- external sources ------------------------------------------------
    def _load_files(self) -> None:
        if self._files_loaded:
            return
        self._files_loaded = True
        env_files = os.environ.get(PARAM_FILE_ENV, "")
        for path in (p for p in env_files.split(os.pathsep) if p):
            try:
                with open(path) as f:
                    for line in f:
                        line = line.strip()
                        if not line or line.startswith("#") or "=" not in line:
                            continue
                        k, v = line.split("=", 1)
                        self._file[k.strip()] = (v.strip(), path)
            except OSError:
                continue

    def parse_cli(self, argv: list[str]) -> list[str]:
        """Consume ``--mca <name> <value>`` pairs; return leftover argv."""
        rest: list[str] = []
        i = 0
        while i < len(argv):
            if argv[i] in ("--mca", "-mca") and i + 2 < len(argv):
                name, value = argv[i + 1], argv[i + 2]
                if not name.startswith("otpu_"):
                    name = "otpu_" + name
                self._cli[name] = value
                i += 3
            else:
                rest.append(argv[i])
                i += 1
        with self._lock:
            for var in self._vars.values():
                self._apply_external(var)
        return rest

    def _set_external(self, var: Var, raw: Any, source: VarSource, detail: str) -> None:
        """Apply an externally-sourced value; malformed values warn, not raise."""
        try:
            var._set(raw, source, detail)
        except ValueError as exc:
            from ompi_tpu_torch.base.output import show_help

            show_help("help-var", "bad-value", name=var.name, where=detail,
                      value=raw, error=exc)

    def _apply_external(self, var: Var) -> None:
        """(Re)apply file/env/CLI values respecting source priority."""
        self._load_files()
        names = [var.name, *var.aliases]
        for n in names:
            if n in self._file:
                val, path = self._file[n]
                self._set_external(var, val, VarSource.FILE, path)
        for n in names:
            env_name = ENV_PREFIX + n.removeprefix("otpu_")
            if env_name in os.environ:
                self._set_external(var, os.environ[env_name], VarSource.ENV, env_name)
        for n in names:
            if n in self._cli:
                self._set_external(var, self._cli[n], VarSource.CLI, "cli")

    # -- lookup / reflection --------------------------------------------
    def lookup(self, full_name: str) -> Optional[Var]:
        full_name = self._alias.get(full_name, full_name)
        return self._vars.get(full_name)

    def get(self, full_name: str, default: Any = None) -> Any:
        var = self.lookup(full_name)
        return default if var is None or var.value is None else var.value

    def set(self, full_name: str, value: Any) -> None:
        var = self.lookup(full_name)
        if var is None:
            raise KeyError(full_name)
        var.set(value)

    def all_vars(self, group: str = "") -> list[Var]:
        with self._lock:
            out = [v for v in self._vars.values() if v.group.startswith(group)]
        return sorted(out, key=lambda v: v.name)

    def all_pvars(self) -> list[Pvar]:
        return sorted(self._pvars.values(), key=lambda p: p.name)


registry = VarRegistry()


def _register_builtin_help() -> None:
    from ompi_tpu_torch.base.output import register_help

    register_help(
        "help-var",
        "bad-value",
        "Ignoring invalid value {value!r} for variable {name} (from {where}): "
        "{error}",
    )


_register_builtin_help()
