"""mca-conformance — components honor their framework's contract.

The MCA discovery machinery (``base/mca.py``) imports every module under
``ompi_tpu_torch.mca.<fw>`` and looks for a ``COMPONENT`` export; selection then
calls framework-specific slots.  A component that half-implements the
contract fails at selection time on whatever host first exercises it —
this pass moves that to lint time:

- a module under ``mca/<fw>/`` defining a Component subclass must export
  ``COMPONENT`` (or discovery silently skips it — the bug class
  otpu_info's dynamic framework scan closed),
- the component class must declare a non-empty ``name`` (the selection
  var namespace key),
- frameworks with a required query slot (btl ``send``, coll
  ``comm_query``, pml ``get_module``) must implement it — in the class
  or a same-module base,
- variables register through ``base/var.py``: ``register_vars`` bodies
  must not read ``os.environ`` directly, and module-level
  ``registry.register(group, ...)`` calls must use their own framework
  name as the group (a mismatched group hides the var from
  ``otpu_info --param <fw>``).
"""
from __future__ import annotations

import ast

from ompi_tpu_torch.analysis import (AnalysisPass, Finding, Package,
                                     call_name, const_str, register_pass,
                                     walk)

#: slots every component of the framework must provide
REQUIRED_SLOTS = {
    "btl": ("send",),
    "coll": ("comm_query",),
    "pml": ("get_module",),
}

#: modules never holding components (helpers, the framework base itself)
EXEMPT_FILES = {"__init__.py", "base.py", "algorithms.py"}


def _mca_framework(path: str):
    parts = path.replace("\\", "/").split("/")
    if "mca" in parts:
        i = parts.index("mca")
        if i + 2 < len(parts) or (i + 2 == len(parts)
                                  and parts[-1].endswith(".py")):
            try:
                return parts[i + 1], parts[-1]
            except IndexError:
                return None
    return None


def _base_names(cls: ast.ClassDef) -> set:
    out = set()
    for b in cls.bases:
        if isinstance(b, ast.Name):
            out.add(b.id)
        elif isinstance(b, ast.Attribute):
            out.add(b.attr)
    return out


def _is_component_class(cls: ast.ClassDef) -> bool:
    bases = _base_names(cls)
    return any(b == "Btl" or b.endswith("Component") or b == "Component"
               for b in bases)


def _class_members(cls: ast.ClassDef):
    methods, attrs = set(), {}
    for stmt in cls.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            methods.add(stmt.name)
        elif isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    attrs[t.id] = stmt.value
    return methods, attrs


@register_pass
class McaConformancePass(AnalysisPass):
    name = "mca-conformance"
    description = ("mca/* components export COMPONENT, declare a name, "
                   "implement their framework's required slots, and "
                   "register variables through base/var.py")

    def run(self, pkg: Package) -> list[Finding]:
        out: list[Finding] = []
        for mod in pkg.modules:
            loc = _mca_framework(mod.path)
            if loc is None:
                continue
            fw, fname = loc
            if fname in EXEMPT_FILES or fname.startswith("_"):
                continue
            out.extend(self._check_module(mod, fw))
        return out

    def _check_module(self, mod, fw) -> list:
        out = []
        classes = {c.name: c for c in mod.classes()}
        comp_classes = [c for c in classes.values()
                        if _is_component_class(c)]
        has_component_export = any(
            isinstance(stmt, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == "COMPONENT"
                    for t in stmt.targets)
            for stmt in mod.tree.body)
        if comp_classes and not has_component_export:
            c = comp_classes[0]
            out.append(Finding(
                self.name, mod.path, c.lineno, c.col_offset,
                f"module defines component class '{c.name}' but exports "
                "no module-level COMPONENT — framework discovery "
                "silently skips it", c.name))
        for cls in comp_classes:
            methods, attrs = _class_members(cls)
            # fold in same-module bases (template/base inheritance)
            for b in _base_names(cls):
                base = classes.get(b)
                if base is not None:
                    bm, ba = _class_members(base)
                    methods |= bm
                    for k, v in ba.items():
                        attrs.setdefault(k, v)
            name_val = attrs.get("name")
            if name_val is None or not const_str(name_val):
                out.append(Finding(
                    self.name, mod.path, cls.lineno, cls.col_offset,
                    f"component class '{cls.name}' declares no non-empty "
                    "'name' class attribute — it cannot be addressed by "
                    "the selection vars", cls.name))
            for slot in REQUIRED_SLOTS.get(fw, ()):
                if slot not in methods:
                    out.append(Finding(
                        self.name, mod.path, cls.lineno, cls.col_offset,
                        f"'{cls.name}' does not implement required "
                        f"{fw}-framework slot '{slot}'", cls.name))
            for stmt in cls.body:
                if isinstance(stmt, ast.FunctionDef) \
                        and stmt.name == "register_vars":
                    for node in walk(stmt):
                        if isinstance(node, ast.Attribute) \
                                and node.attr == "environ":
                            out.append(Finding(
                                self.name, mod.path, node.lineno,
                                node.col_offset,
                                "register_vars reads os.environ directly "
                                "— declare an MCA var through "
                                "base/var.py so the value is typed, "
                                "sourced, and visible to otpu_info",
                                f"{cls.name}.register_vars"))
        # module-level registry.register(group, ...) must use this fw
        for stmt in mod.tree.body:
            for node in walk(stmt):
                if isinstance(node, ast.Call) \
                        and call_name(node).endswith("registry.register") \
                        and node.args:
                    group = const_str(node.args[0])
                    if group is not None and group != fw:
                        out.append(Finding(
                            self.name, mod.path, node.lineno,
                            node.col_offset,
                            f"module in mca/{fw}/ registers a variable "
                            f"under group '{group}' — otpu_info --param "
                            f"{fw} will not list it", ""))
        return out
