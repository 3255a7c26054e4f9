"""observability — diagnostics and counters resolve to declared sinks.

Three contracts the observability stack depends on:

1. **show_help keys register**: every ``show_help(topic, key, ...)`` with
   literal arguments must have a matching ``register_help(topic, key,
   template)`` somewhere in the package — otherwise the user sees the
   raw ``[topic:key] k=v`` fallback instead of the written diagnostic.
   (``register_help`` import aliases like ``_rh`` are followed.)

2. **SPC counters declare**: every literal name passed to
   ``spc.record``/``spc.read`` must appear in the ``_COUNTERS`` tuple of
   ``runtime/spc.py`` — a typo'd counter silently counts into nothing
   (record() drops unknown names by design).

3. **Trace span begins close**: a ``t0 = trace.now()`` begin must be
   consumed by a ``trace.span(...)``/``trace.hist_record(...)`` in the
   same function on some path — an unconsumed begin is a span that never
   closes (the family where the timeline silently loses the operation).

4. **Telemetry keys come from the schema**: every literal name passed to
   ``telemetry.register_source`` must be a key of the ``SCHEMA``
   constant in ``runtime/telemetry.py`` — an undeclared source key
   would publish samples ``otpu_top``/``otpu_analyze`` cannot interpret
   (and the runtime rejects it loudly; this catches it before it runs).

5. **Flight-recorder reasons register**: every literal reason passed to
   ``flight.dump`` must have a registered ``help-flight`` template —
   the dump announcement IS the user-facing diagnostic, and an
   unregistered reason would crash-dump with the raw fallback.

6. **Profile stages come from the stage table**: every literal name
   passed to ``profile.stage_span``/``profile.stage_mark`` must be a
   key of the ``STAGES`` table in ``runtime/profile.py`` — the stage
   vocabulary is closed so otpu_analyze's pack/queue/wire/parse/deliver
   decomposition keeps a stable meaning (and the runtime rejects an
   undeclared stage loudly; this catches it before it runs).

7. **Flow-key categories come from the declared registry**: every
   literal category passed to ``trace.flow_start``/``trace.flow_finish``
   must be a key of the ``FLOW_CATEGORIES`` table in
   ``runtime/trace.py`` — each category documents its id format, and
   ``otpu_analyze`` parses flow ids by category, so an undeclared
   category would emit arrows the critical-path graph silently drops.
"""
from __future__ import annotations

import ast

from ompi_tpu_torch.analysis import (AnalysisPass, Finding, Package,
                                     call_name, const_str, register_pass,
                                     walk)


def _register_aliases(mod) -> set:
    """Names that mean base.output.register_help in this module."""
    names = {"register_help"}
    for node in walk(mod.tree):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.endswith("output"):
            for alias in node.names:
                if alias.name == "register_help":
                    names.add(alias.asname or alias.name)
    return names


@register_pass
class ObservabilityPass(AnalysisPass):
    name = "observability"
    description = ("show_help keys resolve to registered templates, SPC "
                   "counter names are declared in runtime/spc.py, "
                   "trace.now() begins are consumed by a span, "
                   "telemetry source names come from the declared "
                   "SCHEMA, flight-recorder dump reasons are "
                   "help-flight-registered, profile stage names come "
                   "from the declared STAGES table, flow-key categories "
                   "come from the declared FLOW_CATEGORIES registry")

    def run(self, pkg: Package) -> list[Finding]:
        registered: set[tuple] = set()
        counters: set[str] = set()
        counters_declared = False
        schema: set[str] = set()
        schema_declared = False
        stages: set[str] = set()
        stages_declared = False
        flows: set[str] = set()
        flows_declared = False
        for mod in pkg.modules:
            aliases = _register_aliases(mod)
            for node in walk(mod.tree):
                if isinstance(node, ast.Call):
                    fname = call_name(node)
                    short = fname.rsplit(".", 1)[-1]
                    if short in aliases and len(node.args) >= 2:
                        topic = const_str(node.args[0])
                        key = const_str(node.args[1])
                        if topic and key:
                            registered.add((topic, key))
            if mod.path.replace("\\", "/").endswith("spc.py"):
                for stmt in mod.tree.body:
                    if isinstance(stmt, ast.Assign) \
                            and any(isinstance(t, ast.Name)
                                    and t.id == "_COUNTERS"
                                    for t in stmt.targets) \
                            and isinstance(stmt.value, (ast.Tuple, ast.List)):
                        counters_declared = True
                        for elt in stmt.value.elts:
                            s = const_str(elt)
                            if s:
                                counters.add(s)
            if mod.path.replace("\\", "/").endswith("profile.py"):
                for stmt in mod.tree.body:
                    if isinstance(stmt, ast.Assign) \
                            and any(isinstance(t, ast.Name)
                                    and t.id == "STAGES"
                                    for t in stmt.targets) \
                            and isinstance(stmt.value, ast.Dict):
                        stages_declared = True
                        for k in stmt.value.keys:
                            s = const_str(k)
                            if s:
                                stages.add(s)
            if mod.path.replace("\\", "/").endswith("trace.py"):
                for stmt in mod.tree.body:
                    if isinstance(stmt, ast.Assign) \
                            and any(isinstance(t, ast.Name)
                                    and t.id == "FLOW_CATEGORIES"
                                    for t in stmt.targets) \
                            and isinstance(stmt.value, ast.Dict):
                        flows_declared = True
                        for k in stmt.value.keys:
                            s = const_str(k)
                            if s:
                                flows.add(s)
            if mod.path.replace("\\", "/").endswith("telemetry.py"):
                for stmt in mod.tree.body:
                    if isinstance(stmt, ast.Assign) \
                            and any(isinstance(t, ast.Name)
                                    and t.id in ("SCHEMA", "_SCHEMA")
                                    for t in stmt.targets):
                        if isinstance(stmt.value, ast.Dict):
                            schema_declared = True
                            for k in stmt.value.keys:
                                s = const_str(k)
                                if s:
                                    schema.add(s)
                        elif isinstance(stmt.value,
                                        (ast.Tuple, ast.List)):
                            schema_declared = True
                            for elt in stmt.value.elts:
                                s = const_str(elt)
                                if s:
                                    schema.add(s)
        out: list[Finding] = []
        for mod in pkg.modules:
            for fn, qual in mod.functions():
                out.extend(self._check_fn(mod, fn, qual, registered,
                                          counters, counters_declared,
                                          schema, schema_declared,
                                          stages, stages_declared,
                                          flows, flows_declared))
        return out

    def _check_fn(self, mod, fn, qual, registered, counters,
                  counters_declared, schema, schema_declared,
                  stages, stages_declared, flows,
                  flows_declared) -> list:
        out = []
        begins: dict[str, ast.AST] = {}
        consumed: set[str] = set()
        for node in walk(fn):
            if not isinstance(node, ast.Call):
                if isinstance(node, ast.Assign) \
                        and isinstance(node.value, ast.Call) \
                        and call_name(node.value).endswith("trace.now") \
                        and isinstance(node.targets[0], ast.Name):
                    begins[node.targets[0].id] = node
                continue
            name = call_name(node)
            short = name.rsplit(".", 1)[-1]
            if short == "show_help" and len(node.args) >= 2:
                topic, key = const_str(node.args[0]), const_str(node.args[1])
                if topic and key and (topic, key) not in registered:
                    out.append(Finding(
                        self.name, mod.path, node.lineno, node.col_offset,
                        f"show_help('{topic}', '{key}') has no matching "
                        "register_help — the user would see the raw "
                        "fallback instead of the written diagnostic",
                        qual))
            elif name in ("spc.record", "spc.read") and node.args \
                    and counters_declared:
                cname = const_str(node.args[0])
                if cname and cname not in counters:
                    out.append(Finding(
                        self.name, mod.path, node.lineno, node.col_offset,
                        f"SPC counter '{cname}' is not declared in "
                        "runtime/spc.py _COUNTERS — record() silently "
                        "drops unknown names", qual))
            elif short == "register_source" and node.args \
                    and schema_declared:
                sname = const_str(node.args[0])
                if sname and sname not in schema:
                    out.append(Finding(
                        self.name, mod.path, node.lineno,
                        node.col_offset,
                        f"telemetry source {sname!r} is not a key of "
                        "runtime/telemetry.py SCHEMA — published sample "
                        "keys must come from the declared schema",
                        qual))
            elif (name.endswith("flight.dump")
                  or (short == "dump"
                      and mod.path.replace("\\", "/")
                      .endswith("flight.py"))) and node.args:
                reason = const_str(node.args[0])
                if reason and ("help-flight", reason) not in registered:
                    out.append(Finding(
                        self.name, mod.path, node.lineno,
                        node.col_offset,
                        f"flight-recorder dump reason {reason!r} has no "
                        "registered help-flight template — the crash "
                        "announcement would be the raw fallback",
                        qual))
            elif short in ("stage_span", "stage_mark") and node.args \
                    and stages_declared:
                sname = const_str(node.args[0])
                if sname and sname not in stages:
                    out.append(Finding(
                        self.name, mod.path, node.lineno,
                        node.col_offset,
                        f"profile stage {sname!r} is not declared in "
                        "runtime/profile.py STAGES — stage clocks must "
                        "aggregate into the declared stage table",
                        qual))
                # a stage_span consumes its t0 like span/hist_record
                for arg in list(node.args) + [kw.value for kw in
                                              node.keywords]:
                    for sub in walk(arg):
                        if isinstance(sub, ast.Name):
                            consumed.add(sub.id)
            elif short in ("flow_start", "flow_finish") and node.args \
                    and flows_declared:
                fname_lit = const_str(node.args[0])
                if fname_lit and fname_lit not in flows:
                    out.append(Finding(
                        self.name, mod.path, node.lineno,
                        node.col_offset,
                        f"flow category {fname_lit!r} is not declared "
                        "in runtime/trace.py FLOW_CATEGORIES — flow "
                        "ids are parsed per declared category, an "
                        "undeclared one emits arrows the critical-path "
                        "graph silently drops", qual))
            elif short in ("span", "hist_record"):
                for arg in list(node.args) + [kw.value for kw in
                                              node.keywords]:
                    for sub in walk(arg):
                        if isinstance(sub, ast.Name):
                            consumed.add(sub.id)
        # a begin consumed anywhere in the function (incl. inside a
        # lambda's span call) closes; otherwise the span never ends
        for tname, node in begins.items():
            if tname not in consumed:
                out.append(Finding(
                    self.name, mod.path, node.lineno, node.col_offset,
                    f"'{tname} = trace.now()' is never consumed by a "
                    "trace.span/hist_record in this function — the span "
                    "begins but never closes", qual))
        return out
