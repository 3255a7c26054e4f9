"""otpu_info — the ``ompi_info`` equivalent: dump frameworks, components,
priorities, MCA variables (with values and sources), and pvars.

The port's twin of the JAX package's ``otpu_info``: the same sections, rows
and ``--parsable`` form, read from ``ompi_tpu_torch``'s registries.  The
reference ``ompi_info`` walks every registered framework and the MCA var
registry and prints one ``key: value`` line per item; ``--all`` shows
everything, ``--param <fw> <comp>`` filters, ``--parsable`` emits
machine-readable ``:``-separated output, ``--lint`` the static analyzer's
registered passes (``ompi_tpu_torch.analysis``; ``--all`` lists them too).

Usage::

    python -m ompi_tpu_torch.tools.otpu_info [--all] [--param FW [COMP]]
                                             [--parsable] [--pvars]
"""
from __future__ import annotations

import argparse
import sys

def _framework_names() -> list:
    """Every subpackage of ``ompi_tpu_torch.mca`` is a framework (the
    autogen.pl role) — scanned dynamically, not hand-listed: a static
    tuple silently skips any framework added after it was written."""
    import pkgutil

    import ompi_tpu_torch.mca as mca_pkg

    return sorted(info.name for info in pkgutil.iter_modules(mca_pkg.__path__)
                  if info.ispkg)


def _discover_all():
    from ompi_tpu_torch.base import mca

    for name in _framework_names():
        fw = mca.framework(name, "")
        fw.discover()
        # register vars without requiring a full runtime init
        for comp in fw.components.values():
            if not getattr(comp, "_vars_registered", False):
                try:
                    comp.register_vars(fw)
                    comp._vars_registered = True
                except Exception:
                    pass
    return mca.all_frameworks()


def _fmt(key: str, value, parsable: bool) -> str:
    if parsable:
        return f"{key}:{value}"
    return f"{key + ':':>40} {value}"


def _pset_rows() -> list:
    """(name, size, source) of every process set this process can see.

    Inside a tpurun job (``OTPU_COORD`` set) the coord service is asked
    for its advertised registry — the same source sessions resolve
    against; standalone, only the MPI-4 builtins exist.  ``mpi://SELF``
    is always client-resolved (its membership is per-process)."""
    import os

    rows = []
    nprocs = int(os.environ.get("OTPU_NPROCS", "1") or 1)
    coord = os.environ.get("OTPU_COORD")
    if coord:
        try:
            from ompi_tpu_torch.rte.coord import CoordClient

            c = CoordClient(timeout=5.0)
            try:
                rows = [(r["name"], int(r["size"]), r["source"])
                        for r in c.pset_list()]
            finally:
                c.close()
        except Exception:
            rows = [("mpi://WORLD", nprocs, "builtin (coord unreachable)")]
    else:
        rows = [("mpi://WORLD", nprocs, "builtin")]
    rows.append(("mpi://SELF", 1, "builtin"))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="otpu_info",
        description="Show installed frameworks, components, and MCA vars")
    ap.add_argument("--all", action="store_true",
                    help="Show everything (components + vars + pvars)")
    ap.add_argument("--param", nargs="+", metavar=("FW", "COMP"),
                    help="Show variables of one framework (and component)")
    ap.add_argument("--parsable", action="store_true",
                    help="Machine-readable colon-separated output")
    ap.add_argument("--pvars", action="store_true",
                    help="Show performance variables (MPI_T pvar analog)")
    ap.add_argument("--lint", action="store_true",
                    help="Show registered otpu-lint analysis passes "
                         "(the invariant families the static analyzer "
                         "enforces; run them with ompi_tpu_torch.tools"
                         ".otpu_lint)")
    ap.add_argument("--trace", action="store_true",
                    help="Show the otpu-trace plane: the declared span "
                         "categories and flow-key categories "
                         "(runtime/trace.py CATEGORIES / "
                         "FLOW_CATEGORIES) and the ring/export/flow "
                         "MCA vars")
    ap.add_argument("--telemetry", action="store_true",
                    help="Show the live-telemetry plane: every "
                         "published sample key (the declared schema "
                         "otpu_top renders), the sampler's MCA vars, "
                         "and the flight-recorder settings")
    ap.add_argument("--profile", action="store_true",
                    help="Show the otpu-prof plane: the declared "
                         "datapath stage table (runtime/profile.py "
                         "STAGES), the stage-clock / sampling-profiler "
                         "MCA vars, and the perf-history file "
                         "otpu_perf reads")
    ap.add_argument("--progress", action="store_true",
                    help="Show the progress-engine plane: the "
                         "registry-enumerated progress vars (native "
                         "reactor switch, low-priority cadence), the "
                         "reactor's capability/engagement state, live "
                         "callback/waiter counts, and the "
                         "progress_native_* SPC counters")
    ap.add_argument("--quant", action="store_true",
                    help="Show the coll/quant plane: the quantization "
                         "MCA vars (codec block, wire enable, KV "
                         "codec), the accuracy-budget comm info key, "
                         "the quant stage clocks, and the quant SPC "
                         "counters — all registry-enumerated")
    ap.add_argument("--moe", action="store_true",
                    help="Show the parallel/moe plane: the expert-"
                         "parallel MCA vars (gating top-k, capacity "
                         "factor, drop policy, designed-imbalance "
                         "knobs), the moe telemetry key, and the "
                         "moe_* SPC counters — all registry-"
                         "enumerated")
    ap.add_argument("--serving", action="store_true",
                    help="Show the serving-fleet plane: the "
                         "registry-enumerated serving MCA vars (prefix "
                         "cache, autoscale policy) and the serving "
                         "role/pool process sets the coordination "
                         "service advertises")
    ap.add_argument("--psets", action="store_true",
                    help="Show the process sets the coordination service "
                         "advertises (name, size, membership source) — "
                         "the MPI-4 pset registry sessions resolve "
                         "against; standalone shows the builtins")
    ap.add_argument("--topo", action="store_true",
                    help="Show host + device topology (hwloc analog; "
                         "lstopo-lite)")
    ap.add_argument("--debug-dump", action="store_true",
                    help="Debugger handle introspection: live "
                         "communicators, pml message queues, proctable "
                         "(the MPIR/ompi_common_dll analog) as JSON — "
                         "initializes the runtime in this process")
    args = ap.parse_args(argv)

    if args.debug_dump:
        import json

        import ompi_tpu_torch
        from ompi_tpu_torch.runtime import debugger

        ompi_tpu_torch.init()
        print(json.dumps(debugger.dump(), indent=1, default=str))
        return 0

    import ompi_tpu_torch
    from ompi_tpu_torch.base.var import registry

    out = []
    p = args.parsable
    out.append(_fmt("package", "ompi_tpu_torch (PyTorch/CUDA MPI)", p))
    out.append(_fmt("version", ompi_tpu_torch.__version__, p))

    frameworks = _discover_all()

    if args.all or not args.param:
        for fw in frameworks:
            if not fw.components:
                continue
            for comp in sorted(fw.components.values(),
                               key=lambda c: c.name):
                prio = getattr(comp, "priority", "")
                out.append(_fmt(f"mca {fw.name}",
                                f"{comp.name} (priority {prio})", p))

    if args.all or args.param:
        want_fw = args.param[0] if args.param else None
        want_comp = args.param[1] if args.param and len(args.param) > 1 \
            else None
        for var in registry.all_vars():
            group = var.group.split("/")
            if want_fw and group[0] != want_fw:
                continue
            if want_comp and (len(group) < 2 or group[1] != want_comp):
                continue
            origin = var.source.name.lower()
            detail = f" [{var.source_detail}]" if var.source_detail else ""
            out.append(_fmt(
                f"mca var {var.name}",
                f"{var.value!r} (type {var.vtype.name.lower()}, "
                f"source {origin}{detail})", p))

    if args.topo:
        # explicit-only (not part of --all): device discovery initializes
        # the accelerator runtime, which an info dump must not pay for
        from ompi_tpu_torch.base import hwloc

        for line in hwloc.summary().splitlines():
            out.append(_fmt("topo", line.strip(), p))

    if args.all or args.lint:
        # the dynamic-scan convention: enumerate the registry, never a
        # hand-kept list — a pass added later shows up automatically
        from ompi_tpu_torch import analysis

        for lint_pass in analysis.all_passes():
            out.append(_fmt(f"lint pass {lint_pass.name}",
                            lint_pass.description, p))

    if args.all or args.trace:
        # registry-enumerated like --telemetry/--profile: the declared
        # category tables and the trace var group, never a hand-kept
        # list — a category added later shows up automatically
        from ompi_tpu_torch.runtime import trace as _trace

        for cat, desc in _trace.CATEGORIES.items():
            out.append(_fmt(f"trace category {cat}", desc, p))
        for fcat, desc in _trace.FLOW_CATEGORIES.items():
            out.append(_fmt(f"trace flow key {fcat}", desc, p))
        for var in registry.all_vars("trace"):
            out.append(_fmt(f"trace var {var.name}",
                            f"{var.value!r} — {var.help}", p))

    if args.all or args.telemetry:
        # registry-enumerated like --lint/--psets: the schema constant
        # and the telemetry/flight var groups, never a hand-kept list
        from ompi_tpu_torch.runtime import flight as _flight  # noqa: F401
        from ompi_tpu_torch.runtime import telemetry as _telemetry

        for key, desc in _telemetry.SCHEMA.items():
            out.append(_fmt(f"telemetry key {key}", desc, p))
        for group in ("telemetry", "flight"):
            for var in registry.all_vars(group):
                out.append(_fmt(
                    f"telemetry var {var.name}",
                    f"{var.value!r} — {var.help}", p))

    if args.all or args.profile:
        # registry-enumerated like --telemetry: the STAGES table and
        # the profile var group, never a hand-kept list
        from ompi_tpu_torch.runtime import profile as _profile
        from ompi_tpu_torch.tools.otpu_perf import DEFAULT_HISTORY

        for stage, desc in _profile.STAGES.items():
            out.append(_fmt(f"profile stage {stage}", desc, p))
        for var in registry.all_vars("profile"):
            out.append(_fmt(f"profile var {var.name}",
                            f"{var.value!r} — {var.help}", p))
        out.append(_fmt("profile history",
                        f"{DEFAULT_HISTORY} (the port's benchmark "
                        "appends; otpu_perf --diff/--check compare)", p))

    if args.all or args.progress:
        # registry-enumerated like --telemetry/--profile: importing the
        # engine registers the 'progress' var group; reactor state and
        # the counter names come from their declared tables, never a
        # hand-kept list
        from ompi_tpu_torch.runtime import progress as _progress
        from ompi_tpu_torch.runtime import reactor as _reactor
        from ompi_tpu_torch.runtime import spc as _pspc

        for var in registry.all_vars("progress"):
            out.append(_fmt(f"progress var {var.name}",
                            f"{var.value!r} — {var.help}", p))
        for key, val in sorted(_reactor.stats().items()):
            out.append(_fmt(f"progress reactor {key}", val, p))
        from ompi_tpu_torch.mca.threads import native as _threads_native

        for key, val in sorted(_threads_native.substrate().items()):
            out.append(_fmt(f"progress substrate {key}", val, p))
        for key, val in sorted(_progress._telemetry_stats().items()):
            out.append(_fmt(f"progress engine {key}", val, p))
        for cname in _pspc._COUNTERS:
            if cname.startswith(("progress_native", "fastpath_native")):
                out.append(_fmt(f"progress counter {cname}",
                                "SPC counter (see --pvars for values)",
                                p))

    if args.all or args.quant:
        # registry-enumerated like --telemetry/--profile: the coll/
        # quant var group (registered by the coll framework scan
        # above), the declared quant stage clocks out of the STAGES
        # table, and the declared quant_* SPC counters — never a
        # hand-kept list
        from ompi_tpu_torch.mca.coll import quant as _quant
        from ompi_tpu_torch.runtime import profile as _qprofile
        from ompi_tpu_torch.runtime import spc as _qspc

        out.append(_fmt("quant budget info key", _quant.BUDGET_KEY, p))
        for var in registry.all_vars("coll/quant"):
            out.append(_fmt(f"quant var {var.name}",
                            f"{var.value!r} — {var.help}", p))
        for stage, desc in _qprofile.STAGES.items():
            if stage.startswith("quant."):
                out.append(_fmt(f"quant stage {stage}", desc, p))
        for cname in _qspc._COUNTERS:
            if cname.startswith("quant_"):
                out.append(_fmt(f"quant counter {cname}",
                                "SPC counter (see --pvars for values)",
                                p))

    if args.all or args.moe:
        # registry-enumerated like --quant/--serving: importing the
        # subsystem registers the 'moe' var group; the telemetry key
        # and the moe_* SPC counters come from their declared tables,
        # never a hand-kept list
        import ompi_tpu_torch.parallel.moe  # noqa: F401  (registers moe vars)
        from ompi_tpu_torch.runtime import spc as _mspc
        from ompi_tpu_torch.runtime import telemetry as _mtelemetry

        for var in registry.all_vars("moe"):
            out.append(_fmt(f"moe var {var.name}",
                            f"{var.value!r} — {var.help}", p))
        out.append(_fmt("moe telemetry key moe",
                        _mtelemetry.SCHEMA["moe"], p))
        for cname in _mspc._COUNTERS:
            if cname.startswith("moe_"):
                out.append(_fmt(f"moe counter {cname}",
                                "SPC counter (see --pvars for values)",
                                p))

    if args.all or args.serving:
        # registry-enumerated like --telemetry/--profile: the serving
        # var group (registered at ompi_tpu_torch.serving import) plus the
        # advertised serving role/pool psets — never a hand-kept list
        import ompi_tpu_torch.serving  # noqa: F401  (registers serving vars)

        for var in registry.all_vars("serving"):
            out.append(_fmt(f"serving var {var.name}",
                            f"{var.value!r} — {var.help}", p))
        # otpu-req request tracing rides the trace group but is a
        # serving-plane switch — surface it here, with the slo
        # telemetry key and the declared req_*/slo_* SPC counters
        # (enumerated from their registries, never a hand-kept list)
        from ompi_tpu_torch.runtime import spc as _sspc
        from ompi_tpu_torch.runtime import telemetry as _stelemetry

        var = registry.lookup("otpu_trace_requests")
        if var is not None:
            out.append(_fmt(f"serving var {var.name}",
                            f"{var.value!r} — {var.help}", p))
        out.append(_fmt("serving telemetry key slo",
                        _stelemetry.SCHEMA["slo"], p))
        out.append(_fmt("serving telemetry key frontdoor",
                        _stelemetry.SCHEMA["frontdoor"], p))
        for cname in _sspc._COUNTERS:
            if cname.startswith(("req_", "slo_", "serve_shed",
                                 "serve_preempt", "serve_spec_")):
                out.append(_fmt(f"serving counter {cname}",
                                "SPC counter (see --pvars for values)",
                                p))
        for pname, size, source in _pset_rows():
            if pname.startswith("mpi://serving/"):
                out.append(_fmt(f"serving pset {pname}",
                                f"size {size} (source {source})", p))

    if args.all or args.psets:
        for pname, size, source in _pset_rows():
            out.append(_fmt(f"pset {pname}",
                            f"size {size} (source {source})", p))

    if args.all or args.pvars:
        # SPC counters normally register at instance boot; an info dump
        # must list them (zeroed) without paying for a runtime boot.
        # Lazily-registered pvars (trace histogram bins like
        # btl_sendmsg/staging_hit) appear once a run has touched them.
        from ompi_tpu_torch.runtime import spc as _spc

        _spc.init()
        for pv in registry.all_pvars():
            out.append(_fmt(
                f"pvar {pv.name}",
                f"{pv.read()} ({pv.pclass.name.lower()}) — {pv.help}", p))

    try:
        print("\n".join(out))
    except BrokenPipeError:
        pass   # output piped into head & friends
    return 0


if __name__ == "__main__":
    sys.exit(main())
