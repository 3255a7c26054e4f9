"""otpu_lint — CLI front-end for the invariant-encoding static analyzer.

Usage::

    python -m ompi_tpu_torch.tools.otpu_lint [paths...] [--list] [--parsable]
        [--select pass1,pass2] [--suppressions FILE | --no-suppressions]
        [--write-suppressions FILE] [--timings]

Copy of ``ompi_tpu/tools/otpu_lint.py`` with the port's two defaults:
paths = ``ompi_tpu_torch`` (the package), suppressions = the package's own
baseline, ``ompi_tpu_torch/lint_suppressions.txt`` beside this package
(the file the CI gate uses; the reference reads ``lint_suppressions.txt``
from the current directory, the JAX package's baseline, whose entries
match ``ompi_tpu/...`` paths only).  Exit status 0 means no
unsuppressed findings and no parse errors; 1 otherwise.  Unused baseline
entries are reported (and fail the run) so the suppressions file can
only shrink — a fixed finding must take its baseline entry with it.
"""
from __future__ import annotations

import argparse
import os
import sys

#: the port's baseline, inside the package (found from any directory)
DEFAULT_SUPPRESSIONS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "lint_suppressions.txt")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="otpu_lint",
        description="Run the otpu-lint invariant passes over source trees")
    ap.add_argument("paths", nargs="*", default=None,
                    help="Files or directories (default: the "
                         "ompi_tpu_torch package)")
    ap.add_argument("--list", action="store_true",
                    help="List registered analysis passes and exit")
    ap.add_argument("--select", metavar="PASSES",
                    help="Comma-separated pass names to run (default all)")
    ap.add_argument("--suppressions", metavar="FILE",
                    help="Baseline file (default: the package's "
                         "lint_suppressions.txt when present)")
    ap.add_argument("--no-suppressions", action="store_true",
                    help="Ignore any baseline file")
    ap.add_argument("--write-suppressions", metavar="FILE",
                    help="Write current findings as a baseline (each "
                         "generated entry still needs a justification "
                         "comment) and exit 0")
    ap.add_argument("--parsable", action="store_true",
                    help="Machine-readable colon-separated output")
    ap.add_argument("--timings", action="store_true",
                    help="Print the per-pass wall-clock breakdown "
                         "(the CI gate's budget diagnostics)")
    args = ap.parse_args(argv)

    from ompi_tpu_torch import analysis

    if args.list:
        for p in analysis.all_passes():
            if args.parsable:
                print(f"{p.name}:{p.description}")
            else:
                print(f"{p.name + ':':<18} {p.description}")
        return 0

    paths = args.paths or ["ompi_tpu_torch"]
    select = [s.strip() for s in args.select.split(",") if s.strip()] \
        if args.select else None

    sup = None
    if not args.no_suppressions and args.write_suppressions is None:
        sup_path = args.suppressions or DEFAULT_SUPPRESSIONS
        if args.suppressions or os.path.exists(sup_path):
            try:
                sup = analysis.Suppressions.load(sup_path)
            except ValueError as exc:
                print(f"otpu-lint: {exc}", file=sys.stderr)
                return 1

    try:
        result = analysis.lint(paths, select=select, suppressions=sup)
    except KeyError as exc:
        print(f"otpu-lint: {exc.args[0]}", file=sys.stderr)
        return 1

    if args.write_suppressions is not None:
        text = analysis.Suppressions.render(result.findings)
        with open(args.write_suppressions, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"otpu-lint: wrote {len(result.findings)} baseline "
              f"entr{'y' if len(result.findings) == 1 else 'ies'} to "
              f"{args.write_suppressions}")
        return 0

    failures = 0
    for f in result.errors + result.findings:
        print(f.format(args.parsable))
        failures += 1
    # unused entries are reported only when this run could have proved
    # them stale (their rule ran over their file): a partial run —
    # subset paths or --select — must not demand baseline edits it
    # cannot justify
    unused = result.unused_suppressions(sup) if sup is not None else []
    for e in unused:
        print(f"{sup.path}:{e.line_no}: unused suppression "
              f"'{e.rule} {e.path}{':' + e.symbol if e.symbol else ''}' "
              "— the finding is gone, remove the entry")
        failures += 1
    if args.timings:
        # stderr under --parsable: the human-format rows must not
        # corrupt the machine-readable findings stream
        print(result.format_timings(),
              file=sys.stderr if args.parsable else sys.stdout)
    if not args.parsable:
        print(f"otpu-lint: {len(result.findings)} finding(s), "
              f"{len(result.suppressed)} suppressed, "
              f"{len(result.errors)} parse error(s), "
              f"{len(unused)} unused suppression(s) "
              f"[{result.passes} passes over {result.files} files]")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
