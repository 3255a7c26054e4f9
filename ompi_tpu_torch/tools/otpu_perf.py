"""otpu_perf — the perf-regression history plane's comparator.

The port's benchmark appends schema'd min-of-k measurement rows to its own
``BENCH_CUDA_HISTORY.jsonl`` at the repo root (one JSON object per line;
``ladder`` rows carry per-(topology, coll, size, algorithm) timings that a
tuned rules file is derived from).  The schema, the comparator and the exit
codes are the JAX package's ``otpu_perf``'s; only the default history file
is the port's own.  This tool consumes that file:

- ``--diff``: compare the LATEST run's rows against a rolling baseline
  (the per-key MINIMUM over the previous ``--window`` runs — min-of-k
  against min-of-history keeps both sides on the fast scheduling mode
  of a bimodal host) with a noise band (``--band-rel`` + ``--band-abs-us``),
  and **exit 3 on any regression** — the CI contract.
- ``--check``: validate a history file's schema (every line parses,
  version/kind/fields are right) and self-test the comparator on
  synthetic rows; exit 1 on any problem.
- default: a per-key summary of the whole history (runs, latest vs
  best, trend).

All latency metrics are microseconds, lower is better.  ``--parsable``
emits colon-separated rows for scripts.  A missing history file is an
unreadable one: ``--check`` and the summary exit 1.

    python -m ompi_tpu_torch.tools.otpu_perf [HISTORY] [--diff | --check]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

#: history schema version: bump when row fields change meaning
SCHEMA_V = 1

#: fields every row must carry, by kind
_REQUIRED = {
    "bench": ("v", "kind", "run", "t", "key", "lat_us", "k"),
    "ladder": ("v", "kind", "run", "t", "topology", "coll", "nbytes",
               "algorithm", "lat_us", "k"),
}

#: the port's own history (never the JAX package's BENCH_HISTORY.jsonl)
DEFAULT_HISTORY = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "BENCH_CUDA_HISTORY.jsonl")


def load_history(path: str) -> tuple[list, list]:
    """Parse a history file into ``(rows, errors)`` — errors are
    human-readable strings, one per malformed line (the file stays
    usable: good lines still load)."""
    rows: list = []
    errors: list = []
    try:
        with open(path) as f:
            raw_lines = f.readlines()
    except OSError as exc:
        return [], [f"cannot read {path!r}: {exc}"]
    for lineno, line in enumerate(raw_lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            row = json.loads(line)
        except ValueError as exc:
            errors.append(f"line {lineno}: not JSON ({exc})")
            continue
        if not isinstance(row, dict):
            errors.append(f"line {lineno}: not an object")
            continue
        kind = row.get("kind")
        req = _REQUIRED.get(kind)
        if req is None:
            errors.append(f"line {lineno}: unknown kind {kind!r} "
                          f"(expected one of {sorted(_REQUIRED)})")
            continue
        missing = [k for k in req if k not in row]
        if missing:
            errors.append(f"line {lineno}: {kind} row missing "
                          f"{missing}")
            continue
        if int(row["v"]) != SCHEMA_V:
            errors.append(f"line {lineno}: schema version {row['v']} "
                          f"(this tool reads v{SCHEMA_V})")
            continue
        try:
            if float(row["lat_us"]) <= 0:
                errors.append(f"line {lineno}: non-positive lat_us")
                continue
        except (TypeError, ValueError):
            errors.append(f"line {lineno}: lat_us not a number")
            continue
        rows.append(row)
    return rows, errors


def _runs(rows: list, kind: str = "bench") -> list:
    """Run ids of ``kind`` rows, oldest first (by first-seen t)."""
    seen: dict = {}
    for r in rows:
        if r.get("kind") != kind:
            continue
        run = r["run"]
        t = float(r.get("t", 0.0))
        if run not in seen or t < seen[run]:
            seen[run] = t
    return [run for run, _t in sorted(seen.items(),
                                      key=lambda kv: (kv[1], kv[0]))]


def _row_key(row: dict) -> str:
    if row.get("kind") == "ladder":
        return (f"ladder/{row['topology']}/{row['coll']}/"
                f"{row['nbytes']}/{row['algorithm']}")
    return str(row["key"])


def _by_run_key(rows: list, kind: str = "bench") -> dict:
    """{run: {key: lat_us}} (min when a run repeats a key)."""
    out: dict = {}
    for r in rows:
        if r.get("kind") != kind:
            continue
        cell = out.setdefault(r["run"], {})
        key = _row_key(r)
        v = float(r["lat_us"])
        cell[key] = min(cell.get(key, v), v)
    return out


def compare(rows: list, band_rel: float = 0.5,
            band_abs_us: float = 100.0, window: int = 8,
            kind: str = "bench") -> dict:
    """Latest run vs the rolling min-baseline of the previous ``window``
    runs.  A key regresses when ``new > base * (1 + band_rel) +
    band_abs_us``; keys with no prior history are reported as ``new``.
    Returns ``{run, baseline_runs, rows: [...], regressions: n}``."""
    runs = _runs(rows, kind)
    if not runs:
        return {"run": None, "baseline_runs": [], "rows": [],
                "regressions": 0}
    latest = runs[-1]
    prior = runs[:-1][-window:]
    per_run = _by_run_key(rows, kind)
    base: dict = {}
    for run in prior:
        for key, v in per_run.get(run, {}).items():
            base[key] = min(base.get(key, v), v)
    out_rows = []
    regressions = 0
    for key, new in sorted(per_run.get(latest, {}).items()):
        b = base.get(key)
        if b is None:
            out_rows.append({"key": key, "new_us": round(new, 1),
                             "base_us": None, "status": "new"})
            continue
        limit = b * (1.0 + band_rel) + band_abs_us
        regressed = new > limit
        improved = new < b / (1.0 + band_rel)
        status = ("REGRESSED" if regressed
                  else "improved" if improved else "ok")
        if regressed:
            regressions += 1
        out_rows.append({
            "key": key, "new_us": round(new, 1),
            "base_us": round(b, 1), "limit_us": round(limit, 1),
            "ratio": round(new / b, 3), "status": status,
        })
    return {"run": latest, "baseline_runs": prior, "rows": out_rows,
            "regressions": regressions}


def self_test() -> Optional[str]:
    """Comparator sanity on synthetic rows: an injected 10x slowdown
    must regress, a within-band repeat must not.  Returns an error
    string, or None when healthy."""
    def mk(run, t, key, lat):
        return {"v": SCHEMA_V, "kind": "bench", "run": run, "t": t,
                "key": key, "lat_us": lat, "k": 3}

    clean = [mk("r1", 1, "x", 100.0), mk("r2", 2, "x", 120.0)]
    res = compare(clean, band_rel=0.5, band_abs_us=10.0, window=8)
    if res["regressions"] != 0:
        return "comparator flags a within-band repeat as a regression"
    slow = clean + [mk("r3", 3, "x", 1000.0)]
    res = compare(slow, band_rel=0.5, band_abs_us=10.0, window=8)
    if res["regressions"] != 1:
        return "comparator misses a 10x injected slowdown"
    # min-of-history baseline: the slow r3 must not poison r4's base
    ok_again = slow + [mk("r4", 4, "x", 110.0)]
    res = compare(ok_again, band_rel=0.5, band_abs_us=10.0, window=8)
    if res["regressions"] != 0:
        return "rolling min baseline was poisoned by a slow run"
    return None


def check(path: str) -> list:
    """The --check contract: schema-validate ``path`` and self-test the
    comparator.  Returns the list of problems (empty = healthy)."""
    rows, errors = load_history(path)
    problems = list(errors)
    if not rows:
        problems.append(f"{path}: no valid history rows")
    elif not _runs(rows, "bench"):
        problems.append(f"{path}: no bench-kind runs")
    err = self_test()
    if err:
        problems.append(f"comparator self-test: {err}")
    return problems


def render(res: dict, parsable: bool = False) -> str:
    if parsable:
        lines = []
        for r in res["rows"]:
            lines.append(":".join(str(x) for x in (
                r["key"], r["new_us"], r.get("base_us"),
                r.get("ratio", "-"), r["status"])))
        return "\n".join(lines)
    lines = [f"otpu_perf — run {res['run']} vs min of "
             f"{len(res['baseline_runs'])} prior run(s)"]
    lines.append(f"{'key':<40} {'new_us':>10} {'base_us':>10} "
                 f"{'ratio':>6}  status")
    for r in res["rows"]:
        base = "-" if r.get("base_us") is None else f"{r['base_us']:.1f}"
        ratio = r.get("ratio", "-")
        lines.append(f"{r['key']:<40} {r['new_us']:>10.1f} {base:>10} "
                     f"{ratio:>6}  {r['status']}")
    lines.append(f"regressions: {res['regressions']}")
    return "\n".join(lines)


def summary(rows: list) -> str:
    runs = _runs(rows)
    per_run = _by_run_key(rows)
    keys = sorted({k for cell in per_run.values() for k in cell})
    lines = [f"otpu_perf history — {len(runs)} run(s), "
             f"{len(keys)} key(s)"]
    lines.append(f"{'key':<40} {'runs':>5} {'best_us':>10} "
                 f"{'latest_us':>10}")
    for key in keys:
        vals = [(run, per_run[run][key]) for run in runs
                if key in per_run.get(run, {})]
        best = min(v for _r, v in vals)
        lines.append(f"{key:<40} {len(vals):>5} {best:>10.1f} "
                     f"{vals[-1][1]:>10.1f}")
    n_ladder = sum(1 for r in rows if r.get("kind") == "ladder")
    if n_ladder:
        lines.append(f"(+ {n_ladder} ladder rows; compare with "
                     "--diff --kind ladder)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="otpu_perf",
        description="Compare/validate the BENCH_CUDA_HISTORY.jsonl "
                    "perf-regression plane")
    ap.add_argument("history", nargs="?", default=DEFAULT_HISTORY,
                    help=f"History file (default: {DEFAULT_HISTORY})")
    ap.add_argument("--diff", action="store_true",
                    help="Compare the latest run against the rolling "
                         "min baseline; exit 3 on regression")
    ap.add_argument("--check", action="store_true",
                    help="Schema-validate the history file and "
                         "self-test the comparator; exit 1 on problems")
    ap.add_argument("--kind", default="bench",
                    choices=sorted(_REQUIRED),
                    help="Row kind to compare (default bench)")
    ap.add_argument("--band-rel", type=float, default=0.5,
                    help="Relative noise band for --diff (default 0.5: "
                         "50%% over baseline tolerated — host timing "
                         "is bimodal under load)")
    ap.add_argument("--band-abs-us", type=float, default=100.0,
                    help="Absolute noise floor in us added to the band "
                         "(default 100)")
    ap.add_argument("--window", type=int, default=8,
                    help="Rolling-baseline depth in runs (default 8)")
    ap.add_argument("--parsable", action="store_true",
                    help="Colon-separated rows")
    args = ap.parse_args(argv)

    if args.check:
        problems = check(args.history)
        if problems:
            for p in problems:
                print(f"otpu_perf --check: {p}", file=sys.stderr)
            return 1
        rows, _ = load_history(args.history)
        print(f"otpu_perf --check: {args.history} ok "
              f"({len(rows)} rows, {len(_runs(rows))} bench runs, "
              f"schema v{SCHEMA_V}, comparator self-test passed)")
        return 0

    rows, errors = load_history(args.history)
    for e in errors:
        print(f"otpu_perf: warning: {e}", file=sys.stderr)
    if not rows:
        print(f"otpu_perf: no history rows in {args.history!r} "
              "(the port's benchmark appends to it)",
              file=sys.stderr)
        return 1
    if args.diff:
        res = compare(rows, band_rel=args.band_rel,
                      band_abs_us=args.band_abs_us,
                      window=args.window, kind=args.kind)
        print(render(res, parsable=args.parsable))
        return 3 if res["regressions"] else 0
    print(summary(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
