"""otpu_analyze — cross-rank straggler / critical-path analysis.

The port's twin of the JAX package's ``otpu_analyze``: the same report,
read through ``ompi_tpu_torch``'s trace merge and percentiles, its
``telemetry.SLO_BUDGET`` and coll/tuned's menus and fixed ladders.

    python -m ompi_tpu_torch.tools.otpu_analyze PATH... [--critical-path]
        [--suggest-ladder OUT] [--requests [--slo-ms MS]] [--diff OLD.json]

Consumes the clock-aligned timelines the tracing stack already produces
(``trace_merged.json`` from ``tpurun``, per-rank ``trace_rank<r>.json``
payloads, or a directory holding either) and answers the questions a
skew report's eyeball pass cannot:

- **Critical-path attribution (otpu-crit)**: with the flow layer armed
  (``otpu_trace_flow``, default-on under tracing) every pml message
  span carries its ``cid.src.dst.seq`` key and every collective span a
  per-comm ``(cid, cseq)`` round key.  ``--critical-path`` assembles
  the cross-rank activity graph over the merged timeline — program-
  order edges within each rank, message edges send-complete → recv-
  delivery, collective barrier edges last-arrival → all-release — and
  walks each step's longest dependency chain backward from the step's
  completion.  The report attributes every step's wall time to
  {compute, comm buckets (split into the profile's STAGES groups when otpu-prof
  payloads ride along), blocked-on-rank-R}, names the step's bounding
  rank, gives a top-blockers table, and reports the **critical**
  exposed-comm fraction — only comm ON the path counts, so a collective
  that merely absorbs another rank's skew stops inflating the number.
  ``--suggest-ladder`` converts the per-(coll, size-bin) critical
  contributions into a versioned draft rules file in exactly the format
  ``coll/tuned.py`` consumes (an autotuner seeds its sweep from
  it).

- **Last-arrival attribution**: for every matched collective round,
  which rank entered last?  The rank that is last most often IS the
  straggler — on a synchronizing collective everyone else's wait time
  is attributable to it.  Rounds are matched per (collective, cid) by
  occurrence index from the tail (the ring-overwrite convention
  ``trace.skew_report`` established).
- **Inter-rank skew distributions**: per (collective, cid) and overall,
  the mean/p50/p99/max spread between first and last arrival — the
  measured input a HiCCL-style topology composer needs to justify its
  schedule choices.
- **Exposed-communication fraction**: per rank, the fraction of its
  observed timeline spent inside collective spans (interval-union, so
  nested/overlapping spans don't double-count) — the number the
  fused-overlap work must drive toward zero.  When
  step spans exist (``cat == "step"`` or a ``--step-span`` name), the
  fraction is also reported per step.
- **Host-overhead decomposition** (otpu-prof): when the per-rank trace
  payloads carry ``runtime/profile.py`` stage histograms (job ran with
  ``otpu_profile_stages``), every rank gets a per-message
  pack/queue/wire/parse/deliver breakdown, an **exposed-host fraction**
  (host-side stage time over the rank's observed window — the number
  the native reactor must drive down), and a
  stage-sum vs end-to-end reconciliation ratio (stage sums are work
  segments inside the e2e latency; the remainder is progress-loop
  wait, so the ratio must land in (0, ~1]).

The report is a regression-friendly JSON document (stable key order,
rounded numbers); ``--diff OLD.json`` compares two runs and flags straggler/skew movement.
"""
from __future__ import annotations

import argparse
import bisect
import glob
import json
import os
import sys
from typing import Optional

# THE percentile and clock-alignment implementations (the offset sign
# convention must live in exactly one place — trace.py)
from ompi_tpu_torch.runtime.trace import _percentile, merge_timelines


def load_run(paths: list) -> tuple:
    """Normalize any input form into ``(events, profiles, meta)``: one
    clock-aligned event list, ``{rank: otpu-prof payload}`` for every
    rank whose artifact carried profile metadata, and a run-metadata
    dict — ``events_overwritten`` per rank (the ring-wrap honesty
    counter a critical path must disclose: a silently truncated
    timeline attributes blame it never saw) plus ``payload_ranks``
    (ranks whose payloads were present even with ZERO spans — crash
    bundles produce those, and a vanished rank is itself a finding).

    Accepts merged-timeline files (events already aligned, ``pid`` =
    rank), per-rank payload files (aligned here via each payload's
    ``clock_offset_us``), flight-recorder bundles (``merged_tail``;
    per-rank profile snapshots under ``dumps``), and directories
    (prefer ``trace_merged.json`` for events, but ALWAYS scan the
    per-rank ``trace_rank*.json`` files too — the merged file drops
    the profile breakdown)."""
    files: list = []
    for p in paths:
        if os.path.isdir(p):
            merged = os.path.join(p, "trace_merged.json")
            ranks = sorted(glob.glob(os.path.join(p, "trace_rank*.json")))
            if os.path.exists(merged):
                files.append(merged)
                files.extend((r, "profile-only") for r in ranks)
            else:
                files.extend(ranks)
        else:
            files.append(p)
    if not files:
        raise SystemExit("otpu_analyze: no timeline files found")
    events: list = []
    payloads: list = []       # per-rank payloads: align via THE merger
    profiles: dict = {}
    meta: dict = {"events_overwritten": {}, "payload_ranks": []}
    for entry in files:
        path, meta_only = (entry if isinstance(entry, tuple)
                           else (entry, None))
        with open(path) as f:
            doc = json.load(f)
        if "merged_tail" in doc:                  # flight bundle
            events.extend(doc["merged_tail"])
            for r, dump in (doc.get("dumps") or {}).items():
                if isinstance(dump, dict) and dump.get("profile"):
                    profiles[int(r)] = dump["profile"]
        elif "traceEvents" in doc:
            m = doc.get("metadata", {})
            if m.get("rank") is not None:
                rank = int(m["rank"])
                if m.get("profile"):
                    profiles[rank] = m["profile"]
                if rank not in meta["payload_ranks"]:
                    meta["payload_ranks"].append(rank)
                if m.get("events_overwritten"):
                    meta["events_overwritten"][rank] = \
                        int(m["events_overwritten"])
                if not meta_only:
                    payloads.append(doc)          # per-rank payload
            elif not meta_only:
                events.extend(doc["traceEvents"])  # already merged
                # tpurun's merged file carries the per-rank overflow
                # counters forward so a merged-only analyze stays honest
                for r, n in (m.get("events_overwritten") or {}).items():
                    if n:
                        meta["events_overwritten"][int(r)] = int(n)
        else:
            raise SystemExit(f"otpu_analyze: {path!r} is not a trace "
                             "timeline, payload, or flight bundle")
    if payloads:
        events.extend(merge_timelines(payloads))
    events.sort(key=lambda e: float(e.get("ts", 0.0)))
    meta["payload_ranks"].sort()
    return events, profiles, meta


def load_events(paths: list) -> list:
    """Back-compat wrapper over :func:`load_run` (events only)."""
    return load_run(paths)[0]


def _coll_rounds(events: list) -> dict:
    """(name, cid) -> {rank: [(ts, dur)]} for collective X-spans."""
    table: dict = {}
    for ev in events:
        if ev.get("cat") != "coll" or ev.get("ph") != "X":
            continue
        eargs = ev.get("args") or {}
        key = (ev.get("name"), eargs.get("cid"))
        table.setdefault(key, {}).setdefault(
            int(ev.get("pid", 0)), []).append(
            (float(ev["ts"]), float(ev.get("dur", 0.0))))
    return table


def _union_us(intervals: list) -> float:
    """Total covered microseconds of possibly-overlapping (start, dur)
    intervals."""
    if not intervals:
        return 0.0
    intervals = sorted(intervals)
    total = 0.0
    cur_lo, cur_hi = intervals[0][0], intervals[0][0] + intervals[0][1]
    for lo, dur in intervals[1:]:
        hi = lo + dur
        if lo > cur_hi:
            total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    return total + (cur_hi - cur_lo)


#: otpu-prof stage -> decomposition bucket: the five-way per-message
#: breakdown the acceptance reports use.  ``wire`` is the only
#: kernel-handoff bucket; every other stage is host software time.
_BUCKETS = {
    "pack": ("send.pack", "send.staging"),
    "queue": ("send.queue",),
    "wire": ("send.wire",),
    "parse": ("recv.parse",),
    "deliver": ("recv.deliver", "recv.complete"),
}
_HOST_BUCKETS = ("pack", "queue", "parse", "deliver")


def _host_overhead(profiles: dict, windows: dict,
                   coll_by_rank: dict) -> dict:
    """Per-rank otpu-prof report: the five-bucket per-message
    decomposition, exposed-host fraction, and the stage-sum vs
    end-to-end reconciliation (see module docstring)."""
    out: dict = {}
    for rank in sorted(profiles):
        prof = profiles[rank] or {}
        stages = prof.get("stages") or {}
        decomp: dict = {}
        for bucket, names in _BUCKETS.items():
            n = total = 0.0
            for s in names:
                row = stages.get(s)
                if row:
                    n = max(n, float(row.get("n", 0)))
                    total += float(row.get("sum_us", 0.0))
            if n:
                decomp[bucket] = {"n": int(n),
                                  "total_us": round(total, 1),
                                  "mean_us": round(total / n, 2)}
        stage_sum = sum(d["total_us"] for d in decomp.values())
        host_sum = sum(decomp[b]["total_us"] for b in _HOST_BUCKETS
                       if b in decomp)
        colls = coll_by_rank.get(rank, [])
        e2e = sum(dur for _ts, dur in colls)
        # denominator: prefer the profile's own covered window
        # (arm->export) — the stage totals span the WHOLE run, while
        # the trace-event window only spans what survived the bounded
        # ring, which would inflate the fraction on long runs
        lo, hi = windows.get(rank, (0.0, 0.0))
        wall = float(prof.get("elapsed_us") or 0.0) or (hi - lo)
        row = {
            "decomposition": decomp,
            "stage_sum_us": round(stage_sum, 1),
            "host_stage_us": round(host_sum, 1),
            "exposed_host_fraction": round(host_sum / wall, 3)
            if wall > 0 else 0.0,
        }
        if e2e > 0:
            row["coll_e2e_us"] = round(e2e, 1)
            row["stage_over_e2e"] = round(stage_sum / e2e, 3)
        if prof.get("profiler"):
            row["profiler"] = prof["profiler"]
        out[str(rank)] = row
    return out


# -- critical path (otpu-crit) -------------------------------------------

#: STAGES groups the per-bucket on-path comm time is decomposed into
#: when otpu-prof payloads ride along (proportional to the rank's own
#: measured stage sums — the path tells WHERE the time sits, the stage
#: clocks tell WHAT the host was doing there)
_STAGE_GROUPS = {
    "send": ("send.pack", "send.staging", "send.queue", "send.wire"),
    "recv": ("recv.parse", "recv.deliver", "recv.complete"),
    "coll": ("coll.decide", "coll.alg"),
}


def _latest_before(spans: list, t: float) -> Optional[tuple]:
    """Latest span (by start) in a start-sorted list with start
    STRICTLY before ``t`` — strictness is what keeps the backward walk
    from revisiting the span it just jumped out of."""
    i = bisect.bisect_left(spans, (t,))
    return spans[i - 1] if i else None


def _overlap_us(spans: list, lo: float, hi: float) -> float:
    """Union-microseconds of start-sorted (start, end, ...) spans
    clipped to [lo, hi]."""
    total = 0.0
    cur = lo
    i = bisect.bisect_left(spans, (lo,))
    if i:
        prev = spans[i - 1]
        if prev[1] > lo:
            i -= 1
    for s in spans[i:]:
        if s[0] >= hi:
            break
        a, b = max(s[0], cur), min(s[1], hi)
        if b > a:
            total += b - a
            cur = b
    return total


def _crit_prepare(events: list, step_span: Optional[str]) -> dict:
    """Index the merged timeline for the walk: per-rank sorted span
    lists, collective rounds keyed by (name, cid, cseq), message edges
    keyed by flow id, and per-(step index, rank) windows."""
    colls: dict = {}     # rank -> [(ts, end, name, cid, cseq, nbytes)]
    sends: dict = {}     # fid -> (rank, send-complete ts)
    recvs: dict = {}     # rank -> [(ts, end, fid)]
    pml: dict = {}       # rank -> {"send": [(ts, end)], "recv": ...}
    steps: dict = {}     # step idx -> {rank: (ts, end)}
    rounds: dict = {}    # (name, cid, cseq) -> {rank: (ts, end)}
    step_counts: dict = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        r = int(ev.get("pid", 0))
        ts = float(ev["ts"])
        end = ts + float(ev.get("dur", 0.0))
        cat = ev.get("cat")
        eargs = ev.get("args") or {}
        if cat == "coll":
            cseq = eargs.get("cseq")
            nbytes = int(eargs.get("nbytes", 0) or 0)
            colls.setdefault(r, []).append(
                (ts, end, ev.get("name"), eargs.get("cid"), cseq, nbytes))
            if cseq is not None:
                rounds.setdefault(
                    (ev.get("name"), eargs.get("cid"), cseq), {})[r] = \
                    (ts, end)
        elif cat == "pml":
            kind = "send" if ev.get("name") == "send" else "recv"
            pml.setdefault(r, {"send": [], "recv": []})[kind].append(
                (ts, end))
            fid = eargs.get("fid")
            if fid:
                # span args carry the key as a tuple (JSON: a list);
                # normalize so send/recv sides hash identically
                if isinstance(fid, (list, tuple)):
                    fid = tuple(fid)
                if kind == "send":
                    sends[fid] = (r, end)
                else:
                    recvs.setdefault(r, []).append((ts, end, fid))
        if cat == "step" or ev.get("name") == (step_span or "step"):
            idx = eargs.get("step")
            if idx is None:     # no index arg: per-rank occurrence order
                idx = step_counts.get(r, 0)
            step_counts[r] = step_counts.get(r, 0) + 1
            steps.setdefault(idx, {})[r] = (ts, end)
    for table in (colls, recvs):
        for spans in table.values():
            spans.sort()
    for by_kind in pml.values():
        by_kind["send"].sort()
        by_kind["recv"].sort()
    # recv jump candidates: only recvs NOT nested inside a coll span on
    # the same rank (a collective's internal recvs are subsumed by the
    # round's barrier edge)
    standalone: dict = {}
    for r, spans in recvs.items():
        mine = colls.get(r, [])
        keep = []
        for ts, end, fid in spans:
            i = bisect.bisect_left(mine, (ts,))
            inside = bool(i and mine[i - 1][1] >= end) or \
                bool(i < len(mine) and mine[i][0] <= ts
                     and mine[i][1] >= end)
            if not inside:
                keep.append((ts, end, fid))
        standalone[r] = keep
    return {"colls": colls, "sends": sends, "recvs": standalone,
            "pml": pml, "steps": steps, "rounds": rounds}


def _walk_step(idx, windows: dict, ix: dict) -> Optional[dict]:
    """Extract one step's critical path by walking backward from the
    step's completion: inside a collective round, the time after the
    last member's arrival is shared algorithm work ON the path, and the
    path then jumps to the last-arriving rank (barrier edge); inside a
    matched recv, it jumps to the sender at send-complete (message
    edge); everything else is the current rank's own program order."""
    home = max(windows, key=lambda r: windows[r][1])
    r, t = home, windows[home][1]
    lo_all = min(w[0] for w in windows.values())
    segments: list = []   # (rank, lo, hi, kind, key)
    for _guard in range(100000):
        lo_r = windows.get(r, (lo_all, 0.0))[0]
        if t <= lo_r + 1e-9:
            break
        cand_c = _latest_before(ix["colls"].get(r, []), t)
        if cand_c is not None and cand_c[0] < lo_r:
            cand_c = None
        cand_m = _latest_before(ix["recvs"].get(r, []), t)
        if cand_m is not None and cand_m[0] < lo_r:
            cand_m = None
        if cand_c is None and cand_m is None:
            segments.append((r, lo_r, t, "gap", None))
            break
        if cand_m is not None and (cand_c is None
                                   or cand_m[0] > cand_c[0]):
            ts_v, end_v, fid = cand_m
            if end_v < t:
                segments.append((r, end_v, t, "gap", None))
                t = end_v
            snd = ix["sends"].get(fid)
            if snd is not None and snd[0] != r and snd[1] > ts_v:
                # message edge: recv waited on the sender
                seg_lo = min(t, max(ts_v, snd[1]))
                segments.append((r, seg_lo, t, "msg", None))
                r, t = snd[0], min(snd[1], t)
                continue
            segments.append((r, ts_v, t, "msg", None))
            t = ts_v
            continue
        ts_c, end_c, name, cid, cseq, nbytes = cand_c
        if end_c < t:
            segments.append((r, end_c, t, "gap", None))
            t = end_c
        member = ix["rounds"].get((name, cid, cseq)) \
            if cseq is not None else None
        if member and len(member) > 1:
            last_rank = max(member, key=lambda rr: member[rr][0])
            last_start = member[last_rank][0]
            if last_rank != r and last_start > ts_c:
                # barrier edge: work after last arrival is on the path
                # here; the wait before it belongs to the last arriver
                seg_lo = min(t, max(ts_c, last_start))
                segments.append((r, seg_lo, t, "coll", (name, nbytes)))
                r, t = last_rank, min(last_start, t)
                continue
        segments.append((r, ts_c, t, "coll", (name, nbytes)))
        t = ts_c
    if not segments:
        return None
    return {"home": home, "segments": segments,
            "wall_us": windows[home][1] - lo_all}


def _crit_step_report(idx, walk: dict, ix: dict) -> tuple:
    """Fold one walk into ``(per-step report row, per-(coll, size-bin)
    critical contributions, on-path us per rank)`` — the row carries
    buckets, the bounding rank, and the step's critical exposed-comm
    fraction; the other two aggregate across steps."""
    from ompi_tpu_torch.runtime.trace import _bin_label

    home = walk["home"]
    on_path: dict = {}
    buckets = {"compute": 0.0, "send": 0.0, "recv": 0.0, "coll": 0.0}
    blocked: dict = {}
    coll_crit: dict = {}
    for rk, lo, hi, kind, key in walk["segments"]:
        us = hi - lo
        if us <= 0:
            continue
        on_path[rk] = on_path.get(rk, 0.0) + us
        if rk != home:
            blocked[rk] = blocked.get(rk, 0.0) + us
        if kind == "coll":
            buckets["coll"] += us
            name, nbytes = key
            ck = f"{name}/{_bin_label(int(nbytes).bit_length())}"
            cell = coll_crit.setdefault(ck, [0.0, 0])
            cell[0] += us
            cell[1] = max(cell[1], int(nbytes))
        elif kind == "msg":
            buckets["recv"] += us
        else:
            spans = ix["pml"].get(rk, {})
            snd = _overlap_us(spans.get("send", []), lo, hi)
            rcv = _overlap_us(spans.get("recv", []), lo, hi)
            buckets["send"] += snd
            buckets["recv"] += rcv
            buckets["compute"] += max(0.0, us - snd - rcv)
    path_us = sum(on_path.values())
    comm_us = buckets["coll"] + buckets["send"] + buckets["recv"]
    row = {
        "step": idx,
        "wall_us": round(walk["wall_us"], 1),
        "bound_by": max(on_path, key=on_path.get),
        "on_path_us": {str(r): round(v, 1)
                       for r, v in sorted(on_path.items())},
        "buckets": {k: round(v, 1) for k, v in buckets.items()},
        "blocked_on": {str(r): round(v, 1)
                       for r, v in sorted(blocked.items())},
        "critical_exposed_comm": round(comm_us / path_us, 3)
        if path_us > 0 else 0.0,
    }
    return row, coll_crit, on_path


def critical_path_report(events: list, profiles: Optional[dict] = None,
                         step_span: Optional[str] = None) -> dict:
    """The --critical-path section: per-step attribution rows, the
    most-often-bounding rank, top-blockers table, overall critical
    exposed-comm fraction, per-(coll, size-bin) critical contributions,
    and — when otpu-prof profiles ride along — a STAGES-group blame
    decomposition per rank."""
    ix = _crit_prepare(events, step_span)
    if not ix["steps"]:
        return {"steps": [], "note": "no step spans found (record "
                "trace.span(..., cat='step') or pass --step-span)"}
    steps_out: list = []
    bound_counts: dict = {}
    coll_crit_all: dict = {}
    on_path_all: dict = {}
    comm_on_path = path_total = 0.0
    for idx in sorted(ix["steps"], key=lambda v: (str(type(v)), v)):
        windows = ix["steps"][idx]
        walk = _walk_step(idx, windows, ix)
        if walk is None:
            continue
        row, coll_crit, on_path = _crit_step_report(idx, walk, ix)
        steps_out.append(row)
        bound_counts[row["bound_by"]] = \
            bound_counts.get(row["bound_by"], 0) + 1
        for k, (us, nb) in coll_crit.items():
            cell = coll_crit_all.setdefault(k, [0.0, 0])
            cell[0] += us
            cell[1] = max(cell[1], nb)
        for r, us in on_path.items():
            on_path_all[r] = on_path_all.get(r, 0.0) + us
        b = row["buckets"]
        comm_on_path += b["coll"] + b["send"] + b["recv"]
        path_total += sum(b.values())
    if not steps_out:
        return {"steps": [], "note": "no walkable steps"}
    bound_rank = max(bound_counts, key=bound_counts.get)
    report = {
        "steps": steps_out,
        "bound_by": {
            "rank": bound_rank,
            "fraction": round(bound_counts[bound_rank]
                              / len(steps_out), 3),
            "counts": {str(r): n
                       for r, n in sorted(bound_counts.items())},
        },
        "critical_exposed_comm": round(comm_on_path / path_total, 3)
        if path_total > 0 else 0.0,
        "top_blockers": [
            {"rank": r, "steps_bound": bound_counts.get(r, 0),
             "on_path_us": round(us, 1)}
            for r, us in sorted(on_path_all.items(),
                                key=lambda kv: -kv[1])],
        "coll_critical_us": {k: round(v[0], 1) for k, v in
                             sorted(coll_crit_all.items(),
                                    key=lambda kv: -kv[1][0])},
        "_coll_critical_nbytes": {k: v[1]
                                  for k, v in coll_crit_all.items()},
    }
    if profiles:
        report["stage_blame"] = _stage_blame(on_path_all, ix, profiles)
    return report


def _stage_blame(on_path_all: dict, ix: dict, profiles: dict) -> dict:
    """Per-rank STAGES-group decomposition of the rank's on-path time:
    the comm share splits across the rank's measured stage sums within
    each group (otpu-prof rode in the payload metadata); a rank with no
    profile keeps the coarse group totals."""
    out: dict = {}
    for r, total in sorted(on_path_all.items()):
        stages = ((profiles.get(r) or {}).get("stages")
                  or {}) if profiles else {}
        row: dict = {"on_path_us": round(total, 1)}
        for group, names in _STAGE_GROUPS.items():
            sums = {s: float((stages.get(s) or {}).get("sum_us", 0.0))
                    for s in names}
            gsum = sum(sums.values())
            if gsum > 0:
                row[group] = {s: round(v / gsum, 3)
                              for s, v in sums.items() if v > 0}
        out[str(r)] = row
    return out


# -- per-request decomposition (otpu-req) --------------------------------

#: serve_req span name -> stage key of the six-way decomposition
_REQ_SPAN_STAGE = {"req_queue": "queue", "req_dispatch": "dispatch",
                   "req_prefill": "prefill", "req_kv": "kv",
                   "req_decode": "decode", "req_stream": "stream"}
#: report order of the six per-request stages
REQ_STAGES = ("queue", "dispatch", "prefill", "kv", "decode", "stream")


def _req_collect(events: list) -> tuple:
    """Group the otpu-req layer's artifacts by request id: ``serve_req``
    stage spans (router + worker ranks of the merged timeline) and the
    ``rid.hop`` flow halves of each request's causal arrow chain."""
    spans: dict = {}
    flows: dict = {}
    for ev in events:
        ph = ev.get("ph")
        if ph == "X" and ev.get("cat") == "serve_req":
            eargs = ev.get("args") or {}
            rid = eargs.get("rid")
            stage = _REQ_SPAN_STAGE.get(ev.get("name"))
            if rid is None or stage is None:
                continue
            ts = float(ev["ts"])
            spans.setdefault(int(rid), {}).setdefault(stage, []).append(
                (ts, ts + float(ev.get("dur", 0.0)),
                 int(ev.get("pid", 0)), eargs))
        elif ph in ("s", "f") and ev.get("name") == "serve_req":
            rid_s, _, hop_s = str(ev.get("id", "")).rpartition(".")
            try:
                rid, hop = int(rid_s), int(hop_s)
            except ValueError:
                continue
            flows.setdefault(rid, {}).setdefault(hop, {})[ph] = (
                int(ev.get("pid", 0)), float(ev.get("ts", 0.0)))
    return spans, flows


def _req_decompose(stages: dict) -> Optional[dict]:
    """One request's six-stage decomposition, or None when the request
    is not reconstructable (the router's four lifecycle spans plus the
    worker prefill span must all have survived the ring — an
    incomplete request cannot reconcile against its own e2e)."""
    if any(s not in stages
           for s in ("queue", "dispatch", "decode", "stream", "prefill")):
        return None
    # the router spans emit exactly once (at _finish); worker
    # prefill/kv spans may repeat across requeue replays, so those
    # stages SUM
    row = {s: round(sum(e - t for t, e, _p, _a in stages.get(s, ())), 1)
           for s in REQ_STAGES}
    first = stages["queue"][-1]
    last = stages["stream"][-1]
    e2e = last[1] - first[0]
    if e2e <= 0:
        return None
    # colocated mode runs prefill INSIDE the decode window (the first
    # work command carries it): clip the overlap out of the decode
    # stage so the six stages partition the e2e instead of double-
    # counting it.  Staged mode's prefill/kv sit in the dispatch ->
    # decode gap, so nothing clips there.
    dlo, dhi = stages["decode"][-1][0], stages["decode"][-1][1]
    overlap = 0.0
    for s in ("prefill", "kv"):
        for t, e, _p, _a in stages.get(s, ()):
            overlap += max(0.0, min(e, dhi) - max(t, dlo))
    row["decode"] = round(max(0.0, row["decode"] - overlap), 1)
    # staged mode pipelines the decode-side slab read against the
    # prefill compute (the per-sequence Pready keys make blocks
    # visible as they land), so the kv wait's head is covered by
    # prefill time — clip it too, same double-count rule
    kv_overlap = 0.0
    for tp, ep, _pp, _ap in stages.get("prefill", ()):
        for tk, ek, _pk, _ak in stages.get("kv", ()):
            kv_overlap += max(0.0, min(ep, ek) - max(tp, tk))
    row["kv"] = round(max(0.0, row["kv"] - kv_overlap), 1)
    eargs = last[3]
    return {"stages": row, "e2e_us": round(e2e, 1),
            "ratio": round(sum(row.values()) / e2e, 3),
            "tenant": str(eargs.get("tenant") or ""),
            "pool": str(eargs.get("pool") or ""),
            "worker": eargs.get("worker"),
            "prefill_rank": stages["prefill"][-1][2]}


def requests_report(events: list,
                    slo_ms: Optional[float] = None) -> dict:
    """The --requests section: per-request six-stage decompositions
    reconciled against each request's own e2e, the exact-p99 tail
    cohort with its dominant stage / hottest tenant / bounding worker,
    flow-chain completeness (one causal arrow chain per request across
    router and worker ranks), and — given ``--slo-ms`` — the exact
    per-request breach fraction the telemetry plane's rolling-window
    burn rate must agree with."""
    spans, flows = _req_collect(events)
    reqs: dict = {}
    for rid, st in spans.items():
        d = _req_decompose(st)
        if d is not None:
            reqs[rid] = d
    total = len(spans)
    out: dict = {
        "requests_seen": total,
        "decomposed": len(reqs),
        "decomposed_fraction": round(len(reqs) / total, 3)
        if total else 0.0,
    }
    if not reqs:
        out["note"] = ("no decomposable serve_req spans — run with "
                       "otpu_trace_requests set and analyze the MERGED "
                       "timeline (router and worker ranks each hold "
                       "half the stages)")
        return out
    e2e_sorted = sorted(d["e2e_us"] for d in reqs.values())
    ratios = sorted(d["ratio"] for d in reqs.values())
    out["stage_median_us"] = {
        s: round(_percentile(sorted(d["stages"][s]
                                    for d in reqs.values()), 0.50), 1)
        for s in REQ_STAGES}
    out["e2e_us"] = {"p50": round(_percentile(e2e_sorted, 0.50), 1),
                     "p99": round(_percentile(e2e_sorted, 0.99), 1),
                     "max": round(e2e_sorted[-1], 1)}
    out["stage_over_e2e"] = {"min": ratios[0],
                             "p50": round(_percentile(ratios, 0.50), 3),
                             "max": ratios[-1]}
    # exact p99 tail cohort (the rolling histograms estimate p99; the
    # cohort is computed from the exact per-request samples)
    p99 = _percentile(e2e_sorted, 0.99)
    cohort = {rid: d for rid, d in reqs.items() if d["e2e_us"] >= p99}
    stage_sums = {s: sum(d["stages"][s] for d in cohort.values())
                  for s in REQ_STAGES}
    dom = max(stage_sums, key=stage_sums.get)
    tenants: dict = {}
    workers: dict = {}
    for d in cohort.values():
        tenants[d["tenant"]] = tenants.get(d["tenant"], 0) + 1
        # blame lands on the rank that RAN the dominant stage: the
        # prefill rank for prefill/kv tails, the decode worker else
        w = d["prefill_rank"] if dom in ("prefill", "kv") \
            else d["worker"]
        workers[w] = workers.get(w, 0.0) + d["e2e_us"]
    tail_total = sum(stage_sums.values()) or 1.0
    out["tail"] = {
        "p99_us": round(p99, 1),
        "cohort": len(cohort),
        "rids": sorted(cohort)[:8],
        "dominant_stage": dom,
        "dominant_share": round(stage_sums[dom] / tail_total, 3),
        "hottest_tenant": max(tenants, key=tenants.get),
        "bounding_worker": max(workers, key=workers.get),
    }
    # flow-chain completeness: every emitted hop has both halves and
    # the chain runs dispatch (0) .. completion (2) — the merged
    # timeline renders one arrow chain per complete request
    complete = 0
    sample = None
    for rid in sorted(flows):
        hops = flows[rid]
        if 0 in hops and max(hops) == 2 and all(
                "s" in h and "f" in h for h in hops.values()):
            complete += 1
            if sample is None or len(hops) > len(sample["hops"]):
                sample = {"rid": rid, "hops": [
                    f"{hop}:r{h['s'][0]}->r{h['f'][0]}"
                    for hop, h in sorted(hops.items())]}
    out["flows"] = {"chains_seen": len(flows),
                    "chains_complete": complete,
                    "sample": sample}
    if slo_ms:
        from ompi_tpu_torch.runtime.telemetry import SLO_BUDGET

        breaches = sum(1 for v in e2e_sorted
                       if v / 1000.0 > float(slo_ms))
        frac = breaches / len(e2e_sorted)
        out["slo_exact"] = {"target_ms": float(slo_ms),
                            "requests": len(e2e_sorted),
                            "breaches": breaches,
                            "breach_fraction": round(frac, 4),
                            "burn": round(frac / SLO_BUDGET, 3)}
    return out


_LADDER_VERSION = 1


def suggest_ladder(report: dict, comm_size: int) -> str:
    """Render the per-(coll, size-bin) critical contributions as a
    draft dynamic-rules file in the EXACT format ``coll/tuned.py``
    loads (``_load_rules``; one rule per line, first match wins).

    The draft is **behavior-identical by construction**: for every
    collective with critical-path time it emits the fixed ladder's
    whole breakpoint table up through the hot cells
    (``tuned.ladder_rules`` — a lone hot-cell row would silently
    extend that cell's pick to every smaller message, since the
    grammar has no lower bound), with the measured critical share
    annotated on the rows the hot cells land in.  Loading it changes
    NO pick — it marks exactly which cells a benchmark ladder sweep is
    worth running on, and the autotuner's improved picks then diff
    against a checked-in baseline.  Commutativity caveat: the rule
    grammar cannot express it, so tuned applies dynamic rules to
    commutative reductions only (non-commutative ops keep the fixed
    ladder's order-safe picks) and the draft pins the commutative
    incumbents.  Note the one deliberate perf side effect of ANY
    loaded rules file: tuned's small-allreduce eager lane disables
    itself so overrides are never masked."""
    from ompi_tpu_torch.mca.coll.tuned import _MENUS, ladder_rules

    crit = report.get("critical_path") or report
    cells = crit.get("coll_critical_us") or {}
    nbytes_by_key = crit.get("_coll_critical_nbytes") or {}
    total = sum(cells.values()) or 1.0
    lines = [
        f"# otpu-crit suggested tuning ladder v{_LADDER_VERSION}",
        f"# source: otpu_analyze --suggest-ladder over "
        f"{len(crit.get('steps') or [])} steps, comm_size {comm_size}",
        "# schema: coll  max_comm_size  max_bytes  algorithm  [segsize]",
        "# behavior-identical draft: every row pins the fixed ladder's",
        "# own incumbent (commutative form; non-commutative ops ignore",
        "# dynamic rules); rows marked critical_us sat on the measured",
        "# critical path — sweep those with a benchmark ladder before",
        "# promoting a different algorithm",
    ]
    # hot-cell upper bounds per collective: (cap_bytes, {max_bin_bound:
    # (us, share)}) — the cap decides how far the breakpoint table runs
    per_coll: dict = {}
    for key, us in cells.items():
        name = key.rsplit("/", 1)[0]
        if name not in _MENUS:
            continue        # device *_array entry points have no ladder
        nbytes = int(nbytes_by_key.get(key, 0))
        hi = (1 << int(nbytes).bit_length()) - 1 if nbytes else 0
        cap, hot = per_coll.setdefault(name, [0, {}])
        per_coll[name][0] = max(cap, hi)
        hot[hi] = hot.get(hi, 0.0) + us
    for name in sorted(per_coll):
        cap, hot = per_coll[name]
        for max_bytes, alg in ladder_rules(name, comm_size, cap):
            # annotate the row each hot cell falls under (the first
            # rule whose bound covers the cell's bin)
            marks = [f"critical_us={us:.1f} share={us / total:.2f} "
                     f"(<= {hi}b)"
                     for hi, us in sorted(hot.items())
                     if hi <= max_bytes]
            for hi in [h for h in hot if h <= max_bytes]:
                del hot[hi]
            for m in marks:
                lines.append(f"# {m}")
            lines.append(f"{name}  {comm_size}  {max_bytes}  {alg}")
    if not per_coll:
        lines.append("# (no collective time on the critical path)")
    return "\n".join(lines) + "\n"


def analyze(events: list, step_span: Optional[str] = None,
            profiles: Optional[dict] = None,
            meta: Optional[dict] = None,
            critical_path: bool = False,
            requests: bool = False,
            slo_ms: Optional[float] = None) -> dict:
    """The full report over one clock-aligned event list (see module
    docstring for the sections).  ``meta`` is :func:`load_run`'s third
    element (overflow counters + payload ranks); ``critical_path``
    adds the otpu-crit section (it walks every step, so it is opt-in
    on the CLI); ``requests`` adds the otpu-req per-request section."""
    ranks = sorted({int(e.get("pid", 0)) for e in events}
                   | set((meta or {}).get("payload_ranks") or []))
    per_coll: dict = {}
    last_arrival: dict = {r: 0 for r in ranks}
    all_spreads: list = []
    rounds_total = 0
    for (name, cid), by_rank in sorted(
            _coll_rounds(events).items(),
            key=lambda kv: (str(kv[0][0]), str(kv[0][1]))):
        members = sorted(by_rank)
        if len(members) < 2:
            continue
        rounds = min(len(by_rank[r]) for r in members)
        if rounds == 0:
            continue
        tails = {r: by_rank[r][len(by_rank[r]) - rounds:]
                 for r in members}
        spreads: list = []
        last_count: dict = {}
        for k in range(rounds):
            starts = {r: tails[r][k][0] for r in members}
            last = max(starts, key=starts.get)
            last_count[last] = last_count.get(last, 0) + 1
            last_arrival[last] = last_arrival.get(last, 0) + 1
            spreads.append(max(starts.values()) - min(starts.values()))
        rounds_total += rounds
        all_spreads.extend(spreads)
        spreads.sort()
        slowest = max(last_count, key=last_count.get)
        per_coll[f"{name}/cid{cid}"] = {
            "rounds": rounds,
            "ranks": members,
            "straggler_rank": slowest,
            "straggler_fraction": round(last_count[slowest] / rounds, 3),
            "last_arrivals": {str(r): last_count.get(r, 0)
                              for r in members},
            "skew_us": {
                "mean": round(sum(spreads) / rounds, 1),
                "p50": round(_percentile(spreads, 0.50), 1),
                "p99": round(_percentile(spreads, 0.99), 1),
                "max": round(spreads[-1], 1),
            },
        }
    # one grouping pass (events are large; steps can be many — never
    # rescan the whole list per rank or per step)
    spans_by_rank: dict = {}     # rank -> [(ts, ts+dur)] of X-spans
    coll_by_rank: dict = {}      # rank -> sorted [(ts, dur)] of colls
    step_spans: list = []        # (rank, ts, dur, args)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        r = int(ev.get("pid", 0))
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        spans_by_rank.setdefault(r, []).append((ts, ts + dur))
        if ev.get("cat") == "coll":
            coll_by_rank.setdefault(r, []).append((ts, dur))
        if ev.get("cat") == "step" \
                or ev.get("name") == (step_span or "step"):
            step_spans.append((r, ts, dur, ev.get("args") or {}))
    for spans in coll_by_rank.values():
        spans.sort()
    # exposed-communication fraction per rank (interval union); the
    # observed window doubles as the host-overhead denominator
    exposed: dict = {}
    windows: dict = {}
    for r in ranks:
        mine = spans_by_rank.get(r)
        if not mine:
            continue
        lo = min(t0 for t0, _t1 in mine)
        hi = max(t1 for _t0, t1 in mine)
        windows[r] = (lo, hi)
        comm = _union_us(coll_by_rank.get(r, []))
        exposed[str(r)] = round(comm / (hi - lo), 3) if hi > lo else 0.0
    # per-step breakdown when step spans exist (bisect into the rank's
    # sorted coll starts instead of rescanning the event list)
    steps: dict = {}
    for r, lo, dur, eargs in step_spans:
        colls = coll_by_rank.get(r, [])
        i = bisect.bisect_left(colls, (lo, float("-inf")))
        j = bisect.bisect_left(colls, (lo + dur, float("-inf")))
        comm = _union_us(colls[i:j])
        idx = eargs.get("step", len(steps.get(str(r), [])))
        steps.setdefault(str(r), []).append(
            {"step": idx, "exposed_comm": round(comm / dur, 3)
             if dur > 0 else 0.0})
    all_spreads.sort()
    straggler = (max(last_arrival, key=last_arrival.get)
                 if rounds_total else None)
    overwritten = (meta or {}).get("events_overwritten") or {}
    report = {
        "ranks": ranks,
        # ring-wrap honesty: a wrapped ring silently lost this many
        # events per rank — critical paths over a truncated timeline
        # can lie, so the counter leads the report
        "events_overwritten": {
            "total": sum(overwritten.values()),
            "per_rank": {str(r): int(n)
                         for r, n in sorted(overwritten.items())},
        },
        "rounds_total": rounds_total,
        "straggler": {
            "rank": straggler,
            "fraction": round(last_arrival.get(straggler, 0)
                              / rounds_total, 3) if rounds_total else 0.0,
            "last_arrivals": {str(r): last_arrival.get(r, 0)
                              for r in ranks},
        },
        "skew_us": {
            "mean": round(sum(all_spreads) / len(all_spreads), 1)
            if all_spreads else 0.0,
            "p50": round(_percentile(all_spreads, 0.50), 1),
            "p99": round(_percentile(all_spreads, 0.99), 1),
            "max": round(all_spreads[-1], 1) if all_spreads else 0.0,
        },
        "collectives": per_coll,
        "exposed_comm": exposed,
        "steps": steps,
        "host_overhead": _host_overhead(profiles or {}, windows,
                                        coll_by_rank),
    }
    if critical_path:
        report["critical_path"] = critical_path_report(
            events, profiles=profiles, step_span=step_span)
    if requests:
        report["requests"] = requests_report(events, slo_ms=slo_ms)
    return report


def diff_reports(old: dict, new: dict) -> dict:
    """Regression-friendly comparison of two reports (what a benchmark
    diffs across runs): straggler movement, skew deltas, exposed-comm
    deltas per rank."""
    out: dict = {"straggler_changed":
                 old.get("straggler", {}).get("rank")
                 != new.get("straggler", {}).get("rank"),
                 "straggler": [old.get("straggler", {}).get("rank"),
                               new.get("straggler", {}).get("rank")]}
    for field in ("mean", "p50", "p99", "max"):
        a = float(old.get("skew_us", {}).get(field, 0.0))
        b = float(new.get("skew_us", {}).get(field, 0.0))
        out[f"skew_{field}_us_delta"] = round(b - a, 1)
    exp: dict = {}
    for r in sorted(set(old.get("exposed_comm", {}))
                    | set(new.get("exposed_comm", {}))):
        a = float(old.get("exposed_comm", {}).get(r, 0.0))
        b = float(new.get("exposed_comm", {}).get(r, 0.0))
        exp[r] = round(b - a, 3)
    out["exposed_comm_delta"] = exp
    oh_old = old.get("host_overhead") or {}
    oh_new = new.get("host_overhead") or {}
    if oh_old or oh_new:
        host: dict = {}
        for r in sorted(set(oh_old) | set(oh_new)):
            a = float((oh_old.get(r) or {})
                      .get("exposed_host_fraction", 0.0))
            b = float((oh_new.get(r) or {})
                      .get("exposed_host_fraction", 0.0))
            host[r] = round(b - a, 3)
        out["exposed_host_delta"] = host
    cp_old = old.get("critical_path") or {}
    cp_new = new.get("critical_path") or {}
    if cp_old or cp_new:
        a = (cp_old.get("bound_by") or {}).get("rank")
        b = (cp_new.get("bound_by") or {}).get("rank")
        out["critical_bound_by_changed"] = a != b
        out["critical_bound_by"] = [a, b]
        out["critical_exposed_comm_delta"] = round(
            float(cp_new.get("critical_exposed_comm", 0.0))
            - float(cp_old.get("critical_exposed_comm", 0.0)), 3)
        colls: dict = {}
        for k in sorted(set(cp_old.get("coll_critical_us") or {})
                        | set(cp_new.get("coll_critical_us") or {})):
            colls[k] = round(
                float((cp_new.get("coll_critical_us") or {})
                      .get(k, 0.0))
                - float((cp_old.get("coll_critical_us") or {})
                        .get(k, 0.0)), 1)
        out["coll_critical_us_delta"] = colls
    return out


def render_text(report: dict, parsable: bool = False) -> str:
    ow = report.get("events_overwritten") or {}
    if parsable:
        lines = []
        if ow.get("total"):
            lines.append(f"events_overwritten:{ow['total']}:" + ":".join(
                f"{r}={n}" for r, n in ow["per_rank"].items()))
        s = report["straggler"]
        lines.append(f"straggler:{s['rank']}:{s['fraction']}")
        cp = report.get("critical_path") or {}
        if cp.get("steps"):
            bb = cp["bound_by"]
            lines.append(f"critical_bound_by:{bb['rank']}:"
                         f"{bb['fraction']}:{len(cp['steps'])}")
            lines.append("critical_exposed_comm:"
                         f"{cp['critical_exposed_comm']}")
            for k, us in cp["coll_critical_us"].items():
                lines.append(f"coll_critical_us:{k}:{us}")
        rq = report.get("requests") or {}
        if rq:
            lines.append(f"req:{rq['decomposed']}:"
                         f"{rq['requests_seen']}:"
                         f"{rq['decomposed_fraction']}")
        if rq.get("stage_median_us"):
            for s in REQ_STAGES:
                lines.append(
                    f"req_stage_median:{s}:{rq['stage_median_us'][s]}")
            e = rq["e2e_us"]
            lines.append(f"req_e2e:{e['p50']}:{e['p99']}:{e['max']}")
            ra = rq["stage_over_e2e"]
            lines.append(f"req_ratio:{ra['min']}:{ra['p50']}:{ra['max']}")
            t = rq["tail"]
            lines.append(
                f"req_tail:{t['cohort']}:{t['dominant_stage']}:"
                f"{t['dominant_share']}:{t['hottest_tenant']}:"
                f"{t['bounding_worker']}")
            fl = rq["flows"]
            lines.append(f"req_flows:{fl['chains_complete']}:"
                         f"{fl['chains_seen']}")
            se = rq.get("slo_exact")
            if se:
                lines.append(f"req_slo:{se['target_ms']}:"
                             f"{se['breach_fraction']}:{se['burn']}")
        sk = report["skew_us"]
        lines.append(f"skew_us:{sk['mean']}:{sk['p50']}:{sk['p99']}:"
                     f"{sk['max']}")
        for key, c in report["collectives"].items():
            lines.append(
                f"coll:{key}:{c['rounds']}:{c['straggler_rank']}:"
                f"{c['straggler_fraction']}:{c['skew_us']['p99']}")
        for r, f in report["exposed_comm"].items():
            lines.append(f"exposed_comm:{r}:{f}")
        for r, h in (report.get("host_overhead") or {}).items():
            lines.append(
                f"exposed_host:{r}:{h['exposed_host_fraction']}:"
                f"{h['host_stage_us']}:{h.get('coll_e2e_us', 0.0)}")
            for bucket, d in h["decomposition"].items():
                lines.append(f"host_stage:{r}:{bucket}:{d['n']}:"
                             f"{d['mean_us']}:{d['total_us']}")
        return "\n".join(lines)
    s = report["straggler"]
    lines = [f"otpu-analyze — {len(report['ranks'])} ranks, "
             f"{report['rounds_total']} matched collective rounds"]
    if ow.get("total"):
        lines.append(
            f"WARNING: {ow['total']} events overwritten by ring wrap "
            f"({', '.join(f'rank {r}: {n}' for r, n in ow['per_rank'].items())}) "
            "— raise otpu_trace_buffer_events; attribution below may "
            "miss the truncated prefix")
    if s["rank"] is not None:
        lines.append(
            f"straggler: rank {s['rank']} arrived last in "
            f"{100 * s['fraction']:.0f}% of rounds "
            f"({s['last_arrivals']})")
    sk = report["skew_us"]
    lines.append(f"inter-rank skew (us): mean {sk['mean']}  "
                 f"p50 {sk['p50']}  p99 {sk['p99']}  max {sk['max']}")
    lines.append("")
    lines.append(f"{'collective':<24} {'rounds':>6} {'straggler':>9} "
                 f"{'fraction':>8} {'skew p99':>9}")
    for key, c in report["collectives"].items():
        lines.append(f"{key:<24} {c['rounds']:>6} "
                     f"{c['straggler_rank']:>9} "
                     f"{c['straggler_fraction']:>8} "
                     f"{c['skew_us']['p99']:>9}")
    lines.append("")
    lines.append("exposed-communication fraction per rank:")
    for r, f in report["exposed_comm"].items():
        lines.append(f"  rank {r}: {100 * f:.1f}%")
    overhead = report.get("host_overhead") or {}
    if overhead:
        lines.append("")
        lines.append("host-overhead decomposition (otpu-prof, per "
                     "occurrence mean us / total us):")
        buckets = ("pack", "queue", "wire", "parse", "deliver")
        lines.append(f"{'rank':>4} " + " ".join(
            f"{b:>15}" for b in buckets)
            + f" {'host%':>6} {'stage/e2e':>9}")
        for r, h in overhead.items():
            cells = []
            for b in buckets:
                d = h["decomposition"].get(b)
                cells.append(f"{d['mean_us']:.1f}/{d['total_us']:.0f}"
                             if d else "-")
            lines.append(
                f"{r:>4} " + " ".join(f"{c:>15}" for c in cells)
                + f" {100 * h['exposed_host_fraction']:>5.1f}%"
                + f" {h.get('stage_over_e2e', '-'):>9}")
            prof = h.get("profiler")
            if prof:
                lines.append(
                    f"     profiler: {prof['samples']} samples, "
                    f"gil_released {prof['gil_released']}, gil_wait "
                    f"{prof['gil_wait']}, top phases "
                    + ", ".join(f"{k}={v}" for k, v in
                                list(prof["phases"].items())[:4]))
    rq = report.get("requests")
    if rq is not None:
        lines.append("")
        lines.append(
            f"per-request decomposition (otpu-req): "
            f"{rq['decomposed']}/{rq['requests_seen']} requests "
            f"decomposed ({100 * rq['decomposed_fraction']:.0f}%)")
        if rq.get("stage_median_us"):
            med = rq["stage_median_us"]
            lines.append("  stage medians (us): " + "  ".join(
                f"{s} {med[s]}" for s in REQ_STAGES))
            e = rq["e2e_us"]
            ra = rq["stage_over_e2e"]
            lines.append(
                f"  e2e us: p50 {e['p50']}  p99 {e['p99']}  max "
                f"{e['max']}; stage-sum/e2e {ra['min']}..{ra['max']} "
                f"(p50 {ra['p50']})")
            t = rq["tail"]
            lines.append(
                f"  p99 tail cohort ({t['cohort']} requests >= "
                f"{t['p99_us']}us): dominant stage "
                f"{t['dominant_stage']} "
                f"({100 * t['dominant_share']:.0f}% of cohort stage "
                f"time), hottest tenant {t['hottest_tenant']!r}, "
                f"bounding worker rank {t['bounding_worker']}")
            fl = rq["flows"]
            lines.append(
                f"  flow chains: {fl['chains_complete']}/"
                f"{fl['chains_seen']} complete"
                + (f"; e.g. rid {fl['sample']['rid']}: "
                   + " ".join(fl["sample"]["hops"])
                   if fl.get("sample") else ""))
            se = rq.get("slo_exact")
            if se:
                lines.append(
                    f"  exact SLO check vs {se['target_ms']}ms: "
                    f"{se['breaches']}/{se['requests']} breaches "
                    f"(fraction {se['breach_fraction']}), burn "
                    f"{se['burn']}x budget")
        elif rq.get("note"):
            lines.append(f"  {rq['note']}")
    cp = report.get("critical_path")
    if cp is not None:
        lines.append("")
        if not cp.get("steps"):
            lines.append(f"critical path: {cp.get('note', 'no steps')}")
            return "\n".join(lines)
        bb = cp["bound_by"]
        lines.append(
            f"critical path over {len(cp['steps'])} steps: bound by "
            f"rank {bb['rank']} in {100 * bb['fraction']:.0f}% of steps "
            f"({bb['counts']}); critical exposed-comm "
            f"{100 * cp['critical_exposed_comm']:.1f}%")
        lines.append("top blockers (time owning the critical path):")
        for row in cp["top_blockers"]:
            lines.append(f"  rank {row['rank']}: "
                         f"{row['on_path_us']:.0f}us on path, bounds "
                         f"{row['steps_bound']} steps")
        if cp["coll_critical_us"]:
            lines.append("collective time ON the critical path "
                         "(per coll/size-bin; --suggest-ladder pins "
                         "these cells):")
            for k, us in list(cp["coll_critical_us"].items())[:8]:
                lines.append(f"  {k}: {us:.0f}us")
        blame = cp.get("stage_blame")
        if blame:
            lines.append("stage blame (otpu-prof group shares of each "
                         "rank's on-path comm):")
            for r, row in blame.items():
                groups = ", ".join(
                    f"{g}[" + " ".join(f"{s.split('.')[1]}={f:.0%}"
                                       for s, f in row[g].items()) + "]"
                    for g in ("send", "recv", "coll") if g in row)
                lines.append(f"  rank {r}: {row['on_path_us']:.0f}us "
                             f"on path {groups}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="otpu_analyze",
        description="Straggler/critical-path analysis over merged "
                    "otpu-trace timelines")
    ap.add_argument("paths", nargs="+",
                    help="trace_merged.json, per-rank trace_rank*.json "
                         "files, a flight bundle, or a trace directory")
    ap.add_argument("--json", default=None, metavar="OUT",
                    dest="json_out",
                    help="Write the JSON report here ('-' = stdout)")
    ap.add_argument("--parsable", action="store_true",
                    help="Colon-separated text output")
    ap.add_argument("--step-span", default=None,
                    help="Span name marking one training step (per-step "
                         "exposed-comm breakdown)")
    ap.add_argument("--critical-path", action="store_true",
                    dest="critical_path",
                    help="Walk each step's cross-rank critical path "
                         "(flow keys + collective round keys) and "
                         "attribute its wall time to {compute, comm "
                         "buckets, blocked-on-rank-R}")
    ap.add_argument("--suggest-ladder", default=None, metavar="OUT",
                    dest="suggest_ladder",
                    help="Write the per-(coll, size-bin) critical "
                         "contributions as a draft coll/tuned dynamic-"
                         "rules file ('-' = stdout); implies "
                         "--critical-path")
    ap.add_argument("--requests", action="store_true",
                    dest="requests",
                    help="Reconstruct per-request stage decompositions "
                         "(otpu-req serve_req spans + rid.hop flow "
                         "chains) and attribute the p99 tail cohort")
    ap.add_argument("--slo-ms", default=None, type=float,
                    dest="slo_ms", metavar="MS",
                    help="With --requests: check the exact per-request "
                         "e2e samples against this SLO target and "
                         "report the exact breach fraction / burn the "
                         "telemetry plane's rolling window must agree "
                         "with")
    ap.add_argument("--diff", default=None, metavar="OLD",
                    help="Compare against a previous JSON report and "
                         "print the deltas")
    args = ap.parse_args(argv)
    events, profiles, meta = load_run(args.paths)
    report = analyze(events, step_span=args.step_span,
                     profiles=profiles, meta=meta,
                     critical_path=bool(args.critical_path
                                        or args.suggest_ladder),
                     requests=bool(args.requests or args.slo_ms),
                     slo_ms=args.slo_ms)
    if args.suggest_ladder:
        text = suggest_ladder(report, comm_size=len(report["ranks"]))
        if args.suggest_ladder == "-":
            print(text, end="")
        else:
            with open(args.suggest_ladder, "w") as f:
                f.write(text)
    if args.json_out:
        encoded = json.dumps(report, indent=1, sort_keys=False)
        if args.json_out == "-":
            print(encoded)
        else:
            with open(args.json_out, "w") as f:
                f.write(encoded)
    if args.diff:
        with open(args.diff) as f:
            old = json.load(f)
        print(json.dumps(diff_reports(old, report), indent=1))
    if not (args.json_out == "-" or args.diff):
        try:
            print(render_text(report, parsable=args.parsable))
        except BrokenPipeError:
            pass   # output piped into head & friends
    return 0


if __name__ == "__main__":
    sys.exit(main())
