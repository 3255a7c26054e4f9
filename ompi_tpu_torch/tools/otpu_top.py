"""otpu_top — attach to a running job and watch it live.

The consumer half of the telemetry plane (``runtime/telemetry.py``):
connects to a job's coordination service from OUTSIDE the job (the
address ``tpurun`` binds — pass ``--coord host:port`` or run inside the
job env where ``OTPU_COORD`` is set), polls every rank's latest
published sample out of the KV space, and renders a per-rank live
table: message/byte rates (from the sampler's own SPC deltas), per-
collective interval p50/p99, transport out-queue depth, staging/serving
occupancy, injected-chaos totals — with stale-rank flagging (a rank
whose sample sequence number stops advancing is marked ``STALE``: it
is wedged, dead, or its sampler lost the coord service).

The port's twin of the JAX package's ``otpu_top``: the same table, rows and
modes over the port's telemetry key and coordination client.

Modes (``python -m ompi_tpu_torch.tools.otpu_top ...``)::

    otpu_top --coord H:P                  # one table and exit
    otpu_top --coord H:P --watch          # refresh until ^C / job end
    otpu_top --coord H:P --json           # one JSON object per poll
    otpu_top --coord H:P --parsable       # colon-separated rows

Exit code 2 means the coordination service was unreachable.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

# the publisher's key constant — renaming it there must not silently
# strand this consumer polling a key nobody writes
from ompi_tpu_torch.runtime.telemetry import _KV_KEY

#: SPC counters summed into the table's msg/s column (one number for
#: "how much traffic is this rank driving")
_MSG_COUNTERS = ("send", "isend", "recv", "irecv", "sendrecv",
                 "bcast", "reduce", "allreduce", "gather", "scatter",
                 "allgather", "alltoall", "reduce_scatter",
                 "device_collectives", "part_msgs")


def _rate(sample: dict, names, per: str = "spc_delta") -> float:
    """Per-second rate of the summed counters from a sample's own
    delta block (delta over one sampler interval)."""
    delta = sample.get(per) or {}
    total = 0.0
    for n in names:
        total += float(delta.get(n, 0))
    iv_ms = float(sample.get("interval_ms") or 0)
    if iv_ms <= 0:
        return 0.0
    return total * 1000.0 / iv_ms


def _msg_rate(sample: dict) -> float:
    """Messages+collectives per second: p2p SPC deltas PLUS collective
    invocations from the trace-histogram deltas — sm-path collectives
    never touch the pml counters, so the histogram is the only live
    signal for them (needs otpu_trace_enable on the job)."""
    hist_n = sum(float(h.get("n", 0))
                 for h in (sample.get("hist") or {}).values())
    iv_ms = float(sample.get("interval_ms") or 0)
    hist_rate = hist_n * 1000.0 / iv_ms if iv_ms > 0 else 0.0
    return _rate(sample, _MSG_COUNTERS) + hist_rate


def _byte_rate(sample: dict) -> float:
    """Bytes per second: max of the SPC wire-byte rate and the
    histogram's collective-payload estimate — NOT their sum: on the
    tcp path a collective's fragments are counted by ``bytes_sent``
    AND land in the histogram (summing would double-count ~2x), while
    on the sm path only the histogram sees them.  max() reports the
    dominant signal either way."""
    hist_b = sum(float(h.get("bytes", 0))
                 for h in (sample.get("hist") or {}).values())
    iv_ms = float(sample.get("interval_ms") or 0)
    hist_rate = hist_b * 1000.0 / iv_ms if iv_ms > 0 else 0.0
    return max(_rate(sample, ("bytes_sent",)), hist_rate)


def _fmt_si(v: float) -> str:
    for unit, div in (("G", 1e9), ("M", 1e6), ("k", 1e3)):
        if abs(v) >= div:
            return f"{v / div:.1f}{unit}"
    return f"{v:.0f}"


class TopSession:
    """Poll state: per-rank last-seen sequence numbers drive the
    stale-rank flag (no sample OR an unchanged seq across a poll gap
    longer than two sampler intervals = stale)."""

    def __init__(self, client, nprocs: int) -> None:
        self.client = client
        self.nprocs = nprocs
        self._last_seq: dict[int, int] = {}
        self._last_advance: dict[int, float] = {}

    def poll(self) -> dict:
        """{rank: sample-or-None} plus freshness bookkeeping."""
        now = time.monotonic()
        out: dict = {}
        for rank in range(self.nprocs):
            # a missing key is a None VALUE (rank not sampling yet); a
            # raised error is the coord service dying — propagate it so
            # the caller can exit instead of rendering all-stale forever
            raw = self.client.get(rank, _KV_KEY, wait=False)
            sample: Optional[dict] = None
            if raw:
                try:
                    sample = json.loads(raw)
                except (TypeError, ValueError):
                    sample = None
            if sample is not None:
                seq = int(sample.get("seq", 0))
                if seq != self._last_seq.get(rank):
                    self._last_seq[rank] = seq
                    self._last_advance[rank] = now
            out[rank] = sample
        return out

    def stale(self, rank: int, sample: Optional[dict]) -> bool:
        if sample is None:
            return True
        iv_s = max(0.05, float(sample.get("interval_ms") or 0) / 1e3)
        # the sample's own wall-clock age catches a long-dead rank's
        # frozen KV entry even on the FIRST poll (where seq tracking
        # has nothing to compare against); generous floor absorbs
        # observer-vs-rank clock skew
        age = time.time() - float(sample.get("t") or 0)
        if age > max(3 * iv_s, 5.0):
            return True
        last = self._last_advance.get(rank)
        return last is None or (time.monotonic() - last) > 2 * iv_s


def _coll_cell(sample: dict, coll: str) -> str:
    h = (sample.get("hist") or {}).get(coll)
    if not h:
        return "-"
    return f"{h['p50_us']:.0f}/{h['p99_us']:.0f}us"


def _host_pct(sample: dict) -> Optional[float]:
    """otpu-prof live host-overhead: the interval's stage-clock time as
    a percentage of the sampling interval (None without a profile
    source — job not run with otpu_profile_stages)."""
    prof = sample.get("profile")
    iv_ms = float(sample.get("interval_ms") or 0)
    if not prof or iv_ms <= 0:
        return None
    return 100.0 * float(prof.get("host_us", 0.0)) / (iv_ms * 1000.0)


def _host_cell(sample: dict) -> str:
    pct = _host_pct(sample)
    if pct is None:
        return "-"
    gil = (sample.get("profile") or {}).get("gil_released")
    return f"{pct:.0f}%" if gil is None else f"{pct:.0f}%/{gil:.2f}"


def _fleet_cell(sample: dict) -> str:
    """Serving-fleet summary of a rank publishing the ``fleet`` key
    (the fleet controller rank): total queued across pools + the
    prefix-cache hit rate — 'q3/87%' (or '-' off the fleet rank)."""
    fl = sample.get("fleet")
    if not fl:
        return "-"
    pools = fl.get("pools") or {}
    queued = sum(int(p.get("queued", 0)) for p in pools.values())
    hits = sum(int((p.get("prefix") or {}).get("hits", 0))
               for p in pools.values())
    misses = sum(int((p.get("prefix") or {}).get("misses", 0))
                 for p in pools.values())
    if hits + misses:
        return f"q{queued}/{100.0 * hits / (hits + misses):.0f}%"
    return f"q{queued}/-"


def _slo_cell(sample: dict) -> str:
    """otpu-req SLO burn of a rank publishing the ``slo`` key (the
    router/controller rank): the worst per-(pool, tenant) error-budget
    burn rate in the rolling window — '0.6x' sustainable, '>1x' is
    budget-eating ('-' off the router rank or with no SLO target)."""
    slo = sample.get("slo")
    if not slo:
        return "-"
    burns = [float(t.get("burn", 0.0))
             for tenants in (slo.get("pools") or {}).values()
             for t in tenants.values()]
    if not burns:
        return "-"
    return f"{max(burns):.1f}x"


def _door_cell(sample: dict) -> str:
    """Front-door summary of a rank publishing the ``frontdoor`` key
    (the fleet controller rank): door-held depth + lifetime sheds,
    with a '!' while any pool is holding batch after a preemption —
    'd2/s14!' ('-' off the controller rank or with no door armed)."""
    fd = sample.get("frontdoor")
    if not fd:
        return "-"
    depth = sum(int(n) for n in (fd.get("queued") or {}).values())
    mark = "!" if fd.get("holds") else ""
    return f"d{depth}/s{fd.get('shed', 0)}{mark}"


def render_table(session: TopSession, samples: dict, coll: str,
                 parsable: bool = False) -> str:
    """The per-rank live table (or ``:``-separated rows)."""
    rows = [(rank, samples[rank], session.stale(rank, samples[rank]))
            for rank in sorted(samples)]
    if parsable:
        out = []
        for rank, s, stale in rows:
            if s is None:
                out.append(f"{rank}:-:-:-:-:-:-:-:-:-:-:{int(stale)}")
                continue
            tcp = s.get("tcp") or {}
            chaos = s.get("chaos") or {}
            pct = _host_pct(s)
            out.append(":".join(str(x) for x in (
                rank, s.get("seq"), round(_msg_rate(s), 1),
                round(_byte_rate(s), 1),
                _coll_cell(s, coll), tcp.get("outq_frags", 0),
                sum(chaos.values()),
                "-" if pct is None else round(pct, 1),
                _fleet_cell(s), _slo_cell(s), _door_cell(s),
                int(stale))))
        return "\n".join(out)
    hdr = (f"{'rank':>4}  {'seq':>6}  {'msg/s':>8}  {'bytes/s':>8}  "
           f"{coll + ' p50/p99':>16}  {'outq':>5}  {'stage':>6}  "
           f"{'serveq':>6}  {'chaos':>5}  {'host%/gil':>10}  "
           f"{'fleet':>8}  {'burn':>5}  {'door':>8}  flag")
    lines = [hdr]
    for rank, s, stale in rows:
        if s is None:
            lines.append(f"{rank:>4}  {'-':>6}  {'-':>8}  {'-':>8}  "
                         f"{'-':>16}  {'-':>5}  {'-':>6}  {'-':>6}  "
                         f"{'-':>5}  {'-':>10}  {'-':>8}  {'-':>5}  "
                         f"{'-':>8}  STALE")
            continue
        tcp = s.get("tcp") or {}
        staging = s.get("staging") or {}
        serving = s.get("serving") or {}
        chaos = s.get("chaos") or {}
        lines.append(
            f"{rank:>4}  {s.get('seq', 0):>6}  "
            f"{_fmt_si(_msg_rate(s)):>8}  "
            f"{_fmt_si(_byte_rate(s)):>8}  "
            f"{_coll_cell(s, coll):>16}  "
            f"{tcp.get('outq_frags', 0):>5}  "
            f"{_fmt_si(float(staging.get('bytes', 0))):>6}  "
            f"{serving.get('queued', '-'):>6}  "
            f"{sum(chaos.values()):>5}  "
            f"{_host_cell(s):>10}  "
            f"{_fleet_cell(s):>8}  "
            f"{_slo_cell(s):>5}  "
            f"{_door_cell(s):>8}  "
            f"{'STALE' if stale else 'ok'}")
    return "\n".join(lines)


def _parse_addr(spec: str) -> Optional[tuple]:
    """HOST:PORT -> (host, port), or None on a malformed spec (no /
    non-numeric port) — the CLI turns that into a friendly error, not
    a traceback."""
    host, _, port = spec.rpartition(":")
    try:
        return (host or "127.0.0.1", int(port))
    except ValueError:
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="otpu_top",
        description="Live per-rank telemetry of a running ompi_tpu_torch job")
    ap.add_argument("--coord", default=os.environ.get("OTPU_COORD"),
                    metavar="HOST:PORT",
                    help="Coordination-service address (default: the "
                         "OTPU_COORD env var inside a job)")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="Poll interval in seconds (watch/json modes)")
    ap.add_argument("--count", type=int, default=0, metavar="N",
                    help="Stop after N polls (0 = until ^C or the "
                         "coordination service goes away)")
    ap.add_argument("--watch", action="store_true",
                    help="Keep refreshing the table")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="Stream one JSON object per poll "
                         "({t, nprocs, ranks, stale}) to stdout")
    ap.add_argument("--parsable", action="store_true",
                    help="Colon-separated rows instead of the table")
    ap.add_argument("--coll", default="allreduce",
                    help="Collective whose interval p50/p99 the table "
                         "shows (default: allreduce)")
    args = ap.parse_args(argv)
    if not args.coord:
        ap.error("no coordination service: pass --coord HOST:PORT "
                 "(or run inside a job where OTPU_COORD is set)")

    addr = _parse_addr(args.coord)
    if addr is None:
        ap.error(f"bad --coord {args.coord!r} (expected HOST:PORT)")

    from ompi_tpu_torch.rte.coord import CoordClient

    try:
        client = CoordClient(addr=addr, timeout=5.0,
                             retries=0)
        nprocs = int(client._rpc(op="ping")["nprocs"])
    except Exception as exc:
        print(f"otpu_top: cannot reach coordination service at "
              f"{args.coord}: {exc}", file=sys.stderr)
        return 2
    session = TopSession(client, nprocs)
    polls = 0
    streaming = args.watch or args.as_json or args.count
    try:
        while True:
            try:
                samples = session.poll()
            except Exception:
                print("otpu_top: coordination service went away (job "
                      "ended?)", file=sys.stderr)
                return 0
            polls += 1
            if args.as_json:
                stale = [r for r, s in samples.items()
                         if session.stale(r, s)]
                print(json.dumps({"t": time.time(), "nprocs": nprocs,
                                  "ranks": {str(r): s for r, s in
                                            samples.items()},
                                  "stale": stale}), flush=True)
            else:
                if args.watch and sys.stdout.isatty():
                    print("\x1b[2J\x1b[H", end="")
                print(render_table(session, samples, args.coll,
                                   parsable=args.parsable), flush=True)
            if args.count and polls >= args.count:
                return 0
            if not streaming:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    finally:
        try:
            client.close()
        except Exception:
            pass


if __name__ == "__main__":
    sys.exit(main())
