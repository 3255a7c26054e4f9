"""The host tier's spread on the card's machine (card only, ~4 minutes).

Runs ``chip_smoke.host_tier`` alone, each time in a fresh process: three
times with glibc's default allocator and three times, in turns, with large
blocks kept resident
(``MALLOC_MMAP_THRESHOLD_`` and ``MALLOC_TRIM_THRESHOLD_`` at 1 GiB, so a
freed 16 MB block stays mapped and its next use faults no page in).  It
prints each run's ``host_tier`` line, then one summary line.  Before the
phase each process times the allocator alone, without the port: copies of
a 16 MB array, one at a time and two alive at once (the device world's
send and receive holds two: the staged copy and the unexpected queue's).
The ping-pong counts how its waits idled (polls that found nothing,
yields, blocking selects) a round trip.  Run ``chip_smoke.py`` with the
same environment to read the phase inside the whole smoke.

    python3 chip_host_tier.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

KEEP = {"MALLOC_MMAP_THRESHOLD_": str(1 << 30),
        "MALLOC_TRIM_THRESHOLD_": str(1 << 30)}
RUNS = (("default", {}), ("kept", KEEP)) * 3
CHILD = r"""
import json, statistics, subprocess, time
import numpy as np, torch
import chip_smoke as c

src = np.ones(4 << 20, np.float32)


def copies_ms(n):
    times = []
    for _ in range(11):
        t0 = time.perf_counter()
        bufs = [src.copy() for _ in range(n)]
        del bufs
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


print(json.dumps({"allocator": {"one_16MB_copy_ms": copies_ms(1),
                                "two_16MB_copies_ms": copies_ms(2)}}),
      flush=True)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip()
c.host_tier(torch.Generator(device="cuda").manual_seed(c.SEED), smi)
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_host_tier: no CUDA device is available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    summary = {}
    for mode, extra in RUNS:
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("MALLOC_")}
        env.update(extra)
        r = subprocess.run([sys.executable, "-c", CHILD], cwd=here, env=env,
                           capture_output=True, text=True, timeout=600)
        lines = {key: x for x in r.stdout.splitlines()
                 for key in ("allocator", "host_tier")
                 if x.startswith('{"%s"' % key)}
        if r.returncode != 0 or len(lines) != 2:
            print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
            return 1
        print(lines["allocator"], flush=True)
        print(lines["host_tier"], flush=True)
        got = json.loads(lines["host_tier"])["host_tier"]
        dw, pp = got["device_world"], got["pingpong_2"]
        summary.setdefault(mode, []).append({
            **json.loads(lines["allocator"])["allocator"],
            "send_recv_ms_16MB": dw["send_recv_ms_16MB"],
            "staging_ms_16MB": dw["staging_ms_16MB"],
            "latency_us_8B": pp["latency_us_8B"],
            **{k: v for k, v in pp.items() if k.startswith("rank0_")},
            "bandwidth_MBps_4MB": pp["bandwidth_MBps_4MB"]})
    print(json.dumps({"host_tier_spread": summary,
                      "card": got["card"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
