"""Which part of the native core moves the host figures (card only, ~4 min).

Runs two of ``chip_smoke.py``'s host jobs under the port's ``tpurun`` in
turns, each lane once a round, three rounds:

- the ``-n 4`` default-selection job (``chip_smoke.TUNED``: coll/tuned's
  16 MB allreduce of card tensors, its ladder and every entry forced) with
  the native core (host folds of 1 MB and more on ``threads/native``'s
  worker pool), with the core but a pool of one worker (``--mca
  threads_pool_workers 1``: every fold inline, as without the core), and
  with ``OTPU_NATIVE_DISABLE=1``;
- the ``-n 2`` ping-pong over btl/tcp (``chip_smoke.PINGPONG``, ``--mca btl
  tcp,self``) with the native reactor, with the core but the reactor off
  (``--mca progress_native 0``: the selector loop), and with
  ``OTPU_NATIVE_DISABLE=1``.

Every result is checked as ``chip_smoke.py`` checks it (bit for bit; the
ping-pong's lane).  Prints one ``host_lanes`` line: each figure's medians by
lane and round, with the card's name and power limit.

    python3 chip_host_lanes.py
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROUNDS = 3
POOL_LANES = {"pool": ([], {}),
              "one_worker": (["--mca", "threads_pool_workers", "1"], {}),
              "pure": ([], {"OTPU_NATIVE_DISABLE": "1"})}
TCP_LANES = {"reactor": ([], {}),
             "selector": (["--mca", "progress_native", "0"], {}),
             "pure": ([], {"OTPU_NATIVE_DISABLE": "1"})}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_host_lanes: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as c

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = {"card": smi, "tuned_4_16MB": {}, "tcp_pingpong_2": {}}
    with tempfile.TemporaryDirectory() as tmp:
        tuned, ping = Path(tmp, "tuned.py"), Path(tmp, "ping.py")
        tuned.write_text(c.TUNED)
        ping.write_text(c.PINGPONG)
        for rnd in range(ROUNDS):
            for lane, (args, env) in POOL_LANES.items():
                lines, _ = c.tpurun(4, [*args, sys.executable, str(tuned),
                                        str(c.SEED)], env=env)
                ranks = [c.job_result(lines, r) for r in range(4)]
                owners = c.TUNED_OWNERS if lane != "pure" else {
                    "allreduce": "TunedModule", "iallreduce": "LibnbcModule",
                    "iallgather": "LibnbcModule"}
                c.require(all(x["owner"] == owners and x["ladder"]["bit_exact"]
                              and all(v["bit_exact"]
                                      for v in x["forced"].values())
                              for x in ranks), f"tuned job {lane}: {ranks}")
                row = {"ladder": statistics.median(
                    x["ladder"]["ms"] for x in ranks)}
                for alg in ranks[0]["forced"]:
                    row[alg] = statistics.median(
                        x["forced"][alg]["ms"] for x in ranks)
                out["tuned_4_16MB"].setdefault(lane, []).append(row)
            for lane, (args, env) in TCP_LANES.items():
                lines, _ = c.tpurun(2, ["--mca", "btl", "tcp,self", *args,
                                        sys.executable, str(ping)], env=env)
                res = c.job_result(lines, 0)
                c.require(res["btl"] == "tcp"
                          and res["native"] is (lane != "pure")
                          and res["reactor"] is (lane == "reactor"),
                          f"tcp ping-pong {lane}: {res}")
                out["tcp_pingpong_2"].setdefault(lane, []).append(
                    {k: res[k] for k in ("latency_us_8B",
                                         "bandwidth_MBps_4MB")})
    print(json.dumps({"host_lanes": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
