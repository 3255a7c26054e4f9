"""The fleet soak's scale-up against the fleet's life after the load (card
only, ~6 minutes).

Runs ``chip_smoke.py``'s phase 15 (b) job (``chip_smoke.FLEET_SOAK_JOB``:
``tpurun -n 5 --enable-recovery --pool m_a:1,2 --pool m_b:3,4``, 24 + 16
requests, worker 2 killed mid-load, a p99 SLO of 2 ms) in turns with the
fleet ticked for 0 s and for 1 s after its last completion, ``ROUNDS``
rounds.  The autoscaler reads the router rank's telemetry sample, which
closes up to one sampler interval after the completions it counts; with 0 s
the job ends at its last completion, as a load generator that stops the
control loop there does.  Each run is checked as ``chip_smoke.py`` checks (b).  Prints
one line a run and one ``fleet_soak`` line with the card's name and power
limit and, for each lane, the runs that passed and those whose scale-up
came only after the load.

    python3 chip_fleet_soak.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import chip_smoke as cs

ROUNDS = 5
LANES = (0.0, 1.0)


def passes(res: dict) -> bool:
    """``chip_smoke.fleet_pgas``'s check of (b)."""
    return bool(res["done"] == res["unique"] == res["submitted"] == 40
                and res["exact"] and res["requeued"] > 0
                and res["prefix_hits"] > 0
                and any(d["signal"] == "p99" for d in res["ups"])
                and res["spawned"] and res["spawned_in_pool"]
                and all(d.startswith("cuda") for d in res["spawned_devices"])
                and res["device"].startswith("cuda"))


def main() -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        job = Path(tmp, "fleet_soak.py")
        job.write_text(cs.FLEET_SOAK_JOB)
        for rnd in range(ROUNDS):
            for settle in LANES if rnd % 2 == 0 else LANES[::-1]:
                r, lines, wall = cs.tpurun_any(
                    5, ["--enable-recovery", "--pool", "m_a:1,2", "--pool",
                        "m_b:3,4", "--mca", "otpu_telemetry_interval_ms", "50",
                        sys.executable, str(job), str(settle)], timeout=240)
                objs = [x for x in lines.get(0, []) if x.startswith("{")]
                run = {"round": rnd, "settle_s": settle, "rc": r.returncode,
                       "wall_s": wall}
                if objs:
                    res = json.loads(objs[-1])
                    run.update(ok=passes(res),
                               ups_during_load=res["ups_during_load"],
                               ups=[[d["pool"], d["signal"], d["value"],
                                     d.get("how")] for d in res["ups"]],
                               spawned_devices=res["spawned_devices"],
                               requeued=res["requeued"])
                else:
                    run.update(ok=False, stderr=r.stderr[-1500:])
                runs.append(run)
                print(json.dumps(run), flush=True)
    lanes = {str(s): {"runs": sum(r["settle_s"] == s for r in runs),
                      "passed": sum(r["settle_s"] == s and r["ok"]
                                    for r in runs),
                      "no_up_during_load": sum(
                          r["settle_s"] == s
                          and r.get("ups_during_load") == 0 for r in runs)}
             for s in LANES}
    print(json.dumps({"fleet_soak": {"card": smi, "lanes": lanes}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
