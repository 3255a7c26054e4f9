"""Expert-parallel MoE training demo — with a deliberately hot expert.

The counterpart of the JAX package's ``examples/moe_train_demo.py``.

    python -m ompi_tpu_torch.examples.moe_train_demo [--device cpu]

Self-launching: starts ``python -m ompi_tpu_torch.parallel.moe`` under
``tpurun -n 3`` with tracing on and a gate skewed toward expert 5
(``hot_expert=5, hot_boost=0.8``), which homes on rank 2 of the 3-way
expert partition.  Each step the ranks gate their local tokens with the
shared deterministic plan, dispatch int8-quantizable payload rows through
the ragged ``alltoallv``, apply the owned experts (paced so received load
is wall-clock), and combine through the ragged ``allgatherv``.  Each rank's
parameters live on ``--device`` (default: the card).

Afterwards the launcher feeds the merged trace to ``otpu_analyze
--critical-path`` and prints the load-imbalance report: the per-expert
token loads from the gating plan, the drop count reconciled against the
capacity factor, and the critical-path attribution — which should blame
rank 2 (the hot expert's home) for nearly every step.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

CONF = {"steps": 10, "n_experts": 6, "expert_dim": 8,
        "tokens_per_step": 48, "capacity_factor": 3.0,
        "hot_expert": 5, "hot_boost": 0.8,
        "compute_us_per_token": 2000, "ckpt_every": 50, "seed": 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device of each rank's tensors (default: the card)")
    args = ap.parse_args(argv)
    from ompi_tpu_torch.parallel.moe import partition, plan_step
    from ompi_tpu_torch.tools import otpu_analyze as oa

    work = tempfile.mkdtemp(prefix="otpu-moe-demo-")
    tdir = os.path.join(work, "trace")
    conf = dict(CONF, ckpt_dir=os.path.join(work, "ckpt"))
    if args.device:
        conf["device"] = args.device
    env = {k: v for k, v in os.environ.items()
           if k not in ("OTPU_RANK", "OTPU_NPROCS", "OTPU_COORD")}
    cmd = [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-n", "3",
           "--mca", "otpu_trace_enable", "1",
           "--mca", "otpu_trace_dir", tdir,
           sys.executable, "-m", "ompi_tpu_torch.parallel.moe",
           json.dumps(conf)]
    print("launching:", " ".join(cmd[2:]), flush=True)
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       timeout=600)
    sys.stdout.write(r.stdout)
    line = next((ln for ln in r.stdout.splitlines() if "MOE " in ln),
                None)
    if r.returncode or line is None:
        sys.stderr.write(r.stderr)
        print("demo FAILED", file=sys.stderr)
        return 1
    rep = json.loads(line.split("MOE ", 1)[1])

    # the imbalance report: per-expert loads from the (shared,
    # deterministic) gating plan, plus the homes from the partition
    E, n = rep["n_experts"], rep["world_size"]
    plan = plan_step(rep["step"] - 1, CONF["tokens_per_step"], E,
                     rep["top_k"], CONF["capacity_factor"],
                     seed=CONF["seed"], hot_expert=CONF["hot_expert"],
                     hot_boost=CONF["hot_boost"])
    homes = {e: next(rk for rk in range(n)
                     if partition(rk, n, E)[0] <= e
                     < partition(rk, n, E)[1]) for e in range(E)}
    print(f"\nfinal-step expert loads (capacity {plan.capacity}, "
          f"max/mean imbalance {plan.imbalance():.2f}):")
    for e, load in enumerate(plan.loads):
        bar = "#" * (load * 40 // max(plan.loads))
        hot = "  <- hot" if e == CONF["hot_expert"] else ""
        print(f"  expert {e} @ rank {homes[e]}: {load:4d} {bar}{hot}")
    print(f"dispatched {rep['dispatched']} tokens, dropped "
          f"{rep['dropped']} (capacity factor "
          f"{CONF['capacity_factor']})")

    events, profiles, meta = oa.load_run([tdir])
    cp = oa.analyze(events, profiles=profiles, meta=meta,
                    critical_path=True)["critical_path"]
    bb = cp["bound_by"]
    print(f"critical path: rank {bb['rank']} bounds "
          f"{bb['fraction']:.0%} of {len(cp['steps'])} steps "
          f"(hot expert {CONF['hot_expert']} homes on rank "
          f"{homes[CONF['hot_expert']]})")
    ok = bb["rank"] == homes[CONF["hot_expert"]]
    print("hot-expert rank blamed:", "YES" if ok else "NO")
    print(f"merged timeline: {os.path.join(tdir, 'trace_merged.json')}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
