"""Elastic train-through-failure demo — a rank dies, training finishes.

The counterpart of the JAX package's ``examples/elastic_train_demo.py``.

    python -m ompi_tpu_torch.examples.elastic_train_demo [--device cpu]

Self-launching: runs this module with ``--worker`` under ``tpurun -n 4
--enable-recovery`` with a chaos kill schedule (``kill:rank=2,step=7``) and
tracing on.  Rank 2 is killed mid-training; the survivors run the recovery
state machine — revoke → ERA agree → shrink to the surviving membership →
respawn a replacement via ``MPI_Comm_spawn`` (verified against the dynamic
``mpi://job/<id>`` pset; it binds the same device as the survivors) →
restore from the last checkpoint → resume — and the job completes at full
width with parameters **bit-exact** to a failure-free run restored from the
same checkpoint step (verified at the end against the pure-numpy oracle).
Each rank's parameter vector lives on ``--device`` (default: the card).

Inspect the merged timeline afterwards (chrome://tracing / Perfetto): the
``elastic_detect`` → ``elastic_agree`` → ``elastic_shrink`` →
``elastic_respawn`` → ``elastic_restore`` → ``elastic_resume`` spans ARE
the recovery, with wall-clock widths.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

STEPS, BATCH, DIMS = 15, 24, 12


def launch(device) -> int:
    work = tempfile.mkdtemp(prefix="otpu-elastic-demo-")
    ckpt = os.path.join(work, "ckpt")
    tdir = os.path.join(work, "trace")
    env = {k: v for k, v in os.environ.items()
           if k not in ("OTPU_RANK", "OTPU_NPROCS", "OTPU_COORD")}
    cmd = [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-n", "4",
           "--enable-recovery",
           "--mca", "otpu_chaos_spec", "kill:rank=2,step=7",
           "--mca", "otpu_trace_enable", "1",
           "--mca", "otpu_trace_dir", tdir,
           sys.executable, "-m", "ompi_tpu_torch.examples.elastic_train_demo",
           "--worker", ckpt, *(["--device", device] if device else [])]
    print("launching:", " ".join(cmd[2:]), flush=True)
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       timeout=600)
    sys.stdout.write(r.stdout)
    line = next((ln for ln in r.stdout.splitlines()
                 if "ELASTIC " in ln), None)
    if r.returncode or line is None:
        sys.stderr.write(r.stderr)
        print("demo FAILED", file=sys.stderr)
        return 1
    rep = json.loads(line.split("ELASTIC ", 1)[1])
    rec = rep["recoveries"][0]
    print(f"\nkilled rank 2 at step {rec['detect_step']}; recovery "
          f"{rec['total_ms']:.0f}ms "
          f"(agree {rec['agree_ms']:.0f} / shrink {rec['shrink_ms']:.0f}"
          f" / respawn {rec.get('respawn_ms', 0):.0f}), resumed from "
          f"step {rec['resume_step']} at width {rec['world_size']}")

    # the failure-free oracle, restored from the same checkpoint step
    from ompi_tpu_torch.parallel import checkpoint
    from ompi_tpu_torch.parallel.elastic import reference_run

    tree = checkpoint.load(
        os.path.join(ckpt, f"step{rec['resume_step']:06d}"), device=device)
    ref = reference_run(tree["w"].cpu().numpy(), rec["resume_step"],
                        STEPS, BATCH)
    ok = rep["w"] == ref.tolist()
    print("bit-exact vs failure-free restore:", "YES" if ok else "NO")
    print(f"merged timeline: {os.path.join(tdir, 'trace_merged.json')}")
    return 0 if ok else 1


def rank_main(ckpt_dir: str, device) -> int:
    import ompi_tpu_torch
    from ompi_tpu_torch.parallel.elastic import ElasticTrainer

    world = ompi_tpu_torch.init(device=device)
    trainer = ElasticTrainer(world, ckpt_dir=ckpt_dir, model_size=DIMS,
                             global_batch=BATCH, ckpt_every=5, respawn=True,
                             device=device)
    trainer.train(STEPS)
    if trainer.comm.rank == 0:
        print("ELASTIC " + json.dumps(
            {**trainer.report(), "device": str(trainer.device)}), flush=True)
    ompi_tpu_torch.finalize()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device of each rank's parameters (default: the "
                         "card)")
    ap.add_argument("--worker", metavar="CKPT_DIR",
                    help="run as one rank of the job, checkpointing into "
                         "CKPT_DIR (tpurun starts these)")
    args = ap.parse_args(argv)
    if args.worker:
        return rank_main(args.worker, args.device)
    return launch(args.device)


if __name__ == "__main__":
    sys.exit(main())
