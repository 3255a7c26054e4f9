"""Fleet demo — the multi-tenant serving platform, two models end to end.

The counterpart of the JAX package's ``examples/fleet_demo.py``::

    python -m ompi_tpu_torch.examples.fleet_demo            # in process
    python -m ompi_tpu_torch.tools.tpurun -n 5 \\
        --pool m_a:1,2 --pool m_b:3,4 \\
        python -m ompi_tpu_torch.examples.fleet_demo

Two model pools share the job's workers; two weighted tenants (ten_a
2:1 over ten_b) drive mixed Poisson traffic whose prompts share prefix
templates — the shape that makes prefix-cache-aware routing pay.  The
demo prints what the fleet delivered per tenant (p50/p99 out of each
tenant's OWN otpu-trace histogram family, tokens/sec) and what the
prefix cache saved (worker-verified hits vs full prefill passes).

In process, the device world hosts every rank: the four workers run their
serve loops on threads over ``Comm.as_rank`` views and the fleet resolves
its pools from explicit :class:`~ompi_tpu_torch.serving.fleet.PoolSpec`
tables; under tpurun the SAME controller resolves them from the
``--pool``-published ``mpi://serving/pool/<model>`` process sets.

``--device`` names the device the world binds to (default: the card;
``--device cpu`` where there is none).  The fleet computes on the host and
launches no kernel.
"""
import argparse
import json
import threading

import ompi_tpu_torch
from ompi_tpu_torch.serving import (FleetController, MixedPoissonDriver,
                                    PoolSpec, ShardWorker)
from ompi_tpu_torch.serving.worker import toy_token

WORKLOAD = {
    "ten_a": dict(model="m_a", rate_rps=400.0, n_requests=32,
                  prompt_lens=(8, 48), decode_lens=(4, 16),
                  prefixes=3, prefix_len=32),
    "ten_b": dict(model="m_b", rate_rps=250.0, n_requests=20,
                  prompt_lens=(8, 48), decode_lens=(4, 16),
                  prefixes=2, prefix_len=16),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device the world binds to (default: the card)")
    args = ap.parse_args(argv)
    world = ompi_tpu_torch.init(device=args.device)
    inproc = world.rte.is_device_world

    if inproc or world.rank == 0:
        threads = []
        if inproc:
            workers = [ShardWorker(world.as_rank(r), router=0)
                       for r in (1, 2, 3, 4)]
            threads = [threading.Thread(target=w.serve, daemon=True)
                       for w in workers]
            for t in threads:
                t.start()
            fleet = FleetController(
                world.as_rank(0),
                pools=[PoolSpec("m_a", [1, 2], max_batch=6,
                                max_batch_tokens=1 << 13),
                       PoolSpec("m_b", [3, 4], max_batch=6,
                                max_batch_tokens=1 << 13)],
                tenants={"ten_a": 2, "ten_b": 1})
        else:
            # pools come from the tpurun --pool psets
            fleet = FleetController(world,
                                    tenants={"ten_a": 2, "ten_b": 1})
        print(f"fleet pools: {fleet.pool_workers()}", flush=True)
        rep = MixedPoissonDriver(WORKLOAD, seed=11).run(
            fleet, max_wall_s=120)
        for req in fleet.completed():      # every token verifies
            assert req.tokens == [toy_token(req.rid, i)
                                  for i in range(req.max_new_tokens)]
        print(f"\n{rep['requests']} requests, "
              f"{rep['tokens_per_s']} tokens/s aggregate")
        print(f"{'tenant':>8}  {'reqs':>5}  {'p50 ms':>8}  "
              f"{'p99 ms':>8}  {'tokens/s':>9}")
        for name, tr in sorted(rep["tenants"].items()):
            print(f"{name:>8}  {tr['requests']:>5}  "
                  f"{tr['p50_ms']:>8}  {tr['p99_ms']:>8}  "
                  f"{tr['tokens_per_s']:>9}")
        print(f"\nprefix cache: {rep['prefix_hits']} verified hits vs "
              f"{rep['prefills']} full prefills "
              f"(hit rate {100.0 * rep['prefix_hit_rate']:.0f}% — "
              "hits prefill only the uncached suffix)")
        st = fleet.stats()
        for pool, entry in sorted(st["pools"].items()):
            print(f"pool {pool}: {entry['workers']} worker(s), "
                  f"prefix {entry['prefix']}")
        fleet.shutdown()
        for t in threads:
            t.join(timeout=10)
        print("FLEET DEMO OK " + json.dumps(
            {"requests": rep["requests"], "prefix_hits": rep["prefix_hits"],
             "prefills": rep["prefills"],
             "device": str(world.rte.device)}), flush=True)
    else:
        ShardWorker(world, router=0).serve()
    ompi_tpu_torch.finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
