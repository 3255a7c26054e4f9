"""Continuous-batching serving demo — the port's serving engine end to end.

The counterpart of the JAX package's ``examples/serving_demo.py``::

    python -m ompi_tpu_torch.examples.serving_demo
    python -m ompi_tpu_torch.tools.tpurun -n 3 python -m \\
        ompi_tpu_torch.examples.serving_demo
    python -m ompi_tpu_torch.tools.tpurun -n 3 --router-ranks 0 \\
        --worker-ranks 1,2 python -m ompi_tpu_torch.examples.serving_demo

In-process, the device world hosts every rank (``Comm.as_rank`` views)
with the two workers running their serve loops on threads: rank 0 routes,
rank 1 prefills, rank 2 decodes — each finished sequence's KV block
travels prefill → decode over an MPI-4 partitioned slab (one ``Pready``
per sequence, aggregated tail flush, the receiver partitioned twice as
finely as the sender), and a Poisson open-loop driver reports p50/p99
request latency out of the otpu-trace log2 histograms plus decoded
tokens/sec.

Under tpurun the same code serves across processes, with the roles that
``ompi_tpu_torch.serving.roles`` resolves: the ``--router-ranks`` /
``--worker-ranks`` psets when given, else the lowest rank routes.  The
router's first worker prefills, its second decodes and any further one
serves colocated.  Every rank prints its ``ROLES`` line; the router prints
the driver's report and ``SERVING DEMO OK``.

``--device`` names the device the world binds to (default: the card;
``--device cpu`` where there is none).  The MCA vars drive the engine as
anywhere: ``OTPU_MCA_coll_quant_kv_codec=int8`` (under tpurun, ``--mca
coll_quant_kv_codec int8``) streams encoded KV slabs, and
``OTPU_MCA_serving_spec_k=4`` decodes speculatively.  The engine computes
on the host and launches no kernel.
"""
import argparse
import json
import threading

import ompi_tpu_torch
from ompi_tpu_torch.serving import (ContinuousBatchScheduler, Router,
                                    ShardWorker, roles)
from ompi_tpu_torch.serving.driver import PoissonDriver
from ompi_tpu_torch.serving.worker import toy_token

SLOTS, KV_ELEMS, N_REQUESTS = 8, 128, 32


def _worker(comm, router: int, role: str, peer=None) -> ShardWorker:
    if role == "prefill":
        return ShardWorker(comm, router=router, role="prefill", peer=peer,
                           slots=SLOTS, kv_elems=KV_ELEMS)
    if role == "decode":
        return ShardWorker(comm, router=router, role="decode", peer=peer,
                           slots=SLOTS, kv_elems=KV_ELEMS,
                           kv_partitions=2 * SLOTS)
    return ShardWorker(comm, router=router)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device the world binds to (default: the card)")
    args = ap.parse_args(argv)
    world = ompi_tpu_torch.init(device=args.device)
    inproc = world.rte.is_device_world
    if inproc:
        router, workers = 0, [1, 2]
        me = router
    else:
        router, workers = roles(world)
        me = world.rank
    print("ROLES " + json.dumps({"rank": me, "router": router,
                                 "workers": workers}), flush=True)
    prefill, decode = workers[0], workers[1]

    if me == router:
        threads = []
        if inproc:
            pre = _worker(world.as_rank(prefill), router, "prefill", decode)
            dec = _worker(world.as_rank(decode), router, "decode", prefill)
            threads = [threading.Thread(target=w.serve, daemon=True)
                       for w in (pre, dec)]
            for t in threads:
                t.start()
        engine = Router(
            world.as_rank(router) if inproc else world,
            scheduler=ContinuousBatchScheduler(max_batch=SLOTS,
                                               max_batch_tokens=1 << 13,
                                               slots=SLOTS),
            # in-process the device world has more ranks than serve
            # loops: the table must name the two that run
            workers=workers if inproc else None,
            stages=True, decode_chunk=4, kv_elems=KV_ELEMS)
        report = PoissonDriver(rate_rps=400.0, n_requests=N_REQUESTS,
                               prompt_lens=(8, 48), decode_lens=(4, 16),
                               seed=7).run(engine, max_wall_s=120)
        engine.shutdown()
        for t in threads:
            t.join(timeout=10)
        done = engine.completed()
        assert len(done) == N_REQUESTS, (len(done), N_REQUESTS)
        for req in done:                     # bit-exact decode check
            assert req.tokens == [toy_token(req.rid, i)
                                  for i in range(req.max_new_tokens)]
        print("serving report:")
        for k, v in report.items():
            print(f"  {k:>14}: {v}")
        print("SERVING DEMO OK " + json.dumps(report), flush=True)
    elif me == prefill:
        _worker(world, router, "prefill", decode).serve()
    elif me == decode:
        _worker(world, router, "decode", prefill).serve()
    else:
        _worker(world, router, "colocated").serve()
    ompi_tpu_torch.finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
