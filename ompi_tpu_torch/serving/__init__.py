"""ompi_tpu_torch.serving — continuous-batching inference over the runtime.

Copy of ``ompi_tpu/serving/`` with its imports re-pointed: the scheduler,
the prefix cache, the KV stream, the shard worker, the router, the front
door, the fleet and the drivers.  Module names, public names, counters,
trace spans and flows, telemetry sources and MCA vars are the reference's:

* a **request router** rank feeding model-shard **worker** ranks over an
  ordinary communicator (:mod:`ompi_tpu_torch.serving.router`,
  :mod:`ompi_tpu_torch.serving.worker`);
* **continuous batching**: an admission scheduler merges in-flight
  requests into prefill/decode micro-batches every engine tick and
  evicts finished sequences without draining the batch
  (:mod:`ompi_tpu_torch.serving.scheduler`);
* **KV-cache streaming** between the prefill and decode stages over
  MPI-4 partitioned persistent requests — ``Psend_init``/``Precv_init``
  per stage pair, one ``Pready`` per finished sequence, the bucketed-
  overlap machinery of ``mca/part`` pointed at inference
  (:mod:`ompi_tpu_torch.serving.kv_stream`);
* **autoscaling** via ``dpm.spawn`` when queue depth crosses a
  watermark, new workers (``python -m ompi_tpu_torch.serving.worker``)
  joining through the dynamic ``mpi://job/<id>`` process set;
* **serve-through-failure**: on ``proc_failed`` the comm is revoked,
  survivors shrink (publishing ``mpi://surviving``), the router
  re-shards its worker table and requeues the dead worker's in-flight
  requests — no admitted request is ever dropped;
* **prefix-cache-aware routing** (:mod:`ompi_tpu_torch.serving.
  prefix_cache`) and the **front door**'s SLO-tiered admission
  (:mod:`ompi_tpu_torch.serving.frontdoor`);
* **the fleet** (:mod:`ompi_tpu_torch.serving.fleet`): multiple models and
  tenants sharing one job — named per-model pools (``mpi://serving/pool/
  <model>`` psets, ``tpurun --pool``), fair-share weighted-round-robin
  admission across tenants, prefix-cache-aware routing, one recovery for
  every pool, and autoscaling driven by the live telemetry plane (per-pool
  p99 SLO / stale ranks / depth) instead of a queue-depth watermark.

The toy model and the KV slabs stay numpy on the host, as in the
reference: the engine launches no kernel, on the card or off it.  Its
comms come from ``ompi_tpu_torch.init()`` (the card's world unless the
caller names ``device="cpu"``).

Role placement: ``tpurun --router-ranks/--worker-ranks`` publish the
``mpi://serving/router`` / ``mpi://serving/workers`` psets; without
them the lowest comm rank routes and the rest serve shards
(:func:`roles`).
"""
from __future__ import annotations

#: role process-set names served by the coordination service (published
#: by ``tpurun --router-ranks`` / ``--worker-ranks``)
PSET_ROUTER = "mpi://serving/router"
PSET_WORKERS = "mpi://serving/workers"


def roles(comm) -> tuple[int, list]:
    """(router comm-rank, [worker comm-ranks]) for ``comm``.

    Resolution order: the ``mpi://serving/router`` / ``.../workers``
    psets when the coordination service advertises them (world ranks are
    mapped into ``comm``; members outside the comm are ignored), else
    the default split — lowest rank routes, everyone else serves.
    """
    router, workers = None, None
    client = getattr(comm.rte, "client", None)
    if client is not None:
        try:
            r_entry = client.pset_get(PSET_ROUTER)
            w_entry = client.pset_get(PSET_WORKERS)
        except Exception:
            r_entry = w_entry = None
        in_comm = {w: i for i, w in enumerate(comm.group.world_ranks)}
        if r_entry is not None:
            rr = [in_comm[int(m)] for m in r_entry["members"]
                  if int(m) in in_comm]
            router = rr[0] if rr else None
        if w_entry is not None:
            workers = sorted(in_comm[int(m)] for m in w_entry["members"]
                             if int(m) in in_comm)
    if router is None:
        router = 0
    if not workers:
        workers = [r for r in range(comm.size) if r != router]
    return router, [w for w in workers if w != router]


from ompi_tpu_torch.serving.scheduler import (  # noqa: E402
    ContinuousBatchScheduler, ServeRequest)
from ompi_tpu_torch.serving.kv_stream import (  # noqa: E402
    KvSlabReceiver, KvSlabSender)
from ompi_tpu_torch.serving.prefix_cache import (  # noqa: E402
    PrefixRegistry, PrefixStore, block_hashes)
from ompi_tpu_torch.serving.frontdoor import (  # noqa: E402
    SLO_BATCH, SLO_INTERACTIVE, Decision, FrontDoor, TokenBucket)
from ompi_tpu_torch.serving.router import Router  # noqa: E402
from ompi_tpu_torch.serving.worker import (  # noqa: E402
    ShardWorker, toy_draft_token, toy_token, worker_main)
from ompi_tpu_torch.serving.fleet import (  # noqa: E402
    PSET_POOL_PREFIX, FleetAutoscaler, FleetController, PoolSpec,
    pool_specs_from_psets)
from ompi_tpu_torch.serving.driver import (  # noqa: E402
    MixedPoissonDriver, PoissonDriver)

__all__ = [
    "PSET_ROUTER", "PSET_WORKERS", "PSET_POOL_PREFIX", "roles",
    "ServeRequest", "ContinuousBatchScheduler",
    "KvSlabSender", "KvSlabReceiver",
    "PrefixRegistry", "PrefixStore", "block_hashes",
    "Router", "ShardWorker", "worker_main",
    "toy_token", "toy_draft_token",
    "FrontDoor", "TokenBucket", "Decision",
    "SLO_INTERACTIVE", "SLO_BATCH",
    "FleetController", "FleetAutoscaler", "PoolSpec",
    "pool_specs_from_psets",
    "PoissonDriver", "MixedPoissonDriver",
]
