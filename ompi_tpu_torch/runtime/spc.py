"""Software performance counters (``ompi/runtime/ompi_spc.c``: inline
counters bumped in the bindings, exported as MPI_T-style pvars).

Copy of ``ompi_tpu/runtime/spc.py`` with the counters that the port's
modules record: point-to-point and its protocols (ob1's RGET rung and
its striped streams among them), the device collectives (``bump_device``),
the coordination client's retries, the codec (the MoE
dispatch's and coll/quant's host codec) and the host collectives'
fastpath counters (coll/algorithms' schedule cache, coll/tuned's eager
lane, the accelerator's staging pool) and the host transports' (btl/tcp,
the native reactor, coll/quant's wire stage) and the observability
runtime's (the telemetry sampler's publishes, the profiler's ticks, the
trace's flow halves) and fault injection's (each chaos fault, the flight
recorder's dumps) and partitioned communication's and the MoE trainer's,
and the serving engine's (``ompi_tpu_torch/serving``: the scheduler, the
prefix cache, the front door, speculative decode, the fleet's scale-downs
and enlists, the request trace and the SLO accountant's).  The reference's
other counters (the per-collective call counts) come with the modules that
record them.
"""
from __future__ import annotations

from ompi_tpu_torch.base.var import PvarClass, registry

_COUNTERS = (
    "send", "isend", "recv", "irecv", "probe", "iprobe",
    "bytes_sent", "bytes_received",
    "unexpected_msgs", "out_of_sequence_msgs", "matched_msgs",
    "rget_msgs", "striped_msgs",
    # partitioned communication (mca/part): Pready and Parrived calls, the
    # wire messages the aggregation left, and the partitioned bytes
    "part_pready", "part_parrived", "part_msgs", "part_bytes",
    "device_collectives", "device_bytes",
    "coord_reconnects", "coord_rpc_retries",
    "quant_encodes", "quant_decodes",
    # fastpath counters: the schedule cache must hit on repeated
    # collectives, and the staging pool must reuse its warm buffers
    "fastpath_sched_hits", "fastpath_sched_misses", "fastpath_eager_lane",
    "fastpath_staging_hits", "fastpath_staging_misses",
    # the host transports: btl/tcp's header forms, sendmsg calls and
    # backpressure copies, the native reactor's drains and its two lanes,
    # the wire's integrity trips and coll/quant's wire stage
    "fastpath_hdr_fast", "fastpath_hdr_pickle", "fastpath_sendmsg",
    "fastpath_payload_copies", "progress_native_drains",
    "fastpath_native_frags", "fastpath_native_raw", "wire_cksum_fail",
    "wire_desync",
    "quant_wire_bytes_saved", "quant_wire_decode_fail",
    # the observability runtime: telemetry samples published into the
    # coord KV (runtime/telemetry), sampling-profiler ticks
    # (runtime/profile), and the trace's message-flow halves
    # (runtime/trace flow_start/flow_finish)
    "telemetry_samples", "profile_samples", "flow_starts", "flow_finishes",
    # chaos (ft/chaos): every injected fault is counted, so a chaos run
    # self-documents what it actually injected; the flight recorder's dumps
    "chaos_drop", "chaos_delay", "chaos_dup", "chaos_corrupt",
    "chaos_reset", "chaos_stall", "chaos_disconnect", "chaos_kill",
    "flight_dumps",
    # MoE expert parallelism (parallel/moe's MoeTrainer): tokens entering
    # the ragged dispatch, tokens dropped by the capacity policy, and the
    # high-water per-step load-imbalance factor in milli-units (a gauge
    # kept as a monotonic high-water so the counter plane stays
    # append-only)
    "moe_dispatch_tokens", "moe_dropped_tokens", "moe_imbalance_max",
    # serving (ompi_tpu_torch/serving): the continuous-batching engine's
    # admissions and evictions per tick, decoded token volume, KV-slab
    # streaming epochs, requests requeued by serve-through-failure and
    # autoscale spawns; full prefill passes, prefix-cache hits, router-side
    # lookup misses and stale hints; the fleet's telemetry-policy
    # scale-downs and re-enlistments; the front door's sheds and preemptions
    # and speculative decode's accepted and rejected draft tokens
    "serve_requests", "serve_tokens", "serve_ticks", "serve_admitted",
    "serve_evicted", "serve_requeued", "serve_kv_epochs", "serve_scaleups",
    "serve_prefills", "serve_prefix_hits", "serve_prefix_misses",
    "serve_prefix_stale", "serve_scaledowns", "serve_enlists",
    "serve_shed", "serve_preempt", "serve_spec_accepts",
    "serve_spec_rejects",
    # the request trace (runtime/trace's requests layer): requests whose
    # causal chain was stamped and the stage spans emitted, both flat while
    # otpu_trace_requests is off; the SLO accountant (runtime/telemetry):
    # completions within otpu_serving_slo_p99_ms and those breaching it
    "req_traced", "req_stages", "slo_goodput", "slo_breaches",
)

_pvars = {}


def init() -> None:
    for name in _COUNTERS:
        _pvars[name] = registry.register_pvar(
            "runtime", "spc", name, pclass=PvarClass.COUNTER,
            help=f"SPC counter: number/volume of {name}")
    # device counters accumulate in module ints (bump_device) and fold in
    # lazily; the pre-read hook keeps direct pvar readers coherent too
    for name in ("device_collectives", "device_bytes"):
        _pvars[name].on_read = _flush_device


def record(name: str, value: float = 1) -> None:
    pv = _pvars.get(name)
    if pv is not None:
        pv.add(value)


_dev_calls_n = 0
_dev_bytes_n = 0


def bump_device(nbytes: int) -> None:
    """Hot-path SPC bump for device collectives: two plain integer adds on
    module globals (folded into the pvars at read time), as the reference's
    inline non-atomic counter increments (``ompi_spc.c``)."""
    global _dev_calls_n, _dev_bytes_n
    _dev_calls_n += 1
    _dev_bytes_n += nbytes


def _flush_device() -> None:
    """Fold the relaxed device-counter accumulators into their pvars."""
    global _dev_calls_n, _dev_bytes_n
    if _dev_calls_n:
        pv = _pvars.get("device_collectives")
        if pv is not None:
            pv.add(_dev_calls_n)
            _dev_calls_n = 0
        pv = _pvars.get("device_bytes")
        if pv is not None:
            pv.add(_dev_bytes_n)
            _dev_bytes_n = 0


def read(name: str) -> float:
    pv = _pvars.get(name)
    return 0 if pv is None else pv.read()


def counters() -> dict:
    return {k: v.read() for k, v in _pvars.items()}
