"""serving/driver — the synthetic heavy-traffic drivers.

Copy of ``ompi_tpu/serving/driver.py`` with its imports re-pointed.
:class:`MixedPoissonDriver` drives a :class:`~ompi_tpu_torch.serving.fleet.
FleetController` or a single :class:`~ompi_tpu_torch.serving.router.Router`.

:class:`PoissonDriver`: Poisson arrivals (seeded exponential
inter-arrival gaps) with mixed prompt/decode lengths, fed into a
:class:`~ompi_tpu_torch.serving.router.Router` in wall-clock time; the
report reads p50/p99 request latency out of the otpu-trace
``serve_request`` log2 histogram (the percentile estimator of
``runtime/trace.py``) and computes tokens/sec from the completed set —
the serving figures ``chip_smoke.py``'s ``serving`` phase prints,
qualitatively different from the OSU-style sweeps (open-loop offered
load against a queueing system instead of a closed request/reply
ping-pong).

:class:`MixedPoissonDriver`: the FLEET version — several tenants, each
with its own seeded arrival process, request rate, prompt/decode
length mix, target model, and (optionally) a pool of shared prompt
prefixes (the traffic shape that makes prefix-cache routing pay).
Per-tenant latency percentiles come from per-tenant otpu-trace
histogram FAMILIES (``serve_tenant_<name>``), each ``hist_reset`` at
run start, so two tenants' percentile populations never merge — the
per-tenant p99 is a real per-tenant number, not a blended one.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ompi_tpu_torch.base.var import registry
from ompi_tpu_torch.runtime import trace
from ompi_tpu_torch.serving.frontdoor import SLO_INTERACTIVE
from ompi_tpu_torch.serving.router import POOL_HIST_PREFIX, TENANT_HIST_PREFIX


class PoissonDriver:
    """Open-loop traffic: ``n_requests`` arrivals at ``rate_rps`` with
    prompt/decode lengths drawn uniformly from the given ranges."""

    def __init__(self, rate_rps: float = 200.0, n_requests: int = 64,
                 prompt_lens: tuple = (8, 64),
                 decode_lens: tuple = (4, 24), seed: int = 0) -> None:
        rng = np.random.default_rng(seed)
        self.n_requests = int(n_requests)
        gaps = rng.exponential(1.0 / float(rate_rps), self.n_requests)
        self.arrivals_s = np.cumsum(gaps)       # offsets from run start
        self.prompts = rng.integers(prompt_lens[0], prompt_lens[1] + 1,
                                    self.n_requests)
        self.decodes = rng.integers(decode_lens[0], decode_lens[1] + 1,
                                    self.n_requests)
        self._next = 0

    def due(self, elapsed_s: float) -> list:
        """(prompt_len, decode_len) pairs whose arrival time has come."""
        out = []
        while (self._next < self.n_requests
               and self.arrivals_s[self._next] <= elapsed_s):
            out.append((int(self.prompts[self._next]),
                        int(self.decodes[self._next])))
            self._next += 1
        return out

    @property
    def exhausted(self) -> bool:
        return self._next >= self.n_requests

    def run(self, router, max_wall_s: float = 120.0,
            tick_sleep_s: float = 0.0) -> dict:
        """Drive the router under this arrival process and report.

        Tracing is force-enabled for the run (the latency histogram IS
        the measurement instrument) and restored afterwards.
        """
        was_enabled = trace.enabled
        if not was_enabled:
            registry.set("otpu_trace_enable", True)
        # fresh percentile population: an earlier run in this process
        # must not bleed into this run's p50/p99
        trace.hist_reset("serve_request")
        t0 = time.perf_counter()
        try:
            while True:
                elapsed = time.perf_counter() - t0
                if elapsed > max_wall_s:
                    raise TimeoutError(
                        f"serving driver exceeded {max_wall_s}s with "
                        f"{len(router.completed())}/{self.n_requests} "
                        "requests complete")
                for prompt_len, decode_len in self.due(elapsed):
                    router.submit(prompt_len, decode_len)
                router.tick()
                if (self.exhausted and not router.sched.depth()
                        and not router.sched.running()):
                    break
                if tick_sleep_s:
                    time.sleep(tick_sleep_s)
            elapsed = time.perf_counter() - t0
            return self.report(router, elapsed)
        finally:
            if not was_enabled:
                registry.set("otpu_trace_enable", False)

    def report(self, router, elapsed_s: float) -> dict:
        done = router.completed()
        tokens = sum(len(r.tokens) for r in done)
        lat_ms = sorted((r.done_ns - r.arrival_ns) / 1e6 for r in done
                        if r.done_ns is not None)
        exact_p99 = _exact_p99(lat_ms)
        return {
            "requests": len(done),
            "elapsed_s": round(elapsed_s, 3),
            "tokens": int(tokens),
            "tokens_per_s": round(tokens / elapsed_s, 1),
            "req_per_s": round(len(done) / elapsed_s, 1),
            # the contract numbers: percentiles interpolated from the
            # otpu-trace log2 latency histogram
            "p50_ms": round(
                trace.hist_percentile("serve_request", 0.50) / 1000.0, 3),
            "p99_ms": round(
                trace.hist_percentile("serve_request", 0.99) / 1000.0, 3),
            # cross-check: exact p99 over the driver's own sample list
            # (the histogram estimate must sit within a log2 bin of it)
            "p99_exact_ms": round(exact_p99, 3),
            "requeued": router.lost_and_requeued,
        }


def _exact_p99(lat_ms: list) -> float:
    if not lat_ms:
        return 0.0
    return lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))]


class MixedPoissonDriver:
    """Multi-tenant open-loop traffic against a
    :class:`~ompi_tpu_torch.serving.fleet.FleetController` (or a single
    Router — anything with ``submit``/``tick``/``completed``).

    ``tenants`` maps a tenant name to its workload::

        {"ten_a": {"model": "m_a", "rate_rps": 300.0, "n_requests": 32,
                   "prompt_lens": (8, 64), "decode_lens": (4, 24),
                   "prefixes": 4, "prefix_len": 32},
         ...}

    Every tenant gets its OWN deterministic rng stream (seeded
    ``[seed, tenant index]``), so adding a tenant never perturbs
    another tenant's arrivals.  ``prefixes``/``prefix_len`` draw each
    prompt as one of ``prefixes`` shared token templates plus a random
    suffix — the shared-system-prompt shape that exercises
    prefix-cache routing; 0 (the default) submits length-only requests
    exactly like :class:`PoissonDriver`."""

    def __init__(self, tenants: dict, seed: int = 0) -> None:
        if not tenants:
            raise ValueError("mixed driver needs at least one tenant")
        self.tenants = {}
        events = []
        for idx, (name, cfg) in enumerate(sorted(tenants.items())):
            cfg = dict(cfg)
            model = cfg.get("model", "")
            rate = float(cfg.get("rate_rps", 200.0))
            n = int(cfg.get("n_requests", 32))
            plens = cfg.get("prompt_lens", (8, 64))
            dlens = cfg.get("decode_lens", (4, 24))
            n_prefix = int(cfg.get("prefixes", 0))
            prefix_len = int(cfg.get("prefix_len", 0))
            rng = np.random.default_rng([int(seed), idx])
            templates = [tuple(int(t) for t in
                               rng.integers(0, 50000, prefix_len))
                         for _ in range(n_prefix)] \
                if n_prefix and prefix_len else []
            arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
            for i in range(n):
                decode = int(rng.integers(dlens[0], dlens[1] + 1))
                if templates:
                    tmpl = templates[int(rng.integers(len(templates)))]
                    suffix = tuple(int(t) for t in rng.integers(
                        0, 50000, int(rng.integers(plens[0],
                                                   plens[1] + 1))))
                    prompt = tmpl + suffix
                    events.append((float(arrivals[i]), name, model,
                                   len(prompt), decode, prompt))
                else:
                    plen = int(rng.integers(plens[0], plens[1] + 1))
                    events.append((float(arrivals[i]), name, model,
                                   plen, decode, None))
            self.tenants[name] = {"model": model, "n_requests": n,
                                  "slo": str(cfg.get("slo", ""))}
        events.sort(key=lambda e: e[0])
        self.events = events
        self.n_requests = len(events)
        self._next = 0
        # shed/retry accounting per tenant — filled by run() when the
        # fleet has a front door armed, zero otherwise
        self._shed: dict = {}
        self._retried: dict = {}

    def due(self, elapsed_s: float) -> list:
        """(tenant, model, prompt_len, decode_len, prompt-tokens)
        tuples whose arrival time has come, across every tenant."""
        out = []
        while (self._next < self.n_requests
               and self.events[self._next][0] <= elapsed_s):
            out.append(self.events[self._next][1:])
            self._next += 1
        return out

    @property
    def exhausted(self) -> bool:
        return self._next >= self.n_requests

    def _submit(self, fleet, tenant, model, plen, dlen,
                prompt) -> Optional[float]:
        """Submit one arrival.  Returns ``None`` when admitted, or the
        front door's retry-after hint (seconds) when shed — the run
        loop re-arrives the request after exactly that delay."""
        cls = self.tenants[tenant].get("slo", "")
        fd = getattr(fleet, "frontdoor", None)
        if fd is not None:
            used = cls or SLO_INTERACTIVE
            self.tenants[tenant]["slo_used"] = used
            dec = fd.submit(tenant, model, prompt_len=plen,
                            max_new_tokens=dlen, slo=used,
                            prompt=prompt)
            if not dec.admitted:
                return dec.retry_after_s
        elif hasattr(fleet, "routers"):
            fleet.submit(tenant, model, prompt_len=plen,
                         max_new_tokens=dlen, prompt=prompt, slo=cls)
        else:                          # a bare Router works too
            fleet.submit(plen, dlen, tenant=tenant, prompt=prompt,
                         slo=cls)
        return None

    @staticmethod
    def _idle(fleet) -> bool:
        """Nothing queued or running — fleet and bare Router alike
        (the Router keeps those on its scheduler)."""
        sched = fleet if hasattr(fleet, "depth") else fleet.sched
        return not sched.depth() and not sched.running()

    def run(self, fleet, max_wall_s: float = 120.0,
            tick_sleep_s: float = 0.0,
            check_invariants: bool = False) -> dict:
        """Drive the fleet under the merged arrival processes and
        report per tenant.  Tracing is force-enabled for the run (the
        histogram families ARE the measurement instrument) and every
        per-tenant/per-pool family is reset first — percentile
        populations from an earlier run in this process never merge
        into this one's."""
        was_enabled = trace.enabled
        if not was_enabled:
            registry.set("otpu_trace_enable", True)
        trace.hist_reset("serve_request")
        models = set()
        for name, info in self.tenants.items():
            trace.hist_reset(TENANT_HIST_PREFIX + name)
            models.add(info["model"])
        for model in models:
            trace.hist_reset(POOL_HIST_PREFIX + model)
        prefills0, hits0 = self._prefix_counts(fleet)
        self._shed = {}
        self._retried = {}
        #: shed arrivals waiting out their retry-after hint:
        #: (due_s, tenant, model, plen, dlen, prompt)
        pending: list = []
        fd = getattr(fleet, "frontdoor", None)
        t0 = time.perf_counter()
        try:
            while True:
                elapsed = time.perf_counter() - t0
                if elapsed > max_wall_s:
                    raise TimeoutError(
                        f"mixed driver exceeded {max_wall_s}s with "
                        f"{len(fleet.completed())}/{self.n_requests} "
                        "requests complete")
                arrivals = list(self.due(elapsed))
                if pending:
                    # honor retry-after: a shed request re-arrives only
                    # once its hinted delay has fully elapsed
                    due_now = [e for e in pending if e[0] <= elapsed]
                    if due_now:
                        pending = [e for e in pending
                                   if e[0] > elapsed]
                        for e in due_now:
                            self._retried[e[1]] = \
                                self._retried.get(e[1], 0) + 1
                        arrivals.extend(e[1:] for e in due_now)
                for tenant, model, plen, dlen, prompt in arrivals:
                    retry = self._submit(fleet, tenant, model, plen,
                                         dlen, prompt)
                    if retry is not None:
                        self._shed[tenant] = \
                            self._shed.get(tenant, 0) + 1
                        pending.append((elapsed + retry, tenant, model,
                                        plen, dlen, prompt))
                fleet.tick()
                if check_invariants and hasattr(fleet, "routers"):
                    for router in fleet.routers.values():
                        router.sched.check_invariants()
                    if fd is not None:
                        fd.check_invariants()
                if (self.exhausted and not pending
                        and (fd is None or not fd.depth())
                        and self._idle(fleet)):
                    break
                if tick_sleep_s:
                    time.sleep(tick_sleep_s)
            elapsed = time.perf_counter() - t0
            return self.report(fleet, elapsed, prefills0, hits0)
        finally:
            if not was_enabled:
                registry.set("otpu_trace_enable", False)

    @staticmethod
    def _prefix_counts(fleet) -> tuple:
        """(full prefills, verified hits) as the ROUTER side counted
        them from worker reports — works across processes, where SPC
        counters (per process, worker-side) cannot."""
        routers = fleet.routers.values() if hasattr(fleet, "routers") \
            else (fleet,)
        return (sum(r.prefill_count for r in routers),
                sum(r.prefix_hit_count for r in routers))

    def report(self, fleet, elapsed_s: float, prefills0: int = 0,
               hits0: int = 0) -> dict:
        done = fleet.completed()
        tokens = sum(len(r.tokens) for r in done)
        per_tenant = {}
        for name in self.tenants:
            mine = [r for r in done if r.tenant == name]
            lat_ms = sorted((r.done_ns - r.arrival_ns) / 1e6
                            for r in mine if r.done_ns is not None)
            fam = TENANT_HIST_PREFIX + name
            t_tokens = sum(len(r.tokens) for r in mine)
            per_tenant[name] = {
                "requests": len(mine),
                "tokens": t_tokens,
                "tokens_per_s": round(t_tokens / elapsed_s, 1),
                # per-tenant percentiles from the tenant's OWN
                # histogram family — populations never merge
                "p50_ms": round(
                    trace.hist_percentile(fam, 0.50) / 1000.0, 3),
                "p99_ms": round(
                    trace.hist_percentile(fam, 0.99) / 1000.0, 3),
                "p99_exact_ms": round(_exact_p99(lat_ms), 3),
                # front-door accounting (0/0 without a door): every
                # shed eventually re-arrives, so shed <= retried at
                # drain time and completed == n_requests
                "shed": self._shed.get(name, 0),
                "retried": self._retried.get(name, 0),
            }
        # per-SLO-class rollup: latency populations from the done
        # requests' own class stamps, shed/retried attributed through
        # each tenant's effective submit class
        by_cls: dict = {}
        for r in done:
            by_cls.setdefault(r.slo or "unclassified", []).append(r)
        slo_classes = {}
        for cls, reqs in sorted(by_cls.items()):
            lat = sorted((r.done_ns - r.arrival_ns) / 1e6 for r in reqs
                         if r.done_ns is not None)
            slo_classes[cls] = {
                "requests": len(reqs),
                "tokens": sum(len(r.tokens) for r in reqs),
                "p50_ms": round(lat[len(lat) // 2], 3) if lat else 0.0,
                "p99_exact_ms": round(_exact_p99(lat), 3),
                "shed": 0, "retried": 0,
            }
        for name, info in self.tenants.items():
            cls = info.get("slo_used") or info.get("slo") \
                or "unclassified"
            if cls in slo_classes:
                slo_classes[cls]["shed"] += self._shed.get(name, 0)
                slo_classes[cls]["retried"] += \
                    self._retried.get(name, 0)
        prefills_now, hits_now = self._prefix_counts(fleet)
        prefills = prefills_now - prefills0
        hits = hits_now - hits0
        return {
            "requests": len(done),
            "elapsed_s": round(elapsed_s, 3),
            "tokens": int(tokens),
            "tokens_per_s": round(tokens / elapsed_s, 1),
            "req_per_s": round(len(done) / elapsed_s, 1),
            "tenants": per_tenant,
            "slo_classes": slo_classes,
            "shed": sum(self._shed.values()),
            "retried": sum(self._retried.values()),
            # the prefix-cache evidence: full prefill passes actually
            # computed vs worker-verified hits that skipped them
            "prefills": int(prefills),
            "prefix_hits": int(hits),
            "prefix_hit_rate": round(hits / (prefills + hits), 4)
            if (prefills + hits) else 0.0,
            "requeued": fleet.lost_and_requeued,
        }
