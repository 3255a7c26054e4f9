"""bml/r2 equivalent: per-peer BTL endpoint selection.

Copy of ``ompi_tpu/mca/bml/r2.py``.  The reference's ``bml_r2.c`` builds,
for every peer, the list of BTLs that can reach it, ordered for latency
(eager sends) and striped by bandwidth (large transfers).  Here: query
every available btl component for reachability at add_procs time; the
lowest-latency endpoint serves eager traffic (btl/sm on one node, btl/tcp
between nodes), the full list serves pml/ob1's striping.
"""
from __future__ import annotations

from typing import Callable, Optional

from ompi_tpu_torch.base import mca
from ompi_tpu_torch.mca.btl.base import Endpoint, Frag


class Bml:
    def __init__(self, rte, recv_cb: Callable[[Frag], None]) -> None:
        self.rte = rte
        self._endpoints: dict[int, list[Endpoint]] = {}
        fw = mca.framework("btl", "byte transfer layer", multi_select=True)
        self.btls = []
        for btl in fw.select_all():
            btl.set_recv_callback(recv_cb)
            setup = getattr(btl, "setup", None)
            if setup is not None:
                try:
                    if setup(rte) is False:
                        continue  # transport not usable in this process model
                except Exception as exc:
                    from ompi_tpu_torch.base import output as _o

                    _o.output(fw.stream, 1, "btl %s setup failed: %s",
                              btl.name, exc)
                    close = getattr(btl, "close", None)
                    if close is not None:
                        try:
                            close()  # release partially-acquired resources
                        except Exception:
                            pass
                    continue
            self.btls.append(btl)
            from ompi_tpu_torch.runtime import progress as prog

            prog.register(btl.progress)

    def add_proc(self, world_rank: int) -> list[Endpoint]:
        eps = []
        for btl in self.btls:
            ep = btl.reachable(world_rank, self.rte)
            if ep is not None:
                eps.append(ep)
        eps.sort(key=lambda e: (e.btl.latency, -e.btl.bandwidth))
        self._endpoints[world_rank] = eps
        return eps

    def endpoint(self, world_rank: int) -> Optional[Endpoint]:
        """Lowest-latency endpoint for the peer (eager path)."""
        eps = self._endpoints.get(world_rank)
        if eps is None:
            eps = self.add_proc(world_rank)
        return eps[0] if eps else None

    def endpoints(self, world_rank: int) -> list[Endpoint]:
        eps = self._endpoints.get(world_rank)
        if eps is None:
            eps = self.add_proc(world_rank)
        return eps

    def flush(self) -> None:
        """Drain every btl's queued sends (``flush`` where a btl queues)."""
        for btl in self.btls:
            flush = getattr(btl, "flush", None)
            if flush is not None:
                flush()

    def finalize(self) -> None:
        # resource release itself happens in each component's close() via
        # the framework close lifecycle (mca.close_all in runtime finalize)
        from ompi_tpu_torch.runtime import progress as prog

        for btl in self.btls:
            prog.unregister(btl.progress)
