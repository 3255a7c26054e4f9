"""hook/comm_method — print the selected transport matrix at init.

Copy of ``ompi_tpu/mca/hook/comm_method.py`` (after
``ompi/mca/hook/comm_method/``): when ``otpu_hook_comm_method_display`` is
set, each rank prints one ``[comm_method]`` line naming the btl that
reaches every peer and, where the rte knows the nodes, hwloc's locality
tier between them (``inter``, ``node``, ``numa``, ``core``) from the
peers' ``cpus`` modex: the tool that answers "is this job using sm or
falling back to tcp?".
"""
from __future__ import annotations

from ompi_tpu_torch.base.mca import Component
from ompi_tpu_torch.base.var import VarType


class CommMethodComponent(Component):
    name = "comm_method"
    priority = 10

    def register_vars(self, fw) -> None:
        self.display_var = self.register_var(
            "display", vtype=VarType.BOOL, default=False,
            help="Print the per-peer transport (BTL) matrix after init "
                 "(hook/comm_method's mca_hook_comm_method_enable_mpi_init)")

    def at_init(self, world) -> None:
        if not bool(self.display_var.value):
            return
        pml = world.pml
        bml = getattr(pml, "bml", None)
        if bml is None:         # an interposed pml without forwarding
            bml = getattr(getattr(pml, "_inner", None), "bml", None)
        if bml is None:
            return
        me = world.rank
        rte = world.rte
        from ompi_tpu_torch.base import hwloc

        my_node = getattr(rte, "_node", None)
        my_cpus = None
        topo = hwloc.host_topology()
        loc_names = {hwloc.LOC_DIFFERENT_NODE: "inter",
                     hwloc.LOC_SAME_NODE: "node",
                     hwloc.LOC_SAME_NUMA: "numa",
                     hwloc.LOC_SAME_CORE: "core"}
        if hasattr(rte, "modex_get"):
            my_cpus = rte.modex_get(rte.my_world_rank, "cpus", wait=False)
        cells = []
        for r in range(world.size):
            w = world.world_rank(r)
            if w == rte.my_world_rank:
                cells.append("self*")
                continue
            eps = bml.endpoints(w)
            cell = eps[0].btl.name if eps else "none"
            # the locality tier from the peer's modexed topology facts
            if my_node is not None and hasattr(rte, "node_of"):
                peer_node = rte.node_of(w)
                peer_cpus = rte.modex_get(w, "cpus", wait=False) \
                    if hasattr(rte, "modex_get") else None
                tier = hwloc.locality(
                    my_node, peer_node or "?", my_cpus, peer_cpus,
                    topo.numa_nodes, ncpus=topo.ncpus_online)
                cell += f"/{loc_names[tier]}"
            cells.append(cell)
        print(f"[comm_method] rank {me}: " +
              " ".join(f"{r}:{c}" for r, c in enumerate(cells)),
              flush=True)


COMPONENT = CommMethodComponent()
