"""Hardware topology discovery and process binding (the hwloc analog).

Copy of ``ompi_tpu/base/hwloc.py`` (after ``opal/mca/hwloc/``), which
answers two questions the runtime keeps asking: what does this host look
like (cores, NUMA nodes), so ranks can be *bound*, and how local are two
peers (same node, same NUMA node, same cores), so a tool can say which
tier joins them.  No external library: host facts come from ``os`` and
``/sys``.

The host half (``HostTopology``, ``host_topology``, ``_parse_cpulist``,
``compute_binding``, ``bind_self``, ``locality`` with its ``LOC_*`` tiers)
is the reference's.  ``compute_binding`` partitions the process's
*original* affinity mask, captured once before any binding, so that init,
finalize, init does not partition an already narrowed mask.  ``bind_self``
touches only the calling process (``os.sched_setaffinity(0, ...)``).

The device half describes the card: ``device_topology`` lists the CUDA
devices from ``torch.cuda.get_device_properties`` (name, memory, SM count,
PCI bus id) as ``CudaDevice`` entries, and an empty list without a card.
A GPU has no interconnect coordinates, so ``ici_mesh_shape`` returns what
the reference returns when no device has coordinates: None.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import socket
from typing import Optional

# locality tiers, opal_hwloc_locality_t analog (monotone: each implies the
# ones above it)
LOC_DIFFERENT_NODE = 0
LOC_SAME_NODE = 1
LOC_SAME_NUMA = 2
LOC_SAME_CORE = 3


@dataclasses.dataclass(frozen=True)
class HostTopology:
    hostname: str
    ncpus_online: int
    cpus_allowed: tuple     # affinity mask of this process
    numa_nodes: tuple       # tuple of (node_id, cpu_tuple)

    @property
    def nnuma(self) -> int:
        return max(1, len(self.numa_nodes))


@dataclasses.dataclass(frozen=True)
class CudaDevice:
    index: int
    name: str
    total_memory: int       # bytes
    sm_count: int
    pci_bus_id: str


def _read_numa() -> tuple:
    nodes = []
    for path in sorted(glob.glob("/sys/devices/system/node/node[0-9]*")):
        nid = int(os.path.basename(path)[4:])
        try:
            with open(os.path.join(path, "cpulist")) as f:
                cpus = _parse_cpulist(f.read().strip())
        except OSError:
            cpus = ()
        nodes.append((nid, cpus))
    return tuple(nodes)


def _parse_cpulist(s: str) -> tuple:
    cpus = []
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            a, b = part.split("-")
            cpus.extend(range(int(a), int(b) + 1))
        else:
            cpus.append(int(part))
    return tuple(cpus)


_host_cache: Optional[HostTopology] = None
_orig_affinity: Optional[tuple] = None   # pre-binding mask, captured once


def _current_affinity() -> tuple:
    try:
        return tuple(sorted(os.sched_getaffinity(0)))
    except AttributeError:              # non-Linux
        return tuple(range(os.cpu_count() or 1))


def host_topology(refresh: bool = False) -> HostTopology:
    global _host_cache, _orig_affinity
    if _orig_affinity is None:
        _orig_affinity = _current_affinity()
    if _host_cache is None or refresh:
        _host_cache = HostTopology(
            hostname=socket.gethostname(),
            ncpus_online=os.cpu_count() or 1,
            cpus_allowed=_current_affinity(),
            numa_nodes=_read_numa(),
        )
    return _host_cache


def device_topology() -> list:
    """The CUDA devices this process sees (empty without a card)."""
    import torch

    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        bus = "{:04x}:{:02x}:{:02x}.0".format(
            int(getattr(p, "pci_domain_id", 0)),
            int(getattr(p, "pci_bus_id", 0)),
            int(getattr(p, "pci_device_id", 0)))
        out.append(CudaDevice(index=i, name=p.name,
                              total_memory=int(p.total_memory),
                              sm_count=int(p.multi_processor_count),
                              pci_bus_id=bus))
    return out


def ici_mesh_shape() -> Optional[tuple]:
    """The physical interconnect torus extent: None, as the reference
    returns when no device has coordinates (a GPU has none)."""
    return None


def compute_binding(rank: int, nranks: int,
                    topo: Optional[HostTopology] = None) -> tuple:
    """Contiguous block partition of allowed CPUs for local rank i of n.

    The ``--bind-to core`` policy: each rank gets floor(ncpus/nranks)
    cores, NUMA-contiguous because cpus_allowed is sorted.  With fewer
    cores than ranks it returns every CPU (oversubscription unbinds).
    Without an explicit ``topo`` it partitions the ORIGINAL process mask
    (captured before any ``bind_self``)."""
    if topo is not None:
        cpus = topo.cpus_allowed
    else:
        host_topology()            # ensures _orig_affinity is captured
        cpus = _orig_affinity
    per = len(cpus) // nranks
    if per == 0:
        return cpus
    return cpus[rank * per:(rank + 1) * per]


def bind_self(cpus) -> bool:
    """Apply a CPU binding to this process; False if unsupported."""
    try:
        os.sched_setaffinity(0, set(cpus))
        return True
    except (AttributeError, OSError):
        return False


def locality(a_host: str, b_host: str, a_cpus=None, b_cpus=None,
             numa_nodes=None, ncpus: Optional[int] = None) -> int:
    """Locality tier between two ranks from their modexed facts.

    Overlapping masks only mean SAME_CORE when the ranks are actually
    *bound* (mask smaller than the whole host): two unbound ranks share
    the full mask and say nothing about core sharing."""
    if a_host != b_host:
        return LOC_DIFFERENT_NODE
    if a_cpus and b_cpus:
        sa, sb = set(a_cpus), set(b_cpus)
        total = ncpus if ncpus is not None else (os.cpu_count() or 1)
        bound = len(sa) < total and len(sb) < total
        if bound and sa & sb:
            return LOC_SAME_CORE
        for _nid, node_cpus in (numa_nodes or ()):
            nc = set(node_cpus)
            if sa & nc and sb & nc and bound:
                return LOC_SAME_NUMA
    return LOC_SAME_NODE


def summary() -> str:
    t = host_topology()
    lines = [f"host: {t.hostname}  cpus: {t.ncpus_online} "
             f"(allowed {len(t.cpus_allowed)})  numa: {t.nnuma}"]
    # device facts are best-effort: an info tool must not need a card
    # just to print the host's topology
    try:
        devs = device_topology()
    except Exception as exc:
        lines.append(f"  devices: unavailable ({type(exc).__name__})")
        return "\n".join(lines)
    if not devs:
        lines.append("  devices: none")
    for d in devs:
        lines.append(f"  device[{d.index}] {d.name} sms={d.sm_count} "
                     f"mem={d.total_memory} pci={d.pci_bus_id}")
    return "\n".join(lines)
