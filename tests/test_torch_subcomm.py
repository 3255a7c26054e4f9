"""Sub-communicators on the raised ring (coll/ring against coll/pallas), on
the CPU lane: ``create`` over ranks 0, 2, 4, 6 (n = 4), a ``split`` into
sizes 3, 3 and 2 (each reached through ``as_rank``), and a size-1 split.
coll/ring and coll/pallas build their module with the sub-comm's size, so
the ring reductions (K3, K5; K4, K6 above ``vmem_max_bytes``), the
all-gather (K10) and the bcast (K12) run their schedules over the member
rows only, at n = 4, 3 and 2: plain versions here, interpret mode in the
reference, bit for bit.  A size-1 comm takes coll/self_coll for its host
slots and the ring's n = 1 copies for its device slots.
"""
import numpy as np
import pytest

import ompi_tpu_torch
from ompi_tpu_torch.base import cudaenv
from test_torch_comm import _owner, _same
from test_torch_world import ring_worlds  # noqa: F401

#: the sub-comms: name -> (make from a world, members)
SUBS = {
    "create 0,2,4,6": (lambda w: w.create(w.group.incl([0, 2, 4, 6])),
                       [0, 2, 4, 6]),
    "split first 3": (lambda w: w.as_rank(1).split([0, 0, 0, 1, 1, 1, 2, 2]),
                      [0, 1, 2]),
    "split second 3": (lambda w: w.as_rank(4).split([0, 0, 0, 1, 1, 1, 2, 2]),
                       [3, 4, 5]),
    "split 2": (lambda w: w.as_rank(7).split([0, 0, 0, 1, 1, 1, 2, 2], [0] * 6 + [1, 0]),
                [7, 6]),
}


def _spy(monkeypatch, names):
    """Record (wrapper, n) for each call to the ring wrappers ``names``."""
    from ompi_tpu_torch.ops import ring_collectives as rc

    seen = []
    for name in names:
        real = getattr(rc, name)
        monkeypatch.setattr(
            rc, name, lambda *a, _n=name, _r=real, **k:
            seen.append((_n, a[1], k.get("variant"))) or _r(*a, **k))
    return seen


def _x(n, per, seed):
    return (1.0 + 0.05 * np.random.default_rng(seed).standard_normal(
        (n, per))).astype(np.float32)


@pytest.mark.parametrize("sub", list(SUBS))
def test_ring_on_a_subcomm_matches_pallas(ring_worlds, sub, monkeypatch):
    """allreduce (SUM, MAX, PROD: K3), reduce_scatter (K5), allgather (K10)
    and bcast (K12) on the member rows, each taken by the ring with the
    sub-comm's n, bit for bit with the reference's sub-comm."""
    from ompi_tpu.api import op as jop

    jw, tw = ring_worlds
    make, members = SUBS[sub]
    js, ts = make(jw), make(tw)
    n = len(members)
    assert list(ts.group.world_ranks) == members == list(js.group.world_ranks)
    for slot in ("allreduce_array", "reduce_scatter_array", "allgather_array",
                 "bcast_array"):
        assert _owner(ts, slot) == "RingCollModule"
        assert _owner(js, slot) == "PallasCollModule"
    seen = _spy(monkeypatch, ("all_reduce", "reduce_scatter", "all_gather",
                              "bcast"))
    x, z = _x(n, 1000, n), _x(n * n, 37, n + 1).reshape(n, n, 37)
    for op in ("SUM", "MAX", "PROD"):
        _same(ts.allreduce_array(x, getattr(ompi_tpu_torch, op)),
              js.allreduce_array(x, getattr(jop, op)), f"{sub} {op}")
    _same(ts.reduce_scatter_array(z), js.reduce_scatter_array(z), sub)
    _same(ts.allgather_array(x), js.allgather_array(x), sub)
    _same(ts.bcast_array(x, n - 1), js.bcast_array(x, n - 1), sub)
    assert seen == [("all_reduce", n, "fused")] * 3 + [
        ("reduce_scatter", n, "fused"), ("all_gather", n, "ring"),
        ("bcast", n, None)], seen


@pytest.mark.parametrize(
    "ring_worlds", [{"otpu_coll_ring_vmem_max_bytes": 1024}], indirect=True)
@pytest.mark.parametrize("sub", ["create 0,2,4,6", "split second 3"])
def test_segmented_ring_on_a_subcomm_matches_pallas(ring_worlds, sub,
                                                    monkeypatch):
    """Above vmem_max_bytes per rank: K4 and K6 on the member rows."""
    jw, tw = ring_worlds
    make, members = SUBS[sub]
    js, ts = make(jw), make(tw)
    n = len(members)
    seen = _spy(monkeypatch, ("all_reduce", "reduce_scatter"))
    x, z = _x(n, 1000, 7), _x(n * n, 600, 8).reshape(n, n, 600)
    _same(ts.allreduce_array(x), js.allreduce_array(x), sub)
    _same(ts.reduce_scatter_array(z), js.reduce_scatter_array(z), sub)
    assert seen == [("all_reduce", n, "seg"), ("reduce_scatter", n, "seg")]


def test_size_one_split_on_the_raised_ring(ring_worlds):
    """A size-1 comm: coll/self_coll owns its host slots; its device slots
    are the ring's n = 1 forms (a copy), as the reference's."""
    from ompi_tpu.api import op as jop

    jw, tw = ring_worlds
    color = [0] * 5 + [1, 2, 2]
    js, ts = jw.as_rank(5).split(color), tw.as_rank(5).split(color)
    assert ts.size == js.size == 1 and list(ts.group.world_ranks) == [5]
    assert _owner(ts, "allreduce") == "SelfCollModule"
    assert _owner(ts, "allreduce_array") == "RingCollModule"
    x = _x(1, 64, 9)
    _same(ts.allreduce_array(x), js.allreduce_array(x, jop.SUM))
    _same(ts.allgather_array(x), js.allgather_array(x))
    _same(ts.bcast_array(x, 0), js.bcast_array(x, 0))
    _same(ts.reduce_array(x, ompi_tpu_torch.SUM, 0), js.reduce_array(x, jop.SUM, 0))
    _same(ts.allreduce(x[0]), js.allreduce(x[0]))


def test_conductor_on_a_subcomm_forwards_to_the_ring(ring_worlds,
                                                     monkeypatch):
    """A tensor given to a sub-comm's host allreduce reaches the ring with
    the sub-comm's n."""
    import torch

    _, tw = ring_worlds
    sub = SUBS["split first 3"][0](tw)
    seen = _spy(monkeypatch, ("all_reduce",))
    x = torch.from_numpy(_x(3, 100, 10))
    out = sub.allreduce(x)
    assert seen == [("all_reduce", 3, "fused")]
    _same(cudaenv.to_numpy(out), cudaenv.to_numpy(sub.allreduce_array(x)))
