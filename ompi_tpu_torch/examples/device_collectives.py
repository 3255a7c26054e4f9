"""Device-collective tour: coll/builtin, coll/ring, and the fused GEMM.

The counterpart of the JAX package's ``examples/device_collectives.py``.
Runs in the device world (one process drives every virtual rank: the rows
of one tensor on one device).  Shows the device transports a user can
select between:

1. **coll/builtin** (default): torch's own reductions over the rank axis —
   the right default.
2. **coll/ring** (``--mca coll_ring_priority 95`` or the in-process
   override below): the hand-written ring kernels (K3 at this size), and
   the pipelined bcast (K12).
3. **ops/overlap**: the fused collective matmul (K20) — per-block compute
   overlapping each ring step's exchange.
4. The duplex all-gather (K11) and the 2-D torus schedules on a (2, n/2)
   grid, whose phases are sub-ring launches of K5 and K10.

    python -m ompi_tpu_torch.examples.device_collectives [--device cpu]

``--device`` names the device the world binds to (default: the card, where
every kernel above launches; on ``cpu`` each runs its plain version).
"""
import argparse

import numpy as np
import torch

import ompi_tpu_torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device the world binds to (default: the card)")
    args = ap.parse_args(argv)
    world = ompi_tpu_torch.init(device=args.device)
    device = world.rte.device
    n = world.size
    print(f"device world: {n} rank(s)")
    rng = np.random.default_rng(0)
    got = {}

    # -- 1. coll/builtin (the default owner of the *_array slots) --------
    x = rng.standard_normal((n, 1024)).astype(np.float32)
    out = world.allreduce_array(x).cpu().numpy()
    np.testing.assert_allclose(out, x.sum(0), rtol=1e-4, atol=1e-5)
    owner = world.c_coll["allreduce_array"].__self__.__class__.__name__
    print(f"allreduce via {owner}: ok")
    got["allreduce_builtin"] = out

    # -- 2. coll/ring (the hand-written ring kernels) --------------------
    if n == 1:
        print("SKIPPED: rings need >1 rank — set "
              "OTPU_MCA_rte_virtual_ranks=8")
    if n > 1:
        from ompi_tpu_torch.base.var import registry
        from ompi_tpu_torch.runtime import init as rt

        var = registry.lookup("otpu_coll_ring_priority")
        if var is None:
            raise SystemExit("coll/ring did not register its vars "
                             "(component excluded?)")
        old = var.value
        var.set(95)       # the MPI_T-style cvar write API
        rt.reset_for_testing()
        try:
            w2 = ompi_tpu_torch.init(device=args.device)
            owner = w2.c_coll["allreduce_array"].__self__.__class__.__name__
            out = w2.allreduce_array(x).cpu().numpy()
            np.testing.assert_allclose(out, x.sum(0), rtol=1e-4, atol=1e-5)
            b = w2.bcast_array(x, root=n - 1).cpu().numpy()
            np.testing.assert_allclose(
                b, np.broadcast_to(x[n - 1], x.shape), rtol=1e-6)
            print(f"allreduce + pipelined bcast via {owner}: ok")
            got["allreduce_ring"], got["bcast"] = out, b
        finally:
            var.set(old)
            rt.reset_for_testing()
            ompi_tpu_torch.init(device=args.device)

    # -- 3. the fused collective matmul ----------------------------------
    if n > 1:
        from ompi_tpu_torch.ops import overlap

        M, K, N = 64, 16 * n, 32
        a = rng.standard_normal((n, M, K // n)).astype(np.float32)
        bb = rng.standard_normal((n, K // n, N)).astype(np.float32)
        y = overlap.matmul_allreduce(torch.from_numpy(a).to(device),
                                     torch.from_numpy(bb).to(device), n)
        y = y.cpu().numpy()
        np.testing.assert_allclose(
            y, sum(a[i] @ bb[i] for i in range(n)), rtol=1e-3, atol=1e-3)
        print("fused matmul+allreduce (compute overlaps the ring DMA): ok")
        got["matmul_allreduce"] = y

    # -- 4. duplex + torus schedules ------------------------------------
    if n >= 4 and n % 2 == 0:
        from ompi_tpu_torch.ops import ring_collectives as rc

        g = rng.standard_normal((n, 256)).astype(np.float32)
        gd = torch.from_numpy(g).to(device)
        y = rc.all_gather(gd, n, variant="bidi").cpu().numpy()
        np.testing.assert_allclose(y, g, rtol=1e-6)
        print("bidirectional all-gather (duplex ICI, ceil((n-1)/2) "
              "steps): ok")
        x2 = rng.standard_normal((n, n, 128)).astype(np.float32)
        r = rc.reduce_scatter_torus(torch.from_numpy(x2).to(device), 2,
                                    n // 2).cpu().numpy()
        np.testing.assert_allclose(r, x2.sum(0), rtol=1e-4, atol=1e-5)
        a2 = rc.all_gather_torus(gd, 2, n // 2).cpu().numpy()
        np.testing.assert_allclose(a2, g, rtol=1e-6)
        print("2D-torus reduce-scatter + all-gather (per-dimension "
              "sub-rings): ok")
        got["all_gather_bidi"], got["reduce_scatter_torus"] = y, r
        got["all_gather_torus"] = a2

    ompi_tpu_torch.finalize()
    print("DEVICE COLLECTIVES OK")
    return got


if __name__ == "__main__":
    main()
