"""MoE/EP ragged dispatch with the true alltoallv — the workload the
counts-driven ragged kernel exists for.

The counterpart of the JAX package's ``examples/ragged_dispatch.py``.
Every routing step of a mixture-of-experts layer sends a DIFFERENT number
of tokens between each pair of ranks.  A padded ``all_to_all`` must move
the worst-case count for every pair; the ragged kernel
(``ops.ring_collectives.all_to_all_v``, K15) takes the (n, n) counts table
as a runtime operand and moves only real tokens — and because the counts
are data, one built kernel serves every routing outcome.

    python -m ompi_tpu_torch.examples.ragged_dispatch [--device cpu]

The n ranks are the ``otpu_rte_virtual_ranks`` virtual ranks (default 8),
rows of one tensor on ``--device`` (default: the card, where the dispatch
and the combine are one K15 launch each).
"""
import argparse

import numpy as np
import torch

from ompi_tpu_torch.base import cudaenv
from ompi_tpu_torch.ops import ring_collectives as rc


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device of the token slab (default: the card)")
    args = ap.parse_args(argv)
    device = cudaenv.resolve_device(args.device)
    n = cudaenv.virtual_ranks()
    d_model = 256                 # token feature width (128-lane aligned)
    cap = 64                      # worst-case tokens per (src, dst) pair

    rng = np.random.default_rng(0)
    # a routing step: rank i holds cap-padded token blocks for each
    # expert home j, with counts[i, j] real tokens
    counts = rng.integers(4, cap + 1, (n, n)).astype(np.int32)
    tokens = rng.standard_normal((n, n, cap, d_model)).astype(np.float32)

    out = rc.all_to_all_v(torch.from_numpy(tokens).to(device), counts, n)
    got = out.cpu().numpy()
    # rank j now holds out[j, i, :counts[i, j]] = rank i's tokens for it
    for j in range(n):
        for i in range(n):
            c = counts[i, j]
            np.testing.assert_array_equal(got[j, i, :c], tokens[i, j, :c])

    ideal = counts.sum() * d_model * 4
    chunk = 8
    ragged = (-(-counts // chunk) * chunk).sum() * d_model * 4
    padded = n * n * cap * d_model * 4
    print(f"dispatch verified on {n} ranks: ideal {ideal >> 10} KiB, "
          f"ragged wire {ragged >> 10} KiB "
          f"({ragged / ideal:.2f}x ideal), padded all_to_all would "
          f"move {padded >> 10} KiB ({padded / ideal:.2f}x)")

    # the inverse (combine) is the same kernel with transposed counts
    back = rc.all_to_all_v(out, counts.T, n).cpu().numpy()
    for i in range(n):
        for j in range(n):
            c = counts[i, j]
            np.testing.assert_array_equal(back[i, j, :c], tokens[i, j, :c])
    print("combine (inverse dispatch) verified: counts.T round-trips")
    return {"counts": counts, "tokens": tokens, "dispatched": got,
            "combined": back}


if __name__ == "__main__":
    main()
