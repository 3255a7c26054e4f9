"""Chaos's off-path cost: the host time of one ``send`` of btl/tcp and of
btl/sm with chaos unset (the card's machine, about 3 minutes).

The ping-pong of ``chip_smoke.py`` moves by 100 µs and more from run to
run, which hides a hook that costs well under 1 µs.  This times the hook's
own layer instead: each lane's ``send`` of an 8 B eager frame, 100 calls a
batch and 2000 batches, in a fresh process against a connected socket pair
(tcp) or a ring in a shared segment (sm) that the process drains between
batches, off the clock.  The figure is the median batch's µs a call.

With ``--parent DIR`` (a checkout of another commit, such as one unpacked
by ``git archive``) the two trees run in turns, parent, this tree, this
tree, parent, for ``ROUNDS`` rounds, so that the two are compared within
one call.  Prints one ``chaos_offpath`` line with the card's name and
power limit, each run's figures, and each lane's median over the runs of
each tree.

    python3 chip_chaos_offpath.py [--parent DIR]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROUNDS = 3
CHILD = r"""
import json, socket, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
from multiprocessing import shared_memory
from ompi_tpu_torch.mca.btl import sm, tcp
from ompi_tpu_torch.mca.btl.base import MATCH, Endpoint, Frag

CALLS, BATCHES = 100, 2000
payload = np.arange(8, dtype=np.uint8)
frags = [Frag(0, 0, 1, 5, i, MATCH, payload, total_len=8)
         for i in range(CALLS)]


def per_call_us(send, drain):
    times = []
    for _ in range(BATCHES):
        t0 = time.perf_counter_ns()
        for f in frags:
            send(f)
        times.append((time.perf_counter_ns() - t0) / CALLS / 1e3)
        drain()
    return statistics.median(times)


out = {"tree": sys.argv[1]}
a, b = socket.socketpair()
conn = tcp._Conn(a)
conn.rank = 1
btl = tcp.TcpBtl()
btl._by_rank[1] = [conn]
ep = Endpoint(btl, 1)
a.setblocking(False)
b.setblocking(False)


def drain_tcp():
    while True:
        try:
            if not b.recv(1 << 20):
                return
        except BlockingIOError:
            return


out["tcp_send_us"] = per_call_us(lambda f: btl.send(ep, f), drain_tcp)
a.close()
b.close()

seg = shared_memory.SharedMemory(create=True, size=8 << 20)
ring = sm._Ring(seg, owner=True)
sbtl = sm.SmBtl()
sbtl._rings_out[1] = ring
sep = Endpoint(sbtl, 1)


def drain_sm():
    while ring.pop_frame() is not None:
        pass


out["sm_send_us"] = per_call_us(lambda f: sbtl.send(sep, f), drain_sm)
seg.unlink()
print(json.dumps(out), flush=True)
"""


def run(tree: Path) -> dict:
    r = subprocess.run([sys.executable, "-c", CHILD, str(tree)],
                       capture_output=True, text=True, timeout=300,
                       check=True)
    return json.loads(r.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_chaos_offpath: no CUDA device is available",
              file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    order = [here] if args.parent is None else \
        [args.parent.resolve(), here, here, args.parent.resolve()]
    runs = [run(tree) for _ in range(ROUNDS) for tree in order]
    medians = {}
    for name, tree in (("change", here), ("parent", args.parent)):
        mine = [x for x in runs if tree is not None
                and x["tree"] == str(tree.resolve())]
        if mine:
            medians[name] = {
                lane: statistics.median(x[lane] for x in mine)
                for lane in ("tcp_send_us", "sm_send_us")}
    print(json.dumps({"chaos_offpath": {"card": smi, "runs": runs,
                                        "medians": medians}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
