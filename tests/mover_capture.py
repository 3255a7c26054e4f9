"""The byte mover under CUDA graph capture, on the card: the two cases that
``tests/test_torch_mover.py`` (``cuda``) and ``chip_smoke.py`` run, the
tests with more launches.  It imports torch and ``ompi_tpu_torch`` only.

A launch of the mover (K10, K11, K13-K16) takes its span tickets from a
counter pair.  An eager launch draws a slot of its library's round-robin
pool of ``TICKET_SLOTS`` pairs; a launch that a graph captures runs on a
pair that the graph owns.  Were a captured launch to draw a slot, two
launches would share a pair: (1) a replay and the eager launch that draws
the same slot a pool later; (2) two graphs captured a pool's length of
launches apart, replayed at once.  Each case queues the two launches behind
one gate (``_gate``), so that they start together once both are queued,
and their checks after them, on inputs small enough
that both grids are resident at once (64 CTAs of one SM each and fewer,
against the H100's 132 SMs), and counts the wrong elements of every result.
Every input is bumped before each launch, so that a copy that was skipped
leaves the previous values and shows.
"""
import torch

from ompi_tpu_torch.ops import _build
from ompi_tpu_torch.ops import ring_collectives as rc

#: counter slots of one library's round-robin pool (csrc/pair_copy.cuh)
TICKET_SLOTS = 1024
N = 8
#: the library of each kernel's entry
LIBRARY = {"all_gather": "ring_copy", "all_gather_bidi": "ring_copy",
           "all_to_all_v": "exchange"}
#: ~200 µs of the gate's spin at the H100's 1.98 GHz: several times what
#: the host takes to queue the launches of one round behind it
GATE_CYCLES = 400_000


def dealt(kernel: str) -> int:
    """Slots of ``kernel``'s library's pool dealt so far (mod 2^31)."""
    lib = LIBRARY[kernel]
    return getattr(_build.load(lib), f"otpu_{lib}_tickets_dealt")()


def case(kernel: str, small: bool, gen: torch.Generator):
    """(call, bump, check) for K10 (``all_gather``), K11
    (``all_gather_bidi``) or K15 (``all_to_all_v``, its counts table on the
    card) on int32: 1 MB in all (64 CTAs), or ``small``, 32 KB (K10, K11)
    or 128 KB (K15).  ``bump()`` adds 1 to the input in place;
    ``check(out)`` is the number of wrong elements (K15: over the valid
    rows) as a device scalar, so that no check waits for the card."""
    def ints(shape):
        return torch.randint(-2**30, 2**30, shape, dtype=torch.int32,
                             device="cuda", generator=gen)

    if kernel == "all_to_all_v":
        x = ints((N, N, 4, 128 if small else 1024))
        counts = torch.randint(0, 5, (N, N), dtype=torch.int32, device="cuda",
                               generator=gen)
        valid = (torch.arange(4, device="cuda")[None, None, :]
                 < counts.T[:, :, None])[..., None]
        return ((lambda: rc.all_to_all_v(x, counts, N)), (lambda: x.add_(1)),
                (lambda out: ((out != x.transpose(0, 1)) & valid).sum()))
    x = ints((N, 1024 if small else 32768))
    variant = "bidi" if kernel == "all_gather_bidi" else "ring"
    return ((lambda: rc.all_gather(x, N, variant)), (lambda: x.add_(1)),
            (lambda out: (out != x).sum()))


def capture(call, warm: bool = True):
    """``call`` captured into a new graph: (graph, its output).  The warm-up
    call builds and loads the library first."""
    if warm:
        call()
        torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    return graph, out


def _streams(k: int) -> list:
    main = torch.cuda.current_stream()
    streams = [torch.cuda.Stream() for _ in range(k)]
    for s in streams:
        s.wait_stream(main)
    return streams


def _gate(streams, gate) -> None:
    """Hold ``streams`` behind one event that stream ``gate`` records after
    their queued work and GATE_CYCLES of spinning: what is queued on them
    next starts together."""
    for s in streams:
        gate.wait_stream(s)
    with torch.cuda.stream(gate):
        torch.cuda._sleep(GATE_CYCLES)
        event = torch.cuda.Event()
        event.record()
    for s in streams:
        s.wait_event(event)


def beside_eager(kernel: str, rounds: int, gen) -> tuple:
    """One launch captured and replayed on stream A, ``rounds`` times, each
    replay gated with one eager launch of the same library on stream B:
    (wrong elements of the replays, of the eager results, slots the
    capture drew).  More rounds than TICKET_SLOTS reach any slot that the
    capture could hold."""
    call, bump, check = case(kernel, False, gen)
    small, small_bump, small_check = case(kernel, True, gen)
    call()
    small()
    torch.cuda.synchronize()
    before = dealt(kernel)
    graph, out = capture(call, warm=False)
    drew = dealt(kernel) - before
    a, b, gate = _streams(3)
    bad = torch.zeros(2, dtype=torch.int64, device="cuda")
    for _ in range(rounds):
        with torch.cuda.stream(a):
            bump()
        with torch.cuda.stream(b):
            small_bump()
        _gate((a, b), gate)
        with torch.cuda.stream(a):
            graph.replay()
        with torch.cuda.stream(b):
            eager = small()
        with torch.cuda.stream(a):
            bad[0] += check(out)
        with torch.cuda.stream(b):
            bad[1] += small_check(eager)
    torch.cuda.synchronize()
    return int(bad[0]), int(bad[1]), drew


def two_apart(kernel: str, rounds: int, gen) -> tuple:
    """Two graphs whose captured launches are TICKET_SLOTS - 1 eager
    launches apart, replayed ``rounds`` times, each pair of replays gated
    to start together on two streams: the wrong elements of each graph's
    results."""
    cases = [case(kernel, False, gen) for _ in range(2)]
    small = case(kernel, True, gen)[0]
    first, out_first = capture(cases[0][0])
    for _ in range(TICKET_SLOTS - 1):
        small()
    second, out_second = capture(cases[1][0], warm=False)
    streams, gate = _streams(2), _streams(1)[0]
    bad = torch.zeros(2, dtype=torch.int64, device="cuda")
    for _ in range(rounds):
        for s, (_, bump, _) in zip(streams, cases):
            with torch.cuda.stream(s):
                bump()
        _gate(streams, gate)
        for s, graph in zip(streams, (first, second)):
            with torch.cuda.stream(s):
                graph.replay()
        for i, (s, out) in enumerate(zip(streams, (out_first, out_second))):
            with torch.cuda.stream(s):
                bad[i] += cases[i][2](out)
    torch.cuda.synchronize()
    return int(bad[0]), int(bad[1])
