"""What the probe modules share: the variant record, the inputs' byte
and operation counts, and the TPU probes' timing method on the card.

The method (``benchmarks/probe_kernel_cost.py:55-68``): K dispatches, each
on its own XOR-varied copy of the input, then one readback; the best of
``reps`` runs, per dispatch.  Here CUDA events bracket the K dispatches
(each a wrapper call: the kernel, after the zeroing of its output where
``ops/probe.REDUCE`` has it add atomically), and the readback follows.  When the host enqueues slower than the card runs,
that time is the host's; ``graph_ms`` replays the same K dispatches from
a CUDA graph, so its time is the card's alone.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from metakssd_tpu_torch.device import resolve_device
from metakssd_tpu_torch.ops import _build
from metakssd_tpu_torch.ops.probe import LANES

K = 16                  # dispatches per timed run
NWIN = 1 << 24          # windows per dispatch
REPS = 3                # timed runs; the best counts


@dataclasses.dataclass
class Variant:
    """One line of a TPU probe file and its counterpart here."""
    name: str                     # the TPU file's label
    replaces: str                 # file:line of the TPU kernel
    kernel: str                   # key of _build.LAUNCHES
    tiles: torch.Tensor           # the input (K XOR-varied copies are timed)
    run: Callable                 # input -> result, through the wrapper
    plain: Callable | None        # input -> result, the plain version
    nbytes: int                   # bytes the function must move
    ops: int                      # 32-bit operations it does
    nwin: int                     # windows of one dispatch
    library: Callable | None = None   # one PyTorch call of the same function
    tables: dict = dataclasses.field(default_factory=dict)  # other inputs


def out_bytes(nb: int) -> int:
    """The [nb, 1, 128] int32 result."""
    return nb * LANES * 4


# 32-bit operations per window of the probe kernels (csrc/probe.cu),
# counted on the cheapest formulation they use (64-bit rolling tuples): the
# new base's and, compare and select; the forward tuple's shift, or and
# mask and the reverse complement's shift, xor, shift and or, on 32-bit
# halves; the 64-bit min; the result's xor, or and add.
WINDOW_OPS = 22
SEARCH_OPS = 13         # dim and base extraction, the hit test, the add
STEP_OPS = 4            # one search step: load, compare, select, index


def search_ops(steps: int, extra: int = 0) -> int:
    """32-bit operations per window of the window math and a search of
    ``steps`` dependent steps, plus ``extra``.  The exact search's bound
    counts one step (``search_ops(1)``): a bucket index of the table takes
    a window to its lower bound in about one step, so a binary search of
    the whole table (12 steps for 4096 keys) is not the function's least
    work.  The signature search keeps its 7 steps: it computes another
    function (a 16-bit signature hit at a 7-level bucket)."""
    return WINDOW_OPS + SEARCH_OPS + STEP_OPS * steps + extra


# K1 and K2 (csrc/sketch.cu) per window, on packed codes: two funnel
# shifts each for the forward and the reverse-complement tuple, the
# forward tuple's 64-bit cut (2) and the other's mask (2), the 64-bit min
# (4), dim's shift and mask (2), the fold's multiply and shift, the word's
# index, load, shift and mask and the queue mask's shift and or (8); the
# packing of a thread's 48 codes, shared by its 16 windows, is left out.
SCAN_OPS = 24


def filter_ops(nwin: int, kept: int, steps: int) -> int:
    """32-bit operations that K1's or K2's function needs on ``nwin``
    windows of which ``kept`` are kept: the scan per window, and per kept
    window one exact search of ``steps`` steps and the drtuple.  What the
    kernels spend on filter candidates that the search rejects (a cost of
    the folded bitmap, not of the function), and on rebuilding a
    candidate's tuple, is left out of the bound."""
    return nwin * SCAN_OPS + kept * (SEARCH_OPS + STEP_OPS * steps)


def vary(t: torch.Tensor, k: int = K) -> list[torch.Tensor]:
    """k copies of t, copy i XORed with i (uint16 through its int16 bits).
    A uint8 code stream is rolled by i bases instead: XOR would make its
    codes invalid (>= 4), while XOR keeps a tile's ``c & 3`` varied."""
    if t.dtype == torch.uint8:
        return [torch.roll(t, i) for i in range(k)]
    if t.dtype == torch.uint16:
        s = t.view(torch.int16)
        return [(s ^ i).view(torch.uint16) for i in range(k)]
    return [t ^ i for i in range(k)]


def time_variant(v: Variant, k: int = K, reps: int = REPS) -> float:
    """Best ms per dispatch of v.run over k XOR-varied inputs (CUDA
    events; one warm-up dispatch first, one readback per run)."""
    inputs = vary(v.tiles, k)
    torch.cuda.synchronize()
    v.run(inputs[0])
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        outs = [v.run(t) for t in inputs]
        e1.record()
        torch.stack([o.reshape(-1)[0] for o in outs]).sum().item()
        best = min(best, e0.elapsed_time(e1))
    del inputs
    return best / k


def graph_ms(fn: Callable, inputs: list[torch.Tensor],
             reps: int = REPS) -> float:
    """ms per dispatch of fn over the inputs, replayed ``reps`` times from
    a CUDA graph (one warm-up call first): the card's time without the
    host's.  Wrapper calls made while capturing count as launches."""
    fn(inputs[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(t) for t in inputs]
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del outs, graph
    return e0.elapsed_time(e1) / (reps * len(inputs))


def run_all(title: str, variants: list[Variant], k: int = K,
            reps: int = REPS) -> list[dict]:
    """Time every variant on the card, print the TPU file's lines, and
    return one record per variant with its launches in this run."""
    print(f"{title} (K={k}, best of {reps}; {torch.cuda.get_device_name(0)})",
          flush=True)
    records = []
    for v in variants:
        before = _build.LAUNCHES[v.kernel]
        ms = time_variant(v, k, reps)
        mwin = v.nwin / ms / 1e3
        print(f"{v.name:34s} {ms:9.4f} ms/dispatch ({mwin:8.0f} Mwin/s)",
              flush=True)
        records.append({"name": v.name, "replaces": v.replaces,
                        "kernel": v.kernel, "ms": ms, "mwin_s": mwin,
                        "launches": _build.LAUNCHES[v.kernel] - before,
                        "variant": v})
    return records


def cuda_device() -> torch.device:
    """The card the probes run on; raises where there is none."""
    return resolve_device("cuda")
