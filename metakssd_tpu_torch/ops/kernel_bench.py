"""Chained-dispatch throughput of the compact sketch kernel K1: the port of
``metakssd_tpu/ops/kernel_bench.py``.

``kernel_chain_mwin`` queues ``k_reps`` K1 launches back to back, each on
a code stream of its own that lies on the device before the clock starts,
then reduces each launch's drtuples to one int32 sum on the device (all
``k_reps`` in one batched reduction, so that the host queues nothing
between two launches but the next launch) and drains the sums with one
readback; it reports the best of ``reps`` such passes in millions of
windows a second.  Each launch goes through
``ops/sketch_cuda.window_compact``, as the chunk loop's do, but nothing in
the timed region waits for the card except the one readback, and no
chunk is copied to the card inside it (the chunk loop, ``sketch_windows``,
uploads each chunk from pinned memory on a copy stream and reads each
chunk's count back once two more chunks a card are queued).

The input is the JAX module's: the L3K11 shuffle of seed 1234 by default,
and ``nwin + TL - 1`` 2-bit codes from ``default_rng(0)``.  Dispatch ``i``
reads those codes rotated left by ``i`` bases, each code plus ``i`` mod 4:
the JAX module XORs its packed tiles with ``i``, which would make bases
invalid here, while this keeps every code in 0..3 and gives every
dispatch a buffer of its own with other k-mers.  On ``device="cpu"`` the
launches are K1's plain version (the tests, at a small ``nwin``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from metakssd_tpu_torch.device import resolve_device
from metakssd_tpu_torch.ops import sketch_cuda
from metakssd_tpu_torch.state import accept_tables


def default_shuf():
    """The JAX module's default: L3K11 (k=11, subk=6, drlevel=3), seed 1234."""
    from metakssd_tpu_torch.formats.shuf import make_shuf
    from metakssd_tpu_torch.params import SketchParams
    return make_shuf(SketchParams(k=11, subk=6, drlevel=3), seed=1234)


def chain_codes(nwin: int, TL: int, k_reps: int) -> list[np.ndarray]:
    """The ``k_reps`` code streams of a pass (uint8, ``nwin + TL - 1``
    codes each): the JAX module's codes, stream ``i`` rotated left by
    ``i`` with ``i`` added to each code mod 4."""
    base = np.random.default_rng(0).integers(
        0, 4, size=nwin + TL - 1).astype(np.uint8)
    return [(np.roll(base, -i) + i) & 3 for i in range(k_reps)]


class Chain:
    """A pass's inputs on the device: the accept tables, the code streams,
    K1's capacity and the slot indices that mask its unfilled slots."""

    def __init__(self, shuf, nwin: int, k_reps: int, device):
        dev = resolve_device(device)
        self.p = shuf.params
        self.tables = accept_tables(shuf, dev)
        self.codes = [torch.from_numpy(c).to(dev)
                      for c in chain_codes(nwin, self.p.kmer_len, k_reps)]
        self.cap = sketch_cuda.default_capacity(nwin, self.tables)
        self.slot = torch.arange(self.cap, device=dev)

    def launch(self) -> torch.Tensor:
        """Queues a pass: the K1 launches, then the reduction.  Returns
        int64 [k_reps, 2] on the device: each dispatch's drtuple sum and
        kept count."""
        drs, counts = [], []
        for c in self.codes:
            dr, _, count = sketch_cuda.window_compact(c, self.tables, self.p,
                                                      self.cap)
            drs.append(dr)
            counts.append(count)
        counts = torch.cat(counts)
        kept = self.slot[None, :] < counts[:, None]
        sums = torch.where(kept, torch.stack(drs).to(torch.int64), 0).sum(1)
        return torch.stack([sums, counts], 1)

    def run(self) -> np.ndarray:
        """One pass, ended by its one readback.  Returns each dispatch's
        drtuple sum as int32 (wrapping, as the JAX ``fn``'s)."""
        got = self.launch().cpu().numpy()
        if (got[:, 1] > self.cap).any():
            raise RuntimeError(f"K1 kept more than its {self.cap} slots: "
                               "a sum would miss drtuples")
        return (got[:, 0] & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def chain_sums(shuf=None, nwin: int = 1 << 24, k_reps: int = 16, *,
               device="cuda") -> np.ndarray:
    """The int32 drtuple sum of each of a pass's ``k_reps`` dispatches."""
    return Chain(shuf or default_shuf(), nwin, k_reps, device).run()


def kernel_chain_mwin(shuf=None, nwin: int = 1 << 24, k_reps: int = 16,
                      reps: int = 3, *, device="cuda") -> float:
    """Mwin/s of the compact sketch kernel K1 on ``device``: ``nwin``
    windows a dispatch, ``k_reps`` dispatches a pass, the best of ``reps``
    passes after one untimed pass (the library's load, the first launch)."""
    chain = Chain(shuf or default_shuf(), nwin, k_reps, device)
    chain.run()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        chain.run()                     # ends in the pass's one readback
        best = min(best, time.perf_counter() - t0)
    return nwin * k_reps / best / 1e6
