"""The chunk loop's dealing of chunks over devices and its FIFO queue
(``metakssd_tpu_torch.ops.sketch_cuda.sketch_windows``, ``devices``)
against the JAX chunk loop's round-robin
(``metakssd_tpu.ops.sketch_pallas.sketch_codes_pallas``, ``devices``) and
golden, exactly, on the CPU: the port's counterpart of
tests/test_sketch_pallas.py::test_pallas_multidevice_round_robin.

One L3K11 stream from a numpy seed spans 6 chunks of the port's loop (3
of the JAX loop's), and a poly-A block overflows chunk 3's capacity
in the middle of the queue, so the K2 rerun takes a chunk that is no
longer the newest one queued.  The loop's order (at most DEPTH chunks a
device in flight, none resolved before the next is queued) is held by
``probes/chunk_split.check_order``.  The same checks on a card, with the
pinned buffers, are in tests/test_torch_sketch_cuda.py.
"""

import functools

import jax
import numpy as np
import pytest

from metakssd_tpu.ops import golden, sketch_pallas
from metakssd_tpu_torch.ops import sketch_cuda
from metakssd_tpu_torch.params import SketchParams
from metakssd_tpu_torch.probes.chunk_split import check_order, record_order
from metakssd_tpu_torch.state import accept_tables

from sketch_cases import assert_pairs_equal, pairs, random_codes, \
    zero_accepted

P = SketchParams(k=11, subk=6, drlevel=3)
BW = sketch_pallas.RWIN * sketch_pallas.LANES
N = 21 * BW + 1000              # the JAX loop's plan: 3 chunks
CHUNK = 1 << 17                 # the port's loop: 6 chunks
NCHUNKS = 6
CAP = 1024                      # a random chunk keeps about 32 windows
POLY_A = slice(3 * CHUNK + 100, 3 * CHUNK + 5100)   # all kept, in chunk 3

# (port devices, JAX devices as a slice of jax.local_devices() or as
# given, devices the port deals to)
DEVICES = {"two": (["cpu", "cpu"], slice(0, 2), 2),
           "one": (["cpu"], slice(0, 1), 1),
           "empty": ([], [], 1),
           "auto": (None, None, 1)}


@functools.lru_cache(maxsize=1)
def _case():
    shuf = zero_accepted(P, seed=11)
    codes = random_codes(seed=11, n=N, n_invalid=200)
    codes[POLY_A] = 0
    assert -(-(N - P.kmer_len + 1) // CHUNK) == NCHUNKS
    gdr, gpos = golden.window_drtuples(codes, shuf, return_positions=True)
    return shuf, codes, gdr.astype(np.uint32), gpos


@pytest.mark.parametrize("case", list(DEVICES))
def test_round_robin_matches_jax_and_golden(case, monkeypatch):
    """Drtuples as sorted multisets and (drtuple, position) pairs equal
    the JAX loop's on the matching devices and golden's; K2 reruns
    the overflowing chunk alone; the queue keeps its order."""
    devices, jax_sel, ndev = DEVICES[case]
    jdevs = jax.local_devices()[jax_sel] if isinstance(jax_sel, slice) \
        else jax_sel
    shuf, codes, gdr, gpos = _case()
    tabs = accept_tables(shuf, "cpu")
    reruns = []
    full = sketch_cuda.window_full_plain
    monkeypatch.setattr(sketch_cuda, "window_full_plain",
                        lambda *a: reruns.append(1) or full(*a))
    with record_order() as log:
        dr, pos = sketch_cuda.sketch_windows(
            codes, P, tabs, want_pos=True, chunk_windows=CHUNK,
            capacity=CAP, devices=devices)
    check_order(log, NCHUNKS, ndev)
    assert len(reruns) == 1
    assert gdr.size > 2 * CAP
    assert_pairs_equal(pairs(dr, pos), pairs(gdr, gpos))
    pdr, ppos = sketch_pallas.sketch_codes_pallas(
        codes, shuf, interpret=True, with_positions=True, devices=jdevs)
    assert_pairs_equal(pairs(dr, pos), pairs(pdr, ppos))

    keys, none = sketch_cuda.sketch_windows(
        codes, P, tabs, chunk_windows=CHUNK, capacity=CAP, devices=devices)
    assert none is None
    keys.sort()
    np.testing.assert_array_equal(keys, np.sort(gdr))
    jkeys, count = sketch_pallas.sketch_codes_pallas(
        codes, shuf, interpret=True, devices=jdevs)
    assert count == keys.size
    np.testing.assert_array_equal(keys, jkeys)


@pytest.mark.parametrize("devices", [["cuda:0", "cpu"], ["cpu", "cuda"],
                                     ["cpu", "meta"], ["meta"]])
def test_devices_of_another_kind_raise(devices):
    """A list that mixes CUDA and the CPU, or names a device with no
    sketch kernel, raises before anything runs (no card needed)."""
    shuf, codes, _, _ = _case()
    with pytest.raises(ValueError):
        sketch_cuda.sketch_windows(codes, P, accept_tables(shuf, "cpu"),
                                   chunk_windows=CHUNK, devices=devices)


@pytest.mark.parametrize("log,ndev", [
    (["queue", "resolve"] * NCHUNKS, 1),                 # the serial loop
    (["queue"] * NCHUNKS + ["resolve"] * NCHUNKS, 1),    # 4 in flight
    (["queue"] * NCHUNKS + ["resolve"] * 5, 4)])         # one left unread
def test_check_order_rejects_a_serial_loop(log, ndev):
    """The order check fails a loop that reads a chunk's count before
    the next chunk is queued, keeps more than DEPTH chunks a device in
    flight, or leaves a chunk unresolved."""
    with pytest.raises(AssertionError):
        check_order(log, NCHUNKS, ndev)
