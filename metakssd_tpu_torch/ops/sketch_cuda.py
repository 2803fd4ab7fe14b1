"""The window-sketch kernels K1/K2: wrappers, plain versions and the chunk
loop (their launches are counted in ``ops/_build.LAUNCHES``).

K1 ``window_compact`` (``csrc/sketch.cu`` ``mkssd_sketch_compact``)
replaces ``metakssd_tpu/ops/sketch_pallas.py:_compact_kernel``; K2
``window_full`` (``mkssd_sketch_full``) replaces ``sketch_pallas._kernel``.
Each wrapper runs its plain PyTorch version when the codes tensor lies on
the CPU, launches its kernel when it lies on a CUDA device, and raises on
anything else; there is no fallback from a failed launch.

The kernels test one bit of ``tables.filter`` per window and search the
accept table exactly only where it is set (``ops/sketch_filter.py``).
``window_filtered_plain`` is that formulation in plain torch, beside the
plain versions, which search every window; the tests hold the two equal.

Tensor contract (both versions):

* ``codes``: uint8 [n], 0..3 = ACGT, >= 4 = invalid; the window count is
  n - 2k + 1 (>= 1, < 2^31);
* uint32 values (drtuples, the 0xFFFFFFFF drop mark) travel in int32
  tensors with the same bits (torch's uint32 lacks shifts and sorts), so
  read them on the host as ``.numpy().view(np.uint32)``;
* K1 -> (dr int32 [capacity], pos int32 [capacity] or None, count int64
  [1]): the first min(count, capacity) entries are the kept windows'
  drtuples and chunk-relative window indices, in no particular order;
  count keeps counting past capacity;
* K2 -> (dr int32 [nwin], keep int32 [nwin]).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import warnings

import numpy as np
import torch

from metakssd_tpu_torch.ops import _build, sketch_filter
from metakssd_tpu_torch.state import AcceptTables

CHUNK_WINDOWS = 1 << 26        # windows per device dispatch (64M)
DEPTH = 2                      # chunks queued per device before resolving
DROPPED = 0xFFFFFFFF

# Pinned host allocations of the chunk loop: ``upload``, a card's two code
# buffers in a call (each made when the card's first or second chunk needs
# it, then reused), and ``count``, the count slots of a call.  No chunk
# allocates one.  chip_smoke.py and the tests hold the loop to this.
PINNED_ALLOCS = {"upload": 0, "count": 0}


def _nwin(codes: torch.Tensor, p) -> int:
    nwin = codes.numel() - p.kmer_len + 1
    if nwin < 1 or nwin >= 1 << 31:
        raise ValueError(f"{codes.numel()} codes give {nwin} windows; "
                         "a chunk needs 1 <= windows < 2^31")
    return nwin


def _as_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same low bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _window_tuples(codes: torch.Tensor, p):
    """(canonical tuple int64 [nwin], inner substring dim int64 [nwin],
    all-bases-valid bool [nwin]) for every window, in int64: k <= 15 on
    the device path, so a 4k-bit tuple fits.  An invalid code counts as
    its low two bits, as in the kernels' scan; its windows are not valid,
    so no output depends on that."""
    TL = p.kmer_len
    nwin = codes.numel() - TL + 1
    c = codes.to(torch.int64)
    bad = c > 3
    c = c & 3
    fwd = torch.zeros(nwin, dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    for j in range(TL):
        seg = c[j:j + nwin]
        fwd |= seg << (2 * (TL - 1 - j))
        rc |= (seg ^ 3) << (2 * j)
    nbad = torch.zeros(codes.numel() + 1, dtype=torch.int64,
                       device=codes.device)
    nbad[1:] = torch.cumsum(bad.to(torch.int64), 0)
    ok = nbad[TL:TL + nwin] == nbad[:nwin]
    uni = torch.minimum(fwd, rc)            # forward on a tie
    dim = (uni >> (2 * p.outctx)) & ((1 << (4 * p.subk)) - 1)
    return uni, dim, ok


def _search(uni: torch.Tensor, dim: torch.Tensor, tables: AcceptTables, p):
    """The exact search of each dim and the drtuple it gives:
    (drtuple int64, hit bool), elementwise over ``uni`` and ``dim``."""
    oc2 = 2 * p.outctx
    acc = tables.accept.to(torch.int64)
    pos = torch.searchsorted(acc, dim).clamp_(max=acc.numel() - 1)
    hit = acc[pos] == dim
    omask = (1 << oc2) - 1
    top = (uni >> (4 * p.k - oc2)) & omask
    right = uni & omask
    dr = (((top << oc2) | right) << (4 * (p.subk - p.drlevel))) \
        + tables.pfilter.to(torch.int64)[pos]
    return dr, hit


def _window_math(codes: torch.Tensor, tables: AcceptTables, p):
    """(drtuple int64 [nwin], keep bool [nwin]) for every window: the
    exact search runs on every window."""
    uni, dim, ok = _window_tuples(codes, p)
    dr, hit = _search(uni, dim, tables, p)
    return dr, ok & hit


def filter_candidates(codes: torch.Tensor, tables: AcceptTables, p):
    """Indices (int64, ascending) of the windows that K1 and K2 hand to
    their verify phase: the filter bit of the window's dim is set.
    Validity is checked there, so a window that holds an invalid code
    may be among them.  Returns (candidates, their tuples, their dims,
    whether each is valid)."""
    uni, dim, ok = _window_tuples(codes, p)
    passed = sketch_filter.bits_set(
        tables.filter, sketch_filter.filter_index(dim, tables.filter_log2,
                                                  p.subk))
    cand = torch.nonzero(passed).flatten()
    return cand, uni[cand], dim[cand], ok[cand]


def window_filtered_plain(codes: torch.Tensor, tables: AcceptTables, p):
    """K2's result by the kernels' formulation, in plain torch: one
    filter bit per window, then validity and the exact search on the
    candidates only.  Equal to ``window_full_plain`` on every input (the
    filter has no false negative); the tests hold the two together."""
    nwin = _nwin(codes, p)
    cand, uni, dim, ok = filter_candidates(codes, tables, p)
    dr, hit = _search(uni, dim, tables, p)
    hit &= ok
    out_dr = torch.full((nwin,), DROPPED, dtype=torch.int64,
                        device=codes.device)
    out_dr[cand[hit]] = dr[hit]
    keep = torch.zeros(nwin, dtype=torch.int32, device=codes.device)
    keep[cand[hit]] = 1
    return _as_u32_bits(out_dr), keep


def window_full_plain(codes: torch.Tensor, tables: AcceptTables, p):
    """Plain version of K2, same interface."""
    _nwin(codes, p)
    dr, keep = _window_math(codes, tables, p)
    return (_as_u32_bits(torch.where(keep, dr, DROPPED)),
            keep.to(torch.int32))


def window_compact_plain(codes: torch.Tensor, tables: AcceptTables, p,
                         capacity: int, want_pos: bool):
    """Plain version of K1, same interface (capacity and count
    included, so the chunk loop's overflow path runs on the CPU too)."""
    _nwin(codes, p)
    dr, keep = _window_math(codes, tables, p)
    idx = torch.nonzero(keep).flatten()
    m = min(idx.numel(), capacity)
    out_dr = torch.empty(capacity, dtype=torch.int32, device=codes.device)
    out_dr[:m] = _as_u32_bits(dr[idx[:m]])
    out_pos = None
    if want_pos:
        out_pos = torch.empty(capacity, dtype=torch.int32,
                              device=codes.device)
        out_pos[:m] = idx[:m].to(torch.int32)
    count = torch.full((1,), idx.numel(), dtype=torch.int64,
                       device=codes.device)
    return out_dr, out_pos, count


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(codes: torch.Tensor, tables: AcceptTables, p) -> None:
    if codes.dtype != torch.uint8 or not codes.is_contiguous():
        raise ValueError("codes must be a contiguous uint8 tensor")
    for t in (tables.accept, tables.pfilter, tables.filter):
        if t.device != codes.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError("accept tables must be contiguous int32 on "
                             "the codes' device")
    if tables.size < 1:
        raise ValueError("empty accept table")
    sketch_filter.check_log2(tables.filter_log2, p.subk)
    if tables.filter.numel() != sketch_filter.n_words(tables.filter_log2):
        raise ValueError(f"filter of {tables.filter.numel()} words for "
                         f"2^{tables.filter_log2} bits")


def window_compact(codes: torch.Tensor, tables: AcceptTables, p,
                   capacity: int, want_pos: bool = False):
    """K1: kept windows only (see the module docstring)."""
    if codes.device.type == "cpu":
        return window_compact_plain(codes, tables, p, capacity, want_pos)
    if codes.device.type != "cuda":
        raise ValueError(f"no sketch kernel for device {codes.device}")
    nwin = _nwin(codes, p)
    _check_cuda(codes, tables, p)
    lib = _build.library()
    out_dr = torch.empty(capacity, dtype=torch.int32, device=codes.device)
    out_pos = (torch.empty(capacity, dtype=torch.int32, device=codes.device)
               if want_pos else None)
    count = torch.zeros(1, dtype=torch.int64, device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    with _build.card_of(codes):
        err = lib.mkssd_sketch_compact(
            codes.data_ptr(), codes.numel(), nwin, tables.accept.data_ptr(),
            tables.pfilter.data_ptr(), tables.size, tables.filter.data_ptr(),
            tables.filter_log2, p.k, p.subk, p.drlevel,
            out_dr.data_ptr(), out_pos.data_ptr() if want_pos else None,
            count.data_ptr(), capacity, stream)
    _build.raise_on(err, "mkssd_sketch_compact")
    _build.LAUNCHES["sketch_compact"] += 1
    return out_dr, out_pos, count


def window_full(codes: torch.Tensor, tables: AcceptTables, p):
    """K2: every window's drtuple (0xFFFFFFFF where dropped) and keep."""
    if codes.device.type == "cpu":
        return window_full_plain(codes, tables, p)
    if codes.device.type != "cuda":
        raise ValueError(f"no sketch kernel for device {codes.device}")
    nwin = _nwin(codes, p)
    _check_cuda(codes, tables, p)
    lib = _build.library()
    out_dr = torch.empty(nwin, dtype=torch.int32, device=codes.device)
    out_keep = torch.empty(nwin, dtype=torch.int32, device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    with _build.card_of(codes):
        err = lib.mkssd_sketch_full(
            codes.data_ptr(), codes.numel(), nwin, tables.accept.data_ptr(),
            tables.pfilter.data_ptr(), tables.size, tables.filter.data_ptr(),
            tables.filter_log2, p.k, p.subk, p.drlevel,
            out_dr.data_ptr(), out_keep.data_ptr(), stream)
    _build.raise_on(err, "mkssd_sketch_full")
    _build.LAUNCHES["sketch_full"] += 1
    return out_dr, out_keep


# ---------------------------------------------------------------------------
# chunk loop
# ---------------------------------------------------------------------------

def default_capacity(nwin: int, tables: AcceptTables) -> int:
    """Survivor slots for a chunk: twice the expected count of random
    sequence plus a margin.  Low-complexity input (a poly-A read
    whose k-mer is accepted keeps every window) overflows it and takes
    the K2 rerun."""
    expected = nwin * tables.size // tables.shuf_len
    return min(nwin, 2 * expected + 65536)


def _chunk_devices(devices, home: torch.device,
                   nchunks: int) -> list[torch.device]:
    """The devices that chunks are dealt to, in turn
    (``sketch_pallas.py:696-716``): ``devices`` as given; the tables' own
    device for ``[]``; for None every visible card when there are several
    and the stream spans several chunks, else the tables' device.  One
    kind, CUDA or CPU, or it raises."""
    if devices is None and home.type == "cuda" and nchunks > 1 \
            and torch.cuda.device_count() > 1:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices] if devices else [home]
    kinds = {d.type for d in devs}
    if len(kinds) > 1:
        raise ValueError(f"devices mix {sorted(kinds)}: the chunk loop "
                         "deals chunks to devices of one kind")
    if not kinds <= {"cuda", "cpu"}:
        raise ValueError(f"no sketch kernel for device {devs[0]}")
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]


class _Lane:
    """One device's side of a ``sketch_windows`` call: its copy of the
    accept tables and, on a card, a copy stream, a readback stream, two
    pinned upload buffers (the lane's j-th chunk goes through buffer
    j % 2) and the event of each buffer's last H2D."""

    def __init__(self, dev: torch.device, tables: AcceptTables,
                 nbytes: int):
        self.dev = dev
        self.tables = tables if tables.accept.device == dev else \
            dataclasses.replace(tables, accept=tables.accept.to(dev),
                                pfilter=tables.pfilter.to(dev),
                                filter=tables.filter.to(dev))
        self.nbytes = nbytes
        self.bufs: list[torch.Tensor] = []
        self.h2d: list = [None, None]
        self.n = 0
        self.copy = self.readback = None
        if dev.type == "cuda":
            self.copy = torch.cuda.Stream(dev)
            self.readback = torch.cuda.Stream(dev)

    def on(self):
        """Makes the lane's card the current CUDA device: the kernels
        launch on the current device's stream."""
        return (torch.cuda.device(self.dev) if self.dev.type == "cuda"
                else contextlib.nullcontext())

    def stage(self, seg: np.ndarray) -> tuple[torch.Tensor, int]:
        """Host copy of a (possibly read-only, parser-owned) code slice,
        taken before this returns, and the buffer it went to: on a card
        the lane's next pinned buffer, once the H2D that last read it is
        done."""
        if self.dev.type == "cpu":
            host, b = torch.empty(seg.size, dtype=torch.uint8), 0
        else:
            b = self.n % 2
            self.n += 1
            if b == len(self.bufs):
                self.bufs.append(torch.empty(
                    self.nbytes, dtype=torch.uint8, pin_memory=True))
                PINNED_ALLOCS["upload"] += 1
            else:
                self.h2d[b].synchronize()
            host = self.bufs[b][:seg.size]
        with warnings.catch_warnings():
            # a parser's read-only buffer: torch only reads it
            warnings.simplefilter("ignore", UserWarning)
            src = torch.from_numpy(seg)
        host.copy_(src)     # on the host's threads, unlike a numpy copy
        return host, b

    def upload(self, host: torch.Tensor, b: int) -> torch.Tensor:
        """A staged slice on the lane's device.  On a card the H2D runs
        on the copy stream and the current stream waits for it before
        anything it queues next (K1)."""
        if self.dev.type == "cpu":
            return host
        with torch.cuda.stream(self.copy):
            c = torch.empty(host.numel(), dtype=torch.uint8, device=self.dev)
            c.copy_(host, non_blocking=True)
        ev = self.h2d[b] = torch.cuda.Event()
        ev.record(self.copy)
        compute = torch.cuda.current_stream(self.dev)
        compute.wait_event(ev)
        # the chunk stays on the card for a K2 rerun; its memory goes back
        # to the allocator only after the current stream's work on it
        c.record_stream(compute)
        return c


class _Chunk:
    """A queued chunk: its codes on the lane's device (kept for a K2
    rerun), K1's outputs and, on a card, K1's count on its way into a
    pinned slot and the event that says it has arrived."""

    def __init__(self, lane: _Lane, start: int, seg: np.ndarray, p,
                 cap: int, want_pos: bool, slot: torch.Tensor | None):
        self.lane, self.start, self.cap = lane, start, cap
        self.codes = lane.upload(*lane.stage(seg))
        self.dr, self.pos, count = window_compact(
            self.codes, lane.tables, p, cap, want_pos)
        self.count, self.done = count, None
        if lane.dev.type == "cuda":
            slot.copy_(count, non_blocking=True)
            self.count = slot
            self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(lane.dev))

    def kept(self) -> int:
        """K1's count; on a card it waits for this chunk's event alone,
        not for the chunks queued after it on the same stream."""
        if self.done is not None:
            self.done.synchronize()
        return int(self.count[0])

    def result(self, p, want_pos: bool, on_device: bool = False):
        """(drtuples uint32, stream positions int64 or None) of the
        chunk's kept windows: K1's, or K2's where K1 overflowed.  With
        ``on_device`` the drtuples stay on the chunk's device, an int32
        tensor (u32 bits) made on its current stream."""
        lane = self.lane
        n = self.kept()
        if n > self.cap:
            dr, keep = window_full(self.codes, lane.tables, p)
            pos = torch.nonzero(keep).flatten()
            dr = dr[pos]
            # K2's results are queued behind the current stream's work
            stream = None
        else:
            dr, pos = self.dr[:n], self.pos[:n] if want_pos else None
            # K1's are complete (its event): read them back past the
            # chunks queued after it
            stream = lane.readback
        if on_device:
            return dr, None
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            dr = dr.cpu().numpy().view(np.uint32)
            if want_pos:
                pos = pos.cpu().numpy().astype(np.int64) + self.start
        return dr, pos if want_pos else None


def sketch_windows(codes: np.ndarray, p, tables: AcceptTables,
                   want_pos: bool = False,
                   chunk_windows: int = CHUNK_WINDOWS,
                   capacity: int | None = None, devices=None,
                   on_device: bool = False):
    """All kept windows of a code stream -> (drtuples uint32, window
    positions int64 or None), unsorted, duplicates kept: the port of
    ``sketch_pallas.sketch_codes_pallas``'s chunk loop.

    The stream is cut into chunks of ``chunk_windows`` windows that
    overlap by TL-1 bases, so every window is evaluated exactly once.
    Chunk i goes to ``devices[i % len(devices)]`` (see
    ``_chunk_devices``; the tables are staged once per device) and runs
    K1; a chunk whose count exceeds its capacity reruns through K2 on
    its own device from its codes, still there.  Chunks are queued
    without a host sync, DEPTH per device: on a card, chunk i's host copy
    into a pinned buffer and its H2D (a copy stream) overlap the K1 of
    the chunks before it, and chunk i is resolved (its count read, its
    kept windows read back) in FIFO order once more than DEPTH x
    len(devices) chunks are queued, so never before chunk i+1's H2D and
    K1 are.  On the CPU the same loop runs K1/K2's plain versions
    synchronously.  Parts are joined in chunk order; chunk-relative int32
    positions become int64 stream positions on the host (a batched genome
    stream passes 2^31 bases).  With ``on_device`` (no positions) nothing
    is read back: the drtuples join as one int32 tensor (u32 bits) on the
    first chunk's device, made on its current stream, those of other
    cards by a peer copy."""
    if on_device and want_pos:
        raise ValueError("on_device leaves no positions")
    TL = p.kmer_len
    nwin_total = codes.size - TL + 1
    starts = range(0, max(nwin_total, 0), chunk_windows)
    devs = _chunk_devices(devices, tables.accept.device, len(starts))
    nbytes = min(chunk_windows + TL - 1, codes.size)
    lanes = {d: _Lane(d, tables, nbytes) for d in dict.fromkeys(devs)}
    slots = None
    if devs[0].type == "cuda" and len(starts):
        slots = torch.empty(len(starts), dtype=torch.int64, pin_memory=True)
        PINNED_ALLOCS["count"] += 1
    pending: collections.deque[_Chunk] = collections.deque()
    drs: list[np.ndarray] = []
    poss: list[np.ndarray] = []

    def resolve() -> None:
        chunk = pending.popleft()
        with chunk.lane.on():
            dr, pos = chunk.result(p, want_pos, on_device)
        drs.append(dr)
        if want_pos:
            poss.append(pos)

    for i, start in enumerate(starts):
        nw = min(chunk_windows, nwin_total - start)
        cap = default_capacity(nw, tables) if capacity is None else capacity
        lane = lanes[devs[i % len(devs)]]
        with lane.on():
            pending.append(_Chunk(
                lane, start, codes[start:start + nw + TL - 1], p, cap,
                want_pos, None if slots is None else slots[i:i + 1]))
        while len(pending) > DEPTH * len(devs):
            resolve()
    while pending:
        resolve()
    if on_device:
        return torch.cat([torch.zeros(0, dtype=torch.int32, device=devs[0])]
                         + [d.to(devs[0]) for d in drs]), None
    dr = np.concatenate(drs) if drs else np.zeros(0, np.uint32)
    if not want_pos:
        return dr, None
    return dr, (np.concatenate(poss) if poss else np.zeros(0, np.int64))
