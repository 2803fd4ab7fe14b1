"""The window-sketch kernels K1/K2: wrappers, plain versions, launch
counters and the chunk loop.

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

import numpy as np
import torch

from metakssd_tpu_torch.ops import sketch_filter
from metakssd_tpu_torch.state import AcceptTables

# Launches of each kernel of csrc/ (not of its plain version): K1, K2, K3
# (``member``) and its index build (``member_index``, both counted by
# ops/merge.py) and the probe kernels (``probe_*``, counted by
# ops/probe.py).  Reset with reset_launches(); chip_smoke.py reads them
# around each leg of the main path.
LAUNCHES = {"sketch_compact": 0, "sketch_full": 0, "member": 0,
            "member_index": 0, "probe_floor": 0, "probe_winmath": 0,
            "probe_gather": 0, "probe_search": 0}

CHUNK_WINDOWS = 1 << 26        # windows per device dispatch (64M)
DROPPED = 0xFFFFFFFF


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def window_compact(codes: torch.Tensor, tables: AcceptTables, p,
                   capacity: int, want_pos: bool = False):
    """K1: kept windows only (see the module docstring)."""
    if codes.device.type == "cpu":
        return window_compact_plain(codes, tables, p, capacity, want_pos)
    if codes.device.type != "cuda":
        raise ValueError(f"no sketch kernel for device {codes.device}")
    nwin = _nwin(codes, p)
    _check_cuda(codes, tables, p)
    from metakssd_tpu_torch.ops import _build
    lib = _build.library()
    out_dr = torch.empty(capacity, dtype=torch.int32, device=codes.device)
    out_pos = (torch.empty(capacity, dtype=torch.int32, device=codes.device)
               if want_pos else None)
    count = torch.zeros(1, dtype=torch.int64, device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = lib.mkssd_sketch_compact(
        codes.data_ptr(), codes.numel(), nwin, tables.accept.data_ptr(),
        tables.pfilter.data_ptr(), tables.size, tables.filter.data_ptr(),
        tables.filter_log2, p.k, p.subk, p.drlevel,
        out_dr.data_ptr(), out_pos.data_ptr() if want_pos else None,
        count.data_ptr(), capacity, stream)
    _raise_on(err, "mkssd_sketch_compact")
    LAUNCHES["sketch_compact"] += 1
    return out_dr, out_pos, count


def window_full(codes: torch.Tensor, tables: AcceptTables, p):
    """K2: every window's drtuple (0xFFFFFFFF where dropped) and keep."""
    if codes.device.type == "cpu":
        return window_full_plain(codes, tables, p)
    if codes.device.type != "cuda":
        raise ValueError(f"no sketch kernel for device {codes.device}")
    nwin = _nwin(codes, p)
    _check_cuda(codes, tables, p)
    from metakssd_tpu_torch.ops import _build
    lib = _build.library()
    out_dr = torch.empty(nwin, dtype=torch.int32, device=codes.device)
    out_keep = torch.empty(nwin, dtype=torch.int32, device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = lib.mkssd_sketch_full(
        codes.data_ptr(), codes.numel(), nwin, tables.accept.data_ptr(),
        tables.pfilter.data_ptr(), tables.size, tables.filter.data_ptr(),
        tables.filter_log2, p.k, p.subk, p.drlevel,
        out_dr.data_ptr(), out_keep.data_ptr(), stream)
    _raise_on(err, "mkssd_sketch_full")
    LAUNCHES["sketch_full"] += 1
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


def _upload(seg: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy a (possibly read-only, parser-owned) code slice into a tensor
    on ``device``.  The host copy is taken before this returns, so the
    caller may hand the source buffer back to the parser."""
    host = torch.empty(seg.size, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    host.numpy()[:] = seg
    if device.type == "cpu":
        return host
    return host.to(device, non_blocking=True)


def sketch_windows(codes: np.ndarray, p, tables: AcceptTables,
                   want_pos: bool = False,
                   chunk_windows: int = CHUNK_WINDOWS,
                   capacity: int | None = None):
    """All kept windows of a code stream -> (drtuples uint32, window
    positions int64 or None), unsorted, duplicates kept.

    The stream is cut into chunks of ``chunk_windows`` windows that
    overlap by TL-1 bases, so every window is evaluated exactly once.
    Each chunk runs K1; a chunk whose count exceeds its capacity reruns
    through K2.  Chunk-relative int32 positions become int64 stream
    positions on the host (a batched genome stream passes 2^31 bases).
    Every device result is on the host before the next chunk's copy."""
    TL = p.kmer_len
    device = tables.accept.device
    nwin_total = codes.size - TL + 1
    drs: list[np.ndarray] = []
    poss: list[np.ndarray] = []
    for start in range(0, max(nwin_total, 0), chunk_windows):
        nw = min(chunk_windows, nwin_total - start)
        c = _upload(codes[start:start + nw + TL - 1], device)
        cap = default_capacity(nw, tables) if capacity is None else capacity
        dr, pos, count = window_compact(c, tables, p, cap, want_pos)
        n = int(count.item())
        if n > cap:
            dr, keep = window_full(c, tables, p)
            pos = torch.nonzero(keep).flatten()
            dr = dr[pos]
        else:
            dr = dr[:n]
            pos = pos[:n] if want_pos else None
        drs.append(dr.cpu().numpy().view(np.uint32))
        if want_pos:
            poss.append(pos.cpu().numpy().astype(np.int64) + start)
    dr = np.concatenate(drs) if drs else np.zeros(0, np.uint32)
    if not want_pos:
        return dr, None
    return dr, (np.concatenate(poss) if poss else np.zeros(0, np.int64))
