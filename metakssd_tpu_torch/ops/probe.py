"""The probe kernels P1-P4: wrappers, plain versions and launch counters.

The TPU probes (``benchmarks/probe_kernel_cost.py``, ``probe_r4.py``,
``probe_floor_chunk.py``, ``probe_floor_noread.py``) split the cost of the
compact sketch kernel K1 into its read floor, window math, table search
and launch overhead.  Each of their Pallas kernels reduces one block of a
[nb, rows, 128] tile tensor to a [1, 128] row of int32 sums; four CUDA
kernels (``csrc/probe.cu``) cover every variant:

* ``floor`` (``mkssd_probe_floor``): sum, XOR or block index over a row
  range of int32, int8 or uint16 tiles (the last two read 16 bytes a
  load, from 16-byte aligned tiles);
* ``winmath`` (``mkssd_probe_winmath``): the sum of ``(uni_hi ^ uni_lo) |
  invalid`` over the windows of the first ``nrows`` rows;
* ``gather`` (``mkssd_probe_gather``): ``ng`` chained lookups in a
  4096-entry table or in its first 128 entries, uint32 or uint16;
* ``search`` (``mkssd_probe_search``): window math plus the exact table
  search (the lower bound in the accept table, found through K3's bucket
  index of it, ``merge.MemberIndex``) or the signature search of
  ``sketch_pallas.py:188-219``, summing ``base | pos`` of kept windows.

Each wrapper runs its plain PyTorch version when the tiles lie on the CPU,
launches its kernel when they lie on a CUDA device, and raises on anything
else.  Where several CUDA blocks share a tile block, a kernel combines
their rows in the way ``REDUCE`` names for it: ``"ticket"``, one launch
(the last block adds the others' rows), or ``"atomic"``, the result
zeroed first and each block adding into it.  The plain versions compute
in int64 and wrap to int32, as the TPU kernels' int32 sums wrap.  Every
result is int32 [nb, 1, 128].  u32 table entries travel in int32 tensors
with the same bits; uint16 tiles and tables are ``torch.uint16`` tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from metakssd_tpu_torch.ops import _build, merge
from metakssd_tpu_torch.ops.sketch_cuda import _as_u32_bits

LANES = 128
PART_ROWS = 128               # rows a CUDA block takes, at least (kPartRows)
MAX_SHARES = 65535            # CUDA blocks of a tile block (kMaxShares)
# How each kernel combines the blocks of a tile block (csrc/probe.cu):
# each the faster on the H100 (PERF.md, PR 9); the gather's chains of
# dependent loads lose 7% to the ticket's grid of fewer, longer blocks
REDUCE = {"floor": "ticket", "winmath": "ticket", "gather": "atomic",
          "search": "ticket"}
OPS = {"sum": 0, "xor": 1, "none": 2}
_TILE_TYPES = {torch.int32: 0, torch.int8: 1, torch.uint16: 2}
_LOW32 = 0xFFFFFFFF


def _i64(t: torch.Tensor) -> torch.Tensor:
    """int64 values of int32 / int8 (sign-extended) or uint16 / u32-bit
    int32 tables (zero-extended by the caller) tensors."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(torch.int64) & 0xFFFF
    return t.to(torch.int64)


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 sums -> their int32 value mod 2^32."""
    return _as_u32_bits(x & _LOW32)


# ---------------------------------------------------------------------------
# inputs: tiles and search tables
# ---------------------------------------------------------------------------

def tiles_from_codes(codes: torch.Tensor, rwin: int, ext: int,
                     nblocks: int | None = None) -> torch.Tensor:
    """Column-major window tiles of a code stream: the counterpart of
    ``sketch_pallas._restructure_packed``.  Window ``(b*128 + l)*rwin + r``
    goes to ``tiles[b, r, l]`` for r < rwin, rows rwin .. rwin+ext-1 repeat
    the next ``ext`` bases of the lane's strip, and invalid bases (>= 4)
    become 4, as does everything past the stream.  ``nblocks`` defaults
    to the blocks the stream fills."""
    if not 0 <= ext <= rwin:
        raise ValueError(f"ext {ext} must lie in [0, rwin={rwin}]")
    n = codes.numel()
    S = LANES * (nblocks if nblocks is not None
                 else max(1, -(-n // (LANES * rwin))))
    M = S * rwin
    c = torch.full((M + rwin,), 4, dtype=torch.int32, device=codes.device)
    m = min(n, M + rwin)
    c[:m] = codes[:m].to(torch.int32).clamp_(max=4)
    strips = torch.cat([c[:M].view(S, rwin),
                        c[rwin:M + rwin].view(S, rwin)[:, :ext]], dim=1)
    return strips.view(S // LANES, LANES, rwin + ext).transpose(1, 2) \
        .contiguous()


def exact_buckets(n: int) -> int | None:
    """The bucket count of the exact search's index over ``n`` accept
    keys: the most that K3's index kernel takes (nb + 1 <= n; 2048 for
    4096 keys, about 2 keys a bucket), which searched faster on the H100
    than K3's own 1/8 rule (256, about 16; PERF.md section 6).  None (K3's
    rule: no index) below 2 keys."""
    return 1 << ((n - 1).bit_length() - 1) if n >= 2 else None


def exact_index(accept: torch.Tensor) -> merge.MemberIndex:
    """K3's index of the sorted accept table (u32 bits in int32) on its
    device, at ``exact_buckets``: built once per table, then passed to
    every ``search`` on it."""
    return merge.build_index(accept, buckets=exact_buckets(accept.numel()))


def bfs_levels(accept_tups: np.ndarray) -> np.ndarray:
    """Splitter values of the binary search, one row group per level (the
    port's copy of ``sketch_pallas._bfs_levels``): level d holds the 2^d
    values the search compares at step d."""
    n = accept_tups.size
    rows = []
    for d in range(n.bit_length() - 1):
        sz = 1 << d
        row = np.zeros(max(LANES, sz), np.uint32)
        row[:sz] = accept_tups[(2 * np.arange(sz) + 1) * (n >> (d + 1)) - 1]
        rows.append(row.reshape(-1, LANES))
    return np.concatenate(rows, axis=0)


def sig_tables(accept_tups: np.ndarray) -> np.ndarray:
    """[R/2, 128] uint32 pair-packed low-16-bit signatures of each bucket's
    R = n/128 entries (the port's copy of ``sketch_pallas._sig_tables``):
    lane b, word w = sig(entry 2w) | sig(entry 2w+1) << 16."""
    runs = accept_tups.reshape(LANES, accept_tups.size // LANES)
    s16 = (runs & np.uint32(0xFFFF)).astype(np.uint32)
    return (s16[:, 0::2] | (s16[:, 1::2] << np.uint32(16))).T


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def floor_plain(tiles: torch.Tensor, row0: int, row1: int,
                op: str = "sum") -> torch.Tensor:
    """Plain version of ``floor``."""
    nb = tiles.shape[0]
    if op == "none":
        return torch.arange(nb, dtype=torch.int32, device=tiles.device) \
            .view(nb, 1, 1).expand(nb, 1, LANES).contiguous()
    x = _i64(tiles[:, row0:row1])
    if op == "sum":
        return _wrap(x.sum(dim=1, keepdim=True))
    acc = torch.zeros_like(x[:, :1])
    for r in range(x.shape[1]):
        acc ^= x[:, r:r + 1]
    return _wrap(acc)


def _tuples(tiles: torch.Tensor, nrows: int, TL: int):
    """The TPU kernels' (uni_hi, uni_lo, invalid) of the first nrows
    window rows, as int64 u32 halves."""
    c = _i64(tiles)
    shape = (tiles.shape[0], nrows, LANES)
    z = torch.zeros(shape, dtype=torch.int64, device=tiles.device)
    fwd_hi, fwd_lo, rc_hi, rc_lo = z, z.clone(), z.clone(), z.clone()
    invalid = torch.zeros(shape, dtype=torch.bool, device=tiles.device)
    for j in range(TL):
        cs = c[:, j:j + nrows]
        seg = cs & 3
        invalid |= cs >= 4
        fpos, rpos = 2 * (TL - 1 - j), 2 * j
        if fpos >= 32:
            fwd_hi |= seg << (fpos - 32)
        else:
            fwd_lo |= seg << fpos
        if rpos >= 32:
            rc_hi |= (seg ^ 3) << (rpos - 32)
        else:
            rc_lo |= (seg ^ 3) << rpos
    take_fwd = (fwd_hi < rc_hi) | ((fwd_hi == rc_hi) & (fwd_lo <= rc_lo))
    return (torch.where(take_fwd, fwd_hi, rc_hi),
            torch.where(take_fwd, fwd_lo, rc_lo), invalid)


def winmath_plain(tiles: torch.Tensor, nrows: int, TL: int) -> torch.Tensor:
    """Plain version of ``winmath``."""
    hi, lo, invalid = _tuples(tiles, nrows, TL)
    return _wrap(((hi ^ lo) | invalid.to(torch.int64)).sum(dim=1,
                                                            keepdim=True))


def gather_plain(tiles: torch.Tensor, nrows: int, table: torch.Tensor,
                 size: int, mult: int, ng: int) -> torch.Tensor:
    """Plain version of ``gather``."""
    tab = _i64(table.reshape(-1)[:size]) & _LOW32
    pos = ((_i64(tiles[:, :nrows]) & 3) * mult) & (size - 1)
    acc = torch.zeros_like(pos)
    for _ in range(ng):
        res = tab[pos]
        acc += res
        pos = (pos + res) & (size - 1)
    return _wrap(acc.sum(dim=1, keepdim=True))


def search_plain(tiles: torch.Tensor, nrows: int, k: int, subk: int,
                 drlevel: int, accept: torch.Tensor | None = None,
                 lev: torch.Tensor | None = None,
                 sig: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``search``: the exact form without ``sig``, else
    the signature form."""
    TL, outctx = 2 * k, k - subk
    hi, lo, invalid = _tuples(tiles, nrows, TL)
    uni = (hi << 32) | lo
    dim = (uni >> (2 * outctx)) & ((1 << (4 * subk)) - 1)
    if sig is None:
        a = _i64(accept) & _LOW32
        pos = torch.searchsorted(a, dim)
        hit = a[pos.clamp(max=a.numel() - 1)] == dim
    else:
        levs = _i64(lev[:7]) & _LOW32
        pos = torch.zeros_like(dim)
        for d in range(7):
            pos = 2 * pos + (levs[d][pos] < dim).to(torch.int64)
        words = _i64(sig) & _LOW32
        hit = torch.zeros_like(invalid)
        for w in range(words.shape[0]):
            word = words[w][pos]
            hit |= ((word & 0xFFFF) == (dim & 0xFFFF)) | \
                ((word >> 16) == (dim & 0xFFFF))
    omask = (1 << (2 * outctx)) - 1
    top = (uni >> (4 * k - 2 * outctx)) & omask
    base = (((top << (2 * outctx)) | (uni & omask))
            << (4 * (subk - drlevel))) & _LOW32
    acc = torch.where(hit & ~invalid, base | pos, 0)
    return _wrap(acc.sum(dim=1, keepdim=True))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _cuda(tiles: torch.Tensor, name: str):
    """The library and stream for a launch on the tiles' device; raises for
    a device with no kernel or a layout the kernel does not take."""
    if tiles.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {tiles.device}")
    if tiles.dim() != 3 or tiles.shape[2] != LANES \
            or not tiles.is_contiguous():
        raise ValueError(f"{name}: tiles must be a contiguous "
                         f"[nb, rows, {LANES}] tensor")
    return (_build.library(),
            torch.cuda.current_stream(tiles.device).cuda_stream)


# Ticket counters per (device, stream), zeroed once: every launch leaves
# them zero, and launches on one stream run in turn.  A CUDA graph's
# replays use those of the stream it was captured on.
_TICKETS: dict = {}
_MIN_TICKETS = 4096


def _tickets(device: torch.device, stream: int, nb: int) -> torch.Tensor:
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < nb:
        t = torch.zeros(max(nb, _MIN_TICKETS), dtype=torch.int32,
                        device=device)
        _TICKETS[(device, stream)] = t
    return t


def _outputs(tiles: torch.Tensor, rows: int, name: str, stream: int):
    """A kernel's [blocks, 1, LANES] int32 result, its scratch and its
    ticket counters (None for the atomic reduce, or where one block takes
    a tile block's ``rows``)."""
    nb = tiles.shape[0]
    parts = -(-rows // PART_ROWS)
    if parts > MAX_SHARES:
        raise ValueError(f"{name}: {rows} rows a tile block; a launch takes "
                         f"at most {MAX_SHARES * PART_ROWS}")
    shape = (nb, 1, LANES)
    if parts == 1:
        return torch.empty(shape, dtype=torch.int32, device=tiles.device), \
            None, None
    if REDUCE[name] == "atomic":
        return torch.zeros(shape, dtype=torch.int32, device=tiles.device), \
            None, None
    out = torch.empty(shape, dtype=torch.int32, device=tiles.device)
    partial = torch.empty((nb, parts, LANES), dtype=torch.int32,
                          device=tiles.device)
    return out, partial, _tickets(tiles.device, stream, nb)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _table(t: torch.Tensor, tiles: torch.Tensor, name: str) -> None:
    if t.device != tiles.device or t.dtype != torch.int32 \
            or not t.is_contiguous():
        raise ValueError(f"{name}: tables must be contiguous int32 on the "
                         "tiles' device")


def check_vector_rows(tiles: torch.Tensor, row0: int) -> None:
    """Raises unless the floor kernel of int8 and uint16 tiles, which reads
    16 bytes a load, can read ``tiles`` from row ``row0``: the tiles' base
    and the row's offset ``row0 * 128 * itemsize`` 16-byte aligned."""
    offset = row0 * LANES * tiles.element_size()
    if tiles.data_ptr() % 16 or offset % 16:
        raise ValueError(f"floor: {tiles.dtype} tiles at {tiles.data_ptr():#x}"
                         f" (row {row0} at +{offset}) are not 16-byte "
                         "aligned; the kernel reads 16 bytes a load")


def floor(tiles: torch.Tensor, row0: int, row1: int,
          op: str = "sum") -> torch.Tensor:
    """Sum (``op="sum"``), XOR (``"xor"``) or block index (``"none"``) of
    rows [row0, row1) of each tile block.  On CUDA, int8 and uint16 tiles
    must be 16-byte aligned (``check_vector_rows``)."""
    if tiles.device.type == "cpu":
        return floor_plain(tiles, row0, row1, op)
    lib, stream = _cuda(tiles, "floor")
    if tiles.dtype not in _TILE_TYPES or op not in OPS:
        raise ValueError(f"floor: no kernel for {tiles.dtype} tiles, op {op}")
    if tiles.element_size() < 4 and op != "none":
        check_vector_rows(tiles, row0)
    out, partial, tickets = _outputs(tiles, row1 - row0, "floor", stream)
    _build.raise_on(lib.mkssd_probe_floor(
        tiles.data_ptr(), _TILE_TYPES[tiles.dtype], tiles.shape[0],
        tiles.shape[1], row0, row1, OPS[op], out.data_ptr(), _ptr(partial),
        _ptr(tickets), stream), "mkssd_probe_floor")
    _build.LAUNCHES["probe_floor"] += 1
    return out


def winmath(tiles: torch.Tensor, nrows: int, TL: int) -> torch.Tensor:
    """Window math over the first ``nrows`` window rows of int32 or int8
    tiles."""
    if tiles.device.type == "cpu":
        return winmath_plain(tiles, nrows, TL)
    lib, stream = _cuda(tiles, "winmath")
    if tiles.dtype not in (torch.int32, torch.int8):
        raise ValueError(f"winmath: no kernel for {tiles.dtype} tiles")
    out, partial, tickets = _outputs(tiles, nrows, "winmath", stream)
    _build.raise_on(lib.mkssd_probe_winmath(
        tiles.data_ptr(), _TILE_TYPES[tiles.dtype], tiles.shape[0],
        tiles.shape[1], nrows, TL, out.data_ptr(), _ptr(partial),
        _ptr(tickets), stream), "mkssd_probe_winmath")
    _build.LAUNCHES["probe_winmath"] += 1
    return out


def gather(tiles: torch.Tensor, nrows: int, table: torch.Tensor, size: int,
           mult: int, ng: int) -> torch.Tensor:
    """``ng`` chained lookups in the first ``size`` (4096 or 128) entries
    of a uint32 (int32 bits) or uint16 table, over int32 tiles."""
    if tiles.device.type == "cpu":
        return gather_plain(tiles, nrows, table, size, mult, ng)
    lib, stream = _cuda(tiles, "gather")
    if tiles.dtype != torch.int32 or table.device != tiles.device \
            or table.dtype not in (torch.int32, torch.uint16) \
            or not table.is_contiguous() or table.numel() < size:
        raise ValueError("gather: int32 tiles and a contiguous int32 or "
                         f"uint16 table of >= {size} entries on one device")
    out, partial, tickets = _outputs(tiles, nrows, "gather", stream)
    _build.raise_on(lib.mkssd_probe_gather(
        tiles.data_ptr(), tiles.shape[0], tiles.shape[1], nrows,
        table.data_ptr(), _TILE_TYPES[table.dtype], size, mult, ng,
        out.data_ptr(), _ptr(partial), _ptr(tickets), stream),
        "mkssd_probe_gather")
    _build.LAUNCHES["probe_gather"] += 1
    return out


def _check_index(index: merge.MemberIndex, accept: torch.Tensor | None,
                 sig: torch.Tensor | None, tiles: torch.Tensor) -> None:
    """Raises unless ``index`` can be the exact search's index of
    ``accept`` for these tiles: the table's size, type and device, and a
    bucket count ``mkssd_probe_search`` takes."""
    if sig is not None or accept is None:
        raise ValueError("search: an index goes with the exact form's "
                         "accept table")
    t = index.table
    if t.device != tiles.device or t.device != accept.device \
            or t.dtype != torch.int32 or t.dim() != 1 \
            or not t.is_contiguous():
        raise ValueError(f"search: the index table ({t.dtype} on "
                         f"{t.device}) must be contiguous int32 on the "
                         f"tiles' device {tiles.device}")
    nb = index.nb
    if t.numel() != (nb + 1 if nb else 0):
        raise ValueError(f"search: an index of {nb} buckets holds "
                         f"{nb + 1 if nb else 0} entries, not {t.numel()}")
    if nb and (nb & (nb - 1) or nb + 1 > accept.numel()) \
            or not 0 <= index.shift <= 32:
        raise ValueError(f"search: no index of {nb} buckets, shift "
                         f"{index.shift} over {accept.numel()} keys")


def search(tiles: torch.Tensor, nrows: int, k: int, subk: int, drlevel: int,
           accept: torch.Tensor | None = None, lev: torch.Tensor | None = None,
           sig: torch.Tensor | None = None,
           index: merge.MemberIndex | None = None) -> torch.Tensor:
    """Window math + table search over int32 tiles: exact with the sorted
    ``accept`` table, or the signature form with the BFS levels ``lev``
    and the signature words ``sig`` (all u32 bits in int32).  ``index``
    is ``exact_index(accept)``, checked on every device; on CUDA the exact
    form without one builds it first (set-up, counted as
    ``LAUNCHES["member_index"]``: a read of the table's last key, so not
    inside a CUDA graph's capture)."""
    if index is not None:
        _check_index(index, accept, sig, tiles)
    if tiles.device.type == "cpu":
        return search_plain(tiles, nrows, k, subk, drlevel, accept, lev, sig)
    lib, stream = _cuda(tiles, "search")
    if tiles.dtype != torch.int32:
        raise ValueError(f"search: no kernel for {tiles.dtype} tiles")
    if sig is None:
        _table(accept, tiles, "search")
        if index is None:
            index = exact_index(accept)
    else:
        _table(lev, tiles, "search")
        _table(sig, tiles, "search")
        if lev.numel() < 7 * LANES or sig.dim() != 2 \
                or sig.shape[1] != LANES:
            raise ValueError("search: lev needs 7 rows of 128, sig "
                             "[words, 128]")
    out, partial, tickets = _outputs(tiles, nrows, "search", stream)
    _build.raise_on(lib.mkssd_probe_search(
        tiles.data_ptr(), tiles.shape[0], tiles.shape[1], nrows, k, subk,
        drlevel, None if accept is None else accept.data_ptr(),
        0 if accept is None else accept.numel(),
        None if index is None or index.nb == 0 else index.table.data_ptr(),
        0 if index is None else index.nb,
        0 if index is None else index.shift,
        None if lev is None else lev.data_ptr(),
        None if sig is None else sig.data_ptr(),
        0 if sig is None else sig.shape[0], out.data_ptr(), _ptr(partial),
        _ptr(tickets), stream), "mkssd_probe_search")
    _build.LAUNCHES["probe_search"] += 1
    return out
