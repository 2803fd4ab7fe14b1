"""Inverted-index ("mco") artifacts.

Reference format (co2mco.c:12-87), per component c:
    mco.c        — concatenated genome-id rows (uint32), one row per k-mer
                   id in [0, 16**component_sz), empty rows omitted
    mco.index.c  — uint64[16**component_sz] cumulative row end offsets
    mcofiles.stat — header (formats.costat.McoStat)

The dense index is the reference's design (34 GiB at component_sz=8!);
the engine's native representation is the sparse CSR
:class:`InvertedIndex` (sorted distinct k-mer ids + row offsets +
gid postings) which converts losslessly to/from the dense format.
"""

from __future__ import annotations

import dataclasses
import os
import numpy as np

from metakssd_tpu_torch.formats.codir import CoDir
from metakssd_tpu_torch.formats.costat import McoStat

MCO_PREFIX = "mco"
MCO_IDX_PREFIX = "mco.index"


@dataclasses.dataclass
class InvertedIndex:
    """Sparse CSR inverted index for one component.

    kmers[i] is a distinct sorted k-mer id; its genome list is
    gids[offsets[i]:offsets[i+1]] (ascending genome order, matching the
    reference's sequential append order in co2mco.c:37-56).
    """
    kmers: np.ndarray     # uint32[nrows], sorted distinct
    offsets: np.ndarray   # uint64[nrows+1]
    gids: np.ndarray      # uint32[total_postings]

    @classmethod
    def from_codir(cls, cd: CoDir, c: int) -> "InvertedIndex":
        ids = cd.ids[c]
        index = cd.index[c]
        n = ids.size
        # stable sort by k-mer id keeps genome order inside each row:
        # fused native inversion (mmap-direct read, genome rows derived
        # in the scatter pass — no key copy / row-fill temporaries;
        # numpy stable argsort is ~7x slower at stage-II scale)
        from metakssd_tpu_torch.io import native as native_io
        pair = None
        if native_io.available() and np.asarray(ids).dtype.itemsize <= 4:
            pair = native_io.invert_postings(ids, index,
                                             cd.stat.infile_num)
        if pair is not None:
            sk, sg = pair[0], pair[1].view(np.uint32)
        else:
            gid = np.empty(n, dtype=np.uint32)
            for g in range(cd.stat.infile_num):
                gid[int(index[g]):int(index[g + 1])] = g
            order = np.argsort(ids, kind="stable")
            sk = np.asarray(ids)[order]
            sg = gid[order]
        # unique of a sorted array without np.unique's internal re-sort
        from metakssd_tpu_torch.utils import sorted_first_idx
        starts = sorted_first_idx(sk)
        kmers = sk[starts]
        offsets = np.empty(kmers.size + 1, dtype=np.uint64)
        offsets[:-1] = starts
        offsets[-1] = n
        return cls(kmers, offsets, sg)



class _FileSink:
    """Sequential big-file writer.  Uses O_DIRECT with page-aligned
    staging buffers when available (bypasses page-cache writeback:
    754 vs 183 MiB/s measured on this virtio disk — writeback
    throttling, not the device, was the stage-II bottleneck); falls
    back to buffered writes for unaligned tails or unsupporting
    filesystems (MKSSD_NO_DIRECT_IO=1 forces the fallback)."""

    def __init__(self, path: str):
        self.path = path
        self.off = 0
        self.direct = False
        flags = os.O_WRONLY | os.O_CREAT | os.O_TRUNC
        if hasattr(os, "O_DIRECT") and \
                not os.environ.get("MKSSD_NO_DIRECT_IO"):
            try:
                self.fd = os.open(path, flags | os.O_DIRECT, 0o644)
                self.direct = True
            except OSError:
                self.fd = os.open(path, flags, 0o644)
        else:
            self.fd = os.open(path, flags, 0o644)

    def write(self, mv) -> None:
        """mv: memoryview over a PAGE-ALIGNED buffer (mmap-backed)."""
        n = len(mv)
        if n == 0:
            return
        if self.direct and n % 4096:
            # unaligned tail: drop to buffered for the rest of the file.
            # Invalidate self.fd across the reopen — if the reopen
            # raises (e.g. the file was unlinked by concurrent cleanup),
            # a later close() would otherwise re-close the OLD fd
            # number, which the OS may already have reused (observed:
            # it landed on a subprocess pipe and broke an unrelated
            # oracle run in the fuzz harness).
            os.close(self.fd)
            self.fd = -1
            self.fd = os.open(self.path, os.O_WRONLY)
            self.direct = False
        w = 0
        while w < n:
            w += os.pwrite(self.fd, mv[w:], self.off + w)
        self.off += n

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1


def _aligned_bufs(nbuf: int, nbytes: int):
    """nbuf page-aligned byte buffers (mmap-backed, O_DIRECT-safe)."""
    import mmap
    mms = [mmap.mmap(-1, nbytes) for _ in range(nbuf)]
    return mms, [np.frombuffer(m, dtype=np.uint8) for m in mms]


def _stream_array(sink: _FileSink, arr: np.ndarray) -> None:
    """Write a contiguous array through the sink via aligned staging
    chunks (memcpy at GB/s is free next to the disk)."""
    _stream_byte_parts(sink, [np.ascontiguousarray(arr)
                              .view(np.uint8).reshape(-1)])


def _stream_byte_parts(sink: _FileSink, parts) -> None:
    """Stream consecutive byte arrays as one file through aligned
    staging chunks, packing across part boundaries so every write but
    the last stays O_DIRECT-aligned."""
    total = sum(len(p) for p in parts)
    CHB = 1 << 27
    mms, bufs = _aligned_bufs(1, min(CHB, max(total, 1)))
    fill = 0
    for p in parts:
        off = 0
        while off < len(p):
            n = min(CHB - fill, len(p) - off)
            bufs[0][fill:fill + n] = p[off:off + n]
            fill += n
            off += n
            if fill == CHB:
                sink.write(memoryview(mms[0])[:fill])
                fill = 0
    if fill:
        sink.write(memoryview(mms[0])[:fill])


def save_npy_direct(path: str, arr: np.ndarray) -> None:
    """np.save equivalent through the O_DIRECT sink, crash-safe: the
    .npy bytes land in a same-directory temp file and rename into place
    atomically, so readers only ever see complete sidecars (page-cache
    writeback throttles buffered np.save to ~180 MiB/s on this disk;
    the sink sustains ~750)."""
    import io as _io

    from numpy.lib import format as npfmt
    hdr = _io.BytesIO()
    arr = np.ascontiguousarray(arr)
    npfmt.write_array_header_1_0(hdr, npfmt.header_data_from_array_1_0(arr))
    tmp = f"{path}.tmp{os.getpid()}"
    sink = _FileSink(tmp)
    try:
        _stream_byte_parts(sink, [
            np.frombuffer(hdr.getvalue(), np.uint8),
            arr.view(np.uint8).reshape(-1)])
    except BaseException:
        sink.close()
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    sink.close()
    os.rename(tmp, path)


def write_mco_component(dirpath: str, c: int, inv: InvertedIndex,
                        comp_space: int) -> None:
    """Write one component in the dense reference format.

    The dense cumulative index has 16^COMPONENT_SZ rows (34 GiB at the
    reference default of 8), so it is streamed in bounded chunks — the
    u64 row-size buffer carries a running offset, never materialising
    the whole index in RAM.  Chunks are written by a dedicated writer
    thread (4-deep aligned buffer ring) through O_DIRECT, so the
    memset+scatter+cumsum compute (~2.5 GB/s) fully overlaps a
    writeback-free disk stream."""
    import queue
    import threading

    os.makedirs(dirpath, exist_ok=True)
    lens = np.diff(inv.offsets.astype(np.int64)).astype(np.uint64)
    kmers = inv.kmers.astype(np.int64)
    CH = 1 << 24
    sink = _FileSink(os.path.join(dirpath, f"{MCO_IDX_PREFIX}.{c}"))
    try:
        # 4 buffers + queue depth 2: at most (queue 2) + (writer 1)
        # chunks in flight while the producer fills a 4th — a buffer is
        # never refilled before its write completed
        nbuf = 4
        rows = min(CH, comp_space)
        mms, raw = _aligned_bufs(nbuf, rows * 8)
        bufs = [r.view(np.uint64) for r in raw]
        q: queue.Queue = queue.Queue(maxsize=nbuf - 2)
        err: list = []

        def writer():
            while True:
                item = q.get()
                if item is None:
                    return
                try:
                    sink.write(item)
                except OSError as e:   # surface on the producer side
                    err.append(e)

        th = threading.Thread(target=writer)
        th.start()
        try:
            base = np.uint64(0)
            lo_i = 0
            for i, off in enumerate(range(0, comp_space, CH)):
                n = min(CH, comp_space - off)
                chunk = bufs[i % nbuf][:n]
                chunk[:] = 0
                hi_i = int(np.searchsorted(kmers, off + n, side="left"))
                sel = slice(lo_i, hi_i)
                chunk[kmers[sel] - off] = lens[sel]
                lo_i = hi_i
                np.cumsum(chunk, out=chunk)
                chunk += base
                base = chunk[-1] if n else base
                if err:
                    raise err[0]
                q.put(memoryview(mms[i % nbuf])[:n * 8])
        finally:
            q.put(None)
            th.join()
        if err:
            raise err[0]
    finally:
        sink.close()
    gsink = _FileSink(os.path.join(dirpath, f"{MCO_PREFIX}.{c}"))
    try:
        _stream_array(gsink, inv.gids.astype(np.uint32, copy=False))
    finally:
        gsink.close()




def build_mco(co_dir: str, mco_dir: str,
              component_sz: int | None = None) -> McoStat:
    """Stage II: invert a sketch dir into a reference-format mco dir
    (reference run_stageII, command_dist.c:504-552).

    component_sz controls the dense row space (16**component_sz) exactly
    like the reference's COMPONENT_SZ macro; the default (8) matches the
    reference's default build but produces a 32 GiB index file — pass 6
    to interoperate with `make alert`-style builds or for tests.
    """
    from metakssd_tpu_torch import params as P
    comp_space = 1 << (4 * (component_sz if component_sz is not None
                            else P.COMPONENT_SZ))
    cd = CoDir.read(co_dir, want_abund=False)
    stat = McoStat.from_costat(cd.stat)
    os.makedirs(mco_dir, exist_ok=True)
    from metakssd_tpu_torch.utils import TIMER

    def one(c: int) -> None:
        with TIMER.stage("stage2.invert"):
            inv = InvertedIndex.from_codir(cd, c)
        with TIMER.stage("stage2.write"):
            write_mco_component(mco_dir, c, inv, comp_space)

    if cd.stat.comp_num > 1:
        # components are independent files: invert+write in parallel
        # (2 workers: overlaps one component's sort with another's IO
        # without doubling peak RAM; numpy releases the GIL in both)
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=2) as ex:
            list(ex.map(one, range(cd.stat.comp_num)))
    else:
        one(0)
    stat.write(mco_dir)
    return stat
