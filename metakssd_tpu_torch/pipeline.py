"""Stage I on a device: sequence files -> combined sketch directory.

The port of ``metakssd_tpu/pipeline.py`` (``run_stage1``, ``sketch_file``,
the streaming fastq path and the batched multi-file path).  Parsing, the
unique/count tail and the on-disk format are the JAX package's shared,
jax-free code; the window sketch runs through ``ops/sketch.py`` on the
named device.  The output directory is byte-identical to
``metakssd_tpu.pipeline.run_stage1``'s for the same inputs.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from metakssd_tpu.formats.codir import write_codir
from metakssd_tpu.formats.costat import CoStat
from metakssd_tpu.io import native, seqio
from metakssd_tpu.ops.golden import sets_from_drtuples
from metakssd_tpu.pipeline import SketchOptions
from metakssd_tpu.utils import TIMER

from metakssd_tpu_torch.device import resolve_device
from metakssd_tpu_torch.ops import sketch
from metakssd_tpu_torch.state import accept_tables

# Bases per streamed fastq batch (reads never split across batches).
STREAM_BATCH_BASES = 64 << 20


def check_supported(opts: SketchOptions) -> None:
    """Raise for options whose code paths are not ported yet, naming
    their item in ROADMAP.md's port queue."""
    for flag, item, on in (("--byread", 1, opts.byread),
                           ("--ckpt", 2, opts.ckpt),
                           ("--mesh", 3, opts.mesh > 1),
                           ("-P/--pipecmd", 4, bool(opts.pipecmd))):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported to metakssd_tpu_torch yet "
                f"(ROADMAP.md, port queue item {item})")


def _sketch_fastq_streaming(path: str, shuf, mode: str, min_occ: int,
                            min_qual: int, device, tables):
    """Sketch a fastq of any size with O(batch) host memory: fixed-size
    read batches from the native parser go to the device one at a time,
    each batch's accepted drtuples accumulate, and unique/count runs once
    at the end.  The parser's batch buffer is reused by the next
    ``next()``; ``sketch_codes`` has copied it before returning."""
    parts = []
    for codes, _ in native.stream_fastq(path, min_qual, STREAM_BATCH_BASES,
                                        copy=False):
        parts.append(sketch.sketch_codes(codes, shuf, device, tables))
    dr = np.concatenate(parts) if parts else np.zeros(0, np.uint64)
    return sets_from_drtuples(dr, shuf.params, mode=mode, min_occ=min_occ)


def sketch_file(path: str, shuf, opts: SketchOptions, device, tables=None
                ) -> list[tuple[np.ndarray, np.ndarray | None]]:
    """Sketch one input file into per-component (ids, counts)."""
    check_supported(opts)
    if seqio.sniff_format(path) == "fastq":
        mode = "koc" if opts.abundance else "occ"
        # reference -A path (mt_shortreads2koc) has no quality filter
        q = 0 if opts.abundance else opts.min_qual
        if native.available():
            return _sketch_fastq_streaming(path, shuf, mode, opts.min_occ,
                                           q, device, tables)
        codes, _ = seqio.fastq_to_codes(path, min_qual=q)
        return sketch.sketch_to_sets(codes, shuf, device, mode=mode,
                                     min_occ=opts.min_occ, tables=tables)
    codes = seqio.fasta_to_codes(path)
    return sketch.sketch_to_sets(codes, shuf, device,
                                 mode="uniq" if opts.dedup else "set",
                                 min_occ=opts.min_occ, tables=tables)


def _batched_stage1(inputs: list[str], shuf, opts: SketchOptions, koc: bool,
                    device, tables):
    """Sketch many inputs in one device stream: files concatenate
    (RESET-separated), survivors are attributed to files by window
    position, then unique/count per file on the host."""
    p = shuf.params

    def _parse(path: str) -> np.ndarray:
        if seqio.sniff_format(path) == "fastq":
            q = 0 if opts.abundance else opts.min_qual
            return seqio.fastq_to_codes(path, min_qual=q)[0]
        return seqio.fasta_to_codes(path)

    # host parse pool (-p): the native parser releases the GIL inside
    # its ctypes call, so threads parse files in parallel
    nthreads = opts.threads if opts.threads > 0 else (os.cpu_count() or 1)
    nthreads = min(nthreads, len(inputs))
    if nthreads > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=nthreads) as pool:
            parsed = list(pool.map(_parse, inputs))
    else:
        parsed = [_parse(path) for path in inputs]

    chunks: list[np.ndarray] = []
    bounds = np.zeros(len(inputs) + 1, dtype=np.int64)
    for i, c in enumerate(parsed):
        chunks.append(c)
        chunks.append(np.full(1, 255, dtype=np.uint8))
        bounds[i + 1] = bounds[i] + c.size + 1
    del parsed
    codes = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
    del chunks
    dr, pos = sketch.sketch_codes_with_positions(codes, shuf, device, tables)
    gid = np.searchsorted(bounds, pos, side="right") - 1
    per_genome = []
    for g in range(len(inputs)):
        fmt_fastq = seqio.sniff_format(inputs[g]) == "fastq"
        mine = np.sort(dr[gid == g])
        uniq, counts = np.unique(mine, return_counts=True)
        ab = None
        if koc:
            ab = np.minimum(counts, 0xFFFF).astype(np.uint16)
        elif opts.dedup and not fmt_fastq:
            uniq = uniq[counts == 1]
        elif fmt_fastq and opts.min_occ > 1:
            uniq = uniq[counts >= opts.min_occ]
        comp = (uniq % np.uint64(p.component_num)).astype(np.int64)
        ids = (uniq >> np.uint64(p.comp_code_bits)).astype(np.uint32)
        per_genome.append([
            (ids[comp == ci],
             ab[comp == ci] if ab is not None else None)
            for ci in range(p.component_num)])
    return per_genome


def run_stage1(inputs: list[str], shuf, out_dir: str,
               opts: SketchOptions | None = None, *, device) -> CoStat:
    """Sketch all inputs on ``device`` and write the combined sketch
    directory (``metakssd_tpu.pipeline.run_stage1``)."""
    opts = opts or SketchOptions()
    check_supported(opts)
    dev = resolve_device(device)
    p = shuf.params
    tables = accept_tables(shuf, dev) if sketch.on_device_path(shuf) \
        else None

    koc = opts.abundance
    if koc and any(seqio.sniff_format(f) != "fastq" for f in inputs):
        # reference closes abundance mode on non-fastq input
        # (command_dist.c:390-393)
        koc = False
        opts = dataclasses.replace(opts, abundance=False)

    batchable = (len(inputs) > 1 and
                 (not koc or
                  all(seqio.sniff_format(f) == "fastq" for f in inputs)))
    TIMER.count("stage1.files", len(inputs))
    with TIMER.stage("stage1.sketch"):
        if batchable:
            per_genome = _batched_stage1(inputs, shuf, opts, koc, dev,
                                         tables)
        else:
            per_genome = [sketch_file(path, shuf, opts, dev, tables)
                          for path in inputs]

    ctx_ct = np.array(
        [sum(g[c][0].size for c in range(p.component_num))
         for g in per_genome], dtype=np.uint32)
    stat = CoStat(shuf_id=p.shuf_id, koc=koc, kmerlen=2 * p.k,
                  dim_rd_len=2 * p.drlevel, comp_num=p.component_num,
                  all_ctx_ct=int(ctx_ct.sum()), ctx_ct=ctx_ct,
                  names=list(inputs))
    write_codir(out_dir, stat, per_genome)
    if opts.keepcofile:
        # the per-file intermediates "{i}.co.{c}" (+ ".a") of the
        # reference's --keepcofile (command_dist.c:438-457)
        for i, g in enumerate(per_genome):
            for c, (ids, ab) in enumerate(g):
                ids.astype(np.uint32).tofile(
                    os.path.join(out_dir, f"{i}.co.{c}"))
                if ab is not None:
                    ab.astype(np.uint16).tofile(
                        os.path.join(out_dir, f"{i}.co.{c}.a"))
    return stat
