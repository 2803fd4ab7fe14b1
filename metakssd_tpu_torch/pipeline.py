"""Stage I on a device: sequence files -> combined sketch directory.

The port of ``metakssd_tpu/pipeline.py`` (``run_stage1``, ``sketch_file``
with ``-P``, the streaming fastq path, the batched multi-file path,
``--byread``, the ``--ckpt`` snapshots and ``--mesh``), with its options,
input listing and ``-L`` handling.  Parsing, the unique/count tail and the
on-disk format are the port's copies of the JAX package's host code; the
window sketch runs through ``ops/sketch.py`` on the named device, or with
``--mesh N`` through ``parallel/mesh.sharded_sketch`` over N shards.  The
output directory is byte-identical to ``metakssd_tpu.pipeline.run_stage1``'s
for the same inputs.

On ``"host"`` stage I takes the JAX package's host engine where that
package takes it (``metakssd_tpu/pipeline.py:125-135,280-294``): each of
several files through ``native.sketch_cpu`` on one thread inside the
``-p`` pool, one fastq without ``--ckpt`` through the fused
``native.sketch_fastq``, and every other stream through ``sketch_cpu``
(``ops/sketch.sketch_codes``).  ``--byread``, ``--mesh`` and configs with
k - drlevel > 8 run as on ``"cpu"``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np

from metakssd_tpu_torch.device import engine, resolve_device
from metakssd_tpu_torch.formats.codir import write_codir
from metakssd_tpu_torch.formats.costat import CoStat
from metakssd_tpu_torch.formats.shuf import (DimShuffle, make_shuf,
                                             read_shuf, write_shuf)
from metakssd_tpu_torch.io import native, seqio
from metakssd_tpu_torch.ops import sketch
from metakssd_tpu_torch.ops.golden import sets_from_drtuples
from metakssd_tpu_torch.params import SketchParams
from metakssd_tpu_torch.state import accept_tables
from metakssd_tpu_torch.utils import TIMER

ACCEPT_EXTS = seqio.FASTA_EXTS + seqio.FASTQ_EXTS

# Bases per streamed fastq batch (reads never split across batches).
STREAM_BATCH_BASES = 64 << 20
# --ckpt: streamed batches between persisted snapshots, and files per
# batched-sketch group (a crash loses at most one group's work).
CKPT_EVERY = 8
CKPT_GROUP = 64


@dataclasses.dataclass
class SketchOptions:
    """Mirrors the reference dist options (command_dist_wrapper.c:68-96)."""
    abundance: bool = False    # -A  (koc mode, u16 counts)
    dedup: bool = False        # -u  (keep multiplicity-1 k-mers only)
    min_occ: int = 1           # -n  (fastq least k-mer occurrence)
    min_qual: int = 0          # -Q  (fastq base-quality filter)
    byread: bool = False       # --byread (per-read sketching)
    pipecmd: str = ""          # -P  (decompress/filter command -> fastq)
    threads: int = 0           # -p  (host parse pool; 0 = cpu count)
    keepcofile: bool = False   # --keepcofile (per-file .co intermediates)
    mesh: int = 0              # --mesh (data-parallel sketch over N devices)
    ckpt: bool = False         # --ckpt (per-file/per-batch stage-I resume)


def organize_infiles(args: list[str], list_file: str | None = None) -> list[str]:
    """Expand dirs / list files / file args into an ordered list of inputs
    (reference organize_infile_frm_arg / organize_infile_list,
    global_basic.c:169-325)."""
    paths: list[str] = []
    if list_file:
        with open(list_file) as f:
            for line in f:
                line = line.strip()
                if line:
                    paths.append(line)
    for a in args or []:
        if os.path.isdir(a):
            for name in sorted(os.listdir(a)):
                base = name[:-3] if name.endswith(".gz") else name
                if os.path.splitext(base)[1].lower() in ACCEPT_EXTS:
                    paths.append(os.path.join(a, name))
        else:
            paths.append(a)
    return paths


def resolve_shuffle(dr_file: str | None, k: int, drlevel: int,
                    out_dir: str, seed: int | None = None) -> DimShuffle:
    """-L handling: a .shuf path loads it; otherwise generate one into
    out_dir/default.shuf (reference get_dim_shuffle, command_dist.c:256-284)."""
    if dr_file and os.path.isfile(dr_file):
        return read_shuf(dr_file)
    shuf = make_shuf(SketchParams.for_drlevel(k, drlevel), seed=seed)
    os.makedirs(out_dir, exist_ok=True)
    write_shuf(os.path.join(out_dir, "default.shuf"), shuf)
    return shuf


def _ckpt_key(path: str, shuf, mode: str, min_qual: int) -> dict:
    st = os.stat(path)
    return {"file": os.path.abspath(path), "size": st.st_size,
            "mtime": st.st_mtime, "shuf_id": shuf.params.shuf_id,
            "mode": mode, "min_qual": min_qual,
            "batch_bases": STREAM_BATCH_BASES}


def _ckpt_save(ckpt_file: str, payload: dict) -> None:
    """Atomic checkpoint write (tmp + rename): a crash mid-save leaves
    the previous snapshot intact."""
    tmp = ckpt_file + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, ckpt_file)


def _ckpt_load(ckpt_file: str, key: dict):
    if not os.path.exists(ckpt_file):
        return None
    try:
        z = np.load(ckpt_file, allow_pickle=False)
        if json.loads(str(z["key"])) != key:
            return None
        return z
    except (OSError, ValueError, KeyError):
        return None


def _sketch_fastq_streaming(path: str, shuf, mode: str, min_occ: int,
                            min_qual: int, device, tables,
                            ckpt_file: str | None = None, threads: int = 0,
                            host: bool = False):
    """Sketch a fastq of any size with O(batch) host memory: fixed-size
    read batches from the native parser go to the device one at a time,
    each batch's accepted drtuples accumulate, and unique/count runs once
    at the end.  The parser's batch buffer is reused by the next
    ``next()``; ``sketch_codes`` has copied it before returning.

    With ``ckpt_file``, the accumulated drtuples persist every
    CKPT_EVERY batches; a restart parses the batches already sketched
    again but skips their sketch.  The snapshot's keys are the JAX
    package's, so either package resumes the other's.

    With ``host`` (the native engine) and no ``ckpt_file`` the fused
    native parse and sketch takes the whole file on ``threads`` threads
    (0: OpenMP's default); with ``ckpt_file`` each batch goes through
    ``native.sketch_cpu``."""
    if ckpt_file is None and host:
        dr = native.sketch_fastq(path, shuf, min_qual=min_qual,
                                 nthreads=threads)
        return sets_from_drtuples(dr, shuf.params, mode=mode,
                                  min_occ=min_occ)
    key = _ckpt_key(path, shuf, mode, min_qual)
    done = 0
    parts = []
    if ckpt_file:
        z = _ckpt_load(ckpt_file, key)
        if z is not None:
            done = int(z["done"])
            parts = [z["dr"].astype(np.uint64)]
    for i, (codes, _) in enumerate(native.stream_fastq(
            path, min_qual, STREAM_BATCH_BASES, copy=False)):
        if i < done:
            continue
        parts.append(sketch.sketch_codes(codes, shuf, device, tables,
                                         host=host))
        if ckpt_file and (i + 1 - done) % CKPT_EVERY == 0:
            _ckpt_save(ckpt_file, {"key": np.str_(json.dumps(key)),
                                   "done": np.int64(i + 1),
                                   "dr": np.concatenate(parts)})
    dr = np.concatenate(parts) if parts else np.zeros(0, np.uint64)
    if ckpt_file and os.path.exists(ckpt_file):
        os.remove(ckpt_file)
    return sets_from_drtuples(dr, shuf.params, mode=mode, min_occ=min_occ)


def sketch_file(path: str, shuf, opts: SketchOptions, device, tables=None,
                ckpt_file: str | None = None, *, host: bool = False
                ) -> list[tuple[np.ndarray, np.ndarray | None]]:
    """Sketch one input file into per-component (ids, counts).  With
    ``opts.mesh`` > 1 the whole file's code stream is sketched over that
    many data shards (``parallel/mesh.sharded_sketch``), never streamed.
    ``host``: the native engine sketches (``device.engine``)."""

    def sets(codes, mode):
        if opts.mesh > 1:
            from metakssd_tpu_torch.parallel import mesh as pmesh
            dr = pmesh.sharded_sketch(
                codes, shuf, pmesh.make_mesh(opts.mesh, 1, device), tables)
            return sets_from_drtuples(dr, shuf.params, mode=mode,
                                      min_occ=opts.min_occ)
        return sketch.sketch_to_sets(codes, shuf, device, mode=mode,
                                     min_occ=opts.min_occ, tables=tables,
                                     host=host)

    if opts.pipecmd:
        # reference treats piped input as fastq (command_dist.c:378)
        codes, _ = seqio.pipecmd_to_codes(
            opts.pipecmd, path,
            min_qual=0 if opts.abundance else opts.min_qual)
        return sets(codes, "koc" if opts.abundance else "occ")
    if seqio.sniff_format(path) == "fastq":
        mode = "koc" if opts.abundance else "occ"
        # reference -A path (mt_shortreads2koc) has no quality filter
        q = 0 if opts.abundance else opts.min_qual
        if opts.mesh <= 1 and native.available():
            return _sketch_fastq_streaming(path, shuf, mode, opts.min_occ,
                                           q, device, tables, ckpt_file,
                                           opts.threads, host)
        codes, _ = seqio.fastq_to_codes(path, min_qual=q)
        return sets(codes, mode)
    return sets(seqio.fasta_to_codes(path), "uniq" if opts.dedup else "set")


def sketch_byread(path: str, shuf, out_dir: str, *, device, **kw) -> None:
    """Per-read sketching (reference reads2mco, iseq2comem.c:89-214):
    the accepted windows of every read in stream order, duplicates kept,
    in ``combco.{c}``; ``combco.index.{c}`` holds the cumulative per-read
    counts (u64, reads + 1 entries).  The windows and their positions come
    from K1 (K2 where a chunk overflows) on ``device``, golden for configs
    off the kernel path; a stable sort by position gives stream order
    (``sketch_xla.sketch_codes(stream_order=True)``).  ``kw`` reaches the
    chunk loop (``chunk_windows``, ``capacity``)."""
    p = shuf.params
    if seqio.sniff_format(path) == "fastq":
        codes, starts = seqio.fastq_to_codes(path)
        read_starts = starts[:-1]          # one entry per read
    else:
        codes, read_starts = seqio.fasta_to_codes(path, return_headers=True)
    nreads = read_starts.size
    dr, pos = sketch.sketch_codes_with_positions(
        codes, shuf, resolve_device(device), **kw)
    order = np.argsort(pos, kind="stable")
    dr, pos = dr[order], pos[order]
    # a window belongs to the read holding its start: reads are
    # separated by RESETs, so no window spans two reads
    read_of = np.searchsorted(read_starts, pos, side="right") - 1
    comp = (dr % np.uint64(p.component_num)).astype(np.int64)
    ids = (dr >> np.uint64(p.comp_code_bits)).astype(np.uint32)
    os.makedirs(out_dir, exist_ok=True)
    for c in range(p.component_num):
        sel = comp == c
        ids[sel].tofile(os.path.join(out_dir, f"combco.{c}"))
        counts = np.bincount(read_of[sel], minlength=nreads)
        index = np.zeros(nreads + 1, dtype=np.uint64)
        np.cumsum(counts, out=index[1:])
        index.tofile(os.path.join(out_dir, f"combco.index.{c}"))
    # the reference also writes a cofiles.stat for byread dirs (one
    # "genome" = the input file, ctx counts zeroed; command_dist.c:354),
    # which reverse -b and CoDir read
    CoStat(shuf_id=p.shuf_id, koc=False, kmerlen=2 * p.k,
           dim_rd_len=2 * p.drlevel, comp_num=p.component_num,
           all_ctx_ct=0, ctx_ct=np.zeros(1, np.uint32),
           names=[path]).write(out_dir)


def _set_mode(fastq: bool, opts: SketchOptions) -> str:
    """How one input of a batched run becomes its sets
    (``sets_from_drtuples``): counts for ``-A``, a fasta's once-seen
    k-mers for dedup, a fastq's k-mers seen ``min_occ`` times, else every
    k-mer."""
    if opts.abundance:
        return "koc"
    if opts.dedup and not fastq:
        return "uniq"
    return "occ" if fastq and opts.min_occ > 1 else "set"


def _batched_stage1(inputs: list[str], shuf, opts: SketchOptions, device,
                    tables, host: bool = False):
    """Sketch many inputs in one device stream: files concatenate
    (RESET-separated), survivors are attributed to files by window
    position, then unique/count per file on the host.  With ``host``
    each file is parsed and sketched by ``native.sketch_cpu`` on one
    thread inside the ``-p`` pool instead."""
    p = shuf.params

    def _parse(path: str) -> np.ndarray:
        if seqio.sniff_format(path) == "fastq":
            q = 0 if opts.abundance else opts.min_qual
            return seqio.fastq_to_codes(path, min_qual=q)[0]
        return seqio.fasta_to_codes(path)

    def _sets(path: str, dr: np.ndarray):
        mode = _set_mode(seqio.sniff_format(path) == "fastq", opts)
        return sets_from_drtuples(dr, p, mode=mode, min_occ=opts.min_occ)

    def _host_sets(path: str):
        return _sets(path, native.sketch_cpu(_parse(path), shuf, nthreads=1))

    # host pool (-p): the native parser and sketcher release the GIL
    # inside their ctypes calls, so threads work on files in parallel
    nthreads = opts.threads if opts.threads > 0 else (os.cpu_count() or 1)
    nthreads = min(nthreads, len(inputs))
    work = _host_sets if host else _parse
    if nthreads > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=nthreads) as pool:
            parsed = list(pool.map(work, inputs))
    else:
        parsed = [work(path) for path in inputs]
    if host:
        return parsed

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
    return [_sets(path, dr[gid == g]) for g, path in enumerate(inputs)]


def _file_ckpt_path(ckpt_dir: str, i: int) -> str:
    return os.path.join(ckpt_dir, f"file{i}.npz")


def _file_ckpt_params(path: str, shuf, opts: SketchOptions) -> str:
    """Everything that changes the sketch of ``path`` keys its snapshot
    (as ``_ckpt_key`` does a stream's): a rerun with other options
    sketches again."""
    return "|".join(str(x) for x in (
        os.path.abspath(path), shuf.params.shuf_id, opts.abundance,
        opts.dedup, opts.min_occ, opts.min_qual, opts.byread))


def _save_file_ckpt(fp: str, path: str, sets, params: str) -> None:
    st = os.stat(path)
    payload = {"size": np.int64(st.st_size), "mtime": np.float64(st.st_mtime),
               "params": np.array(params), "ncomp": np.int64(len(sets))}
    for c, (ids, ab) in enumerate(sets):
        payload[f"ids_{c}"] = np.asarray(ids, dtype=np.uint32)
        if ab is not None:
            payload[f"ab_{c}"] = np.asarray(ab)
    _ckpt_save(fp, payload)


def _load_file_ckpt(fp: str, path: str, params: str):
    if not os.path.exists(fp):
        return None
    try:
        z = np.load(fp, allow_pickle=False)
        st = os.stat(path)
        if int(z["size"]) != st.st_size or \
                float(z["mtime"]) != st.st_mtime or \
                "params" not in z.files or str(z["params"]) != params:
            return None
        return [(z[f"ids_{c}"],
                 z[f"ab_{c}"] if f"ab_{c}" in z.files else None)
                for c in range(int(z["ncomp"]))]
    except (OSError, ValueError, KeyError):
        return None


def run_stage1(inputs: list[str], shuf, out_dir: str,
               opts: SketchOptions | None = None, *, device) -> CoStat:
    """Sketch all inputs on ``device`` and write the combined sketch
    directory (``metakssd_tpu.pipeline.run_stage1``).

    With ``opts.ckpt``, each file's sets persist under
    ``out_dir/.stage1_ckpt/file{i}.npz`` as they complete (batched inputs
    in groups of CKPT_GROUP files; a streamed fastq also every CKPT_EVERY
    batches in ``stream{i}.ckpt``); a rerun after a crash resumes from
    them, and the directory goes once the sketch dir is written."""
    opts = opts or SketchOptions()
    host = engine(device, shuf)
    dev = resolve_device(device)
    p = shuf.params
    tables = accept_tables(shuf, dev) if sketch.on_device_path(shuf) \
        and not host else None

    koc = opts.abundance
    if koc and any(seqio.sniff_format(f) != "fastq" for f in inputs):
        # reference closes abundance mode on non-fastq input
        # (command_dist.c:390-393)
        koc = False
        opts = dataclasses.replace(opts, abundance=False)

    # --mesh keeps every file on its own sharded sketch, as the JAX
    # package does (metakssd_tpu/pipeline.py:406-408)
    batchable = (len(inputs) > 1 and not opts.pipecmd and
                 opts.mesh <= 1 and
                 (not koc or
                  all(seqio.sniff_format(f) == "fastq" for f in inputs)))
    ckpt_dir = os.path.join(out_dir, ".stage1_ckpt") if opts.ckpt else None
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)

    def resumed(i: int):
        if not ckpt_dir:
            return None
        return _load_file_ckpt(_file_ckpt_path(ckpt_dir, i), inputs[i],
                               _file_ckpt_params(inputs[i], shuf, opts))

    def persist(i: int, sets) -> None:
        if ckpt_dir:
            _save_file_ckpt(_file_ckpt_path(ckpt_dir, i), inputs[i], sets,
                            _file_ckpt_params(inputs[i], shuf, opts))

    TIMER.count("stage1.files", len(inputs))
    with TIMER.stage("stage1.sketch"):
        per_genome: list = [resumed(i) for i in range(len(inputs))]
        if batchable:
            todo = [i for i, g in enumerate(per_genome) if g is None]
            group = CKPT_GROUP if ckpt_dir else len(todo)
            for lo in range(0, len(todo), max(group, 1)):
                idx = todo[lo:lo + group]
                got = _batched_stage1([inputs[i] for i in idx], shuf, opts,
                                      dev, tables, host)
                for i, sets in zip(idx, got):
                    per_genome[i] = sets
                    persist(i, sets)
        else:
            for i, path in enumerate(inputs):
                if per_genome[i] is not None:
                    continue
                sck = (os.path.join(ckpt_dir, f"stream{i}.ckpt")
                       if ckpt_dir else None)
                per_genome[i] = sketch_file(path, shuf, opts, dev, tables,
                                            ckpt_file=sck, host=host)
                persist(i, per_genome[i])

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
    if ckpt_dir and os.path.isdir(ckpt_dir):
        # the combined sketch dir is now the durable result
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return stat
