"""Sketch search on a device: the port of ``metakssd_tpu/dist.py``.

For every query sketch and every reference, the number of shared k-mers
(the ``sharedk_ct.dat`` matrix), then ``distance.out``.  Against a sketch
dir, each component's sorted distinct reference k-mers are staged on the
device once (``state.haystack_from_inverted``) and each query's sorted
k-mers are searched in them by K3 (``ops/merge.py``); the matched rows'
postings are counted on the host.  Against an mco dir the counts come
from the JAX package's own host mmap route, which runs no kernel.  The
options, the statistics and the file formats are the JAX package's,
imported: ``distance.out`` and ``sharedk_ct.dat`` are byte-identical to
``metakssd_tpu.dist.run_dist_search``'s.
"""

from __future__ import annotations

import os

import numpy as np

from metakssd_tpu.dist import (_EXPAND_CHUNK, DistOptions, _check_compat,
                               _shared_counts_mco, load_sharedk,
                               save_sharedk, write_distance_out)
from metakssd_tpu.formats import mco as mco_fmt
from metakssd_tpu.formats.codir import CoDir
from metakssd_tpu.formats.costat import CoStat, McoStat
from metakssd_tpu.io import native as native_io
from metakssd_tpu.utils import TIMER

from metakssd_tpu_torch.device import resolve_device
from metakssd_tpu_torch.ops import merge
from metakssd_tpu_torch.state import haystack_from_inverted

__all__ = ["DistOptions", "run_dist_search", "shared_kmer_matrix"]


def _is_mco(path) -> bool:
    return isinstance(path, str) and \
        os.path.exists(os.path.join(path, "mcofiles.stat"))


def _count_postings(rows: np.ndarray, offs: np.ndarray, gids: np.ndarray,
                    num_refs: int) -> np.ndarray:
    """uint32 [num_refs]: postings per genome over the matched rows, a
    row counted once per occurrence.  The shared native pass, or numpy
    in chunks of bounded scratch (``metakssd_tpu/dist.py:96-124``)."""
    acc = np.zeros(num_refs, dtype=np.uint32)
    if native_io.postings_count(rows, offs, gids, acc):
        return acc
    lo = 0
    while lo < rows.size:
        hi = lo
        budget = _EXPAND_CHUNK
        while hi < rows.size and budget > 0:
            budget -= int(offs[rows[hi] + 1] - offs[rows[hi]])
            hi += 1
        rch = rows[lo:hi]
        starts, ends = offs[rch], offs[rch + 1]
        lens = ends - starts
        total = int(lens.sum())
        lo = hi
        if total == 0:
            continue
        bnd = np.zeros(rch.size, dtype=np.int64)
        np.cumsum(lens[:-1], out=bnd[1:])
        flat = (np.arange(total, dtype=np.int64)
                - np.repeat(bnd, lens) + np.repeat(starts, lens))
        acc += np.bincount(gids[flat], minlength=num_refs).astype(np.uint32)
    return acc


def shared_kmer_matrix(ref: CoDir | str, qry: CoDir | str, *, device,
                       out: np.ndarray | None = None) -> np.ndarray:
    """uint32 [qry_num, ref_num] shared-k-mer counts
    (``metakssd_tpu.dist.shared_kmer_matrix``).  ``ref`` is a sketch dir
    or an mco dir; ``out`` may be a preallocated (memory-mapped) matrix
    that the counts are added into."""
    if isinstance(qry, str):
        qry = CoDir.read(qry, want_abund=False)
    if _is_mco(ref):
        mstat = McoStat.read(ref)
        _check_compat(mstat.shuf_id, mstat.comp_num, qry.stat)
        return _shared_counts_mco(ref, qry, mstat, out)
    if isinstance(ref, str):
        ref = CoDir.read(ref, want_abund=False)
    _check_compat(ref.stat.shuf_id, ref.stat.comp_num, qry.stat)
    dev = resolve_device(device)
    num_refs = ref.stat.infile_num
    if out is None:
        out = np.zeros((qry.stat.infile_num, num_refs), dtype=np.uint32)
    for c in range(ref.stat.comp_num):
        inv = mco_fmt.InvertedIndex.from_codir(ref, c)
        if inv.kmers.size == 0:
            continue
        hay = haystack_from_inverted(inv, dev)
        offs = inv.offsets.astype(np.int64)
        for q in range(qry.stat.infile_num):
            qids = np.sort(qry.genome_ids(c, q))
            if qids.size == 0:
                continue
            member, pos = merge.sorted_membership(hay, None, qids)
            rows = pos[member].astype(np.int64)
            out[q] += _count_postings(rows, offs, inv.gids, num_refs)
    return out


def run_dist_search(ref_path: str, qry_path: str, outdir: str,
                    opts: DistOptions | None = None, *, device,
                    shard_db: int = 0, max_mem_gb: float = 0) -> str:
    """Counts, statistics and ``distance.out``
    (``metakssd_tpu.dist.run_dist_search``).  ``shard_db`` 1 takes the
    one-device posting expansion of ``parallel/mesh.py``; ``max_mem_gb``
    > 0 accumulates a larger matrix straight into the memory-mapped
    ``sharedk_ct.dat`` (``-m``)."""
    dev = resolve_device(device)
    opts = opts or DistOptions()
    with TIMER.stage("dist.load"):
        qry = CoDir.read(qry_path, want_abund=False)
        is_mco = _is_mco(ref_path)
        rstat = McoStat.read(ref_path) if is_mco else CoStat.read(ref_path)
        ref_names, ref_ctx = rstat.names, rstat.ctx_ct
    TIMER.count("dist.queries", qry.stat.infile_num)
    TIMER.count("dist.refs", len(ref_names))
    if opts.shared_kmerpath:
        matrix = load_sharedk(opts.shared_kmerpath, qry.stat.infile_num,
                              len(ref_names))
    elif shard_db >= 1 and not is_mco:
        from metakssd_tpu_torch.parallel import mesh as pmesh
        with TIMER.stage("dist.shared_counts"):
            matrix = pmesh.sharded_shared_counts(ref_path, qry, shard_db,
                                                 dev)
        skf = save_sharedk(matrix, outdir)
    else:
        qnum, rnum = qry.stat.infile_num, len(ref_names)
        os.makedirs(outdir, exist_ok=True)
        skf = os.path.join(outdir, "sharedk_ct.dat")
        if max_mem_gb > 0 and 4 * qnum * rnum > max_mem_gb * (1 << 30):
            matrix = np.memmap(skf, dtype=np.uint32, mode="w+",
                               shape=(qnum, rnum))
            matrix[:] = 0
        else:
            matrix = np.zeros((qnum, rnum), dtype=np.uint32)
        with TIMER.stage("dist.shared_counts"):
            shared_kmer_matrix(ref_path, qry, device=dev, out=matrix)
        if isinstance(matrix, np.memmap):
            matrix.flush()
        else:
            save_sharedk(matrix, outdir)
    with TIMER.stage("dist.write_output"):
        path = write_distance_out(
            matrix, ref_names, qry.stat.names, ref_ctx, qry.stat.ctx_ct,
            qry.stat.kmerlen, qry.stat.dim_rd_len, outdir, opts)
    if not opts.keep_shared_kmer and not opts.shared_kmerpath:
        os.remove(skf)
    return path
