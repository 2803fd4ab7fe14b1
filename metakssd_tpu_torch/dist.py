"""Sketch search on a device: the port of ``metakssd_tpu/dist.py``.

For every query sketch and every reference, the number of shared k-mers
(the ``sharedk_ct.dat`` matrix), then ``distance.out``.  Against a sketch
dir, each component's sorted distinct reference k-mers are staged on the
device once (``state.haystack_from_inverted``) and each query's sorted
k-mers are searched in them by K3 (``ops/merge.py``); the matched rows'
postings are counted on the host.  Against an mco dir the counts come
from the host mmap route, which runs no kernel.  That route, the
options, the statistics and the file formats are copied from the JAX
package: ``distance.out`` and ``sharedk_ct.dat`` are byte-identical to
``metakssd_tpu.dist.run_dist_search``'s.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np

from metakssd_tpu_torch.device import resolve_device
from metakssd_tpu_torch.formats import mco as mco_fmt
from metakssd_tpu_torch.formats.codir import CoDir, _mmap_or_empty
from metakssd_tpu_torch.formats.costat import CoStat, McoStat
from metakssd_tpu_torch.formats.mco import MCO_IDX_PREFIX, MCO_PREFIX
from metakssd_tpu_torch.io import native as native_io
from metakssd_tpu_torch.ops import merge
from metakssd_tpu_torch.state import haystack_from_inverted
from metakssd_tpu_torch.utils import TIMER

ALP_SIZE = 4  # DNA (reference command_dist.c:554)

# cap on expanded postings per reduction chunk (~128 MB of int64
# scratch); bounds host memory for mco rows with huge posting lists
_EXPAND_CHUNK = 16 << 20


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


def _shared_counts_mco(ref: str, qry: CoDir, mstat: McoStat,
                       out: np.ndarray | None) -> np.ndarray:
    """Shared-count matrix against a dense reference-format mco dir via
    mmap random access — exactly the reference's access shape
    (command_dist.c:1003-1049): the cumulative index row extents for the
    query's k-mers are fancy-indexed straight out of the (34 GiB at
    COMPONENT_SZ=8) memory-mapped file, so only the touched pages fault
    in; a full-index scan would read the whole file per run."""
    num_refs = mstat.infile_num
    qnum = qry.stat.infile_num
    if out is None:
        out = np.zeros((qnum, num_refs), dtype=np.uint32)
    for c in range(mstat.comp_num):
        cum = _mmap_or_empty(os.path.join(ref, f"{MCO_IDX_PREFIX}.{c}"),
                             np.uint64)
        gids = _mmap_or_empty(os.path.join(ref, f"{MCO_PREFIX}.{c}"),
                              np.uint32)
        if cum.size == 0:
            continue
        for q in range(qnum):
            qids = qry.genome_ids(c, q).astype(np.int64)
            qids = qids[qids < cum.size]       # foreign-build guard
            if qids.size == 0:
                continue
            en = np.asarray(cum[qids], dtype=np.int64)
            st = np.where(qids > 0,
                          np.asarray(cum[np.maximum(qids - 1, 0)],
                                     dtype=np.int64), 0)
            sel = en > st
            st, en = st[sel], en[sel]
            if st.size == 0:
                continue
            acc = np.zeros(num_refs, dtype=np.uint32)
            if not native_io.postings_count_ranges(st, en, gids, acc):
                lo = 0
                lens = en - st
                while lo < st.size:               # bounded scratch
                    hi = lo
                    budget = _EXPAND_CHUNK
                    while hi < st.size and budget > 0:
                        budget -= int(lens[hi])
                        hi += 1
                    total = int(lens[lo:hi].sum())
                    if total:
                        bnd = np.zeros(hi - lo, dtype=np.int64)
                        np.cumsum(lens[lo:hi - 1] if hi - lo > 1
                                  else lens[lo:lo], out=bnd[1:])
                        flat = (np.arange(total, dtype=np.int64)
                                - np.repeat(bnd, lens[lo:hi])
                                + np.repeat(st[lo:hi], lens[lo:hi]))
                        acc += np.bincount(
                            gids[flat],
                            minlength=num_refs).astype(np.uint32)
                    lo = hi
            out[q] += acc
    return out


def _check_compat(ref_shuf_id: int, ref_comp: int, qstat: CoStat) -> None:
    # diagnostics word-for-word match the reference err() texts
    # (command_dist.c:163-167) so users see the familiar hint
    if qstat.shuf_id != ref_shuf_id:
        raise ValueError(
            f"qry shuf_id: {qstat.shuf_id} not match ref shuf_id: "
            f"{ref_shuf_id}\ntry regenerate .co dir and feed -L the .shuf "
            f"file used to generate the ref database")
    if qstat.comp_num != ref_comp:
        raise ValueError(f"qry comp_num: {qstat.comp_num} not match ref "
                         f"comp_num: {ref_comp}")


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


# --------------------------------------------------------------------------
# statistics + printing (reference dist_print_nobin / output_ctrl)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DistOptions:
    metric: int = 0            # -M 0 Jaccard / 1 containment
    outfields: int = 2         # -O 0 dist / 1 +p,q / 2 +CI
    correction: bool = False   # --correction
    mut_dist_max: float = 1.0  # -D
    num_neigb: int = 0         # -N
    keep_shared_kmer: bool = False  # --keepskf
    shared_kmerpath: str = ""  # -f


_HEADER = [["Jaccard\tMashD", "P-value(J)\tFDR(J)", "Jaccard_CI\tMashD_CI"],
           ["ContainmentM\tAafD", "P-value(C)\tFDR(C)",
            "ContainmentM_CI\tAafD_CI"]]


def _cfmt(fmt: str, x) -> str:
    """printf-compatible float formatting: glibc prints the sign bit of
    NaNs ("-NAN"); Python suppresses it."""
    s = fmt % x
    if np.isnan(x) and np.signbit(x):
        return "-" + s
    return s


def _get_dist(metric_kind: int, m, kmerlen: int) -> np.float64:
    """C-semantics (IEEE, no exceptions) version of
    log(GET_MATRIC(kind, m))/kmerlen (reference command_dist.c:1636,1651)."""
    m = np.float64(m)
    with np.errstate(divide="ignore", invalid="ignore"):
        v = 1.0 / (2.0 * m) + 0.5 if metric_kind == 0 else 1.0 / m
        return np.log(v) / kmerlen


def _format_line(qname: str, rname: str, X: int, Y: int, XnY: int,
                 kmerlen: int, dim_rd_len: int, opts: DistOptions,
                 cmprsn_num: int) -> str | None:
    """One output line (reference output_ctrl, command_dist.c:1637-1674)."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        rs = np.float64(0.0)
        if opts.correction:
            x_d = np.float64(X - XnY)
            y_d = np.float64(Y - XnY)
            p_base = 1.0 - 1.0 / np.float64(ALP_SIZE) ** (kmerlen - dim_rd_len)
            px = 1.0 - p_base ** x_d
            py = 1.0 - p_base ** y_d
            rs = px * py * (x_d + y_d) / (px + py - 2 * px * py)
        tmp = np.float64((X + Y - XnY) if opts.metric == 0 else min(X, Y))
        metric = (np.float64(XnY) - rs) / tmp
        dist = _get_dist(opts.metric, metric, kmerlen)
        if dist > 1:
            dist = np.float64(1.0)
        if dist > opts.mut_dist_max:
            return None
        line = (f"{qname}\t{rname}\t{XnY}-{int(rs) if np.isfinite(rs) else 0}"
                f"|{X}|{Y}\t{_cfmt('%.6f', metric)}\t{_cfmt('%.6f', dist)}")
        if opts.outfields > 0:
            sd = np.sqrt(metric * (1 - metric) / tmp)
            pv = 0.5 * np.float64(math.erfc(metric / sd * math.sqrt(0.5)))
            line += "\t%s\t%s" % (_cfmt("%E", pv),
                                  _cfmt("%E", pv * cmprsn_num))
            if opts.outfields > 1:
                ci1 = metric - 1.96 * sd
                ci2 = metric + 1.96 * sd
                d1 = _get_dist(opts.metric, ci2, kmerlen)
                d2 = _get_dist(opts.metric, ci1, kmerlen)
                line += "\t[%s,%s]\t[%s,%s]" % tuple(
                    _cfmt("%.6f", v) for v in (ci1, ci2, d1, d2))
    return line + "\n"


def write_distance_out(matrix: np.ndarray, ref_names: list[str],
                       qry_names: list[str], ref_ctx_ct: np.ndarray,
                       qry_ctx_ct: np.ndarray, kmerlen: int,
                       dim_rd_len: int, outdir: str,
                       opts: DistOptions | None = None) -> str:
    opts = opts or DistOptions()
    os.makedirs(outdir, exist_ok=True)
    ref_num = len(ref_names)
    qry_num = len(qry_names)
    cmprsn = ref_num * qry_num
    path = os.path.join(outdir, "distance.out")
    with open(path, "w") as f:
        f.write("Qry\tRef\tShared_k|Ref_s|Qry_s")
        for i in range(opts.outfields + 1):
            f.write("\t" + _HEADER[opts.metric][i])
        f.write("\n")
        for q in range(qry_num):
            Y = int(qry_ctx_ct[q])
            row = matrix[q]
            rids = range(ref_num)
            if opts.num_neigb:
                # top-N by (uncorrected) metric, ties by ascending rid,
                # zero-metric refs dropped (reference command_dist.c:1592-1618)
                mvals = np.zeros(ref_num)
                X = ref_ctx_ct.astype(np.float64)
                XnY = row.astype(np.float64)
                with np.errstate(divide="ignore", invalid="ignore"):
                    if opts.metric == 1:
                        mvals = XnY / np.minimum(X, Y)
                    else:
                        mvals = XnY / (X + Y - XnY)
                mvals = np.nan_to_num(mvals)
                order = np.lexsort((np.arange(ref_num), -mvals))
                rids = [int(r) for r in order[:opts.num_neigb]
                        if mvals[r] > 0]
            for r in rids:
                line = _format_line(qry_names[q], ref_names[r],
                                    int(ref_ctx_ct[r]), Y, int(row[r]),
                                    kmerlen, dim_rd_len, opts, cmprsn)
                if line:
                    f.write(line)
    return path


def save_sharedk(matrix: np.ndarray, outdir: str) -> str:
    """Persist qry x ref uint32 counts as the reference's sharedk_ct.dat."""
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "sharedk_ct.dat")
    matrix.astype(np.uint32).tofile(path)
    return path


def load_sharedk(path: str, qry_num: int, ref_num: int) -> np.ndarray:
    m = np.fromfile(path, dtype=np.uint32)
    return m.reshape(qry_num, ref_num)


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
