"""MarkerDB taxonomic profiling on a device, and the host-side abv index
and search: the port of ``metakssd_tpu/composite.py``.

Profiling (``get_species_abundance``, composite.py:262-412) takes one of
two device routes.  The MarkerDB's inverted index is built as the JAX
package builds it: ``stage_markerdb`` inverts it (or mmaps its
``.mkssd_stage`` sidecars, the same files).  By default
``state.profile_index_from_staged`` moves it onto the device once per
MarkerDB, and per query the port's ``DeviceProfileIndex`` returns the
exact ``postings_group_stats`` tuple.  With ``shard_db`` N >= 1 each
component's distinct k-mers go onto N db shards as a
``parallel/mesh.ShardedMatchIndex``, K3 matches the query ids there, and
the host expands the postings and takes the statistics (the native
``postings_group_stats``, else numpy and ``_profile_stats``), as the JAX
package's ``shard_db`` route does.  On ``"host"`` (``shard_db`` 0) nothing
is staged on a device: each component's ``_CompIndex.match`` finds the
query ids by ``np.searchsorted`` and expands their postings with the
native ``postings_expand``, and ``postings_group_stats`` takes the
statistics, the JAX package's host route (``composite.py:103-125``).  The
report lines and the ``binvec`` vectors are formatted as the JAX package
formats them, byte for byte.

``index_abv``, ``abv_search`` and ``read_abv`` (``-i``, ``-s``, ``-d``)
are host work, copied from the JAX package; ``ops/dense_abv.py`` is the
device search (``--dense``).
"""

from __future__ import annotations

import glob
import math
import os
import sys
import threading
import time

import numpy as np

from metakssd_tpu_torch.device import engine, resolve_device
from metakssd_tpu_torch.formats.abv import (BINVEC_DIRNAME, AbvIndex,
                                            read_abv_file, write_abv_file)
from metakssd_tpu_torch.formats.codir import CoDir
from metakssd_tpu_torch.formats.costat import CoStat
from metakssd_tpu_torch.formats.mco import save_npy_direct
from metakssd_tpu_torch.io import native as native_io
from metakssd_tpu_torch.ops.merge import host_membership
from metakssd_tpu_torch.params import MIN_KM_S
from metakssd_tpu_torch.parallel import mesh as pmesh
from metakssd_tpu_torch.state import profile_index_from_staged
from metakssd_tpu_torch.utils import TIMER, sorted_first_idx

ST_PCTL = 0.98
ED_PCTL = 0.99


def _profile_stats(matched_ab: np.ndarray):
    """Reference per-genome statistics (command_composite.c:596-624) on a
    1-based sorted array, C-indexing semantics preserved."""
    n = matched_ab.size
    s1 = np.empty(n + 1, dtype=np.int64)
    s1[0] = n
    s1[1:] = np.sort(matched_ab)
    total = int(s1[1:].sum())
    median = int(s1[n // 2])
    p0 = int(n * ST_PCTL)
    lastsum = 0
    lastn = 0
    i = p0
    while i <= n * ED_PCTL:
        lastsum += int(s1[i])
        lastn += 1
        i += 1
    avg = np.float32(total) / np.float32(n)
    avg9899 = np.float32(lastsum) / np.float32(lastn) if lastn \
        else np.float32("nan")
    return total, avg, avg9899, median, int(s1[n])


class _CompIndex:
    """Per-component MarkerDB match index: sorted distinct reference
    k-mers ``rk``, posting offsets ``starts`` and genome rows
    ``gid_sorted`` (``state.profile_index_from_staged`` moves them onto
    the device).

    Like the reference's stage II (co2mco: invert once, search many),
    the inversion is built once and persisted as a sidecar next to the
    MarkerDB (see stage_markerdb); later profiling runs mmap it.
    """

    def __init__(self, ref_ids: np.ndarray, prow: np.ndarray,
                 staged: tuple | None = None,
                 sorted_pair: tuple | None = None):
        if staged is not None:
            self.rk, self.starts, self.gid_sorted = staged
        elif sorted_pair is not None:
            # fused native inversion already sorted (key, genome) pairs
            sk, self.gid_sorted = sorted_pair
            got = native_io.sorted_unique_pack(sk) \
                if native_io.available() else None
            if got is not None:
                self.rk, starts = got   # one fused pass: idx + gather
            else:
                starts = sorted_first_idx(sk)
                self.rk = sk[starts]
            self.starts = np.empty(self.rk.size + 1, dtype=np.int64)
            self.starts[:-1] = starts
            self.starts[-1] = sk.size
        else:
            if (native_io.available()
                    and np.asarray(ref_ids).dtype.itemsize <= 4):
                # one explicit copy of the (possibly mmap'd) key
                # stream; the caller-owned prow (np.repeat product) is
                # consumed in place when it has the right dtype/layout
                sk = np.empty(np.asarray(ref_ids).size, np.uint32)
                np.copyto(sk, ref_ids, casting="unsafe")
                gs = prow if (isinstance(prow, np.ndarray)
                              and prow.dtype == np.int32
                              and prow.flags.c_contiguous
                              and prow.flags.writeable) else \
                    np.array(prow, dtype=np.int32, order="C")
                native_io.kv_radix_sort(sk, gs)
                self.gid_sorted = gs    # cold staging: 59M postings in
            else:                       # ~2.3 s vs ~7 s argsort+gather
                order = np.argsort(ref_ids, kind="stable")
                sk = np.asarray(ref_ids)[order]
                self.gid_sorted = prow[order]
            # unique of a sorted array without np.unique's second sort
            # (parallel native boundary sweep when available)
            starts = sorted_first_idx(sk)
            self.rk = sk[starts]
            self.starts = np.empty(self.rk.size + 1, dtype=np.int64)
            self.starts[:-1] = starts
            self.starts[-1] = sk.size

    def match(self, qids_s: np.ndarray, qab_s: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray]:
        """(genome int32, abundance uint16) of every posting whose k-mer
        is among the sorted query ids ``qids_s``, with that id's abundance
        from ``qab_s``: membership by ``np.searchsorted``, the expansion by
        the native ``postings_expand`` (``--device host``)."""
        member, pos = host_membership(self.rk, qids_s)
        rows = pos[member].astype(np.int64)
        total = int((self.starts[rows + 1] - self.starts[rows]).sum())
        if total == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.uint16)
        return native_io.postings_expand(rows, self.starts, self.gid_sorted,
                                         qab_s[member], total)


_STAGE_DIRNAME = ".mkssd_stage"
_COMP_CACHE: dict = {}


def stage_markerdb(refdir: str, ref: CoDir | None = None,
                   persist: bool = True) -> list:
    """Build (or load) the per-component match indexes of a MarkerDB.

    The inverted layout (sorted distinct k-mers + posting offsets +
    genome rows) is the analogue of the reference's stage II mco build:
    computed once, persisted as .npy sidecars under
    ``refdir/.mkssd_stage/``, mmap'd afterwards.  Falls back to
    in-memory staging when refdir is not writable."""
    stat_path = os.path.join(refdir, "cofiles.stat")
    mtime = os.path.getmtime(stat_path) if os.path.exists(stat_path) else 0
    key = (os.path.abspath(refdir), mtime)
    if key in _COMP_CACHE:
        return _COMP_CACHE[key]
    ref = ref or CoDir.read(refdir, want_abund=False)
    nref = ref.stat.infile_num
    sdir = os.path.join(refdir, _STAGE_DIRNAME)
    if os.path.isdir(sdir):
        _sweep_stale_tmps(sdir)   # once per staging, not per component
    comp_idx = []
    for c in range(ref.stat.comp_num):
        if not ref.ids[c].size:
            comp_idx.append(None)
            continue
        pre = os.path.join(sdir, f"c{c}")
        try:
            if os.path.exists(pre + ".rk.npy") and \
                    os.path.getmtime(pre + ".rk.npy") >= mtime:
                staged = (np.load(pre + ".rk.npy", mmap_mode="r"),
                          np.load(pre + ".st.npy", mmap_mode="r"),
                          np.load(pre + ".gs.npy", mmap_mode="r"))
                comp_idx.append(_CompIndex(None, None, staged=staged))
                continue
        except (OSError, ValueError):
            pass
        pair = None
        if native_io.available() and \
                np.asarray(ref.ids[c]).dtype.itemsize <= 4:
            # fused inversion: no key copy, no np.repeat row array —
            # on this host those were ~5 s of single-threaded
            # first-touch page faults at GTDB scale
            pair = native_io.invert_postings(ref.ids[c], ref.index[c],
                                             nref)
        if pair is not None:
            ci = _CompIndex(None, None, sorted_pair=pair)
        else:
            lens = np.diff(ref.index[c].astype(np.int64))
            prow = np.repeat(np.arange(nref, dtype=np.int32), lens)
            ci = _CompIndex(np.asarray(ref.ids[c]), prow)
        comp_idx.append(ci)
        if persist:
            # sidecars write OFF the cold critical path: a background
            # thread streams them through the O_DIRECT sink with
            # atomic tmp+rename (readers only ever see complete
            # files), so the first profiling run doesn't wait ~3 s of
            # page-cache writeback before answering queries.
            # NON-daemon: the interpreter joins it at exit, so a short
            # CLI run still persists the sidecars instead of killing
            # the write mid-flight (the queries overlap it either way)
            t = threading.Thread(target=_persist_staged,
                                 args=(sdir, pre, ci), daemon=False)
            t.start()
            _STAGE_THREADS.append(t)
    _COMP_CACHE[key] = comp_idx
    return comp_idx


_STAGE_THREADS: list = []


def _sweep_stale_tmps(sdir: str) -> None:
    """Remove temp files from sidecar writers that died mid-write
    (save_npy_direct's tmp names are pid-suffixed; anything older than
    an hour is junk — a live writer renames within seconds)."""
    for t in glob.glob(os.path.join(sdir, "*.npy.tmp*")):
        try:
            if time.time() - os.path.getmtime(t) > 3600:
                os.remove(t)
        except OSError:
            pass


def _persist_staged(sdir: str, pre: str, ci: "_CompIndex") -> None:
    try:
        os.makedirs(sdir, exist_ok=True)
        # rk last: the load path keys on rk.npy, so its appearance
        # implies the other two sidecars are already complete
        save_npy_direct(pre + ".st.npy", ci.starts)
        save_npy_direct(pre + ".gs.npy", ci.gid_sorted)
        save_npy_direct(pre + ".rk.npy", ci.rk)
    except OSError:
        pass                   # read-only refdir: stay in-memory


def wait_staging() -> None:
    """Block until background sidecar writes finish (tests / clean
    shutdown; the atomic rename makes waiting optional for safety)."""
    while _STAGE_THREADS:
        _STAGE_THREADS.pop().join()



_INDEX_CACHE: dict = {}


def _staged_index(refdir: str, ref: CoDir, device, shard_db: int):
    """A MarkerDB's index on ``device``, built once per MarkerDB, device,
    route and shard layout: the ``DeviceProfileIndex`` (``shard_db`` 0),
    or per component a ``ShardedMatchIndex`` over ``shard_db`` db shards
    (None for an empty component)."""
    stat_path = os.path.join(refdir, "cofiles.stat")
    mesh = pmesh.make_mesh(1, shard_db, device) if shard_db else None
    key = (os.path.abspath(refdir), os.path.getmtime(stat_path), str(device),
           shard_db, mesh.key if mesh else None)
    got = _INDEX_CACHE.get(key)
    if got is None:
        with TIMER.stage("composite.stage_markerdb"):
            comp_idx = stage_markerdb(refdir, ref)
        if shard_db:
            got = [None if ci is None else pmesh.ShardedMatchIndex(
                ci.rk, ci.starts, ci.gid_sorted, mesh)
                for ci in comp_idx]
        else:
            got = profile_index_from_staged(comp_idx, ref.stat.infile_num,
                                            device)
        _INDEX_CACHE[key] = got
    return got


def get_species_abundance(refdir: str, qrydir: str, outdir: str = "./",
                          binvec: bool = False, min_km_s: int = MIN_KM_S,
                          out=None, shard_db: int = 0, *, device) -> None:
    """Profile query metagenome sketches against a MarkerDB
    (reference get_species_abundance, command_composite.c:446-649).
    ``shard_db`` N >= 1 matches on N db shards with K3 and takes the
    statistics on the host; ``"host"`` matches on the host."""
    host = engine(device) and not shard_db
    dev = resolve_device(device)
    out = out or sys.stdout
    with TIMER.stage("composite.load"):
        ref = CoDir.read(refdir, want_abund=False)
        qry = CoDir.read(qrydir)
    if qry.abund is None:
        raise ValueError("get_species_abundance(): query has not abundance")
    if qry.stat.shuf_id != ref.stat.shuf_id:
        print(f"get_species_abundance(): qry shuf_id {qry.stat.shuf_id} "
              f"not match ref shuf_id: {ref.stat.shuf_id}", file=sys.stderr)

    nref = ref.stat.infile_num
    if host:
        with TIMER.stage("composite.stage_markerdb"):
            index = stage_markerdb(refdir, ref)
    else:
        index = _staged_index(refdir, ref, dev, shard_db)
    TIMER.count("composite.queries", qry.stat.infile_num)
    TIMER.count("composite.refs", nref)

    for qn in range(qry.stat.infile_num):
        _t0 = time.perf_counter()  # per-query match+stats+write, summed
        pcq = []
        for c in range(ref.stat.comp_num):
            qids = qry.genome_ids(c, qn)
            qab = qry.genome_abund(c, qn)
            order = np.argsort(qids, kind="stable")
            pcq.append((qids[order], qab[order]))
        if shard_db or host:
            # K3 (or the host) matches each component's ids; the host
            # expands the postings and takes the statistics
            matched = [index[c].match(qids_s, qab_s)
                       for c, (qids_s, qab_s) in enumerate(pcq)
                       if qids_s.size and index[c] is not None]
            all_g = (np.concatenate([g for g, _ in matched]) if matched
                     else np.zeros(0, np.int32))
            all_ab = (np.concatenate([a for _, a in matched]) if matched
                      else np.zeros(0, np.uint16))
            stats = native_io.postings_group_stats(all_g, all_ab, nref,
                                                   ST_PCTL, ED_PCTL)
        else:
            stats = index.group_stats(pcq, ST_PCTL, ED_PCTL)
        if stats is not None:
            counts, sums, lastsum, lastn, median_a, max_a = stats

            def stats_for(rn_i: int):
                tot = int(sums[rn_i])
                cnt = int(counts[rn_i])
                ln = int(lastn[rn_i])
                # float32 divisions here so rounding matches the
                # reference; cnt == 0 -> NaN on purpose (its 0/0)
                with np.errstate(invalid="ignore", divide="ignore"):
                    avg = np.float32(tot) / np.float32(cnt)
                avg9899 = (np.float32(int(lastsum[rn_i])) / np.float32(ln)
                           if ln else np.float32("nan"))
                return tot, avg, avg9899, int(median_a[rn_i]), \
                    int(max_a[rn_i])
        else:
            # no host library: group the matched abundances by genome once
            counts = np.bincount(all_g, minlength=nref).astype(np.int64)
            gorder = np.argsort(all_g, kind="stable")
            ab_sorted = all_ab[gorder]
            gstarts = np.searchsorted(all_g[gorder],
                                      np.arange(nref + 1, dtype=np.int64))

            def stats_for(rn_i: int):
                return _profile_stats(
                    ab_sorted[gstarts[rn_i]:gstarts[rn_i + 1]]
                    .astype(np.int64))

        # sort refs by shared count desc, ties stable (glibc mergesort)
        order = np.argsort(-counts, kind="stable")
        binvecs: list[tuple[int, np.float32]] = []
        binvec_sum = np.float32(0.0)
        for rn_i in order:
            kmer_num = int(counts[rn_i])
            if kmer_num < min_km_s:
                break
            total, avg, avg9899, median, mx = stats_for(int(rn_i))
            if binvec:
                if median > 1 and kmer_num > min_km_s + 1:
                    binvecs.append((int(rn_i), avg9899))
                    binvec_sum += avg9899
            else:
                out.write(f"{qry.stat.names[qn]}\t{ref.stat.names[rn_i]}\t"
                          f"{kmer_num}\t{avg:f}\t{avg9899:f}\t{median}\t"
                          f"{mx}\n")
        if binvec:
            num_pass = len(binvecs)
            idxs = np.array([b[0] for b in binvecs], dtype=np.int32)
            pcts = np.array([b[1] for b in binvecs], dtype=np.float32)
            pcts = (pcts - np.float32(1.0)) * np.float32(100.0) / \
                (binvec_sum - np.float32(num_pass))
            if outdir and len(outdir) >= 3:
                vdir = outdir
            else:
                vdir = os.path.join(refdir, BINVEC_DIRNAME)
            os.makedirs(vdir, exist_ok=True)
            base = os.path.basename(qry.stat.names[qn])
            write_abv_file(os.path.join(vdir, base + ".abv"), idxs, pcts)
        TIMER.stages.append(("composite.profile", time.perf_counter() - _t0))


# --------------------------------------------------------------------------
# abv index + search (host work)
# --------------------------------------------------------------------------

def index_abv(refdir: str, abv_dir: str | None = None,
              file_order: list[str] | None = None) -> AbvIndex:
    """Build the abundance-vector column index
    (reference index_abv, command_composite.c:351-438).

    File order defaults to sorted names (the reference uses readdir
    order, which is filesystem-dependent); pass file_order to replicate a
    specific enumeration.
    """
    ref_stat = CoStat.read(refdir)
    adir = abv_dir or os.path.join(refdir, BINVEC_DIRNAME)
    names = file_order or sorted(
        f for f in os.listdir(adir) if f.endswith(".abv"))
    nspecies = ref_stat.infile_num
    y_l2n = np.zeros(len(names))
    cat_idx, cat_pct, cat_si = [], [], []
    for si, fname in enumerate(names):
        idxs, pcts = read_abv_file(os.path.join(adir, fname))
        # sequential (not pairwise) double accumulation, matching the
        # reference's per-record loop (command_composite.c:393-395)
        sq = (pcts.astype(np.float64) ** 2)
        y_l2n[si] = math.sqrt(float(sq.cumsum()[-1]) if sq.size else 0.0)
        cat_idx.append(idxs.astype(np.int64))
        cat_pct.append(pcts.astype(np.float32))
        cat_si.append(np.full(idxs.size, si, dtype=np.int32))
    cat_idx = np.concatenate(cat_idx) if cat_idx else np.zeros(0, np.int64)
    cat_pct = np.concatenate(cat_pct) if cat_pct else np.zeros(0, np.float32)
    cat_si = np.concatenate(cat_si) if cat_si else np.zeros(0, np.int32)
    # stable sort by species dim keeps file order within each posting
    # list — the reference's append order (command_composite.c:393-401)
    order = np.argsort(cat_idx, kind="stable")
    counts = np.bincount(cat_idx, minlength=nspecies).astype(np.int32)
    index = AbvIndex(names=names, y_l2n=y_l2n,
                     abmi=np.cumsum(counts).astype(np.int32),
                     abm_idx=cat_si[order], abm_pct=cat_pct[order])
    index.write(refdir)
    return index


def abv_search(refdir: str, queries: list[str], mode: int = 0,
               out=None) -> None:
    """Search abundance vectors (reference abv_search,
    command_composite.c:217-348).  mode: 0 cosine, 1 L1, 2 L2."""
    out = out or sys.stdout
    idx = AbvIndex.read(refdir)
    nsamples = len(idx.names)
    starts = np.concatenate([[0], idx.abmi]).astype(np.int64)
    names_arr = np.asarray(idx.names, dtype=object)
    names_blob, names_off = native_io.names_blob(idx.names)

    for qpath in queries:
        if not qpath.endswith(".abv"):
            print(f"argument {qpath} is not a .abv file, skipped")
            continue
        if "/" not in qpath:
            qpath2 = os.path.join(refdir, BINVEC_DIRNAME, qpath)
        else:
            qpath2 = qpath
        qidx, qpct = read_abv_file(qpath2)
        measure = np.full(nsamples, np.float32(-2.0), dtype=np.float32)
        xsum = np.zeros(nsamples, dtype=np.float32)
        ysum = np.zeros(nsamples, dtype=np.float32)
        # vectorised posting-list walk: expand every (query dim ->
        # posting) pair; np.add.at accumulates in input (= query-dim)
        # order in float32, bit-identical to the reference's loop
        qpct32 = qpct.astype(np.float32)
        xl2n = np.float32(0.0)
        for x in qpct32.tolist():          # sequential f32 accumulation
            xl2n += np.float32(x) * np.float32(x)
        lo = starts[qidx]
        hi = starts[qidx.astype(np.int64) + 1]
        lens = hi - lo
        total = int(lens.sum())
        bnd = np.zeros(qidx.size, dtype=np.int64)
        np.cumsum(lens[:-1], out=bnd[1:])
        pos = (np.arange(total, dtype=np.int64)
               - np.repeat(bnd, lens) + np.repeat(lo, lens))
        sids_all = idx.abm_idx[pos].astype(np.int64)
        ys_all = idx.abm_pct[pos]
        xs_all = np.repeat(qpct32, lens)
        # first-appearance order (the reference reports samples in the
        # order they are first touched): O(postings) min-scatter of the
        # touch position instead of an O(n log n) unique sort
        first = np.full(nsamples, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(first, sids_all, np.arange(total, dtype=np.int64))
        touched = first != np.iinfo(np.int64).max
        ids = np.flatnonzero(touched)
        ids = ids[np.argsort(first[ids], kind="stable")]
        measure[touched] = 0.0
        if mode == 1:
            np.add.at(measure, sids_all,
                      np.abs(ys_all.astype(np.float64)
                             - xs_all.astype(np.float64)).astype(np.float32))
            np.add.at(xsum, sids_all, xs_all)
            np.add.at(ysum, sids_all, ys_all)
        elif mode == 2:
            np.add.at(measure, sids_all, (ys_all - xs_all) ** 2)
        else:
            np.add.at(measure, sids_all, ys_all * xs_all)
        if mode == 0:
            # double-precision normalisation, then one rounding to f32
            # (reference: measure / (sqrt(xl2n) * y_l2n), y_l2n double)
            measure[ids] = (measure[ids].astype(np.float64)
                            / (math.sqrt(float(xl2n))
                               * idx.y_l2n[ids])).astype(np.float32)
        out.write("#Sample\t")
        if mode == 1:
            measure[ids] += (np.float32(200.0) - xsum[ids] - ysum[ids])
            order = ids[np.argsort(measure[ids], kind="stable")]
            out.write("L1norm\n")
            vals = measure[order]
        elif mode == 2:
            order = ids[np.argsort(measure[ids], kind="stable")]
            out.write("L2norm\n")
            vals = np.sqrt(measure[order].astype(np.float64))
        else:
            order = ids[np.argsort(measure[ids], kind="stable")][::-1]
            out.write("CosineXY\n")
            vals = measure[order]
        # bulk C-level formatting; per-line Python f-strings are the hot
        # loop when a query touches most samples (the reference prints
        # the same lines with printf, command_composite.c:322-346)
        native_io.write_name_float_lines(out, names_arr, names_blob,
                                         names_off, order, vals)


def read_abv(path: str, out=None) -> None:
    out = out or sys.stdout
    idxs, pcts = read_abv_file(path)
    for i, p in zip(idxs.tolist(), pcts.tolist()):
        out.write(f"{i}\t{np.float32(p):f}\n")
