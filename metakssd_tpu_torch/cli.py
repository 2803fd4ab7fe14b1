"""Command line of the port: every verb of ``metakssd_tpu.cli`` on a CUDA
device or, explicitly, on the CPU or the host engine.

    python -m metakssd_tpu_torch.cli shuffle -k 11 -s 6 -l 3 -o L3K11
    python -m metakssd_tpu_torch.cli dist -L L3K11.shuf -o sketches genomes/
    python -m metakssd_tpu_torch.cli set -g tax.tsv -o pans sketches
    python -m metakssd_tpu_torch.cli set -q -o uniq pans
    python -m metakssd_tpu_torch.cli set -i uniq -o markerdb pans
    python -m metakssd_tpu_torch.cli profile -L L3K11.shuf -r markerdb \\
        -o out sample.fastq
    python -m metakssd_tpu_torch.cli composite -r markerdb -q qry -b \\
        -o markerdb/abundance_Vec
    python -m metakssd_tpu_torch.cli composite -r markerdb -i
    python -m metakssd_tpu_torch.cli composite -r markerdb -s 2 --dense \\
        sample.fastq.abv
    python -m metakssd_tpu_torch.cli dist -r refco -o out qryco

Flags follow ``metakssd_tpu.cli`` (and so the reference wrappers,
command_dist_wrapper.c:32-96, command_set.c:24-68,
command_composite.c:32-63).  ``--device`` is ``cuda`` (default), ``cpu``
or ``host``: ``cpu`` runs the plain PyTorch version of every kernel,
``host`` the JAX package's native host engine where it has one and the
plain versions elsewhere (``device.py``).  The
verbs that do host work only (``shuffle``, ``reverse``, ``postprocess``,
``primer``) take no ``--device``; their handlers are copied from
``metakssd_tpu.cli``.  ``--mesh N`` sketches over N data shards and
``--shard-db N`` spreads the MarkerDB or reference over N db shards
(``parallel/mesh.py``), dealt over the visible devices.

Several processes (on one host or many) run one job when each is started
with ``MKSSD_COORDINATOR=host:port`` (rank 0's address),
``MKSSD_NPROCS`` and ``MKSSD_PROCID``: they join before the verb runs
(within ``MKSSD_COORD_TIMEOUT`` seconds, default 300, a budget for the
join alone), every process reads the same inputs, each writes the same
files, and each leaves the job when its verb ends.  The join is over gloo
and, where ``--device`` is CUDA and every rank holds a card of its own
(one rank included), also over NCCL for card tensors
(``parallel/mesh.choose_backend``); ``TIMER.meta["collectives"]`` names
the backend and ``["collective_counts"]`` the calls and bytes of each.  A
join that fails, NCCL's included, is a one-line error and exit code 1.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys


def _shuf(args):
    """The ``-L`` shuffle: a ``.shuf`` path, or one generated for a level
    number (2 without ``-L``) into ``<outdir>/default.shuf``, with
    ``--component_sz`` applied, as ``metakssd_tpu.cli`` does."""
    import dataclasses
    from metakssd_tpu_torch.formats.shuf import DimShuffle, read_shuf
    from metakssd_tpu_torch.pipeline import resolve_shuffle
    if args.DimRdcLevel and os.path.isfile(args.DimRdcLevel):
        shuf = read_shuf(args.DimRdcLevel)
    else:
        level = int(args.DimRdcLevel) if args.DimRdcLevel else 2
        shuf = resolve_shuffle(None, args.halfKmerlength, level, args.outdir,
                               seed=args.seed)
    if args.component_sz is not None:
        shuf = DimShuffle(dataclasses.replace(
            shuf.params, component_sz=args.component_sz), shuf.shuffled_dim)
    return shuf


def _cmd_shuffle(args) -> int:
    from metakssd_tpu_torch.params import SketchParams
    from metakssd_tpu_torch.formats.shuf import make_shuf, write_shuf
    if args.usedefault:
        # reference command_shuffle.c:31,94: force the prokaryote
        # defaults (k=8, s=5, l=2) regardless of other flags
        print("use default values for all options")
        args.halfKmerLen, args.halfSubstrLen, args.level = 8, 5, 2
    p = SketchParams(k=args.halfKmerLen, subk=args.halfSubstrLen,
                     drlevel=args.level)
    p.validate()
    shuf = make_shuf(p, seed=args.seed)
    write_shuf(args.outfile + ".shuf", shuf)
    print(f"kssd shuffle: shuf_id={shuf.params.shuf_id}, k = {p.k}, "
          f"halfCtxLen = {p.subk}, level= {p.drlevel}")
    return 0


def _cmd_dist(args) -> int:
    """The branches of ``metakssd_tpu.cli._cmd_dist`` (cli.py:42-139):
    stage I (``--byread``: per-read), stage II, stage I + II, search,
    sketch-then-search and the combination of several sketch dirs."""
    from metakssd_tpu_torch import dist, pipeline, setops
    from metakssd_tpu_torch.formats import mco as mco_fmt
    from metakssd_tpu_torch.formats.costat import CO_DSTAT, MCO_DSTAT
    from metakssd_tpu_torch.io import native as native_io
    from metakssd_tpu_torch.pipeline import SketchOptions, organize_infiles

    native_io.set_threads(args.threadN)
    opts = SketchOptions(
        abundance=args.abundance, dedup=args.dedup,
        min_occ=args.LstKmerOcrs, min_qual=args.quality,
        byread=args.byread, pipecmd=args.pipecmd, threads=args.threadN,
        keepcofile=args.keepcofile, mesh=args.mesh, ckpt=args.ckpt)

    def has(d, f):
        return os.path.isdir(d) and os.path.exists(os.path.join(d, f))

    ref, queries, outdir = args.reference_dir, args.query, args.outdir
    if ref:
        if has(ref, CO_DSTAT) and not has(ref, MCO_DSTAT) and not queries:
            # stage II only: invert an existing sketch dir
            mco_fmt.build_mco(ref, outdir, component_sz=args.component_sz)
        elif not has(ref, CO_DSTAT) and not has(ref, MCO_DSTAT) \
                and not queries:
            # stage I + II from sequence files
            shuf = _shuf(args)
            pipeline.run_stage1(organize_infiles([ref], args.list), shuf,
                                outdir, opts, device=args.device)
            mco_fmt.build_mco(outdir, outdir, component_sz=args.component_sz)
        elif queries:
            dopts = dist.DistOptions(
                metric=args.metric, outfields=args.outfields,
                correction=bool(args.correction),
                mut_dist_max=args.mutDist_max,
                num_neigb=args.neighborN_max, keep_shared_kmer=args.keepskf,
                shared_kmerpath=args.skf)
            qdir, tmp_q = queries[0], None
            if not has(qdir, CO_DSTAT):
                # sequence queries with -L <.shuf>: sketch, then search
                if not (args.DimRdcLevel and os.path.isfile(args.DimRdcLevel)
                        and all(os.path.isfile(q) for q in queries)):
                    sys.exit("query must be a sketch dir (run dist -L ... "
                             "<seqs> first), or pass seq files together "
                             "with -L <.shuf> to sketch-and-search")
                qdir = tmp_q = os.path.join(outdir, "qry.co")
                pipeline.run_stage1(organize_infiles(queries, args.list),
                                    _shuf(args), qdir, opts,
                                    device=args.device)
            dist.run_dist_search(ref, qdir, outdir, dopts,
                                 device=args.device, shard_db=args.shard_db,
                                 max_mem_gb=args.maxMemory)
            if tmp_q is not None and not args.keepcofile:
                shutil.rmtree(tmp_q, ignore_errors=True)
        return 0

    if queries and has(queries[0], CO_DSTAT):
        if len(queries) == 1:
            # stage II of a sketch dir given as the query
            mco_fmt.build_mco(queries[0], outdir,
                              component_sz=args.component_sz)
        else:
            setops.combine_queries(queries, outdir)
        return 0
    shuf = _shuf(args)
    inputs = organize_infiles(queries, args.list)
    if not inputs:
        sys.exit("please specify the input/query files")
    if opts.byread:
        if len(inputs) != 1:
            sys.exit("--byread takes one input file")
        pipeline.sketch_byread(inputs[0], shuf, outdir, device=args.device)
    else:
        pipeline.run_stage1(inputs, shuf, outdir, opts, device=args.device)
    return 0


def _cmd_set(args) -> int:
    """``metakssd_tpu.cli._cmd_set`` (cli.py:142-165) on ``--device``."""
    from metakssd_tpu_torch import setops
    from metakssd_tpu_torch.io import native as native_io
    native_io.set_threads(args.threads)
    dev = args.device
    if args.union:
        setops.sketch_union(args.insketch, args.outdir, device=dev)
    elif args.uniq_union:
        setops.uniq_sketch_union(args.insketch, args.outdir, device=dev)
    elif args.subtract:
        setops.sketch_operate(args.insketch, args.subtract, args.outdir,
                              intersect=False, device=dev)
    elif args.intsect:
        setops.sketch_operate(args.insketch, args.intsect, args.outdir,
                              intersect=True, device=dev)
    elif args.grouping:
        setops.grouping_genomes(args.insketch, args.grouping, args.outdir,
                                device=dev)
    elif args.combin_pan:
        setops.combine_pans([args.insketch] + (args.rest or []), args.outdir)
    elif args.print_names:
        setops.print_gnames(args.insketch)
    else:
        print("set operation use : -u, -q, -i or -s")
        return 1
    return 0


def _cmd_composite(args) -> int:
    """``metakssd_tpu.cli._cmd_composite`` (cli.py:168-192): profiling
    and the abv search (``-s``, over the index's postings, or ``--dense``)
    on ``--device``, the search's ``host`` route the JAX package's host
    walk; the abv index and ``-d`` are host work."""
    from metakssd_tpu_torch import composite
    from metakssd_tpu_torch.device import engine
    from metakssd_tpu_torch.io import native as native_io
    from metakssd_tpu_torch.ops import abv_postings, dense_abv
    native_io.set_threads(args.threads)
    if args.ref and args.query:
        kw = {} if args.min_km_s is None else {"min_km_s": args.min_km_s}
        composite.get_species_abundance(
            args.ref, args.query, outdir=args.outfile, binvec=args.binVec,
            shard_db=args.shard_db, device=args.device, **kw)
    elif args.ref and args.idxbv:
        composite.index_abv(args.ref)
    elif args.ref and args.search is not None:
        if args.dense:
            dense_abv.abv_search_dense(args.ref, args.rest or [],
                                       mode=args.search, device=args.device)
        elif engine(args.device):
            composite.abv_search(args.ref, args.rest or [],
                                 mode=args.search)
        else:
            abv_postings.abv_search_postings(
                args.ref, args.rest or [], mode=args.search,
                device=args.device)
    elif args.readabv:
        for f in args.rest or []:
            composite.read_abv(f)
    else:
        print("Usage: metakssd composite -r <ref> < mode: -q | -i | -s >")
        return 1
    return 0


def _cmd_profile(args) -> int:
    """fastq -> sketch -A -> composite -> poisson as one timed flow."""
    from metakssd_tpu_torch import profile_e2e
    from metakssd_tpu_torch.io import native as native_io
    from metakssd_tpu_torch.pipeline import SketchOptions

    native_io.set_threads(args.threadN)
    opts = SketchOptions(
        abundance=True, min_occ=args.LstKmerOcrs, min_qual=args.quality,
        threads=args.threadN, mesh=args.mesh, ckpt=args.ckpt)
    rep = profile_e2e.profile_fastq(
        args.query, args.reference_dir, args.DimRdcLevel, args.outdir,
        shkm_thr=args.shkm_thr, opts=opts,
        cami=tuple(args.cami) if args.cami else None,
        min_km_s=args.min_km_s, shard_db=args.shard_db, device=args.device)
    print(json.dumps(rep), file=sys.stderr)
    return 0


def _cmd_reverse(args) -> int:
    from metakssd_tpu_torch import reverse
    reverse.co_reverse2kmer(args.codir, args.shufFile, args.outdir,
                            byreads=args.byreads)
    return 0


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=("cuda", "cpu", "host"),
                   default="cuda",
                   help="cuda runs the CUDA kernels; cpu runs their plain "
                        "PyTorch versions on the CPU; host runs the native "
                        "C++ host engine (sketch, radix-sort unions, "
                        "postings) and numpy membership where the JAX "
                        "package runs them on a host without an "
                        "accelerator, the plain versions elsewhere, never "
                        "initialises CUDA, and fails without the host "
                        "library (default cuda)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="metakssd_tpu_torch",
        description="KSSD sketching and metagenomic profiling on a GPU")
    sub = ap.add_subparsers(dest="command", required=True)

    sh = sub.add_parser("shuffle", help="generate dimension shuffle file")
    sh.add_argument("-k", "--halfKmerLen", type=int, default=8)
    sh.add_argument("-s", "--halfSubstrLen", type=int, default=5)
    sh.add_argument("-l", "--level", type=int, default=2)
    sh.add_argument("-o", "--outfile", default="./default")
    sh.add_argument("--usedefault", action="store_true",
                    help="all options use default value (prokaryote "
                         "genomes: k=8, s=5, l=2)")
    sh.add_argument("--seed", type=int, default=None)
    sh.set_defaults(func=_cmd_shuffle)

    di = sub.add_parser("dist", help="sketch / build db / search")
    di.add_argument("-k", "--halfKmerlength", type=int, default=8)
    di.add_argument("-p", "--threadN", type=int, default=0)
    di.add_argument("-l", "--list", default=None)
    di.add_argument("-L", "--DimRdcLevel", default=None,
                    help="level int or .shuf path")
    di.add_argument("-m", "--maxMemory", type=float, default=0)
    di.add_argument("-n", "--LstKmerOcrs", type=int, default=1)
    di.add_argument("-Q", "--quality", type=int, default=0)
    di.add_argument("-r", "--reference_dir", default="")
    di.add_argument("-o", "--outdir", default=".")
    di.add_argument("-N", "--neighborN_max", type=int, default=0)
    di.add_argument("-D", "--mutDist_max", type=float, default=1.0)
    di.add_argument("-M", "--metric", type=int, default=0)
    di.add_argument("-O", "--outfields", type=int, default=2)
    di.add_argument("--correction", type=int, default=0)
    di.add_argument("-A", "--abundance", action="store_true")
    di.add_argument("-u", "--dedup", action="store_true")
    di.add_argument("--keepcofile", action="store_true")
    di.add_argument("-P", "--pipecmd", default="")
    di.add_argument("--keepskf", action="store_true")
    di.add_argument("-f", "--skf", default="")
    di.add_argument("--byread", action="store_true")
    di.add_argument("--seed", type=int, default=None)
    di.add_argument("--shard-db", type=int, default=0, dest="shard_db",
                    help="shard the reference postings over N db shards")
    di.add_argument("--mesh", type=int, default=0,
                    help="sketch each input over N data shards")
    di.add_argument("--ckpt", action="store_true")
    di.add_argument("--component_sz", type=int, default=None,
                    help="mco dense row space = 16^N (default 8)")
    _add_device(di)
    di.add_argument("query", nargs="*")
    di.set_defaults(func=_cmd_dist)

    se = sub.add_parser("set", help="lossless sketch set algebra")
    se.add_argument("-u", "--union", action="store_true")
    se.add_argument("-q", "--uniq_union", action="store_true")
    se.add_argument("-s", "--subtract", default=None, metavar="PAN")
    se.add_argument("-i", "--intsect", default=None, metavar="PAN")
    se.add_argument("-c", "--combin_pan", action="store_true")
    se.add_argument("-g", "--grouping", default=None, metavar="TSV")
    se.add_argument("-P", "--print_names", action="store_true")
    se.add_argument("-p", "--threads", type=int, default=1)
    se.add_argument("-o", "--outdir", default="./")
    _add_device(se)
    se.add_argument("insketch")
    se.add_argument("rest", nargs="*")
    se.set_defaults(func=_cmd_set)

    co = sub.add_parser("composite", help="MarkerDB profiling / abv search")
    co.add_argument("-r", "--ref", default="")
    co.add_argument("-q", "--query", default="")
    co.add_argument("-o", "--outfile", default="./")
    co.add_argument("-p", "--threads", type=int, default=1)
    co.add_argument("-b", "--binVec", action="store_true")
    co.add_argument("-i", "--idxbv", action="store_true")
    co.add_argument("-s", "--search", type=int, default=None)
    co.add_argument("-d", "--readabv", action="store_true")
    co.add_argument("--min-km-s", type=int, dest="min_km_s", default=None,
                    help="min shared k-mers to report a species (reference "
                         "MIN_KM_S macro: 6 default, 1 in the 16S build)")
    co.add_argument("--shard-db", type=int, default=0, dest="shard_db",
                    help="match the query ids (K3) over N db shards of the "
                         "MarkerDB's k-mer space")
    co.add_argument("--dense", action="store_true",
                    help="batched dense search for -s on --device (last-"
                         "ulp value differences vs the sparse path)")
    _add_device(co)
    co.add_argument("rest", nargs="*")
    co.set_defaults(func=_cmd_composite)

    pf = sub.add_parser("profile",
                        help="one-command metagenome profiling: fastq "
                             "-> sketch -A -> composite -> poisson")
    pf.add_argument("-L", "--DimRdcLevel", required=True,
                    help=".shuf used to build the MarkerDB")
    pf.add_argument("-r", "--reference_dir", required=True,
                    help="MarkerDB sketch dir")
    pf.add_argument("-o", "--outdir", default=".")
    pf.add_argument("-p", "--threadN", type=int, default=0)
    pf.add_argument("-Q", "--quality", type=int, default=0)
    pf.add_argument("-n", "--LstKmerOcrs", type=int, default=1)
    pf.add_argument("-S", "--shkm-thr", type=int, default=6,
                    dest="shkm_thr",
                    help="min shared k-mers for poisson normalization")
    pf.add_argument("--min-km-s", type=int, dest="min_km_s", default=None)
    pf.add_argument("--mesh", type=int, default=0,
                    help="sketch the sample over N data shards")
    pf.add_argument("--ckpt", action="store_true")
    pf.add_argument("--shard-db", type=int, default=0, dest="shard_db",
                    help="shard the MarkerDB k-mer space over N db shards")
    pf.add_argument("--cami", nargs=2,
                    metavar=("PSID2NCBI_TSV", "NODES_TSV"), default=None,
                    help="also write a CAMI-format profile")
    _add_device(pf)
    pf.add_argument("query", nargs="+", help="fastq(.gz) sample files")
    pf.set_defaults(func=_cmd_profile)

    rv = sub.add_parser("reverse", help="sketch -> k-mer strings")
    rv.add_argument("-L", "--shufFile", required=True)
    rv.add_argument("-o", "--outdir", default=".")
    rv.add_argument("-p", "--threads", type=int, default=1)
    rv.add_argument("-b", "--byreads", action="store_true")
    rv.add_argument("codir")
    rv.set_defaults(func=_cmd_reverse)

    pr = sub.add_parser("primer", help=argparse.SUPPRESS)
    pr.set_defaults(func=_cmd_primer)

    pp = sub.add_parser("postprocess",
                        help="ports of the reference Perl toolchain")
    pps = pp.add_subparsers(dest="pp_command", required=True)
    po = pps.add_parser("poisson", help="Poisson relative abundance")
    po.add_argument("composite_tsv")
    po.add_argument("--shkm-thr", type=int, default=6)
    po.set_defaults(func=_cmd_pp_poisson)
    ca = pps.add_parser("cami", help="CAMI profile format conversion")
    ca.add_argument("composite_tsv")
    ca.add_argument("psid2ncbi_tsv")
    ca.add_argument("nodes_tsv")
    ca.add_argument("--shkm-thr", type=float, default=18)
    ca.add_argument("--low-thr", type=float, default=1)
    ca.set_defaults(func=_cmd_pp_cami)
    kr = pps.add_parser("krona", help="psid_species -> Krona taxonomy")
    kr.add_argument("psid_species_tsv")
    kr.add_argument("gtdb_taxonomy_tsv")
    kr.set_defaults(func=_cmd_pp_krona)
    am = pps.add_parser("abv-metadata",
                        help="join abv-search output with run metadata")
    am.add_argument("abv_out_tsv")
    am.add_argument("metadata_csv")
    am.set_defaults(func=_cmd_pp_abvmeta)
    cs = pps.add_parser("csv-subset",
                        help="rows of a csv whose id is in a selection "
                             "list (csv order)")
    cs.add_argument("csv")
    cs.add_argument("selection_tsv")
    cs.set_defaults(func=_cmd_pp_csv_subset)
    ocs = pps.add_parser("ordcsv-subset",
                         help="csv rows in selection order; ==no match== "
                              "for absent ids")
    ocs.add_argument("csv")
    ocs.add_argument("selection_tsv")
    ocs.set_defaults(func=_cmd_pp_ordcsv_subset)
    return ap


def _cmd_primer(args) -> int:
    """Hidden dev utility: largest prime below each power of two
    (reference global_wrapper.c:95-97, global_basic.c:424), via
    deterministic Miller-Rabin for 64-bit range."""
    def is_prime(n: int) -> bool:
        if n < 2:
            return False
        for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
            if n % p == 0:
                return n == p
        d, r = n - 1, 0
        while d % 2 == 0:
            d //= 2
            r += 1
        for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
            x = pow(a, d, n)
            if x in (1, n - 1):
                continue
            for _ in range(r - 1):
                x = x * x % n
                if x == n - 1:
                    break
            else:
                return False
        return True

    for w in range(8, 52):
        n = (1 << w) - 1
        while not is_prime(n):
            n -= 1
        print(n)
    return 0


def _cmd_pp_poisson(args) -> int:
    from metakssd_tpu_torch.postprocess import poisson
    with open(args.composite_tsv) as f:
        poisson.poisson_abundance(f, shkm_thr=args.shkm_thr)
    return 0


def _cmd_pp_cami(args) -> int:
    from metakssd_tpu_torch.postprocess import cami
    n2r, n2p, n2n = cami.load_nodes(args.nodes_tsv)
    with open(args.composite_tsv) as f:
        cami.composite_to_cami_profile(
            f, cami.load_psid_map(args.psid2ncbi_tsv), n2r, n2p, n2n,
            shkm_thr=args.shkm_thr, low_thr=args.low_thr)
    return 0


def _cmd_pp_krona(args) -> int:
    from metakssd_tpu_torch.postprocess import cami
    with open(args.psid_species_tsv) as a, open(args.gtdb_taxonomy_tsv) as b:
        cami.krona_taxonomy(a, list(b))
    return 0


def _cmd_pp_abvmeta(args) -> int:
    from metakssd_tpu_torch.postprocess import cami
    with open(args.abv_out_tsv) as a, open(args.metadata_csv) as b:
        cami.abv_match_metadata(a, b)
    return 0


def _cmd_pp_csv_subset(args) -> int:
    from metakssd_tpu_torch.postprocess import csvutil
    with open(args.csv) as c, open(args.selection_tsv) as s:
        csvutil.csv_table_subset(c, s)
    return 0


def _cmd_pp_ordcsv_subset(args) -> int:
    from metakssd_tpu_torch.postprocess import csvutil
    with open(args.csv) as c, open(args.selection_tsv) as s:
        csvutil.ordcsv_table_subset(c, s)
    return 0


def main(argv: list[str] | None = None) -> int:
    from metakssd_tpu_torch.composite import wait_staging
    from metakssd_tpu_torch.utils import TIMER
    args = build_parser().parse_args(argv)
    joined = False
    if os.environ.get("MKSSD_COORDINATOR"):
        # a multi-process launch: join before any device work; a dead or
        # malformed coordinator is a one-line error, not a hang
        from metakssd_tpu_torch.device import engine, resolve_device
        from metakssd_tpu_torch.parallel import mesh as pmesh
        device = getattr(args, "device", None)
        try:
            # the host engine's ranks join as the CPU's do (gloo)
            joined = pmesh.init_distributed(
                device=resolve_device(device) if engine(device) else device)
        except RuntimeError as e:
            print(f"metakssd_tpu_torch: {e}", file=sys.stderr)
            return 1
    TIMER.reset()
    TIMER.meta["command"] = args.command
    if joined:
        TIMER.meta["collectives"] = pmesh.collectives_backend()
        pmesh.reset_collectives()
    rc = 1
    try:
        rc = args.func(args)
        return rc
    except (ValueError, FileNotFoundError, IsADirectoryError,
            NotADirectoryError) as e:
        print(f"metakssd_tpu_torch: {e}", file=sys.stderr)
        return 1
    finally:
        if joined:
            TIMER.meta["collective_counts"] = dict(pmesh.COLLECTIVES)
        TIMER.report()
        # a first profile against a MarkerDB writes its index sidecars in
        # the background; an in-process caller gets main() back only once
        # every file of the run is on disk
        wait_staging()
        if joined:
            pmesh.leave_distributed(rc == 0)


if __name__ == "__main__":
    sys.exit(main())
