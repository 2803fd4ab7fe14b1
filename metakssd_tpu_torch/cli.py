"""Command line of the port: the ``profile`` verb and ``dist`` (stage I,
stage II and sketch search), on a CUDA device or, explicitly, on the CPU.

    python -m metakssd_tpu_torch.cli dist -L L3K11.shuf -o markerdb genomes/
    python -m metakssd_tpu_torch.cli profile -L L3K11.shuf -r markerdb \\
        -o out sample.fastq
    python -m metakssd_tpu_torch.cli dist -L K8S5L2.shuf -o refco genomes/
    python -m metakssd_tpu_torch.cli dist -r refco -o out qryco
    python -m metakssd_tpu_torch.cli dist -r refco -o refmco \\
        --component_sz 6

Flags follow ``metakssd_tpu.cli`` (and so the reference wrappers,
command_dist_wrapper.c:32-96).  ``--device`` is ``cuda`` (default) or
``cpu``; ``cpu`` runs the plain PyTorch version of every kernel.  Options
whose paths are not ported yet raise NotImplementedError naming their
ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys


def _shuf(args):
    """The ``-L`` shuffle, with ``--component_sz`` applied as
    ``metakssd_tpu.cli`` applies it.  Only a ``.shuf`` path is ported."""
    import dataclasses
    from metakssd_tpu.formats.shuf import DimShuffle, read_shuf
    if not args.DimRdcLevel or not os.path.isfile(args.DimRdcLevel):
        raise NotImplementedError(
            "-L takes a .shuf path in metakssd_tpu_torch; a level number "
            "(or no -L) is not ported yet (ROADMAP.md, port queue item 9)")
    shuf = read_shuf(args.DimRdcLevel)
    if args.component_sz is not None:
        shuf = DimShuffle(dataclasses.replace(
            shuf.params, component_sz=args.component_sz), shuf.shuffled_dim)
    return shuf


def _cmd_dist(args) -> int:
    """The branches of ``metakssd_tpu.cli._cmd_dist`` (cli.py:42-139):
    stage I, stage II, stage I + II, search and sketch-then-search (not
    the combination of several sketch dirs)."""
    from metakssd_tpu.formats import mco as mco_fmt
    from metakssd_tpu.formats.costat import CO_DSTAT, MCO_DSTAT
    from metakssd_tpu.io import native as native_io
    from metakssd_tpu.pipeline import SketchOptions, organize_infiles
    from metakssd_tpu_torch import dist, pipeline

    native_io.set_threads(args.threadN)
    opts = SketchOptions(
        abundance=args.abundance, min_occ=args.LstKmerOcrs,
        min_qual=args.quality, byread=args.byread, pipecmd=args.pipecmd,
        threads=args.threadN, mesh=args.mesh, ckpt=args.ckpt)
    pipeline.check_supported(opts)

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
            if tmp_q is not None:
                shutil.rmtree(tmp_q, ignore_errors=True)
        return 0

    if queries and has(queries[0], CO_DSTAT):
        if len(queries) > 1:
            raise NotImplementedError(
                "combining sketch dirs is not ported to metakssd_tpu_torch "
                "yet (ROADMAP.md, port queue item 6)")
        # stage II of a sketch dir given as the query
        mco_fmt.build_mco(queries[0], outdir, component_sz=args.component_sz)
        return 0
    shuf = _shuf(args)
    inputs = organize_infiles(queries, args.list)
    if not inputs:
        sys.exit("please specify the input/query files")
    pipeline.run_stage1(inputs, shuf, outdir, opts, device=args.device)
    return 0


def _cmd_profile(args) -> int:
    """fastq -> sketch -A -> composite -> poisson as one timed flow."""
    from metakssd_tpu.io import native as native_io
    from metakssd_tpu.pipeline import SketchOptions
    from metakssd_tpu_torch import profile_e2e

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


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs the CUDA kernels; cpu runs their plain "
                        "PyTorch versions (default cuda)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="metakssd_tpu_torch",
        description="KSSD sketching and metagenomic profiling on a GPU")
    sub = ap.add_subparsers(dest="command", required=True)

    di = sub.add_parser("dist", help="sketch / build db / search")
    di.add_argument("-p", "--threadN", type=int, default=0)
    di.add_argument("-l", "--list", default=None)
    di.add_argument("-L", "--DimRdcLevel", default=None,
                    help=".shuf path (needed where the command sketches)")
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
    di.add_argument("-P", "--pipecmd", default="")
    di.add_argument("--keepskf", action="store_true")
    di.add_argument("-f", "--skf", default="")
    di.add_argument("--byread", action="store_true")
    di.add_argument("--shard-db", type=int, default=0, dest="shard_db",
                    help="1: count postings by expansion on the device")
    di.add_argument("--mesh", type=int, default=0)
    di.add_argument("--ckpt", action="store_true")
    di.add_argument("--component_sz", type=int, default=None,
                    help="mco dense row space = 16^N (default 8)")
    _add_device(di)
    di.add_argument("query", nargs="*")
    di.set_defaults(func=_cmd_dist)

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
    pf.add_argument("--mesh", type=int, default=0)
    pf.add_argument("--ckpt", action="store_true")
    pf.add_argument("--shard-db", type=int, default=0, dest="shard_db")
    pf.add_argument("--cami", nargs=2,
                    metavar=("PSID2NCBI_TSV", "NODES_TSV"), default=None,
                    help="also write a CAMI-format profile")
    _add_device(pf)
    pf.add_argument("query", nargs="+", help="fastq(.gz) sample files")
    pf.set_defaults(func=_cmd_profile)
    return ap


def main(argv: list[str] | None = None) -> int:
    from metakssd_tpu.composite import wait_staging
    from metakssd_tpu.utils import TIMER
    args = build_parser().parse_args(argv)
    TIMER.reset()
    TIMER.meta["command"] = args.command
    try:
        return args.func(args)
    except (ValueError, FileNotFoundError, IsADirectoryError,
            NotADirectoryError, NotImplementedError) as e:
        print(f"metakssd_tpu_torch: {e}", file=sys.stderr)
        return 1
    finally:
        TIMER.report()
        # a first profile against a MarkerDB writes its index sidecars in
        # the background; an in-process caller gets main() back only once
        # every file of the run is on disk
        wait_staging()


if __name__ == "__main__":
    sys.exit(main())
