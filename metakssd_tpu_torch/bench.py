"""The port's benchmark: the legs of the root ``bench.py`` on one device.

    python -m metakssd_tpu_torch.bench [--device cuda|cuda:N|cpu] [--e2e]

Prints ONE JSON line of the root bench's shape,

    {"metric": "fastq_sketch_reads_per_s", "value": N, "unit": "reads/s",
     "vs_baseline": N, "extra": {...}}

with ``--e2e`` the root bench's ``e2e_profile_latency_s`` line instead.
Each leg runs in a fresh process of its own under MKSSD_BENCH_TIMEOUT
seconds, and repeats its measurement MKSSD_BENCH_REPS times: ``extra``
keeps the best repeat under the root bench's key and every repeat beside
it as ``<key>_runs``.

* sketch: ``pipeline.run_stage1`` of the fastq with abundance (``dist -A``)
  on ``--device`` -> ``value`` (reads/s, every repeat in
  ``reads_per_s_runs``), and the same on the native host engine
  (``--device host``) -> ``cpu_reads_per_s``: the root bench's
  ``cpu_reads_per_s`` ran ``run_stage1`` under ``MKSSD_BACKEND=cpu``,
  which is that engine;
* kernel: ``ops/kernel_bench.kernel_chain_mwin`` -> ``kernel_mwin_per_s``
  (2^24 windows a dispatch; on the CPU, where K1's plain version runs,
  2^14);
* profile: ``composite.get_species_abundance`` of the fastq's sketch
  against the synthetic MarkerDB -> ``profile_latency_s``;
* abv: ``composite.abv_search`` mode 2 (the sparse host route) ->
  ``abv_queries_per_s``, and ``ops/dense_abv.abv_search_dense`` on
  ``--device`` -> ``abv_dense_queries_per_s`` (the root bench ran dense
  only on a TPU, and reported the larger of the two as
  ``abv_queries_per_s``; here each route keeps its own key);
* e2e: ``profile_e2e.profile_fastq`` once cold (index sidecars removed)
  -> ``e2e_cold_total_s``, then steady -> ``e2e_total_s`` and the best
  repeat's ``e2e_stages``;
* e2e_host: the e2e leg on the host engine, as the root bench's e2e
  worker ran on a host without a TPU -> ``cpu_e2e_total_s``,
  ``cpu_e2e_cold_total_s`` and ``cpu_e2e_stages`` (not with ``--e2e``).

The inputs are the root bench's, byte for byte, from the same seeds: the
fastq (``default_rng(7)``, a 2 Mbp genome, MKSSD_BENCH_READS x 100 bp
reads), the L3K11 shuffle of seed 1234, the MarkerDB (``default_rng(21)``,
MKSSD_BENCH_SPECIES species of 3000 random ids and up to 500 of the
query's) and the abv corpus (``default_rng(5)``, 4096 samples over 64
species, 64 queries).  They are made once into MKSSD_BENCH_CACHE
(``.bench_cache_torch/`` at the repository root by default).

Where MKSSD_REFERENCE names the reference C tool's sources and they
build, each leg also times the tool on the same files
(``ref_reads_per_s`` and the ``*_ref_*`` keys) and ``vs_baseline`` is
``value`` over ``ref_reads_per_s``.  Unset, nothing outside the
repository is read: no ``ref_*`` key, and ``vs_baseline`` is 0.0.

``--device cuda`` without a card exits 1 and prints no number, and so does
a leg that fails or passes its timeout: nothing falls back to the CPU.
``extra.device`` names what ran the legs: the card's name and power limit
as ``nvidia-smi`` gives them, or ``cpu``; the host engine's legs ran on
the same machine's CPU.  ``extra.launches`` has each leg's kernel launches
(``ops/_build.LAUNCHES``, nonzero entries) and ``extra.host_library``
the host library's build (``io/native.build_kind``: ``serial`` where
``-fopenmp`` fails, as on the card's host).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.environ.get("MKSSD_BENCH_CACHE",
                       os.path.join(REPO, ".bench_cache_torch"))
REFERENCE = os.environ.get("MKSSD_REFERENCE", "")

N_READS = int(os.environ.get("MKSSD_BENCH_READS", 200_000))
READ_LEN = 100
REPS = int(os.environ.get("MKSSD_BENCH_REPS", 3))
WORKER_TIMEOUT = int(os.environ.get("MKSSD_BENCH_TIMEOUT", 1500))
N_SPECIES = int(os.environ.get("MKSSD_BENCH_SPECIES", 4096))
IDS_PER_SPECIES = 3000
KERNEL_WINDOWS = 1 << 24          # windows a dispatch of the kernel leg
CPU_KERNEL_WINDOWS = 1 << 14      # the same where K1's plain version runs
ABV_SPECIES, ABV_SAMPLES, ABV_QUERIES = 64, 4096, 64


class LegFailed(RuntimeError):
    """A leg exited nonzero, printed no result or passed its timeout."""


# --------------------------------------------------------------------------
# inputs (the root bench's files)
# --------------------------------------------------------------------------

def _prepare() -> tuple[str, str]:
    """The sample fastq and the L3K11 shuffle."""
    from metakssd_tpu_torch.formats.shuf import make_shuf, write_shuf
    from metakssd_tpu_torch.params import SketchParams
    os.makedirs(CACHE, exist_ok=True)
    fq = os.path.join(CACHE, f"sample_{N_READS}.fq")
    shufp = os.path.join(CACHE, "bench_l3k11.shuf")
    if not os.path.exists(shufp):
        write_shuf(shufp, make_shuf(SketchParams(k=11, subk=6, drlevel=3),
                                    seed=1234))
    if not os.path.exists(fq):
        rng = np.random.default_rng(7)
        genome = rng.integers(0, 4, size=2_000_000)
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)[genome]
        starts = rng.integers(0, genome.size - READ_LEN, size=N_READS)
        with open(fq + ".tmp", "w") as f:
            qual = "I" * READ_LEN
            for i, s in enumerate(starts):
                seq = bases[s:s + READ_LEN].tobytes().decode()
                f.write(f"@r{i}\n{seq}\n+\n{qual}\n")
        os.replace(fq + ".tmp", fq)
    return fq, shufp


def _profile_fixture(device) -> tuple[str, str, str]:
    """(MarkerDB dir, query sketch dir, shuffle): the query is the
    fastq's ``dist -A`` sketch, the MarkerDB N_SPECIES synthetic species
    drawn directly (profiling reads only the sketch files)."""
    from metakssd_tpu_torch import cli
    from metakssd_tpu_torch.formats.codir import CoDir, write_codir
    from metakssd_tpu_torch.formats.costat import CoStat
    from metakssd_tpu_torch.formats.shuf import read_shuf
    fq, shufp = _prepare()
    qdir = os.path.join(CACHE, f"prof_qry_{N_READS}")
    dbdir = os.path.join(CACHE, f"prof_db_{N_SPECIES}_{N_READS}")
    if not os.path.exists(os.path.join(qdir, "cofiles.stat")):
        if cli.main(["dist", "-L", shufp, "-A", "-o", qdir, fq, "--device",
                     str(device)]) != 0:
            raise RuntimeError(f"dist -A of {fq} failed")
    if not os.path.exists(os.path.join(dbdir, "cofiles.stat")):
        rng = np.random.default_rng(21)
        qids = np.asarray(CoDir.read(qdir, want_abund=False).ids[0])
        p = read_shuf(shufp).params
        per_genome = []
        for _ in range(N_SPECIES):
            own = rng.integers(0, 1 << 32, size=IDS_PER_SPECIES,
                               dtype=np.uint32)
            mix = rng.choice(qids, size=min(qids.size // 2, 500),
                             replace=False)
            per_genome.append([(np.unique(np.concatenate([own, mix])),
                                None)])
        ctx = np.array([g[0][0].size for g in per_genome], dtype=np.uint32)
        stat = CoStat(p.shuf_id, False, 2 * p.k, 2 * p.drlevel, 1,
                      int(ctx.sum()), ctx,
                      [f"sp{i}" for i in range(N_SPECIES)])
        write_codir(dbdir, stat, per_genome)
    return dbdir, qdir, shufp


def _abv_fixture(dbdir: str) -> list[str]:
    """The abv corpus in the MarkerDB's ``abundance_Vec/`` and its index;
    returns the query paths."""
    from metakssd_tpu_torch import composite
    from metakssd_tpu_torch.formats.abv import write_abv_file
    abvdir = os.path.join(dbdir, "abundance_Vec")
    os.makedirs(abvdir, exist_ok=True)
    if not os.listdir(abvdir):
        rng = np.random.default_rng(5)
        for s in range(ABV_SAMPLES):
            nd = int(rng.integers(8, 48))
            idx = np.sort(rng.choice(ABV_SPECIES, nd, replace=False)) \
                .astype(np.int32)
            pct = (rng.random(nd).astype(np.float32) * 10) \
                .astype(np.float32)
            write_abv_file(os.path.join(abvdir, f"s{s}.abv"), idx, pct)
    composite.index_abv(dbdir)
    return [os.path.join(abvdir, q)
            for q in sorted(os.listdir(abvdir))[:ABV_QUERIES]]


# --------------------------------------------------------------------------
# the reference C tool
# --------------------------------------------------------------------------

def _safe_len_path(binpath: str) -> str:
    """The reference's main() writes ``argv[0] + " <subcommand>"`` one
    byte past its buffer (metakssd.c:18-21); with len(argv[0]) % 16 == 11
    that byte lands on a malloc chunk's size field and a later free
    aborts.  A longer name keeps it in malloc's slack."""
    if len(binpath) % 16 != 11:
        return binpath
    safe = binpath + "_"
    if not os.path.exists(safe):
        shutil.copy2(binpath, safe)
    return safe


def _oracle_bin() -> str | None:
    """The reference C tool built from REFERENCE's sources (as
    ``tests/oracle.py`` builds it), or None where REFERENCE is unset or
    holds no sources, or the compiler fails."""
    if not REFERENCE:
        return None
    binpath = os.path.join(CACHE, "oracle", "metakssd")
    if not os.path.exists(binpath):
        srcs = sorted(glob.glob(os.path.join(REFERENCE, "*.c")))
        if not srcs:
            return None
        os.makedirs(os.path.dirname(binpath), exist_ok=True)
        try:
            subprocess.run(["gcc", "-std=gnu11", "-O2", *srcs, "-o", binpath,
                            "-lz", "-lm", "-fopenmp"], check=True,
                           capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            return None
    return _safe_len_path(binpath)


def _best_ref_s(argvs: list[list[str]], cwd: str | None = None,
                min_lines: int = 0, fresh: str | None = None) -> float | None:
    """Best of REPS seconds of the reference running ``argvs`` in turn
    (the root bench's oracle legs), ``fresh`` removed before each, or None
    where it is missing or fails."""
    binpath = _oracle_bin()
    if not binpath:
        return None
    best = float("inf")
    for _ in range(REPS):
        if fresh:
            shutil.rmtree(fresh, ignore_errors=True)
        t0 = time.perf_counter()
        rs = [subprocess.run([binpath, *a], capture_output=True, cwd=cwd)
              for a in argvs]
        dt = time.perf_counter() - t0
        if all(r.returncode == 0 for r in rs) and \
                len(rs[-1].stdout.splitlines()) >= min_lines:
            best = min(best, dt)
    return best if np.isfinite(best) else None


def _bench_reference(fq: str, shufp: str) -> float:
    """The reference's reads/s on the same fastq and shuffle, warm (both
    files read once, one untimed run first); 0.0 without it."""
    binpath = _oracle_bin()
    if not binpath:
        return 0.0
    out = os.path.join(CACHE, "ref_out")
    for p in (fq, shufp):
        with open(p, "rb") as f:
            while f.read(1 << 24):
                pass
    argv = ["dist", "-L", shufp, "-A", "-o", out, fq]
    shutil.rmtree(out, ignore_errors=True)
    subprocess.run([binpath, *argv], capture_output=True)
    best = _best_ref_s([argv], fresh=out)
    return N_READS / best if best else 0.0


# --------------------------------------------------------------------------
# the legs (each in a worker process)
# --------------------------------------------------------------------------

def _best(key: str, runs: list[float], lower: bool = False) -> dict:
    return {key: min(runs) if lower else max(runs), f"{key}_runs": runs}


def _leg_sketch(device) -> dict:
    """``dist -A`` of the fastq through the port's ``run_stage1``, on
    ``device`` and on the host engine."""
    from metakssd_tpu_torch import pipeline
    from metakssd_tpu_torch.formats.shuf import read_shuf
    from metakssd_tpu_torch.io import native
    from metakssd_tpu_torch.ops import sketch_cuda
    from metakssd_tpu_torch.state import accept_tables
    fq, shufp = _prepare()
    shuf = read_shuf(shufp)
    opts = pipeline.SketchOptions(abundance=True)
    native.available()                  # build or load the host library
    res = {}
    for dev in (str(device), "host"):
        if dev.startswith("cuda"):
            # the card's context, the kernels' library and a first launch
            sketch_cuda.sketch_windows(np.full(1 << 16, 1, np.uint8),
                                       shuf.params, accept_tables(shuf, dev))
        out = os.path.join(CACHE, f"mine_out_{dev.replace(':', '')}")
        runs = []
        for _ in range(REPS):
            shutil.rmtree(out, ignore_errors=True)
            t0 = time.perf_counter()
            pipeline.run_stage1([fq], shuf, out, opts, device=dev)
            runs.append(N_READS / (time.perf_counter() - t0))
        res.update(_best("cpu_reads_per_s" if dev == "host"
                         else "reads_per_s", runs))
    res["host_library"] = native.build_kind()
    return res


def _leg_kernel(device) -> dict:
    from metakssd_tpu_torch.ops.kernel_bench import kernel_chain_mwin
    nwin = CPU_KERNEL_WINDOWS if str(device) == "cpu" else KERNEL_WINDOWS
    return _best("kernel_mwin_per_s", [
        kernel_chain_mwin(nwin=nwin, reps=1, device=device)
        for _ in range(REPS)])


def _leg_profile(device) -> dict:
    from metakssd_tpu_torch import composite
    dbdir, qdir, _ = _profile_fixture(device)
    outp = os.path.join(CACHE, "prof_out.tsv")
    runs = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        with open(outp, "w") as f:
            composite.get_species_abundance(dbdir, qdir, out=f, device=device)
        runs.append(time.perf_counter() - t0)
    composite.wait_staging()
    res = _best("profile_latency_s", runs, lower=True)
    ref = _best_ref_s([["composite", "-r", dbdir, "-q", qdir]])
    if ref is not None:
        res["profile_ref_latency_s"] = ref
    return res


def _leg_abv(device) -> dict:
    from metakssd_tpu_torch import composite
    from metakssd_tpu_torch.ops.dense_abv import abv_search_dense
    dbdir, _, _ = _profile_fixture(device)
    qpaths = _abv_fixture(dbdir)
    sparse, dense = [], []
    with open(os.devnull, "w") as devnull:
        for _ in range(REPS):
            t0 = time.perf_counter()
            composite.abv_search(dbdir, qpaths, mode=2, out=devnull)
            sparse.append(len(qpaths) / (time.perf_counter() - t0))
        # the dense DB is staged once, as in a serving process
        abv_search_dense(dbdir, qpaths[:2], mode=2, out=devnull,
                         device=device)
        for _ in range(REPS):
            t0 = time.perf_counter()
            abv_search_dense(dbdir, qpaths, mode=2, out=devnull,
                             device=device)
            dense.append(len(qpaths) / (time.perf_counter() - t0))
    res = {**_best("abv_queries_per_s", sparse),
           **_best("abv_dense_queries_per_s", dense)}
    # the reference opens query files relative to its working directory,
    # and must print a block per query (no silent open failure)
    qnames = [os.path.basename(q) for q in qpaths]
    ref = _best_ref_s([["composite", "-r", dbdir, "-s", "2", *qnames]],
                      cwd=os.path.dirname(qpaths[0]), min_lines=len(qnames))
    if ref is not None:
        res["abv_ref_queries_per_s"] = len(qnames) / ref
    return res


def _leg_e2e(device, reference: bool = True) -> dict:
    """fastq -> sketch -> profile -> Poisson, as ``profile`` runs it: one
    cold repeat (no index sidecars on disk), then REPS steady ones.  Every
    repeat drops the in-process indexes, as a new CLI process would.
    ``reference``: also time the reference tool where it is named."""
    from metakssd_tpu_torch import composite, profile_e2e
    dbdir, _, shufp = _profile_fixture(device)
    fq, _ = _prepare()
    outdir = os.path.join(CACHE, "e2e_out")

    def run(cold: bool) -> dict:
        shutil.rmtree(outdir, ignore_errors=True)
        composite._COMP_CACHE.clear()
        composite._INDEX_CACHE.clear()
        if cold:
            composite.wait_staging()
            shutil.rmtree(os.path.join(dbdir, ".mkssd_stage"),
                          ignore_errors=True)
        return profile_e2e.profile_fastq([fq], dbdir, shufp, outdir,
                                         device=device)

    cold = run(True)
    reps = [run(False) for _ in range(REPS)]
    composite.wait_staging()
    best = min(reps, key=lambda r: r["total_s"])
    res = {"e2e_total_s": best["total_s"],
           "e2e_total_s_runs": [r["total_s"] for r in reps],
           "e2e_cold_total_s": cold["total_s"],
           "e2e_stages": {k: v for k, v in best["stages"].items()
                          if k.startswith("e2e.")}}
    if not reference:
        return res
    ref_co = os.path.join(CACHE, "e2e_ref_co")
    ref = _best_ref_s([["dist", "-L", shufp, "-A", "-o", ref_co, fq],
                       ["composite", "-r", dbdir, "-q", ref_co]],
                      fresh=ref_co)
    if ref is not None:
        res["e2e_ref_total_s"] = ref
    return res


def _leg_e2e_host(device) -> dict:
    """The e2e leg on the host engine whatever ``device`` is, under the
    root bench's ``cpu_`` keys."""
    return {f"cpu_{k}": v for k, v in _leg_e2e("host", False).items()}


LEGS = {"sketch": _leg_sketch, "kernel": _leg_kernel,
        "profile": _leg_profile, "abv": _leg_abv, "e2e": _leg_e2e,
        "e2e_host": _leg_e2e_host}


def _worker_main(task: str, device: str) -> int:
    """One leg in this process; prints ``WORKER_RESULT <json>``."""
    from metakssd_tpu_torch.ops import _build
    _build.reset_launches()
    res = LEGS[task](device)
    res["launches"] = {k: v for k, v in _build.LAUNCHES.items() if v}
    print("WORKER_RESULT " + json.dumps(res), flush=True)
    return 0


def _run_worker(task: str, device: str) -> dict:
    """A leg in a fresh process; raises LegFailed unless it reports."""
    argv = [sys.executable, "-m", "metakssd_tpu_torch.bench", "--worker",
            task, device]
    try:
        r = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                           timeout=WORKER_TIMEOUT)
    except subprocess.TimeoutExpired:
        raise LegFailed(f"leg {task} on {device} passed its "
                        f"{WORKER_TIMEOUT} s") from None
    for line in r.stdout.splitlines():
        if line.startswith("WORKER_RESULT ") and r.returncode == 0:
            return json.loads(line[len("WORKER_RESULT "):])
    raise LegFailed(f"leg {task} on {device} exited {r.returncode}:\n"
                    + (r.stderr or "")[-3000:])


# --------------------------------------------------------------------------
# orchestration
# --------------------------------------------------------------------------

def device_name(device: str) -> str:
    """What runs the legs: the card's name and power limit (nvidia-smi),
    or ``cpu``.  Raises where ``device`` is a card that is not there."""
    from metakssd_tpu_torch.device import resolve_device
    if resolve_device(device).type == "cpu":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _legs(tasks: list[str], device: str, extra: dict) -> dict:
    """Runs each leg in turn; returns their results merged, launches per
    leg in ``extra["launches"]``."""
    merged = {}
    for task in tasks:
        t0 = time.perf_counter()
        res = _run_worker(task, device)
        print(f"bench: leg {task} on {device}: "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        extra["launches"][task] = res.pop("launches")
        merged.update(res)
    return merged


def run(device: str = "cuda", e2e_only: bool = False) -> dict:
    """The bench line (a dict) on ``device``; raises on a failed leg."""
    extra = {"device": device_name(device), "launches": {}}
    fq, shufp = _prepare()
    if e2e_only:
        res = _legs(["e2e"], device, extra)
        ref = res.get("e2e_ref_total_s", 0.0)
        extra.update(stages=res["e2e_stages"],
                     e2e_total_s_runs=res["e2e_total_s_runs"],
                     e2e_cold_total_s=res["e2e_cold_total_s"],
                     e2e_ref_total_s=ref)
        return {"metric": "e2e_profile_latency_s",
                "value": res["e2e_total_s"], "unit": "s",
                "vs_baseline": ref / res["e2e_total_s"] if ref else 0.0,
                "extra": extra}
    ref_rps = _bench_reference(fq, shufp)
    res = _legs(list(LEGS), device, extra)
    value = res.pop("reads_per_s")
    extra.update(res)
    if ref_rps:
        extra["ref_reads_per_s"] = ref_rps
    return {"metric": "fastq_sketch_reads_per_s", "value": value,
            "unit": "reads/s",
            "vs_baseline": value / ref_rps if ref_rps else 0.0,
            "extra": extra}


def _bench_device(name: str) -> str:
    """``--device``: ``cuda``, ``cuda:N`` or ``cpu``."""
    if name in ("cuda", "cpu") or re.fullmatch(r"cuda:\d+", name):
        return name
    raise argparse.ArgumentTypeError(
        f"{name!r}: cuda, cuda:N or cpu (the host engine runs under the "
        "cpu_* keys whatever the device is)")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m metakssd_tpu_torch.bench",
        description="The root bench.py's legs on one device; one JSON line")
    ap.add_argument("--device", default="cuda", type=_bench_device,
                    help="cuda (default), cuda:N or cpu; the host engine's "
                         "legs run under the cpu_* keys whatever it is")
    ap.add_argument("--e2e", action="store_true",
                    help="the end-to-end profile leg alone")
    ap.add_argument("--worker", nargs=2, metavar=("LEG", "DEVICE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return _worker_main(*args.worker)
    try:
        line = run(args.device, args.e2e)
    except (RuntimeError, subprocess.CalledProcessError, OSError) as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
