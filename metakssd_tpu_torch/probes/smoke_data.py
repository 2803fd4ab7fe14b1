"""Seeded data and command runners shared by ``chip_smoke.py`` (at the
repository root) and the probes that time one of its legs
(``probes/profile_busy.py``, ``probes/host_library_check.py``): the
profile slice's genomes, shuffle file and read sample, the set leg's
synthetic sketch dir, and the set leg itself.  Everything is made from a
seed with numpy; nothing here needs a GPU.
"""

from __future__ import annotations

import json
import os
import time

L3K11 = (11, 6, 3)
N_GENOMES = 1024                  # MarkerDB genomes ...
GENOME_LEN = 1_000_000            # ... of 1 Mbp each (1 Gbase)
N_SAMPLED = 32                    # genomes the sample's reads come from
N_READS = 4_000_000               # sample reads, poly-A block included
READ_LEN = 150
N_POLYA = 2000                    # poly-A reads: every window survives
CPU_READS = 200_000               # reads of the --device cpu comparison
SET_TAXA = 16384                  # set leg: taxa of a MarkerDB build ...
SET_PER_TAXON = 4                 # ... of 4 genomes each ...
SET_UNASSIGNED = 64               # ... and genomes of taxid 0 (dropped)
SET_POOL = 1200                   # ids of a taxon's own
SET_SHARED = 40                   # ids a taxon shares with each neighbour
SET_KEEP = 0.8                    # share of its taxon's ids a genome holds


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def write_zero_accepted_shuf(path: str, cfg, seed: int):
    """Write a seeded .shuf file whose substring 0 is accepted with
    pfilter 0, so the poly-A k-mer survives (drtuple 0), and return it as
    the port reads it.  Layout: int32 id, k, subk, drlevel, then the int32
    permutation of range(16**subk); entries below the accept bound are
    accepted.  No module of the JAX package is named here, so this
    writes the file itself; the port's reader checks it."""
    import numpy as np
    from metakssd_tpu_torch.profile_e2e import read_shuf
    k, subk, drlevel = cfg
    rng = np.random.default_rng(seed)
    arr = rng.permutation(1 << 4 * subk).astype("<i4")
    sid = int(rng.integers(1, 2**31 - 1))
    j = int(np.flatnonzero(arr == 0)[0])
    arr[0], arr[j] = arr[j], arr[0]
    with open(path, "wb") as f:
        f.write(np.array([sid, k, subk, drlevel], "<i4").tobytes())
        f.write(arr.tobytes())
    return read_shuf(path)


def write_fasta(path: str, name: str, seq_ascii) -> None:
    """One record, its sequence on one line (the numpy fasta parser, which
    runs where the native one does not build, costs a Python step per
    line)."""
    with open(path, "wb") as f:
        f.write(f">{name} synthetic genome\n".encode())
        f.write(seq_ascii.tobytes() + b"\n")


def read_fasta(path: str):
    """The sequence of a file written by write_fasta, as ASCII uint8."""
    import numpy as np
    with open(path, "rb") as f:
        body = f.read().split(b"\n", 1)[1].replace(b"\n", b"")
    return np.frombuffer(body, np.uint8).copy()


def write_fastq(path: str, reads_ascii) -> None:
    """Fixed-width records: '@r%07d\\n' + seq + '\\n+\\n' + qual + '\\n'."""
    import numpy as np
    nreads, rl = reads_ascii.shape
    rec = 10 + rl + 3 + rl + 1
    block = 1 << 18
    with open(path, "wb") as f:
        for lo in range(0, nreads, block):
            r = reads_ascii[lo:lo + block]
            b = r.shape[0]
            out = np.empty((b, rec), np.uint8)
            ids = np.arange(lo, lo + b)
            out[:, 0] = ord("@")
            out[:, 1] = ord("r")
            for d in range(7):
                out[:, 8 - d] = ord("0") + (ids // 10 ** d) % 10
            out[:, 9] = ord("\n")
            out[:, 10:10 + rl] = r
            out[:, 10 + rl:13 + rl] = np.frombuffer(b"\n+\n", np.uint8)
            out[:, 13 + rl:13 + 2 * rl] = ord("I")
            out[:, rec - 1] = ord("\n")
            f.write(out.tobytes())


def make_slice_data(work: str, seed: int):
    """Genomes, the L3K11 shuffle and the read sample, all from ``seed``.
    Returns (shuf path, genome dir, fastq path, reads as ASCII
    [N_READS, READ_LEN], {sampled genome path: coverage}, {sampled genome
    path: coverage by the first CPU_READS reads})."""
    import numpy as np

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    shufp = os.path.join(work, "L3K11.shuf")
    write_zero_accepted_shuf(shufp, L3K11, seed)
    gdir = os.path.join(work, "genomes")
    os.makedirs(gdir)
    sampled = set(rng.choice(N_GENOMES, N_SAMPLED, replace=False).tolist())
    kept = {}
    for i in range(N_GENOMES):
        g = acgt[rng.integers(0, 4, size=GENOME_LEN, dtype=np.uint8)]
        path = os.path.join(gdir, f"g{i:04d}.fa")
        write_fasta(path, f"g{i:04d}", g)
        if i in sampled:
            kept[path] = g
    paths = sorted(kept)
    weights = rng.lognormal(0.0, 1.5, len(paths))
    counts = rng.multinomial(N_READS - N_POLYA, weights / weights.sum())
    parts = []
    for path, cnt in zip(paths, counts):
        starts = rng.integers(0, GENOME_LEN - READ_LEN + 1, cnt)
        parts.append(kept[path][starts[:, None] + np.arange(READ_LEN)])
    reads = np.concatenate(parts)
    perm = rng.permutation(reads.shape[0])
    reads = reads[perm]
    # the first CPU_READS reads lie before the poly-A block
    first = np.bincount(np.repeat(np.arange(len(paths)), counts)[perm]
                        [:CPU_READS], minlength=len(paths))
    flat = reads.reshape(-1)
    flat[rng.integers(0, flat.size, flat.size // 1000)] = ord("N")
    mid = reads.shape[0] // 2
    reads = np.concatenate([reads[:mid],
                            np.full((N_POLYA, READ_LEN), ord("A"), np.uint8),
                            reads[mid:]])
    fq = os.path.join(work, "sample.fq")
    write_fastq(fq, reads)
    coverage = {path: cnt * READ_LEN / GENOME_LEN
                for path, cnt in zip(paths, counts)}
    sub_coverage = {path: cnt * READ_LEN / GENOME_LEN
                    for path, cnt in zip(paths, first)}
    return shufp, gdir, fq, reads, coverage, sub_coverage


def stage_seconds(timer) -> dict:
    out: dict = {}
    for name, dt in timer.stages:
        out[name] = round(out.get(name, 0.0) + dt, 4)
    return out


def run_cli(label: str, argv: list) -> float:
    from metakssd_tpu_torch import cli
    from metakssd_tpu_torch.pipeline import TIMER
    t = time.time()
    check(cli.main(argv) == 0, f"{label} failed: {argv}")
    dt = time.time() - t
    print(f"  {label:36s} {dt:9.3f} s  stages "
          f"{json.dumps(stage_seconds(TIMER))}", flush=True)
    return dt


def make_set_data(work: str, seed: int):
    """A synthetic L3K11 sketch dir at a MarkerDB build's scale and its
    taxon file.  SET_TAXA taxa of SET_PER_TAXON genomes; a taxon's pool is
    SET_POOL ids of its own and SET_SHARED shared with each neighbouring
    taxon (distinct random u32, >= 2^31 included); a genome holds each id
    of its taxon's pool with probability SET_KEEP (about 1,024 ids).  After
    every (SET_TAXA / SET_UNASSIGNED)-th taxon comes a genome of taxid 0
    that copies a random taxon's pool.  Returns (sketch dir, taxon file,
    number of ids)."""
    import numpy as np
    from metakssd_tpu_torch.pipeline import CoStat, write_codir
    rng = np.random.default_rng(seed + 3)
    t = SET_TAXA
    need = t * (SET_POOL + SET_SHARED)
    ids = np.unique(rng.integers(0, 1 << 32, need + need // 8,
                                 dtype=np.uint64).astype(np.uint32))
    ids = rng.permutation(ids)[:need]
    own = ids[:t * SET_POOL].reshape(t, SET_POOL)
    shared = ids[t * SET_POOL:].reshape(t, SET_SHARED)
    pool = np.concatenate([own, shared, np.roll(shared, 1, axis=0)], axis=1)
    pool.sort(axis=1)
    taxon = np.repeat(np.arange(t), SET_PER_TAXON)
    taxon = np.insert(taxon, np.arange(0, t, t // SET_UNASSIGNED)
                      * SET_PER_TAXON + SET_PER_TAXON, -1)
    rows = pool[np.where(taxon >= 0, taxon,
                         rng.integers(0, t, taxon.size))]
    keep = rng.random(rows.shape, dtype=np.float32) < SET_KEEP
    flat = rows[keep]
    del rows, pool
    lens = keep.sum(axis=1)
    per_genome = [[(x, None)] for x in np.split(flat, np.cumsum(lens)[:-1])]
    co = os.path.join(work, "set_sketches")
    write_codir(co, CoStat(
        shuf_id=int(rng.integers(1, 2**31 - 1)), koc=False, kmerlen=22,
        dim_rd_len=6, comp_num=1, all_ctx_ct=int(flat.size),
        ctx_ct=lens.astype(np.uint32),
        names=[f"genome{g:05d}.fa" for g in range(taxon.size)]), per_genome)
    taxf = os.path.join(work, "set_taxa.tsv")
    with open(taxf, "w") as f:
        f.writelines(f"{1000 + x}\ttaxon{x}\n" if x >= 0 else "0\n"
                     for x in taxon.tolist())
    return co, taxf, int(flat.size)


def set_leg(work: str, dev: str, co: str, taxf: str,
            secs: dict | None = None) -> str:
    """set -g -> -q -> -i (the MarkerDB chain), then -u, -s and -c, on
    ``dev``, in a dir of its own with outputs named relative to it (so
    the names that -c records are the same on both devices); each verb's
    seconds go into ``secs``."""
    wd = os.path.join(work, f"set_{dev}")
    os.makedirs(wd)
    here = os.getcwd()
    os.chdir(wd)
    try:
        for verb, argv in (("-g", ["-g", taxf, "-o", "pan", co]),
                           ("-q", ["-q", "-o", "uq", "pan"]),
                           ("-i", ["-i", "uq", "-o", "mk", "pan"]),
                           ("-u", ["-u", "-o", "u", co]),
                           ("-s", ["-s", "uq", "-o", "s", co]),
                           ("-c", ["-c", "-o", "c", "u", "uq"])):
            dt = run_cli(f"set {verb} --device {dev}",
                         ["set", *argv, "--device", dev])
            if secs is not None:
                secs[verb] = dt
    finally:
        os.chdir(here)
    return wd
