#!/usr/bin/env python3
"""Smoke run of metakssd_tpu_torch on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py [--seed N]

Phases, in order; each prints its seconds, and any failure exits non-zero:

1. card: requires torch.cuda.is_available(); prints nvidia-smi's
   name and power limit;
2. build: compiles csrc/*.cu with nvcc into metakssd_tpu_torch/_build/;
3. kernels: K1 (compact) and K2 (full) against their plain PyTorch
   versions on the card, on 64M-window batches of configs (11,6,3),
   (8,5,2) and (7,5,3) with 0.1% invalid bases, a poly-A stream whose
   k-mer is accepted, and a forced tiny capacity.  On a 1 Mbase slice both
   also equal the reference: ``golden.window_drtuples``, the JAX
   package's numpy model (metakssd_tpu/ops/golden.py), which the port's
   ``ops.sketch`` already runs for configs the kernels do not take.
   Then K3 (membership) against its plain version, in identity and
   values mode: about 4.19M distinct random u32 keys (>= 2^31 included)
   and 1M sorted needles, half hits, with duplicates; a clustered
   haystack whose needle blocks span more than the staged window; 1, 100,
   2047 and 0 needles; an empty haystack; 0xFFFFFFFF present and absent.
   Prints each kernel's time beside its plain version's (CUDA events,
   after a warm-up);
4. slice: 1024 synthetic 1 Mbp genomes -> MarkerDB with the port's
   ``dist`` (L3K11), a 4M x 150 bp fastq sampled from 32 of them with
   skewed abundance, 0.1% N and a block of poly-A reads, then the port's
   ``profile --device cuda``, the main path.  Launch counts are zeroed
   before each of the two legs and checked for each: K1 ran in ``dist``,
   and K1 and K2 both ran in ``profile``.  Checks that the profile names
   exactly sampled genomes and every genome of coverage >= 1x, and that
   ``--device cpu`` (the plain versions) writes byte-identical TSVs on the
   first 200K reads;
5. search: the same genomes sketched at K8S5L2 (the prokaryote default)
   as a reference, and 128 query genomes of 1 Mbp (16 substituted copies
   of distinct references at each of 0.1, 0.5, 1, 2, 5 and 10%, and 32
   unrelated ones).  ``dist -r`` runs on the card (launch counts zeroed
   before it: K3 must run), with ``--device cpu``, against the stage-II
   mco dir (``--component_sz 6``) and with ``--shard-db 1``.  The four
   distance.out files must be byte-identical, every substituted query's
   best reference by Jaccard must be its source, the median Jaccard
   must fall strictly with the rate, and no unrelated query may reach
   Jaccard 0.01;
6. set: a synthetic L3K11 sketch dir at a MarkerDB build's scale (65,536
   genomes in 16,384 taxa of 4, about 1,024 ids each, 67M ids in all,
   and 64 genomes of taxid 0) goes through ``set -g`` -> ``-q`` -> ``-i``,
   then ``-u``, ``-s`` and ``-c``, with ``--device cuda`` (launch counts
   zeroed before it: K3 must run) and with ``--device cpu``; every output
   dir must be byte-identical between the two.  Then the real chain on
   phase 4's genomes (taxa of 4 consecutive genomes): ``set -g/-q/-i``,
   ``dist -A`` of the first 200K reads and ``composite -q`` and ``-q -b``
   on both devices; TSVs and ``.abv`` files byte-identical, and every
   taxon holding a genome of coverage >= 1x in those reads reported;
7. abv: one abundance vector per taxon of phase 6's markers (16,384
   vectors over 16,384 species dims, 30-600 nonzero dims of skewed
   prevalence, lognormal percentages), ``composite -i``, and 256 queries
   (192 DB vectors, 64 perturbed copies) through ``composite -s 0/1/2``:
   sparse text identical between the routes; ``--dense`` on the card (a
   1 GiB float32 DB) with the sparse path's overlap sets, within 2e-3 of
   its measures (a query's L2 to itself excepted: ROADMAP.md section 3)
   and every DB query its own top cosine hit; ``--dense --device cpu`` on
   16 queries within 2e-3 of the card's;
8. probes: the probe path P1-P4, the port's counterparts of the TPU
   probes of ``benchmarks/`` (``metakssd_tpu_torch/probes/``), each at its
   file's shapes (2^24 windows per dispatch) and timing method (16
   XOR-varied dispatches, one readback, best of PROBE_REPS), with launch
   counts zeroed before it: every probe kernel must run.  Then each
   variant's CUDA kernel against its plain version on the same input,
   element for element; the card's time of the path's 16 dispatches
   replayed from a CUDA graph (the path's own time includes the host's
   enqueueing), the plain version's, and for the sums one ``torch.sum``'s
   (replayed alike);
9. cuda tests: ``pytest -m cuda`` on the four cuda-marked test files.

The line before the last is the kernels' JSON record, with the launch
counts of the ``profile`` leg (K1, K2), of the ``dist -r --device cuda``
and ``set --device cuda`` legs (K3) and of the probe path (P1-P4, one
entry per variant), and each kernel's bound: the larger of its bytes over
3.35 TB/s and its 32-bit operations over 67 T/s (the H100's float32 rate
outside the tensor cores; the table of peaks has no int32 figure),
counted from this run's inputs.  The last line is ``{"ok": true,
"device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.  All data is made from --seed with numpy under
``.smoke_work/`` and removed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
L3K11 = (11, 6, 3)
CHECK_CONFIGS = [(11, 6, 3), (8, 5, 2), (7, 5, 3)]
BATCH_WINDOWS = 64 << 20          # the streaming batch size, in windows
N_GENOMES = 1024                  # MarkerDB genomes ...
GENOME_LEN = 1_000_000            # ... of 1 Mbp each (1 Gbase)
N_SAMPLED = 32                    # genomes the sample's reads come from
N_READS = 4_000_000               # sample reads, poly-A block included
READ_LEN = 150
N_POLYA = 2000                    # poly-A reads: every window survives
CPU_READS = 200_000               # reads of the --device cpu comparison
ALL_ONES = 0xFFFFFFFF
MEMBER_HAY = 1 << 22              # K3 haystack draw (about 4.19M distinct)
MEMBER_NEEDLES = 1 << 20          # K3 needles, half of them hits
QUERY_KMERS = 4096                # K3 needles of one K8S5L2 genome query
K8S5L2 = (8, 5, 2)                # the prokaryote default of dist search
RATES = (0.001, 0.005, 0.01, 0.02, 0.05, 0.10)   # query substitution rates
N_PER_RATE = 16                   # mutated queries per rate
N_UNRELATED = 32                  # queries from no reference genome
SET_TAXA = 16384                  # set leg: taxa of a MarkerDB build ...
SET_PER_TAXON = 4                 # ... of 4 genomes each ...
SET_UNASSIGNED = 64               # ... and genomes of taxid 0 (dropped)
SET_POOL = 1200                   # ids of a taxon's own
SET_SHARED = 40                   # ids a taxon shares with each neighbour
SET_KEEP = 0.8                    # share of its taxon's ids a genome holds
CHAIN_TAXON = 4                   # real chain: taxa of 4 consecutive genomes
ABV_DIMS = (30, 600)              # nonzero dims of an abundance vector
ABV_DB_QUERIES = 192              # queries that are vectors of the DB ...
ABV_PERTURBED = 64                # ... and perturbed copies of DB vectors
ABV_CPU_QUERIES = 16              # dense queries run on the CPU too
DENSE_TOL = 2e-3                  # dense vs sparse (tests/test_dense_abv.py)
PROBE_REPS = 3                    # timed runs of each probe variant
HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory rate
ALU_OPS_PER_S = 67e12             # H100 SXM float32 rate outside tensor cores


def _bound(nbytes: int, ops: int) -> tuple[float, str]:
    """(least ms for the work, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _phase(name: str, t0: float) -> None:
    print(f"phase {name}: {time.time() - t0:.3f} s", flush=True)


def write_zero_accepted_shuf(path: str, cfg, seed: int):
    """Write a seeded .shuf file whose substring 0 is accepted with
    pfilter 0, so the poly-A k-mer survives (drtuple 0), and return it as
    the port reads it.  Layout: int32 id, k, subk, drlevel, then the int32
    permutation of range(16**subk); entries below the accept bound are
    accepted.  The script names no module of the JAX package, so it
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


def _time_ms(fn, reps: int) -> float:
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _u32(t):
    import numpy as np
    return t.cpu().numpy().view(np.uint32)


def _pairs(dr, pos):
    import numpy as np
    order = np.lexsort((dr, pos))
    return np.asarray(pos)[order], np.asarray(dr)[order]


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_kernels(work: str, seed: int) -> dict:
    """K1/K2 vs plain on the card; returns times and max errors."""
    import numpy as np
    import torch
    from metakssd_tpu_torch.ops import sketch_cuda
    from metakssd_tpu_torch.ops.sketch import golden
    from metakssd_tpu_torch.state import accept_tables

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    res = {"k1_err": 0, "k2_err": 0}
    for cfg in CHECK_CONFIGS:
        shuf = write_zero_accepted_shuf(
            os.path.join(work, "K%dS%dL%d.shuf" % cfg), cfg, seed)
        p = shuf.params
        tabs = accept_tables(shuf, dev)
        n = BATCH_WINDOWS + p.kmer_len - 1
        codes = rng.integers(0, 4, size=n, dtype=np.uint8)
        codes[rng.integers(0, n, n // 1000)] = 4
        c = torch.from_numpy(codes).to(dev)
        nwin = n - p.kmer_len + 1
        cap = sketch_cuda.default_capacity(nwin, tabs)

        # K1 with positions vs plain: count, drtuple multiset, pairs
        dr, pos, cnt = sketch_cuda.window_compact(c, tabs, p, cap, True)
        pdr, ppos, pcnt = sketch_cuda.window_compact_plain(c, tabs, p, cap,
                                                           True)
        m = int(cnt.item())
        _check(m == int(pcnt.item()) and 0 < m <= cap,
               f"{cfg} K1 count {m} vs plain {int(pcnt.item())}")
        a, b = np.sort(_u32(dr[:m])), np.sort(_u32(pdr[:m]))
        res["k1_err"] = max(res["k1_err"], int(np.abs(
            a.astype(np.int64) - b.astype(np.int64)).max()))
        _check(np.array_equal(a, b), f"{cfg} K1 drtuple multiset")
        pa = _pairs(_u32(dr[:m]), pos[:m].cpu().numpy())
        pb = _pairs(_u32(pdr[:m]), ppos[:m].cpu().numpy())
        _check(np.array_equal(pa[0], pb[0]) and np.array_equal(pa[1], pb[1]),
               f"{cfg} K1 (drtuple, position) pairs")
        del dr, pos, pdr, ppos

        # K2 vs plain, window by window
        fdr, fk = sketch_cuda.window_full(c, tabs, p)
        gdr, gk = sketch_cuda.window_full_plain(c, tabs, p)
        res["k2_err"] = max(res["k2_err"], int(
            ((fdr.long() & 0xFFFFFFFF) - (gdr.long() & 0xFFFFFFFF))
            .abs().max().item()))
        _check(torch.equal(fdr, gdr) and torch.equal(fk, gk),
               f"{cfg} K2 vs plain")
        _check(int(fk.sum().item()) == m, f"{cfg} K2 keeps {m} windows")
        del fdr, fk, gdr, gk

        # forced tiny capacity: the count keeps counting past it
        _, _, cnt = sketch_cuda.window_compact(c, tabs, p, 100, True)
        _check(int(cnt.item()) == m, f"{cfg} K1 count past capacity")

        # 1 Mbase slice: the chunk loop (K1, positions) and K2 equal golden,
        # also through the overflow rerun at a tiny capacity
        sl = codes[:1 << 20]
        gd, gp = golden.window_drtuples(sl, shuf, return_positions=True)
        for capacity in (None, 100):
            d, ps = sketch_cuda.sketch_windows(sl, p, tabs, want_pos=True,
                                               capacity=capacity)
            x, y = _pairs(d.astype(np.uint64), ps), _pairs(gd, gp)
            _check(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]),
                   f"{cfg} chunk loop vs golden (capacity {capacity})")
        fdr, fk = sketch_cuda.window_full(
            torch.from_numpy(sl).to(dev), tabs, p)
        keep = fk.cpu().numpy().astype(bool)
        _check(np.array_equal(np.flatnonzero(keep), gp) and np.array_equal(
            _u32(fdr)[keep].astype(np.uint64), gd), f"{cfg} K2 vs golden")

        # poly-A stream: every window kept, past the default capacity
        pa_codes = np.zeros(1 << 20, np.uint8)
        pc = torch.from_numpy(pa_codes).to(dev)
        npa = pa_codes.size - p.kmer_len + 1
        pcap = sketch_cuda.default_capacity(npa, tabs)
        _, _, cnt = sketch_cuda.window_compact(pc, tabs, p, pcap)
        _check(int(cnt.item()) == npa > pcap, f"{cfg} poly-A K1 count")
        fdr, fk = sketch_cuda.window_full(pc, tabs, p)
        gdr, gk = sketch_cuda.window_full_plain(pc, tabs, p)
        _check(torch.equal(fdr, gdr) and torch.equal(fk, gk)
               and int(fk.sum().item()) == npa, f"{cfg} poly-A K2")
        d, _ = sketch_cuda.sketch_windows(pa_codes, p, tabs)
        _check(d.size == npa and not d.any(), f"{cfg} poly-A chunk loop")

        # times at the 64M-window batch (positions off: the streaming path)
        t = {
            "k1": _time_ms(lambda: sketch_cuda.window_compact(
                c, tabs, p, cap), 10),
            "k1_plain": _time_ms(lambda: sketch_cuda.window_compact_plain(
                c, tabs, p, cap, False), 3),
            "k2": _time_ms(lambda: sketch_cuda.window_full(c, tabs, p), 10),
            "k2_plain": _time_ms(lambda: sketch_cuda.window_full_plain(
                c, tabs, p), 3),
        }
        for name, ms in t.items():
            print(f"  {cfg} {name:9s} {ms:10.4f} ms  "
                  f"{nwin / ms / 1e3:10.1f} Mwin/s", flush=True)
        print(f"  {cfg} kernels == plain (K1 {m} survivors of {nwin} "
              "windows, K2 all windows), == golden on 1 Mbase, poly-A "
              "and forced-capacity overflow ok", flush=True)
        if cfg == L3K11:
            res["times"] = t
            res["shape"] = {"n_codes": n, "nwin": nwin, "TL": p.kmer_len,
                            "n_accept": tabs.size, "survivors": m}
        del c, codes
        torch.cuda.empty_cache()
    return res


def _member_cases(seed: int):
    """(name, haystack, values, needles) uint32 numpy cases of K3."""
    import numpy as np
    rng = np.random.default_rng(seed + 1)

    def u32(lo, hi, n):
        return rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32)

    def half_hits(hay, n):
        return np.sort(np.concatenate([rng.choice(hay, n // 2),
                                       u32(0, ALL_ONES, n - n // 2)]))

    hay = np.unique(u32(0, ALL_ONES, MEMBER_HAY))     # keys >= 2^31 too
    vals = u32(0, 1 << 32, hay.size)
    yield "4M x 1M", hay, vals, half_hits(hay, MEMBER_NEEDLES)
    dense = np.unique(np.concatenate([u32(0, 1 << 17, 100_000),
                                      u32(1 << 30, 1 << 31, 1_000_000)]))
    yield ("clustered", dense, u32(0, 1 << 32, dense.size), np.sort(
        np.concatenate([u32(0, 1 << 17, 3000), rng.choice(dense, 200_000)])))
    for n in (1, 100, 2047, 0):
        yield f"{n} needles", hay, vals, half_hits(hay, n)
    yield ("empty haystack", np.zeros(0, np.uint32), np.zeros(0, np.uint32),
           half_hits(hay, 1000))
    ones = np.full(3, ALL_ONES, np.uint32)
    yield ("0xFFFFFFFF absent", hay, vals,
           np.sort(np.concatenate([half_hits(hay, 10_000), ones])))
    with_ones = np.append(hay, np.uint32(ALL_ONES))
    yield ("0xFFFFFFFF present", with_ones, np.append(vals, np.uint32(7)),
           np.sort(np.concatenate([half_hits(hay, 10_000), ones])))


def phase_member(seed: int) -> dict:
    """K3 vs plain on the card, in identity and values mode; returns the
    max value error and the times at 4M x 1M."""
    import numpy as np
    import torch
    from metakssd_tpu_torch.ops import merge

    dev = torch.device("cuda")
    err = 0
    timed = None
    for name, hay, vals, needles in _member_cases(seed):
        h = merge.u32_tensor(hay).to(dev)
        nd = merge.u32_tensor(needles).to(dev)
        for v in (None, merge.u32_tensor(vals).to(dev)):
            m, val = merge.member(h, v, nd)
            pm, pv = merge.member_plain(h, v, nd)
            torch.cuda.synchronize()
            _check(torch.equal(m, pm), f"K3 {name}: member differs from plain")
            if needles.size:
                err = max(err, int(((val.long() & 0xFFFFFFFF)
                                    - (pv.long() & 0xFFFFFFFF))
                                   .abs().max().item()))
            _check(torch.equal(val, pv), f"K3 {name}: value differs")
        hits = int(m.sum().item())
        if name.startswith("0xFFFFFFFF"):
            tail = m[nd == -1].bool()
            _check(bool(tail.all()) if "present" in name
                   else not bool(tail.any()), f"K3 {name}")
        print(f"  K3 {name:18s} haystack {hay.size:8d} needles "
              f"{needles.size:8d} members {hits:8d} == plain", flush=True)
        if name == "4M x 1M":
            timed = (h, merge.u32_tensor(vals).to(dev), nd)
            _check(hits >= needles.size // 2, "K3 4M x 1M: too few hits")
    h, v, nd = timed
    one_query = nd[::nd.numel() // QUERY_KMERS][:QUERY_KMERS].contiguous()
    # the library yardstick: torch.searchsorted of the same keys, as int64
    # (the int32 bit view misorders keys >= 2^31); the copies are set-up
    h64, nd64 = h.long() & ALL_ONES, nd.long() & ALL_ONES
    t = {"library": _time_ms(lambda: torch.searchsorted(h64, nd64), 20)}
    del h64, nd64
    for label, x in (("", nd), ("query_", one_query)):
        for mode, vv in (("", None), ("values_", v)):
            t[f"{label}{mode}k3"] = _time_ms(
                lambda: merge.member(h, vv, x), 20)
            t[f"{label}{mode}plain"] = _time_ms(
                lambda: merge.member_plain(h, vv, x), 5)
    for name, ms in t.items():
        n = one_query.numel() if name.startswith("query_") else nd.numel()
        name = "torch.searchsorted" if name == "library" else name
        print(f"  K3 {name:20s} {ms:10.4f} ms  {n / ms / 1e3:10.2f} "
              f"Mneedles/s  ({h.numel()} x {n})", flush=True)
    return {"err": err, "times": t, "shape": {"hay": h.numel(),
                                              "needles": nd.numel()}}


def _write_fasta(path: str, name: str, seq_ascii) -> None:
    """One record, its sequence on one line (the numpy fasta parser, which
    runs where the native one does not build, costs a Python step per
    line)."""
    with open(path, "wb") as f:
        f.write(f">{name} synthetic genome\n".encode())
        f.write(seq_ascii.tobytes() + b"\n")


def _read_fasta(path: str):
    """The sequence of a file written by _write_fasta, as ASCII uint8."""
    import numpy as np
    with open(path, "rb") as f:
        body = f.read().split(b"\n", 1)[1].replace(b"\n", b"")
    return np.frombuffer(body, np.uint8).copy()


def _write_fastq(path: str, reads_ascii) -> None:
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
        _write_fasta(path, f"g{i:04d}", g)
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
    _write_fastq(fq, reads)
    coverage = {path: cnt * READ_LEN / GENOME_LEN
                for path, cnt in zip(paths, counts)}
    sub_coverage = {path: cnt * READ_LEN / GENOME_LEN
                    for path, cnt in zip(paths, first)}
    return shufp, gdir, fq, reads, coverage, sub_coverage


def _stage_seconds(timer) -> dict:
    out: dict = {}
    for name, dt in timer.stages:
        out[name] = round(out.get(name, 0.0) + dt, 4)
    return out


def _tsv_rows(path: str) -> list:
    with open(path) as f:
        return [ln.split("\t") for ln in f.read().splitlines()]


def phase_slice(work: str, seed: int) -> dict:
    import torch
    from metakssd_tpu_torch import cli
    from metakssd_tpu_torch.ops import sketch_cuda
    from metakssd_tpu_torch.pipeline import TIMER, native

    t0 = time.time()
    shufp, gdir, fq, reads, coverage, sub_coverage = make_slice_data(
        work, seed)
    print(f"  data: {N_GENOMES} genomes x {GENOME_LEN} bp, "
          f"{reads.shape[0]} reads x {READ_LEN} bp ({N_POLYA} poly-A) in "
          f"{time.time() - t0:.1f} s; fastq parser: "
          f"{'native' if native.available() else 'numpy seqio'}",
          flush=True)
    db = os.path.join(work, "markerdb")
    out = os.path.join(work, "profile_cuda")

    torch.cuda.reset_peak_memory_stats()
    sketch_cuda.reset_launches()
    t = time.time()
    _check(cli.main(["dist", "-L", shufp, "-o", db, "--device", "cuda",
                     gdir]) == 0, "dist (MarkerDB build) failed")
    dist_s = time.time() - t
    dist_launches = dict(sketch_cuda.LAUNCHES)
    print(f"  dist    {dist_s:.3f} s  launches {dist_launches}", flush=True)
    _check(dist_launches["sketch_compact"] > 0,
           f"K1 never launched in dist: {dist_launches}")

    sketch_cuda.reset_launches()
    t = time.time()
    _check(cli.main(["profile", "-L", shufp, "-r", db, "-o", out,
                     "--device", "cuda", fq]) == 0, "profile failed")
    profile_s = time.time() - t
    launches = dict(sketch_cuda.LAUNCHES)
    stages = _stage_seconds(TIMER)
    peak = torch.cuda.max_memory_allocated()
    print(f"  profile {profile_s:.3f} s  launches {launches}  stages "
          f"{json.dumps(stages)}", flush=True)
    print(f"  peak device memory (dist and profile) {peak / 2**20:.1f} MiB",
          flush=True)
    _check(launches["sketch_compact"] > 0 and launches["sketch_full"] > 0,
           f"a sketch kernel never launched in profile: {launches}")

    rows = _tsv_rows(os.path.join(out, "abundance.tsv"))
    names = {r[1] for r in rows}
    _check(rows and names <= set(coverage),
           f"abundance.tsv names unsampled genomes: {names - set(coverage)}")
    missing = [g for g, cov in coverage.items() if cov >= 1 and g not in names]
    _check(not missing, f"genomes of coverage >= 1x missing: {missing}")
    print(f"  abundance.tsv: {len(rows)} genomes, all sampled; "
          f"{sum(c >= 1 for c in coverage.values())} of {len(coverage)} "
          "sampled genomes have coverage >= 1x and all are present",
          flush=True)

    # the same profile on the first reads: CUDA kernels vs plain on CPU
    sub = os.path.join(work, "subset.fq")
    _write_fastq(sub, reads[:CPU_READS])
    del reads
    sub_out = {}
    for dev in ("cuda", "cpu"):
        sub_out[dev] = os.path.join(work, f"subset_{dev}")
        t = time.time()
        _check(cli.main(["profile", "-L", shufp, "-r", db, "-o",
                         sub_out[dev], "--device", dev, sub]) == 0,
               f"subset profile --device {dev} failed")
        print(f"  subset ({CPU_READS} reads) --device {dev}: "
              f"{time.time() - t:.3f} s", flush=True)
    for name in ("species_coverage.tsv", "abundance.tsv"):
        with open(os.path.join(sub_out["cuda"], name), "rb") as a, \
                open(os.path.join(sub_out["cpu"], name), "rb") as b:
            x, y = a.read(), b.read()
        _check(x == y and len(x) > 0,
               f"{name}: --device cuda and --device cpu differ")
    print("  subset: --device cuda and --device cpu TSVs byte-identical",
          flush=True)
    return {"launches": launches, "shuf": shufp, "markerdb": db,
            "subset": sub, "sub_coverage": sub_coverage}


def make_search_queries(work: str, gdir: str, seed: int):
    """128 query genomes: N_PER_RATE substituted copies of distinct
    reference genomes at each of RATES, and N_UNRELATED random ones.
    Returns (query dir, {query path: (source path or None, rate)})."""
    import numpy as np
    rng = np.random.default_rng(seed + 2)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    refs = sorted(os.listdir(gdir))
    src = rng.choice(len(refs), len(RATES) * N_PER_RATE, replace=False)
    qdir = os.path.join(work, "queries")
    os.makedirs(qdir)
    truth = {}
    for i in range(len(RATES) * N_PER_RATE + N_UNRELATED):
        path = os.path.join(qdir, f"q{i:03d}.fa")
        if i < src.size:
            gpath, rate = os.path.join(gdir, refs[src[i]]), \
                RATES[i // N_PER_RATE]
            seq = _read_fasta(gpath)
            hit = np.flatnonzero(rng.random(seq.size) < rate)
            code = np.searchsorted(acgt, seq[hit])
            seq[hit] = acgt[(code + rng.integers(1, 4, hit.size)) % 4]
            truth[path] = (gpath, rate)
        else:
            seq = acgt[rng.integers(0, 4, size=GENOME_LEN, dtype=np.uint8)]
            truth[path] = (None, None)
        _write_fasta(path, f"q{i:03d}", seq)
    return qdir, truth


def _run_cli(label: str, argv: list) -> float:
    from metakssd_tpu_torch import cli
    from metakssd_tpu_torch.pipeline import TIMER
    t = time.time()
    _check(cli.main(argv) == 0, f"{label} failed: {argv}")
    dt = time.time() - t
    print(f"  {label:36s} {dt:9.3f} s  stages "
          f"{json.dumps(_stage_seconds(TIMER))}", flush=True)
    return dt


def phase_search(work: str, seed: int) -> dict:
    """The search leg at K8S5L2: reference and query sketches, then
    ``dist -r`` on the card (K3), on the CPU, against the stage-II mco dir
    and through ``--shard-db 1``; all four distance.out byte-identical."""
    import numpy as np
    import torch
    from metakssd_tpu_torch.ops import sketch_cuda

    gdir = os.path.join(work, "genomes")
    shufp = os.path.join(work, "K8S5L2.shuf")
    write_zero_accepted_shuf(shufp, K8S5L2, seed)
    refco, qryco = os.path.join(work, "refco"), os.path.join(work, "qryco")
    torch.cuda.reset_peak_memory_stats()
    sketch_cuda.reset_launches()
    _run_cli("dist (reference)", ["dist", "-L", shufp, "-o", refco,
                                  "--device", "cuda", gdir])
    _check(sketch_cuda.LAUNCHES["sketch_compact"] > 0,
           "K1 never launched in the reference build")
    t = time.time()
    qdir, truth = make_search_queries(work, gdir, seed)
    print(f"  query data: {len(truth)} genomes in {time.time() - t:.1f} s",
          flush=True)
    _run_cli("dist (queries)", ["dist", "-L", shufp, "-o", qryco,
                                "--device", "cuda", qdir])

    out = {k: os.path.join(work, f"d_{k}")
           for k in ("cuda", "cpu", "mco", "shard")}
    sketch_cuda.reset_launches()
    secs = {"cuda": _run_cli("dist -r --device cuda", [
        "dist", "-r", refco, "-o", out["cuda"], "--device", "cuda", qryco])}
    launches = dict(sketch_cuda.LAUNCHES)
    print(f"  search launches {launches}", flush=True)
    _check(launches["member"] > 0, f"K3 never launched in the search: "
                                   f"{launches}")
    secs["cpu"] = _run_cli("dist -r --device cpu", [
        "dist", "-r", refco, "-o", out["cpu"], "--device", "cpu", qryco])
    refmco = os.path.join(work, "refmco")
    _run_cli("dist -r (stage II)", ["dist", "-r", refco, "-o", refmco,
                                    "--component_sz", "6"])
    secs["mco"] = _run_cli("dist -r mco", [
        "dist", "-r", refmco, "-o", out["mco"], "--device", "cuda", qryco])
    secs["shard"] = _run_cli("dist -r --shard-db 1", [
        "dist", "-r", refco, "--shard-db", "1", "-o", out["shard"],
        "--device", "cuda", qryco])
    print(f"  peak device memory (search leg) "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)

    texts = {}
    for k, d in out.items():
        with open(os.path.join(d, "distance.out"), "rb") as f:
            texts[k] = f.read()
    _check(all(t == texts["cuda"] for t in texts.values()),
           "the four distance.out files differ")
    jac: dict = {}
    for ln in texts["cuda"].decode().splitlines()[1:]:
        col = ln.split("\t")
        jac.setdefault(col[0], {})[col[1]] = float(col[3])
    _check(set(jac) == set(truth) and all(len(v) == N_GENOMES
                                          for v in jac.values()),
           "distance.out does not hold every query x reference pair")
    by_rate: dict = {}
    for q, (src, rate) in truth.items():
        best = max(jac[q], key=jac[q].get)
        if src is None:
            _check(jac[q][best] < 0.01, f"unrelated {q} reaches Jaccard "
                                        f"{jac[q][best]} against {best}")
            continue
        _check(best == src, f"{q}: best reference {best}, source {src}")
        by_rate.setdefault(rate, []).append(jac[q][src])
    med = [float(np.median(by_rate[r])) for r in RATES]
    _check(all(a > b for a, b in zip(med, med[1:])),
           f"median Jaccard does not fall with the rate: {med}")
    unrelated = max(max(jac[q].values())
                    for q, (src, _) in truth.items() if src is None)
    print("  search: 4 distance.out byte-identical "
          f"({len(texts['cuda'])} bytes); every mutated query's best "
          "reference is its source; median Jaccard by rate "
          + ", ".join(f"{r}: {m:.6f}" for r, m in zip(RATES, med))
          + f"; unrelated queries max Jaccard {unrelated:.6f}", flush=True)
    return {"launches": launches, "seconds": secs}


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


def _same_dirs(a: str, b: str, what: str) -> int:
    """Every file of dir ``a`` byte-identical in dir ``b`` (the hidden
    MarkerDB staging sidecars left out); returns their bytes."""
    fa = sorted(f for f in os.listdir(a) if not f.startswith("."))
    fb = sorted(f for f in os.listdir(b) if not f.startswith("."))
    _check(fa == fb and fa, f"{what}: files differ: {fa} vs {fb}")
    size = 0
    for f in fa:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            data = x.read()
            _check(data == y.read(), f"{what}: {f} differs between devices")
        size += len(data)
    return size


def _run_cli_to(label: str, argv: list, path: str) -> float:
    """``_run_cli`` with the command's stdout written to ``path``."""
    import contextlib
    from metakssd_tpu_torch import cli
    t = time.time()
    with open(path, "w") as f, contextlib.redirect_stdout(f):
        rc = cli.main(argv)
    dt = time.time() - t
    _check(rc == 0, f"{label} failed: {argv}")
    print(f"  {label:36s} {dt:9.3f} s", flush=True)
    return dt


def _set_leg(work: str, dev: str, co: str, taxf: str) -> str:
    """set -g -> -q -> -i (the MarkerDB chain), then -u, -s and -c, on
    ``dev``, in a dir of its own with outputs named relative to it (so
    the names that -c records are the same on both devices)."""
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
            _run_cli(f"set {verb} --device {dev}",
                     ["set", *argv, "--device", dev])
    finally:
        os.chdir(here)
    return wd


def _real_chain(work: str, sres: dict) -> None:
    """The MarkerDB chain on phase 4's L3K11 genomes (taxa of CHAIN_TAXON
    consecutive genomes), then ``composite -q`` and ``-q -b`` of the
    first CPU_READS reads on both devices: byte-identical TSVs and .abv
    files, and every taxon holding a genome of coverage >= 1x reported."""
    from metakssd_tpu_torch.pipeline import CoStat
    names = CoStat.read(sres["markerdb"]).names
    taxf = os.path.join(work, "chain_taxa.tsv")
    with open(taxf, "w") as f:
        f.writelines(f"{1 + i // CHAIN_TAXON}\ttaxon{i // CHAIN_TAXON}\n"
                     for i in range(len(names)))
    qco = os.path.join(work, "chain_sample")
    _run_cli("dist -A (200K reads)", ["dist", "-L", sres["shuf"], "-A", "-o",
                                      qco, "--device", "cuda",
                                      sres["subset"]])
    out = {}
    for dev in ("cuda", "cpu"):
        d = {k: os.path.join(work, f"chain_{dev}_{k}")
             for k in ("pan", "uq", "mk", "abv")}
        _run_cli(f"chain set -g --device {dev}", [
            "set", "-g", taxf, "-o", d["pan"], "--device", dev,
            sres["markerdb"]])
        _run_cli(f"chain set -q --device {dev}", [
            "set", "-q", "-o", d["uq"], "--device", dev, d["pan"]])
        _run_cli(f"chain set -i --device {dev}", [
            "set", "-i", d["uq"], "-o", d["mk"], "--device", dev, d["pan"]])
        d["tsv"] = os.path.join(work, f"chain_{dev}.tsv")
        _run_cli_to(f"chain composite -q --device {dev}", [
            "composite", "-r", d["mk"], "-q", qco, "--device", dev],
            d["tsv"])
        _run_cli(f"chain composite -q -b --device {dev}", [
            "composite", "-r", d["mk"], "-q", qco, "-b", "-o", d["abv"],
            "--device", dev])
        out[dev] = d
    for k in ("pan", "uq", "mk", "abv"):
        _same_dirs(out["cuda"][k], out["cpu"][k], f"chain {k}")
    with open(out["cuda"]["tsv"], "rb") as a, \
            open(out["cpu"]["tsv"], "rb") as b:
        text = a.read()
        _check(text == b.read() and text, "chain composite TSVs differ")
    reported = {ln.split("\t")[1] for ln in text.decode().splitlines()}

    def taxon_of(path):
        i = names.index(path) // CHAIN_TAXON
        return f"{1 + i}_taxon{i}"
    cov = sres["sub_coverage"]
    want = {taxon_of(p) for p, c in cov.items() if c >= 1}
    sampled = {taxon_of(p) for p in cov}
    _check(want and want <= reported,
           f"taxa with a genome of coverage >= 1x missing: "
           f"{sorted(want - reported)}")
    _check(reported <= sampled,
           f"unsampled taxa reported: {sorted(reported - sampled)}")
    print(f"  chain: {len(reported)} taxa reported, all sampled; the "
          f"{len(want)} taxa holding a genome of coverage >= 1x all "
          "present; TSVs, .abv files and set dirs byte-identical between "
          "devices", flush=True)


def phase_set(work: str, seed: int, sres: dict) -> dict:
    """The set leg: the synthetic MarkerDB build on cuda (K3 counted) and
    on cpu, byte-identical dirs; then the real chain."""
    import torch
    from metakssd_tpu_torch.ops import sketch_cuda
    from metakssd_tpu_torch.pipeline import CoStat
    t = time.time()
    co, taxf, nids = make_set_data(work, seed)
    print(f"  data: {SET_TAXA * SET_PER_TAXON + SET_UNASSIGNED} genomes, "
          f"{SET_TAXA} taxa, {nids} ids ({4 * nids / 2**20:.1f} MiB of u32) "
          f"in {time.time() - t:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    sketch_cuda.reset_launches()
    wd = {"cuda": _set_leg(work, "cuda", co, taxf)}
    launches = sketch_cuda.LAUNCHES["member"]
    peak = torch.cuda.max_memory_allocated()
    print(f"  set leg launches {dict(sketch_cuda.LAUNCHES)}; peak device "
          f"memory {peak / 2**20:.1f} MiB", flush=True)
    _check(launches > 0, "K3 never launched in the set leg")
    wd["cpu"] = _set_leg(work, "cpu", co, taxf)
    outs = sorted(os.listdir(wd["cuda"]))
    _check(outs == sorted(os.listdir(wd["cpu"])) and len(outs) == 6,
           f"set: output dirs {outs}")
    size = sum(_same_dirs(os.path.join(wd["cuda"], d),
                          os.path.join(wd["cpu"], d), f"set {d}")
               for d in outs)
    mk = os.path.join(wd["cuda"], "mk")
    st = CoStat.read(mk)
    _check(st.infile_num == SET_TAXA and "0" not in st.names,
           f"markers hold {st.infile_num} taxa")
    _check(0.9 * SET_TAXA * SET_POOL < st.all_ctx_ct
           <= SET_TAXA * (SET_POOL + 2 * SET_SHARED),
           f"markers hold {st.all_ctx_ct} ids")
    print(f"  set: 6 output dirs ({size} bytes) byte-identical between "
          f"--device cuda and --device cpu; {st.all_ctx_ct} markers in "
          f"{st.infile_num} taxa", flush=True)
    _real_chain(work, sres)
    return {"launches": launches, "markers": mk}


def _abv_blocks(path: str, index_of: dict):
    """[(header, sample ids, values)] per query of an abv search text."""
    import numpy as np
    with open(path, "rb") as f:
        blocks = f.read().split(b"#Sample\t")[1:]
    out = []
    for blk in blocks:
        head, _, body = blk.partition(b"\n")
        cols = body.replace(b"\n", b"\t").split(b"\t")[:-1]
        ids = np.fromiter((index_of[n] for n in cols[0::2]), np.int64,
                          len(cols) // 2)
        vals = np.array(cols[1::2]).astype(np.float64) if ids.size \
            else np.zeros(0)
        out.append((head, ids, vals))
    return out


def make_abv_data(work: str, refdir: str, seed: int):
    """One .abv vector per taxon of ``refdir`` over its species dims:
    ABV_DIMS nonzero dims drawn without replacement with prevalence
    falling as 1/rank (Gumbel top-k), lognormal percentages summing to 100.
    Queries: ABV_DB_QUERIES vectors of the DB and ABV_PERTURBED perturbed
    copies of others.  Returns (query paths, sample names, DB queries)."""
    import numpy as np
    from metakssd_tpu_torch.composite import write_abv_file
    from metakssd_tpu_torch.pipeline import CoStat
    rng = np.random.default_rng(seed + 4)
    nsp = CoStat.read(refdir).infile_num
    nvec = nsp
    vdir = os.path.join(refdir, "abundance_Vec")
    os.makedirs(vdir)
    logp = -np.log(np.arange(1, nsp + 1, dtype=np.float64))
    nd = rng.integers(ABV_DIMS[0], ABV_DIMS[1] + 1, nvec)
    top_k = ABV_DIMS[1]
    names = [f"v{i:05d}.abv" for i in range(nvec)]
    vecs = []
    for lo in range(0, nvec, 1024):
        key = logp + rng.gumbel(size=(min(1024, nvec - lo), nsp))
        top = np.argpartition(-key, top_k, axis=1)[:, :top_k]
        top = np.take_along_axis(top, np.argsort(
            -np.take_along_axis(key, top, 1), axis=1), 1)
        for r in range(top.shape[0]):
            d = np.sort(top[r, :nd[lo + r]]).astype(np.int32)
            pct = rng.lognormal(0.0, 1.0, d.size)
            vecs.append((d, pct))
            write_abv_file(os.path.join(vdir, names[lo + r]), d,
                           (pct / pct.sum() * 100).astype(np.float32))
    qdir = os.path.join(work, "abv_queries")
    os.makedirs(qdir)
    pick = rng.choice(nvec, ABV_DB_QUERIES + ABV_PERTURBED, replace=False)
    queries = [os.path.join(vdir, names[i]) for i in pick[:ABV_DB_QUERIES]]
    for j, i in enumerate(pick[ABV_DB_QUERIES:]):
        d, pct = vecs[i]
        pct = pct * rng.lognormal(0.0, 0.3, pct.size)
        queries.append(os.path.join(qdir, f"perturbed{j:03d}.abv"))
        write_abv_file(queries[-1], d,
                       (pct / pct.sum() * 100).astype(np.float32))
    return queries, names, [int(i) for i in pick[:ABV_DB_QUERIES]]


def phase_abv(work: str, seed: int, refdir: str) -> dict:
    """The abv leg: index, sparse search on both routes (identical text),
    dense search on the card (overlap sets, 2e-3 bound and self hits
    against the sparse path) and on the CPU for ABV_CPU_QUERIES queries
    (2e-3 of the card's)."""
    import numpy as np
    import torch
    from metakssd_tpu_torch.ops import dense_abv
    t = time.time()
    queries, names, db_queries = make_abv_data(work, refdir, seed)
    index_of = {n.encode(): i for i, n in enumerate(names)}
    print(f"  data: {len(names)} vectors over {len(names)} species dims, "
          f"{len(queries)} queries in {time.time() - t:.1f} s", flush=True)
    _run_cli("composite -i", ["composite", "-r", refdir, "-i"])
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    _, _, dense = dense_abv._dense_db(refdir, dev)
    torch.cuda.synchronize()
    print(f"  dense DB on the card: {tuple(dense.mat.shape)} float32 "
          f"({dense.mat.numel() * 4 / 2**30:.3f} GiB) in "
          f"{time.time() - t:.3f} s", flush=True)
    nq = len(queries)
    cpu_q = queries[:ABV_CPU_QUERIES // 2] + queries[-ABV_CPU_QUERIES // 2:]
    per256 = {}
    for mode in (0, 1, 2):
        txt = {}
        for route in ("cuda", "cpu"):
            txt[route] = os.path.join(work, f"abv_s{mode}_{route}.txt")
            per256[f"s{mode} sparse {route}"] = _run_cli_to(
                f"composite -s {mode} --device {route}",
                ["composite", "-r", refdir, "-s", str(mode), *queries,
                 "--device", route], txt[route]) * 256 / nq
        with open(txt["cuda"], "rb") as a, open(txt["cpu"], "rb") as b:
            _check(a.read() == b.read(), f"-s {mode}: sparse text differs "
                                         "between the routes")
        for route, qs in (("cuda", queries), ("cpu", cpu_q)):
            txt[f"dense_{route}"] = os.path.join(
                work, f"abv_s{mode}_dense_{route}.txt")
            per256[f"s{mode} dense {route}"] = _run_cli_to(
                f"composite -s {mode} --dense --device {route}",
                ["composite", "-r", refdir, "-s", str(mode), "--dense", *qs,
                 "--device", route], txt[f"dense_{route}"]) * 256 / len(qs)
        sparse = _abv_blocks(txt["cuda"], index_of)
        dense_b = _abv_blocks(txt["dense_cuda"], index_of)
        _check(len(sparse) == len(dense_b) == nq, f"-s {mode}: block count")
        worst, selfs, residues = 0.0, 0, []
        for qi, ((hs, si, sv), (hd, di, dv)) in enumerate(zip(sparse,
                                                              dense_b)):
            _check(hs == hd, f"-s {mode}: headers differ")
            os_, od = np.argsort(si), np.argsort(di)
            _check(np.array_equal(si[os_], di[od]),
                   f"-s {mode}: query {qi} overlap sets differ")
            sv, dv = sv[os_], dv[od]
            check = np.ones(sv.size, bool)
            if mode == 2:
                # a query equal to a DB vector: sparse 0, dense the sqrt of
                # a rounding residue (ROADMAP.md section 3)
                check = sv != 0.0
                selfs += int((~check).sum())
                residues += dv[~check].tolist()
            if check.any():
                worst = max(worst, float(np.abs(dv - sv)[check].max()))
            if mode == 0 and qi < len(db_queries):
                _check(di[0] == db_queries[qi],
                       f"query {qi}: top cosine hit {names[di[0]]} is not "
                       f"itself {names[db_queries[qi]]}")
        _check(worst < DENSE_TOL, f"-s {mode}: dense vs sparse {worst}")
        cpu_b = _abv_blocks(txt["dense_cpu"], index_of)
        cuda_sub = dense_b[:ABV_CPU_QUERIES // 2] + \
            dense_b[-ABV_CPU_QUERIES // 2:]
        self_ids = db_queries[:ABV_CPU_QUERIES // 2] + \
            [-1] * (ABV_CPU_QUERIES // 2)
        cpu_worst = 0.0
        for (_, ci, cv), (_, gi, gv), me in zip(cpu_b, cuda_sub, self_ids):
            oc, og = np.argsort(ci), np.argsort(gi)
            _check(np.array_equal(ci[oc], gi[og]),
                   f"-s {mode}: dense cpu and cuda sample sets differ")
            check = ci[oc] != me if mode == 2 else np.ones(ci.size, bool)
            if check.any():
                cpu_worst = max(cpu_worst, float(np.abs(
                    cv[oc] - gv[og])[check].max()))
        _check(cpu_worst < DENSE_TOL, f"-s {mode}: dense cpu vs cuda "
                                      f"{cpu_worst}")
        lines = sum(b[1].size for b in sparse)
        extra = ""
        if mode == 2:
            r = np.asarray(residues)
            extra = (f"; {selfs} self distances (sparse 0): dense NaN "
                     f"{int(np.isnan(r).sum())}, max "
                     f"{float(np.nanmax(r)) if np.isfinite(r).any() else 0}")
        print(f"  -s {mode}: {lines} lines; sparse text identical between "
              f"routes; dense overlap sets equal, max |dense - sparse| "
              f"{worst:.3g}, dense cpu vs cuda {cpu_worst:.3g}"
              f"{'; every DB query its own top hit' if mode == 0 else ''}"
              f"{extra}", flush=True)
    print(f"  peak device memory (abv leg) "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    print("  seconds per 256 queries: " + json.dumps(
        {k: round(v, 4) for k, v in per256.items()}), flush=True)
    return {"per256": per256}


CUDA_TESTS = ["tests/test_torch_sketch_cuda.py",
              "tests/test_torch_member_cuda.py",
              "tests/test_torch_setops_cuda.py",
              "tests/test_torch_probes_cuda.py"]
PROBE_KERNELS = ("probe_floor", "probe_winmath", "probe_gather",
                 "probe_search")


def phase_probes() -> list:
    """The probe path on the card (launch counts zeroed before it), then
    every variant's kernel against its plain version; one record per
    variant for the kernels' JSON line."""
    import torch
    from metakssd_tpu_torch.ops import sketch_cuda
    from metakssd_tpu_torch.probes import (probe_floor_chunk,
                                           probe_floor_noread,
                                           probe_kernel_cost, probe_r4)
    from metakssd_tpu_torch.probes._common import graph_ms, vary

    mods = (("P1", probe_kernel_cost), ("P2", probe_r4),
            ("P3", probe_floor_chunk), ("P4", probe_floor_noread))
    sketch_cuda.reset_launches()
    runs = [(pid, rec) for pid, mod in mods
            for rec in mod.run(reps=PROBE_REPS)]
    launches = dict(sketch_cuda.LAUNCHES)
    print(f"  probe path launches {launches}", flush=True)
    for kern in PROBE_KERNELS:
        _check(launches[kern] > 0, f"{kern} never launched: {launches}")
        _check(sum(r["launches"] for _, r in runs if r["kernel"] == kern)
               == launches[kern], f"{kern}: launches not all attributed")

    out = []
    for pid, r in runs:
        v = r["variant"]
        if v.plain is None:          # K1/K2 on the probe's windows
            ms = graph_ms(v.run, vary(v.tiles), 5)
            print(f"  {pid} {v.name:30s} {ms:8.4f} ms on the card "
                  f"({r['ms']:.4f} per path dispatch)", flush=True)
            continue
        got, want = v.run(v.tiles), v.plain(v.tiles)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item())
        _check(torch.equal(got, want), f"{pid} {v.name}: kernel != plain")
        plain_ms = _time_ms(lambda: v.plain(v.tiles), 2)
        # the card's time per dispatch: the path's K dispatches replayed
        # from a CUDA graph (the path's own time includes the host's)
        inputs = vary(v.tiles)
        ms = graph_ms(v.run, inputs, 5)
        lib_ms = None
        if v.library is not None:
            try:
                lib_ms = graph_ms(v.library, inputs, 5)
            except (RuntimeError, TypeError) as e:
                print(f"  {pid} {v.name}: no torch.sum for "
                      f"{v.tiles.dtype} here ({e})", flush=True)
        del inputs
        bound_ms, bound_by = _bound(v.nbytes, v.ops)
        lib = "none" if lib_ms is None else f"{lib_ms:.4f}"
        print(f"  {pid} {v.name:30s} {ms:8.4f} ms on the card "
              f"({r['ms']:.4f} per path dispatch)  plain {plain_ms:9.4f}  "
              f"torch.sum {lib}  bound {bound_ms:.4f} ({bound_by}: "
              f"{v.nbytes} B, {v.ops} ops)  launches {r['launches']}  "
              "== plain", flush=True)
        out.append({"name": f"{pid} {v.kernel}: {v.name}", "route": "cuda",
                    "source": "metakssd_tpu_torch/csrc/probe.cu",
                    "replaces": v.replaces, "launches": r["launches"],
                    "max_abs_err": err, "ms": ms, "path_ms": r["ms"],
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms})
        del got, want
    del runs
    torch.cuda.empty_cache()
    return out


def phase_cuda_tests() -> None:
    """The cuda-marked tests, in a child process; fails unless all pass."""
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "-p",
         "no:cacheprovider", *CUDA_TESTS], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:] or [proc.stderr[-500:]]
    print(f"  pytest -m cuda: {tail[0]}", flush=True)
    _check(proc.returncode == 0, "cuda tests failed:\n" + proc.stdout[-4000:]
           + proc.stderr[-2000:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Smoke run of metakssd_tpu_torch on one NVIDIA GPU")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from metakssd_tpu_torch.ops import _build, sketch_cuda
    from metakssd_tpu_torch.probes._common import search_ops

    t0 = time.time()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    _phase("card", t0)

    t0 = time.time()
    _build.library()
    for ln in _build.build_log.splitlines():
        if "registers" in ln or "spill" in ln:
            print("  " + ln.strip(), flush=True)
    _phase("build", t0)

    work = os.path.join(ROOT, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        t0 = time.time()
        kres = phase_kernels(work, args.seed)
        mres = phase_member(args.seed)
        _phase("kernels", t0)

        t0 = time.time()
        sres = phase_slice(work, args.seed)
        _phase("slice", t0)

        t0 = time.time()
        qres = phase_search(work, args.seed)
        _phase("search", t0)

        t0 = time.time()
        setres = phase_set(work, args.seed, sres)
        _phase("set", t0)

        t0 = time.time()
        phase_abv(work, args.seed, setres["markers"])
        _phase("abv", t0)

        t0 = time.time()
        probes = phase_probes()
        _phase("probes", t0)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    t0 = time.time()
    phase_cuda_tests()
    _phase("cuda tests", t0)

    t = kres["times"]
    mt = mres["times"]
    ks = kres["shape"]
    # K1/K2 at the 64M-window L3K11 batch: the codes and both tables read
    # once; K1 writes its survivors' drtuples and the counter, K2 a
    # drtuple and a keep flag per window.  Operations: the window math
    # and a lower bound of ceil(log2 n) steps per window.
    win_ops = ks["nwin"] * search_ops((ks["n_accept"] - 1).bit_length())
    tables = 8 * ks["n_accept"]
    k1_bound = _bound(ks["n_codes"] + tables + 4 * ks["survivors"] + 8,
                      win_ops)
    k2_bound = _bound(ks["n_codes"] + tables + 8 * ks["nwin"], win_ops)
    # K3 at 4.19M x 1M, identity mode: haystack and needles read once, a
    # member flag and a value written per needle; a lower bound each
    ms_ = mres["shape"]
    k3_bound = _bound(4 * ms_["hay"] + 12 * ms_["needles"], ms_["needles"]
                      * (4 * (ms_["hay"] - 1).bit_length() + 4))
    print(json.dumps({"kernels": [
        {"name": "sketch_compact (K1)", "route": "cuda",
         "source": "metakssd_tpu_torch/csrc/sketch.cu",
         "replaces": "metakssd_tpu/ops/sketch_pallas.py:323",
         "launches": sres["launches"]["sketch_compact"],
         "max_abs_err": kres["k1_err"], "ms": t["k1"],
         "plain_ms": t["k1_plain"], "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "sketch_full (K2)", "route": "cuda",
         "source": "metakssd_tpu_torch/csrc/sketch.cu",
         "replaces": "metakssd_tpu/ops/sketch_pallas.py:298",
         "launches": sres["launches"]["sketch_full"],
         "max_abs_err": kres["k2_err"], "ms": t["k2"],
         "plain_ms": t["k2_plain"], "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None},
        {"name": "member (K3)", "route": "cuda",
         "source": "metakssd_tpu_torch/csrc/member.cu",
         "replaces": "metakssd_tpu/ops/merge_device.py:29",
         "launches": qres["launches"]["member"] + setres["launches"],
         "max_abs_err": mres["err"], "ms": mt["k3"],
         "plain_ms": mt["plain"], "bound_ms": k3_bound[0],
         "bound_by": k3_bound[1], "library_ms": mt["library"]},
        *probes,
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
