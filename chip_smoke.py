#!/usr/bin/env python3
"""Smoke run of metakssd_tpu_torch on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py [--seed N]

Phases, in order; each prints its seconds, and any failure exits non-zero:

1. card: requires torch.cuda.is_available(); prints nvidia-smi's
   name and power limit;
2. build: compiles csrc/*.cu with nvcc into metakssd_tpu_torch/_build/;
3. kernels: K1 (compact, with and without positions) and K2 (full)
   against their plain PyTorch versions on the card, on 64M-window
   batches of configs (11,6,3), (8,5,2) and (7,5,3) with 0.1% invalid
   bases, a poly-A stream whose k-mer is accepted, and a forced tiny
   capacity.  On a 1 Mbase slice both also equal the reference:
   ``golden.window_drtuples``, the JAX package's numpy model
   (metakssd_tpu/ops/golden.py), which the port's ``ops.sketch`` already
   runs for configs the kernels do not take.  Then the kernels' filter:
   bitmaps of other sizes than the default (the largest, 2^19 bits, at
   subk = 5 and 6; folds so small that most or all windows pass; the
   direct bitmap of subk = 4), a subk = 7 table of 16,000 dims, a stream
   whose every 2k-th window passes the filter and fails the search
   (timed beside a random stream), and 2^20 windows all kept at a
   capacity between one tile's survivors and all of them.  K1's and K2's
   times are printed beside those of the kernels that searched every
   window, and their bounds.  Then K3 (membership) and its index build
   against their plain versions, in identity and values mode: edge cases
   (a clustered haystack whose first bucket holds 100K keys and whose
   needle blocks span more than the staged window; unsorted needles; 1,
   100, 2047 and 0 needles; an empty and a 15-key haystack, which have
   no index table; 0xFFFFFFFF present and absent), then the three shapes
   of ``probes/bench_member.py``: ``4M x 1M`` (1M sorted needles against
   about 4.19M distinct random u32 keys, half hits), ``dist batch`` (128
   sorted runs of 4096 needles against the same keys: one component of
   ``dist -r``) and ``set -s`` (65,600 sorted runs of 1,024 ids, 94%
   hits, against 19.7M keys: the set leg's ``-s`` call).  At each shape
   K3 must also equal the indexed formulation in plain torch and the
   index kernel ``build_index_plain``; prints K3's time (replayed from a
   CUDA graph, and between CUDA events over back-to-back calls) beside
   its plain version's, ``torch.searchsorted``'s (timed the same two
   ways) and its bound, and the
   index build's likewise (CUDA events after a warm-up, and from a CUDA
   graph; the largest key read on the host before the timed calls, as a
   ``StaticHaystack`` has it, and once with that read inside them);
3b. pipeline: ``sketch_windows``'s pipelined dispatch on an L3K11
   stream of 6 chunks of 2M windows whose chunk 3, queued behind the
   clean chunk 2, holds a poly-A block past its capacity: with
   ``devices`` None, ``[cuda:0]`` and ``[cuda:0, cuda:0]``, twice each,
   the (drtuple, position) pairs equal the ``--device cpu`` run's, K1
   runs once a chunk and K2 once (the overflowing chunk), no chunk's
   count is read before the next chunk's K1 is queued, at most DEPTH
   chunks a device are queued before the oldest is read, and a call
   allocates two pinned upload buffers a card and one count array, none
   a chunk (``probes/chunk_split.checked_run``).  Then the per-chunk
   split of 4 chunks of 64M random windows, the serial order the loop
   had before and the pipelined one, in turns (``chunk_split``);
4. slice: 1024 synthetic 1 Mbp genomes -> MarkerDB with the port's
   ``dist`` (L3K11), a 4M x 150 bp fastq sampled from 32 of them with
   skewed abundance, 0.1% N and a block of poly-A reads, then the port's
   ``profile --device cuda``, the main path.  Launch counts are zeroed
   before each of the two legs and checked for each: K1 ran in ``dist``,
   and K1 and K2 both ran in ``profile``.  Checks that the profile names
   exactly sampled genomes and every genome of coverage >= 1x, and that
   ``--device cpu`` (the plain versions) writes byte-identical TSVs on the
   first 200K reads;
4b. stage1-flags: on phase 4's shuffle, genomes and fastq.  ``dist
   --byread --device cuda`` of the 4M reads (launch counts zeroed: K1 and,
   for the poly-A block's chunk, K2 must run): reads + 1 index entries,
   the last the count of ids, and the distinct ids those of a plain
   ``dist`` (occ); on the first CPU_READS reads the cuda and cpu per-read
   dirs byte-identical and ``reverse -b`` of the card's printing every
   read.  ``dist -P cat`` of those reads, with and without ``-A``,
   byte-identical to ``dist`` of the file.  ``dist --ckpt`` of the genomes
   in groups of 64, crashed by an injected exception after the 4th group
   and resumed (the 12 groups left sketched), byte-identical to phase 4's
   MarkerDB; ``profile --ckpt`` with a snapshot every 2 streamed batches,
   crashed after the 4th and resumed (the batches left sketched),
   byte-identical to phase 4's TSVs.  ``profile --shard-db 1`` (launch
   counts zeroed: K3 and its index once per component), byte-identical to
   phase 4's TSVs; its K3 call timed as phase 3 times its shapes;
5. search: the same genomes sketched at K8S5L2 (the prokaryote default)
   as a reference, and 128 query genomes of 1 Mbp (16 substituted copies
   of distinct references at each of 0.1, 0.5, 1, 2, 5 and 10%, and 32
   unrelated ones).  ``dist -r`` runs on the card (launch counts zeroed
   before it: K3 must run), with ``--device cpu``, against the stage-II
   mco dir (``--component_sz 6``) and with ``--shard-db 1``.  On the
   card K3 and its index build must launch once per component (not once
   per query); the real haystack and needle counts of those calls are
   printed.  ``--shard-db 1`` (launch counts zeroed) must launch K3 once
   per (query, component) with ids, in values mode, and its index once
   per such pair of at least 16 distinct ids.  The four distance.out files must be byte-identical, every
   substituted query's best reference by Jaccard must be its source, the
   median Jaccard must fall strictly with the rate, and no unrelated
   query may reach Jaccard 0.01;
5b. mesh: on phase 4's and phase 5's data, with launch counts zeroed
   before each leg.  ``dist --mesh 4`` of the 1024 genomes (K1 on every
   shard of every genome), byte-identical to phase 4's MarkerDB;
   ``profile --mesh 4`` of the 4M reads (K1 per shard chunk, K2 for the
   poly-A block's) and ``profile --shard-db 4`` (K3 and its index once per
   db shard and component), TSVs byte-identical to phase 4's; ``composite
   -q --shard-db 4`` of the sample's sketch, byte-identical to phase 4's
   species coverage; ``dist -r --shard-db 4`` at K8S5L2 (K3 once per shard
   and (query, component), the query's ids as haystack in values mode),
   distance.out byte-identical to phase 5's.  K3 checked against its
   plain version and timed (from a CUDA graph, beside
   ``torch.searchsorted``, with its bound) at one shard of each of the two
   ``--shard-db 4`` calls.  Then RANKS = 2 processes on the first
   visible card (``CUDA_VISIBLE_DEVICES``), joined by
   ``MKSSD_COORDINATOR=127.0.0.1:<free port>``, so over gloo
   (``tests/ranks.run_ranks``: ``python -m metakssd_tpu_torch.cli`` once
   per verb and rank, ``MKSSD_LOG=json``), running ``dist --mesh 4``,
   ``dist -r --shard-db 4``, ``composite --shard-db 4``, ``set -u`` and
   ``set -g``, each rank into its own dirs: every file of both ranks
   byte-identical to this process's runs; a rank that fails, or one that
   runs a verb past RANKS_TIMEOUT, fails the phase;
5c. collectives: prints ``torch.distributed.is_nccl_available()`` and
   NCCL's version.  (a) The same five verbs, each in a job of one rank
   on the card (``MKSSD_NPROCS=1``), so its collectives run over an NCCL
   group of one: every file byte-identical to phase 5b's one-process
   runs, each TIMER report naming ``nccl (1 rank, 1 card)``, NCCL calls
   above 0 for ``dist --mesh 4``, ``dist -r --shard-db 4`` and ``set
   -u``; each verb's seconds printed beside phase 5b's one-process time,
   with the calls and bytes of its collectives.  (b) ``python -m
   metakssd_tpu_torch.probes.collectives_check`` in a one-rank NCCL
   group: ``gather_arrays`` and ``all_sum`` of CUDA tensors of 0, 1 and
   2^24 + 3 elements (uint8, int32, uint32, int64, uint64) give the input
   back, equal to the numpy forms over gloo.  (c) Phase 5b's reports name
   ``gloo (2 ranks share cuda:0)``.  (d) With two or more visible cards:
   two ranks of one card each run the five verbs over NCCL, byte-identical;
   ``sketch_windows(devices=None)`` deals 2 x cards chunks of 1M windows
   over every card, its pairs equal to the CPU run's; ``make_mesh`` deals
   shards round-robin over the cards.  With one card it prints ``several
   cards: not run (1 visible)``;
6. set: a synthetic L3K11 sketch dir at a MarkerDB build's scale (65,536
   genomes in 16,384 taxa of 4, about 1,024 ids each, 67M ids in all,
   and 64 genomes of taxid 0) goes through ``set -g`` -> ``-q`` -> ``-i``,
   then ``-u``, ``-s`` and ``-c``, with ``--device cuda`` (launch counts
   zeroed before it: K3 and its index build must run; the haystack and
   needle counts of the ``-i`` and ``-s`` calls are printed) and with
   ``--device cpu``; every output dir must be byte-identical between the
   two.  Then the real chain on
   phase 4's genomes (taxa of 4 consecutive genomes): ``set -g/-q/-i``,
   ``dist -A`` of the first 200K reads and ``composite -q``, ``-q -b``
   and ``-q --shard-db 1`` on both devices; TSVs (the ``--shard-db 1`` ones
   too) and ``.abv`` files byte-identical, and every taxon holding a
   genome of coverage >= 1x in those reads reported;
7. abv: one abundance vector per taxon of phase 6's markers (16,384
   vectors over 16,384 species dims, 30-600 nonzero dims of skewed
   prevalence, lognormal percentages), ``composite -i``, and 128 queries
   (96 DB vectors, 32 perturbed copies) through ``composite -s 0/1/2``:
   sparse text identical between the routes; ``--dense`` on the card (a
   1 GiB float32 DB) with the sparse path's overlap sets, within 2e-3 of
   its measures (a query's L2 to itself excepted: ROADMAP.md section 3)
   and every DB query its own top cosine hit; ``--dense --device cpu`` on
   8 queries within 2e-3 of the card's;
8. probes: the probe path P1-P4, the port's counterparts of the TPU
   probes of ``benchmarks/`` (``metakssd_tpu_torch/probes/``), each at its
   file's shapes (2^24 windows per dispatch) and timing method (16
   XOR-varied dispatches, one readback, best of PROBE_REPS), with launch
   counts zeroed before it: every probe kernel must run.  Then each
   variant's CUDA kernel against its plain version on the same input,
   element for element; the card's time of the path's 16 dispatches
   replayed from a CUDA graph (the path's own time includes the host's
   enqueueing): the median and range of PROBE_REPLAYS timings, taken in
   turns with one ``torch.sum``'s for the sums (replayed alike), and the
   plain version's.  P1's exact search runs through K3's index of its
   accept table (built once, before the path: one index launch), held
   against ``build_index_plain`` at the same bucket count; its line
   prints the index's nb, shift and largest bucket;
8b. bench: ``python -m metakssd_tpu_torch.bench`` (the root bench.py's
   legs: sketch reads/s on the card and the CPU, ``kernel_chain_mwin``,
   profile latency, abv q/s sparse and dense, e2e profile cold and
   steady), in a child process, at the root bench's defaults (200K reads,
   4096 species) and at 4M reads against 16,384 species x 3000 ids (the
   CPU sketch there repeated once); each
   line is printed, must hold every key positive, and its legs' launch
   counts (each from 0) must show K1 on the card in the sketch, kernel
   (at least 16) and e2e legs;
9. cuda tests: ``pytest -m cuda`` on the five cuda-marked test files.

The line before the last is the kernels' JSON record, with the launch
counts of the ``profile``, ``dist --byread``, ``dist --mesh 4`` and
``profile --mesh 4`` legs and of each bench run's legs (K1, K2), of the ``dist -r --device cuda``,
``dist -r --shard-db 1``, ``set --device cuda``, ``profile --shard-db 1``, ``profile --shard-db 4``,
``composite --shard-db 4`` and ``dist -r --shard-db 4`` legs (K3 and its
index build; the index build also of the probe path, whose table
counts in the build's ``max_abs_err``), each leg's in
``launches_by_leg`` and
their sum in ``launches``, and of the probe path (P1-P4, one entry per
variant), and each kernel's bound (K3's and the index build's also per
shape, K3's with the ``profile --shard-db 1`` call's and one shard's of
each ``--shard-db 4`` call): the larger of its
bytes over 3.35 TB/s and its 32-bit operations over the card's int32 rate
(SMs x 64 lanes x the largest SM clock, printed in phase 1), counted from
this run's inputs (for K1 and K2, this run's kept windows; for K3, the
bucket of each needle in this run's index).  The last line is ``{"ok":
true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.  All data is made from --seed with numpy under
``.smoke_work/`` and removed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

try:
    from metakssd_tpu_torch.probes.smoke_data import (
        CPU_READS, GENOME_LEN, L3K11, N_GENOMES, N_POLYA, N_READS, READ_LEN,
        SET_PER_TAXON, SET_POOL, SET_SHARED, SET_TAXA, SET_UNASSIGNED, check,
        make_set_data, make_slice_data, read_fasta, run_cli, set_leg,
        stage_seconds, write_fasta, write_fastq, write_zero_accepted_shuf)
except ImportError as e:
    sys.exit(f"chip_smoke: needs the checkout it lies in ({e})")

CHECK_CONFIGS = [(11, 6, 3), (8, 5, 2), (7, 5, 3)]
BATCH_WINDOWS = 64 << 20          # the streaming batch size, in windows
FILTER_WINDOWS = 4 << 20          # windows of each extra filter check
K1_MS_BEFORE = 1.3424             # K1 and K2 per 64M-window L3K11 batch when
K2_MS_BEFORE = 1.8297             # they searched every window (PERF.md table)
ALL_ONES = 0xFFFFFFFF
MEMBER_HAY = 1 << 22              # K3 edge cases' haystack draw (4.19M)
K8S5L2 = (8, 5, 2)                # the prokaryote default of dist search
RATES = (0.001, 0.005, 0.01, 0.02, 0.05, 0.10)   # query substitution rates
N_PER_RATE = 16                   # mutated queries per rate
N_UNRELATED = 32                  # queries from no reference genome
CHAIN_TAXON = 4                   # real chain: taxa of 4 consecutive genomes
ABV_DIMS = (30, 600)              # nonzero dims of an abundance vector
ABV_DB_QUERIES = 96               # queries that are vectors of the DB ...
ABV_PERTURBED = 32                # ... and perturbed copies of DB vectors
ABV_CPU_QUERIES = 8               # dense queries run on the CPU too
DENSE_TOL = 2e-3                  # dense vs sparse (tests/test_dense_abv.py)
PROBE_REPS = 3                    # timed runs of each probe variant
PROBE_REPLAYS = 5                 # graph timings of each (median, range)
PROFILE_TSVS = ("species_coverage.tsv", "abundance.tsv")
HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory rate
INT32_LANES_PER_SM = 64           # Hopper: int32 operations per SM per clock
INT32_OPS_PER_S = 0.0             # set from the card by card_int32_rate()


def card_int32_rate() -> float:
    """The card's int32 rate: SMs x 64 lanes x the largest SM clock that
    nvidia-smi reports.  Every kernel here does integer work, so this,
    not the float32 rate (which counts a fused multiply-add as two and
    has twice the lanes), bounds their operations."""
    global INT32_OPS_PER_S
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    INT32_OPS_PER_S = sms * INT32_LANES_PER_SM * mhz * 1e6
    print(f"int32 rate: {sms} SMs x {INT32_LANES_PER_SM} lanes x {mhz:.0f} "
          f"MHz = {INT32_OPS_PER_S / 1e12:.3f} T/s", flush=True)
    return INT32_OPS_PER_S


def _bound(nbytes: int, ops: int) -> tuple[float, str]:
    """(least ms for the work, what bounds it): bytes over the device
    memory rate, 32-bit integer operations over the card's int32 rate."""
    check(INT32_OPS_PER_S > 0, "card_int32_rate() has not run")
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _phase(name: str, t0: float) -> None:
    print(f"phase {name}: {time.time() - t0:.3f} s", flush=True)


def _u32(t):
    import numpy as np
    return t.cpu().numpy().view(np.uint32)


def _pairs(dr, pos):
    import numpy as np
    order = np.lexsort((dr, pos))
    return np.asarray(pos)[order], np.asarray(dr)[order]


def _k1_k2_vs_plain(c, tabs, p, cap, what: str, res: dict) -> int:
    """K1 (with positions) at ``cap`` and K2 on the CUDA codes ``c``
    against their plain versions, element for element; updates the max
    errors in ``res`` and returns the count of kept windows."""
    import numpy as np
    import torch
    from metakssd_tpu_torch.ops import sketch_cuda

    dr, pos, cnt = sketch_cuda.window_compact(c, tabs, p, cap, True)
    pdr, ppos, pcnt = sketch_cuda.window_compact_plain(c, tabs, p, cap, True)
    m = int(cnt.item())
    check(m == int(pcnt.item()), f"{what} K1 count {m} vs plain "
                                  f"{int(pcnt.item())}")
    fdr, fk = sketch_cuda.window_full(c, tabs, p)
    gdr, gk = sketch_cuda.window_full_plain(c, tabs, p)
    res["k2_err"] = max(res["k2_err"], int(
        ((fdr.long() & ALL_ONES) - (gdr.long() & ALL_ONES))
        .abs().max().item()))
    check(torch.equal(fdr, gdr) and torch.equal(fk, gk),
           f"{what} K2 vs plain")
    check(int(fk.sum().item()) == m, f"{what} K2 keeps {m} windows")
    w = min(m, cap)
    at = pos[:w].cpu().numpy()
    if m <= cap:
        a, b = np.sort(_u32(dr[:m])), np.sort(_u32(pdr[:m]))
        if m:
            res["k1_err"] = max(res["k1_err"], int(np.abs(
                a.astype(np.int64) - b.astype(np.int64)).max()))
        check(np.array_equal(a, b), f"{what} K1 drtuple multiset")
        pa = _pairs(_u32(dr[:m]), at)
        pb = _pairs(_u32(pdr[:m]), ppos[:m].cpu().numpy())
        check(np.array_equal(pa[0], pb[0]) and np.array_equal(pa[1], pb[1]),
               f"{what} K1 (drtuple, position) pairs")
    else:
        # past the capacity K1 holds `cap` distinct kept windows, each
        # with its own drtuple (K2's, which equals the plain version's)
        check(np.unique(at).size == w and np.array_equal(
            _u32(dr[:w]), _u32(fdr)[at]) and bool(fk.cpu().numpy()[at].all()),
            f"{what} K1 slots at capacity {cap} of {m}")
    # without positions: the same count and multiset
    dr2, none, cnt2 = sketch_cuda.window_compact(c, tabs, p, cap)
    check(none is None and int(cnt2.item()) == m, f"{what} K1 no-pos count")
    if m <= cap:
        check(np.array_equal(np.sort(_u32(dr2[:m])), np.sort(_u32(dr[:m]))),
               f"{what} K1 without positions")
    return m


def _filter_cases(work: str, seed: int, res: dict) -> None:
    """What the filter adds to check: bitmaps of other sizes (the
    largest, 2^19 bits, leaves two blocks to an SM; subk = 4 is direct),
    a subk = 7 table near the largest the kernel path takes, a stream of
    false positives, and a stream kept whole at a capacity between one
    tile's survivors and all of them."""
    import numpy as np
    import torch
    from metakssd_tpu_torch.ops import sketch_cuda, sketch_filter
    from metakssd_tpu_torch.params import SketchParams
    from metakssd_tpu_torch.probes.bench_member import time_ms
    from metakssd_tpu_torch.profile_e2e import read_shuf
    from metakssd_tpu_torch.state import accept_tables, make_accept_tables

    def sized(shuf, log2):
        tups, pf = shuf.device_tables()[:2]
        return make_accept_tables(tups, pf, shuf.params.subk, dev, log2)

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 5)
    n = FILTER_WINDOWS + 31
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    codes[rng.integers(0, n, n // 1000)] = 4
    codes[1 << 20:(1 << 20) + 10_000] = 0
    write_zero_accepted_shuf(os.path.join(work, "K6S4L2.shuf"), (6, 4, 2),
                             seed)
    for cfg, log2 in (((8, 5, 2), 19), ((7, 5, 3), 16), ((11, 6, 3), 19),
                      ((11, 6, 3), 12), ((8, 5, 2), 10), ((6, 4, 2), None)):
        shuf = read_shuf(os.path.join(work, "K%dS%dL%d.shuf" % cfg))
        p = shuf.params
        tabs = sized(shuf, log2)
        log2 = tabs.filter_log2
        check((log2 == 4 * p.subk) == (cfg == (6, 4, 2)),
              f"{cfg}: 2^{log2}-bit filter, direct or not")
        c = torch.from_numpy(codes[:FILTER_WINDOWS + p.kmer_len - 1]).to(dev)
        m = _k1_k2_vs_plain(c, tabs, p, FILTER_WINDOWS, f"{cfg} 2^{log2}-bit "
                            "filter", res)
        ncand = sketch_cuda.filter_candidates(c, tabs, p)[0].numel()
        print(f"  {cfg} filter of 2^{log2} bits: {ncand} candidates, {m} kept "
              f"of {FILTER_WINDOWS} windows == plain", flush=True)

    # subk = 7, 16,000 accepted dims (no shuffle file gives more than
    # 4096; the kernels take any sorted table): the largest fold, 2^19
    p = SketchParams(9, 7, 4)
    acc = np.unique(rng.integers(0, p.shuf_len, 16_000)).astype(np.uint32)
    acc[0] = 0
    pf = rng.integers(0, 1 << 12, acc.size).astype(np.uint32)
    pf[0] = 0
    tabs = make_accept_tables(acc, pf, p.subk, dev)
    check(tabs.filter_log2 == 19, f"subk 7 filter 2^{tabs.filter_log2}")
    hits, _ = sketch_filter.codes_with_dims(
        rng.choice(acc, 100_000).astype(np.int64), p, seed + 6)
    fdims = sketch_filter.false_positive_dims(
        tabs.accept, tabs.filter, 19, p.subk, 1 << 22, seed + 7)
    fps, fkept = sketch_filter.codes_with_dims(fdims[:100_000], p, seed + 8)
    c = torch.from_numpy(np.concatenate(
        [codes[:FILTER_WINDOWS // 2], hits, fps])).to(dev)
    m = _k1_k2_vs_plain(c, tabs, p, c.numel(), "subk 7 table", res)
    ncand = sketch_cuda.filter_candidates(c, tabs, p)[0].numel()
    check(m > 25_000 and ncand >= m + fkept.size, "subk 7: too few hits or "
                                                   "false positives")
    print(f"  (9, 7, 4) table of {acc.size} dims, 2^19-bit fold: {ncand} "
          f"candidates ({fkept.size} made false positives), {m} kept of "
          f"{c.numel() - p.kmer_len + 1} windows == plain", flush=True)

    # false positives at L3K11's default bitmap: every 2k-th window passes
    # the filter and fails the search; time beside the random stream's
    shuf = read_shuf(os.path.join(work, "K%dS%dL%d.shuf" % L3K11))
    p = shuf.params
    tabs = accept_tables(shuf, dev)
    fdims = sketch_filter.false_positive_dims(
        tabs.accept, tabs.filter, tabs.filter_log2, p.subk, 1 << 22, seed + 9)
    fps, fkept = sketch_filter.codes_with_dims(fdims[:60_000], p, seed + 10)
    stream = np.tile(fps, FILTER_WINDOWS // fps.size + 1)[
        :FILTER_WINDOWS + p.kmer_len - 1]
    c = torch.from_numpy(stream).to(dev)
    m = _k1_k2_vs_plain(c, tabs, p, FILTER_WINDOWS, "false positives", res)
    ncand = sketch_cuda.filter_candidates(c, tabs, p)[0].numel()
    check(ncand > 20 * max(m, 1) and ncand > FILTER_WINDOWS // 30,
           f"false-positive stream: {ncand} candidates, {m} kept")
    r = torch.from_numpy(codes[:FILTER_WINDOWS + p.kmer_len - 1]).to(dev)
    cap = sketch_cuda.default_capacity(FILTER_WINDOWS, tabs)
    t_fp = time_ms(lambda: sketch_cuda.window_compact(c, tabs, p, cap), 10)
    t_rand = time_ms(lambda: sketch_cuda.window_compact(r, tabs, p, cap), 10)
    rcand = sketch_cuda.filter_candidates(r, tabs, p)[0].numel()
    print(f"  false positives, {L3K11}: {ncand} candidates, {m} kept of "
          f"{FILTER_WINDOWS} windows == plain; K1 {t_fp:.4f} ms against "
          f"{t_rand:.4f} ms on a random stream ({rcand} candidates)",
          flush=True)

    # every window kept over 256 tiles, at a capacity between one tile's
    # survivors (4096) and all of them
    for cfg in (L3K11, K8S5L2):
        shuf = read_shuf(os.path.join(work, "K%dS%dL%d.shuf" % cfg))
        p = shuf.params
        tabs = accept_tables(shuf, dev)
        pa = torch.zeros((1 << 20) + p.kmer_len - 1, dtype=torch.uint8,
                         device=dev)
        m = _k1_k2_vs_plain(pa, tabs, p, 300_000, f"{cfg} all kept", res)
        check(m == 1 << 20, f"{cfg} all kept: {m}")
    print("  all windows kept (2^20, 256 tiles) at capacity 300000: count "
          "runs on, slots hold distinct kept windows, K2 == plain",
          flush=True)


def _k12_bounds(ks: dict):
    """Bounds of K1 and K2 at the 64M-window L3K11 batch: the codes, both
    tables and the filter bitmap read once; K1 writes its survivors'
    drtuples and the counter, K2 a drtuple and a keep flag per window.
    Operations: the scan's tuple extraction and one filter test per
    window, and for this run's kept windows a lower bound of
    ceil(log2 n) steps and the drtuple.  The filter's other candidates
    (printed by the kernels phase) are the design's cost, not the
    function's, and do not enter the bound."""
    from metakssd_tpu_torch.probes._common import filter_ops
    ops = filter_ops(ks["nwin"], ks["survivors"],
                     (ks["n_accept"] - 1).bit_length())
    read = ks["n_codes"] + 8 * ks["n_accept"] + ks["filter_bytes"]
    return (_bound(read + 4 * ks["survivors"] + 8, ops),
            _bound(read + 8 * ks["nwin"], ops))


def _k12_lines(kres: dict) -> None:
    """K1's and K2's times beside those of the kernels that searched
    every window, and their bounds."""
    t = kres["times"]
    for name, key, before, bound in zip(
            ("K1 sketch_compact", "K2 sketch_full"), ("k1", "k2"),
            (K1_MS_BEFORE, K2_MS_BEFORE), _k12_bounds(kres["shape"])):
        print(f"{name}: {t[key]:.4f} ms per 64M-window L3K11 batch "
              f"(search of every window: {before:.4f} ms, "
              f"{before / t[key]:.2f}x); bound {bound[0]:.4f} ms by "
              f"{bound[1]}, {100 * bound[0] / t[key]:.1f}% of the time",
              flush=True)


def phase_kernels(work: str, seed: int) -> dict:
    """K1/K2 vs plain on the card; returns times and max errors."""
    import numpy as np
    import torch
    from metakssd_tpu_torch.ops import sketch_cuda
    from metakssd_tpu_torch.ops.sketch import golden
    from metakssd_tpu_torch.probes.bench_member import time_ms
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

        # K1 with and without positions and K2 vs plain, element for element
        m = _k1_k2_vs_plain(c, tabs, p, cap, f"{cfg}", res)
        check(0 < m <= cap, f"{cfg} K1 count {m} at capacity {cap}")
        ncand = sketch_cuda.filter_candidates(c, tabs, p)[0].numel()

        # forced tiny capacity: the count keeps counting past it
        _, _, cnt = sketch_cuda.window_compact(c, tabs, p, 100, True)
        check(int(cnt.item()) == m, f"{cfg} K1 count past capacity")

        # 1 Mbase slice: the chunk loop (K1, positions) and K2 equal golden,
        # also through the overflow rerun at a tiny capacity
        sl = codes[:1 << 20]
        gd, gp = golden.window_drtuples(sl, shuf, return_positions=True)
        for capacity in (None, 100):
            d, ps = sketch_cuda.sketch_windows(sl, p, tabs, want_pos=True,
                                               capacity=capacity)
            x, y = _pairs(d.astype(np.uint64), ps), _pairs(gd, gp)
            check(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]),
                   f"{cfg} chunk loop vs golden (capacity {capacity})")
        fdr, fk = sketch_cuda.window_full(
            torch.from_numpy(sl).to(dev), tabs, p)
        keep = fk.cpu().numpy().astype(bool)
        check(np.array_equal(np.flatnonzero(keep), gp) and np.array_equal(
            _u32(fdr)[keep].astype(np.uint64), gd), f"{cfg} K2 vs golden")

        # poly-A stream: every window kept, past the default capacity
        pa_codes = np.zeros(1 << 20, np.uint8)
        pc = torch.from_numpy(pa_codes).to(dev)
        npa = pa_codes.size - p.kmer_len + 1
        pcap = sketch_cuda.default_capacity(npa, tabs)
        _, _, cnt = sketch_cuda.window_compact(pc, tabs, p, pcap)
        check(int(cnt.item()) == npa > pcap, f"{cfg} poly-A K1 count")
        fdr, fk = sketch_cuda.window_full(pc, tabs, p)
        gdr, gk = sketch_cuda.window_full_plain(pc, tabs, p)
        check(torch.equal(fdr, gdr) and torch.equal(fk, gk)
               and int(fk.sum().item()) == npa, f"{cfg} poly-A K2")
        d, _ = sketch_cuda.sketch_windows(pa_codes, p, tabs)
        check(d.size == npa and not d.any(), f"{cfg} poly-A chunk loop")

        # times at the 64M-window batch (k1: positions off, the streaming
        # path; k1_pos: positions on, the genome path)
        t = {
            "k1": time_ms(lambda: sketch_cuda.window_compact(
                c, tabs, p, cap), 10),
            "k1_pos": time_ms(lambda: sketch_cuda.window_compact(
                c, tabs, p, cap, True), 10),
            "k1_plain": time_ms(lambda: sketch_cuda.window_compact_plain(
                c, tabs, p, cap, False), 3),
            "k2": time_ms(lambda: sketch_cuda.window_full(c, tabs, p), 10),
            "k2_plain": time_ms(lambda: sketch_cuda.window_full_plain(
                c, tabs, p), 3),
        }
        for name, ms in t.items():
            print(f"  {cfg} {name:9s} {ms:10.4f} ms  "
                  f"{nwin / ms / 1e3:10.1f} Mwin/s", flush=True)
        print(f"  {cfg} kernels == plain (K1 {m} survivors and {ncand} "
              f"filter candidates of {nwin} windows, 2^{tabs.filter_log2}-"
              "bit filter; K2 all windows), == golden on 1 Mbase, poly-A "
              "and forced-capacity overflow ok", flush=True)
        if cfg == L3K11:
            res["times"] = t
            res["shape"] = {"n_codes": n, "nwin": nwin,
                            "n_accept": tabs.size, "survivors": m,
                            "filter_bytes": 4 * tabs.filter.numel()}
        del c, codes
        torch.cuda.empty_cache()
    _filter_cases(work, seed, res)
    torch.cuda.empty_cache()
    return res


PIPE_CHUNK = 1 << 21              # the pipeline phase's chunks (windows) ...
PIPE_CHUNKS = 6                   # ... and their count; chunk 3 overflows
SPLIT_CHUNKS = 4                  # 64M-window chunks of the per-chunk split


def phase_pipeline(work: str, seed: int) -> None:
    """The chunk loop's pipelined dispatch against its CPU run and its
    contract, then its per-chunk split, printed."""
    import numpy as np
    from metakssd_tpu_torch.ops import sketch_cuda
    from metakssd_tpu_torch.probes import chunk_split
    from metakssd_tpu_torch.state import accept_tables

    shuf = write_zero_accepted_shuf(os.path.join(work, "pipeline.shuf"),
                                    L3K11, seed)
    p = shuf.params
    rng = np.random.default_rng(seed + 3)
    codes = rng.integers(0, 4, size=PIPE_CHUNKS * PIPE_CHUNK - 1000,
                         dtype=np.uint8)
    codes[rng.integers(0, codes.size, codes.size // 1000)] = 4
    codes[3 * PIPE_CHUNK + 1000:3 * PIPE_CHUNK + (1 << 20)] = 0
    t = time.time()
    ref = sketch_cuda.sketch_windows(codes, p, accept_tables(shuf, "cpu"),
                                     want_pos=True, chunk_windows=PIPE_CHUNK)
    print(f"  --device cpu: {ref[0].size} kept windows in "
          f"{time.time() - t:.1f} s", flush=True)
    tabs = accept_tables(shuf, "cuda")
    for devices in (None, ["cuda:0"], ["cuda:0", "cuda:0"]):
        for _ in range(2):
            try:
                chunk_split.checked_run(codes, p, tabs, PIPE_CHUNK, None,
                                        devices, ref, reruns=1)
            except AssertionError as e:
                check(False, f"pipelined chunk loop: {e}")
        print(f"  devices={devices}: pairs == cpu, {PIPE_CHUNKS} K1 + 1 K2, "
              "order and pinned buffers ok", flush=True)
    dr, _ = sketch_cuda.sketch_windows(codes, p, tabs,
                                       chunk_windows=PIPE_CHUNK)
    check(np.array_equal(np.sort(dr), np.sort(ref[0])),
          "pipelined chunk loop without positions")
    big = rng.integers(0, 4, size=SPLIT_CHUNKS * sketch_cuda.CHUNK_WINDOWS
                       + p.kmer_len - 1, dtype=np.uint8)
    for order in ("serial", "pipelined", "pipelined", "serial"):
        split = chunk_split.serial_split if order == "serial" \
            else chunk_split.pipelined_split
        print("  split " + json.dumps(split(big, p, tabs,
                                            sketch_cuda.CHUNK_WINDOWS)),
              flush=True)


def _member_cases(seed: int):
    """(name, haystack, values, needles) uint32 numpy edge cases of K3."""
    import numpy as np
    rng = np.random.default_rng(seed + 1)

    def u32(lo, hi, n):
        return rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32)

    def half_hits(hay, n):
        return np.sort(np.concatenate([rng.choice(hay, n // 2),
                                       u32(0, ALL_ONES, n - n // 2)]))

    hay = np.unique(u32(0, ALL_ONES, MEMBER_HAY))     # keys >= 2^31 too
    vals = u32(0, 1 << 32, hay.size)
    dense = np.unique(np.concatenate([u32(0, 1 << 17, 100_000),
                                      u32(1 << 30, 1 << 31, 1_000_000)]))
    # 100K keys in one bucket of the index; blocks wider than the window
    yield ("clustered", dense, u32(0, 1 << 32, dense.size), np.sort(
        np.concatenate([u32(0, 1 << 17, 3000), rng.choice(dense, 200_000)])))
    yield ("unsorted", hay, vals, rng.permutation(half_hits(hay, 300_000)))
    for n in (1, 100, 2047, 0):
        yield f"{n} needles", hay, vals, half_hits(hay, n)
    yield ("empty haystack", np.zeros(0, np.uint32), np.zeros(0, np.uint32),
           half_hits(hay, 1000))
    yield ("15-key haystack", hay[:15], vals[:15], half_hits(hay[:15], 500))
    ones = np.full(3, ALL_ONES, np.uint32)
    yield ("0xFFFFFFFF absent", hay, vals,
           np.sort(np.concatenate([half_hits(hay, 10_000), ones])))
    with_ones = np.append(hay, np.uint32(ALL_ONES))
    yield ("0xFFFFFFFF present", with_ones, np.append(vals, np.uint32(7)),
           np.sort(np.concatenate([half_hits(hay, 10_000), ones])))


def _k3_vs_plain(name, h, vals, nd, index) -> int:
    """K3 (through ``index``, or building one) against member_plain in
    identity mode and, where ``vals`` are given, values mode, and against
    the indexed formulation in plain torch; returns the max value error
    and checks the hits."""
    import torch
    from metakssd_tpu_torch.ops import merge
    err = 0
    for v in (None,) if vals is None else (None, vals):
        m, val = merge.member(h, v, nd, index)
        pm, pv = merge.member_plain(h, v, nd)
        torch.cuda.synchronize()
        check(torch.equal(m, pm), f"K3 {name}: member differs from plain")
        if nd.numel():
            err = max(err, int(((val.long() & ALL_ONES)
                                - (pv.long() & ALL_ONES)).abs().max()
                               .item()))
        check(torch.equal(val, pv), f"K3 {name}: value differs")
        if index is not None:
            im, iv = merge.member_indexed_plain(h, v, nd, index)
            check(torch.equal(m, im) and torch.equal(val, iv),
                   f"K3 {name}: differs from the indexed plain version")
        del pm, pv
    hits = int(m.sum().item())
    print(f"  K3 {name:18s} haystack {h.numel():9d} needles "
          f"{nd.numel():9d} members {hits:9d} == plain", flush=True)
    return err


def _k3_ops(x64, index, nh: int) -> int:
    """int32 operations of K3's indexed search of these needles (int64
    copies of the u32 keys): per needle 4 for its bucket's bounds (shift,
    compare, two table reads), 4 for each halving step of a lower-bound
    search of its bucket (bitlen of the bucket's size), and 4 for the
    compare and the two writes.  Counted from this run's needles and
    index: a needle above every key has an empty bucket."""
    import torch
    if index.nb:
        t = index.table.long() & ALL_ONES
        b = x64 >> index.shift
        inside = b < index.nb
        b = b.clamp(max=index.nb - 1)
        size = torch.where(inside, t[b + 1] - t[b], 0)
        del t, b, inside
    else:
        size = torch.full_like(x64, nh)
    # frexp's exponent is bitlen for a size > 0, and 0 for 0
    steps = int(torch.frexp(size.double()).exponent.long().sum().item())
    return 8 * x64.numel() + 4 * steps


def phase_member(seed: int) -> dict:
    """K3 and its index build against their plain versions on the card,
    in identity and values mode: the edge cases, then the three shapes of
    ``probes/bench_member.py`` (``4M x 1M``, ``dist batch``, ``set -s``),
    each timed beside its plain version, ``torch.searchsorted`` and its
    bound.  Returns the max value error of K3 and of its index and the
    per-shape records."""
    import numpy as np
    import torch
    from metakssd_tpu_torch.ops import merge
    from metakssd_tpu_torch.probes import bench_member
    from metakssd_tpu_torch.probes.bench_member import time_ms

    dev = torch.device("cuda")
    err = index_err = 0
    for name, hay, vals, needles in _member_cases(seed):
        h = merge.u32_tensor(hay).to(dev)
        nd = merge.u32_tensor(needles).to(dev)
        err = max(err, _k3_vs_plain(name, h, merge.u32_tensor(vals).to(dev),
                                    nd, None))
        if name.startswith("0xFFFFFFFF"):
            m, _ = merge.member(h, None, nd)
            tail = m[nd == -1].bool()
            check(bool(tail.all()) if "present" in name
                   else not bool(tail.any()), f"K3 {name}")
    shapes = []
    for name in bench_member.SHAPES:
        h, v, x = bench_member.make_shape(name, seed, dev)
        ix = merge.build_index(h)
        plain_ix = merge.build_index_plain(h)
        torch.cuda.synchronize()
        check((ix.nb, ix.shift) == (plain_ix.nb, plain_ix.shift)
               and torch.equal(ix.table, plain_ix.table),
               f"K3 index {name}: differs from build_index_plain")
        if ix.nb:
            index_err = max(index_err, int(
                ((ix.table.long() & ALL_ONES)
                 - (plain_ix.table.long() & ALL_ONES)).abs().max().item()))
        err = max(err, _k3_vs_plain(name, h, v, x, ix))
        rec = _k3_record(name, h, x, ix)
        # the index kernel with the largest key read beforehand (a
        # StaticHaystack has it on the host), beside the call that reads
        # it from the card, and torch.searchsorted of the same boundaries;
        # events and graph replay alike
        h64 = h.long() & ALL_ONES
        b64 = torch.arange(ix.nb, dtype=torch.int64, device=dev) << ix.shift
        mk = int(h[-1].item()) & ALL_ONES
        rec.update({
            "nb": ix.nb, "shift": ix.shift,
            "index_ms": time_ms(lambda: merge.build_index(h, mk), 5),
            "index_graph_ms": bench_member.graph_ms(
                lambda: merge.build_index(h, mk)),
            "index_read_ms": time_ms(lambda: merge.build_index(h), 5),
            "index_plain_ms": time_ms(lambda: merge.build_index_plain(h), 5),
            "index_library_ms": time_ms(
                lambda: torch.searchsorted(h64, b64), 5),
            "index_library_graph_ms": bench_member.graph_ms(
                lambda: torch.searchsorted(h64, b64))})
        if name == "4M x 1M":
            rec["values_k3_ms"] = time_ms(
                lambda: merge.member(h, v, x, ix), 20)
            rec["values_plain_ms"] = time_ms(
                lambda: merge.member_plain(h, v, x), 5)
        rec["index_bound_ms"], rec["index_bound_by"] = _bound(
            4 * rec["nh"] + 4 * (ix.nb + 1),
            ix.nb * (4 * (rec["nh"] - 1).bit_length() + 4))
        print(f"  K3 {name}: index of {ix.nb} buckets (shift {ix.shift}) "
              f"{rec['index_ms']:.4f} ms (graph replay "
              f"{rec['index_graph_ms']:.4f}; with the read of the largest "
              f"key {rec['index_read_ms']:.4f})  plain "
              f"{rec['index_plain_ms']:.4f}  torch.searchsorted "
              f"{rec['index_library_ms']:.4f} (graph replay "
              f"{rec['index_library_graph_ms']:.4f})  bound "
              f"{rec['index_bound_ms']:.4f} ({rec['index_bound_by']})"
              + ("" if name != "4M x 1M" else
                 f"; values mode K3 {rec['values_k3_ms']:.4f} ms, plain "
                 f"{rec['values_plain_ms']:.4f}"), flush=True)
        shapes.append(rec)
        del h, v, x, h64, b64
        torch.cuda.empty_cache()
    return {"err": err, "index_err": index_err, "shapes": shapes}


def _tsv_rows(path: str) -> list:
    with open(path) as f:
        return [ln.split("\t") for ln in f.read().splitlines()]


def phase_slice(work: str, seed: int) -> dict:
    import torch
    from metakssd_tpu_torch import cli
    from metakssd_tpu_torch.ops import sketch_cuda
    from metakssd_tpu_torch.pipeline import TIMER

    t0 = time.time()
    shufp, gdir, fq, reads, coverage, sub_coverage = make_slice_data(
        work, seed)
    print(f"  data: {N_GENOMES} genomes x {GENOME_LEN} bp, "
          f"{reads.shape[0]} reads x {READ_LEN} bp ({N_POLYA} poly-A) in "
          f"{time.time() - t0:.1f} s", flush=True)
    db = os.path.join(work, "markerdb")
    out = os.path.join(work, "profile_cuda")

    torch.cuda.reset_peak_memory_stats()
    sketch_cuda.reset_launches()
    t = time.time()
    check(cli.main(["dist", "-L", shufp, "-o", db, "--device", "cuda",
                     gdir]) == 0, "dist (MarkerDB build) failed")
    dist_s = time.time() - t
    dist_launches = dict(sketch_cuda.LAUNCHES)
    print(f"  dist    {dist_s:.3f} s  launches {dist_launches}", flush=True)
    check(dist_launches["sketch_compact"] > 0,
           f"K1 never launched in dist: {dist_launches}")

    sketch_cuda.reset_launches()
    t = time.time()
    check(cli.main(["profile", "-L", shufp, "-r", db, "-o", out,
                     "--device", "cuda", fq]) == 0, "profile failed")
    profile_s = time.time() - t
    launches = dict(sketch_cuda.LAUNCHES)
    stages = stage_seconds(TIMER)
    peak = torch.cuda.max_memory_allocated()
    print(f"  profile {profile_s:.3f} s  launches {launches}  stages "
          f"{json.dumps(stages)}", flush=True)
    print(f"  peak device memory (dist and profile) {peak / 2**20:.1f} MiB",
          flush=True)
    check(launches["sketch_compact"] > 0 and launches["sketch_full"] > 0,
           f"a sketch kernel never launched in profile: {launches}")

    rows = _tsv_rows(os.path.join(out, "abundance.tsv"))
    names = {r[1] for r in rows}
    check(rows and names <= set(coverage),
           f"abundance.tsv names unsampled genomes: {names - set(coverage)}")
    missing = [g for g, cov in coverage.items() if cov >= 1 and g not in names]
    check(not missing, f"genomes of coverage >= 1x missing: {missing}")
    print(f"  abundance.tsv: {len(rows)} genomes, all sampled; "
          f"{sum(c >= 1 for c in coverage.values())} of {len(coverage)} "
          "sampled genomes have coverage >= 1x and all are present",
          flush=True)

    # the same profile on the first reads: CUDA kernels vs plain on CPU
    sub = os.path.join(work, "subset.fq")
    write_fastq(sub, reads[:CPU_READS])
    del reads
    sub_out = {}
    for dev in ("cuda", "cpu"):
        sub_out[dev] = os.path.join(work, f"subset_{dev}")
        t = time.time()
        check(cli.main(["profile", "-L", shufp, "-r", db, "-o",
                         sub_out[dev], "--device", dev, sub]) == 0,
               f"subset profile --device {dev} failed")
        print(f"  subset ({CPU_READS} reads) --device {dev}: "
              f"{time.time() - t:.3f} s", flush=True)
    _same_files(sub_out["cuda"], sub_out["cpu"], PROFILE_TSVS,
                "subset profile, --device cuda and --device cpu")
    print("  subset: --device cuda and --device cpu TSVs byte-identical",
          flush=True)
    return {"launches": launches, "shuf": shufp, "markerdb": db,
            "subset": sub, "sub_coverage": sub_coverage, "genomes": gdir,
            "fastq": fq, "profile": out, "profile_s": profile_s,
            "dist_s": dist_s}


class _Injected(RuntimeError):
    """The crash that the --ckpt legs inject."""


def _crash_after(mod, name: str, n_ok: int, calls: list):
    """Replace mod.name by a wrapper that counts its calls in ``calls``
    and raises _Injected on call n_ok + 1 (n_ok None: never); returns the
    function it replaced."""
    real = getattr(mod, name)

    def wrapped(*a, **kw):
        if n_ok is not None and len(calls) >= n_ok:
            raise _Injected(f"injected crash after {n_ok} calls of {name}")
        calls.append(1)
        return real(*a, **kw)
    setattr(mod, name, wrapped)
    return real


def _interrupted(label: str, argv: list, mod, name: str, n_ok: int) -> int:
    """Run the CLI with mod.name crashing after n_ok calls, then again
    from its checkpoint; returns the calls of the resumed run."""
    from metakssd_tpu_torch import cli
    first: list = []
    real = _crash_after(mod, name, n_ok, first)
    try:
        cli.main(argv)
        check(False, f"{label}: the injected crash did not happen")
    except _Injected:
        pass
    finally:
        setattr(mod, name, real)
    again: list = []
    _crash_after(mod, name, None, again)
    try:
        t = time.time()
        check(cli.main(argv) == 0, f"{label}: the resumed run failed")
        print(f"  {label}: crashed after {n_ok} calls of {name}, resumed "
              f"with {len(again)} in {time.time() - t:.3f} s", flush=True)
    finally:
        setattr(mod, name, real)
    return len(again)


def _same_files(a: str, b: str, names, what: str) -> None:
    for f in names:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            data = x.read()
            check(data and data == y.read(), f"{what}: {f} differs")


def _k3_record(name: str, h, x, ix, v=None) -> dict:
    """K3's times at one shape (haystack h, needles x, index ix, values v
    or None, int32 tensors of u32 bits on the card) in the mode of the
    product path's call: from a CUDA graph and back to back, beside its
    plain version and torch.searchsorted on int64 copies (the int32 bit
    view misorders keys >= 2^31; the copies are set-up), timed the same
    two ways; and its bound from this run's needles and index (values
    mode also reads the values)."""
    import torch
    from metakssd_tpu_torch.ops import merge
    from metakssd_tpu_torch.probes import bench_member
    from metakssd_tpu_torch.probes.bench_member import time_ms
    h64, x64 = h.long() & ALL_ONES, x.long() & ALL_ONES
    rec = {"shape": name, "nh": h.numel(), "nn": x.numel(),
           "k3_ms": bench_member.graph_ms(lambda: merge.member(h, v, x, ix)),
           "k3_events_ms": time_ms(lambda: merge.member(h, v, x, ix), 20),
           "plain_ms": time_ms(lambda: merge.member_plain(h, v, x), 5),
           "library_ms": bench_member.graph_ms(
               lambda: torch.searchsorted(h64, x64)),
           "library_events_ms": time_ms(
               lambda: torch.searchsorted(h64, x64), 20),
           "ops": _k3_ops(x64, ix, h.numel())}
    hay_bytes = 4 * rec["nh"] * (1 if v is None else 2)
    rec["bound_ms"], rec["bound_by"] = _bound(hay_bytes + 12 * rec["nn"],
                                              rec["ops"])
    print(f"  K3 {name}: {rec['nh']} x {rec['nn']}  K3 {rec['k3_ms']:.4f} "
          f"ms (graph replay; back-to-back calls {rec['k3_events_ms']:.4f})"
          f"  plain {rec['plain_ms']:.4f}  torch.searchsorted "
          f"{rec['library_ms']:.4f} (back to back "
          f"{rec['library_events_ms']:.4f})  bound {rec['bound_ms']:.4f} "
          f"({rec['bound_by']}, {rec['ops']} ops)  "
          f"{rec['nn'] / rec['k3_ms'] / 1e3:.2f} Mneedles/s", flush=True)
    return rec


def phase_stage1_flags(work: str, seed: int, sres: dict) -> dict:
    """``dist --byread``, ``dist -P``, ``dist --ckpt``, ``profile --ckpt``
    and ``profile --shard-db 1`` on phase 4's shuffle, genomes and fastq,
    each against what phase 4 wrote or the plain run of the same input;
    launch counts zeroed before the byread and shard-db legs."""
    import numpy as np
    from metakssd_tpu_torch import composite, pipeline
    from metakssd_tpu_torch.formats.codir import CoDir
    from metakssd_tpu_torch.io import native
    from metakssd_tpu_torch.ops import merge, sketch, sketch_cuda
    shufp, fq, sub = sres["shuf"], sres["fastq"], sres["subset"]
    check(native.available(), "--ckpt streams through the host library, "
                              "which did not build")
    secs = {}

    # --byread on the 4M-read fastq: K1 with positions, the poly-A block's
    # chunk through K2
    br = os.path.join(work, "byread_cuda")
    sketch_cuda.reset_launches()
    secs["dist --byread"] = run_cli("dist --byread --device cuda", [
        "dist", "-L", shufp, "--byread", "-o", br, "--device", "cuda", fq])
    br_launches = dict(sketch_cuda.LAUNCHES)
    print(f"  byread launches {br_launches}", flush=True)
    check(br_launches["sketch_compact"] > 0 and
          br_launches["sketch_full"] > 0,
          f"a sketch kernel never launched in dist --byread: {br_launches}")
    plain = os.path.join(work, "sample_occ")
    secs["dist (occ)"] = run_cli("dist (occ) --device cuda", [
        "dist", "-L", shufp, "-o", plain, "--device", "cuda", fq])
    occ = CoDir.read(plain, want_abund=False)
    total = 0
    for c in range(occ.stat.comp_num):
        idx = np.fromfile(os.path.join(br, f"combco.index.{c}"), np.uint64)
        ids = np.fromfile(os.path.join(br, f"combco.{c}"), np.uint32)
        check(idx.size == N_READS + 1 and int(idx[-1]) == ids.size,
              f"byread combco.index.{c}: {idx.size} entries, last "
              f"{int(idx[-1])}, {ids.size} ids")
        check(np.array_equal(np.unique(ids), occ.genome_ids(c, 0)),
              f"byread component {c}: distinct ids differ from dist's")
        total += ids.size
    print(f"  byread: {N_READS} reads, {total} windows in stream order; "
          "distinct ids == dist (occ)", flush=True)
    sub_br = {}
    for dev in ("cuda", "cpu"):
        sub_br[dev] = os.path.join(work, f"byread_sub_{dev}")
        secs[f"dist --byread {CPU_READS} reads {dev}"] = run_cli(
            f"dist --byread ({CPU_READS} reads) {dev}", [
                "dist", "-L", shufp, "--byread", "-o", sub_br[dev],
                "--device", dev, sub])
    _same_dirs(sub_br["cuda"], sub_br["cpu"], "byread subset")
    rev = os.path.join(work, "byread_reverse.txt")
    secs["reverse -b"] = _run_cli_to("reverse -b (byread subset)", [
        "reverse", "-L", shufp, "-b", sub_br["cuda"]], rev)
    with open(rev, "rb") as f:
        nrec = f.read().count(b">read ")
    check(nrec == CPU_READS, f"reverse -b printed {nrec} reads")

    # -P cat: the same dir as dist of the file itself
    for flags in ([], ["-A"]):
        d = {k: os.path.join(work, f"pipe{''.join(flags)}_{k}")
             for k in ("piped", "file")}
        secs[f"dist -P cat {' '.join(flags)}".strip()] = run_cli(
            f"dist -P cat {' '.join(flags)}", [
                "dist", "-L", shufp, *flags, "-P", "cat", "-o", d["piped"],
                "--device", "cuda", sub])
        run_cli(f"dist {' '.join(flags)} (the file)", [
            "dist", "-L", shufp, *flags, "-o", d["file"], "--device",
            "cuda", sub])
        _same_dirs(d["piped"], d["file"], f"-P cat {flags}")
    print("  -P cat: with and without -A, byte-identical to dist of the "
          "file", flush=True)

    # --ckpt: a crash after the 4th group (dist) and after the 4th streamed
    # batch (profile), then the resumed run
    ckgroup, ckevery = pipeline.CKPT_GROUP, pipeline.CKPT_EVERY
    pipeline.CKPT_GROUP, pipeline.CKPT_EVERY = 64, 2
    try:
        db = os.path.join(work, "markerdb_ckpt")
        t = time.time()
        groups = _interrupted("dist --ckpt", [
            "dist", "-L", shufp, "--ckpt", "-o", db, "--device", "cuda",
            sres["genomes"]], pipeline, "_batched_stage1", 4)
        secs["dist --ckpt (crash + resume)"] = time.time() - t
        check(groups == N_GENOMES // 64 - 4,
              f"dist --ckpt resumed {groups} groups")
        _same_dirs(db, sres["markerdb"], "dist --ckpt")
        prof = os.path.join(work, "profile_ckpt")
        t = time.time()
        batches = _interrupted("profile --ckpt", [
            "profile", "-L", shufp, "-r", sres["markerdb"], "-o", prof,
            "--ckpt", "--device", "cuda", fq], sketch, "sketch_codes", 4)
        secs["profile --ckpt (crash + resume)"] = time.time() - t
        nbatch = sum(1 for _ in native.stream_fastq(
            fq, 0, pipeline.STREAM_BATCH_BASES, copy=False))
        check(batches == nbatch - 4,
              f"profile --ckpt resumed {batches} of {nbatch} batches")
        _same_files(prof, sres["profile"], PROFILE_TSVS, "profile --ckpt")
        check(not os.path.exists(os.path.join(prof, "qry.co",
                                              ".stage1_ckpt")),
              "profile --ckpt left its checkpoint dir")
    finally:
        pipeline.CKPT_GROUP, pipeline.CKPT_EVERY = ckgroup, ckevery
    print(f"  --ckpt: dist resumed {groups} of {N_GENOMES // 64} groups, "
          f"profile {batches} of {nbatch} batches; outputs byte-identical "
          "to phase 4's", flush=True)

    # profile --shard-db 1: K3 matches the sample's ids on the card
    shard = os.path.join(work, "profile_shard")
    sketch_cuda.reset_launches()
    secs["profile --shard-db 1"] = run_cli("profile --shard-db 1", [
        "profile", "-L", shufp, "-r", sres["markerdb"], "-o", shard,
        "--shard-db", "1", "--device", "cuda", fq])
    sd_launches = dict(sketch_cuda.LAUNCHES)
    print(f"  shard-db launches {sd_launches}", flush=True)
    _same_files(shard, sres["profile"], PROFILE_TSVS, "profile --shard-db 1")
    ref = CoDir.read(sres["markerdb"], want_abund=False)
    qry = CoDir.read(os.path.join(shard, "qry.co"))
    index = [v for k, v in composite._INDEX_CACHE.items()
             if k[0] == os.path.abspath(sres["markerdb"]) and k[3] == 1]
    check(len(index) == 1, f"{len(index)} shard-db indexes staged")
    comps = [c for c in range(ref.stat.comp_num)
             if index[0][c] is not None and qry.ids[c].size]
    check(comps and sd_launches["member"] == len(comps)
          and sd_launches["member_index"] == len(comps),
          f"K3 and its index must launch once per component ({len(comps)})"
          f" in profile --shard-db 1: {sd_launches}")
    calls = {f"c{c}": (index[0][c].nk, int(qry.ids[c].size)) for c in comps}
    print("  profile --shard-db 1 K3 calls (haystack x needles): "
          + ", ".join(f"{k} {h} x {n}" for k, (h, n) in calls.items())
          + "; TSVs byte-identical to phase 4's profile", flush=True)
    hay = index[0][comps[0]].hays[0]
    x = merge.u32_tensor(np.sort(np.asarray(qry.ids[comps[0]]))) \
        .to(hay.device)
    err = _k3_vs_plain("profile --shard-db 1", hay.hay, None, x, hay.index)
    k3 = _k3_record("profile --shard-db 1", hay.hay, x, hay.index)
    k3["err"] = err
    print("  seconds: " + json.dumps({k: round(v, 4)
                                      for k, v in secs.items()}), flush=True)
    return {"byread_launches": br_launches, "shard_launches": sd_launches,
            "k3": k3, "k3_calls": calls, "seconds": secs}


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
            seq = read_fasta(gpath)
            hit = np.flatnonzero(rng.random(seq.size) < rate)
            code = np.searchsorted(acgt, seq[hit])
            seq[hit] = acgt[(code + rng.integers(1, 4, hit.size)) % 4]
            truth[path] = (gpath, rate)
        else:
            seq = acgt[rng.integers(0, 4, size=GENOME_LEN, dtype=np.uint8)]
            truth[path] = (None, None)
        write_fasta(path, f"q{i:03d}", seq)
    return qdir, truth


def phase_search(work: str, seed: int) -> dict:
    """The search leg at K8S5L2: reference and query sketches, then
    ``dist -r`` on the card (K3), on the CPU, against the stage-II mco dir
    and through ``--shard-db 1``; all four distance.out byte-identical."""
    import numpy as np
    import torch
    from metakssd_tpu_torch.ops import sketch_cuda
    from metakssd_tpu_torch.formats.codir import CoDir

    gdir = os.path.join(work, "genomes")
    shufp = os.path.join(work, "K8S5L2.shuf")
    write_zero_accepted_shuf(shufp, K8S5L2, seed)
    refco, qryco = os.path.join(work, "refco"), os.path.join(work, "qryco")
    torch.cuda.reset_peak_memory_stats()
    sketch_cuda.reset_launches()
    run_cli("dist (reference)", ["dist", "-L", shufp, "-o", refco,
                                  "--device", "cuda", gdir])
    check(sketch_cuda.LAUNCHES["sketch_compact"] > 0,
           "K1 never launched in the reference build")
    t = time.time()
    qdir, truth = make_search_queries(work, gdir, seed)
    print(f"  query data: {len(truth)} genomes in {time.time() - t:.1f} s",
          flush=True)
    run_cli("dist (queries)", ["dist", "-L", shufp, "-o", qryco,
                                "--device", "cuda", qdir])

    out = {k: os.path.join(work, f"d_{k}")
           for k in ("cuda", "cpu", "mco", "shard")}
    sketch_cuda.reset_launches()
    secs = {"cuda": run_cli("dist -r --device cuda", [
        "dist", "-r", refco, "-o", out["cuda"], "--device", "cuda", qryco])}
    launches = dict(sketch_cuda.LAUNCHES)
    print(f"  search launches {launches}", flush=True)
    ref, qry = CoDir.read(refco), CoDir.read(qryco)
    comps = [c for c in range(ref.stat.comp_num)
             if ref.ids[c].size and qry.ids[c].size]
    check(comps and launches["member"] == len(comps)
           and launches["member_index"] == len(comps),
           f"K3 and its index must launch once per component "
           f"({len(comps)}) in the search: {launches}")
    nh = [np.unique(ref.ids[c]).size for c in comps]
    nn = [qry.ids[c].size for c in comps]
    print(f"  search K3 calls: {len(comps)} (one per component), "
          f"haystack {min(nh)}-{max(nh)} keys, needles {min(nn)}-"
          f"{max(nn)} ({len(truth)} queries)", flush=True)
    secs["cpu"] = run_cli("dist -r --device cpu", [
        "dist", "-r", refco, "-o", out["cpu"], "--device", "cpu", qryco])
    refmco = os.path.join(work, "refmco")
    run_cli("dist -r (stage II)", ["dist", "-r", refco, "-o", refmco,
                                    "--component_sz", "6"])
    secs["mco"] = run_cli("dist -r mco", [
        "dist", "-r", refmco, "-o", out["mco"], "--device", "cuda", qryco])
    # --shard-db 1: K3 in values mode once per (query, component), the
    # query's distinct ids as haystack (indexed from 16 ids)
    sketch_cuda.reset_launches()
    secs["shard"] = run_cli("dist -r --shard-db 1", [
        "dist", "-r", refco, "--shard-db", "1", "-o", out["shard"],
        "--device", "cuda", qryco])
    shard_launches = dict(sketch_cuda.LAUNCHES)
    print(f"  dist -r --shard-db 1 launches {shard_launches}", flush=True)
    sizes = [np.unique(qry.genome_ids(c, q)).size
             for c in range(ref.stat.comp_num) if ref.ids[c].size
             for q in range(qry.stat.infile_num)]
    check(shard_launches["member"] == sum(1 for x in sizes if x)
          and shard_launches["member_index"]
          == sum(1 for x in sizes if x >= 16),
          f"dist -r --shard-db 1: K3 once per (query, component) with ids "
          f"({sum(1 for x in sizes if x)}), its index once per pair of 16 "
          f"ids or more: {shard_launches}")
    print(f"  peak device memory (search leg) "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)

    texts = {}
    for k, d in out.items():
        with open(os.path.join(d, "distance.out"), "rb") as f:
            texts[k] = f.read()
    check(all(t == texts["cuda"] for t in texts.values()),
           "the four distance.out files differ")
    jac: dict = {}
    for ln in texts["cuda"].decode().splitlines()[1:]:
        col = ln.split("\t")
        jac.setdefault(col[0], {})[col[1]] = float(col[3])
    check(set(jac) == set(truth) and all(len(v) == N_GENOMES
                                          for v in jac.values()),
           "distance.out does not hold every query x reference pair")
    by_rate: dict = {}
    for q, (src, rate) in truth.items():
        best = max(jac[q], key=jac[q].get)
        if src is None:
            check(jac[q][best] < 0.01, f"unrelated {q} reaches Jaccard "
                                        f"{jac[q][best]} against {best}")
            continue
        check(best == src, f"{q}: best reference {best}, source {src}")
        by_rate.setdefault(rate, []).append(jac[q][src])
    med = [float(np.median(by_rate[r])) for r in RATES]
    check(all(a > b for a, b in zip(med, med[1:])),
           f"median Jaccard does not fall with the rate: {med}")
    unrelated = max(max(jac[q].values())
                    for q, (src, _) in truth.items() if src is None)
    print("  search: 4 distance.out byte-identical "
          f"({len(texts['cuda'])} bytes); every mutated query's best "
          "reference is its source; median Jaccard by rate "
          + ", ".join(f"{r}: {m:.6f}" for r, m in zip(RATES, med))
          + f"; unrelated queries max Jaccard {unrelated:.6f}", flush=True)
    return {"launches": launches, "shard_launches": shard_launches,
            "seconds": secs, "shuf": shufp, "refco": refco,
            "qryco": qryco, "dist_out": out["cuda"],
            "k3_calls": {"calls": len(comps), "nh": nh, "nn": nn}}


MESH = 4                          # shards of the mesh phase's legs
RANKS = 2                         # processes of its multi-process leg
RANKS_TIMEOUT = 300               # seconds a process of that leg may take


def _mesh_launches(label: str, argv: list, path: str | None = None):
    """``run_cli`` (or ``_run_cli_to`` with stdout to ``path``) with the
    launch counts zeroed before it; returns (seconds, counts)."""
    from metakssd_tpu_torch.ops import sketch_cuda
    sketch_cuda.reset_launches()
    dt = run_cli(label, argv) if path is None else \
        _run_cli_to(label, argv, path)
    got = dict(sketch_cuda.LAUNCHES)
    print(f"  {label} launches {got}", flush=True)
    return dt, got


def phase_mesh(work: str, sres: dict, qres: dict) -> dict:
    """``--mesh 4`` and ``--shard-db 4`` on phase 4's and phase 5's data,
    each byte-identical to the one-device run and with its launches
    counted; K3 timed at the per-shard shapes; then RANKS processes on the
    one card, joined by MKSSD_COORDINATOR over gloo, every file of every
    rank byte-identical to the one-process run's."""
    import numpy as np
    import torch
    from metakssd_tpu_torch import composite
    from metakssd_tpu_torch.formats.codir import CoDir
    from metakssd_tpu_torch.ops import merge
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from ranks import run_ranks
    from metakssd_tpu_torch.pipeline import CoStat
    shufp, db, fq = sres["shuf"], sres["markerdb"], sres["fastq"]
    n = str(MESH)
    secs, launches = {}, {}
    torch.cuda.reset_peak_memory_stats()

    # --mesh 4: K1 (and K2) per shard of each genome and of the sample
    d = os.path.join(work, "mesh_dist")
    secs["dist --mesh 4"], launches["dist --mesh 4"] = _mesh_launches(
        "dist --mesh 4", ["dist", "-L", shufp, "--mesh", n, "-o", d,
                          "--device", "cuda", sres["genomes"]])
    _same_dirs(d, db, "dist --mesh 4 against phase 4's dist")
    check(launches["dist --mesh 4"]["sketch_compact"] >= MESH * N_GENOMES,
          f"K1 did not run per shard: {launches['dist --mesh 4']}")
    prof = os.path.join(work, "mesh_profile")
    secs["profile --mesh 4"], launches["profile --mesh 4"] = _mesh_launches(
        "profile --mesh 4", ["profile", "-L", shufp, "-r", db, "-o", prof,
                             "--mesh", n, "--device", "cuda", fq])
    _same_files(prof, sres["profile"], PROFILE_TSVS, "profile --mesh 4")
    got = launches["profile --mesh 4"]
    check(got["sketch_compact"] >= MESH and got["sketch_full"] > 0,
          f"K1 per shard and K2 must run in profile --mesh 4: {got}")

    # --shard-db 4: K3 per db shard, composite and profile
    ref = CoDir.read(db, want_abund=False)
    qry = CoDir.read(os.path.join(prof, "qry.co"))
    comps = [c for c in range(ref.stat.comp_num)
             if ref.ids[c].size and qry.ids[c].size]
    sd = os.path.join(work, "mesh_shard_profile")
    secs["profile --shard-db 4"], launches["profile --shard-db 4"] = \
        _mesh_launches("profile --shard-db 4", [
            "profile", "-L", shufp, "-r", db, "-o", sd, "--shard-db", n,
            "--device", "cuda", fq])
    _same_files(sd, sres["profile"], PROFILE_TSVS, "profile --shard-db 4")
    got = launches["profile --shard-db 4"]
    check(got["member"] == MESH * len(comps)
          and got["member_index"] == MESH * len(comps),
          f"K3 and its index must launch once per shard and component "
          f"({MESH} x {len(comps)}): {got}")
    tsv = os.path.join(work, "mesh_composite.tsv")
    secs["composite --shard-db 4"], launches["composite --shard-db 4"] = \
        _mesh_launches("composite -q --shard-db 4", [
            "composite", "-r", db, "-q", os.path.join(prof, "qry.co"),
            "--shard-db", n, "--device", "cuda"], tsv)
    with open(tsv, "rb") as a, open(os.path.join(
            sres["profile"], "species_coverage.tsv"), "rb") as b:
        text = a.read()
        check(text and text == b.read(), "composite -q --shard-db 4 differs "
                                         "from phase 4's species coverage")
    got = launches["composite --shard-db 4"]
    check(got["member"] == MESH * len(comps),
          f"K3 in composite --shard-db 4: {got}")
    index = [v for k, v in composite._INDEX_CACHE.items()
             if k[0] == os.path.abspath(db) and k[3] == MESH]
    check(len(index) == 1, f"{len(index)} --shard-db 4 indexes staged")
    hay = index[0][comps[0]].hays[0]
    x = merge.u32_tensor(np.sort(np.asarray(qry.ids[comps[0]]))) \
        .to(hay.device)
    err = _k3_vs_plain("profile --shard-db 4", hay.hay, None, x, hay.index)
    k3 = [_k3_record("profile --shard-db 4, one shard", hay.hay, x,
                     hay.index)]

    # dist -r --shard-db 4 at K8S5L2: queries' ids as haystacks, a shard's
    # postings as needles
    out = os.path.join(work, "mesh_search")
    secs["dist -r --shard-db 4"], launches["dist -r --shard-db 4"] = \
        _mesh_launches("dist -r --shard-db 4", [
            "dist", "-r", qres["refco"], "--shard-db", n, "-o", out,
            "--device", "cuda", qres["qryco"]])
    _same_files(out, qres["dist_out"], ["distance.out"],
                "dist -r --shard-db 4")
    sref = CoDir.read(qres["refco"], want_abund=False)
    sqry = CoDir.read(qres["qryco"], want_abund=False)
    # (query, component) pairs with ids; an index needs 16 distinct ids
    sizes = [np.unique(sqry.genome_ids(c, q)).size
             for c in range(sref.stat.comp_num) if sref.ids[c].size
             for q in range(sqry.stat.infile_num)]
    pairs = sum(1 for x in sizes if x)
    # the query's haystack is staged once per card that holds a shard
    cards = len({i % torch.cuda.device_count() for i in range(MESH)})
    got = launches["dist -r --shard-db 4"]
    check(got["member"] == MESH * pairs
          and got["member_index"] == cards * sum(1 for x in sizes
                                                 if x >= 16),
          f"dist -r --shard-db 4: K3 once per shard and (query, component)"
          f" ({MESH} x {pairs}), its index once per pair and card "
          f"({cards}): {got}")
    c = next(c for c in range(sref.stat.comp_num) if sref.ids[c].size)
    post = np.asarray(sref.ids[c], np.uint32)
    uq, mult = np.unique(sqry.genome_ids(c, 0), return_counts=True)
    qh = merge.StaticHaystack(uq, mult.astype(np.uint32), "cuda")
    needles = merge.u32_tensor(post[:-(-post.size // MESH)]).to(qh.device)
    err = max(err, _k3_vs_plain("dist -r --shard-db 4", qh.hay, qh.values,
                                needles, qh.index))
    k3.append(_k3_record("dist -r --shard-db 4, one shard", qh.hay, needles,
                         qh.index, qh.values))
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak device memory (mesh legs) {peak / 2**20:.1f} MiB",
          flush=True)

    # RANKS processes on the one card: the verbs of a multi-host job, each
    # rank into its own dirs; references from this process
    names = CoStat.read(db).names
    taxf = os.path.join(work, "mesh_taxa.tsv")
    with open(taxf, "w") as f:
        f.writelines(f"{1 + i // CHAIN_TAXON}\ttaxon{i // CHAIN_TAXON}\n"
                     for i in range(len(names)))
    serial = {k: os.path.join(work, f"mesh_serial_{k}") for k in ("u", "g")}
    secs["set -u"] = run_cli("set -u (one process)", [
        "set", "-u", "-o", serial["u"], "--device", "cuda", db])
    secs["set -g"] = run_cli("set -g (one process)", [
        "set", "-g", taxf, "-o", serial["g"], "--device", "cuda", db])
    job = {"shuf": shufp, "db": db, "genomes": sres["genomes"],
           "refco": qres["refco"], "qryco": qres["qryco"],
           "dist_out": qres["dist_out"], "sample": os.path.join(prof,
                                                              "qry.co"),
           "taxf": taxf, "serial": serial, "composite": text}
    rk = os.path.join(work, "ranks")
    # the ranks share the first visible card, whatever the machine holds,
    # so this leg runs the collectives over gloo (phase 5c runs NCCL)
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    secs[f"{RANKS} processes"] = run_ranks(
        _rank_steps(job, rk), RANKS, os.path.join(rk, "logs"),
        RANKS_TIMEOUT, env=dict(os.environ, MKSSD_LOG="json",
                                CUDA_VISIBLE_DEVICES=first))
    for r in range(RANKS):
        _check_rank_files(job, rk, r)
    print(f"  {RANKS} processes on one card over gloo: dist --mesh 4, "
          "dist -r --shard-db 4, composite --shard-db 4, set -u and set -g "
          f"in {secs[f'{RANKS} processes']:.3f} s; every file of every rank "
          "byte-identical to the one-process run's", flush=True)
    print("  mesh seconds: " + json.dumps({k: round(v, 4)
                                           for k, v in secs.items()}),
          flush=True)
    return {"launches": launches, "k3": k3, "err": err, "seconds": secs,
            "peak_mib": peak / 2**20, "job": job,
            "ranks_logs": os.path.join(rk, "logs")}


RANK_VERBS = ("dist --mesh 4", "dist -r --shard-db 4",
              "composite --shard-db 4", "set -u", "set -g")


def _rank_steps(job: dict, rk: str) -> list:
    """``run_ranks`` steps of the RANK_VERBS on phase 4's and 5's data,
    each rank writing into ``rk``."""
    os.makedirs(rk, exist_ok=True)

    def j(name):
        return os.path.join(rk, name)
    n = str(MESH)
    cu = ["--device", "cuda"]
    return [
        (["dist", "-L", job["shuf"], "--mesh", n, "-o", j("co_p{rank}"),
          job["genomes"], *cu], None),
        (["dist", "-r", job["refco"], "--shard-db", n, "-o",
          j("dist_p{rank}"), job["qryco"], *cu], None),
        (["composite", "-r", job["db"], "-q", job["sample"],
          "--shard-db", n, *cu], j("comp_p{rank}.tsv")),
        (["set", "-u", "-o", j("set_p{rank}"), job["db"], *cu], None),
        (["set", "-g", job["taxf"], "-o", j("grp_p{rank}"), job["db"],
          *cu], None)]


def _check_rank_files(job: dict, rk: str, r: int) -> None:
    """Every file rank ``r`` wrote into ``rk`` byte-identical to the
    one-process run's."""
    def j(name):
        return os.path.join(rk, name)
    _same_dirs(j(f"co_p{r}"), job["db"], f"rank {r} dist --mesh 4")
    _same_files(j(f"dist_p{r}"), job["dist_out"], ["distance.out"],
                f"rank {r} dist -r --shard-db 4")
    with open(j(f"comp_p{r}.tsv"), "rb") as a:
        check(a.read() == job["composite"],
              f"rank {r} composite --shard-db 4")
    _same_dirs(j(f"set_p{r}"), job["serial"]["u"], f"rank {r} set -u")
    _same_dirs(j(f"grp_p{r}"), job["serial"]["g"], f"rank {r} set -g")


def _rank_report(logdir: str, step: int, r: int) -> dict:
    """Rank ``r``'s TIMER report of step ``step``; its ``meta`` must name
    the collectives' backend."""
    from metakssd_tpu_torch.probes.collectives_check import read_report
    rep = read_report(os.path.join(logdir, f"step{step}_rank{r}.log"))
    check("collectives" in rep.get("meta", {}), f"no collectives in the "
          f"TIMER report of step {step}, rank {r} ({logdir})")
    return rep


PIPE_CARDS_CHUNK = 1 << 20        # phase 5c (d): chunks of the dealt stream


def phase_collectives(work: str, seed: int, meshres: dict) -> dict:
    """(a) The RANK_VERBS in a one-rank NCCL job on the card, each verb its
    own job: files byte-identical to the one-process run's, the TIMER
    report naming nccl, NCCL calls above 0 where the verb merges across
    shards.  (b) The collectives on CUDA tensors in a one-rank NCCL group
    (``probes/collectives_check``).  (c) Phase 5b's two processes, which
    share a card: their reports name gloo.  (d) With several cards: two
    ranks, one card each, over NCCL; ``sketch_windows(devices=None)``
    dealing chunks over the cards; ``make_mesh`` dealing shards."""
    import torch
    import torch.distributed as tdist
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from ranks import free_port, run_ranks
    job, secs = meshres["job"], meshres["seconds"]
    print(f"  NCCL available {tdist.is_nccl_available()}, version "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}", flush=True)
    env = dict(os.environ, MKSSD_LOG="json")

    # (a) one rank on the card, over NCCL
    rk = os.path.join(work, "ranks_nccl")
    out = {}
    for i, (verb, step) in enumerate(zip(RANK_VERBS, _rank_steps(job, rk))):
        logs = os.path.join(rk, f"logs{i}")
        dt = run_ranks([step], 1, logs, RANKS_TIMEOUT, env=env)
        rep = _rank_report(logs, 0, 0)
        meta, counts = rep["meta"], rep["meta"].get("collective_counts", {})
        check(meta["collectives"] == "nccl (1 rank, 1 card)",
              f"one-rank {verb}: collectives {meta['collectives']}")
        if verb in ("dist --mesh 4", "dist -r --shard-db 4", "set -u"):
            check(counts.get("nccl_calls", 0) > 0,
                  f"one-rank {verb}: no NCCL call ({counts})")
        staged = sum(rep["stages"].values())
        print(f"  one rank, NCCL: {verb:24s} {dt:8.3f} s, its stages "
              f"{staged:.3f} s (one process in 5b {secs[verb]:.3f} s); "
              f"collectives {json.dumps(counts)}", flush=True)
        out[verb] = {"s": dt, "stages_s": staged,
                     "one_process_s": secs[verb], **counts}
    _check_rank_files(job, rk, 0)
    print("  one rank, NCCL: every file byte-identical to the one-process "
          "run's", flush=True)

    # (b) the collectives on CUDA tensors, a one-rank NCCL group
    t = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "metakssd_tpu_torch.probes.collectives_check",
         "--device", "cuda", "--sizes", "0,1,16777219"], cwd=ROOT,
        env=dict(os.environ, MKSSD_COORDINATOR=f"127.0.0.1:{free_port()}",
                 MKSSD_NPROCS="1", MKSSD_PROCID="0"),
        capture_output=True, text=True, timeout=RANKS_TIMEOUT)
    line = [x for x in proc.stdout.splitlines() if "collectives ok" in x]
    check(proc.returncode == 0 and line and "nccl (1 rank, 1 card)"
          in line[0], "collectives on CUDA tensors, one NCCL rank:\n"
          + proc.stdout[-2000:] + proc.stderr[-2000:])
    print(f"  {line[0]} ({time.time() - t:.3f} s; 0, 1 and 2^24 + 3 "
          "elements of uint8, int32, uint32, int64, uint64: exact)",
          flush=True)

    # (c) phase 5b's ranks on one card
    backends = {_rank_report(meshres["ranks_logs"], i, r)["meta"][
        "collectives"]
                for i in range(len(RANK_VERBS)) for r in range(RANKS)}
    check(backends == {f"gloo ({RANKS} ranks share cuda:0)"},
          f"phase 5b's ranks: {backends}")
    print(f"  phase 5b's {RANKS} processes: {backends.pop()}", flush=True)

    # (d) several cards
    ncard = torch.cuda.device_count()
    if ncard < 2:
        print(f"  several cards: not run ({ncard} visible)", flush=True)
        return {"one_rank": out, "several_cards": False}
    rk = os.path.join(work, "ranks_cards")
    logs = os.path.join(rk, "logs")
    dt = run_ranks(_rank_steps(job, rk), 2, logs, RANKS_TIMEOUT, env=env)
    for r in range(2):
        _check_rank_files(job, rk, r)
        for i in range(len(RANK_VERBS)):
            got = _rank_report(logs, i, r)["meta"]["collectives"]
            check(got == "nccl (2 ranks, 2 cards)",
                  f"two ranks on two cards, rank {r}: {got}")
    print(f"  two ranks on two cards over NCCL: the five verbs in {dt:.3f} "
          "s, every file byte-identical", flush=True)
    _dealt_chunks(work, seed, ncard)
    from metakssd_tpu_torch.parallel import mesh
    m = mesh.make_mesh(2 * ncard + 1, 1, "cuda")
    check([s.device for s in m.shards] == [torch.device("cuda", i % ncard)
                                           for i in range(2 * ncard + 1)],
          f"make_mesh over {ncard} cards: {m.describe()}")
    print(f"  several cards: {ncard} visible; make_mesh deals shards "
          "round-robin", flush=True)
    return {"one_rank": out, "several_cards": True}


def _dealt_chunks(work: str, seed: int, ncard: int) -> None:
    """``sketch_windows(devices=None)`` deals 2 x ncard chunks over every
    card (one poly-A chunk through K2): pairs equal the CPU run's."""
    import numpy as np
    from metakssd_tpu_torch.ops import sketch_cuda
    from metakssd_tpu_torch.probes import chunk_split
    from metakssd_tpu_torch.state import accept_tables
    shuf = write_zero_accepted_shuf(os.path.join(work, "cards.shuf"),
                                    L3K11, seed)
    p = shuf.params
    rng = np.random.default_rng(seed + 5)
    nchunk = 2 * ncard
    codes = rng.integers(0, 4, size=nchunk * PIPE_CARDS_CHUNK,
                         dtype=np.uint8)
    codes[PIPE_CARDS_CHUNK + 1000:PIPE_CARDS_CHUNK + (1 << 19)] = 0
    ref = sketch_cuda.sketch_windows(codes, p, accept_tables(shuf, "cpu"),
                                     want_pos=True,
                                     chunk_windows=PIPE_CARDS_CHUNK)
    try:
        chunk_split.checked_run(codes, p, accept_tables(shuf, "cuda"),
                                PIPE_CARDS_CHUNK, None, None, ref, reruns=1)
    except AssertionError as e:
        check(False, f"chunks dealt over {ncard} cards: {e}")
    print(f"  sketch_windows(devices=None): {nchunk} chunks over {ncard} "
          "cards, pairs == cpu", flush=True)


def _same_dirs(a: str, b: str, what: str) -> int:
    """Every file of dir ``a`` byte-identical in dir ``b`` (the hidden
    MarkerDB staging sidecars left out); returns their bytes."""
    fa = sorted(f for f in os.listdir(a) if not f.startswith("."))
    fb = sorted(f for f in os.listdir(b) if not f.startswith("."))
    check(fa == fb and fa, f"{what}: files differ: {fa} vs {fb}")
    size = 0
    for f in fa:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            data = x.read()
            check(data == y.read(), f"{what}: {f} differs between devices")
        size += len(data)
    return size


def _run_cli_to(label: str, argv: list, path: str) -> float:
    """``run_cli`` with the command's stdout written to ``path``."""
    import contextlib
    from metakssd_tpu_torch import cli
    t = time.time()
    with open(path, "w") as f, contextlib.redirect_stdout(f):
        rc = cli.main(argv)
    dt = time.time() - t
    check(rc == 0, f"{label} failed: {argv}")
    print(f"  {label:36s} {dt:9.3f} s", flush=True)
    return dt


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
    run_cli("dist -A (200K reads)", ["dist", "-L", sres["shuf"], "-A", "-o",
                                      qco, "--device", "cuda",
                                      sres["subset"]])
    out = {}
    for dev in ("cuda", "cpu"):
        d = {k: os.path.join(work, f"chain_{dev}_{k}")
             for k in ("pan", "uq", "mk", "abv")}
        run_cli(f"chain set -g --device {dev}", [
            "set", "-g", taxf, "-o", d["pan"], "--device", dev,
            sres["markerdb"]])
        run_cli(f"chain set -q --device {dev}", [
            "set", "-q", "-o", d["uq"], "--device", dev, d["pan"]])
        run_cli(f"chain set -i --device {dev}", [
            "set", "-i", d["uq"], "-o", d["mk"], "--device", dev, d["pan"]])
        d["tsv"] = os.path.join(work, f"chain_{dev}.tsv")
        _run_cli_to(f"chain composite -q --device {dev}", [
            "composite", "-r", d["mk"], "-q", qco, "--device", dev],
            d["tsv"])
        run_cli(f"chain composite -q -b --device {dev}", [
            "composite", "-r", d["mk"], "-q", qco, "-b", "-o", d["abv"],
            "--device", dev])
        d["shard"] = os.path.join(work, f"chain_{dev}_shard.tsv")
        _run_cli_to(f"chain composite -q --shard-db 1 --device {dev}", [
            "composite", "-r", d["mk"], "-q", qco, "--shard-db", "1",
            "--device", dev], d["shard"])
        out[dev] = d
    for k in ("pan", "uq", "mk", "abv"):
        _same_dirs(out["cuda"][k], out["cpu"][k], f"chain {k}")
    with open(out["cuda"]["tsv"], "rb") as a:
        text = a.read()
    for dev, k in (("cpu", "tsv"), ("cuda", "shard"), ("cpu", "shard")):
        with open(out[dev][k], "rb") as b:
            check(text and text == b.read(), f"chain composite TSVs differ "
                                              f"({dev} {k})")
    reported = {ln.split("\t")[1] for ln in text.decode().splitlines()}

    def taxon_of(path):
        i = names.index(path) // CHAIN_TAXON
        return f"{1 + i}_taxon{i}"
    cov = sres["sub_coverage"]
    want = {taxon_of(p) for p, c in cov.items() if c >= 1}
    sampled = {taxon_of(p) for p in cov}
    check(want and want <= reported,
           f"taxa with a genome of coverage >= 1x missing: "
           f"{sorted(want - reported)}")
    check(reported <= sampled,
           f"unsampled taxa reported: {sorted(reported - sampled)}")
    print(f"  chain: {len(reported)} taxa reported, all sampled; the "
          f"{len(want)} taxa holding a genome of coverage >= 1x all "
          "present; TSVs (also --shard-db 1), .abv files and set dirs "
          "byte-identical between devices", flush=True)


def phase_set(work: str, seed: int, sres: dict) -> dict:
    """The set leg: the synthetic MarkerDB build on cuda (K3 counted) and
    on cpu, byte-identical dirs; then the real chain."""
    import torch
    from metakssd_tpu_torch.ops import sketch_cuda
    from metakssd_tpu_torch.formats.codir import CoDir
    from metakssd_tpu_torch.pipeline import CoStat
    t = time.time()
    co, taxf, nids = make_set_data(work, seed)
    print(f"  data: {SET_TAXA * SET_PER_TAXON + SET_UNASSIGNED} genomes, "
          f"{SET_TAXA} taxa, {nids} ids ({4 * nids / 2**20:.1f} MiB of u32) "
          f"in {time.time() - t:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    sketch_cuda.reset_launches()
    wd = {"cuda": set_leg(work, "cuda", co, taxf)}
    launches = dict(sketch_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"  set leg launches {launches}; peak device "
          f"memory {peak / 2**20:.1f} MiB", flush=True)
    check(launches["member"] > 0 and launches["member_index"] > 0,
           "K3 or its index never launched in the set leg")
    # the K3 calls of -i (uq against the pans) and -s (uq against co)
    uq = os.path.join(wd["cuda"], "uq")
    calls = {f"{verb} c{c}": (
        os.path.getsize(os.path.join(uq, f"uniq_pan.{c}")) // 4,
        CoDir.read(d, want_abund=False).ids[c].size)
             for verb, d in (("-i", os.path.join(wd["cuda"], "pan")),
                             ("-s", co))
             for c in range(CoStat.read(d).comp_num)}
    print("  set K3 calls (haystack x needles): " + ", ".join(
        f"{v} {h} x {n}" for v, (h, n) in calls.items()), flush=True)
    wd["cpu"] = set_leg(work, "cpu", co, taxf)
    outs = sorted(os.listdir(wd["cuda"]))
    check(outs == sorted(os.listdir(wd["cpu"])) and len(outs) == 6,
           f"set: output dirs {outs}")
    size = sum(_same_dirs(os.path.join(wd["cuda"], d),
                          os.path.join(wd["cpu"], d), f"set {d}")
               for d in outs)
    mk = os.path.join(wd["cuda"], "mk")
    st = CoStat.read(mk)
    check(st.infile_num == SET_TAXA and "0" not in st.names,
           f"markers hold {st.infile_num} taxa")
    check(0.9 * SET_TAXA * SET_POOL < st.all_ctx_ct
           <= SET_TAXA * (SET_POOL + 2 * SET_SHARED),
           f"markers hold {st.all_ctx_ct} ids")
    print(f"  set: 6 output dirs ({size} bytes) byte-identical between "
          f"--device cuda and --device cpu; {st.all_ctx_ct} markers in "
          f"{st.infile_num} taxa", flush=True)
    _real_chain(work, sres)
    return {"launches": launches, "markers": mk, "k3_calls": calls}


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
    run_cli("composite -i", ["composite", "-r", refdir, "-i"])
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
    secs = {}
    for mode in (0, 1, 2):
        txt = {}
        for route in ("cuda", "cpu"):
            txt[route] = os.path.join(work, f"abv_s{mode}_{route}.txt")
            secs[f"s{mode} sparse {route}, {nq} queries"] = _run_cli_to(
                f"composite -s {mode} --device {route}",
                ["composite", "-r", refdir, "-s", str(mode), *queries,
                 "--device", route], txt[route])
        with open(txt["cuda"], "rb") as a, open(txt["cpu"], "rb") as b:
            check(a.read() == b.read(), f"-s {mode}: sparse text differs "
                                         "between the routes")
        for route, qs in (("cuda", queries), ("cpu", cpu_q)):
            txt[f"dense_{route}"] = os.path.join(
                work, f"abv_s{mode}_dense_{route}.txt")
            secs[f"s{mode} dense {route}, {len(qs)} queries"] = _run_cli_to(
                f"composite -s {mode} --dense --device {route}",
                ["composite", "-r", refdir, "-s", str(mode), "--dense", *qs,
                 "--device", route], txt[f"dense_{route}"])
        sparse = _abv_blocks(txt["cuda"], index_of)
        dense_b = _abv_blocks(txt["dense_cuda"], index_of)
        check(len(sparse) == len(dense_b) == nq, f"-s {mode}: block count")
        worst, selfs, residues = 0.0, 0, []
        for qi, ((hs, si, sv), (hd, di, dv)) in enumerate(zip(sparse,
                                                              dense_b)):
            check(hs == hd, f"-s {mode}: headers differ")
            os_, od = np.argsort(si), np.argsort(di)
            check(np.array_equal(si[os_], di[od]),
                   f"-s {mode}: query {qi} overlap sets differ")
            sv, dv = sv[os_], dv[od]
            held = np.ones(sv.size, bool)
            if mode == 2:
                # a query equal to a DB vector: sparse 0, dense the sqrt of
                # a rounding residue (ROADMAP.md section 3)
                held = sv != 0.0
                selfs += int((~held).sum())
                residues += dv[~held].tolist()
            if held.any():
                worst = max(worst, float(np.abs(dv - sv)[held].max()))
            if mode == 0 and qi < len(db_queries):
                check(di[0] == db_queries[qi],
                       f"query {qi}: top cosine hit {names[di[0]]} is not "
                       f"itself {names[db_queries[qi]]}")
        check(worst < DENSE_TOL, f"-s {mode}: dense vs sparse {worst}")
        cpu_b = _abv_blocks(txt["dense_cpu"], index_of)
        cuda_sub = dense_b[:ABV_CPU_QUERIES // 2] + \
            dense_b[-ABV_CPU_QUERIES // 2:]
        self_ids = db_queries[:ABV_CPU_QUERIES // 2] + \
            [-1] * (ABV_CPU_QUERIES // 2)
        cpu_worst = 0.0
        for (_, ci, cv), (_, gi, gv), me in zip(cpu_b, cuda_sub, self_ids):
            oc, og = np.argsort(ci), np.argsort(gi)
            check(np.array_equal(ci[oc], gi[og]),
                   f"-s {mode}: dense cpu and cuda sample sets differ")
            held = ci[oc] != me if mode == 2 else np.ones(ci.size, bool)
            if held.any():
                cpu_worst = max(cpu_worst, float(np.abs(
                    cv[oc] - gv[og])[held].max()))
        check(cpu_worst < DENSE_TOL, f"-s {mode}: dense cpu vs cuda "
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
    print("  seconds: " + json.dumps(
        {k: round(v, 4) for k, v in secs.items()}), flush=True)
    return {"seconds": secs}


CUDA_TESTS = ["tests/test_torch_sketch_cuda.py",
              "tests/test_torch_member_cuda.py",
              "tests/test_torch_setops_cuda.py",
              "tests/test_torch_probes_cuda.py",
              "tests/test_torch_mesh_cuda.py"]
PROBE_KERNELS = ("probe_floor", "probe_winmath", "probe_gather",
                 "probe_search")


def phase_probes() -> tuple[list, dict, int]:
    """The probe path on the card (launch counts zeroed before it), then
    every variant's kernel against its plain version, and P1's exact
    search index against ``build_index_plain``.  Returns one record per
    variant for the kernels' JSON line, the path's launch counts and the
    index's largest difference from its plain version."""
    import torch
    from metakssd_tpu_torch.ops import merge, probe, sketch_cuda
    from metakssd_tpu_torch.probes import (probe_floor_chunk,
                                           probe_floor_noread,
                                           probe_kernel_cost, probe_r4)
    from metakssd_tpu_torch.probes._common import graph_ms, vary
    from metakssd_tpu_torch.probes.bench_member import time_ms

    mods = (("P1", probe_kernel_cost), ("P2", probe_r4),
            ("P3", probe_floor_chunk), ("P4", probe_floor_noread))
    sketch_cuda.reset_launches()
    runs = [(pid, rec) for pid, mod in mods
            for rec in mod.run(reps=PROBE_REPS)]
    launches = dict(sketch_cuda.LAUNCHES)
    print(f"  probe path launches {launches}", flush=True)
    for kern in PROBE_KERNELS:
        check(launches[kern] > 0, f"{kern} never launched: {launches}")
        check(sum(r["launches"] for _, r in runs if r["kernel"] == kern)
               == launches[kern], f"{kern}: launches not all attributed")
    # P1's exact search reads its accept table's index, built once by
    # K3's index kernel when P1's variants are made
    check(launches["member_index"] == 1, "P1's exact index: "
          f"{launches['member_index']} builds, not 1")

    out, index_err = [], 0
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
        check(torch.equal(got, want), f"{pid} {v.name}: kernel != plain")
        plain_ms = time_ms(lambda: v.plain(v.tiles), 2)
        # the card's time per dispatch: the path's K dispatches replayed
        # from a CUDA graph (the path's own time includes the host's), in
        # PROBE_REPLAYS timings taken in turns with torch.sum's
        inputs = vary(v.tiles)
        library = v.library
        if library is not None:
            try:
                graph_ms(library, inputs, 1)
            except (RuntimeError, TypeError) as e:
                print(f"  {pid} {v.name}: no torch.sum for "
                      f"{v.tiles.dtype} here ({e})", flush=True)
                library = None
        runs, lib_runs = [], []
        for _ in range(PROBE_REPLAYS):
            runs.append(graph_ms(v.run, inputs, 5))
            if library is not None:
                lib_runs.append(graph_ms(library, inputs, 5))
        del inputs
        ms = statistics.median(runs)
        lib_ms = statistics.median(lib_runs) if lib_runs else None
        bound_ms, bound_by = _bound(v.nbytes, v.ops)
        lib = "none" if lib_ms is None else \
            f"{lib_ms:.4f} ({min(lib_runs):.4f}-{max(lib_runs):.4f})"
        index = v.tables.get("index")
        stats = {} if index is None else probe_kernel_cost.index_stats(index)
        print(f"  {pid} {v.name:30s} {ms:8.4f} ms on the card (median of "
              f"{PROBE_REPLAYS}, {min(runs):.4f}-{max(runs):.4f}; "
              f"{r['ms']:.4f} per path dispatch)  plain {plain_ms:9.4f}  "
              f"torch.sum {lib}  bound {bound_ms:.4f} ({bound_by}: "
              f"{v.nbytes} B, {v.ops} ops)  launches {r['launches']}  "
              + "".join(f"{k} {x}  " for k, x in stats.items())
              + "== plain", flush=True)
        rec = {"name": f"{pid} {v.kernel}: {v.name}", "route": "cuda",
               "source": "metakssd_tpu_torch/csrc/probe.cu",
               "replaces": v.replaces, "launches": r["launches"],
               "max_abs_err": err, "ms": ms,
               "ms_range": [min(runs), max(runs)], "path_ms": r["ms"],
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms,
               "library_ms_range": [min(lib_runs), max(lib_runs)]
               if lib_runs else None, **({"index": stats} if stats else {})}
        if index is not None:
            # the index kernel's table at the search's bucket count,
            # against its plain version on the same accept table
            accept = v.tables["accept"].cpu()
            plain = merge.build_index_plain(
                accept, probe.exact_buckets(accept.numel()))
            check((index.nb, index.shift) == (plain.nb, plain.shift)
                  and index.table.shape == plain.table.shape,
                  f"{pid} {v.name}: index shape {index.nb}/{index.shift} "
                  f"!= plain {plain.nb}/{plain.shift}")
            index_err = max(index_err, int(
                ((index.table.cpu().long() & 0xFFFFFFFF)
                 - (plain.table.long() & 0xFFFFFFFF)).abs().max().item()))
            check(torch.equal(index.table.cpu(), plain.table),
                  f"{pid} {v.name}: member_index table != plain")
            print(f"  {pid} {v.name}: member_index table of {index.nb} "
                  "buckets == plain", flush=True)
        out.append(rec)
        del got, want
    del runs
    torch.cuda.empty_cache()
    return out, launches, index_err


# python -m metakssd_tpu_torch.bench at the root bench's defaults (200K
# reads, 4096 species) and at a sample users call real: the profile cell's
# 4M reads (of 100 bp) against 16,384 species x 3000 ids, about 49M
# postings (a GTDB-scale MarkerDB holds about 59M).  At 4M the CPU sketch
# (K1's plain version) takes about 80 s a repeat, so it runs once there.
BENCH_SIZES = (("200K reads x 4096 species", {}),
               ("4M reads x 16384 species",
                {"MKSSD_BENCH_READS": "4000000",
                 "MKSSD_BENCH_SPECIES": "16384",
                 "MKSSD_BENCH_CPU_REPS": "1"}))
BENCH_LEG_TIMEOUT = 400           # seconds a leg of the bench may take
BENCH_KEYS = ("cpu_reads_per_s", "kernel_mwin_per_s", "profile_latency_s",
              "abv_queries_per_s", "abv_dense_queries_per_s", "e2e_total_s",
              "e2e_cold_total_s")
BENCH_K_REPS = 16                 # K1 launches of a kernel_chain_mwin pass


def phase_bench(work: str) -> list:
    """The bench at BENCH_SIZES, each run in a child process: it must
    exit 0 and report every key positive, and its kernel leg must have
    launched K1 at least BENCH_K_REPS times and its sketch and e2e legs
    K1 on the card (the counts are the legs' own, from 0).  Returns
    (label, bench line) per size."""
    out = []
    for label, env_size in BENCH_SIZES:
        env = dict(os.environ, MKSSD_BENCH_CACHE=os.path.join(
            work, "bench_" + label.split()[0]),
            MKSSD_BENCH_TIMEOUT=str(BENCH_LEG_TIMEOUT), **env_size)
        # the set and composite legs above ran in this process with their
        # -p default of 1, which exports OMP_NUM_THREADS=1 (the CLI's -p):
        # the bench starts as a user's shell would, without it
        env.pop("OMP_NUM_THREADS", None)
        t = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "metakssd_tpu_torch.bench"], cwd=ROOT,
            env=env, capture_output=True, text=True,
            timeout=6 * BENCH_LEG_TIMEOUT)
        dt = time.time() - t
        for ln in proc.stderr.splitlines():
            if ln.startswith("bench:"):
                print("  " + ln, flush=True)
        check(proc.returncode == 0, f"bench ({label}) exited "
              f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"  bench, {label}, {dt:.1f} s: {json.dumps(line)}",
              flush=True)
        ex = line["extra"]
        check(line["value"] > 0, f"bench ({label}): value {line['value']}")
        for key in BENCH_KEYS:
            check(ex.get(key, 0) > 0, f"bench ({label}): {key} is "
                  f"{ex.get(key)}")
        stages = ex.get("e2e_stages", {})
        check(stages and min(stages.values()) >= 0 and
              sum(stages.values()) > 0, f"bench ({label}): e2e_stages "
              f"{stages}")
        launches = ex["launches"]
        check(launches["kernel"].get("sketch_compact", 0) >= BENCH_K_REPS,
              f"bench ({label}): kernel leg launches {launches['kernel']}")
        for leg in ("sketch", "e2e"):
            check(launches[leg].get("sketch_compact", 0) > 0,
                  f"bench ({label}): {leg} leg launched no K1 on the card")
        out.append((label, line))
    _chain_split()
    return out


def _chain_split() -> None:
    """A ``kernel_chain_mwin`` pass (BENCH_K_REPS dispatches of 2^24
    windows) taken apart, best of 3: the host's time to queue it, the
    pass with its readback (what the bench's rate divides), and the
    card's time for it replayed from a CUDA graph, whole and K1 alone
    per dispatch (``window_compact``: its counter's zeroing and K1)."""
    import torch
    from metakssd_tpu_torch.ops import sketch_cuda
    from metakssd_tpu_torch.ops.kernel_bench import Chain, default_shuf
    from metakssd_tpu_torch.probes._common import graph_ms
    nwin = 1 << 24
    chain = Chain(default_shuf(), nwin, BENCH_K_REPS, "cuda")
    chain.run()
    queued, whole = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = chain.launch()
        queued.append(time.perf_counter() - t0)
        pending.cpu()
        whole.append(time.perf_counter() - t0)
    card = graph_ms(lambda _: chain.launch(), [None], 5)
    k1 = graph_ms(lambda c: sketch_cuda.window_compact(
        c, chain.tables, chain.p, chain.cap)[0], chain.codes, 5)
    print(f"  kernel_chain_mwin pass, {BENCH_K_REPS} x 2^24 windows (best "
          f"of 3): queued by the host in {1e3 * min(queued):.4f} ms, with "
          f"its readback {1e3 * min(whole):.4f} ms "
          f"({nwin * BENCH_K_REPS / min(whole) / 1e6:.0f} Mwin/s); on the "
          f"card (CUDA graph) {card:.4f} ms, K1 {k1:.4f} ms a dispatch",
          flush=True)
    del chain
    torch.cuda.empty_cache()


def phase_cuda_tests() -> None:
    """The cuda-marked tests, in a child process; fails unless all pass."""
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "-p",
         "no:cacheprovider", *CUDA_TESTS], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:] or [proc.stderr[-500:]]
    print(f"  pytest -m cuda: {tail[0]}", flush=True)
    check(proc.returncode == 0, "cuda tests failed:\n" + proc.stdout[-4000:]
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
    from metakssd_tpu_torch.io import native
    from metakssd_tpu_torch.ops import _build

    t0 = time.time()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    card_int32_rate()
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
        phase_pipeline(work, args.seed)
        _phase("pipeline", t0)

        _k12_lines(kres)
        t0 = time.time()
        kind = native.build_kind()
        print("host library (sequence parser, posting passes): "
              + {"openmp": "native, OpenMP build",
                 "serial": "native, serial build (the OpenMP compile "
                           "failed here)",
                 None: "none built: numpy routes"}[kind]
              + f" ({time.time() - t0:.1f} s to build or find)", flush=True)
        t0 = time.time()
        sres = phase_slice(work, args.seed)
        _phase("slice", t0)

        t0 = time.time()
        fres = phase_stage1_flags(work, args.seed, sres)
        _phase("stage1-flags", t0)

        t0 = time.time()
        qres = phase_search(work, args.seed)
        _phase("search", t0)

        t0 = time.time()
        meshres = phase_mesh(work, sres, qres)
        _phase("mesh", t0)

        t0 = time.time()
        phase_collectives(work, args.seed, meshres)
        _phase("collectives", t0)

        t0 = time.time()
        setres = phase_set(work, args.seed, sres)
        _phase("set", t0)

        t0 = time.time()
        phase_abv(work, args.seed, setres["markers"])
        _phase("abv", t0)

        t0 = time.time()
        probes, probe_launches, probe_index_err = phase_probes()
        _phase("probes", t0)

        t0 = time.time()
        bench = phase_bench(work)
        _phase("bench", t0)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    t0 = time.time()
    phase_cuda_tests()
    _phase("cuda tests", t0)

    t = kres["times"]
    k1_bound, k2_bound = _k12_bounds(kres["shape"])
    # K3's headline numbers stay those of 4.19M x 1M (identity mode); the
    # record carries every shape's (phase_member)
    k3 = mres["shapes"][0]
    # launches per leg of the main paths, each counted from 0
    ml = meshres["launches"]
    sketch_legs = {"profile": sres["launches"],
                   "dist --byread": fres["byread_launches"],
                   "dist --mesh 4": ml["dist --mesh 4"],
                   "profile --mesh 4": ml["profile --mesh 4"]}
    for label, line in bench:
        legs = line["extra"]["launches"].values()
        sketch_legs["bench, " + label] = {
            name: sum(leg.get(name, 0) for leg in legs)
            for name in ("sketch_compact", "sketch_full")}
    k3_legs = {"dist -r": qres["launches"],
               "dist -r --shard-db 1": qres["shard_launches"],
               "set": setres["launches"],
               "profile --shard-db 1": fres["shard_launches"],
               "profile --shard-db 4": ml["profile --shard-db 4"],
               "composite --shard-db 4": ml["composite --shard-db 4"],
               "dist -r --shard-db 4": ml["dist -r --shard-db 4"]}

    # the index kernel also builds P1's exact search index
    index_legs = {**k3_legs, "probes": probe_launches}

    def by_leg(legs, name):
        return {leg: n[name] for leg, n in legs.items()}
    shapes = [{k: r[k] for k in (
        "shape", "nh", "nn", "ops", "k3_ms", "k3_events_ms", "plain_ms",
        "library_ms", "library_events_ms", "bound_ms", "bound_by")}
        for r in mres["shapes"] + [fres["k3"]] + meshres["k3"]]
    print(json.dumps({"kernels": [
        {"name": "sketch_compact (K1)", "route": "cuda",
         "source": "metakssd_tpu_torch/csrc/sketch.cu",
         "replaces": "metakssd_tpu/ops/sketch_pallas.py:323",
         "launches": sum(by_leg(sketch_legs, "sketch_compact").values()),
         "launches_by_leg": by_leg(sketch_legs, "sketch_compact"),
         "max_abs_err": kres["k1_err"], "ms": t["k1"],
         "plain_ms": t["k1_plain"], "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "sketch_full (K2)", "route": "cuda",
         "source": "metakssd_tpu_torch/csrc/sketch.cu",
         "replaces": "metakssd_tpu/ops/sketch_pallas.py:298",
         "launches": sum(by_leg(sketch_legs, "sketch_full").values()),
         "launches_by_leg": by_leg(sketch_legs, "sketch_full"),
         "max_abs_err": kres["k2_err"], "ms": t["k2"],
         "plain_ms": t["k2_plain"], "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None},
        {"name": "member (K3)", "route": "cuda",
         "source": "metakssd_tpu_torch/csrc/member.cu",
         "replaces": "metakssd_tpu/ops/merge_device.py:29",
         "launches": sum(by_leg(k3_legs, "member").values()),
         "launches_by_leg": by_leg(k3_legs, "member"),
         "max_abs_err": max(mres["err"], fres["k3"]["err"],
                            meshres["err"]),
         "ms": k3["k3_ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": k3["library_ms"], "shapes": shapes,
         "search_calls": qres["k3_calls"], "set_calls": setres["k3_calls"],
         "shard_db_calls": fres["k3_calls"]},
        # K3's set-up, no TPU kernel: the anchor pass of sorted_membership
        # was a host search; timed at the set -s haystack, the largest
        {"name": "member_index (K3 index build)", "route": "cuda",
         "source": "metakssd_tpu_torch/csrc/member.cu",
         "replaces": "metakssd_tpu/ops/merge.py:147",
         "launches": sum(by_leg(index_legs, "member_index").values()),
         "launches_by_leg": by_leg(index_legs, "member_index"),
         "max_abs_err": max(mres["index_err"], probe_index_err),
         "ms": mres["shapes"][-1]["index_ms"],
         "plain_ms": mres["shapes"][-1]["index_plain_ms"],
         "bound_ms": mres["shapes"][-1]["index_bound_ms"],
         "bound_by": mres["shapes"][-1]["index_bound_by"],
         "library_ms": mres["shapes"][-1]["index_library_ms"],
         "shapes": [{k: r[k] for k in (
             "shape", "nh", "nb", "index_ms", "index_graph_ms",
             "index_read_ms", "index_plain_ms", "index_library_ms",
             "index_library_graph_ms", "index_bound_ms")}
             for r in mres["shapes"]]},
        *probes,
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
