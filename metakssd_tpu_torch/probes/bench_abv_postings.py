"""Check and time the abv postings walk (``csrc/abv.cu``,
``mkssd_abv_post_walk``) on the card at the whole public abv DB's shape:
SAMPLES samples over SPECIES species, held as the index's own
species-major postings (sample id int32, percentage float32), and
queries of NNZ species (the configuration's smallest, mean and largest
sample).

    python -m metakssd_tpu_torch.probes.bench_abv_postings [--seed N]

The index is drawn on the card, not read from files, at the
benchmark configuration's assumed distributions: a Zipf popularity of
1/rank over all species, ranks dealt at random; each sample a log-normal
target count of species (median 300, sigma 0.7, clipped to 30-3,000)
and the distinct species of as many Zipf draws as give that count on
average, with uniform random percentages.  The postings are sorted
species-major, sample ids ascending within a species, as ``composite
-i`` writes them, and staged as ``abv_postings.StagedPostings``.
Queries: QUERIES_PER_NNZ a size, each of NNZ distinct species drawn by
the same popularity (the first species most queries name holds nearly
every sample), in draw order (not sorted, as a file may hold them).

First a check at the full shape: for every mode (MODES) and size, the
kernel (``abv_postings.postings_walk``) and its plain twin
(``postings_walk_plain``), both on the card on the same query CSR; the
float32 measures must agree bit for bit and the first touches exactly.
The bits and touches that differ and the largest absolute difference of
the measures are printed (all 0 when the check passes), with the twin's
ms a call.  Then one JSON line a (mode, nnz): the kernel's ms (CUDA events
over REPS launches after two warm-ups, queries taken in turns), its bound
(the query's postings, 8 bytes each, plus the outputs, 12 bytes a
sample, over 3.35 TB/s), ``postings_search_batch``'s ms a call on the host
clock (CSR, upload, launch, readback) and the launches counted in
``_build.LAUNCHES["abv_post_walk"]``.

Last, the text formatter ``mkssd_abv_format_lines`` (``ops/abv_text.py``)
at the benchmark cell's shape: SAMPLES names of the cell's form and
FORMAT_LINES ranked lines of L2-like values (the roots of float32 sums
up to 20,000).  Its text must equal the host writer's
(``io/native.write_name_float_lines``) byte for byte; then one JSON line:
the kernel pair's ms (CUDA events over REPS calls of ``format_lines``),
its bound (the lines' 12 bytes of input, the names' offsets, the names'
bytes it gathers and the text it writes, over 3.35 TB/s), the query's
text on the card's route on the host clock (``CardText.text``: upload,
kernels, two readbacks, decode), the host writer's time on the same
lines and the plain twin's (``format_lines_plain``, Python).
``chip_smoke.py`` runs this module's ``run``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

SAMPLES = 382_016
SPECIES = 85_205
NNZ = (30, 383, 3000)
QUERIES_PER_NNZ = 4
FORMAT_LINES = 378_000    # ranked lines of the cell's query (PERF.md)
REPS = 20
MODES = (2, 1, 0)
PEAK_BYTES = 3.35e12
MODE_NAMES = {0: "cosine", 1: "L1", 2: "L2"}


def _popularity(seed: int, species: int):
    """Zipf weights (float64, summing to 1) of 1/rank, ranks dealt over
    the species ids at random."""
    import numpy as np
    w = 1.0 / (1 + np.random.default_rng([seed, 1]).permutation(species))
    return w / w.sum()


def _draws(p, targets):
    """Zipf draws (int64) whose expected count of distinct species under
    popularity ``p`` is each of ``targets``."""
    import numpy as np
    grid = np.unique(np.geomspace(1, 64 * p.size, 400).astype(np.int64))
    log1m = np.log1p(-p)
    distinct = np.array([np.sum(-np.expm1(k * log1m)) for k in grid])
    return np.ceil(np.interp(targets, distinct, grid)).astype(np.int64)


def make_index(seed: int, device, samples: int = SAMPLES,
               species: int = SPECIES):
    """``abv_postings.StagedPostings`` of ``samples`` x ``species`` drawn
    on ``device`` as the module docstring says."""
    import numpy as np
    import torch
    from metakssd_tpu_torch.formats.abv import AbvIndex
    from metakssd_tpu_torch.ops.abv_postings import StagedPostings
    from metakssd_tpu_torch.ops.abv_text import StagedNames
    rng = np.random.default_rng([seed, 2])
    p = _popularity(seed, species)
    targets = np.clip(np.rint(rng.lognormal(np.log(300), 0.7, samples)), 30,
                      min(3000, species))
    g = torch.Generator(device=device).manual_seed(seed)
    cdf = torch.from_numpy(np.cumsum(p)).to(device)
    sample = torch.repeat_interleave(
        torch.arange(samples, device=device),
        torch.from_numpy(_draws(p, targets)).to(device))
    u = torch.rand(sample.numel(), generator=g, dtype=torch.float64,
                   device=device) * cdf[-1]
    sp = torch.searchsorted(cdf, u).clamp_(max=species - 1)
    del u
    keys = torch.unique(sp * samples + sample)       # sorted, distinct
    del sp, sample
    ids = (keys % samples).to(torch.int32)
    df = torch.bincount(keys // samples, minlength=species)
    del keys
    starts = torch.zeros(species + 1, dtype=torch.int64, device=device)
    torch.cumsum(df, 0, out=starts[1:])
    pct = torch.rand(ids.numel(), generator=g, device=device) * 10 + 0.01
    starts_host = starts.cpu().numpy()
    index = AbvIndex([f"s{i}" for i in range(samples)], np.ones(samples),
                     starts_host[1:].astype(np.int32), ids.cpu().numpy(),
                     pct.cpu().numpy())
    return StagedPostings(index, starts_host, starts, ids, pct,
                          StagedNames(index.names, None, None))


def make_queries(nnz: int, seed: int, species: int = SPECIES,
                 stream: int = 0) -> list:
    """QUERIES_PER_NNZ queries ((species int32, pct float32), species in
    draw order) of ``nnz`` distinct species drawn by the popularity of
    the index made from ``seed``; ``stream`` tells sets apart."""
    import numpy as np
    rng = np.random.default_rng([seed, 3, stream, nnz])
    p = _popularity(seed, species)
    return [(rng.choice(species, min(nnz, species), replace=False,
                        p=p).astype(np.int32),
             (rng.random(min(nnz, species)) * 10 + 0.01).astype(np.float32))
            for _ in range(QUERIES_PER_NNZ)]


def _csr_on(staged, queries: list):
    """(q_off, q_sp, q_val, q_pos) on ``staged``'s device, and the
    postings the walk reads."""
    import torch
    from metakssd_tpu_torch.ops.abv_postings import query_csr
    off, sp, val, pos, walked = query_csr(staged.starts_host, queries)
    dev = staged.ids.device
    return [torch.from_numpy(a).to(dev) for a in (off, sp, val, pos)], walked


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check(staged, seed: int, sizes=NNZ) -> dict:
    """The kernel against its twin on ``staged``'s device (the index made
    from ``seed``), one query a (mode, size); raises on any bit of a measure or any touch that
    differs.  Returns {"measures_differ", "touches_differ", "max_abs_err",
    "plain_ms": {(mode, nnz): ms}}."""
    import torch
    from metakssd_tpu_torch.ops import abv_postings
    dev = staged.ids.device
    n = staged.n_samples
    measures = touches = 0
    worst = 0.0
    plain_ms = {}
    for nnz in sizes:
        csr, walked = _csr_on(staged, make_queries(
            nnz, seed, staged.starts.numel() - 1, stream=1)[:1])
        for mode in MODES:
            _, touch, measure = abv_postings.postings_walk(staged, *csr, mode)
            p_touch = torch.empty_like(touch)
            p_measure = torch.empty_like(measure)
            _sync(dev)
            t = time.perf_counter()
            abv_postings.postings_walk_plain(
                staged.starts, staged.ids, staged.pct, n, *csr, mode,
                p_measure, p_touch)
            _sync(dev)
            plain_ms[(mode, nnz)] = 1e3 * (time.perf_counter() - t)
            b = int((measure.view(torch.int32)
                     != p_measure.view(torch.int32)).sum())
            d = int((touch != p_touch).sum())
            err = float((measure.double() - p_measure.double()).abs().max())
            measures, touches = measures + b, touches + d
            worst = max(worst, err)
            print(f"  check: {MODE_NAMES[mode]}, {nnz} species, {walked} "
                  f"postings, {int((touch >= 0).sum())} samples touched: "
                  f"{b} measures (float32 bits) and {d} touches differ from "
                  f"the twin, max |kernel - twin| {err}, twin "
                  f"{plain_ms[(mode, nnz)]:.1f} ms", flush=True)
    if measures or touches:
        raise AssertionError(f"postings walk: {measures} measures and "
                             f"{touches} first touches differ from the "
                             "plain twin")
    return {"measures_differ": measures, "touches_differ": touches,
            "max_abs_err": worst, "plain_ms": plain_ms}


def _events_ms(fn, n: int) -> float:
    import torch
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(n):
        fn(i)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def time_cases(staged, seed: int, plain_ms: dict) -> list[dict]:
    """One record a (mode, nnz), as the module docstring says."""
    import torch
    from metakssd_tpu_torch.ops import _build, abv_postings
    n, species = staged.n_samples, staged.starts.numel() - 1
    lines = []
    for nnz in NNZ:
        qs = make_queries(nnz, seed, species, stream=2)
        csrs = [_csr_on(staged, [q]) for q in qs]
        walked = sum(w for _, w in csrs) / len(csrs)
        nbytes = walked * 8 + n * 12
        for mode in MODES:
            def kernel(i):
                abv_postings.postings_walk(staged, *csrs[i % len(csrs)][0],
                                           mode)
            kernel(0)
            kernel(1)
            torch.cuda.synchronize()
            before = _build.LAUNCHES["abv_post_walk"]
            ms = _events_ms(kernel, REPS)
            launches = _build.LAUNCHES["abv_post_walk"] - before
            path = []
            for q in qs:
                t = time.perf_counter()
                abv_postings.postings_search_batch(staged, [q], mode=mode)
                path.append(1e3 * (time.perf_counter() - t))
            rec = {"kernel": "mkssd_abv_post_walk", "mode": MODE_NAMES[mode],
                   "samples": n, "species": species,
                   "nnz": nnz, "postings": walked, "ms": ms,
                   "bound_ms": 1e3 * nbytes / PEAK_BYTES,
                   "bound_bytes": nbytes,
                   "plain_ms": plain_ms.get((mode, nnz)),
                   "path_ms": sorted(path)[len(path) // 2],
                   "launches": launches}
            rec["ms_over_bound"] = ms / rec["bound_ms"]
            print(json.dumps(rec), flush=True)
            lines.append(rec)
        del csrs
    return lines


def format_case(seed: int, device, samples: int = SAMPLES,
                lines: int = FORMAT_LINES, reps: int = REPS) -> dict:
    """The text formatter checked against the host writer and timed, as
    the module docstring says; raises where the texts differ."""
    import io
    import numpy as np
    import torch
    from metakssd_tpu_torch.io import native as native_io
    from metakssd_tpu_torch.ops import _build, abv_text
    dev = torch.device(device)
    names = [f"SRR{10_000_000 + i}.abv" for i in range(samples)]
    t = time.perf_counter()
    card = abv_text.CardText.stage(names, dev)
    stage_ms = 1e3 * (time.perf_counter() - t)
    rng = np.random.default_rng([seed, 4])
    ids = rng.permutation(samples)[:lines].astype(np.int64)
    vals = np.sqrt(rng.random(lines, dtype=np.float32).astype(np.float64)
                   * np.float32(20000.0))
    blob, off = native_io.names_blob(names)
    host = io.StringIO()
    t = time.perf_counter()
    native_io.write_name_float_lines(host, names, blob, off, ids, vals)
    host_ms = 1e3 * (time.perf_counter() - t)
    path = []
    for _ in range(3):
        t = time.perf_counter()
        text = card.text(ids, vals)
        path.append(1e3 * (time.perf_counter() - t))
    if text != host.getvalue():
        raise AssertionError("format_lines: the card's text differs from "
                             "the host writer's")
    n = ids.size
    args = (card.blob, card.off, card.lines[8 * n:12 * n].view(torch.int32),
            card.lines[:8 * n].view(torch.float64), card.scratch, card.out)
    before = _build.LAUNCHES["abv_format_lines"]
    ms = (_events_ms(lambda i: abv_text.format_lines(*args), reps)
          if dev.type == "cuda" else None)
    launches = _build.LAUNCHES["abv_format_lines"] - before
    cpu = [a.cpu() for a in args]
    t = time.perf_counter()
    abv_text.format_lines_plain(*cpu)
    plain_ms = 1e3 * (time.perf_counter() - t)
    off = card.off.cpu().numpy()
    nbytes = 12 * n + off.nbytes + int((off[ids + 1] - off[ids]).sum()) \
        + len(text)
    rec = {"kernel": "mkssd_abv_format_lines", "samples": samples,
           "lines": n, "text_bytes": len(text), "ms": ms,
           "bound_ms": 1e3 * nbytes / PEAK_BYTES, "bound_bytes": nbytes,
           "plain_ms": plain_ms, "path_ms": sorted(path)[1],
           "host_writer_ms": host_ms, "stage_ms": stage_ms,
           "launches": launches, "text_equal": True}
    print(json.dumps(rec), flush=True)
    return rec


def run(seed: int = 0) -> dict:
    """Stage, check, then time the walk at the whole DB's shape, then the
    text formatter at the cell's; returns the records and the check's
    counts."""
    import torch
    dev = torch.device("cuda")
    t = time.time()
    staged = make_index(seed, dev)
    torch.cuda.synchronize()
    nnz = staged.ids.numel()
    print(f"  postings {SAMPLES} x {SPECIES} on the card: {nnz} postings "
          f"({nnz * 8 / 1e9:.2f} GB), staged in {time.time() - t:.1f} s",
          flush=True)
    got = check(staged, seed)
    lines = time_cases(staged, seed, got.pop("plain_ms"))
    del staged
    torch.cuda.empty_cache()
    fmt = format_case(seed, dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[:1]
    tail = {"card": card[0] if card else torch.cuda.get_device_name(0),
            "postings": nnz, **got}
    print(json.dumps(tail), flush=True)
    return {"lines": lines, "format": fmt, **tail}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_abv_postings: no CUDA device", file=sys.stderr)
        return 1
    run(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
