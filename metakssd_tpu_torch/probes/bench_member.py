"""Time the membership kernel K3 on the card at the shapes its callers
give it.  Run as a script, so that ``--root`` can point at another
checkout of this package (to time two commits in one call, in turns):

    python metakssd_tpu_torch/probes/bench_member.py [--root DIR] [--seed N]
        [--launches]

Shapes (``make_shape``; every input from the seed with numpy, u32 keys
>= 2^31 included):

* ``4M x 1M``: 1M sorted needles, half hits, against about 4.19M distinct
  random keys (the shape timed since K3 was ported);
* ``dist batch``: DIST_QUERIES runs of QUERY_KMERS sorted needles, half
  hits, each run spread over the same 4.19M keys: what one component of
  ``dist -r`` gives its one K3 call (128 genome queries at K8S5L2);
* ``set -s``: SET_RUNS runs of SET_RUN sorted ids, SET_HITS of them hits,
  against SET_HAY distinct keys: the ``set -s uq co`` call of a MarkerDB
  build of 65,536 genomes (``probes/smoke_data.make_set_data``);
* ``profile match``: PROFILE_IDS sorted ids, PROFILE_HITS of them hits,
  against PROFILE_HAY distinct keys: the one K3 call of ``profile
  --shard-db 1`` in ``chip_smoke.py`` (a component's distinct MarkerDB
  k-mers against the sample's ids), which K3's groups launch takes;
* ``dist -r shard``: SHARD_NEEDLES sorted ids below 2^24, SHARD_HITS of
  them hits, against SHARD_HAY distinct keys in values mode: one shard's
  call of ``dist -r --shard-db 4`` in ``chip_smoke.py`` (a reference
  component's postings against one query's ids and multiplicities),
  whose blocks all stage the whole haystack.

One JSON line per shape: K3's ms in identity mode (the product paths'
mode) with the haystack's index built beforehand where the checkout has
one, timed twice: back-to-back calls between CUDA events (``k3_ms``,
the host's enqueueing included where it is slower than the card) and
calls replayed from a CUDA graph (``k3_graph_ms``, the card's time); and
the index build's ms; at ``4M x 1M`` also values mode; at
``dist batch`` also the same needles as DIST_QUERIES calls of one query
each (how ``dist -r`` called K3 before it batched a component).  CUDA
events over ``--reps`` calls after two warm-ups; the haystack stays in
L2 between calls where it fits (16.8 MB at 4.19M keys; 79 MB at SET_HAY
does not).  Where the checkout's K3 has two launches, each line names the
one its rule takes (``launch``).  ``--launches`` then times both launches
from a CUDA graph at SWEEP needle counts over the ``profile match`` and
``4M x 1M`` haystacks (sorted needles drawn as those shapes draw them),
the measurement behind the rule's threshold.  ``chip_smoke.py`` times
the same shapes, with K3's plain version and ``torch.searchsorted``
beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ALL_ONES = 0xFFFFFFFF
HAY_4M = 1 << 22                  # haystack draw (about 4.19M distinct)
NEEDLES_4M = 1 << 20
QUERY_KMERS = 4096                # needles of one K8S5L2 genome query
DIST_QUERIES = 128
SET_RUNS = 65_600                 # genomes of the set leg ...
SET_RUN = 1024                    # ... of about 1,024 ids each
SET_HAY = 16384 * 1200            # uq: every taxon's own ids
SET_HITS = 0.94                   # share of a genome's ids in uq
PROFILE_HAY = 249_105             # profile --shard-db 1: component c0's
PROFILE_IDS = 5636                # ... distinct k-mers x the sample's ids
PROFILE_HITS = 0.9998             # (5,635 of 5,636 were members)
SHARD_HAY = 3830                  # dist -r --shard-db 4, one shard: a
SHARD_NEEDLES = 1_000_033         # ... query's ids x a shard's postings
SHARD_HITS = 0.0042               # (4,202 of them were members)
SHAPES = ("4M x 1M", "dist batch", "set -s", "profile match",
          "dist -r shard")
SWEEP = (1024, 5636, 16384, 32768, 65536, 131072, 262144)


def make_shape(name: str, seed: int, device):
    """(haystack, values, needles) of one shape as int32 tensors of u32
    bits on ``device``; runs are sorted on the device."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed + 11 + SHAPES.index(name))

    def u32(lo, hi, n):
        return rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32)

    if name in ("profile match", "dist -r shard"):   # exactly nh keys
        nh, top = (PROFILE_HAY, ALL_ONES) if name == "profile match" \
            else (SHARD_HAY, 1 << 24)
        hay = np.sort(rng.choice(np.unique(u32(0, top, nh + nh // 64)),
                                 nh, replace=False))
    else:
        hay = np.unique(u32(0, ALL_ONES,
                            SET_HAY if name == "set -s" else HAY_4M))
    if name == "4M x 1M":
        runs, run, hits = 1, NEEDLES_4M, 0.5
    elif name == "dist batch":
        runs, run, hits = DIST_QUERIES, QUERY_KMERS, 0.5
    elif name == "profile match":
        runs, run, hits = 1, PROFILE_IDS, PROFILE_HITS
    elif name == "dist -r shard":
        runs, run, hits = 1, SHARD_NEEDLES, SHARD_HITS
    else:
        runs, run, hits = SET_RUNS, SET_RUN, SET_HITS
    n = runs * run
    needles = u32(0, 1 << 24 if name == "dist -r shard" else ALL_ONES, n)
    hit = rng.random(n, dtype=np.float32) < hits
    needles[hit] = hay[rng.integers(0, hay.size, int(hit.sum()))]
    x = torch.from_numpy(needles.astype(np.int64)).to(device)
    x = torch.sort(x.view(runs, run), dim=1).values.reshape(-1)
    x = torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
    h = torch.from_numpy(hay.view(np.int32)).to(device)
    v = torch.from_numpy(u32(0, 1 << 32, hay.size).view(np.int32)).to(device)
    return h, v, x.contiguous()


def time_ms(fn, reps: int) -> float:
    """ms per call of fn: ``reps`` calls between CUDA events, after two
    warm-up calls."""
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


def graph_ms(fn, calls: int = 10, reps: int = 20) -> float:
    """ms per call of fn, ``calls`` calls captured in one CUDA graph and
    the graph replayed ``reps`` times (one warm-up call first): the card's
    time without the host's, which an event-timed loop of short calls
    measures instead."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for _ in range(calls)]
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del outs, graph
    return e0.elapsed_time(e1) / (reps * calls)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--launches", action="store_true",
                    help="also time both K3 launches at SWEEP counts")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("bench_member: no CUDA device", file=sys.stderr)
        return 1
    from metakssd_tpu_torch.ops import merge

    indexed = hasattr(merge, "build_index")
    two = hasattr(merge, "member_launch")       # K3 has two launches
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for name in SHAPES:
        h, v, x = make_shape(name, args.seed, dev)
        rec = {"root": args.root, "shape": name, "nh": h.numel(),
               "nn": x.numel(), "indexed": indexed,
               "launch": merge.member_launch(x.numel()) if two
               else "blocks"}
        if indexed:
            rec["index_ms"] = time_ms(lambda: merge.build_index(h), 5)
            ix = merge.build_index(h)
            k3 = lambda vv, nd: merge.member(h, vv, nd, ix)  # noqa: E731
        else:
            k3 = lambda vv, nd: merge.member(h, vv, nd)  # noqa: E731
        rec["k3_ms"] = time_ms(lambda: k3(None, x), args.reps)
        rec["k3_graph_ms"] = graph_ms(lambda: k3(None, x))
        if name == "4M x 1M":
            rec["k3_values_ms"] = time_ms(lambda: k3(v, x), args.reps)
        if name == "dist -r shard":       # the product path's mode
            rec["k3_values_graph_ms"] = graph_ms(lambda: k3(v, x))
        if name == "dist batch":
            runs = x.view(DIST_QUERIES, QUERY_KMERS)
            rec["k3_per_query_x128_ms"] = time_ms(
                lambda: [k3(None, r) for r in runs], 5)
        print(json.dumps(rec), flush=True)
        del h, v, x
        torch.cuda.empty_cache()
    if args.launches and two:
        for name in ("profile match", "4M x 1M"):
            launch_sweep(merge, name, args.seed, dev)
    return 0


def launch_sweep(merge, name: str, seed: int, dev) -> None:
    """K3's two launches from a CUDA graph at each SWEEP needle count:
    the first n of max(SWEEP) needles drawn with the shape's share of
    hits, sorted, against its haystack, in identity mode; one JSON line
    each."""
    import numpy as np
    import torch
    h, _, _ = make_shape(name, seed, dev)
    ix = merge.build_index(h)
    rng = np.random.default_rng(seed + 31)
    hits = PROFILE_HITS if name == "profile match" else 0.5
    hay = h.cpu().numpy().view(np.uint32)
    n = max(SWEEP)
    x = rng.integers(0, ALL_ONES, n, dtype=np.uint64).astype(np.uint32)
    hit = rng.random(n) < hits
    x[hit] = hay[rng.integers(0, hay.size, int(hit.sum()))]
    for nn in SWEEP:
        nd = merge.u32_tensor(np.sort(x[:nn])).to(dev)
        rec = {"sweep": name, "nh": h.numel(), "nn": nn,
               "rule": merge.member_launch(nn)}
        for launch in merge.K3_LAUNCH_CODES:
            rec[f"{launch}_graph_ms"] = graph_ms(
                lambda: merge.member(h, None, nd, ix, launch))
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
