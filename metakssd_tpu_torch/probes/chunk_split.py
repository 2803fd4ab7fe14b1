"""The chunk loop's own cost (``ops/sketch_cuda.sketch_windows``) per
64M-window chunk on the card, and the order it queues and resolves
chunks in.

``serial_split`` runs the loop as it was before the pipelined dispatch:
per chunk a fresh pinned buffer, the host copy into it, the H2D on the
current stream, K1, ``count.item()`` and the readback, each timed (host
clock; H2D and K1 by CUDA events).  ``pipelined_split`` times
``sketch_windows`` itself and splits its chunks by wrapping the loop's
steps: the host copy (``_Lane.stage``, with its wait for the buffer's
last H2D), the H2D and K1 (CUDA events on the copy and current streams),
the count wait (``_Chunk.kept``) and the readback (the rest of
``_Chunk.result``).  ``record_order`` and ``check_order`` hold a run to
the loop's contract; the tests and ``chip_smoke.py`` use them.

Run as a script, so that ``--root`` can point at another checkout (the
whole loop's time then comes from that checkout's ``sketch_windows``; the
pipelined split needs this one's):

    python metakssd_tpu_torch/probes/chunk_split.py [--root DIR]
        [--chunks 16] [--seed 0]

One JSON line per timed run, in turns: serial, pipelined, pipelined,
serial, each over ``--chunks`` chunks of random L3K11 codes.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import subprocess
import sys
import time

L3K11 = (11, 6, 3)


@contextlib.contextmanager
def record_order():
    """A list that receives "queue" as the chunk loop launches a chunk's
    K1 and "resolve" as it reads a chunk's count, while the block runs."""
    from metakssd_tpu_torch.ops import sketch_cuda
    log: list[str] = []
    compact, kept = sketch_cuda.window_compact, sketch_cuda._Chunk.kept

    def logged_compact(*a, **kw):
        log.append("queue")
        return compact(*a, **kw)

    def logged_kept(self):
        log.append("resolve")
        return kept(self)

    sketch_cuda.window_compact = logged_compact
    sketch_cuda._Chunk.kept = logged_kept
    try:
        yield log
    finally:
        sketch_cuda.window_compact = compact
        sketch_cuda._Chunk.kept = kept


def check_order(log: list, nchunks: int, ndev: int) -> None:
    """Raises unless the run queued ``nchunks`` chunks and resolved each
    once, in order, with at most DEPTH x ndev + 1 in flight, none before
    more than DEPTH x ndev were queued (but in the final drain), and none
    before the next chunk's K1 was queued."""
    from metakssd_tpu_torch.ops.sketch_cuda import DEPTH
    q = r = 0
    for ev in log:
        if ev == "queue":
            q += 1
            if q - r > DEPTH * ndev + 1:
                raise AssertionError(f"{q - r} chunks in flight on {ndev} "
                                     f"devices at chunk {q - 1}")
            continue
        if not (q - r > DEPTH * ndev or q == nchunks):
            raise AssertionError(f"chunk {r} resolved with {q - r} in "
                                 "flight before the drain")
        if r + 1 < nchunks and q < r + 2:
            raise AssertionError(f"chunk {r} resolved before chunk {r + 1} "
                                 "was queued")
        r += 1
    if q != nchunks or r != nchunks:
        raise AssertionError(f"{q} queued and {r} resolved of {nchunks}")


def checked_run(codes, p, tables, chunk_windows: int, capacity: int,
                devices, ref, reruns: int) -> None:
    """One ``want_pos`` run of ``sketch_windows`` held to the loop's
    contract: (drtuple, position) pairs equal ``ref``'s (the same call's
    on the CPU), the order of ``check_order`` and, on a card, K1
    launched once a chunk, K2 ``reruns`` times (once for each chunk that
    overflows), two pinned upload buffers a card (one where the card got
    one chunk) and one array of count slots, whatever the chunk count."""
    import numpy as np
    from metakssd_tpu_torch.ops import _build, sketch_cuda
    nchunks = -(-(codes.size - p.kmer_len + 1) // chunk_windows)
    devs = sketch_cuda._chunk_devices(devices, tables.accept.device, nchunks)
    on_card = collections.Counter(devs[i % len(devs)] for i in range(nchunks))
    launches = dict(_build.LAUNCHES)
    pinned = dict(sketch_cuda.PINNED_ALLOCS)
    with record_order() as log:
        dr, pos = sketch_cuda.sketch_windows(
            codes, p, tables, want_pos=True, chunk_windows=chunk_windows,
            capacity=capacity, devices=devices)
    check_order(log, nchunks, len(devs))
    what = f"devices={devices}"
    if devs[0].type == "cuda":
        ran = {k: _build.LAUNCHES[k] - launches[k]
               for k in ("sketch_compact", "sketch_full")}
        if ran != {"sketch_compact": nchunks, "sketch_full": reruns}:
            raise AssertionError(f"{what}: launches {ran} for {nchunks} "
                                 f"chunks and {reruns} reruns")
        allocs = {k: sketch_cuda.PINNED_ALLOCS[k] - pinned[k]
                  for k in pinned}
        want = {"upload": sum(min(2, n) for n in on_card.values()),
                "count": 1}
        if allocs != want:
            raise AssertionError(f"{what}: pinned allocations {allocs}, "
                                 f"not {want}")
    a, b = np.lexsort((dr, pos)), np.lexsort((ref[0], ref[1]))
    if not (np.array_equal(pos[a], ref[1][b])
            and np.array_equal(dr[a], ref[0][b])):
        raise AssertionError(f"{what}: (drtuple, position) pairs differ "
                             "from the CPU's")


def _mean(xs) -> float:
    return sum(xs) / len(xs) if xs else 0.0


def serial_split(codes, p, tables, chunk_windows: int) -> dict:
    """The serial loop's per-chunk ms (see the module docstring)."""
    import numpy as np
    import torch
    from metakssd_tpu_torch.ops import sketch_cuda
    TL = p.kmer_len
    dev = tables.accept.device
    nwin_total = codes.size - TL + 1
    rows = []
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for start in range(0, nwin_total, chunk_windows):
        nw = min(chunk_windows, nwin_total - start)
        seg = codes[start:start + nw + TL - 1]
        cap = sketch_cuda.default_capacity(nw, tables)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        host = torch.empty(seg.size, dtype=torch.uint8, pin_memory=True)
        t1 = time.perf_counter()
        host.numpy()[:] = seg
        t2 = time.perf_counter()
        ev[0].record()
        c = host.to(dev, non_blocking=True)
        ev[1].record()
        dr, _, count = sketch_cuda.window_compact(c, tables, p, cap)
        ev[2].record()
        t3 = time.perf_counter()
        n = int(count.item())
        t4 = time.perf_counter()
        if n > cap:
            raise RuntimeError("a random chunk overflowed its capacity")
        dr[:n].cpu().numpy().view(np.uint32)
        t5 = time.perf_counter()
        rows.append((t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4, ev))
    wall = time.perf_counter() - t_all
    ms = 1e3
    return {"order": "serial", "chunks": len(rows),
            "wall_ms_per_chunk": wall * ms / len(rows),
            "pinned_alloc_ms": _mean([r[0] * ms for r in rows]),
            "host_copy_ms": _mean([r[1] * ms for r in rows]),
            "queue_ms": _mean([r[2] * ms for r in rows]),
            "count_wait_ms": _mean([r[3] * ms for r in rows]),
            "readback_ms": _mean([r[4] * ms for r in rows]),
            "h2d_ms": _mean([r[5][0].elapsed_time(r[5][1]) for r in rows]),
            "k1_ms": _mean([r[5][1].elapsed_time(r[5][2]) for r in rows])}


def pipelined_split(codes, p, tables, chunk_windows: int,
                    devices=None) -> dict:
    """``sketch_windows``'s per-chunk ms, split by wrapping its steps."""
    import torch
    from metakssd_tpu_torch.ops import sketch_cuda
    Lane, Chunk = sketch_cuda._Lane, sketch_cuda._Chunk
    stage, upload, kept, result = Lane.stage, Lane.upload, Chunk.kept, \
        Chunk.result
    compact = sketch_cuda.window_compact
    host = {"host_copy_ms": [], "queue_ms": [], "count_wait_ms": [],
            "readback_ms": []}
    dev_ev: dict = {"h2d": [], "k1": []}

    def timed(key, fn):
        t = time.perf_counter()
        out = fn()
        host[key].append((time.perf_counter() - t) * 1e3)
        return out

    def events(key, stream, fn):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record(stream)
        out = fn()
        e1.record(stream)
        dev_ev[key].append((e0, e1))
        return out

    def w_upload(self, h, b):
        return events("h2d", self.copy, lambda: upload(self, h, b))

    def w_compact(c, *a, **kw):
        return events("k1", torch.cuda.current_stream(c.device),
                      lambda: compact(c, *a, **kw))

    def w_result(self, *a):
        t = time.perf_counter()
        n0 = sum(host["count_wait_ms"])
        out = result(self, *a)
        wait = sum(host["count_wait_ms"]) - n0
        host["readback_ms"].append((time.perf_counter() - t) * 1e3 - wait)
        return out

    def w_chunk_init(self, *a, **kw):
        timed("queue_ms", lambda: chunk_init(self, *a, **kw))

    chunk_init = Chunk.__init__
    Lane.stage = lambda self, seg: timed("host_copy_ms",
                                         lambda: stage(self, seg))
    Lane.upload = w_upload
    Chunk.kept = lambda self: timed("count_wait_ms", lambda: kept(self))
    Chunk.result = w_result
    Chunk.__init__ = w_chunk_init
    sketch_cuda.window_compact = w_compact
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        dr, _ = sketch_cuda.sketch_windows(codes, p, tables,
                                           chunk_windows=chunk_windows,
                                           devices=devices)
        wall = time.perf_counter() - t
        torch.cuda.synchronize()
    finally:
        Lane.stage, Lane.upload, Chunk.kept, Chunk.result = \
            stage, upload, kept, result
        Chunk.__init__ = chunk_init
        sketch_cuda.window_compact = compact
    n = len(dev_ev["k1"])
    out = {"order": "pipelined", "chunks": n,
           "wall_ms_per_chunk": wall * 1e3 / n, "survivors": int(dr.size)}
    # queue_ms holds the host copy, the H2D's and K1's queueing
    out["queue_ms"] = _mean(host["queue_ms"]) - _mean(host["host_copy_ms"])
    for key in ("host_copy_ms", "count_wait_ms", "readback_ms"):
        out[key] = _mean(host[key])
    for key, evs in dev_ev.items():
        out[key + "_ms"] = _mean([a.elapsed_time(b) for a, b in evs])
    return out


def loop_ms(codes, p, tables, chunk_windows: int) -> float:
    """Wall ms per chunk of one ``sketch_windows`` call, untouched."""
    import torch
    from metakssd_tpu_torch.ops import sketch_cuda
    torch.cuda.synchronize()
    t = time.perf_counter()
    sketch_cuda.sketch_windows(codes, p, tables, chunk_windows=chunk_windows)
    torch.cuda.synchronize()
    nchunks = -(-(codes.size - p.kmer_len + 1) // chunk_windows)
    return (time.perf_counter() - t) * 1e3 / nchunks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--chunks", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    from metakssd_tpu_torch.formats.shuf import make_shuf
    from metakssd_tpu_torch.ops import sketch_cuda
    from metakssd_tpu_torch.params import SketchParams
    from metakssd_tpu_torch.state import accept_tables

    if not torch.cuda.is_available():
        print("chunk_split: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    p = SketchParams(*L3K11)
    tables = accept_tables(make_shuf(p, seed=args.seed), "cuda")
    cw = sketch_cuda.CHUNK_WINDOWS
    codes = np.random.default_rng(args.seed).integers(
        0, 4, size=args.chunks * cw + p.kmer_len - 1, dtype=np.uint8)
    sketch_cuda.sketch_windows(codes[:1 << 20], p, tables)      # warm-up
    root = os.path.abspath(args.root)
    piped = hasattr(sketch_cuda, "_Lane")
    for order in ("serial", "pipelined", "pipelined", "serial"):
        if order == "serial":
            rec = serial_split(codes, p, tables, cw)
        elif piped:
            rec = pipelined_split(codes, p, tables, cw)
        else:
            rec = {"order": "pipelined", "chunks": args.chunks,
                   "note": "this checkout's loop is serial"}
        rec["loop_ms_per_chunk"] = loop_ms(codes, p, tables, cw)
        rec["root"] = root
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
