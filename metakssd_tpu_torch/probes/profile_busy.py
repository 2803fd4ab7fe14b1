"""The card's busy share of stage I and ``profile`` on the smoke run's
slice data (``probes/smoke_data.py``: 1024 genomes x 1 Mbp at L3K11,
4M reads x 150 bp).  Each leg runs once to warm up, once untraced for its
wall time and ``stage1.sketch`` seconds, and once under
``torch.profiler`` for the device time of its kernels and copies:

* ``dist``: the 1 Gbase of genomes into a MarkerDB (batched stage I,
  16 chunks of 64M windows in one ``sketch_windows`` call);
* ``byread``: ``dist --byread`` of the 4M reads;
* ``profile``: the 4M reads against that MarkerDB.

Run as a script, so that ``--root`` can point at another checkout (to
time two commits in one call, in turns); ``--work`` keeps the data
between runs (made there when missing):

    python metakssd_tpu_torch/probes/profile_busy.py [--root DIR]
        [--work DIR] [--legs dist,byread,profile]

One JSON line a leg.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

LEGS = ("dist", "byread", "profile")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--work", default=None)
    ap.add_argument("--legs", default=",".join(LEGS))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from metakssd_tpu_torch import cli
    from metakssd_tpu_torch.io import native
    from metakssd_tpu_torch.pipeline import TIMER
    from metakssd_tpu_torch.probes import smoke_data

    if not torch.cuda.is_available():
        print("profile_busy: no CUDA device", file=sys.stderr)
        return 1
    legs = args.legs.split(",")
    if not set(legs) <= set(LEGS):
        ap.error(f"--legs takes {', '.join(LEGS)}")
    keep = args.work is not None
    work = os.path.abspath(args.work or f".smoke_work_{os.getpid()}")
    made = os.path.join(work, "made")
    if not os.path.exists(made):
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        smoke_data.make_slice_data(work, 0)
        open(made, "w").close()
    shufp = os.path.join(work, "L3K11.shuf")
    gdir = os.path.join(work, "genomes")
    fq = os.path.join(work, "sample.fq")
    db = os.path.join(work, "markerdb")
    out = os.path.join(work, f"out_{os.getpid()}")
    argvs = {
        "dist": lambda o: ["dist", "-L", shufp, "-o", o, gdir],
        "byread": lambda o: ["dist", "--byread", "-L", shufp, "-o", o, fq],
        "profile": lambda o: ["profile", "-L", shufp, "-r", db, "-o", o, fq],
    }
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
        + f"; host library {native.build_kind()}", flush=True)
    try:
        if not os.path.isdir(db):
            assert cli.main(argvs["dist"](db) + ["--device", "cuda"]) == 0

        def run(leg: str) -> tuple[float, float]:
            shutil.rmtree(out, ignore_errors=True)
            torch.cuda.synchronize()
            t = time.time()
            assert cli.main(argvs[leg](out) + ["--device", "cuda"]) == 0
            torch.cuda.synchronize()
            wall = time.time() - t
            return wall, sum(dt for name, dt in TIMER.stages
                             if name == "stage1.sketch")

        for leg in legs:
            run(leg)
            wall, sketch_s = run(leg)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                traced, _ = run(leg)
            by_name: dict = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    by_name[e.name] = by_name.get(e.name, 0.0) \
                        + e.time_range.elapsed_us() / 1e3
            busy = sum(by_name.values())
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            print(json.dumps({
                "leg": leg, "root": os.path.abspath(args.root),
                "wall_s": wall, "stage1_sketch_s": sketch_s,
                "traced_s": traced, "device_ms": busy,
                "busy_pct": 100 * busy / (wall * 1e3),
                "top_ms": {name[:60]: ms for name, ms in top}}), flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)
        if not keep:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
