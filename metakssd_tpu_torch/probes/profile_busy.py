"""The card's busy share of ``profile``: runs the smoke run's profile
slice (``probes/smoke_data.py``: 1024-genome L3K11 MarkerDB, 4M reads)
once untraced for its wall time and once under ``torch.profiler`` for the
device time of its kernels and copies.  On the card:

    python -m metakssd_tpu_torch.probes.profile_busy
"""

from __future__ import annotations

import os
import shutil
import time


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from metakssd_tpu_torch import cli
    from metakssd_tpu_torch.io import native
    from metakssd_tpu_torch.probes import smoke_data

    work = os.path.abspath(f".smoke_work_{os.getpid()}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        shufp, gdir, fq, _, _, _ = smoke_data.make_slice_data(work, 0)
        db = os.path.join(work, "markerdb")
        assert cli.main(["dist", "-L", shufp, "-o", db, "--device", "cuda",
                         gdir]) == 0

        def run(tag: str) -> float:
            torch.cuda.synchronize()
            t = time.time()
            assert cli.main(["profile", "-L", shufp, "-r", db, "-o",
                             os.path.join(work, tag), "--device", "cuda",
                             fq]) == 0
            torch.cuda.synchronize()
            return time.time() - t

        run("warm")
        wall = run("untraced")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced = run("traced")
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) \
                    + e.time_range.elapsed_us() / 1e3
        busy = sum(by_name.values())
        print(f"{torch.cuda.get_device_name(0)}; host library "
              f"{native.build_kind()}", flush=True)
        print(f"profile wall {wall:.4f} s untraced, {traced:.4f} s traced; "
              f"device time {busy:.3f} ms = {100 * busy / (wall * 1e3):.3f}% "
              "of the untraced wall time", flush=True)
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {ms:9.3f} ms  {name[:90]}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
