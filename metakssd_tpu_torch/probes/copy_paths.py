"""What the chunk loop's copies cost on the card, one 64M-window chunk
(64 MiB of codes) at a time: the host copy into pinned memory by numpy
(one thread) and by torch (the host's threads); the H2D from a whole
pinned tensor and from a view of one, on the current stream and on a
side stream (host time of the call, device time by CUDA events); the
H2D while the host copies the next chunk into another pinned buffer;
and the host time of queueing a count's D2H into a pinned slot behind a
busy stream.  Three runs of each.  On the card:

    python -m metakssd_tpu_torch.probes.copy_paths
"""

from __future__ import annotations

import subprocess
import sys
import time
import warnings

N = (64 << 20) + 21             # a chunk's codes: 64M windows at L3K11
RUNS = 3


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("copy_paths: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
        + f"; torch threads {torch.get_num_threads()}", flush=True)
    dev = torch.device("cuda")
    seg = np.random.default_rng(0).integers(0, 4, N, dtype=np.uint8)
    seg.flags.writeable = False          # as a parser's buffer may be
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        src = torch.from_numpy(seg)
    a = torch.empty(N, dtype=torch.uint8, pin_memory=True)
    b = torch.empty(N, dtype=torch.uint8, pin_memory=True)
    side = torch.cuda.Stream()

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    for _ in range(RUNS):
        t = time.perf_counter()
        a.numpy()[:] = seg
        t_np = time.perf_counter() - t
        t = time.perf_counter()
        a.copy_(src)
        t_torch = time.perf_counter() - t
        print(f"host copy: numpy {t_np * 1e3:.3f} ms, torch "
              f"{t_torch * 1e3:.3f} ms", flush=True)
    for what, host in (("whole", a), ("view", b[:N - 5])):
        for sname, stream in (("current", torch.cuda.current_stream()),
                              ("side", side)):
            for _ in range(RUNS):
                torch.cuda.synchronize()
                e0, e1 = events()
                with torch.cuda.stream(stream):
                    e0.record()
                    t = time.perf_counter()
                    c = torch.empty(host.numel(), dtype=torch.uint8,
                                    device=dev)
                    c.copy_(host, non_blocking=True)
                    t = time.perf_counter() - t
                    e1.record()
                torch.cuda.synchronize()
                print(f"h2d {what} {sname} stream: host {t * 1e3:.3f} ms, "
                      f"device {e0.elapsed_time(e1):.3f} ms", flush=True)
    for copy in ("numpy", "torch"):
        for _ in range(RUNS):
            torch.cuda.synchronize()
            e0, e1 = events()
            with torch.cuda.stream(side):
                e0.record()
                c = torch.empty(N, dtype=torch.uint8, device=dev)
                c.copy_(a, non_blocking=True)
                e1.record()
            t = time.perf_counter()
            if copy == "numpy":
                b.numpy()[:] = seg
            else:
                b.copy_(src)
            t = time.perf_counter() - t
            torch.cuda.synchronize()
            print(f"h2d beside a {copy} host copy: device "
                  f"{e0.elapsed_time(e1):.3f} ms, host copy {t * 1e3:.3f} ms",
                  flush=True)
    slots = torch.empty(16, dtype=torch.int64, pin_memory=True)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    for _ in range(RUNS):
        torch.cuda._sleep(int(2e8))
        t = time.perf_counter()
        slots[3:4].copy_(count, non_blocking=True)
        t = time.perf_counter() - t
        torch.cuda.synchronize()
        print(f"count d2h into a pinned slot behind a busy stream: host "
              f"{t * 1e3:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
