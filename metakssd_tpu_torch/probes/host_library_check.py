"""Does the native host library slow torch's CPU routes?  Times, on the
host's clock, torch CPU ops alone and the set verbs' ``--device cpu``
route with no host library, with the one this checkout builds (OpenMP, or
serial where ``-fopenmp`` fails) or with a given OpenMP-built one.  One
process per library:

    python -m metakssd_tpu_torch.probes.host_library_check ops LIBRARY
    python -m metakssd_tpu_torch.probes.host_library_check set LIBRARY

with LIBRARY one of ``none``, ``built`` or ``PATH.so``.

``ops``: ``torch.sort`` and ``torch.unique`` of 4M int64 and a 1024^3
matmul, alone and right after a native radix sort.  ``set``: the smoke
run's set leg (``probes/smoke_data.py``, 67M ids) through
``set -g/-q/-i/-u/-s/-c --device cpu``.  ``PATH.so`` (an OpenMP build made
on a host whose g++ has libgomp) is copied to where this checkout would
keep its own OpenMP build, so the loader finds it there.
"""

from __future__ import annotations

import os
import shutil
import sys
import time


def _use_library(which: str):
    from metakssd_tpu_torch.io import native
    if which == "none":
        os.environ["MKSSD_NO_NATIVE"] = "1"
    elif which != "built":
        os.makedirs(native._BUILD_DIR, exist_ok=True)
        shutil.copy(which, native._library_path(native._CXXFLAGS))
    if which != "none" and not native.available():
        raise SystemExit(f"host library {which!r} did not load")
    return native


def check_ops(which: str) -> None:
    import numpy as np
    import torch
    native = _use_library(which)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 1 << 62, 1 << 22))
    a = torch.randn(1024, 1024)
    keys = rng.integers(0, 1 << 32, 1 << 20, dtype=np.uint64) \
        .astype(np.uint32)
    vals = np.arange(keys.size, dtype=np.int32)
    t_sort = float("nan")
    if which != "none":
        big = rng.integers(0, 1 << 32, 1 << 24, dtype=np.uint64) \
            .astype(np.uint32)
        t = time.time()
        native.kv_radix_sort(big, np.arange(big.size, dtype=np.int32))
        t_sort = time.time() - t

    def torch_ops() -> float:
        t = time.time()
        torch.sort(x)
        torch.unique(x)
        a @ a
        return time.time() - t

    torch_ops()
    alone = min(torch_ops() for _ in range(5))
    after = []
    for _ in range(8):
        if which != "none":
            native.kv_radix_sort(keys, vals)
        after.append(torch_ops())
    print(f"{which}: library {native.build_kind()}, torch threads "
          f"{torch.get_num_threads()}, native radix sort of 16M pairs "
          f"{t_sort:.3f} s; torch sort + unique of 4M and matmul 1024^3: "
          f"alone {alone:.4f} s, right after a native call min "
          f"{min(after):.4f} median {sorted(after)[4]:.4f} max "
          f"{max(after):.4f} s", flush=True)


def check_set(which: str) -> None:
    native = _use_library(which)
    from metakssd_tpu_torch.probes import smoke_data
    work = os.path.abspath(f".smoke_work_{os.getpid()}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        print(f"{which}: library {native.build_kind()}", flush=True)
        co, taxf, _ = smoke_data.make_set_data(work, 0)
        smoke_data.set_leg(work, "cpu", co, taxf)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2 or argv[0] not in ("ops", "set"):
        print(__doc__, file=sys.stderr)
        return 2
    (check_ops if argv[0] == "ops" else check_set)(argv[1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
