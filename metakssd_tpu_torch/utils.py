"""Observability: stage timers and structured logging (the port's copy
of ``metakssd_tpu/utils.py``, without its backend policy: the port names
its device explicitly, ``device.py``).  In place of the JAX package's
``jax.profiler`` hook, a stage is also a ``torch.profiler.record_function``
span whenever a ``torch.profiler`` session is active, so that it lies on
the profiler's clock beside the device's kernels and copies.

The reference had only printf progress lines and unused ms/µs helpers
(mytime.c); here the pipeline stages (stage I sketch, stage II invert,
dist search, composite profile, set algebra) record wall time and
counters through the global TIMER, dumped as one JSON line per CLI run
(MKSSD_LOG=json) or pretty text (MKSSD_LOG=1).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time


class StageTimer:
    """Wall-time per named stage + named counters.

    Env is consulted lazily (properties) so tests and long-lived
    processes can flip MKSSD_LOG without rebuilding the singleton.
    """

    def __init__(self, enabled: bool | None = None):
        self._forced = enabled
        self.stages: list[tuple[str, float]] = []
        self.counters: dict[str, float] = {}
        self.meta: dict[str, str] = {}

    @property
    def enabled(self) -> bool:
        if self._forced is not None:
            return self._forced
        return bool(os.environ.get("MKSSD_LOG", ""))

    @property
    def json_mode(self) -> bool:
        return os.environ.get("MKSSD_LOG", "") == "json"

    def reset(self) -> None:
        self.stages.clear()
        self.counters.clear()
        self.meta.clear()

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time the block (``time.perf_counter``) as stage ``name``; under
        an active ``torch.profiler`` also mark it on the profiler's
        timeline.  Never synchronises the device: a stage's device time
        is that of the kernels launched inside its span."""
        span = None
        if _profiling():
            span = sys.modules["torch"].profiler.record_function(name)
            span.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if span is not None:
                span.__exit__(None, None, None)
            self.stages.append((name, dt))
            if self.enabled and not self.json_mode:
                print(f"[mkssd] {name}: {dt:.3f}s", file=sys.stderr)

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def report(self) -> dict:
        stages: dict[str, float] = {}
        for n, t in self.stages:        # repeated stages sum their time
            stages[n] = round(stages.get(n, 0.0) + t, 4)
        rep = {"stages": stages, "counters": self.counters}
        if self.meta:
            rep["meta"] = dict(self.meta)
        if self.enabled and self.json_mode:
            print(json.dumps(rep), file=sys.stderr)
        return rep


def _profiling() -> bool:
    """Whether a ``torch.profiler`` session is active: a cheap check,
    where entering ``record_function`` costs some fifty times more even
    with no profiler.  Without torch loaded no session can be."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


TIMER = StageTimer()


def sorted_unique_first(sk):
    """(first-occurrence mask, first indices) of an ASCENDING-sorted
    array — the linear counterpart of np.unique's sort+diff, shared by
    the inverted-index builders and pan unions (np.unique would re-sort
    the already-sorted input)."""
    import numpy as np
    n = sk.size
    if n == 0:
        return (np.zeros(0, dtype=bool), np.zeros(0, np.int64))
    first = np.empty(n, dtype=bool)
    first[0] = True
    np.not_equal(sk[1:], sk[:-1], out=first[1:])
    return first, np.flatnonzero(first)


def sorted_first_idx(sk):
    """int64 first-occurrence indices of an ascending-sorted uint32
    array — the parallel native pass when available (one boundary
    count + one fill sweep; numpy's mask+flatnonzero route walks the
    array serially and allocates an n-byte mask), else numpy."""
    import numpy as np
    sk = np.ascontiguousarray(sk)
    if sk.dtype == np.uint32 and sk.size >= (1 << 18):
        from metakssd_tpu_torch.io import native as native_io
        if native_io.available():
            got = native_io.sorted_first_indices(sk)
            if got is not None:
                return got
    return sorted_unique_first(sk)[1]
