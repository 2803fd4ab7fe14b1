"""One run of one cell of the benchmark of ``metakssd_tpu_torch``.

    python3 kssd_bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``workloads`` in ``BENCHMARK.json``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``,
whose ``runner`` names ``runners/<runner>.py``); its correctness limits
are ``limits/<workload>.json`` and each metric is read by
``metrics/<metric>.py`` (``read(run)``: a number, or None where it finds
nothing to read).  All are found by name, so a cell, a mix or a metric is
added as files.

Set-up (``setup_s``: process start to the window's start) makes the data
from the seed and warms up every shape of the cell.  The window is a
closed loop of one caller, timed from the start of the first call to the
end of the last, which ends once ``--seconds`` have passed.  Then the
device's peak memory is read, the program's state freed and what the
window produced compared with the plain reference; ``--trace 1`` runs the
window under ``torch.profiler`` and reports the per-layer metrics.

The last line of standard output is one JSON object; each number
compared is printed beside its limit as the last lines of standard error
and, last, under ``checks`` in that object.  Without the card that the
cell asks for, or with JAX or the JAX package loaded once the window has
closed, the run exits nonzero and prints no result.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from kssd_bench import tracing  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "metakssd_tpu"})
CACHE_DIR = ".kssd_bench_cache"


@dataclasses.dataclass
class Call:
    t0: float
    t1: float
    queries: int
    spans: dict


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    setup_s: float
    calls: list
    session: object
    trace: object = None      # tracing.Trace of the window, --trace 1


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` and the files it names."""
    manifest: dict
    entry: dict
    cfg: dict
    traffic: dict
    limits: dict
    runner: object


def load_cell(root: Path, workload: str) -> Cell | None:
    """The cell ``workload`` of the checkout at ``root``, or None."""
    bench = root / "kssd_bench"
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in manifest["workloads"]
                  if w["name"] == workload), None)
    if entry is None:
        return None

    def data(*parts):
        return json.loads(bench.joinpath(*parts).read_text())
    traffic = data("traffic", f"{entry['traffic']}.json")
    runner = load_file(bench / "runners" / f"{traffic['runner']}.py",
                       f"kssd_bench_runner_{traffic['runner']}")
    return Cell(manifest, entry, data("configs", f"{entry['config']}.json"),
                traffic, data("limits", f"{workload}.json"), runner)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & FORBIDDEN)


def metrics_of(manifest: dict, kind: str, workload: str) -> list[dict]:
    return [m for m in manifest[kind]
            if workload in m.get("workloads", [workload])]


def _num(v: float):
    return v if math.isfinite(v) else str(v)


def _window(session, seconds: float, trace: bool, cuda: bool):
    """The closed loop of one caller for ``seconds``: its calls, and with
    ``trace`` the ``tracing.Trace`` of the profiler run around it (else
    None)."""
    import torch
    prof = contextlib.nullcontext()
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    calls = []
    with prof, torch.profiler.record_function("kssd_bench.window"):
        while not calls or calls[-1].t1 - calls[0].t0 < seconds:
            t0 = time.perf_counter()
            with torch.profiler.record_function("kssd_bench.call"):
                n, spans = session.call(len(calls))
            calls.append(Call(t0, time.perf_counter(), n, spans))
        if cuda:
            torch.cuda.synchronize()
    if not trace:
        return calls, None
    t = time.perf_counter()
    got = tracing.from_profiler(prof)
    print(f"kssd_bench: trace read in {time.perf_counter() - t:.1f} s, "
          f"{len(got.device)} device events", file=sys.stderr)
    return calls, got


def main(argv=None, *, root: Path | None = None, device: str | None = None
         ) -> int:
    """One run; ``root`` (the checkout) and ``device`` (instead of the
    cell's cards, with no look for them) are for the tests."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(root or ROOT)
    cell = load_cell(root, args.workload)
    if cell is None:
        print(f"kssd_bench: no workload {args.workload!r}", file=sys.stderr)
        return 2

    import torch
    chips = int(cell.entry["chips"])
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            found = (torch.cuda.device_count()
                     if torch.cuda.is_available() else 0)
            print(f"kssd_bench: {args.workload} needs {chips} CUDA "
                  f"device(s); found {found}", file=sys.stderr)
            return 1
        device = "cuda"
    cuda = device.startswith("cuda")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / CACHE_DIR / sub)
    names = metrics_of(cell.manifest,
                       "per_layer" if args.trace else "end_to_end",
                       args.workload)
    readers = {m["name"]: load_file(
        root / "kssd_bench" / "metrics" / f"{m['name']}.py",
        f"kssd_bench_metric_{m['name']}") for m in names}

    with tempfile.TemporaryDirectory(prefix="kssd_bench_") as work:
        t_session = time.perf_counter()
        session = cell.runner.Session(cell.cfg, cell.traffic, args.seed,
                                      device, work)
        stages = {"before_session": t_session - _T0,
                  **getattr(session, "stages", {})}
        print("kssd_bench: set-up " + ", ".join(
            f"{k} {v:.3f} s" for k, v in stages.items()), file=sys.stderr)
        try:
            if cuda:
                torch.cuda.synchronize()
            calls, trace = _window(session, args.seconds, bool(args.trace),
                                   cuda)
            setup_s = calls[0].t0 - _T0
            lat = sorted(c.t1 - c.t0 for c in calls)
            spans = {k: sum(c.spans.get(k, 0.0) for c in calls) / len(calls)
                     for k in calls[0].spans}
            print(f"kssd_bench: window {len(calls)} calls in "
                  f"{calls[-1].t1 - calls[0].t0:.3f} s; call s min "
                  f"{lat[0]:.4f} median {lat[len(lat) // 2]:.4f} max "
                  f"{lat[-1]:.4f}; mean span s " + ", ".join(
                      f"{k} {v:.4f}" for k, v in spans.items()),
                  file=sys.stderr)
            peak = torch.cuda.max_memory_allocated() if cuda else 0
            checks, failed = session.judge(cell.limits)
            run = Run(setup_s, calls, session, trace)
            extra = {}
            if trace is not None:
                extra = {"busy_s": tracing.busy_seconds(run.trace),
                         "window_s": tracing.window_seconds(run.trace)}
            metrics = {}
            for m in names:
                v = readers[m["name"]].read(run)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
            breakdown = (tracing.breakdown(run.trace) if run.trace
                         else None)
        finally:
            session.close()

    bad = forbidden_modules()
    if bad:
        print(f"kssd_bench: loaded after the window: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    result = {
        "correct": bool(checks) and all(c.ok for c in checks),
        "attempted": sum(c.queries for c in calls),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": chips if cuda else 1,
            "memory_peak_bytes": int(peak), **extra},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c.name: {"value": _num(float(c.value)),
                                 "limit": c.limit} for c in checks}
    sys.stdout.flush()
    unseen = [k for k, v in cell.limits.items()
              if isinstance(v, (int, float)) and k not in result["checks"]]
    if unseen:
        print("kssd_bench: not observed in this run (their layer not found "
              f"in the program): {', '.join(unseen)}", file=sys.stderr)
    for c in checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
