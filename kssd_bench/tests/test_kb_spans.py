"""The per-layer metrics that read the program's own ``abv.*`` spans
(``ops/dense_abv``): the host ones read numbers in a traced run at tiny
size on the CPU, the device ones read None there (no kernels); on a
synthetic trace each reads the expected per-call value, counting a kernel
by where its launch lies, nested spans included; and a program without
the spans leaves each silent."""

import types

import pytest

from kb_tiny import REPO, run_cell, tiny_root
from kssd_bench import run, tracing

HOST = ("abv_names_ms", "abv_rank_ms", "abv_format_ms")
DEVICE = ("abv_mask_ms", "abv_measure_ms")


def _reader(name):
    return run.load_file(REPO / "kssd_bench" / "metrics" / f"{name}.py",
                         f"kb_spans_{name}")


@pytest.mark.parametrize("workload", ["abv.l2.single", "abv.l1.single"])
def test_traced_cell_reads_the_host_spans(tmp_path, capsys, workload):
    rc, res, err = run_cell(tiny_root(tmp_path), workload, capsys, trace=1)
    assert rc == 0 and res["correct"] is True, err
    got = res["metrics"]
    for name in HOST:
        assert got[name]["unit"] == "ms" and got[name]["value"] > 0, name
    for name in DEVICE:
        assert name not in got, name      # no kernels on the CPU
    # the host spans lie inside a call and outside abv_search_batch
    host = sum(got[n]["value"] for n in HOST)
    assert host <= got["abv_output_ms"]["value"] * 1.02


def _kernel(ts, dur, corr, cat="kernel"):
    return (ts, ts + dur, f"k{corr}", cat, corr)


def _synthetic():
    """Two calls; in each the mask span sits in the batch and, the second
    one, in the measure span (as L2's): kernels launched inside them (us)
    and some outside any of them."""
    spans = {tracing.WINDOW: [(0.0, 2000.0)],
             "kssd_bench.call": [(0.0, 1000.0), (1000.0, 2000.0)],
             "abv.batch": [], "abv.mask": [], "abv.measure": [],
             "abv.names": [], "abv.rank": [], "abv.format": []}
    device, launches, corr = [], {}, 0
    for c0 in (0.0, 1000.0):
        spans["abv.batch"].append((c0 + 10, c0 + 500))
        spans["abv.mask"].append((c0 + 20, c0 + 30))
        spans["abv.measure"].append((c0 + 40, c0 + 90))
        spans["abv.mask"].append((c0 + 50, c0 + 60))
        spans["abv.names"].append((c0 + 600, c0 + 650))
        spans["abv.rank"].append((c0 + 650, c0 + 680))
        spans["abv.format"].append((c0 + 680, c0 + 900))
        for launch, dur, cat in ((c0 + 25, 100.0, "kernel"),   # mask 1
                                 (c0 + 26, 7.0, "gpu_memcpy"),
                                 (c0 + 45, 200.0, "kernel"),   # measure
                                 (c0 + 55, 300.0, "kernel"),   # mask 2
                                 (c0 + 95, 400.0, "kernel"),   # batch
                                 (c0 + 700, 5.0, "kernel")):   # format
            corr += 1
            launches[corr] = launch
            device.append(_kernel(launch + 1, dur, corr, cat))
    for v in spans.values():
        v.sort()
    return tracing.Trace(sorted(device), launches, spans, [])


# per call: mask 100 + 300 us; measure 200 + 300 (its own mask); names
# 50, rank 30, format 220 us
WANT = {"abv_mask_ms": 0.4, "abv_measure_ms": 0.5, "abv_names_ms": 0.05,
        "abv_rank_ms": 0.03, "abv_format_ms": 0.22}


@pytest.mark.parametrize("name", sorted(WANT))
def test_synthetic_trace_reads_per_call(name):
    r = types.SimpleNamespace(trace=_synthetic(), calls=[None, None])
    assert _reader(name).read(r) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_silent_without_the_span_or_the_trace(name):
    """A program without the ``abv.*`` spans leaves the metric None, and
    so does an untraced run."""
    tr = _synthetic()
    bare = tracing.Trace(tr.device, tr.launches,
                         {k: v for k, v in tr.spans.items()
                          if not k.startswith("abv.")}, [])
    reader = _reader(name)
    for trace in (bare, None):
        r = types.SimpleNamespace(trace=trace, calls=[None, None])
        assert reader.read(r) is None
