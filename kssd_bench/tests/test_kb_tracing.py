"""The trace read from the profiler in memory equals the one read from
its exported chrome trace (CPU events here; the card's kernels and
launches are held alike on the chip)."""

import pytest
import torch

from kssd_bench import tracing


def _profiled():
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof, torch.profiler.record_function(tracing.WINDOW):
        for _ in range(3):
            with torch.profiler.record_function("kssd_bench.call"):
                x = torch.arange(1000.0)
                (x - 1).abs().sum()
    return prof


def test_in_memory_trace_equals_the_exported_one(tmp_path):
    prof = _profiled()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    a, b = tracing.from_profiler(prof), tracing.read(path)
    assert set(a.spans) == set(b.spans)
    assert len(a.spans["kssd_bench.call"]) == 3
    for k in a.spans:
        assert len(a.spans[k]) == len(b.spans[k])
        for (s0, e0), (s1, e1) in zip(a.spans[k], b.spans[k]):
            assert (e0 - s0) == pytest.approx(e1 - s1, abs=0.5)
    assert [n for *_, n in a.host] == [n for *_, n in b.host]
    assert tracing.window_seconds(a) == pytest.approx(
        tracing.window_seconds(b), abs=1e-6)
    assert len(a.device) == len(b.device)
