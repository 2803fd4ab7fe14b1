"""The port's tracing (``utils.StageTimer``) and the spans of the dense abv
search (``ops/dense_abv.py``), on the CPU.

Under an active ``torch.profiler`` every ``TIMER`` stage is also a
``record_function`` span on the profiler's clock; a call of
``abv_search_dense`` is one ``abv.search`` span holding the spans of its
parts, each inside the part that calls it.  With no profiler active a
stage never enters ``record_function`` and still records its time, on a
monotonic clock.  ``MKSSD_LOG=json`` reports the ``abv.*`` stages and the
``abv.queries`` and ``abv.lines`` counters.
"""

import io
import json
import os
import time

import pytest
import torch

from metakssd_tpu.formats.abv import AbvIndex
from test_torch_dense_abv import _write_db

from metakssd_tpu_torch import cli, utils
from metakssd_tpu_torch.ops import dense_abv
from metakssd_tpu_torch.utils import TIMER

# each span's parent
PARENT = {"abv.db": "abv.search", "abv.stage": "abv.db",
          "abv.queries": "abv.search", "abv.batch": "abv.search",
          "abv.measure": "abv.batch", "abv.readback": "abv.batch",
          "abv.rank": "abv.search", "abv.format": "abv.search"}
ONCE = ("abv.db", "abv.queries", "abv.batch", "abv.measure",
        "abv.readback")


@pytest.fixture(scope="module")
def abv_db(tmp_path_factory):
    """120 vectors of 5-60 dims over 300 species (``test_torch_dense_abv``'s
    skewed database)."""
    return _write_db(tmp_path_factory.mktemp("torch_tracing_abv"), 300, 120,
                     5, True, dims=(5, 60))


def _queries(refdir: str) -> list[str]:
    names = AbvIndex.read(refdir).names
    return names[::40] + [os.path.join(refdir, "abundance_Vec", names[7])]


def _spans(prof) -> list[tuple[int, int, str]]:
    """The ``abv.*`` spans of a stopped profiler: (start, end, name), ns."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("abv."):
            out.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name()))
    return sorted(out, key=lambda s: (s[0], -s[1]))


def _parents(spans) -> list[tuple[str, str | None]]:
    """(span, its innermost enclosing span or None), in start order."""
    got, stack = [], []
    for a, b, name in spans:
        while stack and stack[-1][1] <= a:
            stack.pop()
        got.append((name, stack[-1][2] if stack else None))
        stack.append((a, b, name))
    return got


def _profiled_call(refdir: str, queries: list[str], mode: int):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    sink = io.StringIO()
    with prof:
        dense_abv.abv_search_dense(refdir, queries, mode, out=sink,
                                   device="cpu")
    return _spans(prof), sink


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_spans_of_a_call_nest_in_one_search(abv_db, mode):
    """Per call: one ``abv.search``, every other span inside its caller's;
    one ``abv.measure`` (the gather) and no ``abv.mask`` (the search builds
    no mask of the DB); ``abv.rank`` and ``abv.format`` once a query;
    ``abv.stage`` (the DB and its names) on the call that misses the cache
    only, and no ``abv.names``: nothing of the names is made a call."""
    queries = _queries(abv_db)
    dense_abv._DENSE_CACHE.clear()
    for miss in (True, False):
        spans, sink = _profiled_call(abv_db, queries, mode)
        parents = _parents(spans)
        names = [n for n, _ in parents]
        assert names.count("abv.search") == 1
        assert parents[0] == ("abv.search", None)
        for name, parent in parents[1:]:
            assert parent == PARENT[name], (name, parent)
        assert "abv.mask" not in names and "abv.names" not in names
        for name in ONCE:
            assert names.count(name) == 1, name
        assert names.count("abv.rank") == names.count("abv.format") \
            == len(queries) == sink.getvalue().count("#Sample\t")
        assert names.count("abv.stage") == (1 if miss else 0)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_no_profiler_no_record_function(abv_db, mode, monkeypatch):
    """With no profiler active ``record_function`` is never entered, and
    ``TIMER`` still records every stage of the call."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not utils._profiling()
    queries = _queries(abv_db)
    TIMER.reset()
    try:
        dense_abv.abv_search_dense(abv_db, queries, mode, out=io.StringIO(),
                                   device="cpu")
        names = [n for n, _ in TIMER.stages]
    finally:
        TIMER.reset()
    assert names.count("abv.search") == 1
    assert set(PARENT) - {"abv.stage"} <= set(names)
    assert names.count("abv.measure") == 1 and "abv.mask" not in names
    assert names.count("abv.format") == len(queries)


@pytest.mark.parametrize("enabled", [False, True])
def test_stage_duration_is_monotonic(monkeypatch, enabled):
    """A stage's time never goes negative when the wall clock steps back
    (``time.time`` jumping an hour back inside the block)."""
    timer = utils.StageTimer(enabled=enabled)
    wall = iter([1e9, 1e9 - 3600.0, 1e9 - 7200.0])
    monkeypatch.setattr(time, "time", lambda: next(wall, 0.0))
    with timer.stage("back"):
        time.time()
        time.time()
    (name, dt), = timer.stages
    assert name == "back" and dt >= 0.0


def test_stage_under_profiler_is_a_span():
    """Under an active profiler a stage is a ``record_function`` span on
    the profiler's clock, holding the ops launched in it."""
    timer = utils.StageTimer(enabled=False)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        with timer.stage("abv.outer"):
            with timer.stage("abv.inner"):
                torch.arange(100.0).abs().sum()
    assert [n for n, _ in _parents(_spans(prof))] == \
        ["abv.outer", "abv.inner"]
    assert [n for n, _ in timer.stages] == ["abv.inner", "abv.outer"]
    ops = [e for e in prof.events() if e.name == "aten::abs"]
    inner = [e for e in prof.events() if e.name == "abv.inner"]
    assert ops and len(inner) == 1
    assert inner[0].time_range.start <= ops[0].time_range.start
    assert ops[0].time_range.end <= inner[0].time_range.end


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_cli_json_report_has_abv_stages_and_counters(abv_db, mode, capsys,
                                                     monkeypatch):
    """``MKSSD_LOG=json composite -s <mode> --dense`` reports the ``abv.*``
    stages, ``abv.queries`` (the .abv queries searched; a non-.abv
    argument is skipped, its notice printed before any query's block, as
    the JAX package's dense route prints it) and ``abv.lines`` (the
    text's data lines); off a card no line counts as formatted there or
    sent from there to the host writer."""
    monkeypatch.setenv("MKSSD_LOG", "json")
    queries = _queries(abv_db)
    argv = ["composite", "-r", abv_db, "-s", str(mode), "--dense",
            *queries, "not_an_abv.txt", "--device", "cpu"]
    capsys.readouterr()
    assert cli.main(argv) == 0
    out, err = capsys.readouterr()
    rep = json.loads([ln for ln in err.splitlines()
                      if ln.startswith("{")][-1])
    assert set(PARENT) - {"abv.stage"} <= set(rep["stages"])
    assert "abv.search" in rep["stages"]
    assert rep["counters"]["abv.queries"] == len(queries)
    data = [ln for ln in out.splitlines()
            if ln and not ln.startswith("#") and "\t" in ln]
    assert rep["counters"]["abv.lines"] == len(data) > len(queries)
    assert not {"abv.format.card", "abv.format.host"} & set(rep["counters"])
    assert out.index("argument not_an_abv.txt is not a .abv file") < \
        out.index("#Sample") and out.count("not a .abv file") == 1
    assert rep["meta"]["command"] == "composite"
