"""``composite -s <mode>`` over the abv index's postings
(``ops/abv_postings.py``) on the CPU: its plain twin against the host
route (``composite.abv_search``, ``--device host``), the JAX package's
``composite.abv_search`` and the plain reference (``ref_abv_search``).

The text must be byte-identical to the host route's and the JAX
package's in all three modes; the twin's float32 measure and first
touches bit-identical to the reference's walk, posting by posting.  The
crafted indexes pin the ranking's corners: exact ties (broken by first
touch, reversed for cosine), a query whose species are not in sorted
order, one species, a species no sample holds, an empty query, a sample
equal to the query (L2 0) and a query whose samples span more than one
of the kernel's 1024-sample tiles.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from metakssd_tpu import cli as jax_cli
from metakssd_tpu import composite as jax_composite
from metakssd_tpu.formats.costat import CoStat

import ref_abv_search
import text_cases
from metakssd_tpu_torch import cli, composite
from metakssd_tpu_torch.formats.abv import (AbvIndex, read_abv_file,
                                            write_abv_file)
from metakssd_tpu_torch.io import native as native_io
from metakssd_tpu_torch.ops import _build, abv_postings, abv_text, dense_abv
from metakssd_tpu_torch.utils import TIMER


def _index(refdir, vectors: list, nspecies: int) -> str:
    """``vectors`` ((species, pct) each) as ``abundance_Vec/s<i>.abv``, a
    cofiles.stat of ``nspecies`` species and the port's ``composite -i``
    index over them."""
    vdir = refdir / "abundance_Vec"
    vdir.mkdir()
    for i, (sp, pct) in enumerate(vectors):
        write_abv_file(str(vdir / f"s{i:05d}.abv"),
                       np.asarray(sp, np.int32), np.asarray(pct, np.float32))
    CoStat(1, False, 16, 4, 1, 0, np.zeros(nspecies, np.uint32),
           [f"sp{i}" for i in range(nspecies)]).write(str(refdir))
    composite.index_abv(str(refdir))
    return str(refdir)


def _random_vectors(rng, n: int, nspecies: int, dims=(3, 40)) -> list:
    prev = 1.0 / np.arange(1, nspecies + 1)
    prev /= prev.sum()
    out = []
    for _ in range(n):
        nd = int(rng.integers(*dims))
        sp = rng.choice(nspecies, nd, replace=False, p=prev)
        pct = rng.lognormal(0.0, 1.5, nd)
        out.append((sp, (pct / pct.sum() * 100).astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def seeded_db(tmp_path_factory):
    """2,500 samples of 3-40 species over 400, prevalence 1/rank, species
    in each file in random order."""
    rng = np.random.default_rng(21)
    return _index(tmp_path_factory.mktemp("post_seeded"),
                  _random_vectors(rng, 2500, 400), 400)


def _queries(refdir: str) -> list[str]:
    names = AbvIndex.read(refdir).names
    return names[::311] + [os.path.join(refdir, "abundance_Vec", names[5])]


def _cli(argv, device, capsys) -> str:
    capsys.readouterr()
    assert cli.main([*argv, "--device", device]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_text_matches_host_and_jax(seeded_db, mode, capsys):
    """-s <mode> on --device cpu prints what --device host and the JAX
    CLI print, byte for byte, a non-.abv argument's line in its place."""
    qs = _queries(seeded_db)
    argv = ["composite", "-r", seeded_db, "-s", str(mode), *qs[:3],
            "not_an_abv.txt", *qs[3:]]
    capsys.readouterr()
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert _cli(argv, "host", capsys) == want
    got = _cli(argv, "cpu", capsys)
    assert got == want
    assert got.count("#Sample") == len(qs) and got.count("\n") > 10 * len(qs)
    assert got.index("not_an_abv.txt") > got.index("#Sample")


def _reference(refdir: str, qpath: str, mode: int):
    idx = AbvIndex.read(refdir)
    qsp, qpct = read_abv_file(qpath)
    return ref_abv_search.search(idx.abmi, idx.abm_idx, idx.abm_pct,
                                 idx.names, idx.y_l2n, qsp, qpct, mode)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_twin_matches_reference_bits(seeded_db, mode):
    """``postings_search_batch`` on the CPU: every query of a batch equals
    the plain reference's walk in measure bits and first touch, and its
    text the reference's."""
    qs = _queries(seeded_db)[:3]
    staged = abv_postings.stage_postings(AbvIndex.read(seeded_db), "cpu")
    measure, touch = abv_postings.postings_search_batch(
        staged, [read_abv_file(q if "/" in q else os.path.join(
            seeded_db, "abundance_Vec", q)) for q in qs], mode)
    out = io.StringIO()
    abv_postings.abv_search_postings(seeded_db, qs, mode, out=out,
                                     device="cpu")
    texts = []
    for b, q in enumerate(qs):
        path = q if "/" in q else os.path.join(seeded_db, "abundance_Vec", q)
        m, t, txt = _reference(seeded_db, path, mode)
        np.testing.assert_array_equal(touch[b], t.numpy())
        np.testing.assert_array_equal(measure[b].view(np.int32),
                                      m.numpy().view(np.int32))
        assert (touch[b] >= 0).sum() > 100
        texts.append(txt)
    assert out.getvalue() == "".join(texts)


def _crafted(case: str) -> tuple[list, int, list]:
    """(vectors, species, queries as (species, pct)) of one crafted case."""
    rng = np.random.default_rng(len(case))
    if case == "ties":
        # equal vectors (ties in every mode), scaled copies (cosine
        # ties) and vectors sharing one species at one value
        base = ([1, 4, 6], [20.0, 30.0, 50.0])
        vecs = [base, ([4, 1, 6], [30.0, 20.0, 50.0]), ([9, 2], [60.0, 40.0]),
                base, ([6, 8], [50.0, 50.0]), ([6, 7], [50.0, 50.0]),
                ([1, 4, 6], [10.0, 15.0, 25.0]), ([2, 6], [50.0, 50.0]),
                base, ([3], [100.0])]
        return vecs, 10, [([6, 1, 4], [50.0, 20.0, 30.0]),
                          ([6], [100.0]), ([2, 9, 6], [40.0, 60.0, 50.0])]
    if case == "unsorted":
        vecs = _random_vectors(rng, 300, 50, dims=(2, 12))
        sp = np.array([37, 2, 19, 0, 44, 11], np.int32)
        return vecs, 50, [(sp, rng.random(sp.size) * 20 + 1)]
    if case == "one_species":
        vecs = _random_vectors(rng, 200, 20, dims=(1, 6))
        return vecs, 20, [([0], [100.0]), ([int(vecs[3][0][0])], [7.5])]
    if case == "absent_species":
        vecs = _random_vectors(rng, 200, 30, dims=(1, 6))
        held = {int(s) for v in vecs for s in v[0]}
        absent = [s for s in range(40) if s not in held][:2]
        return vecs, 40, [(absent, [40.0, 60.0]),
                          ([absent[0], 0, absent[1], 1], [10, 50, 15, 25])]
    if case == "empty":
        vecs = _random_vectors(rng, 120, 20, dims=(1, 6))
        return vecs, 20, [([], []), ([1, 2], [60.0, 40.0])]
    if case == "self":
        vecs = _random_vectors(rng, 250, 40, dims=(2, 15))
        return vecs, 40, [vecs[17], vecs[200]]
    assert case == "tiles"
    # 3,000 samples: every tile of 1,024 holds samples of the query's
    # species, some several
    vecs = _random_vectors(rng, 3000, 60, dims=(1, 8))
    sp = np.array([0, 5, 1, 33, 2, 59], np.int32)
    return vecs, 60, [(sp, rng.random(sp.size) * 20 + 1)]


CASES = ["ties", "unsorted", "one_species", "absent_species", "empty",
         "self", "tiles"]


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("case", CASES)
def test_crafted_cases(tmp_path, case, mode, capsys):
    """Each crafted case: the text of --device cpu, --device host and the
    JAX package byte-identical; measure bits and first touches the
    reference's."""
    vecs, nspecies, queries = _crafted(case)
    refdir = _index(tmp_path, vecs, nspecies)
    qpaths = []
    for i, (sp, pct) in enumerate(queries):
        qpaths.append(str(tmp_path / f"q{i}.abv"))
        write_abv_file(qpaths[-1], np.asarray(sp, np.int32),
                       np.asarray(pct, np.float32))
    argv = ["composite", "-r", refdir, "-s", str(mode), *qpaths]
    want = io.StringIO()
    jax_composite.abv_search(refdir, qpaths, mode, out=want)
    host = _cli(argv, "host", capsys)
    got = _cli(argv, "cpu", capsys)
    assert got == host == want.getvalue()
    idx = AbvIndex.read(refdir)
    staged = abv_postings.stage_postings(idx, "cpu")
    measure, touch = abv_postings.postings_search_batch(
        staged, [read_abv_file(q) for q in qpaths], mode)
    for b, q in enumerate(qpaths):
        m, t, _ = _reference(refdir, q, mode)
        np.testing.assert_array_equal(touch[b], t.numpy())
        np.testing.assert_array_equal(measure[b].view(np.int32),
                                      m.numpy().view(np.int32))
    blocks = got.split("#Sample\t")[1:]
    assert len(blocks) == len(qpaths)
    vals = [[ln.split("\t") for ln in blk.splitlines()[1:]]
            for blk in blocks]
    if case == "ties":
        # samples 0, 3 and 8 are one vector: tied, in first-touch order
        # (sample order), reversed for cosine
        first = [n for n, v in vals[0] if n in ("s00000.abv", "s00003.abv",
                                                "s00008.abv")]
        want_ties = ["s00000.abv", "s00003.abv", "s00008.abv"]
        assert first == (want_ties[::-1] if mode == 0 else want_ties)
        tied = [v for n, v in vals[0] if n in want_ties]
        assert len(set(tied)) == 1
    if case == "empty":
        assert vals[0] == [] and len(vals[1]) > 0
    if case == "absent_species":
        assert vals[0] == []
    if case == "self" and mode == 2:
        assert ["s00017.abv", "0.000000"] in vals[0]
        assert vals[0][0][1] == "0.000000"
    if case == "tiles":
        ids = np.flatnonzero(touch[0] >= 0)
        assert len({int(i) // 1024 for i in ids}) == 3


@pytest.mark.parametrize("tiebreak", ["touch", "sample_id"])
def test_order_key_is_a_stable_sort(tiebreak):
    """``abv_text.rank_order`` (the postings route's ``_order_key``) is a
    stable ascending sort of the float32 measure over samples in
    tie-break order: the postings route's first touches, or the dense
    route's ascending sample ids, where it is ``np.argsort(kind="stable")``
    itself; -0.0 ties with 0.0, NaN sorts last, negative values below
    positive."""
    assert abv_postings._order_key is abv_text.rank_order
    rng = np.random.default_rng(4)
    m = rng.choice(np.array([-3.5, -0.0, 0.0, 1.25, 1.25, np.nan, 7.0,
                             -np.inf, np.inf, 2e-45], np.float32), 500)
    t = rng.permutation(10_000)[:500].astype(np.int64)
    if tiebreak == "sample_id":
        t.sort()
    by_t = np.argsort(t)
    want = by_t[np.argsort(m[by_t], kind="stable")]
    got = abv_text.rank_order(m, t)
    np.testing.assert_array_equal(got, want)
    if tiebreak == "sample_id":
        np.testing.assert_array_equal(got, np.argsort(m, kind="stable"))


def test_staging_refuses_unordered_postings(seeded_db):
    """An index whose postings are not in sample order within a species
    (not as ``composite -i`` writes it) is refused when staged."""
    idx = AbvIndex.read(seeded_db)
    lo, hi = 0, int(idx.abmi[0])
    assert hi - lo > 2
    idx.abm_idx[[lo, lo + 1]] = idx.abm_idx[[lo + 1, lo]]
    with pytest.raises(ValueError, match="sample order"):
        abv_postings.stage_postings(idx, "cpu")
    idx.abm_idx[[lo, lo + 1]] = idx.abm_idx[[lo + 1, lo]]
    idx.abm_idx[lo] = len(idx.names)
    with pytest.raises(ValueError):
        abv_postings.stage_postings(idx, "cpu")


def test_query_of_unknown_species_raises(seeded_db, tmp_path):
    q = str(tmp_path / "bad.abv")
    write_abv_file(q, np.array([1, 400], np.int32),
                   np.array([50.0, 50.0], np.float32))
    with pytest.raises(ValueError, match="outside the index"):
        abv_postings.abv_search_postings(seeded_db, [q], 2, out=io.StringIO(),
                                         device="cpu")


# each span's parent
PARENT = {"abv.post.db": "abv.post.search",
          "abv.post.stage": "abv.post.db",
          "abv.post.queries": "abv.post.search",
          "abv.post.batch": "abv.post.search",
          "abv.post.walk": "abv.post.batch",
          "abv.post.readback": "abv.post.batch",
          "abv.post.rank": "abv.post.search",
          "abv.post.format": "abv.post.search"}


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_spans_and_counters(seeded_db, mode, capsys, monkeypatch):
    """Under ``torch.profiler`` a call is one ``abv.post.search`` span with
    the spans of its parts inside their parents (``abv.post.stage`` on the
    cache miss only); ``MKSSD_LOG=json`` reports the stages and the
    counters ``abv.post.postings`` (the query species' posting counts)
    and ``abv.post.lines`` (the text's data lines)."""
    abv_postings._POSTINGS_CACHE.clear()
    qs = _queries(seeded_db)[:3]
    for call in range(2):
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
        with prof:
            abv_postings.abv_search_postings(seeded_db, qs, mode,
                                             out=io.StringIO(), device="cpu")
        spans = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(),
                         e.name())
                        for e in prof.profiler.kineto_results.events()
                        if e.name().startswith("abv.post.")),
                       key=lambda s: (s[0], -s[1]))
        stack, seen = [], []
        for a, b, name in spans:
            while stack and stack[-1][1] <= a:
                stack.pop()
            assert (stack[-1][2] if stack else None) == PARENT.get(name), name
            stack.append((a, b, name))
            seen.append(name)
        assert seen.count("abv.post.search") == 1
        assert seen.count("abv.post.rank") == seen.count(
            "abv.post.format") == len(qs)
        assert ("abv.post.stage" in seen) is (call == 0)
    monkeypatch.setenv("MKSSD_LOG", "json")
    argv = ["composite", "-r", seeded_db, "-s", str(mode), *qs,
            "--device", "cpu"]
    capsys.readouterr()
    launches = dict(_build.LAUNCHES)
    assert cli.main(argv) == 0
    assert _build.LAUNCHES == launches                # no launch on the CPU
    out, err = capsys.readouterr()
    rep = json.loads([ln for ln in err.splitlines()
                      if ln.startswith("{")][-1])
    assert set(PARENT) - {"abv.post.stage"} <= set(rep["stages"])
    idx = AbvIndex.read(seeded_db)
    starts = np.concatenate([[0], idx.abmi]).astype(np.int64)
    walked = 0
    for q in qs:
        sp, _ = read_abv_file(q if "/" in q else os.path.join(
            seeded_db, "abundance_Vec", q))
        walked += int((starts[sp + 1] - starts[sp]).sum())
    assert rep["counters"]["abv.post.postings"] == walked
    data = [ln for ln in out.splitlines() if ln and not ln.startswith("#")]
    assert rep["counters"]["abv.post.lines"] == len(data) > len(qs)
    # the CPU's text is the host writer's, counted neither way
    assert not {"abv.post.format.card", "abv.post.format.host"} & \
        set(rep["counters"])


def test_queries_walked_in_batches(seeded_db, capsys, monkeypatch):
    """Queries past one call's output budget are walked in several calls
    of ``postings_search_batch``; the text is unchanged."""
    qs = _queries(seeded_db)
    argv = ["composite", "-r", seeded_db, "-s", "2", *qs[:2],
            "not_an_abv.txt", *qs[2:]]
    want = _cli(argv, "host", capsys)
    calls = []
    inner = abv_postings.postings_search_batch

    def counted(staged, queries, mode=0):
        calls.append(len(queries))
        return inner(staged, queries, mode=mode)
    monkeypatch.setattr(abv_postings, "postings_search_batch", counted)
    monkeypatch.setattr(abv_postings, "BATCH_BYTES", 12 * 2500 * 3)
    assert _cli(argv, "cpu", capsys) == want
    assert calls == [3] * (len(qs) // 3) + ([len(qs) % 3] if len(qs) % 3
                                             else [])


@pytest.mark.parametrize("seed", [3, 11])
def test_probe_index_is_composite_i_layout(seed):
    """The full-shape probe's index (``probes/bench_abv_postings``), drawn
    small: species-major, sample ids ascending within a species, as
    ``stage_postings`` demands of an index that ``composite -i`` wrote,
    and its queries of distinct species in draw order."""
    from metakssd_tpu_torch.probes import bench_abv_postings as probe
    staged = probe.make_index(seed, torch.device("cpu"), samples=1500,
                              species=300)
    again = abv_postings.stage_postings(staged.index, "cpu")
    assert torch.equal(again.starts, staged.starts)
    assert torch.equal(again.ids, staged.ids)
    assert torch.equal(again.pct, staged.pct)
    assert staged.n_samples == 1500 and staged.starts[-1] == staged.ids.numel()
    qs = probe.make_queries(40, seed, 300)
    assert len(qs) == probe.QUERIES_PER_NNZ
    for sp, pct in qs:
        assert np.unique(sp).size == sp.size == 40
        assert not np.all(np.diff(sp) > 0) and pct.dtype == np.float32


def test_probe_check_counts_what_differs(monkeypatch, capsys):
    """The probe's check passes where the walk is the twin, and counts a
    measure and a touch that differ (so that the card's check would
    fail on them) where one is planted."""
    from metakssd_tpu_torch.probes import bench_abv_postings as probe
    staged = probe.make_index(5, torch.device("cpu"), samples=1200,
                              species=200)
    got = probe.check(staged, 5, sizes=(7,))
    assert got["measures_differ"] == got["touches_differ"] == 0
    assert got["max_abs_err"] == 0.0 and len(got["plain_ms"]) == 3
    inner = abv_postings.postings_walk

    def planted(*args):
        buf, touch, measure = inner(*args)
        hit = int(torch.nonzero(touch[0] >= 0)[0])
        measure[0, hit] = torch.nextafter(measure[0, hit],
                                          torch.tensor(np.inf))
        touch[0, hit + 1] = -1 if touch[0, hit + 1] >= 0 else 0
        return buf, touch, measure
    monkeypatch.setattr(abv_postings, "postings_walk", planted)
    with pytest.raises(AssertionError, match="differ from the plain twin"):
        probe.check(staged, 5, sizes=(7,))
    assert "1 measures (float32 bits) and 1 touches differ" in \
        capsys.readouterr().out


def test_probe_format_case_on_the_cpu():
    """The probe's text case (``probes/bench_abv_postings.format_case``),
    drawn small on the CPU: the twin's text equals the host writer's and
    the record counts its bytes; no kernel is timed or launched."""
    from metakssd_tpu_torch.probes import bench_abv_postings as probe
    rec = probe.format_case(3, "cpu", samples=3000, lines=2000, reps=1)
    assert rec["text_equal"] and rec["lines"] == 2000
    assert rec["ms"] is None and rec["launches"] == 0
    assert rec["bound_bytes"] > 12 * 2000 + rec["text_bytes"] > 2000 * 20


def _route_lines(route: str, refdir: str, mode: int):
    """(the route's staged names, sample ids, float64 values) of one
    query's lines, searched on the CPU by ``route``."""
    cpu = torch.device("cpu")
    if route == "postings":
        staged = abv_postings._postings_db(refdir, cpu)
        q = read_abv_file(os.path.join(refdir, "abundance_Vec",
                                       staged.index.names[7]))
        measure, touch = abv_postings.postings_search_batch(staged, [q],
                                                            mode)
        ids, vals = abv_postings.rank(measure[0], touch[0], mode, q[1],
                                      staged.index.y_l2n)
        return staged.names, ids, vals
    idx, nspecies, dense, names = dense_abv._dense_db(refdir, cpu)
    sp, pct = read_abv_file(os.path.join(refdir, "abundance_Vec",
                                         idx.names[7]))
    q = np.zeros((1, nspecies), np.float32)
    q[0, sp] = pct
    measure, overlap = dense_abv.abv_search_batch(dense, q, mode)
    ids = np.flatnonzero(overlap[0])
    return names, ids, measure[0, ids].astype(np.float64)


@pytest.mark.parametrize("route", ["postings", "dense"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_text_writer_native_equals_numpy(seeded_db, mode, route):
    """The ranked-text writer both card routes share
    (``abv_text.StagedNames.write``, on the CPU the host writer
    ``io/native.write_name_float_lines`` that ``composite.abv_search``
    also calls) gives the same bytes over the route's staged names blob
    as through numpy's ``%f`` without it."""
    names, ids, vals = _route_lines(route, seeded_db, mode)
    if names.blob is None:
        pytest.skip("needs the native host library")
    vals = np.concatenate([vals, [0.0, 1e-7, 5e-7, 123456.7890125,
                                  99.9999995]])
    ids = np.concatenate([ids, ids[:5]])
    got = {}
    for staged in (names, abv_text.StagedNames(names.names, None, None)):
        out = io.StringIO()
        assert staged.write(out, ids, vals) is False
        got[staged.blob is None] = out.getvalue()
    assert got[True] == got[False] and got[True].count("\n") == ids.size


def test_f6_plain_prints_as_printf():
    """The text kernel's arithmetic, in its plain twin: every printed
    value byte for byte as ``"%f"`` (ties at the seventh decimal, -0.0,
    negatives that round to -0.000000, subnormals, 9e12), and every
    value above 9e12 in magnitude or not finite flagged."""
    for v in text_cases.PRINTED:
        assert abv_text.f6_plain(v) == ("%f" % v).encode(), v
    for v in text_cases.FLAGGED:
        assert abv_text.f6_plain(v) is None, v


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_text_twin_equals_host_writer(mode):
    """The text kernel's plain twin (``format_lines`` on CPU tensors, as
    ``CardText.text`` runs it) against the host writer over the names
    blob and without it, and ``"%f"``: 10^5 values of the mode's range
    and the crafted values, names of 0 to 64 characters."""
    rng = np.random.default_rng(mode)
    vals = np.concatenate([text_cases.mode_values(mode, 100_000, rng),
                           text_cases.PRINTED])
    names = text_cases.names_of_lengths(vals.size + 50, rng)
    ids = rng.permutation(len(names))[:vals.size]
    got = abv_text.CardText.stage(names, "cpu").text(ids, vals)
    want = "".join(f"{names[i]}\t{v:f}\n" for i, v in zip(ids, vals))
    assert got == want
    blob, off = native_io.names_blob(names)
    for b, o in ((blob, off), (None, None)):
        out = io.StringIO()
        native_io.write_name_float_lines(out, names, b, o, ids, vals)
        assert out.getvalue() == want


def test_twin_flags_what_it_cannot_print():
    """``format_lines`` on CPU tensors: the flagged values and a sample
    outside the names are counted in ``scratch[1]`` and left out of the
    text; ``CardText.text`` then returns None."""
    names = ["a", "bb", ""]
    card = abv_text.CardText.stage(names, "cpu")
    vals = torch.tensor([1.5, *text_cases.FLAGGED, 2.0], dtype=torch.float64)
    ids = torch.tensor([0] * (vals.numel() - 1) + [3], dtype=torch.int32)
    scratch = torch.zeros(3, dtype=torch.int64)
    out = torch.zeros(64, dtype=torch.uint8)
    abv_text.format_lines(card.blob, card.off, ids, vals, scratch, out)
    assert scratch[:2].tolist() == [len("a\t1.500000\n"),
                                    len(text_cases.FLAGGED) + 1]
    assert bytes(out[:scratch[0]].tolist()) == b"a\t1.500000\n"
    assert card.text(np.array([1, 2]), np.array([3.0, np.inf])) is None
    assert card.text(np.array([1, 2]), np.array([3.0, -0.0])) == \
        "bb\t3.000000\n\t-0.000000\n"
    with pytest.raises(ValueError):
        abv_text.format_lines(card.blob, card.off, ids.long(), vals, scratch,
                              out)


@pytest.mark.parametrize("flag", [None, np.inf, np.nan, 1e15,
                                  text_cases.NEXT_ABOVE])
def test_flagged_line_sends_query_to_host_writer(seeded_db, flag,
                                                 monkeypatch):
    """The postings route with the card's text buffers (here on the CPU,
    so through the twin): a query with no flagged value is formatted
    there (``StagedNames.write`` returns True) and counted in
    ``abv.post.format.card``; one flagged value sends the whole query to
    the host writer (False), counted in ``abv.post.format.host``.  The
    text is the host writer's either way."""
    staged = abv_postings.stage_postings(AbvIndex.read(seeded_db), "cpu")
    assert staged.names.card is None
    staged.names.card = abv_text.CardText.stage(staged.index.names, "cpu")
    qpath = os.path.join(seeded_db, "abundance_Vec", staged.index.names[7])
    q = read_abv_file(qpath)
    rank = abv_postings.rank

    def flagged(*args):
        ids, vals = rank(*args)
        if flag is not None:
            vals[ids.size // 2] = flag
        return ids, vals
    monkeypatch.setattr(abv_postings, "rank", flagged)
    measure, touch = abv_postings.postings_search_batch(staged, [q], 2)
    ids, vals = flagged(measure[0], touch[0], 2, q[1], staged.index.y_l2n)
    want = io.StringIO()
    native_io.write_name_float_lines(want, staged.index.names,
                                     staged.names.blob, staged.names.off,
                                     ids, vals)
    launches = _build.LAUNCHES["abv_format_lines"]
    out = io.StringIO()
    assert staged.names.write(out, ids, vals) is (flag is None)
    assert out.getvalue() == want.getvalue() and ids.size > 100
    monkeypatch.setattr(abv_postings, "_postings_db", lambda *a: staged)
    TIMER.reset()
    out = io.StringIO()
    abv_postings.abv_search_postings(seeded_db, [qpath], 2, out=out,
                                     device="cpu")
    assert out.getvalue() == "#Sample\tL2norm\n" + want.getvalue()
    assert {k: TIMER.counters.get(k, 0) for k in
            ("abv.post.format.card", "abv.post.format.host")} == \
        ({"abv.post.format.card": ids.size, "abv.post.format.host": 0}
         if flag is None else
         {"abv.post.format.card": 0, "abv.post.format.host": ids.size})
    assert _build.LAUNCHES["abv_format_lines"] == launches  # none on a CPU


@pytest.mark.parametrize("route", ["postings", "dense"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_search_text_through_the_twin(seeded_db, mode, route, capsys):
    """Either card route's search with the card's text buffers on its
    staged names (on the CPU, through the twin) prints the text it prints
    without them (the postings route: the host route's), every line
    counted in ``<route>.format.card``."""
    qs = _queries(seeded_db)
    argv = ["composite", "-r", seeded_db, "-s", str(mode), *qs]
    cpu = torch.device("cpu")
    if route == "postings":
        want = _cli(argv, "host", capsys)
        names = abv_postings._postings_db(seeded_db, cpu).names
        search, prefix = abv_postings.abv_search_postings, "abv.post"
    else:
        want = _cli([*argv, "--dense"], "cpu", capsys)
        names = dense_abv._dense_db(seeded_db, cpu)[3]
        search, prefix = dense_abv.abv_search_dense, "abv"
    names.card = abv_text.CardText.stage(names.names, "cpu")
    try:
        TIMER.reset()
        out = io.StringIO()
        search(seeded_db, qs, mode, out=out, device="cpu")
    finally:
        names.card = None
    assert out.getvalue() == want
    assert TIMER.counters[f"{prefix}.format.card"] == \
        TIMER.counters[f"{prefix}.lines"] > len(qs)
    assert f"{prefix}.format.host" not in TIMER.counters


def test_card_text_shared_by_threads():
    """``CardText.text`` from more threads than cores on one staged set
    of buffers (on the CPU, through the twin), with a short switch
    interval: every text is its own query's."""
    import sys
    import threading
    rng = np.random.default_rng(7)
    names = text_cases.names_of_lengths(3000, rng, 20)
    card = abv_text.CardText.stage(names, "cpu")
    jobs = [(rng.permutation(3000)[:1500], text_cases.mode_values(k % 3,
                                                                  1500, rng))
            for k in range(2 * (os.cpu_count() or 4))]
    got = [None] * len(jobs)

    def work(k):
        for _ in range(3):
            got[k] = card.text(*jobs[k])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(len(jobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for (ids, vals), text in zip(jobs, got):
        assert text == "".join(f"{names[i]}\t{v:f}\n"
                               for i, v in zip(ids, vals))
