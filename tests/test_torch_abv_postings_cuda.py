"""The postings walk kernel (``csrc/abv.cu``, ``mkssd_abv_post_walk``) on
the card against its plain twin on the CPU, bit for bit; the text kernel
(``mkssd_abv_format_lines``, ``ops/abv_text.py``) against the host writer
and its twin, byte for byte.

Every test here carries the ``cuda`` marker and skips where there is no
CUDA device.  The module imports neither jax nor the JAX package, so on a
GPU machine:

    python -m pytest -m cuda tests/test_torch_abv_postings_cuda.py
"""

import io
import os

import numpy as np
import pytest
import torch

import text_cases
from metakssd_tpu_torch.formats.abv import AbvIndex, write_abv_file
from metakssd_tpu_torch.io import native as native_io
from metakssd_tpu_torch.ops import _build, abv_postings, abv_text
from metakssd_tpu_torch.utils import TIMER

pytestmark = pytest.mark.cuda

N_SAMPLES = 5000             # five tiles of 1024, the last one partial
N_SPECIES = 3000


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def index():
    """An index of N_SAMPLES samples of 1-400 species with a 1/rank
    prevalence (the first species in most samples, so a tile's postings
    fill several of the kernel's windows), log-normal percentages summing
    to 100; two samples empty."""
    rng = np.random.default_rng(8)
    prev = 1.0 / np.arange(1, N_SPECIES + 1) ** 0.7
    prev /= prev.sum()
    sp_all, pct_all, owner = [], [], []
    for s in range(N_SAMPLES):
        if s in (11, N_SAMPLES - 1):
            continue
        nd = int(rng.integers(1, 400))
        sp = rng.choice(N_SPECIES, nd, replace=False, p=prev)
        pct = rng.lognormal(0.0, 1.5, nd)
        sp_all.append(sp)
        pct_all.append((pct / pct.sum() * 100).astype(np.float32))
        owner.append(np.full(nd, s))
    sp, pct, owner = (np.concatenate(a) for a in (sp_all, pct_all, owner))
    order = np.lexsort((owner, sp))
    y2 = np.bincount(owner, weights=pct.astype(np.float64) ** 2,
                     minlength=N_SAMPLES)
    return AbvIndex([f"S{s:05d}.abv" for s in range(N_SAMPLES)],
                    np.sqrt(y2),
                    np.cumsum(np.bincount(sp, minlength=N_SPECIES)).astype(
                        np.int32),
                    owner[order].astype(np.int32), pct[order])


def _queries(case: str, index: AbvIndex) -> list:
    rng = np.random.default_rng(len(case))

    def spread(nd):
        sp = rng.choice(N_SPECIES, nd, replace=False)
        pct = rng.random(nd) + 0.1
        return sp.astype(np.int32), (pct / pct.sum() * 100).astype(
            np.float32)

    def sample(s):
        starts = np.concatenate([[0], index.abmi]).astype(np.int64)
        held = np.flatnonzero(np.diff(starts) > 0)
        sp = [j for j in held
              if s in index.abm_idx[starts[j]:starts[j + 1]]]
        pct = [index.abm_pct[starts[j]:starts[j + 1]][
            index.abm_idx[starts[j]:starts[j + 1]] == s][0] for j in sp]
        p = rng.permutation(len(sp))
        return (np.asarray(sp, np.int32)[p],
                np.asarray(pct, np.float32)[p])
    empty = (np.zeros(0, np.int32), np.zeros(0, np.float32))
    if case == "empty":
        return [empty]
    if case == "popular":        # the most held species: many windows
        sp = np.arange(40, dtype=np.int32)[::-1].copy()
        return [(sp, np.full(40, 2.5, np.float32))]
    if case == "chunks":         # more species than a block takes at once
        return [spread(700)]
    if case == "all":
        return [spread(N_SPECIES)]
    if case == "batch5":
        dup = spread(30)
        dup = (np.concatenate([dup[0], dup[0][:5]]),
               np.concatenate([dup[1], dup[1][:5]]))
        return [spread(1), empty, spread(250), dup, sample(3)]
    assert case == "self"
    return [sample(0), sample(2500), sample(N_SAMPLES - 2)]


CASES = ["empty", "popular", "chunks", "all", "batch5", "self"]


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("case", CASES)
def test_kernel_equals_twin_bits(cuda, index, case, mode, monkeypatch):
    """``postings_search_batch`` on the card against the CPU twin: measure
    bits and first touches equal; one launch a call, counted in
    ``_build.LAUNCHES``; the twin never called for the card's index."""
    queries = _queries(case, index)
    on_cpu = abv_postings.stage_postings(index, "cpu")
    on_card = abv_postings.stage_postings(index, cuda)
    pm, pt = abv_postings.postings_search_batch(on_cpu, queries, mode)

    def refuse(*a, **k):
        raise AssertionError("the card's index reached the plain twin")
    monkeypatch.setattr(abv_postings, "postings_walk_plain", refuse)
    before = _build.LAUNCHES["abv_post_walk"]
    m, t = abv_postings.postings_search_batch(on_card, queries, mode)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["abv_post_walk"] == before + 1
    assert m.shape == t.shape == (len(queries), N_SAMPLES)
    np.testing.assert_array_equal(t, pt)
    np.testing.assert_array_equal(m.view(np.int32), pm.view(np.int32))
    if case == "empty":
        assert (t == -1).all() and (m == 0).all()
    if case in ("popular", "all"):
        assert (t[0] >= 0).sum() > N_SAMPLES // 2
    if case == "self" and mode == 2:
        assert (m[range(3), [0, 2500, N_SAMPLES - 2]] == 0).all()


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_text_on_the_card_equals_cpu(cuda, index, tmp_path, mode):
    """``composite -s <mode>`` text on ``cuda`` and ``cpu``, byte for
    byte, from the index's files; on the card every line formatted by
    the text kernel (``abv.post.format.card`` equal to
    ``abv.post.lines``, ``abv.post.format.host`` 0), one call of it a
    query that has lines."""
    index.write(str(tmp_path))
    qpaths = []
    for i, (sp, pct) in enumerate(_queries("batch5", index)):
        qpaths.append(str(tmp_path / f"q{i}.abv"))
        write_abv_file(qpaths[-1], sp, pct)
    got = {}
    for dev in ("cpu", "cuda"):
        TIMER.reset()
        launches = _build.LAUNCHES["abv_format_lines"]
        out = io.StringIO()
        abv_postings.abv_search_postings(str(tmp_path), qpaths, mode,
                                         out=out, device=dev)
        got[dev] = out.getvalue()
        launches = _build.LAUNCHES["abv_format_lines"] - launches
    assert got["cuda"] == got["cpu"] and got["cpu"].count("#Sample") == 5
    assert os.path.exists(str(tmp_path / "abundance_Vec.abm"))
    blocks = got["cuda"].split("#Sample\t")[1:]
    assert launches == sum(b.count("\n") > 1 for b in blocks) == 4
    assert TIMER.counters["abv.post.format.card"] == \
        TIMER.counters["abv.post.lines"] > 5
    assert TIMER.counters.get("abv.post.format.host", 0) == 0


def test_launch_checks(cuda, index):
    """The wrapper raises on what the kernel does not take, before any
    launch: a CSR on the CPU, a wrong dtype, an unknown mode."""
    staged = abv_postings.stage_postings(index, cuda)
    off = torch.tensor([0, 2], dtype=torch.int32, device=cuda)
    sp = torch.tensor([1, 4], dtype=torch.int32, device=cuda)
    val = torch.tensor([1.0, 2.0], dtype=torch.float32, device=cuda)
    pos = torch.tensor([0, 10], dtype=torch.int64, device=cuda)
    before = _build.LAUNCHES["abv_post_walk"]
    with pytest.raises(ValueError):
        abv_postings.postings_walk(staged, off.cpu(), sp, val, pos, 2)
    with pytest.raises(ValueError):
        abv_postings.postings_walk(staged, off, sp.long(), val, pos, 2)
    with pytest.raises(ValueError):
        abv_postings.postings_walk(staged, off, sp, val, pos, 3)
    assert _build.LAUNCHES["abv_post_walk"] == before
    _, touch, _ = abv_postings.postings_walk(staged, off, sp, val, pos, 2)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["abv_post_walk"] == before + 1
    assert touch.shape == (1, N_SAMPLES)


def test_probe_check_on_the_card(cuda):
    """The full-shape probe's check (``probes/bench_abv_postings``) at a
    small shape: kernel and twin, both on the card, agree in every
    measure's bits and every touch in all three modes."""
    from metakssd_tpu_torch.probes import bench_abv_postings as probe
    staged = probe.make_index(9, cuda, samples=4000, species=2000)
    got = probe.check(staged, 9, sizes=(30, 383))
    assert got["measures_differ"] == got["touches_differ"] == 0
    assert got["max_abs_err"] == 0.0


CELL_SAMPLES = 382_016       # the postings cell's samples
CELL_LINES = 378_000         # ... and about the lines of its queries


def test_text_kernel_at_the_cell_shape(cuda):
    """The text kernel's bytes equal the host writer's at the postings
    cell's shape: 382,016 names of its form, 378,000 lines of L2 values,
    one call of the kernel."""
    names = [f"SRR{10_000_000 + i}.abv" for i in range(CELL_SAMPLES)]
    rng = np.random.default_rng(22)
    ids = rng.permutation(CELL_SAMPLES)[:CELL_LINES]
    vals = text_cases.mode_values(2, CELL_LINES, rng)
    card = abv_text.CardText.stage(names, cuda)
    launches = _build.LAUNCHES["abv_format_lines"]
    got = card.text(ids, vals)
    assert _build.LAUNCHES["abv_format_lines"] == launches + 1
    want = io.StringIO()
    native_io.write_name_float_lines(want, names, *native_io.names_blob(names),
                                     ids, vals)
    assert got == want.getvalue()
    assert got.count("\n") == CELL_LINES


@pytest.mark.parametrize("longest", [16, 64])
def test_text_kernel_crafted(cuda, longest):
    """On the card, names of 0 to ``longest`` characters (at 64 a block's
    text outgrows shared memory and goes to device memory directly),
    values of every mode and the crafted ones: the text equals the
    twin's and ``"%f"``'s; the flagged values and a sample outside the
    names are counted as the twin counts them, and ``CardText.text``
    returns None for a query that holds one."""
    rng = np.random.default_rng(longest)
    vals = np.concatenate([text_cases.mode_values(m, 20_000, rng)
                           for m in (0, 1, 2)] + [text_cases.PRINTED])
    names = text_cases.names_of_lengths(vals.size, rng, longest)
    ids = rng.permutation(len(names))
    card = abv_text.CardText.stage(names, cuda)
    got = card.text(ids, vals)
    assert got == "".join(f"{names[i]}\t{v:f}\n" for i, v in zip(ids, vals))
    bad = np.concatenate([vals[:3000], text_cases.FLAGGED])
    bad_ids = np.concatenate([ids[:3000 + len(text_cases.FLAGGED)],
                              [len(names)]]).astype(np.int32)
    bad = np.concatenate([bad, [1.0]])
    counts = {}
    for dev in ("cpu", cuda):
        t = abv_text.CardText.stage(names, dev) if dev == "cpu" else card
        scratch = torch.zeros_like(t.scratch)
        out = torch.zeros_like(t.out)
        abv_text.format_lines(t.blob, t.off,
                              torch.from_numpy(bad_ids).to(dev),
                              torch.from_numpy(bad).to(dev), scratch, out)
        total, flagged = scratch[:2].tolist()
        counts[str(dev)] = (total, flagged, bytes(out[:total].cpu().numpy()))
    assert counts["cpu"] == counts["cuda"]
    assert counts["cuda"][1] == len(text_cases.FLAGGED) + 1
    assert card.text(ids[:5], np.array([1.0, 2.0, np.nan, 3.0, 4.0])) is None
