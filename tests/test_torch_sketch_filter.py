"""The filter-then-verify formulation of the port's sketch kernels
(metakssd_tpu_torch/ops/sketch_filter.py, sketch_cuda.window_filtered_plain)
on the CPU, exactly: against the plain versions that search every window,
the numpy model ``golden`` and the Pallas kernels in interpret mode (as
tests/test_sketch_pallas.py runs them).  All values are integers, so every
comparison is bit for bit.  Also the host library's serial rebuild
(metakssd_tpu_torch/io/native.py), with the compiler replaced by a stub.

Nothing here needs the native library, a GPU or the reference binary.
"""

import subprocess

import numpy as np
import pytest
import torch

from metakssd_tpu.ops import golden, sketch_pallas

from metakssd_tpu_torch.io import native
from metakssd_tpu_torch.ops import sketch, sketch_cuda, sketch_filter
from metakssd_tpu_torch.params import SketchParams
from metakssd_tpu_torch.state import accept_tables

from sketch_cases import assert_pairs_equal, pairs, random_codes, \
    sized_tables, synthetic_tables, zero_accepted

# (k, subk, drlevel): the smoke run's configs.  A subk = 7 shuffle file
# holds 2^28 entries (1 GiB), so subk = 7 is tested on tables made
# directly (synthetic_tables), which is all the kernels ever see.
FILTER_CONFIGS = [(11, 6, 3), (8, 5, 2), (7, 5, 3)]


def _all_dims(subk, sample, seed):
    """Every dim of a small space, a random sample of a large one."""
    space = 1 << (4 * subk)
    if space <= 1 << 20:
        return torch.arange(space)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.unique(rng.integers(0, space, sample)))


# ---------------------------------------------------------------------------
# (a) the bitmap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("log2", [None, 12])
@pytest.mark.parametrize("cfg", FILTER_CONFIGS)
def test_bitmap_has_no_false_negative(cfg, log2):
    p = SketchParams(*cfg)
    shuf = zero_accepted(p, seed=sum(cfg))
    tabs = sized_tables(shuf, "cpu", log2)
    assert tabs.filter.dtype == torch.int32
    assert tabs.filter.numel() == (1 << tabs.filter_log2) // 32
    acc = torch.from_numpy(shuf.accept_table()[0].astype(np.int64))
    idx = sketch_filter.filter_index(acc, tabs.filter_log2, p.subk)
    assert int(idx.min()) >= 0 and int(idx.max()) < 1 << tabs.filter_log2
    assert bool(sketch_filter.bits_set(tabs.filter, idx).all())
    # a folded bitmap passes about n / bits of the other dims, no more
    dims = _all_dims(p.subk, 1 << 20, seed=1)
    passed = sketch_filter.bits_set(tabs.filter, sketch_filter.filter_index(
        dims, tabs.filter_log2, p.subk))
    share = float(passed.float().mean())
    assert share <= 1.05 * acc.numel() / (1 << tabs.filter_log2) + 1e-3


@pytest.mark.parametrize("cfg,log2", [((6, 4, 2), None), ((4, 4, 2), 16),
                                      ((7, 4, 3), None), ((5, 3, 2), 12)])
def test_direct_bitmap_is_exact(cfg, log2):
    """With 16**subk bits (subk <= 4: the kernels take at most 2^19) the
    bitmap is the JAX package's accept bitmask: no false positive
    either."""
    p = SketchParams(*cfg)
    shuf = zero_accepted(p, seed=3)
    tabs = sized_tables(shuf, "cpu", log2)
    assert sketch_filter.is_direct(tabs.filter_log2, p.subk)
    np.testing.assert_array_equal(tabs.filter.numpy().view(np.uint32),
                                  shuf.accept_bitmask())
    dims = torch.arange(p.shuf_len)
    passed = sketch_filter.bits_set(tabs.filter, sketch_filter.filter_index(
        dims, tabs.filter_log2, p.subk))
    np.testing.assert_array_equal(np.flatnonzero(passed.numpy()),
                                  shuf.accept_table()[0])


@pytest.mark.parametrize("n,subk,want", [
    (4096, 6, 18), (4096, 5, 18), (4096, 7, 18), (4096, 4, 16),
    (16384, 7, 19), (16000, 7, 19), (256, 2, 8), (1, 6, 10), (8192, 6, 19),
    (100, 5, 13), (2048, 5, 17)])
def test_default_bitmap_size(n, subk, want):
    assert sketch_filter.default_log2(n, subk) == want
    sketch_filter.check_log2(want, subk)


def test_bitmap_size_is_checked():
    acc = torch.arange(10, dtype=torch.int32)
    for log2, subk in ((20, 5), (20, 6), (3, 6), (19, 4)):
        with pytest.raises(ValueError):
            sketch_filter.build_filter(acc, subk, log2)


@pytest.mark.parametrize("n,log2", [(4096, 18), (16_000, 19), (4096, 12)])
def test_subk7_bitmap_against_numpy(n, log2):
    """Tables of subk = 7, up to one near the largest the kernel path
    takes: the bitmap holds exactly the folds of the accepted dims,
    computed here in numpy as unsigned 32-bit products."""
    p = SketchParams(9, 7, 4)
    tabs = synthetic_tables(p, n, seed=4, device="cpu",
                            filter_log2=None if log2 != 12 else 12)
    assert tabs.filter_log2 == log2
    acc = tabs.accept.numpy().view(np.uint32)
    want = (acc.astype(np.uint64) * sketch_filter.FOLD_MULT
            & 0xFFFFFFFF) >> (32 - log2)
    got = np.flatnonzero(np.unpackbits(
        tabs.filter.numpy().view(np.uint8), bitorder="little"))
    np.testing.assert_array_equal(got, np.unique(want))


@pytest.mark.parametrize("n,log2", [(4096, None), (16_000, None),
                                    (4096, 12)])
def test_subk7_filtered_matches_full(n, log2):
    """subk = 7 streams with hits, false positives, invalid bases and a
    poly-A run: filter-then-verify equals the search of every window."""
    p = SketchParams(9, 7, 4)
    tabs = synthetic_tables(p, n, seed=5, device="cpu", filter_log2=log2)
    acc = tabs.accept.numpy().view(np.uint32).astype(np.int64)
    rng = np.random.default_rng(6)
    hits, _ = sketch_filter.codes_with_dims(rng.choice(acc, 800), p, 7)
    fps, kept = sketch_filter.codes_with_dims(
        sketch_filter.false_positive_dims(
            tabs.accept, tabs.filter, tabs.filter_log2, 7, 1 << 18, 8)[:800],
        p, 9)
    codes = np.concatenate([random_codes(10, 20_000, 20), hits, fps])
    codes[1000:1100] = 0
    c = torch.from_numpy(codes)
    fdr, fkeep = sketch_cuda.window_filtered_plain(c, tabs, p)
    pdr, pkeep = sketch_cuda.window_full_plain(c, tabs, p)
    assert torch.equal(fdr, pdr) and torch.equal(fkeep, pkeep)
    ncand = sketch_cuda.filter_candidates(c, tabs, p)[0].numel()
    assert int(fkeep.sum()) >= 300 + 100 - p.kmer_len + 1
    assert ncand >= int(fkeep.sum()) + kept.size > int(fkeep.sum())


# ---------------------------------------------------------------------------
# (b) filter-then-verify against the plain version, golden and Pallas
# ---------------------------------------------------------------------------

def _stream(kind, p, shuf, tabs):
    TL = p.kmer_len
    if kind == "random":
        return random_codes(seed=5, n=30_000, n_invalid=30)
    if kind == "poly_a":
        codes = random_codes(seed=6, n=12_000, n_invalid=12)
        codes[3_000:8_200] = 0
        return codes
    if kind == "false_positives":
        small = sized_tables(shuf, "cpu", 12)
        dims = sketch_filter.false_positive_dims(
            small.accept, small.filter, 12, p.subk, 1 << 16, seed=7)
        codes, kept = sketch_filter.codes_with_dims(dims[:1500], p, seed=8)
        assert kept.size > 300
        return np.concatenate([codes, np.zeros(60, np.uint8)])
    nwin = {"one_window": 1, "TL-1_windows": TL - 1, "TL_windows": TL,
            "a_tile_and_one": 4097}[kind]
    codes = random_codes(seed=9, n=nwin + TL - 1, n_invalid=0)
    codes[:min(nwin, 40) + TL - 1] = 0        # some windows are kept
    return codes


STREAMS = ["random", "poly_a", "false_positives", "one_window",
           "TL-1_windows", "TL_windows", "a_tile_and_one"]


@pytest.mark.parametrize("kind", STREAMS)
@pytest.mark.parametrize("cfg", FILTER_CONFIGS)
def test_filtered_matches_full_golden_pallas(cfg, kind):
    p = SketchParams(*cfg)
    shuf = zero_accepted(p, seed=cfg[0])
    codes = _stream(kind, p, shuf, None)
    c = torch.from_numpy(codes)
    gdr, gpos = golden.window_drtuples(codes, shuf, return_positions=True)
    assert gdr.size > 0
    for log2 in (None, 12):
        tabs = sized_tables(shuf, "cpu", log2)
        fdr, fkeep = sketch_cuda.window_filtered_plain(c, tabs, p)
        pdr, pkeep = sketch_cuda.window_full_plain(c, tabs, p)
        assert torch.equal(fdr, pdr) and torch.equal(fkeep, pkeep)
        cand = sketch_cuda.filter_candidates(c, tabs, p)[0].numpy()
        kept = np.flatnonzero(fkeep.numpy())
        assert np.isin(kept, cand).all()
        if kind == "false_positives" and log2 == 12:
            assert cand.size > 3 * kept.size
    np.testing.assert_array_equal(kept, gpos)
    np.testing.assert_array_equal(
        fdr.numpy().view(np.uint32)[kept].astype(np.uint64), gdr)
    # the Pallas kernels in interpret mode: K2 (all windows) and K1
    # (compact, with positions)
    keys, count = sketch_pallas.sketch_codes_pallas(
        codes, shuf, interpret=True, compact=False)
    assert count == kept.size
    np.testing.assert_array_equal(keys.astype(np.uint64), np.sort(gdr))
    kdr, kpos = sketch_pallas.sketch_codes_pallas(
        codes, shuf, interpret=True, with_positions=True)
    assert_pairs_equal(pairs(kdr, kpos), pairs(gdr, gpos))


def test_no_window_at_all():
    """A stream shorter than one window: the plain versions refuse it and
    the chunk loop returns nothing, as golden does."""
    p = SketchParams(11, 6, 3)
    shuf = zero_accepted(p, seed=10)
    tabs = accept_tables(shuf, "cpu")
    codes = np.zeros(p.kmer_len - 1, np.uint8)
    with pytest.raises(ValueError):
        sketch_cuda.window_filtered_plain(torch.from_numpy(codes), tabs, p)
    assert sketch.sketch_codes(codes, shuf, "cpu").size == 0
    assert golden.window_drtuples(codes, shuf).size == 0


# ---------------------------------------------------------------------------
# (c) the bit layout's edge branches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    (5, 5, 2),       # outctx = 0: no outer context, empty masks
    (12, 4, 4),      # the outer contexts fill all 32 bits (ids >= 2^31)
    (11, 6, 3),      # the left context starts above bit 32 of the tuple
])
def test_edge_layouts(cfg):
    p = SketchParams(*cfg)
    shuf = zero_accepted(p, seed=11)
    assert sketch.on_device_path(shuf)
    tabs = accept_tables(shuf, "cpu")
    codes = random_codes(seed=12, n=25_000, n_invalid=25)
    codes[7_000:7_100] = 0
    c = torch.from_numpy(codes)
    fdr, fkeep = sketch_cuda.window_filtered_plain(c, tabs, p)
    pdr, pkeep = sketch_cuda.window_full_plain(c, tabs, p)
    assert torch.equal(fdr, pdr) and torch.equal(fkeep, pkeep)
    gdr, gpos = golden.window_drtuples(codes, shuf, return_positions=True)
    kept = np.flatnonzero(fkeep.numpy())
    np.testing.assert_array_equal(kept, gpos)
    u32 = fdr.numpy().view(np.uint32)[kept]
    np.testing.assert_array_equal(u32.astype(np.uint64), gdr)
    if cfg == (12, 4, 4):
        assert (u32 >= np.uint32(1 << 31)).any()
    keys, _ = sketch_pallas.sketch_codes_pallas(codes, shuf, interpret=True)
    np.testing.assert_array_equal(keys.astype(np.uint64), np.sort(gdr))


def test_drtuple_zero_passes_the_filter():
    """The poly-A k-mer (dim 0, drtuple 0) is a candidate and is kept,
    under a direct and under a folded bitmap."""
    for cfg, log2 in (((6, 4, 2), None), ((8, 5, 2), None), ((11, 6, 3), None),
                      ((8, 5, 2), 19)):
        p = SketchParams(*cfg)
        shuf = zero_accepted(p, seed=13)
        tabs = sized_tables(shuf, "cpu", log2)
        codes = np.zeros(100, np.uint8)
        dr, keep = sketch_cuda.window_filtered_plain(
            torch.from_numpy(codes), tabs, p)
        assert bool(keep.all()) and not bool(dr.any())


# ---------------------------------------------------------------------------
# (d) the host library's serial rebuild
# ---------------------------------------------------------------------------

def _stub_compiler(monkeypatch, tmp_path, fails):
    """Replace the compiler: a command holding a flag of ``fails`` exits
    1, any other writes its output file.  Returns the commands run."""
    ran = []

    def run(cmd, check=False, capture_output=False, **kw):
        ran.append(list(cmd))
        if any(f in cmd for f in fails):
            raise subprocess.CalledProcessError(1, cmd, b"", b"no libgomp")
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"stub")
        return subprocess.CompletedProcess(cmd, 0, b"", b"")

    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_kind", None)
    monkeypatch.setattr(native.subprocess, "run", run)
    return ran


def test_native_build_falls_back_to_serial_flags(monkeypatch, tmp_path):
    ran = _stub_compiler(monkeypatch, tmp_path, fails=("-fopenmp",))
    so = native._build()
    assert so is not None and so.startswith(str(tmp_path))
    assert so == native._library_path(native._SERIAL_CXXFLAGS)
    assert so != native._library_path(native._CXXFLAGS)
    assert native._kind == "serial"
    assert len(ran) == 2 and "-fopenmp" in ran[0] and "-fopenmp" not in ran[1]
    assert [f for f in ran[0] if f != "-fopenmp"] == \
        [f.replace(native._library_path(native._SERIAL_CXXFLAGS),
                   native._library_path(native._CXXFLAGS)) for f in ran[1]]
    # the second call finds the serial library and compiles nothing: not
    # the OpenMP attempt either, which may fail only after a long compile
    monkeypatch.setattr(native, "_kind", None)
    assert native._build() == so and len(ran) == 2
    assert native._kind == "serial"


def test_native_build_keeps_openmp_when_it_compiles(monkeypatch, tmp_path):
    ran = _stub_compiler(monkeypatch, tmp_path, fails=())
    so = native._build()
    assert so == native._library_path(native._CXXFLAGS)
    assert native._kind == "openmp" and len(ran) == 1
    assert native._build() == so and len(ran) == 1


def test_native_build_gives_none_when_both_fail(monkeypatch, tmp_path):
    ran = _stub_compiler(monkeypatch, tmp_path, fails=("-O3",))
    assert native._build() is None
    assert native._kind is None and len(ran) == 2
    assert not any((tmp_path / "_build").iterdir())
