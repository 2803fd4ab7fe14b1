"""The CUDA kernels K1/K2 (metakssd_tpu_torch/csrc/sketch.cu) against
their plain PyTorch versions and the numpy model ``golden``, on a GPU.

Every test here carries the ``cuda`` marker and skips where there is no
CUDA device.  The module imports neither jax nor the JAX package, so on a
GPU machine:

    python -m pytest -m cuda tests/test_torch_sketch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from metakssd_tpu_torch import pipeline
from metakssd_tpu_torch.io import seqio
from metakssd_tpu_torch.ops import (_build, golden, sketch, sketch_cuda,
                                    sketch_filter)
from metakssd_tpu_torch.params import SketchParams
from metakssd_tpu_torch.state import accept_tables

from sketch_cases import CONFIGS, assert_pairs_equal, pairs, \
    random_codes, sized_tables, synthetic_tables, zero_accepted

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_kernels_match_plain(cuda, cfg):
    """K1 (count, (drtuple, position) pairs, also past a tiny capacity)
    and K2 (window by window) equal their plain versions on the same
    CUDA tensors, with a poly-A run whose k-mer is accepted."""
    p = SketchParams(*cfg)
    tabs = accept_tables(zero_accepted(p, seed=1), cuda)
    codes = random_codes(seed=2, n=1 << 20, n_invalid=500)
    codes[1000:3000] = 0
    c = torch.from_numpy(codes).to(cuda)
    for cap in (1 << 20, 100):
        dr, pos, n = sketch_cuda.window_compact(c, tabs, p, cap, True)
        pdr, ppos, pn = sketch_cuda.window_compact_plain(c, tabs, p, cap,
                                                         True)
        m = int(n.item())
        assert m == int(pn.item()) >= 2000 - p.kmer_len + 1
        if m <= cap:
            assert_pairs_equal(pairs(_u32(dr[:m]), pos[:m].cpu().numpy()),
                               pairs(_u32(pdr[:m]), ppos[:m].cpu().numpy()))
    fdr, fk = sketch_cuda.window_full(c, tabs, p)
    gdr, gk = sketch_cuda.window_full_plain(c, tabs, p)
    assert torch.equal(fdr, gdr) and torch.equal(fk, gk)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_chunk_loop_matches_golden(cuda, cfg):
    """Small chunks and a small capacity on the card: windows across
    chunk boundaries, the K2 rerun of the chunk holding a poly-A run,
    and int64 stream positions all equal golden."""
    p = SketchParams(*cfg)
    shuf = zero_accepted(p, seed=3)
    codes = random_codes(seed=4, n=200_000, n_invalid=200)
    codes[70_000:71_000] = 0
    _build.reset_launches()
    dr, pos = sketch.sketch_codes_with_positions(
        codes, shuf, cuda, chunk_windows=30_011, capacity=512)
    assert _build.LAUNCHES["sketch_compact"] == 7
    assert _build.LAUNCHES["sketch_full"] >= 1
    assert pos.dtype == np.int64
    gdr, gpos = golden.window_drtuples(codes, shuf, return_positions=True)
    assert_pairs_equal(pairs(dr, pos), pairs(gdr, gpos))


def _assert_k1_k2_match_plain(c, tabs, p, cap, want_pos=True):
    """K1 at ``cap`` (with or without positions) and K2 on CUDA codes
    ``c`` against their plain versions; returns the kept count."""
    dr, pos, n = sketch_cuda.window_compact(c, tabs, p, cap, want_pos)
    pdr, ppos, pn = sketch_cuda.window_compact_plain(c, tabs, p, cap, True)
    torch.cuda.synchronize()
    m = int(n.item())
    assert m == int(pn.item())
    assert (pos is None) == (not want_pos)
    w = min(m, cap)
    if want_pos and m <= cap:
        assert_pairs_equal(pairs(_u32(dr[:w]), pos[:w].cpu().numpy()),
                           pairs(_u32(pdr[:w]), ppos[:w].cpu().numpy()))
    elif m <= cap:
        np.testing.assert_array_equal(np.sort(_u32(dr[:w])),
                                      np.sort(_u32(pdr[:w])))
    else:
        # past the capacity K1 keeps some `cap` of the survivors
        kept = _u32(sketch_cuda.window_full_plain(c, tabs, p)[0])
        if want_pos:
            at = pos[:w].cpu().numpy()
            assert np.unique(at).size == w
            np.testing.assert_array_equal(_u32(dr[:w]), kept[at])
    fdr, fk = sketch_cuda.window_full(c, tabs, p)
    gdr, gk = sketch_cuda.window_full_plain(c, tabs, p)
    assert torch.equal(fdr, gdr) and torch.equal(fk, gk)
    assert int(fk.sum().item()) == m
    return m


# (config, log2 of the filter bitmap or None for the default): direct
# and folded bitmaps, the largest one (2^19 bits, two blocks to an SM), a
# fold so small that one window in four passes it, and no outer context
FILTERS = [((11, 6, 3), None), ((11, 6, 3), 12), ((11, 6, 3), 19),
           ((8, 5, 2), None), ((8, 5, 2), 19), ((7, 5, 3), 14),
           ((6, 4, 2), None), ((6, 4, 2), 10),
           ((5, 5, 2), 18)]


@pytest.mark.parametrize("cfg,log2", FILTERS)
@pytest.mark.parametrize("want_pos", [True, False])
def test_filter_sizes_match_plain(cuda, cfg, log2, want_pos):
    p = SketchParams(*cfg)
    tabs = sized_tables(zero_accepted(p, seed=5), cuda, log2)
    codes = random_codes(seed=6, n=300_000, n_invalid=300)
    codes[5000:5400] = 0
    c = torch.from_numpy(codes).to(cuda)
    m = _assert_k1_k2_match_plain(c, tabs, p, 1 << 16, want_pos)
    assert m >= 400 - p.kmer_len + 1


@pytest.mark.parametrize("cfg,log2", [((11, 6, 3), None), ((8, 5, 2), 16),
                                      ((5, 5, 2), 12)])
def test_false_positives_cost_no_output(cuda, cfg, log2):
    """A stream whose every 2k-th window passes the filter and is not
    accepted: the candidates are many, the output is the plain one."""
    p = SketchParams(*cfg)
    tabs = sized_tables(zero_accepted(p, seed=7), cuda, log2)
    dims = sketch_filter.false_positive_dims(
        tabs.accept, tabs.filter, tabs.filter_log2, p.subk, 1 << 21, 8)
    codes, kept = sketch_filter.codes_with_dims(dims[:20_000], p, 9)
    assert kept.size > 2000
    c = torch.from_numpy(codes).to(cuda)
    cand = sketch_cuda.filter_candidates(c, tabs, p)[0]
    m = _assert_k1_k2_match_plain(c, tabs, p, 1 << 16)
    assert cand.numel() >= kept.size + m and cand.numel() > 4 * m


@pytest.mark.parametrize("n,log2", [(4096, None), (16_000, None),
                                    (4096, 13)])
def test_subk7_tables(cuda, n, log2):
    """Tables of subk = 7 made directly (no shuffle file gives more than
    4096 entries; the kernels take any sorted table): 16,000 dims fold to
    the largest bitmap, 2^19 bits.  The stream holds
    hits, false positives, invalid bases and a poly-A run."""
    p = SketchParams(9, 7, 4)
    tabs = synthetic_tables(p, n, seed=10, device=cuda, filter_log2=log2)
    if n == 16_000:
        assert tabs.filter_log2 == 19 and tabs.filter.numel() == 1 << 14
    rng = np.random.default_rng(11)
    acc = _u32(tabs.accept).astype(np.int64)
    hits, _ = sketch_filter.codes_with_dims(rng.choice(acc, 5000), p, 12)
    fps, kept = sketch_filter.codes_with_dims(
        sketch_filter.false_positive_dims(
            tabs.accept, tabs.filter, tabs.filter_log2, 7, 1 << 20,
            13)[:5000], p, 14)
    codes = np.concatenate([random_codes(15, 400_000, 400), hits, fps])
    codes[9000:9100] = 0
    c = torch.from_numpy(codes).to(cuda)
    m = _assert_k1_k2_match_plain(c, tabs, p, 1 << 16)
    assert m > 2000 and kept.size > 1000


@pytest.mark.parametrize("cfg,log2", [((11, 6, 3), None), ((8, 5, 2), 19)])
@pytest.mark.parametrize("nwin", [1, 15, 4095, 4096, 4097, 8192, 8193,
                                  3 * 8192 + 1])
def test_tile_edges(cuda, cfg, log2, nwin):
    """Streams of one window, one tile (4096 windows) less one, one tile,
    one tile and one window more, and several tiles, all of them kept."""
    p = SketchParams(*cfg)
    tabs = sized_tables(zero_accepted(p, seed=13), cuda, log2)
    c = torch.zeros(nwin + p.kmer_len - 1, dtype=torch.uint8, device=cuda)
    assert _assert_k1_k2_match_plain(c, tabs, p, nwin) == nwin
    rc = torch.from_numpy(random_codes(14, nwin + p.kmer_len - 1,
                                       nwin // 500)).to(cuda)
    _assert_k1_k2_match_plain(rc, tabs, p, nwin)


@pytest.mark.parametrize("cfg", [(11, 6, 3), (8, 5, 2)])
def test_all_kept_at_a_capacity_between(cuda, cfg):
    """Every window kept over several tiles, at a capacity between one
    tile's survivors and all of them: the count runs on, the slots that
    exist hold distinct windows' drtuples, nothing is written past them."""
    p = SketchParams(*cfg)
    tabs = accept_tables(zero_accepted(p, seed=15), cuda)
    nwin, cap = 100_000, 30_000
    c = torch.zeros(nwin + p.kmer_len - 1, dtype=torch.uint8, device=cuda)
    assert _assert_k1_k2_match_plain(c, tabs, p, cap) == nwin
    d, _ = sketch_cuda.sketch_windows(c.cpu().numpy(), p, tabs, capacity=cap)
    assert d.size == nwin and not d.any()


def test_codes_at_an_odd_address(cuda):
    """A code tensor that does not start on a 16-byte boundary takes the
    bytewise staging."""
    p = SketchParams(11, 6, 3)
    tabs = accept_tables(zero_accepted(p, seed=16), cuda)
    codes = random_codes(seed=17, n=200_001, n_invalid=100)
    codes[3000:3500] = 0
    c = torch.from_numpy(codes).to(cuda)[1:]
    assert c.data_ptr() % 16 != 0 and c.is_contiguous()
    _assert_k1_k2_match_plain(c, tabs, p, 1 << 16)


def _write_reads(path: str, codes_rows: np.ndarray) -> None:
    """A fastq of the given reads (rows of base codes, 4 for N)."""
    acgtn = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as f:
        for i, row in enumerate(codes_rows):
            seq = acgtn[np.minimum(row, 4)].tobytes()
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * len(seq)))


@pytest.mark.parametrize("chunk,capacity", [(sketch_cuda.CHUNK_WINDOWS,
                                             None), (3001, None), (3001, 5)])
def test_byread_positions_match_plain(cuda, tmp_path, chunk, capacity):
    """--byread through K1's position channel (and K2's rerun where a
    chunk overflows, positions by nonzero) on the card: the windows and
    stream positions, and the per-read dir, equal the plain versions'."""
    p = SketchParams(8, 5, 2)
    shuf = zero_accepted(p, seed=3)
    rng = np.random.default_rng(4)
    reads = rng.integers(0, 4, size=(600, 120)).astype(np.uint8)
    reads[rng.integers(0, 600, 50), rng.integers(0, 120, 50)] = 4
    reads[200:230] = 0                       # a poly-A block
    fq = str(tmp_path / "r.fq")
    _write_reads(fq, reads)
    codes, _ = seqio.fastq_to_codes(fq)
    got = {}
    for dev in ("cuda", "cpu"):
        tabs = accept_tables(shuf, torch.device(dev))
        dr, pos = sketch.sketch_codes_with_positions(
            codes, shuf, dev, tabs, chunk_windows=chunk, capacity=capacity)
        got[dev] = pairs(dr, pos)
        _build.reset_launches()
        pipeline.sketch_byread(fq, shuf, str(tmp_path / dev), device=dev,
                               chunk_windows=chunk, capacity=capacity)
        if dev == "cuda":
            launches = dict(_build.LAUNCHES)
    assert_pairs_equal(got["cuda"], got["cpu"])
    assert launches["sketch_compact"] >= 1
    assert (launches["sketch_full"] > 0) == (capacity is not None)
    for name in sorted(os.listdir(tmp_path / "cpu")):
        if name.startswith("combco") or name == "cofiles.stat":
            assert (tmp_path / "cuda" / name).read_bytes() == \
                (tmp_path / "cpu" / name).read_bytes(), name


def test_kernel_chain_on_the_card(cuda):
    """``kernel_bench``: a pass's dispatch sums on the card equal those of
    K1's plain version, and ``kernel_chain_mwin`` launches K1 k_reps times
    a pass (an untimed one and ``reps`` timed ones), counted."""
    from metakssd_tpu_torch.ops import kernel_bench
    nwin, k_reps = 1 << 20, 4
    np.testing.assert_array_equal(
        kernel_bench.chain_sums(nwin=nwin, k_reps=k_reps, device=cuda),
        kernel_bench.chain_sums(nwin=nwin, k_reps=k_reps, device="cpu"))
    before = _build.LAUNCHES["sketch_compact"]
    rate = kernel_bench.kernel_chain_mwin(nwin=nwin, k_reps=k_reps, reps=2,
                                          device=cuda)
    assert rate > 0
    assert _build.LAUNCHES["sketch_compact"] == before + 3 * k_reps


@pytest.fixture(scope="module")
def pipeline_case():
    """An L3K11 stream of 6 chunks of 2^20 windows whose chunk 3 holds a
    poly-A block past its capacity, queued behind the clean chunk 2, and
    the chunk loop's (drtuple, position) pairs on the CPU."""
    p = SketchParams(11, 6, 3)
    shuf = zero_accepted(p, seed=21)
    chunk, cap = 1 << 20, 4096
    codes = random_codes(seed=22, n=6 * chunk - 500, n_invalid=300)
    codes[3 * chunk + 100:3 * chunk + 10_100] = 0
    ref = sketch_cuda.sketch_windows(codes, p, accept_tables(shuf, "cpu"),
                                     want_pos=True, chunk_windows=chunk,
                                     capacity=cap)
    return p, shuf, codes, chunk, cap, ref


@pytest.mark.parametrize("devices", [None, ["cuda:0"], ["cuda:0", "cuda:0"]])
def test_pipelined_loop_matches_cpu(cuda, pipeline_case, devices):
    """The pipelined chunk loop on the card: pairs equal the CPU's, K1
    once a chunk and K2 for the overflowing chunk alone, no chunk read
    before the next is queued, at most DEPTH chunks a device queued, and
    no pinned buffer past the first two a card."""
    from metakssd_tpu_torch.probes.chunk_split import checked_run
    p, shuf, codes, chunk, cap, ref = pipeline_case
    tabs = accept_tables(shuf, cuda)
    for _ in range(2):
        checked_run(codes, p, tabs, chunk, cap, devices, ref, reruns=1)
    # a pinned card (--device cuda:0) takes every chunk
    dr = sketch.sketch_codes(codes, shuf, "cuda:0", tabs,
                             chunk_windows=chunk, capacity=cap)
    np.testing.assert_array_equal(dr, np.sort(ref[0]).astype(np.uint64))
