"""The CUDA probe kernels P1-P4 (metakssd_tpu_torch/csrc/probe.cu) against
their plain PyTorch versions, on a GPU, exactly.

Every test here carries the ``cuda`` marker and skips where there is no
CUDA device.  The module imports neither jax nor the JAX package, so on a
GPU machine:

    python -m pytest -m cuda tests/test_torch_probes_cuda.py
"""

import numpy as np
import pytest
import torch

from metakssd_tpu_torch.formats.shuf import make_shuf
from metakssd_tpu_torch.ops import _build, merge, probe
from metakssd_tpu_torch.params import SketchParams
from metakssd_tpu_torch.probes import (probe_floor_chunk, probe_floor_noread,
                                       probe_kernel_cost, probe_r4)

pytestmark = pytest.mark.cuda

MODULES = [probe_kernel_cost, probe_r4, probe_floor_chunk,
           probe_floor_noread]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _noisy(t: torch.Tensor, seed: int) -> torch.Tensor:
    """t XOR random values in [0, 8): about half the codes invalid."""
    noise = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 8, tuple(t.shape)).astype(np.int64)).to(t.device)
    return (t.to(torch.int64) ^ noise).to(t.dtype)


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m.__name__[-20:])
def test_variants_match_plain(cuda, mod):
    """Every variant of a probe module at 2^20 windows: the kernel equals
    the plain version on its input and on a noisy copy, and each wrapper
    call counts one launch of its kernel."""
    for v in mod.variants(cuda, nwin=1 << 20):
        if v.plain is None:
            continue
        for t in (v.tiles, _noisy(v.tiles, 1)):
            before = _build.LAUNCHES[v.kernel]
            got = v.run(t)
            assert _build.LAUNCHES[v.kernel] == before + 1, v.name
            torch.cuda.synchronize()
            assert torch.equal(got, v.plain(t)), v.name


@pytest.mark.parametrize("reduce", ["ticket", "atomic"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int8, torch.uint16])
@pytest.mark.parametrize("op", ["sum", "xor", "none"])
def test_floor_row_ranges(cuda, monkeypatch, dtype, op, reduce):
    """Ranges that start and end inside the kernel's 128-row parts and
    inside the rows a warp's 16-byte loads cover (4 at int8, 2 at
    uint16), in both reduce modes, with values that wrap the int32 sum
    (int32) or use the sign bit (int8) or the top bit (uint16); int8 and
    uint16 tiles one element off a 16-byte boundary are refused."""
    monkeypatch.setattr(probe, "REDUCE", dict.fromkeys(probe.REDUCE, reduce))
    rng = np.random.default_rng(2)
    if dtype == torch.int32:
        base = rng.integers(-2**31, 2**31, (3, 300, 128), dtype=np.int64)
        t = torch.from_numpy(base.astype(np.int32)).to(cuda)
    elif dtype == torch.int8:
        t = torch.from_numpy(rng.integers(-128, 128, (3, 300, 128))
                             .astype(np.int8)).to(cuda)
    else:
        t = torch.from_numpy(rng.integers(0, 1 << 16, (3, 300, 128))
                             .astype(np.uint16)).to(cuda)
    for row0, row1 in ((0, 300), (3, 203), (130, 131), (0, 8), (1, 299),
                       (5, 138), (0, 7), (2, 5), (129, 262)):
        assert torch.equal(probe.floor(t, row0, row1, op),
                           probe.floor_plain(t, row0, row1, op)), \
            (row0, row1)
    if dtype != torch.int32 and op != "none":
        big = torch.zeros(t.numel() + 64, dtype=dtype, device=cuda)
        off = (-big.data_ptr() % 16) // big.element_size() + 1
        bad = big[off:off + t.numel()].view(t.shape)
        bad.copy_(t)
        before = _build.LAUNCHES["probe_floor"]
        with pytest.raises(ValueError, match="16-byte"):
            probe.floor(bad, 0, 300, op)
        assert _build.LAUNCHES["probe_floor"] == before


@pytest.mark.parametrize("TL", [1, 10, 22, 31, 32])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int8])
def test_winmath_tuple_lengths(cuda, TL, dtype):
    """From one base to 32 (a 64-bit tuple), window rows not a multiple
    of the kernel's 32-row runs, codes up to 7."""
    rng = np.random.default_rng(TL)
    t = torch.from_numpy(rng.integers(0, 8, (2, 200 + TL, 128))
                         .astype(np.int32)).to(cuda).to(dtype)
    assert torch.equal(probe.winmath(t, 197, TL),
                       probe.winmath_plain(t, 197, TL))


@pytest.mark.parametrize("size,mult", [(4096, 683), (128, 37), (16, 5)])
@pytest.mark.parametrize("u16", [False, True])
def test_gather_tables(cuda, size, mult, u16):
    rng = np.random.default_rng(size)
    tiles = torch.from_numpy(rng.integers(-50, 50, (2, 140, 128))
                             .astype(np.int32)).to(cuda)
    if u16:
        tab = torch.from_numpy(rng.integers(0, 1 << 16, 4096)
                               .astype(np.uint16)).to(cuda)
    else:
        tab = torch.from_numpy(rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
                               .astype(np.uint32).view(np.int32)).to(cuda)
    for ng in (0, 1, 30):
        assert torch.equal(probe.gather(tiles, 139, tab, size, mult, ng),
                           probe.gather_plain(tiles, 139, tab, size, mult, ng))


def _window_dims(tiles: torch.Tensor, nrows: int, p) -> np.ndarray:
    """The distinct dims of the valid windows of the first nrows rows."""
    hi, lo, invalid = probe._tuples(tiles.cpu(), nrows, p.kmer_len)
    outctx = p.k - p.subk
    dim = ((hi << 32 | lo) >> (2 * outctx)) & ((1 << (4 * p.subk)) - 1)
    return np.unique(dim[~invalid].numpy())


def _accept_table(p, table: str, seen: np.ndarray) -> np.ndarray:
    """The config's accept table, or a sorted table over its dims that
    holds 0, the largest dim and some of the tiles' window dims ``seen``:
    with most keys in one bucket of K3's index ("skewed"), or 11 keys,
    below K3's 16 ("few"); or 301 keys all below half the largest dim
    ("low"), so that the windows above them take buckets past nb."""
    a_tups = make_shuf(p, seed=7).device_tables()[0]
    if table == "shuffle":
        return a_tups
    top = (1 << (4 * p.subk)) - 1
    rng = np.random.default_rng(9)
    if table == "low":
        keys = rng.choice(seen[seen <= top >> 1], 300, replace=False)
        return np.unique(np.append(keys, 0).astype(np.uint32))
    keys = rng.choice(seen, 9 if table == "few" else 500, replace=False)
    if table == "skewed":         # a dense run of dims in one bucket
        lo = int(seen[seen.size // 2]) & ~0xFFF
        keys = np.concatenate([keys, np.arange(lo, min(lo + 3000, top))])
    return np.unique(np.concatenate([keys, [0, top]]).astype(np.uint32))


@pytest.mark.parametrize("cfg", [(11, 6, 3), (5, 3, 1), (8, 5, 2)])
@pytest.mark.parametrize("form", ["sig", "exact", "exact densest",
                                  "exact k3", "skewed densest", "skewed k3",
                                  "few densest", "few k3", "low densest",
                                  "low k3"])
def test_search_configs(cuda, cfg, form):
    """Exact and signature search at three configs, one of which keeps a
    window in 16, on tiles with invalid codes.  The exact form runs
    without an index (the wrapper builds one) and with one built at each
    density, on the config's accept table, on a skewed one (a run of 3000
    dims in one bucket), on one of 11 keys and on one whose keys all lie
    below half the dims (windows past its last bucket), those three
    holding some of the tiles' window dims; each equals the plain
    version, and a call with an index launches the search alone."""
    p = SketchParams(*cfg)
    table, _, density = form.partition(" ")
    rng = np.random.default_rng(8)
    tiles = torch.from_numpy(rng.integers(0, 5, (3, 256 + p.kmer_len, 128))
                             .astype(np.int32)).to(cuda)
    dims = _window_dims(tiles, 250, p)
    a_tups = _accept_table(p, "shuffle" if table in ("sig", "exact")
                           else table, dims)
    if table == "sig":
        kw = {"lev": torch.from_numpy(probe.bfs_levels(a_tups)
                                      .view(np.int32)).to(cuda),
              "sig": torch.from_numpy(np.ascontiguousarray(
                  probe.sig_tables(a_tups)).view(np.int32)).to(cuda)}
    else:
        kw = {"accept": torch.from_numpy(a_tups.view(np.int32)).to(cuda)}
        if density:
            kw["index"] = probe.exact_index(kw["accept"]) \
                if density == "densest" else merge.build_index(kw["accept"])
    want = probe.search_plain(tiles, 250, *cfg,
                              **{k: v for k, v in kw.items()
                                 if k != "index"})
    before = dict(_build.LAUNCHES)
    got = probe.search(tiles, 250, *cfg, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want), form
    assert _build.LAUNCHES["probe_search"] == \
        before["probe_search"] + 1
    built = _build.LAUNCHES["member_index"] - before["member_index"]
    assert built == (table == "exact" and not density), form
    if table in ("skewed", "few", "low"):
        assert (want != 0).any(), "no window hit the table"
    if table == "low":            # the kernel's b >= nb branch ran
        ix = kw["index"]
        assert ix.nb and ((dims >> ix.shift) >= ix.nb).any(), form


@pytest.mark.parametrize("nb,rows", [(40, 100), (40, 1000), (600, 300),
                                     (200, 1000)])
def test_floor_is_one_launch(cuda, nb, rows):
    """A floor dispatch is one launch, counted once: its result comes out
    right on memory that held other values (nothing zeroes it), with one
    128-row part per tile block, with eight parts in eight blocks, whose
    tickets must be reset for the next launch (twenty dispatches in a
    row, a winmath between, and replays of a CUDA graph), and with blocks
    that take several parts (so many tile blocks that each gets one block,
    or a few); where the profiler traces the card, it sees one kernel and
    nothing else."""
    rng = np.random.default_rng(rows)
    t = torch.from_numpy(rng.integers(-2**31, 2**31, (nb, rows + 32, 128))
                         .astype(np.int32)).to(cuda)
    want = {op: probe.floor_plain(t, 0, rows, op) for op in ("sum", "xor")}
    junk = torch.full((nb, 1, 128), 12345, dtype=torch.int32, device=cuda)
    del junk                     # the allocator hands this block out next
    before = _build.LAUNCHES["probe_floor"]
    for i in range(20):
        op = ("sum", "xor")[i % 2]
        assert torch.equal(probe.floor(t, 0, rows, op), want[op]), i
        if i == 10:
            assert torch.equal(probe.winmath(t, rows, 22),
                               probe.winmath_plain(t, rows, 22))
    assert _build.LAUNCHES["probe_floor"] == before + 20

    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = probe.floor(t, 0, rows, "sum")
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want["sum"])

    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        probe.floor(t, 0, rows, "sum")
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if on_card:
        assert len(on_card) == 1 and "floor" in on_card[0], on_card


@pytest.mark.parametrize("reduce", ["ticket", "atomic"])
def test_reduce_modes_match_plain(cuda, monkeypatch, reduce):
    """Each kernel in each way of combining the blocks of a tile block,
    at shapes of one and of several 128-row parts, on two streams that
    run at the same time (each keeps its own ticket counters), equals its
    plain version."""
    monkeypatch.setattr(probe, "REDUCE", dict.fromkeys(probe.REDUCE, reduce))
    rng = np.random.default_rng(11)
    p = SketchParams(11, 6, 3)
    accept = torch.from_numpy(make_shuf(p, seed=7).device_tables()[0]
                              .view(np.int32)).to(cuda)
    tab = torch.from_numpy(rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
                           .astype(np.uint32).view(np.int32)).to(cuda)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for nb, rows in ((5, 100), (70, 1000), (300, 520)):
        t = torch.from_numpy(rng.integers(0, 4, (nb, rows + 22, 128))
                             .astype(np.int32)).to(cuda)
        narrow = [torch.from_numpy(rng.integers(-128, 128, t.shape)
                                   .astype(np.int8)).to(cuda),
                  torch.from_numpy(rng.integers(0, 1 << 16, t.shape)
                                   .astype(np.uint16)).to(cuda)]
        calls = [("floor", (0, rows, "sum"), {}),
                 ("floor", (3, rows, "xor"), {}),
                 ("winmath", (rows, 22), {}),
                 ("gather", (rows, tab, 4096, 33, 5), {}),
                 ("search", (rows, 11, 6, 3), {"accept": accept})]
        # the int8 and uint16 floors: both ops, rows not a multiple of 4
        calls = [(t, f, a, kw) for f, a, kw in calls] + [
            (x, "floor", (r0, rows - 1, op), {}) for x in narrow
            for r0, op in ((0, "sum"), (3, "xor"))]
        want = [getattr(probe, f + "_plain")(x, *a, **kw)
                for x, f, a, kw in calls]
        torch.cuda.synchronize()
        got = [[], []]
        for _ in range(3):
            for s, out in zip(streams, got):
                with torch.cuda.stream(s):
                    out.extend(getattr(probe, f)(x, *a, **kw)
                               for x, f, a, kw in calls)
        torch.cuda.synchronize()
        for out in got:
            for i, g in enumerate(out):
                assert torch.equal(g, want[i % len(calls)]), \
                    (nb, rows, i)
