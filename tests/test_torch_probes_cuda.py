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
from metakssd_tpu_torch.ops import probe, sketch_cuda
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
            before = sketch_cuda.LAUNCHES[v.kernel]
            got = v.run(t)
            assert sketch_cuda.LAUNCHES[v.kernel] == before + 1, v.name
            torch.cuda.synchronize()
            assert torch.equal(got, v.plain(t)), v.name


@pytest.mark.parametrize("dtype", [torch.int32, torch.int8, torch.uint16])
@pytest.mark.parametrize("op", ["sum", "xor", "none"])
def test_floor_row_ranges(cuda, dtype, op):
    """Ranges that start and end inside the kernel's 128-row parts, with
    values that wrap the int32 sum (int32) or use the sign bit (int8) or
    the top bit (uint16)."""
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
    for row0, row1 in ((0, 300), (3, 203), (130, 131), (0, 8)):
        assert torch.equal(probe.floor(t, row0, row1, op),
                           probe.floor_plain(t, row0, row1, op))


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


@pytest.mark.parametrize("cfg", [(11, 6, 3), (5, 3, 1), (8, 5, 2)])
@pytest.mark.parametrize("use_sig", [False, True])
def test_search_configs(cuda, cfg, use_sig):
    """Exact and signature search at three configs, one of which keeps a
    window in 16, on tiles with invalid codes."""
    p = SketchParams(*cfg)
    a_tups = make_shuf(p, seed=7).device_tables()[0]
    TL = p.kmer_len
    rng = np.random.default_rng(8)
    tiles = torch.from_numpy(rng.integers(0, 5, (3, 256 + TL, 128))
                             .astype(np.int32)).to(cuda)
    if use_sig:
        kw = {"lev": torch.from_numpy(probe.bfs_levels(a_tups)
                                      .view(np.int32)).to(cuda),
              "sig": torch.from_numpy(np.ascontiguousarray(
                  probe.sig_tables(a_tups)).view(np.int32)).to(cuda)}
    else:
        kw = {"accept": torch.from_numpy(a_tups.view(np.int32)).to(cuda)}
    got = probe.search(tiles, 250, *cfg, **kw)
    assert torch.equal(got, probe.search_plain(tiles, 250, *cfg, **kw))
