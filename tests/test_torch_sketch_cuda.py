"""The CUDA kernels K1/K2 (metakssd_tpu_torch/csrc/sketch.cu) against
their plain PyTorch versions and the numpy model ``golden``, on a GPU.

Every test here carries the ``cuda`` marker and skips where there is no
CUDA device.  The module imports neither jax nor the JAX package, so on a
GPU machine:

    python -m pytest -m cuda tests/test_torch_sketch_cuda.py
"""

import numpy as np
import pytest
import torch

from metakssd_tpu_torch.ops import golden, sketch, sketch_cuda
from metakssd_tpu_torch.params import SketchParams
from metakssd_tpu_torch.state import accept_tables

from sketch_cases import CONFIGS, assert_pairs_equal, pairs, \
    random_codes, zero_accepted

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
    sketch_cuda.reset_launches()
    dr, pos = sketch.sketch_codes_with_positions(
        codes, shuf, cuda, chunk_windows=30_011, capacity=512)
    assert sketch_cuda.LAUNCHES["sketch_compact"] == 7
    assert sketch_cuda.LAUNCHES["sketch_full"] >= 1
    assert pos.dtype == np.int64
    gdr, gpos = golden.window_drtuples(codes, shuf, return_positions=True)
    assert_pairs_equal(pairs(dr, pos), pairs(gdr, gpos))
