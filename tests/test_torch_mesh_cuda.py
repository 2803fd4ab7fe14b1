"""The port's shards (``metakssd_tpu_torch/parallel/mesh.py``) on the card
against the same shards on the CPU: ``sharded_sketch`` over N data shards
(K1 on each, K2 where a chunk overflows), ``ShardedMatchIndex`` and
``sharded_shared_counts`` over N db shards (K3 on each), and
``device_union`` over N data shards.

Every test here carries the ``cuda`` marker and skips where there is no
CUDA device.  The module imports neither jax nor the JAX package, so on a
GPU machine:

    python -m pytest -m cuda tests/test_torch_mesh_cuda.py
"""

import numpy as np
import pytest
import torch

from metakssd_tpu_torch.formats.codir import write_codir
from metakssd_tpu_torch.formats.costat import CoStat
from metakssd_tpu_torch.formats.shuf import make_shuf
from metakssd_tpu_torch.ops import sketch, sketch_cuda
from metakssd_tpu_torch.params import SketchParams
from metakssd_tpu_torch.parallel import mesh

pytestmark = pytest.mark.cuda

ALL_ONES = 0xFFFFFFFF


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _u32(rng, lo, hi, n):
    return rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cfg", [(11, 6, 3), (8, 5, 2)])
def test_sharded_sketch_cuda_matches_cpu(cuda, n, cfg):
    """N shards of a 2M-window stream with a poly-A block, at a capacity
    of 16 kept windows a chunk, so chunks overflow into K2: the one-device
    sketch on the CPU; K1 launches for every shard's chunk."""
    rng = np.random.default_rng(31)
    shuf = make_shuf(SketchParams(*cfg), seed=32)
    codes = rng.integers(0, 4, 2_000_000).astype(np.uint8)
    codes[rng.integers(0, codes.size, 1000)] = 255
    codes[700_000:760_000] = 0
    kw = {"chunk_windows": 1 << 18, "capacity": 16}
    sketch_cuda.reset_launches()
    got = mesh.sharded_sketch(codes, shuf, mesh.make_mesh(n, 1, cuda), **kw)
    launches = dict(sketch_cuda.LAUNCHES)
    want = sketch.sketch_codes(codes, shuf, "cpu")
    np.testing.assert_array_equal(got, want)
    assert launches["sketch_compact"] >= n
    assert launches["sketch_full"] >= 1


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_match_index_cuda_matches_cpu(cuda, n):
    """N db slices on the card: the CPU's answer (0xFFFFFFFF matched,
    keys >= 2^31), one K3 launch and one index build per slice."""
    rng = np.random.default_rng(41)
    rk = np.unique(_u32(rng, 0, 1 << 32, 200_000))
    rk[-1] = ALL_ONES
    lens = rng.integers(1, 5, rk.size)
    starts = np.zeros(rk.size + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    gid = rng.integers(0, 300, int(starts[-1])).astype(np.int32)
    q = np.unique(np.concatenate([rng.choice(rk, 6000),
                                  _u32(rng, 0, 1 << 32, 6000),
                                  np.array([ALL_ONES], np.uint32)]))
    ab = rng.integers(1, 1000, q.size).astype(np.uint16)
    sketch_cuda.reset_launches()
    ix = mesh.ShardedMatchIndex(rk, starts, gid, mesh.make_mesh(1, n, cuda))
    got = ix.match(q, ab)
    launches = dict(sketch_cuda.LAUNCHES)
    want = mesh.ShardedMatchIndex(rk, starts, gid, "cpu").match(q, ab)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert launches["member"] == n and launches["member_index"] == n
    last = gid[starts[-2]:starts[-1]]        # the rows of 0xFFFFFFFF
    assert np.isin(last, got[0][got[1] == ab[-1]]).all()


def _codir(path, rows, koc=False):
    ctx = np.array([sum(x.size for x, _ in g) for g in rows], np.uint32)
    write_codir(path, CoStat(9, koc, 16, 4, len(rows[0]), int(ctx.sum()),
                             ctx, [f"g{i}" for i in range(len(rows))]), rows)


def test_sharded_shared_counts_cuda_matches_cpu(cuda, tmp_path):
    """4 db shards and 2 x 2 shards on the card: the counts of one shard
    on the CPU (duplicated query k-mers, keys >= 2^31); K3 runs."""
    rng = np.random.default_rng(51)
    pool = np.unique(_u32(rng, 0, 1 << 32, 40_000))
    ref = [[(np.unique(rng.choice(pool, 3000)), None) for _ in range(2)]
           for _ in range(30)]
    qry = [[(np.sort(np.concatenate([x, x[::3]])), None)
            for x in (rng.choice(pool, 2000), rng.choice(pool, 500))]
           for _ in range(5)]
    _codir(str(tmp_path / "ref"), ref)
    _codir(str(tmp_path / "qry"), qry)
    want = mesh.sharded_shared_counts(str(tmp_path / "ref"),
                                      str(tmp_path / "qry"), "cpu")
    assert want.max() > 0
    for layout in ((1, 4), (2, 2)):
        sketch_cuda.reset_launches()
        got = mesh.sharded_shared_counts(str(tmp_path / "ref"),
                                         str(tmp_path / "qry"),
                                         mesh.make_mesh(*layout, cuda))
        np.testing.assert_array_equal(got, want)
        assert sketch_cuda.LAUNCHES["member"] > 0


def test_device_union_cuda_over_shards(cuda):
    """Two data shards on the card: np.unique's values and counts."""
    rng = np.random.default_rng(61)
    ids = np.concatenate([_u32(rng, 0, 1 << 32, 300_000),
                          _u32(rng, 0, 5000, 100_000),
                          np.full(3, ALL_ONES, np.uint32)])
    v, c = mesh.device_union(ids, mesh.make_mesh(2, 1, cuda),
                             return_counts=True)
    wv, wc = np.unique(ids, return_counts=True)
    np.testing.assert_array_equal(v, wv)
    np.testing.assert_array_equal(c, wc)
