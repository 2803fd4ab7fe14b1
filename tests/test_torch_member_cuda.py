"""The membership kernel K3 (metakssd_tpu_torch/csrc/member.cu) against its
plain PyTorch version, and the port's sketch search on the card against
the same search on the CPU.

Every test here carries the ``cuda`` marker and skips where there is no
CUDA device.  The module imports neither jax nor the JAX package, so on a
GPU machine:

    python -m pytest -m cuda tests/test_torch_member_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from metakssd_tpu_torch import dist, pipeline
from metakssd_tpu_torch.formats.shuf import make_shuf
from metakssd_tpu_torch.ops import merge, sketch_cuda
from metakssd_tpu_torch.params import SketchParams

pytestmark = pytest.mark.cuda

ALL_ONES = 0xFFFFFFFF
CASES = ["random", "clustered", "n1", "n100", "n2047", "no_needles",
         "empty_haystack", "all_ones_present", "all_ones_absent",
         "unsorted"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _u32(rng, lo, hi, n):
    return rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32)


def _case(name: str):
    """(haystack, values, needles) uint32, from a numpy seed: the cases
    of chip_smoke.py's kernel phase at small sizes."""
    rng = np.random.default_rng(CASES.index(name) + 200)
    hay = np.unique(_u32(rng, 0, ALL_ONES, 70_000))   # keys >= 2^31 too
    if name == "clustered":
        # a dense run: the first needle blocks span more haystack entries
        # than the kernel stages in shared memory
        hay = np.unique(np.concatenate(
            [_u32(rng, 0, 1 << 17, 100_000), _u32(rng, 1 << 30, 1 << 31,
                                                  50_000)]))
        needles = np.concatenate([_u32(rng, 0, 1 << 17, 3000),
                                  rng.choice(hay, 5000)])
    elif name.startswith("n"):
        size = {"n1": 1, "n100": 100, "n2047": 2047, "no_needles": 0}[name]
        needles = np.concatenate([rng.choice(hay, size // 2),
                                  _u32(rng, 0, ALL_ONES, size - size // 2)])
    elif name == "empty_haystack":
        hay = np.zeros(0, np.uint32)
        needles = _u32(rng, 0, ALL_ONES, 3000)
    elif name.startswith("all_ones"):
        if name == "all_ones_present":
            hay = np.append(hay, np.uint32(ALL_ONES))
        needles = np.concatenate([rng.choice(hay, 3000),
                                  np.full(5, ALL_ONES, np.uint32)])
    else:                                  # random, unsorted
        hits = rng.choice(hay, 8000)       # duplicates included
        needles = np.concatenate([hits, hits[:1000],
                                  _u32(rng, 0, ALL_ONES, 8000)])
    needles = np.sort(needles.astype(np.uint32))
    if name == "unsorted":
        needles = rng.permutation(needles)
    values = _u32(rng, 0, 1 << 32, hay.size)
    return hay, values, needles


def _numpy_membership(hay, values, needles):
    if hay.size == 0:
        return np.zeros(needles.size, bool), np.zeros(needles.size,
                                                      np.uint32)
    pos = np.minimum(np.searchsorted(hay, needles), hay.size - 1)
    m = hay[pos] == needles
    val = pos.astype(np.uint32) if values is None else values[pos]
    return m, np.where(m, val, 0).astype(np.uint32)


@pytest.mark.parametrize("identity", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_member_matches_plain(cuda, name, identity):
    """K3 equals its plain version on the same CUDA tensors, and both
    equal numpy's searchsorted semantics; one launch per call with
    needles, none without."""
    hay, values, needles = _case(name)
    h = merge.u32_tensor(hay).to(cuda)
    v = None if identity else merge.u32_tensor(values).to(cuda)
    nd = merge.u32_tensor(needles).to(cuda)
    sketch_cuda.reset_launches()
    m, val = merge.member(h, v, nd)
    torch.cuda.synchronize()
    assert sketch_cuda.LAUNCHES["member"] == (1 if needles.size else 0)
    pm, pv = merge.member_plain(h, v, nd)
    assert torch.equal(m, pm) and torch.equal(val, pv)
    em, ev = _numpy_membership(hay, None if identity else values, needles)
    np.testing.assert_array_equal(m.cpu().numpy().astype(bool), em)
    np.testing.assert_array_equal(val.cpu().numpy().view(np.uint32), ev)
    if name == "all_ones_present":
        assert em[needles == ALL_ONES].all()


def _write_fasta(path, seq_codes):
    with open(path, "wb") as f:
        f.write(b">g\n" + np.frombuffer(b"ACGT", np.uint8)[seq_codes]
                .tobytes() + b"\n")


def test_search_cuda_matches_cpu(cuda, tmp_path):
    """dist search on the card (K3 once per query) writes the
    distance.out and sharedk_ct.dat of the CPU run, byte for byte."""
    rng = np.random.default_rng(5)
    shuf = make_shuf(SketchParams(k=8, subk=5, drlevel=2), seed=6)
    genomes = [rng.integers(0, 4, 600_000) for _ in range(3)]
    gpaths, qpaths = [], []
    for i, g in enumerate(genomes):
        gpaths.append(str(tmp_path / f"g{i}.fa"))
        _write_fasta(gpaths[-1], g)
        q = g.copy()
        hit = rng.random(q.size) < 0.02 * i
        q[hit] = (q[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
        qpaths.append(str(tmp_path / f"q{i}.fa"))
        _write_fasta(qpaths[-1], q)
    ref, qry = str(tmp_path / "ref"), str(tmp_path / "qry")
    pipeline.run_stage1(gpaths, shuf, ref, device=cuda)
    pipeline.run_stage1(qpaths, shuf, qry, device=cuda)
    opts = dist.DistOptions(keep_shared_kmer=True)
    outs = {}
    for dev in ("cpu", "cuda"):
        sketch_cuda.reset_launches()
        outs[dev] = str(tmp_path / f"out_{dev}")
        dist.run_dist_search(ref, qry, outs[dev], opts, device=dev)
        assert sketch_cuda.LAUNCHES["member"] == (3 if dev == "cuda" else 0)
    for f in ("distance.out", "sharedk_ct.dat"):
        with open(os.path.join(outs["cpu"], f), "rb") as a, \
                open(os.path.join(outs["cuda"], f), "rb") as b:
            data = a.read()
            assert data and data == b.read(), f
    m = np.fromfile(os.path.join(outs["cuda"], "sharedk_ct.dat"),
                    np.uint32).reshape(3, 3)
    assert (m.argmax(axis=1) == np.arange(3)).all()
