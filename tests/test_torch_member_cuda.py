"""The membership kernel K3 (metakssd_tpu_torch/csrc/member.cu) and its
index build against their plain PyTorch versions, and the port's sketch
search on the card against the same search on the CPU.

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
from metakssd_tpu_torch.formats.costat import CoStat
from metakssd_tpu_torch.formats.shuf import make_shuf
from metakssd_tpu_torch.ops import _build, merge, probe
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
    _build.reset_launches()
    m, val = merge.member(h, v, nd)
    torch.cuda.synchronize()
    # one K3 launch per call with needles; the index it builds for a bare
    # tensor is counted apart
    assert _build.LAUNCHES["member"] == (1 if needles.size else 0)
    assert _build.LAUNCHES["member_index"] == \
        (1 if needles.size and hay.size >= 16 else 0)
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
    """dist search on the card (K3 once per component, not per query)
    writes the distance.out and sharedk_ct.dat of the CPU run, byte for
    byte."""
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
    comps = CoStat.read(ref).comp_num
    assert CoStat.read(qry).ctx_ct.min() > 0
    outs = {}
    for dev in ("cpu", "cuda"):
        _build.reset_launches()
        outs[dev] = str(tmp_path / f"out_{dev}")
        dist.run_dist_search(ref, qry, outs[dev], opts, device=dev)
        want = comps if dev == "cuda" else 0
        assert _build.LAUNCHES["member"] == want
        assert _build.LAUNCHES["member_index"] == want
    for f in ("distance.out", "sharedk_ct.dat"):
        with open(os.path.join(outs["cpu"], f), "rb") as a, \
                open(os.path.join(outs["cuda"], f), "rb") as b:
            data = a.read()
            assert data and data == b.read(), f
    m = np.fromfile(os.path.join(outs["cuda"], "sharedk_ct.dat"),
                    np.uint32).reshape(3, 3)
    assert (m.argmax(axis=1) == np.arange(3)).all()


INDEX_CASES = ["uniform", "clustered", "high_keys", "all_ones",
               "small_keys", "sixteen_keys", "fifteen_keys", "empty"]


def _index_hay(name: str) -> np.ndarray:
    rng = np.random.default_rng(INDEX_CASES.index(name) + 500)
    if name == "uniform":
        return np.unique(_u32(rng, 0, 1 << 32, 2_000_000))
    if name == "clustered":            # 100K keys in one bucket's range
        return np.unique(np.concatenate([
            _u32(rng, 0, 1 << 17, 100_000), _u32(rng, 1 << 30, 1 << 31,
                                                 500_000)]))
    if name == "high_keys":
        return np.unique(_u32(rng, 1 << 31, 1 << 32, 300_000))
    if name == "all_ones":
        return np.append(np.unique(_u32(rng, 0, ALL_ONES, 300_000)),
                         np.uint32(ALL_ONES))
    if name == "small_keys":           # ids below 2^20: top bits all 0
        return np.unique(_u32(rng, 0, 1 << 20, 400_000))
    if name in ("sixteen_keys", "fifteen_keys"):
        return np.unique(_u32(rng, 0, 1 << 32, 16 if name[0] == "s"
                              else 15))
    return np.zeros(0, np.uint32)


@pytest.mark.parametrize("buckets", [None, 2048, "densest"])
@pytest.mark.parametrize("name", INDEX_CASES)
def test_index_kernel_matches_plain(cuda, name, buckets):
    """mkssd_member_index equals build_index_plain and numpy's lower
    bounds of the bucket boundaries, at K3's rule (no table below 16
    keys), at 2048 buckets (the probe's exact search on 4096 keys; a
    haystack under 2049 keys refuses it) and at the densest count each
    haystack takes (``probe.exact_buckets``); one launch where there is
    a table."""
    hay = _index_hay(name)
    h = merge.u32_tensor(hay).to(cuda)
    if buckets == "densest":
        buckets = probe.exact_buckets(hay.size)
    _build.reset_launches()
    if buckets is not None and buckets + 1 > hay.size:
        with pytest.raises(ValueError, match="buckets"):
            merge.build_index(h, buckets=buckets)
        with pytest.raises(ValueError, match="buckets"):
            merge.build_index_plain(h, buckets)
        assert _build.LAUNCHES["member_index"] == 0
        return
    ix = merge.build_index(h, buckets=buckets)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["member_index"] == (1 if ix.nb else 0)
    assert _build.LAUNCHES["member"] == 0
    plain = merge.build_index_plain(h, buckets)
    assert (ix.nb, ix.shift) == (plain.nb, plain.shift)
    assert torch.equal(ix.table, plain.table)
    if buckets is None:
        assert (ix.nb == 0) == (hay.size < 16)
    else:
        assert ix.nb == buckets
    if ix.nb:
        bounds = np.arange(ix.nb, dtype=np.uint64) << np.uint64(ix.shift)
        want = np.append(np.searchsorted(hay.astype(np.uint64), bounds),
                         hay.size)
        np.testing.assert_array_equal(
            ix.table.cpu().numpy().view(np.uint32), want)


SHAPES = ["dist_batch", "set_runs", "big_wide", "skewed", "staged"]


def _shape(name: str):
    """(haystack, values, needles) uint32 of the shapes dist -r and set
    -s/-i give K3, at small sizes."""
    rng = np.random.default_rng(SHAPES.index(name) + 600)
    hay = np.unique(_u32(rng, 0, ALL_ONES, 400_000))

    def run(n, hit_share):
        k = int(n * hit_share)
        return np.sort(np.concatenate([rng.choice(hay, k),
                                       _u32(rng, 0, ALL_ONES, n - k)]))
    if name == "dist_batch":            # 32 queries of 4096 sorted ids
        needles = np.concatenate([run(4096, 0.5) for _ in range(32)])
    elif name == "set_runs":            # genomes of about 1,024 sorted ids
        needles = np.concatenate([run(int(n), 0.94) for n in
                                  rng.integers(900, 1150, 300)])
    elif name == "big_wide":            # 4M keys, random needle order
        hay = np.unique(_u32(rng, 0, 1 << 32, 4_200_000))
        needles = rng.permutation(run(300_000, 0.5))
    elif name == "skewed":              # one bucket of about 100K keys
        hay = np.unique(np.concatenate([
            _u32(rng, 0, 1 << 17, 200_000), _u32(rng, 1 << 31, 1 << 32,
                                                 200_000)]))
        needles = np.concatenate([run(50_000, 0.5), np.sort(
            _u32(rng, 0, 1 << 17, 30_000))])
    else:                               # dense sorted needles: staged blocks
        needles = run(400_000, 0.5)
    return hay, _u32(rng, 0, 1 << 32, hay.size), needles


@pytest.mark.parametrize("identity", [False, True])
@pytest.mark.parametrize("name", SHAPES)
def test_member_shapes_reuse_one_index(cuda, name, identity):
    """K3 on the search and set shapes, through one StaticHaystack: equal
    to member_plain and numpy on every call, and the index built once
    for all of them."""
    hay, values, needles = _shape(name)
    _build.reset_launches()
    sh = merge.StaticHaystack(hay, None if identity else values, cuda)
    assert _build.LAUNCHES["member_index"] == 1
    if name == "skewed":
        sizes = np.diff(sh.index.table.cpu().numpy().view(np.uint32)
                        .astype(np.int64))
        assert sizes.max() > 90_000
    em, ev = _numpy_membership(hay, None if identity else values, needles)
    halves = np.array_split(np.arange(needles.size), 3)
    for part in halves + [np.arange(needles.size)]:
        nd = merge.u32_tensor(needles[part]).to(cuda)
        m, val = merge.member(sh.hay, sh.values, nd, sh.index)
        pm, pv = merge.member_plain(sh.hay, sh.values, nd)
        torch.cuda.synchronize()
        assert torch.equal(m, pm) and torch.equal(val, pv)
        np.testing.assert_array_equal(m.cpu().numpy().astype(bool),
                                      em[part])
        np.testing.assert_array_equal(val.cpu().numpy().view(np.uint32),
                                      ev[part])
    assert _build.LAUNCHES["member"] == len(halves) + 1
    assert _build.LAUNCHES["member_index"] == 1
    assert em.any() and not em.all()


@pytest.mark.parametrize("max_needles", [None, 1000])
def test_shard_match_cuda_matches_cpu(cuda, monkeypatch, max_needles):
    """``ShardedMatchIndex.match`` (``--shard-db 1``) on the card equals
    its CPU run: the same postings' genomes and abundances, 0xFFFFFFFF
    matched where the distinct k-mers hold it, keys >= 2^31; K3 launches
    once per call of at most MAX_NEEDLES ids, the index once per
    component."""
    from metakssd_tpu_torch.parallel import mesh as pmesh
    if max_needles:
        monkeypatch.setattr(pmesh, "MAX_NEEDLES", max_needles)
    rng = np.random.default_rng(17)
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
    got = {}
    for dev in ("cpu", "cuda"):
        _build.reset_launches()
        ix = pmesh.ShardedMatchIndex(rk, starts, gid, dev)
        got[dev] = ix.match(q, ab)
        launches = dict(_build.LAUNCHES)
    calls = -(-q.size // (max_needles or q.size))
    assert launches["member"] == calls and launches["member_index"] == 1
    for a, b in zip(got["cuda"], got["cpu"]):
        np.testing.assert_array_equal(a, b)
    assert got["cpu"][0].size > 6000
    # the posting rows of 0xFFFFFFFF (the last key) are among the matches
    last = gid[starts[-2]:starts[-1]]
    assert np.isin(last, got["cuda"][0][got["cuda"][1] == ab[-1]]).all()


LAUNCHES = ["rule", "blocks", "groups"]
COUNTS = [1, 15, 16, 17, 1023, 1024, 1025, 5636,
          merge.GROUPS_MAX_NEEDLES - 1, merge.GROUPS_MAX_NEEDLES,
          merge.GROUPS_MAX_NEEDLES + 1]


def _profile_hay():
    """Like the haystack of profile --shard-db 1 (249,105 keys, about 15
    a bucket), 0xFFFFFFFF included."""
    rng = np.random.default_rng(650)
    hay = np.unique(_u32(rng, 0, ALL_ONES, 249_200))[:249_104]
    return np.append(hay, np.uint32(ALL_ONES)), rng


@pytest.mark.parametrize("launch", LAUNCHES)
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("identity", [False, True])
def test_small_counts_both_launches(cuda, identity, order, launch):
    """K3 at needle counts around a block's 1024, the profile's 5,636 and
    the launch threshold, over a profile-like haystack through its
    index: each launch (and the rule's choice) equals member_plain and
    numpy, 0xFFFFFFFF a member, one K3 launch a call."""
    hay, rng = _profile_hay()
    values = _u32(rng, 0, 1 << 32, hay.size)
    sh = merge.StaticHaystack(hay, None if identity else values, cuda)
    for n in COUNTS:
        x = np.concatenate([rng.choice(hay, n - n // 3),
                            _u32(rng, 0, ALL_ONES, n // 3)])
        x[rng.integers(0, n)] = ALL_ONES
        x = np.sort(x)
        if order == "shuffled":
            x = rng.permutation(x)
        nd = merge.u32_tensor(x).to(cuda)
        _build.reset_launches()
        m, val = merge.member(sh.hay, sh.values, nd, sh.index,
                              None if launch == "rule" else launch)
        pm, pv = merge.member_plain(sh.hay, sh.values, nd)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["member"] == 1, n
        took = merge.member_launch(n) if launch == "rule" else launch
        assert _build.LAUNCHES["member_groups"] == \
            (took == "groups"), (n, launch)
        assert torch.equal(m, pm) and torch.equal(val, pv), (n, launch)
        em, ev = _numpy_membership(hay, None if identity else values, x)
        np.testing.assert_array_equal(m.cpu().numpy().astype(bool), em)
        np.testing.assert_array_equal(val.cpu().numpy().view(np.uint32), ev)
        assert em[x == ALL_ONES].all()


def test_launch_rule_matches_kernel(cuda):
    """merge.member_launch is mkssd_member_launch, needle for needle,
    around the threshold and at the shapes PERF.md times."""
    lib = _build.library()
    t = merge.GROUPS_MAX_NEEDLES
    for n in (1, 5636, t - 1, t, t + 1, 128 * 4096, 1 << 20, 1_000_033,
              65_600 * 1024):
        code = lib.mkssd_member_launch(n)
        assert code == merge.K3_LAUNCH_CODES[merge.member_launch(n)], n


@pytest.mark.parametrize("launch", ["blocks", "groups"])
@pytest.mark.parametrize("name", CASES + SHAPES)
def test_each_launch_on_every_case(cuda, name, launch):
    """Both launches, forced, on the edge cases and the search and set
    shapes (which the rule sends to one launch or the other), in both
    modes: equal to member_plain."""
    hay, values, needles = _case(name) if name in CASES else _shape(name)
    h = merge.u32_tensor(hay).to(cuda)
    nd = merge.u32_tensor(needles).to(cuda)
    ix = merge.build_index(h) if hay.size else None
    for v in (None, merge.u32_tensor(values).to(cuda)):
        m, val = merge.member(h, v, nd, ix, launch)
        pm, pv = merge.member_plain(h, v, nd)
        torch.cuda.synchronize()
        assert torch.equal(m, pm) and torch.equal(val, pv), (name, launch)
