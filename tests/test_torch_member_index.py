"""K3's search index and its indexed formulation
(``metakssd_tpu_torch/ops/merge.py``) against numpy and the JAX package,
exactly, on the CPU; and the search and set paths that reuse one index
per component against the JAX CLI, byte for byte.

* ``build_index`` (its plain version here) must equal ``np.searchsorted``
  of its bucket boundaries entry for entry, within 1/8 of the haystack's
  bytes, on uniform, clustered (one huge bucket), high (>= 2^31), all-ones,
  one-key and empty haystacks.
* ``member_indexed_plain`` (bucket bounds, then a bounded search: the
  kernel's formulation) must equal ``member_plain`` and
  ``metakssd_tpu.ops.merge.sorted_membership`` through its host fallback
  and through the Pallas kernel in interpret mode, in identity and values
  mode, on run-sorted needles (the shapes ``dist -r`` and ``set -s/-i``
  give K3), unsorted needles and duplicates.  The Pallas kernel takes
  sorted needles, so it gets them sorted and its answers go back to the
  needles' order; it never reports 0xFFFFFFFF, so those needles are held
  to the fallback only.
* ``dist -r`` and ``set -i/-s`` run with ``member`` replaced by the
  indexed formulation: one call per component (``dist -r``: per
  ``dist.MAX_NEEDLES`` needles, at query boundaries), no index built on
  the CPU route, and ``distance.out``, ``sharedk_ct.dat`` and the set dirs
  as the JAX package writes them.  (That a CUDA haystack builds its index
  once and every call reuses it, ``tests/test_torch_member_cuda.py``
  counts on the card.)
"""

import os

import numpy as np
import pytest
import torch

from metakssd_tpu import cli as jax_cli
from metakssd_tpu import dist as jax_dist
from metakssd_tpu.formats.shuf import make_shuf, write_shuf
from metakssd_tpu.ops import merge as jax_merge
from metakssd_tpu.params import SketchParams

from metakssd_tpu_torch import cli, dist
from metakssd_tpu_torch.formats.codir import CoDir
from metakssd_tpu_torch.ops import merge

from tests.util import random_seq, write_fasta

ALL_ONES = 0xFFFFFFFF


def _u32(rng, lo, hi, n):
    return rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32)


INDEX_CASES = ["uniform", "clustered", "high_keys", "all_ones", "small_keys",
               "fifteen_keys", "sixteen_keys", "one_key", "empty"]


def _index_hay(name: str) -> np.ndarray:
    rng = np.random.default_rng(INDEX_CASES.index(name) + 300)
    if name == "uniform":
        return np.unique(_u32(rng, 0, 1 << 32, 200_000))
    if name == "clustered":           # 100K keys in one bucket's range
        return np.unique(np.concatenate([_u32(rng, 0, 1 << 17, 100_000),
                                         _u32(rng, 1 << 30, 1 << 31,
                                              50_000)]))
    if name == "high_keys":
        return np.unique(_u32(rng, 1 << 31, 1 << 32, 30_000))
    if name == "all_ones":
        return np.append(np.unique(_u32(rng, 0, ALL_ONES, 30_000)),
                         np.uint32(ALL_ONES))
    if name == "small_keys":          # a K8S5L2-like id range: top bits 0
        return np.unique(_u32(rng, 0, 1 << 20, 40_000))
    if name in ("fifteen_keys", "sixteen_keys"):
        return np.unique(_u32(rng, 0, 1 << 32, 15 if name[0] == "f"
                              else 16))
    if name == "one_key":
        return np.array([12345], np.uint32)
    return np.zeros(0, np.uint32)


@pytest.mark.parametrize("name", INDEX_CASES)
def test_index_matches_searchsorted(name):
    """Every entry is the lower bound of its bucket's first key; the
    table holds at most 1/8 of the haystack's bytes and the largest key
    falls in its last bucket."""
    hay = _index_hay(name)
    ix = merge.build_index(merge.u32_tensor(hay))
    assert ix.table.dtype == torch.int32
    table = ix.table.numpy().view(np.uint32)
    if hay.size < 16:
        assert ix.nb == 0 and table.size == 0
        return
    assert ix.nb & (ix.nb - 1) == 0 and 2 * ix.nb + 1 > hay.size // 8
    assert 4 * table.size <= 4 * hay.size / 8
    assert (int(hay[-1]) >> ix.shift) < ix.nb
    assert ix.shift == 0 or (int(hay[-1]) >> (ix.shift - 1)) >= ix.nb
    bounds = np.arange(ix.nb, dtype=np.uint64) << np.uint64(ix.shift)
    want = np.append(np.searchsorted(hay.astype(np.uint64), bounds),
                     hay.size)
    np.testing.assert_array_equal(table, want)
    sizes = np.diff(want)
    if name == "clustered":
        assert sizes.max() > 10_000
    if name == "uniform":
        assert sizes.mean() <= 16


# The probe's exact search (csrc/probe.cu exact_search_kernel) takes K3's
# index of an accept table at a bucket count of its own choosing: every
# power of two with nb + 1 <= n, besides K3's 1/8 rule.
ACCEPT_CASES = ["L3K11", "k5s3l1", "k8s5l2", "skewed", "few_keys", "ends",
                "low_keys"]
SAMPLED_DIMS = 1 << 18             # dims drawn where the domain is larger


def _accept_case(name: str):
    """(sorted distinct u32 keys, 4 * subk: the bits of a dim)."""
    cfg = {"L3K11": (11, 6, 3), "k5s3l1": (5, 3, 1), "k8s5l2": (8, 5, 2)}
    if name in cfg:
        p = SketchParams(*cfg[name])
        return make_shuf(p, seed=1234).device_tables()[0], 4 * p.subk
    rng = np.random.default_rng(ACCEPT_CASES.index(name) + 500)
    if name == "skewed":              # 3000 keys in one 2^12 bucket range
        return np.unique(np.concatenate([
            _u32(rng, 5 << 12, 6 << 12, 3000),
            _u32(rng, 0, 1 << 24, 1000)])), 24
    if name == "few_keys":            # under 16 keys: K3's rule gives nb 0
        return np.unique(_u32(rng, 0, 1 << 24, 11)), 24
    if name == "low_keys":            # every key below 2^22 of 2^24 dims:
        # the top dims fall in buckets at or past nb, above every key
        return np.unique(_u32(rng, 0, 1 << 22, 3000)), 24
    top = (1 << 24) - 1               # the domain's both ends as keys
    return np.unique(np.concatenate([[0, top],
                                     _u32(rng, 1, top, 3000)])), 24


def _dims(keys: np.ndarray, bits: int) -> np.ndarray:
    """Every dim of [0, 2^bits), or a sample with the keys, their
    neighbours and both ends."""
    if bits <= 20:
        return np.arange(1 << bits, dtype=np.int64)
    rng = np.random.default_rng(bits)
    k = keys.astype(np.int64)
    d = np.concatenate([rng.integers(0, 1 << bits, SAMPLED_DIMS), k, k - 1,
                        k + 1, [0, (1 << bits) - 1]])
    return np.unique(d[(d >= 0) & (d < 1 << bits)])


def _bucket_counts(n: int) -> list:
    """K3's rule (None), then every power of two with nb + 1 <= n."""
    return [None] + [1 << i for i in range(32) if (1 << i) + 1 <= n]


def _kernel_search(keys: np.ndarray, ix, dims: np.ndarray):
    """The exact search kernel's steps in numpy, every dim in lockstep:
    the bucket's range from the index (b >= nb: [n, n); nb == 0: the
    whole table), then K3's halving step over it, no read of an empty
    range, and a hit where the last key read at or above the dim equals
    it.  Returns (pos, hit)."""
    n = keys.size
    k = keys.astype(np.int64)
    if ix.nb == 0:
        lo, hi = np.zeros_like(dims), np.full_like(dims, n)
    else:
        t = ix.table.numpy().view(np.uint32).astype(np.int64)
        b = dims >> ix.shift
        inside = b < ix.nb
        bc = np.minimum(b, ix.nb - 1)
        lo, hi = np.where(inside, t[bc], n), np.where(inside, t[bc + 1], n)
    base, length, ku = lo.copy(), hi - lo, np.full_like(dims, -1)
    while (length > 0).any():
        live = length > 0
        half = length >> 1
        key = k[np.minimum(base + half, n - 1)]
        lt = key < dims
        base = np.where(live & lt, base + half + 1, base)
        length = np.where(live, np.where(lt, length - half - 1, half),
                          length)
        ku = np.where(live & ~lt, key, ku)
    return base, ku == dims


@pytest.mark.parametrize("name", ACCEPT_CASES)
def test_index_contract_on_accept_tables(name):
    """For each dim, table[b] <= lower_bound(dim) <= table[b + 1] where b
    = dim >> shift is below nb, and lower_bound(dim) == n where it is not,
    at K3's rule and at every power-of-two bucket count the index kernel
    takes; and the kernel's search through each index gives numpy's lower
    bound and hit.  The shift puts the largest key in the last bucket."""
    keys, bits = _accept_case(name)
    n = keys.size
    dims = _dims(keys, bits)
    k = keys.astype(np.int64)
    lb = np.searchsorted(k, dims)
    want_hit = (lb < n) & (k[np.minimum(lb, n - 1)] == dims)
    counts = _bucket_counts(n)
    if name == "L3K11":
        assert n == 4096 and counts[-1] == 2048
    for buckets in counts:
        ix = merge.build_index_plain(merge.u32_tensor(keys), buckets)
        if buckets is None:
            assert ix.nb == merge.index_shape(n, int(keys[-1]))[0]
            assert (ix.nb == 0) == (n < 16)
        else:
            assert ix.nb == buckets
        if ix.nb:
            t = ix.table.numpy().view(np.uint32).astype(np.int64)
            assert t.size == ix.nb + 1 and t[-1] == n
            assert (int(keys[-1]) >> ix.shift) < ix.nb
            b = dims >> ix.shift
            inside = b < ix.nb
            assert (lb[~inside] == n).all(), (name, buckets)
            if name == "low_keys":    # dims whose bucket is nb or more
                assert (~inside).any(), buckets
            bi = b[inside]
            assert (t[bi] <= lb[inside]).all(), (name, buckets)
            assert (lb[inside] <= t[bi + 1]).all(), (name, buckets)
        pos, hit = _kernel_search(keys, ix, dims)
        np.testing.assert_array_equal(pos, lb, err_msg=f"{name} {buckets}")
        np.testing.assert_array_equal(hit, want_hit,
                                      err_msg=f"{name} {buckets}")
    if name == "skewed":              # one bucket holds most keys
        t = merge.build_index_plain(merge.u32_tensor(keys)).table.numpy()
        assert np.diff(t.view(np.uint32).astype(np.int64)).max() > n // 2
    if name == "ends":
        assert keys[0] == 0 and keys[-1] == (1 << bits) - 1


@pytest.mark.parametrize("buckets", [0, 3, 6, 2047, 4096, 8192, -2])
def test_index_shape_rejects_bucket_counts(buckets):
    """A bucket count must be a power of two with nb + 1 <= nh; K3's rule
    and the counts that fit are taken."""
    with pytest.raises(ValueError, match="buckets"):
        merge.index_shape(4096, (1 << 24) - 1, buckets)
    with pytest.raises(ValueError, match="buckets"):
        merge.build_index_plain(merge.u32_tensor(np.arange(4096)), buckets)
    assert merge.index_shape(4096, (1 << 24) - 1) == (256, 16)
    assert merge.index_shape(4096, (1 << 24) - 1, 2048) == (2048, 13)
    assert merge.index_shape(4096, (1 << 24) - 1, 1) == (1, 24)
    assert merge.index_shape(2, 5, 1) == (1, 3)


HAY = 40_000
MEMBER_CASES = ["sorted", "high_keys", "dist_runs", "set_runs", "unsorted",
                "duplicates", "clustered", "all_ones", "small_hay",
                "one_needle", "empty_haystack"]


def _keys(rng, lo, hi, n):
    """n distinct sorted u32 keys from [lo, hi)."""
    pool = np.unique(_u32(rng, lo, hi, n + n // 4 + 16))
    return np.sort(rng.choice(pool, n, replace=False))


def _member_case(name: str):
    """(haystack, values, needles) uint32, from a numpy seed.  The
    haystacks of the Pallas cases hold HAY keys and their needles fill
    three of its 2048-needle blocks, so that interpret mode compiles one
    shape for all of them."""
    rng = np.random.default_rng(MEMBER_CASES.index(name) + 400)
    hay = _keys(rng, 0, ALL_ONES, HAY)

    def mixed(n):                      # half hits, half random keys
        return np.concatenate([rng.choice(hay, n // 2),
                               _u32(rng, 0, ALL_ONES, n - n // 2)])
    if name == "sorted":
        needles = np.sort(mixed(6000))
    elif name == "high_keys":
        hay = _keys(rng, 1 << 31, ALL_ONES, HAY)
        needles = np.sort(mixed(6000))
    elif name == "dist_runs":          # queries of sorted ids, one run each
        needles = np.concatenate([np.sort(mixed(700)) for _ in range(8)])
    elif name == "set_runs":           # genomes of 128 sorted ids, most hits
        needles = np.concatenate([np.sort(np.concatenate([
            rng.choice(hay, 120), _u32(rng, 0, ALL_ONES, 8)]))
            for _ in range(48)])
    elif name == "unsorted":
        needles = rng.permutation(mixed(6000))
    elif name == "duplicates":
        hits = rng.choice(hay, 2500)
        needles = rng.permutation(np.concatenate([hits, hits[:800],
                                                  mixed(1800)]))
    elif name == "clustered":          # 25K keys in the first bucket
        hay = np.concatenate([_keys(rng, 0, 1 << 17, 25_000),
                              _keys(rng, 1 << 30, 1 << 31, HAY - 25_000)])
        needles = np.sort(np.concatenate([_u32(rng, 0, 1 << 17, 3000),
                                          rng.choice(hay, 3000)]))
    elif name == "all_ones":
        hay[-1] = ALL_ONES
        needles = np.sort(np.concatenate([mixed(5997),
                                          np.full(3, ALL_ONES, np.uint32)]))
    elif name == "small_hay":          # below 16 keys: no table
        hay = _keys(rng, 0, ALL_ONES, 12)
        needles = np.concatenate([hay, _u32(rng, 0, ALL_ONES, 40)])
    elif name == "one_needle":
        needles = rng.choice(hay, 1)
    else:                              # empty_haystack
        needles = mixed(100)
        hay = np.zeros(0, np.uint32)
    values = _u32(rng, 1, 1 << 32, hay.size)
    return hay, values, needles.astype(np.uint32)


def _jax_pallas(hay, values, needles):
    """The Pallas kernel (interpret mode) on the needles sorted, its
    answers put back in the needles' order."""
    order = np.argsort(needles, kind="stable")
    m, v = jax_merge.sorted_membership(hay, values, needles[order],
                                       use_pallas=True, interpret=True)
    out_m, out_v = np.empty_like(m), np.empty_like(v)
    out_m[order], out_v[order] = m, v
    return out_m, out_v


@pytest.mark.parametrize("identity", [False, True])
@pytest.mark.parametrize("name", MEMBER_CASES)
def test_indexed_plain_matches_jax(name, identity):
    hay, values, needles = _member_case(name)
    h, nd = merge.u32_tensor(hay), merge.u32_tensor(needles)
    v = None if identity else merge.u32_tensor(values)
    ix = merge.build_index(h)
    m, val = merge.member_indexed_plain(h, v, nd, ix)
    pm, pv = merge.member_plain(h, v, nd)
    assert torch.equal(m, pm) and torch.equal(val, pv)
    got = m.numpy().astype(bool), val.numpy().view(np.uint32)
    if identity:
        jax_hay, jax_vals = jax_merge.StaticHaystack(hay), None
    else:
        jax_hay, jax_vals = hay, values
    want = jax_merge.sorted_membership(jax_hay, jax_vals, needles,
                                       use_pallas=False)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if hay.size:
        pal = _jax_pallas(hay, np.arange(hay.size, dtype=np.uint32)
                          if identity else values, needles)
        keep = needles != ALL_ONES
        np.testing.assert_array_equal(got[0][keep], pal[0][keep])
        np.testing.assert_array_equal(got[1][keep], pal[1][keep])
    if name == "all_ones":
        assert got[0][needles == ALL_ONES].all()
    if identity:
        np.testing.assert_array_equal(hay[got[1][got[0]]], needles[got[0]])


def _indexed_member(calls):
    """A stand-in for ``merge.member`` that runs the indexed formulation
    and records (haystack size, needles, index passed) of each call."""
    def member(hay, values, needles, index=None):
        calls.append((hay.numel(), needles.numel(), index))
        return merge.member_indexed_plain(hay, values, needles,
                                          merge.build_index_plain(hay))
    return member


@pytest.fixture(scope="module")
def comps_setup(tmp_path_factory):
    """A K8S5L2 reference of four genomes and five queries sketched by the
    JAX CLI in sixteen components (--component_sz 5): two mutated copies,
    an unrelated genome, and two short queries whose ids miss most
    components, one of them entirely."""
    tmp = tmp_path_factory.mktemp("torch_member_index")
    rng = np.random.default_rng(17)
    shufp = str(tmp / "K8S5L2.shuf")
    write_shuf(shufp, make_shuf(SketchParams(k=8, subk=5, drlevel=2),
                                seed=18))
    gdir, qdir = tmp / "genomes", tmp / "queries"
    gdir.mkdir()
    qdir.mkdir()
    genomes = [random_seq(rng, 60_000) for _ in range(4)]
    for i, g in enumerate(genomes):
        write_fasta(str(gdir / f"g{i}.fa"), [g])

    def mutate(seq, rate):
        a = np.frombuffer(seq.encode(), np.uint8).copy()
        hit = rng.random(a.size) < rate
        a[hit] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4,
                                                               hit.sum())]
        return a.tobytes().decode()
    queries = [mutate(genomes[1], 0.01), mutate(genomes[3], 0.05),
               random_seq(rng, 60_000), genomes[0][:3000], "ACGT" * 3]
    for i, q in enumerate(queries):
        write_fasta(str(qdir / f"q{i}.fa"), [q])
    refco, qryco = str(tmp / "refco"), str(tmp / "qryco")
    cs = ["--component_sz", "5"]
    assert jax_cli.main(["dist", "-L", shufp, "-o", refco, *cs,
                         str(gdir)]) == 0
    assert jax_cli.main(["dist", "-L", shufp, "-o", qryco, *cs,
                         *(str(qdir / f"q{i}.fa")
                           for i in range(len(queries)))]) == 0
    return tmp, refco, qryco


@pytest.fixture(scope="module")
def jax_search(comps_setup):
    """The JAX package's distance.out and sharedk_ct.dat of comps_setup."""
    tmp, refco, qryco = comps_setup
    out = str(tmp / "jax")
    jax_dist.run_dist_search(refco, qryco, out,
                             jax_dist.DistOptions(keep_shared_kmer=True),
                             use_device=False)
    return out


def _search_calls(comps_setup, jax_search, monkeypatch, out):
    """Run the port's search with the indexed formulation as ``member``,
    hold its files to the JAX package's and return the calls and the
    number of index builds."""
    tmp, refco, qryco = comps_setup
    calls, builds = [], []
    monkeypatch.setattr(merge, "member", _indexed_member(calls))
    monkeypatch.setattr(merge, "build_index",
                        lambda hay: builds.append(hay.numel()))
    dist.run_dist_search(refco, qryco, str(tmp / out),
                         dist.DistOptions(keep_shared_kmer=True),
                         device="cpu")
    for f in ("distance.out", "sharedk_ct.dat"):
        with open(os.path.join(jax_search, f), "rb") as x, \
                open(os.path.join(tmp, out, f), "rb") as y:
            data = x.read()
            assert data and data == y.read(), f
    return calls, builds


def _per_comp(comps_setup):
    """[component, query] id counts of the queries, and the reference."""
    _, refco, qryco = comps_setup
    qry, ref = CoDir.read(qryco), CoDir.read(refco)
    return np.array([[qry.genome_ids(c, q).size
                      for q in range(qry.stat.infile_num)]
                     for c in range(qry.stat.comp_num)]), ref


def test_search_is_one_call_per_component(comps_setup, jax_search,
                                          monkeypatch):
    """The batched search: one K3 call per component that holds query ids,
    no index built on the CPU route; distance.out and sharedk_ct.dat
    byte-identical to the JAX package's."""
    per_comp, ref = _per_comp(comps_setup)
    assert per_comp.shape[0] == 16 and per_comp[:, 4].sum() == 0
    assert (per_comp[:, 3] == 0).any() and (per_comp[:, 3] > 0).any()
    calls, builds = _search_calls(comps_setup, jax_search, monkeypatch,
                                  "port")
    live = [c for c in range(16) if ref.ids[c].size and per_comp[c].sum()]
    assert [n for _, n, _ in calls] == [int(per_comp[c].sum())
                                        for c in live]
    assert builds == [] and all(ix is None for *_, ix in calls)


@pytest.mark.parametrize("budget", [1, 300, 1200])
def test_search_chunks_at_query_boundaries(comps_setup, jax_search,
                                           monkeypatch, budget):
    """With ``dist.MAX_NEEDLES`` lowered, a component's queries go to K3
    in calls of whole queries' runs, each at most the budget or one query,
    together every id once; the files stay byte-identical."""
    per_comp, ref = _per_comp(comps_setup)
    monkeypatch.setattr(dist, "MAX_NEEDLES", budget)
    calls, _ = _search_calls(comps_setup, jax_search, monkeypatch,
                             f"port{budget}")
    want = []
    for c in range(16):
        if not (ref.ids[c].size and per_comp[c].sum()):
            continue
        run = 0
        for n in per_comp[c]:
            if run and run + n > budget:
                want.append(run)
                run = 0
            run += n
        want.append(run)
    want = [n for n in want if n]
    assert [n for _, n, _ in calls] == want
    assert sum(want) == int(sum(per_comp[c].sum() for c in range(16)
                                if ref.ids[c].size))
    if budget == 1:
        assert len(calls) == int((per_comp[[c for c in range(16)
                                            if ref.ids[c].size]] > 0).sum())


@pytest.mark.parametrize("verb", ["-i", "-s"])
def test_set_operate_through_index(comps_setup, verb, monkeypatch, capsys):
    """set -i/-s: one K3 call per component through the pan's index, and
    the dirs of the JAX CLI, byte for byte."""
    tmp, refco, _ = comps_setup
    upan = str(tmp / f"upan{verb}")
    assert jax_cli.main(["set", "-q", "-o", upan, refco]) == 0
    calls = []
    monkeypatch.setattr(merge, "member", _indexed_member(calls))
    a, b = str(tmp / f"jax{verb}"), str(tmp / f"port{verb}")
    assert jax_cli.main(["set", verb, upan, "-o", a, refco]) == 0
    assert cli.main(["set", verb, upan, "-o", b, "--device", "cpu",
                     refco]) == 0
    capsys.readouterr()
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for f in names:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f
    assert len(calls) == 16 and sum(n for _, n, _ in calls) > 0
    assert all(ix is None for *_, ix in calls)
