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
