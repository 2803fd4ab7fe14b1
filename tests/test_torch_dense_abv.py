"""The port's abundance-vector search against the JAX package, on the CPU.

``state.dense_abv_from_index`` must build the arrays of the JAX
``DenseAbv.from_index``; the port's dense measures must lie within 2e-3 of
the JAX dense path's and of the sparse path's (``composite.abv_search``,
the reference semantics) for cosine, L1 and L2, with equal overlap masks,
and its gather's plain twin within 1e-6 of the reference formulas in
float64;
and ``cli composite -i / -s 0-2 / -d`` must print and write what the JAX
CLI does, byte for byte, and ``-s --dense`` within 2e-3 of it.
"""

import io
import os

import numpy as np
import pytest

from metakssd_tpu import cli as jax_cli
from metakssd_tpu import composite as jax_composite
from metakssd_tpu.formats.abv import AbvIndex, read_abv_file, write_abv_file
from metakssd_tpu.formats.costat import CoStat

from metakssd_tpu_torch import cli
from metakssd_tpu_torch.ops import dense_abv
from metakssd_tpu_torch.state import dense_abv_from_index

TOL = 2e-3          # the bound of tests/test_dense_abv.py


def _write_db(refdir, nspecies: int, nsamples: int, seed: int, skew: bool,
              dims=(3, 10)):
    """Random abv vectors (percentages summing to 100) under
    ``refdir/abundance_Vec``, a cofiles.stat naming the species, and the
    index by the JAX package's ``index_abv``."""
    rng = np.random.default_rng(seed)
    vdir = refdir / "abundance_Vec"
    vdir.mkdir()
    prev = 1.0 / np.arange(1, nspecies + 1) if skew else np.ones(nspecies)
    prev /= prev.sum()
    for s in range(nsamples):
        nd = int(rng.integers(*dims))
        d = np.sort(rng.choice(nspecies, nd, replace=False, p=prev))
        pct = rng.lognormal(0.0, 1.0, nd) if skew else rng.random(nd)
        write_abv_file(str(vdir / f"s{s}.abv"), d.astype(np.int32),
                       (pct / pct.sum() * 100).astype(np.float32))
    CoStat(1, False, 16, 4, 1, 0, np.zeros(nspecies, np.uint32),
           [f"sp{i}" for i in range(nspecies)]).write(str(refdir))
    jax_composite.index_abv(str(refdir))
    return str(refdir)


@pytest.fixture(scope="module", params=["small", "skewed"])
def abv_db(request, tmp_path_factory):
    """``small``: the database of tests/test_dense_abv.py (6 vectors over
    40 species); ``skewed``: 120 vectors of 5-60 dims over 300 species,
    with the prevalence of a species falling as 1/rank."""
    tmp = tmp_path_factory.mktemp(f"torch_abv_{request.param}")
    if request.param == "small":
        return _write_db(tmp, 40, 6, 0, False)
    return _write_db(tmp, 300, 120, 5, True, dims=(5, 60))


def _queries(refdir: str, names: list[str], nspecies: int) -> np.ndarray:
    q = np.zeros((len(names), nspecies), np.float32)
    for i, n in enumerate(names):
        qi, qp = read_abv_file(os.path.join(refdir, "abundance_Vec", n))
        q[i, qi] = qp
    return q


def _some_queries(idx) -> list[str]:
    return idx.names[::max(1, len(idx.names) // 8)]


def test_dense_db_equals_jax(abv_db):
    """The dense matrix and norms equal the JAX DenseAbv's, whether built
    from the AbvIndex or taken from the JAX DenseAbv's arrays."""
    idx = AbvIndex.read(abv_db)
    nspecies = int(idx.abmi.size)
    want = jax_composite.DenseAbv.from_index(idx, nspecies)
    for src in (idx, want):
        got = dense_abv_from_index(src, nspecies, "cpu")
        assert got.names == want.names
        np.testing.assert_array_equal(got.mat.numpy(), np.asarray(want.mat))
        np.testing.assert_array_equal(got.y_l2n.numpy(),
                                      np.asarray(want.y_l2n))
        assert got.mat.numpy().dtype == got.y_l2n.numpy().dtype == \
            np.asarray(want.mat).dtype


def _sparse(refdir: str, name: str, mode: int) -> dict:
    buf = io.StringIO()
    jax_composite.abv_search(refdir, [name], mode=mode, out=buf)
    return {ln.split("\t")[0]: float(ln.split("\t")[1])
            for ln in buf.getvalue().splitlines()[1:]}


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_dense_measures_match(abv_db, mode):
    """Port dense vs JAX dense vs sparse: overlap masks equal, measures
    within 2e-3.  A query's L2 to itself is held to the sparse path's 0
    alone: the JAX dense path gives the square root of a rounding residue
    there (test_l2_self_distance_is_a_rounding_residue)."""
    idx = AbvIndex.read(abv_db)
    nspecies = int(idx.abmi.size)
    names = _some_queries(idx)
    q = _queries(abv_db, names, nspecies)
    dense = dense_abv_from_index(idx, nspecies, "cpu")
    got_m, got_o = dense_abv.abv_search_batch(dense, q, mode=mode)
    jd = jax_composite.DenseAbv.from_index(idx, nspecies)
    want_m, want_o = jax_composite.abv_search_batch(jd, q, mode=mode)
    np.testing.assert_array_equal(got_o, want_o)
    for b, name in enumerate(names):
        sparse = _sparse(abv_db, name, mode)
        self_id = idx.names.index(name)
        assert got_o[b, self_id]
        for si, sname in enumerate(idx.names):
            assert got_o[b, si] == (sname in sparse)
            if not got_o[b, si]:
                continue
            if not (mode == 2 and si == self_id):
                assert abs(got_m[b, si] - want_m[b, si]) < TOL, (b, si)
            assert abs(got_m[b, si] - sparse[sname]) < TOL, (b, sname)


def test_l2_self_distance_is_a_rounding_residue(abv_db):
    """ROADMAP.md section 3: for a query equal to a DB vector the JAX
    package's overlap-L2 expression q2y + y2x - 2<x,y> cancels to a residue
    of a few float32 ulps of sum(x^2); its sqrt is NaN when the residue is
    negative.  The port's gather sums (x - y)^2 directly and gives exactly
    0 there, as the sparse path does."""
    idx = AbvIndex.read(abv_db)
    nspecies = int(idx.abmi.size)
    q = _queries(abv_db, idx.names, nspecies)
    dense = dense_abv_from_index(idx, nspecies, "cpu")
    port_m, port_o = dense_abv.abv_search_batch(dense, q, mode=2)
    assert np.diag(port_o).all() and (np.diag(port_m) == 0.0).all()
    jd = jax_composite.DenseAbv.from_index(idx, nspecies)
    jax_res = np.diag(np.asarray(jax_composite._dense_l2_overlap(jd.mat, q)))
    bound = 64 * np.spacing((q.astype(np.float64) ** 2).sum(1)
                            .astype(np.float32))
    assert (np.abs(jax_res) <= bound).all()
    for name in idx.names[:3]:
        assert _sparse(abv_db, name, 2)[name] == 0.0


def _reference_f64(mat: np.ndarray, q: np.ndarray, mode: int):
    """The reference tool's measures (command_composite.c:299-319) of each
    query against each row, in float64 NumPy: (measure, overlap); over the
    species both hold, L2 sqrt(sum (y - x)^2), L1 sum |y - x| + 200 -
    sum x - sum y, cosine sum x y / (|x| |y|), |x| and |y| over all of
    each vector's species."""
    x = q.astype(np.float64)[:, None, :]
    y = mat.astype(np.float64)[None, :, :]
    both = (x != 0) & (y != 0)
    if mode == 2:
        m = np.sqrt(np.where(both, (y - x) ** 2, 0.0).sum(2))
    elif mode == 1:
        m = (np.where(both, np.abs(y - x), 0.0).sum(2) + 200.0
             - np.where(both, x, 0.0).sum(2) - np.where(both, y, 0.0).sum(2))
    else:
        with np.errstate(invalid="ignore", divide="ignore"):
            m = np.where(both, x * y, 0.0).sum(2) / (
                np.sqrt((x * x).sum(2)) * np.sqrt((y * y).sum(2)))
    return m, both.any(2)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_plain_gather_matches_float64(abv_db, mode):
    """The CPU route of ``abv_search_batch`` (the gather's plain twin) on a
    batch holding a query with no nonzero, a query over every species, DB
    vectors and random queries of other nonzero counts: overlap exact,
    measure within 1e-6 of float64 NumPy (relative above 1), and 0 where
    a sample shares no species."""
    idx = AbvIndex.read(abv_db)
    nspecies = int(idx.abmi.size)
    rng = np.random.default_rng(11 + mode)
    full = rng.random(nspecies).astype(np.float32) + np.float32(0.01)
    q = [np.zeros(nspecies, np.float32), full / full.sum() * 100]
    for nd in (1, 3, nspecies // 4):
        row = np.zeros(nspecies, np.float32)
        row[rng.choice(nspecies, nd, replace=False)] = rng.random(nd) + 0.5
        q.append(row)
    q = np.vstack(q + list(_queries(abv_db, _some_queries(idx), nspecies)))
    dense = dense_abv_from_index(idx, nspecies, "cpu")
    got_m, got_o = dense_abv.abv_search_batch(dense, q, mode=mode)
    want_m, want_o = _reference_f64(dense.mat.numpy(), q, mode)
    assert got_m.dtype == np.float32 and got_o.dtype == bool
    np.testing.assert_array_equal(got_o, want_o)
    assert not got_o[0].any() and got_o[1].sum() == \
        (dense.mat.numpy() != 0).any(1).sum()
    gap = np.abs(got_m[got_o] - want_m[got_o]) / \
        np.maximum(np.abs(want_m[got_o]), 1.0)
    assert gap.max() < 1e-6
    assert (got_m[~got_o] == 0.0).all()


def test_cosine_topk_matches(abv_db):
    idx = AbvIndex.read(abv_db)
    nspecies = int(idx.abmi.size)
    names = _some_queries(idx)
    q = _queries(abv_db, names, nspecies)
    dense = dense_abv_from_index(idx, nspecies, "cpu")
    scores, ids = dense_abv.abv_search_batch_cosine(dense, q, top_k=3)
    jd = jax_composite.DenseAbv.from_index(idx, nspecies)
    js, ji = jax_composite.abv_search_batch_cosine(jd, q, top_k=3)
    np.testing.assert_array_equal(ids[:, 0], ji[:, 0])
    np.testing.assert_allclose(scores, js, atol=1e-5)
    assert [idx.names[i] for i in ids[:, 0]] == list(names)


@pytest.mark.parametrize("verb", ["-i", "-s0", "-s1", "-s2", "-d"])
def test_cli_abv_verbs_match(abv_db, verb, capsys):
    """composite -i writes the JAX CLI's index files; -s (sparse) and -d
    print its lines, byte for byte; bare names resolve under
    abundance_Vec/ and non-.abv arguments are skipped alike."""
    idx = AbvIndex.read(abv_db)
    vdir = os.path.join(abv_db, "abundance_Vec")
    if verb == "-i":
        files = [f"abundance_Vec.{s}" for s in ("abm", "abmi", "name",
                                                "yl2n")]
        assert jax_cli.main(["composite", "-r", abv_db, "-i"]) == 0
        want = {f: open(os.path.join(abv_db, f), "rb").read() for f in files}
        assert cli.main(["composite", "-r", abv_db, "-i", "--device",
                         "cpu"]) == 0
        for f in files:
            assert open(os.path.join(abv_db, f), "rb").read() == want[f], f
        return
    if verb == "-d":
        argv = ["composite", "-d", os.path.join(vdir, idx.names[1]),
                os.path.join(vdir, idx.names[2])]
    else:
        argv = ["composite", "-r", abv_db, "-s", verb[2:], idx.names[0],
                os.path.join(vdir, idx.names[-1]), "not_an_abv.txt"]
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert cli.main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.count("\n") > 4


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_cli_dense_text_matches(abv_db, mode, capsys):
    """composite -s <mode> --dense on the CPU reports the samples the JAX
    CLI's dense search reports, with values within 2e-3 (the self L2
    excepted, as above)."""
    idx = AbvIndex.read(abv_db)
    queries = list(_some_queries(idx))
    argv = ["composite", "-r", abv_db, "-s", str(mode), "--dense", *queries]
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert cli.main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr().out

    def blocks(text):
        out = []
        for blk in text.split("#Sample\t")[1:]:
            lines = blk.splitlines()
            out.append((lines[0], {ln.split("\t")[0]: float(ln.split("\t")[1])
                                   for ln in lines[1:]}))
        return out
    got_b, want_b = blocks(got), blocks(want)
    assert len(got_b) == len(want_b) == len(queries)
    for qname, (hg, g), (hw, w) in zip(queries, got_b, want_b):
        assert hg == hw and set(g) == set(w)
        for name in g:
            if mode == 2 and name == qname:
                continue
            assert abs(g[name] - w[name]) < TOL, (qname, name)
