"""The port's abundance-vector search against the JAX package, on the CPU.

``state.dense_abv_from_index`` must build the arrays of the JAX
``DenseAbv.from_index``; the port's dense measures must lie within 2e-3 of
the JAX dense path's and of the sparse path's (``composite.abv_search``,
the reference semantics) for cosine, L1 and L2, with equal overlap masks;
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
    within 2e-3.  A query's L2 to itself is left out of the value check:
    both dense paths give the square root of a rounding residue there
    (test_l2_self_distance_is_a_rounding_residue)."""
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
            if not got_o[b, si] or (mode == 2 and si == self_id):
                continue
            assert abs(got_m[b, si] - want_m[b, si]) < TOL, (b, si)
            assert abs(got_m[b, si] - sparse[sname]) < TOL, (b, sname)


def test_l2_self_distance_is_a_rounding_residue(abv_db):
    """ROADMAP.md section 3: for a query equal to a DB vector the
    overlap-L2 expression q2y + y2x - 2<x,y> cancels to a residue of a
    few float32 ulps of sum(x^2), in the JAX package and the port alike;
    its sqrt is NaN when the residue is negative.  The sparse path gives
    0 there."""
    idx = AbvIndex.read(abv_db)
    nspecies = int(idx.abmi.size)
    q = _queries(abv_db, idx.names, nspecies)
    dense = dense_abv_from_index(idx, nspecies, "cpu")
    import torch
    with dense_abv._fp32_matmul():
        port = np.diag(dense_abv._dense_l2_overlap(
            dense.mat, torch.from_numpy(q)).numpy())
    jd = jax_composite.DenseAbv.from_index(idx, nspecies)
    jax_res = np.diag(np.asarray(jax_composite._dense_l2_overlap(jd.mat, q)))
    bound = 64 * np.spacing((q.astype(np.float64) ** 2).sum(1)
                            .astype(np.float32))
    assert (np.abs(port) <= bound).all() and (np.abs(jax_res) <= bound).all()
    for name in idx.names[:3]:
        assert _sparse(abv_db, name, 2)[name] == 0.0


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


def test_l1_chunks_over_queries(abv_db):
    """A small temporary bound splits the queries into several chunks and
    gives the one-chunk result."""
    import torch
    idx = AbvIndex.read(abv_db)
    nspecies = int(idx.abmi.size)
    dense = dense_abv_from_index(idx, nspecies, "cpu")
    q = torch.from_numpy(_queries(abv_db, idx.names, nspecies))
    whole = dense_abv._dense_l1(dense.mat, q)
    n = dense.mat.shape[0]
    parts = dense_abv._dense_l1(dense.mat, q, chunk=16,
                                temp_bytes=4 * n * 16 * 3)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), atol=1e-4)


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
