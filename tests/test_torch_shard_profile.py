"""``composite --shard-db 1`` and ``profile --shard-db 1`` in the port
against the JAX package, byte for byte, on the CPU.

The port matches each query id with K3 against a component's distinct
k-mers (``parallel/mesh.ShardedMatchIndex``; the plain version on the
CPU) and takes the statistics on the host, where the JAX package runs
``jnp.searchsorted`` on one db shard.  Both must write the TSVs and
``.abv`` files of the JAX ``get_species_abundance(shard_db=1)`` and of
the port's default route, on a real MarkerDB and on a synthetic one with
the edges: 0xFFFFFFFF in the MarkerDB and in a query, ids of 2^31 and
above, an empty component, a query with nothing in a component.
"""

import io
import os

import numpy as np
import pytest

from metakssd_tpu import cli as jax_cli
from metakssd_tpu import composite as jax_composite
from metakssd_tpu import pipeline as jax_pipeline
from metakssd_tpu import profile_e2e as jax_profile_e2e
from metakssd_tpu.formats.shuf import make_shuf, write_shuf

from metakssd_tpu_torch import cli, composite
from metakssd_tpu_torch.formats.codir import write_codir
from metakssd_tpu_torch.formats.costat import CoStat
from metakssd_tpu_torch.formats.shuf import read_shuf
from metakssd_tpu_torch.io import native
from metakssd_tpu_torch.params import SketchParams
from metakssd_tpu_torch.parallel import mesh as pmesh

from tests.util import random_seq, reads_from_genome, write_fasta, \
    write_fastq

ALL_ONES = 0xFFFFFFFF


@pytest.fixture(scope="module")
def real_db(tmp_path_factory):
    """6 genomes, their MarkerDB (the JAX package's stage I), a fastq from
    three of them and its abundance sketch."""
    tmp = tmp_path_factory.mktemp("shard_real")
    rng = np.random.default_rng(71)
    gdir = tmp / "genomes"
    gdir.mkdir()
    genomes = [random_seq(rng, 30_000) for _ in range(6)]
    for i, g in enumerate(genomes):
        write_fasta(str(gdir / f"sp{i}.fa"), [g])
    shufp = str(tmp / "t.shuf")
    write_shuf(shufp, make_shuf(SketchParams(k=8, subk=5, drlevel=2),
                                seed=72))
    db = str(tmp / "markerdb")
    jax_pipeline.run_stage1(jax_pipeline.organize_infiles([str(gdir)]),
                            read_shuf(shufp), db)
    fq = str(tmp / "sample.fq")
    write_fastq(fq, reads_from_genome(rng, genomes[0], 1200, 120)
                + reads_from_genome(rng, genomes[2], 500, 120, err=0.01)
                + reads_from_genome(rng, genomes[5], 200, 120))
    qry = str(tmp / "qry")
    jax_pipeline.run_stage1([fq], read_shuf(shufp), qry,
                            jax_pipeline.SketchOptions(abundance=True))
    return {"tmp": tmp, "shuf": shufp, "db": db, "fq": fq, "qry": qry}


@pytest.fixture(scope="module")
def edge_db(tmp_path_factory):
    """A synthetic MarkerDB of 7 genomes over 4 components and two
    abundance queries.  Component 2 of the MarkerDB is empty; genome 6's
    only id is 0xFFFFFFFF (component 0); ids of 2^31 and above are
    common; query 0 holds 0xFFFFFFFF in components 0 (a MarkerDB id) and
    1 (not one) and nothing in component 3."""
    tmp = tmp_path_factory.mktemp("shard_edge")
    rng = np.random.default_rng(73)
    ncomp, nref = 4, 7
    pools = [np.unique(rng.integers(0, 1 << 32, 3000, dtype=np.uint64)
                       .astype(np.uint32)) for _ in range(ncomp)]
    pools[0] = pools[0][pools[0] != ALL_ONES]
    ref = []
    for g in range(nref):
        comps = []
        for c in range(ncomp):
            if c == 2:
                ids = np.zeros(0, np.uint32)
            elif g == 6:
                ids = np.array([ALL_ONES] if c == 0 else [], np.uint32)
            else:
                ids = np.unique(rng.choice(pools[c], 400 + 50 * g))
            comps.append((ids.astype(np.uint32), None))
        ref.append(comps)
    sid = 4242
    db = str(tmp / "db")
    write_codir(db, CoStat(sid, False, 16, 4, ncomp,
                           sum(x.size for g in ref for x, _ in g),
                           np.array([sum(x.size for x, _ in g) for g in ref],
                                    np.uint32),
                           [f"ref{g}.fa" for g in range(nref)]), ref)
    qry = []
    for q in range(2):
        comps = []
        for c in range(ncomp):
            ids = np.unique(rng.choice(pools[c], 900))
            if q == 0 and c in (0, 1):
                ids = np.append(ids, np.uint32(ALL_ONES))
            if q == 0 and c == 3:
                ids = np.zeros(0, np.uint32)
            ab = rng.integers(1, 40, ids.size).astype(np.uint16)
            comps.append((ids.astype(np.uint32), ab))
        qry.append(comps)
    qdir = str(tmp / "qry")
    write_codir(qdir, CoStat(sid, True, 16, 4, ncomp,
                             sum(x.size for g in qry for x, _ in g),
                             np.array([sum(x.size for x, _ in g)
                                       for g in qry], np.uint32),
                             ["q0.fq", "q1.fq"]), qry)
    return {"tmp": tmp, "db": db, "qry": qdir}


def _jax_tsv(db, qry, **kw) -> str:
    buf = io.StringIO()
    jax_composite.get_species_abundance(db, qry, out=buf, **kw)
    return buf.getvalue()


def _port_tsv(db, qry, **kw) -> str:
    buf = io.StringIO()
    composite.get_species_abundance(db, qry, out=buf, device="cpu", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("which", ["real", "edge"])
@pytest.mark.parametrize("min_km_s", [None, 1])
def test_shard_db_1_report_matches(request, which, min_km_s):
    """The report lines of shard_db=1 are the JAX package's (its one-shard
    route and its default) and the port's default route's."""
    d = request.getfixturevalue(f"{which}_db")
    kw = {} if min_km_s is None else {"min_km_s": min_km_s}
    want = _jax_tsv(d["db"], d["qry"], shard_db=1, **kw)
    assert want and want == _jax_tsv(d["db"], d["qry"], **kw)
    assert _port_tsv(d["db"], d["qry"], shard_db=1, **kw) == want
    assert _port_tsv(d["db"], d["qry"], **kw) == want
    if which == "edge" and min_km_s == 1:
        # genome 6 shares only 0xFFFFFFFF with query 0
        assert "q0.fq\tref6.fa\t1\t" in want


def test_all_ones_is_matched(edge_db):
    """0xFFFFFFFF is a member when the MarkerDB holds it (component 0)
    and dropped when it does not (component 1): the serial path's
    answer, not the dropped pad of a padded shard."""
    stage = composite.stage_markerdb(edge_db["db"])
    for c, hit in ((0, True), (1, False)):
        ci = stage[c]
        ix = pmesh.ShardedMatchIndex(ci.rk, ci.starts, ci.gid_sorted, "cpu")
        q = np.array([5, ALL_ONES], np.uint32)
        g, ab = ix.match(np.sort(q), np.array([3, 9], np.uint16))
        assert (9 in ab.tolist()) == hit
        if hit:
            assert 6 in g[ab == 9].tolist()
    assert stage[2] is None


def test_shard_db_1_binvec_matches(edge_db, real_db, tmp_path):
    """composite -q -b --shard-db 1: the .abv vectors of the JAX package's
    one-shard route."""
    for name, d in (("edge", edge_db), ("real", real_db)):
        a, b = str(tmp_path / f"{name}_jax"), str(tmp_path / f"{name}_port")
        jax_composite.get_species_abundance(d["db"], d["qry"], outdir=a,
                                            binvec=True, shard_db=1,
                                            min_km_s=1)
        composite.get_species_abundance(d["db"], d["qry"], outdir=b,
                                        binvec=True, shard_db=1,
                                        min_km_s=1, device="cpu")
        names = sorted(os.listdir(a))
        assert names and names == sorted(os.listdir(b))
        for f in names:
            with open(os.path.join(a, f), "rb") as x, \
                    open(os.path.join(b, f), "rb") as y:
                assert x.read() == y.read(), f


@pytest.mark.parametrize("max_needles", [1, 7, 1 << 26])
def test_needles_cut_into_calls(edge_db, monkeypatch, max_needles):
    """A component's query ids go to K3 in calls of at most MAX_NEEDLES;
    the report does not change."""
    calls = []
    real = pmesh.sorted_membership

    def counted(hay, values, needles):
        calls.append(needles.size)
        assert needles.size <= max_needles
        return real(hay, values, needles)
    monkeypatch.setattr(pmesh, "sorted_membership", counted)
    monkeypatch.setattr(pmesh, "MAX_NEEDLES", max_needles)
    composite._INDEX_CACHE.clear()
    got = _port_tsv(edge_db["db"], edge_db["qry"], shard_db=1, min_km_s=1)
    assert got == _jax_tsv(edge_db["db"], edge_db["qry"], shard_db=1,
                           min_km_s=1)
    if max_needles >= 1 << 26:
        assert len(calls) == 5      # 2 queries x 3 components, 1 empty
    else:
        assert max(calls) == max_needles and len(calls) > 100


def test_numpy_statistics_without_the_host_library(edge_db, monkeypatch):
    """Where the host library did not build, numpy and _profile_stats
    give the same report."""
    monkeypatch.setattr(native, "postings_group_stats",
                        lambda *a, **kw: None)
    assert _port_tsv(edge_db["db"], edge_db["qry"], shard_db=1,
                     min_km_s=1) == _jax_tsv(edge_db["db"], edge_db["qry"],
                                             shard_db=1, min_km_s=1)


def test_cli_composite_shard_db_1(real_db, capsys):
    """composite -q [-b] --shard-db 1 through the CLI: the JAX CLI's
    stdout and vectors."""
    d = real_db
    argv = ["composite", "-r", d["db"], "-q", d["qry"], "--shard-db", "1"]
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert cli.main([*argv, "--device", "cpu"]) == 0
    assert want and capsys.readouterr().out == want
    a, b = str(d["tmp"] / "cli_abv_jax"), str(d["tmp"] / "cli_abv_port")
    assert jax_cli.main([*argv, "-b", "-o", a]) == 0
    assert cli.main([*argv, "-b", "-o", b, "--device", "cpu"]) == 0
    name = os.path.basename(d["fq"]) + ".abv"
    with open(os.path.join(a, name), "rb") as x, \
            open(os.path.join(b, name), "rb") as y:
        assert x.read() == y.read()


def test_profile_shard_db_1(real_db):
    """profile --shard-db 1 writes the JAX package's TSVs, which are the
    port's default route's."""
    d = real_db
    ref = str(d["tmp"] / "prof_jax")
    jax_profile_e2e.profile_fastq([d["fq"]], d["db"], d["shuf"], ref,
                                  shard_db=1)
    outs = {}
    for shard in (0, 1):
        outs[shard] = str(d["tmp"] / f"prof_port{shard}")
        assert cli.main(["profile", "-L", d["shuf"], "-r", d["db"], "-o",
                         outs[shard], "--shard-db", str(shard), "--device",
                         "cpu", d["fq"]]) == 0
    for f in ("species_coverage.tsv", "abundance.tsv"):
        with open(os.path.join(ref, f), "rb") as x:
            data = x.read()
        assert data
        for shard in (0, 1):
            with open(os.path.join(outs[shard], f), "rb") as y:
                assert y.read() == data, (f, shard)


def test_match_index_cached_per_markerdb(real_db):
    """The one-shard index is built once per MarkerDB and device."""
    composite._INDEX_CACHE.clear()
    _port_tsv(real_db["db"], real_db["qry"], shard_db=1)
    keys = list(composite._INDEX_CACHE)
    _port_tsv(real_db["db"], real_db["qry"], shard_db=1)
    assert list(composite._INDEX_CACHE) == keys and len(keys) == 1
    idx = composite._INDEX_CACHE[keys[0]]
    assert all(isinstance(x, pmesh.ShardedMatchIndex) or x is None
               for x in idx)
