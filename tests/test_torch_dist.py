"""The port's sketch search and stage II against the JAX package, byte for
byte, on the CPU.

A K8S5L2 reference (the prokaryote default, ``shuffle --usedefault``)
and queries of more than 2048 k-mers each (so every query spans two
blocks of the JAX package's membership kernel) are sketched with the
port's ``run_stage1``.  The port's ``run_dist_search`` and ``cli dist -r
... --device cpu`` must write ``distance.out`` (and ``sharedk_ct.dat``
where kept) byte-identical to ``metakssd_tpu``'s, for every output
option; stage II must write the same mco files as the JAX CLI.
"""

import os

import numpy as np
import pytest

from metakssd_tpu import cli as jax_cli
from metakssd_tpu import dist as jax_dist
from metakssd_tpu.formats.codir import CoDir, write_codir
from metakssd_tpu.formats.costat import CoStat
from metakssd_tpu.formats.shuf import make_shuf, read_shuf, write_shuf
from metakssd_tpu.params import SketchParams
from metakssd_tpu.parallel import mesh as jax_mesh
from metakssd_tpu.pipeline import organize_infiles

from metakssd_tpu_torch import cli, dist, pipeline
from metakssd_tpu_torch.parallel import mesh
from metakssd_tpu_torch.ops.profile_device import SUBW

from tests.util import random_seq, write_fasta

GENOME_LEN = 640_000       # about 2500 K8S5L2 k-mers per genome
OUT_FILES = ("distance.out", "sharedk_ct.dat")


def _mutate(rng, seq: str, rate: float) -> str:
    a = np.frombuffer(seq.encode(), np.uint8).copy()
    hit = np.flatnonzero(rng.random(a.size) < rate)
    codes = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), a[hit])
    a[hit] = np.frombuffer(b"ACGT", np.uint8)[
        (codes + rng.integers(1, 4, hit.size)) % 4]
    return a.tobytes().decode()


@pytest.fixture(scope="module")
def search_setup(tmp_path_factory):
    """(tmp, shuf path, genome dir, query fasta paths, ref sketch dir,
    query sketch dir)."""
    tmp = tmp_path_factory.mktemp("torch_dist")
    rng = np.random.default_rng(41)
    shufp = str(tmp / "K8S5L2.shuf")
    write_shuf(shufp, make_shuf(SketchParams(k=8, subk=5, drlevel=2),
                                seed=42))
    gdir, qdir = tmp / "genomes", tmp / "queries"
    gdir.mkdir()
    qdir.mkdir()
    genomes = [random_seq(rng, GENOME_LEN) for _ in range(5)]
    for i, g in enumerate(genomes):
        write_fasta(str(gdir / f"g{i}.fa"), [g])
    queries = [_mutate(rng, genomes[0], 0.01), _mutate(rng, genomes[2], 0.05),
               random_seq(rng, GENOME_LEN), genomes[4]]
    qpaths = []
    for i, q in enumerate(queries):
        qpaths.append(str(qdir / f"q{i}.fa"))
        write_fasta(qpaths[-1], [q])
    shuf = read_shuf(shufp)
    refco, qryco = str(tmp / "refco"), str(tmp / "qryco")
    pipeline.run_stage1(organize_infiles([str(gdir)]), shuf, refco,
                        device="cpu")
    stat = pipeline.run_stage1(qpaths, shuf, qryco, device="cpu")
    assert stat.ctx_ct.min() > 2048
    return tmp, shufp, str(gdir), qpaths, refco, qryco


def _same_outputs(a: str, b: str, names=OUT_FILES) -> None:
    for f in names:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        assert os.path.exists(pa) == os.path.exists(pb), f
        if os.path.exists(pa):
            with open(pa, "rb") as x, open(pb, "rb") as y:
                data = x.read()
                assert data and data == y.read(), f


def _both(setup, tag: str, opts: jax_dist.DistOptions, ref=None, **kw):
    """Run the JAX package's and the port's search with the same options
    and return their output dirs."""
    tmp, _, _, _, refco, qryco = setup
    ref = ref or refco
    a, b = str(tmp / f"jax_{tag}"), str(tmp / f"port_{tag}")
    jax_dist.run_dist_search(ref, qryco, a, opts, use_device=False, **kw)
    dist.run_dist_search(ref, qryco, b, opts, device="cpu", **kw)
    return a, b


@pytest.mark.parametrize("correction", [0, 1])
@pytest.mark.parametrize("outfields", [0, 1, 2])
@pytest.mark.parametrize("metric", [0, 1])
def test_distance_out_matches(search_setup, metric, outfields, correction):
    """-M x -O x --correction; --keepskf on half of them, so both the
    kept and the removed sharedk_ct.dat are compared."""
    opts = jax_dist.DistOptions(metric=metric, outfields=outfields,
                                correction=bool(correction),
                                keep_shared_kmer=metric == 1)
    a, b = _both(search_setup, f"m{metric}o{outfields}c{correction}", opts)
    _same_outputs(a, b)
    assert os.path.exists(os.path.join(b, "sharedk_ct.dat")) == (metric == 1)


@pytest.mark.parametrize("opt", [{"num_neigb": 2}, {"mut_dist_max": 0.02},
                                 {"num_neigb": 3, "mut_dist_max": 0.05,
                                  "metric": 1}])
def test_top_n_and_max_dist(search_setup, opt):
    """-N keeps each query's best refs; -D drops the distant ones."""
    a, b = _both(search_setup, "nd" + "_".join(map(str, opt.values())),
                 jax_dist.DistOptions(**opt))
    _same_outputs(a, b)
    with open(os.path.join(b, "distance.out")) as f:
        n_lines = len(f.read().splitlines()) - 1
    assert 0 < n_lines < 4 * 5


def test_memmap_matrix(search_setup):
    """-m: a matrix over the memory bound is counted straight into the
    memory-mapped sharedk_ct.dat."""
    opts = jax_dist.DistOptions(keep_shared_kmer=True)
    a, b = _both(search_setup, "memmap", opts, max_mem_gb=1e-9)
    _same_outputs(a, b)


def test_kept_matrix_reloads(search_setup):
    """-f: distance.out from a kept sharedk_ct.dat, counting nothing."""
    tmp = search_setup[0]
    a, _ = _both(search_setup, "keep", jax_dist.DistOptions(
        keep_shared_kmer=True))
    skf = os.path.join(a, "sharedk_ct.dat")
    opts = jax_dist.DistOptions(metric=1, shared_kmerpath=skf)
    x, y = _both(search_setup, "reload", opts)
    _same_outputs(x, y)
    assert os.path.exists(skf)


def test_cli_search_matches(search_setup, capsys):
    tmp, _, _, _, refco, qryco = search_setup
    flags = ["-M", "1", "-O", "1", "--correction", "1", "--keepskf"]
    a, b = str(tmp / "jax_cli"), str(tmp / "port_cli")
    assert jax_cli.main(["dist", "-r", refco, "-o", a, *flags, qryco]) == 0
    assert cli.main(["dist", "-r", refco, "-o", b, *flags, "--device", "cpu",
                     qryco]) == 0
    _same_outputs(a, b)


def test_sketch_then_search_matches(search_setup):
    """Fasta queries with -L <.shuf>: sketched, searched, and the
    temporary qry.co removed, as the JAX CLI does."""
    tmp, shufp, _, qpaths, refco, _ = search_setup
    a, b = str(tmp / "jax_sts"), str(tmp / "port_sts")
    assert jax_cli.main(["dist", "-r", refco, "-L", shufp, "-o", a,
                         *qpaths[:2]]) == 0
    assert cli.main(["dist", "-r", refco, "-L", shufp, "-o", b, "--device",
                     "cpu", *qpaths[:2]]) == 0
    _same_outputs(a, b)
    assert not os.path.exists(os.path.join(b, "qry.co"))


@pytest.fixture(scope="module")
def mco_setup(search_setup):
    """Stage II of the reference, by the JAX CLI and by the port's."""
    tmp, _, _, _, refco, _ = search_setup
    a, b = str(tmp / "jax_mco"), str(tmp / "port_mco")
    assert jax_cli.main(["dist", "-r", refco, "-o", a,
                         "--component_sz", "6"]) == 0
    assert cli.main(["dist", "-r", refco, "-o", b, "--component_sz", "6"]) \
        == 0
    return a, b


def _same_dir(a: str, b: str) -> None:
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    assert fa == fb and fa
    _same_outputs(a, b, fa)


def test_stage2_matches_jax_cli(mco_setup):
    _same_dir(*mco_setup)
    assert "mcofiles.stat" in os.listdir(mco_setup[1])


def test_mco_and_sketch_refs_agree(search_setup, mco_setup):
    """The mco-dir reference gives the sketch-dir reference's matrix,
    and the same distance.out as the JAX package against it."""
    _, _, _, _, refco, qryco = search_setup
    m_sketch = dist.shared_kmer_matrix(refco, qryco, device="cpu")
    m_mco = dist.shared_kmer_matrix(mco_setup[1], qryco, device="cpu")
    np.testing.assert_array_equal(m_sketch, m_mco)
    np.testing.assert_array_equal(
        m_sketch, jax_dist.shared_kmer_matrix(refco, qryco,
                                              use_device=False))
    assert m_sketch.max() > 2000
    a, b = _both(search_setup, "mco", jax_dist.DistOptions(
        keep_shared_kmer=True), ref=mco_setup[1])
    _same_outputs(a, b)


@pytest.fixture(scope="module")
def small_setup(tmp_path_factory):
    """Three 20 kbp genomes and a K6S4L2 shuffle, whose dense mco index
    at --component_sz 4 is small."""
    tmp = tmp_path_factory.mktemp("torch_dist_small")
    rng = np.random.default_rng(43)
    gdir = tmp / "genomes"
    gdir.mkdir()
    for i in range(3):
        write_fasta(str(gdir / f"s{i}.fa"), [random_seq(rng, 20_000)])
    shufp = str(tmp / "K6S4L2.shuf")
    write_shuf(shufp, make_shuf(SketchParams(k=6, subk=4, drlevel=2),
                                seed=44))
    return tmp, shufp, str(gdir)


def test_stage1_and_2_from_genomes(small_setup):
    """-r <genome dir> without queries: sketch, then invert."""
    tmp, shufp, gdir = small_setup
    a, b = str(tmp / "jax_s12"), str(tmp / "port_s12")
    assert jax_cli.main(["dist", "-r", gdir, "-L", shufp, "-o", a,
                         "--component_sz", "4"]) == 0
    assert cli.main(["dist", "-r", gdir, "-L", shufp, "-o", b,
                     "--component_sz", "4", "--device", "cpu"]) == 0
    _same_dir(a, b)


def test_stage2_of_positional_sketch_dir(small_setup):
    """dist -o out <sketch dir> (no -r) inverts the sketch dir too."""
    tmp, shufp, gdir = small_setup
    co = str(tmp / "co")
    assert cli.main(["dist", "-L", shufp, "-o", co, "--device", "cpu",
                     gdir]) == 0
    a, b = str(tmp / "jax_pos2"), str(tmp / "port_pos2")
    assert jax_cli.main(["dist", "-o", a, "--component_sz", "4", co]) == 0
    assert cli.main(["dist", "-o", b, "--component_sz", "4", co]) == 0
    _same_dir(a, b)
    assert "mcofiles.stat" in os.listdir(b)


def _dup_queries(qryco: str, out: str) -> str:
    """The query sketches with every third k-mer repeated, as per-read
    sketches repeat k-mers (tests/test_sharded_profile.py:50-63)."""
    qcd = CoDir.read(qryco, want_abund=False)
    dup = [[(np.sort(np.concatenate([qcd.genome_ids(c, g),
                                     qcd.genome_ids(c, g)[::3]])), None)
            for c in range(qcd.stat.comp_num)]
           for g in range(qcd.stat.infile_num)]
    write_codir(out, qcd.stat, dup)
    return out


def _long_rows(tmp) -> tuple[str, str]:
    """40 refs sharing a 50-k-mer core (posting rows longer than SUBW)
    and 3 queries with duplicates (tests/test_sharded_profile.py:136)."""
    rng = np.random.default_rng(3)
    core = np.unique(rng.integers(0, 1 << 24, 50).astype(np.uint32))
    per_genome = [[(np.unique(np.concatenate(
        [core, rng.integers(0, 1 << 24, 300).astype(np.uint32)])), None)]
        for _ in range(40)]
    per_q = []
    for i in range(3):
        hits = rng.choice(per_genome[i][0][0], 120)
        ids = np.sort(np.concatenate(
            [hits, hits[::2], core,
             rng.integers(0, 1 << 24, 80).astype(np.uint32)]))
        per_q.append([(ids.astype(np.uint32), None)])
    dirs = []
    for tag, rows in (("lr_ref", per_genome), ("lr_qry", per_q)):
        ctx = np.array([g[0][0].size for g in rows], np.uint32)
        stat = CoStat(7, False, 16, 4, 1, int(ctx.sum()), ctx,
                      [f"{tag}{i}" for i in range(len(rows))])
        dirs.append(str(tmp / tag))
        write_codir(dirs[-1], stat, rows)
    assert 40 > SUBW
    return dirs[0], dirs[1]


@pytest.mark.parametrize("case", ["sketches_dup", "long_rows"])
def test_shard_db_one_matches_mesh(search_setup, case):
    """--shard-db 1 equals the JAX package's sharded counts on a 1 x 1
    CPU mesh and the serial counts, duplicate query k-mers included."""
    tmp, _, _, _, refco, qryco = search_setup
    if case == "long_rows":
        ref, qry = _long_rows(tmp)
    else:
        ref, qry = refco, _dup_queries(qryco, str(tmp / "qry_dup"))
    got = mesh.sharded_shared_counts(ref, qry, "cpu")
    want = jax_mesh.sharded_shared_counts(
        ref, qry, jax_mesh.make_mesh(n_data=1, n_db=1))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jax_dist.shared_kmer_matrix(ref, qry, use_device=False))
    np.testing.assert_array_equal(
        got, dist.shared_kmer_matrix(ref, qry, device="cpu"))
    if case == "long_rows":
        assert got.min() > 0          # every (query, ref) shares the core
    else:
        once = dist.shared_kmer_matrix(refco, qryco, device="cpu")
        assert (got != once).any() and (got >= once).all()
        opts = jax_dist.DistOptions(keep_shared_kmer=True)
        a, b = str(tmp / "jax_shard1"), str(tmp / "port_shard1")
        jax_dist.run_dist_search(ref, qry, a, opts, shard_db=1)
        dist.run_dist_search(ref, qry, b, opts, device="cpu", shard_db=1)
        _same_outputs(a, b)


def test_shard_db_two_raises(search_setup, capsys):
    """dist -r --shard-db 2, which raised before the port had more than one
    shard, writes the JAX CLI's distance.out (and kept sharedk_ct.dat)."""
    tmp, _, _, _, refco, qryco = search_setup
    a, b = str(tmp / "jax_shard2"), str(tmp / "port_shard2")
    assert jax_cli.main(["dist", "-r", refco, "--shard-db", "2", "--keepskf",
                         "-o", a, qryco]) == 0
    assert cli.main(["dist", "-r", refco, "--shard-db", "2", "--keepskf",
                     "-o", b, "--device", "cpu", qryco]) == 0
    _same_outputs(a, b)
    capsys.readouterr()


def test_level_number_raises(search_setup, capsys):
    """-L takes a level number as the JAX CLI does (a shuffle is made into
    <outdir>/default.shuf); an -L that is neither a .shuf file nor a number
    fails with a one-line error, in both CLIs."""
    tmp, _, gdir, _, _, _ = search_setup
    a, b = str(tmp / "jax_lvl"), str(tmp / "port_lvl")
    assert jax_cli.main(["dist", "-L", "2", "--seed", "3", "-o", a,
                         gdir]) == 0
    assert cli.main(["dist", "-L", "2", "--seed", "3", "-o", b, "--device",
                     "cpu", gdir]) == 0
    _same_dir(a, b)
    assert "default.shuf" in os.listdir(b)
    capsys.readouterr()
    for main in (jax_cli.main, cli.main):
        assert main(["dist", "-L", "missing.shuf", "-o", str(tmp / "bad"),
                     gdir]) == 1
        err = capsys.readouterr().err
        assert "invalid literal" in err and "Traceback" not in err
