"""The port's shards (``metakssd_tpu_torch/parallel/mesh.py``) against the
JAX package's on the 8 virtual CPU devices of ``tests/conftest.py``, and
against the port's one-device paths, on the CPU.

``sharded_sketch`` over N data shards (a random stream, a stream shorter
than N windows, an empty one, a shard lying wholly in the overlap, a
poly-A block at a cut capacity through the K2 rerun); ``ShardedMatchIndex``
over N db shards (0xFFFFFFFF in the MarkerDB and in a query, keys >= 2^31,
fewer keys than shards, an empty component); ``sharded_shared_counts`` at
db 8, data 2 x db 4 and data 8 x db 1, duplicated query k-mers and posting
rows longer than a subrow; ``make_sharded_profile_step``;
``device_union`` over N.  Then the CLI: ``dist --mesh``, ``dist -A
--mesh``, ``profile --mesh``, ``dist -r --shard-db``, ``composite -q [-b]
--shard-db`` and ``profile --shard-db`` write what the JAX CLI writes,
byte for byte.
"""

import contextlib
import io
import os

import numpy as np
import pytest

from metakssd_tpu import cli as jax_cli
from metakssd_tpu import composite as jax_composite
from metakssd_tpu import dist as jax_dist
from metakssd_tpu.formats.shuf import make_shuf, write_shuf
from metakssd_tpu.ops import golden as jax_golden
from metakssd_tpu.parallel import mesh as jax_mesh

from metakssd_tpu_torch import cli, composite
from metakssd_tpu_torch.formats.codir import CoDir, write_codir
from metakssd_tpu_torch.formats.costat import CoStat
from metakssd_tpu_torch.formats.shuf import read_shuf
from metakssd_tpu_torch.ops import sketch, sketch_cuda
from metakssd_tpu_torch.params import SketchParams
from metakssd_tpu_torch.parallel import mesh

from tests.util import random_seq, reads_from_genome, write_fasta, \
    write_fastq

ALL_ONES = 0xFFFFFFFF


def _shuf(tmp, seed: int, cfg=(8, 5, 2)):
    path = str(tmp / f"s{seed}.shuf")
    write_shuf(path, make_shuf(SketchParams(*cfg), seed=seed))
    return path, read_shuf(path)


def _stream(rng, n: int) -> np.ndarray:
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[rng.integers(0, max(n, 1), n // 2000)] = 255
    return codes


# ---------------------------------------------------------------------------
# sharded_sketch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_sharded_sketch_matches_jax(tmp_path, n):
    """N data shards give the one-device sketch and the JAX package's
    sharded sketch on N virtual devices (tests/test_parallel.py:14)."""
    shufp, shuf = _shuf(tmp_path, 3)
    codes = _stream(np.random.default_rng(0), 200_000)
    got = mesh.sharded_sketch(codes, shuf, mesh.make_mesh(n, 1, "cpu"))
    assert got.dtype == np.uint64 and got.size > 500
    np.testing.assert_array_equal(got, sketch.sketch_codes(codes, shuf,
                                                           "cpu"))
    from metakssd_tpu.formats.shuf import read_shuf as jax_read_shuf
    np.testing.assert_array_equal(got, jax_mesh.sharded_sketch(
        codes, jax_read_shuf(shufp), jax_mesh.make_mesh(n_data=n, n_db=1)))


@pytest.mark.parametrize("case", ["short", "empty", "overlap", "one_tl",
                                  "polya_k2"])
def test_sharded_sketch_edges(tmp_path, case, monkeypatch):
    """Edges of the shard cut, for N in {1, 2, 3, 8}: a stream shorter than
    N windows (shards past its end are empty), an empty stream, 21 windows
    over 8 shards (the last shard lies wholly in the overlap), exactly one
    k-mer, and a poly-A block at a capacity of 4 kept windows a chunk, so
    the chunks overflow into K2 (counted); always the one-device sketch
    and golden."""
    _, shuf = _shuf(tmp_path, 5)
    tl = shuf.params.kmer_len
    rng = np.random.default_rng(7)
    kw = {}
    if case == "short":
        codes = _stream(rng, tl + 2)
    elif case == "empty":
        codes = np.zeros(0, np.uint8)
    elif case == "overlap":
        codes = _stream(rng, tl + 20)
    elif case == "one_tl":
        codes = _stream(rng, tl)
    else:
        codes = np.concatenate([_stream(rng, 30_000),
                                np.zeros(5_000, np.uint8),
                                _stream(rng, 30_000)])
        kw = {"capacity": 4, "chunk_windows": 7_000}
    full_calls = []
    real_full = sketch_cuda.window_full

    def counted(*a, **k):
        full_calls.append(1)
        return real_full(*a, **k)
    monkeypatch.setattr(sketch_cuda, "window_full", counted)
    want = np.sort(jax_golden.window_drtuples(codes, shuf)).astype(np.uint64)
    for n in (1, 2, 3, 8):
        got = mesh.sharded_sketch(codes, shuf, mesh.make_mesh(n, 1, "cpu"),
                                  **kw)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sketch.sketch_codes(codes, shuf, "cpu"),
                                  want)
    assert bool(full_calls) == (case == "polya_k2")
    if case == "polya_k2":
        assert want.size > 100


# ---------------------------------------------------------------------------
# ShardedMatchIndex
# ---------------------------------------------------------------------------

def _match_case(rng, nk: int, with_ones: bool):
    """Sorted distinct keys (half >= 2^31, 0xFFFFFFFF last when asked),
    posting starts (rows of 0-5 genomes) and genome ids."""
    rk = np.unique(rng.integers(0, ALL_ONES, nk * 2, dtype=np.uint64)
                   .astype(np.uint32))[:nk]
    if with_ones and nk:
        rk[-1] = ALL_ONES
        rk = np.unique(rk)
    lens = rng.integers(0, 6, rk.size)
    starts = np.zeros(rk.size + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    gid = rng.integers(0, 50, int(starts[-1])).astype(np.int32)
    return rk, starts, gid


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("case", ["full", "fewer_keys", "empty"])
def test_sharded_match_index(n, case):
    """``match`` over N db shards equals the port's one shard and the JAX
    ``ShardedMatchIndex`` on a 1 x N mesh; a query 0xFFFFFFFF matches
    where the MarkerDB holds it."""
    rng = np.random.default_rng(11 + n)
    nk = {"full": 3000, "fewer_keys": 3, "empty": 0}[case]
    rk, starts, gid = _match_case(rng, nk, with_ones=True)
    q = np.concatenate([rng.choice(rk, min(rk.size, 800)) if rk.size
                        else np.zeros(0, np.uint32),
                        rng.integers(0, ALL_ONES, 400, dtype=np.uint64)
                        .astype(np.uint32),
                        np.array([ALL_ONES], np.uint32)])
    qs = np.unique(q)
    ab = rng.integers(1, 300, qs.size).astype(np.uint16)
    ix = mesh.ShardedMatchIndex(rk, starts, gid, mesh.make_mesh(1, n, "cpu"))
    assert len(ix.hays) == n
    g, a = ix.match(qs, ab)
    g1, a1 = mesh.ShardedMatchIndex(rk, starts, gid, "cpu").match(qs, ab)
    jg, ja = jax_mesh.ShardedMatchIndex(
        rk, starts, gid, jax_mesh.make_mesh(n_data=1, n_db=n)).match(
        qs, ab, None)
    for x, y in ((g, g1), (a, a1), (g, jg), (a, ja)):
        np.testing.assert_array_equal(x, y)
    if nk and starts[-1] - starts[-2]:
        # the MarkerDB's last key is 0xFFFFFFFF: its postings are matched
        assert ab[-1] in a.tolist()
    assert (g.size > 0) == (case != "empty")


# ---------------------------------------------------------------------------
# sharded_shared_counts, make_sharded_profile_step, device_union
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """4 genomes and 2 queries sketched by the JAX CLI (as
    tests/test_sharded_profile.py:17), the queries with every third k-mer
    repeated, 40 references sharing a 50-k-mer core (rows longer than a
    subrow) with 3 duplicated queries, a fastq from genome 2 and its
    abundance sketch."""
    tmp = tmp_path_factory.mktemp("mesh_art")
    rng = np.random.default_rng(0)
    gdir = tmp / "g"
    gdir.mkdir()
    genomes = [random_seq(rng, 30000) for _ in range(4)]
    for i, g in enumerate(genomes):
        write_fasta(str(gdir / f"g{i}.fa"), [g])
    shufp, _ = _shuf(tmp, 11)
    co_ref = str(tmp / "co_ref")
    assert jax_cli.main(["dist", "-L", shufp, "-o", co_ref, str(gdir)]) == 0
    qdir = tmp / "q"
    qdir.mkdir()
    write_fasta(str(qdir / "q0.fa"), [genomes[1][:15000]])
    write_fasta(str(qdir / "q1.fa"), [random_seq(rng, 12000)])
    co_qry = str(tmp / "co_qry")
    assert jax_cli.main(["dist", "-L", shufp, "-o", co_qry, str(qdir)]) == 0
    qcd = CoDir.read(co_qry, want_abund=False)
    dup = [[(np.sort(np.concatenate([qcd.genome_ids(c, g),
                                     qcd.genome_ids(c, g)[::3]])), None)
            for c in range(qcd.stat.comp_num)]
           for g in range(qcd.stat.infile_num)]
    co_dup = str(tmp / "co_dup")
    write_codir(co_dup, qcd.stat, dup)
    core = np.unique(rng.integers(0, 1 << 30, 50).astype(np.uint32))
    per_genome = [[(np.unique(np.concatenate(
        [core, rng.integers(0, 1 << 30, 300).astype(np.uint32)])), None)]
        for _ in range(40)]
    per_q = []
    for i in range(3):
        hits = rng.choice(per_genome[i][0][0], 120)
        ids = np.sort(np.concatenate(
            [hits, hits[::2], core,
             rng.integers(0, 1 << 30, 80).astype(np.uint32)]))
        per_q.append([(ids.astype(np.uint32), None)])
    long_dirs = []
    for tag, rows in (("lr_ref", per_genome), ("lr_qry", per_q)):
        ctx = np.array([g[0][0].size for g in rows], np.uint32)
        long_dirs.append(str(tmp / tag))
        write_codir(long_dirs[-1], CoStat(7, False, 16, 4, 1, int(ctx.sum()),
                                          ctx, [f"{tag}{i}" for i in
                                                range(len(rows))]), rows)
    fq = str(tmp / "r.fq")
    write_fastq(fq, reads_from_genome(rng, genomes[2], 1500, 90)
                + reads_from_genome(rng, genomes[0], 300, 90))
    qko = str(tmp / "qko")
    assert jax_cli.main(["dist", "-L", shufp, "-A", "-o", qko, fq]) == 0
    return {"tmp": tmp, "shuf": shufp, "g": str(gdir), "ref": co_ref,
            "qry": co_qry, "dup": co_dup, "lr_ref": long_dirs[0],
            "lr_qry": long_dirs[1], "fq": fq, "qko": qko}


@pytest.mark.parametrize("layout", [(1, 8), (2, 4), (8, 1), (1, 3)])
@pytest.mark.parametrize("which", ["plain", "dup", "long_rows"])
def test_sharded_shared_counts(art, layout, which):
    """n_data x n_db shards give the serial counts and the JAX package's
    on the same mesh shape (tests/test_sharded_profile.py:17-62,
    136-180)."""
    ref, qry = {"plain": (art["ref"], art["qry"]),
                "dup": (art["ref"], art["dup"]),
                "long_rows": (art["lr_ref"], art["lr_qry"])}[which]
    got = mesh.sharded_shared_counts(ref, qry, mesh.make_mesh(*layout,
                                                              "cpu"))
    serial = jax_dist.shared_kmer_matrix(ref, qry, use_device=False)
    assert got.dtype == np.uint32 and serial.max() > 0
    np.testing.assert_array_equal(got, serial)
    np.testing.assert_array_equal(got, jax_mesh.sharded_shared_counts(
        ref, qry, jax_mesh.make_mesh(*layout)))


def test_sharded_profile_step_counts():
    """At the shape of tests/test_parallel.py:28 (4 data x 2 db shards,
    4096 windows a shard): the host recomputation and the JAX step."""
    k, subk, drlevel, nwin, num_refs = 8, 5, 2, 1 << 12, 16
    from metakssd_tpu.formats.shuf import make_shuf as jax_make_shuf
    from metakssd_tpu.params import SketchParams as JaxParams
    shuf = jax_make_shuf(JaxParams(k=k, subk=subk, drlevel=drlevel), seed=9)
    rng = np.random.default_rng(4)
    n_data, n_db = 4, 2
    codes = rng.integers(0, 4, size=(n_data, nwin + 2 * k - 1)) \
        .astype(np.uint8)
    uniq = np.unique(np.concatenate(
        [jax_golden.window_drtuples(codes[d], shuf) for d in range(n_data)]
    )).astype(np.uint32)
    npost = 1 << 10
    ref_ids = rng.integers(0, 2 ** 32 - 2, size=(n_db, npost),
                           dtype=np.uint64).astype(np.uint32)
    take = min(uniq.size, npost // 2)
    for d in range(n_db):
        ref_ids[d, :take] = rng.choice(uniq, size=take, replace=False)
    ref_ids = np.sort(ref_ids, axis=1)
    ref_gid = rng.integers(0, num_refs, size=(n_db, npost), dtype=np.int32)
    acc, pf = shuf.accept_table()[:2]
    step = mesh.make_sharded_profile_step(
        mesh.make_mesh(n_data, n_db, "cpu"), k=k, subk=subk,
        drlevel=drlevel, nwin=nwin, num_refs=num_refs)
    out = step(codes, acc, pf, ref_ids.reshape(-1), ref_gid.reshape(-1))
    expect = np.zeros(num_refs, np.int64)
    hit = np.isin(ref_ids, uniq)
    np.add.at(expect, ref_gid[hit], 1)
    assert out.dtype == np.uint32 and expect.sum() > 0
    np.testing.assert_array_equal(out, expect)
    import jax.numpy as jnp
    jstep = jax_mesh.make_sharded_profile_step(
        jax_mesh.make_mesh(n_data=n_data, n_db=n_db), k=k, subk=subk,
        drlevel=drlevel, nwin=nwin, max_out=512, num_refs=num_refs)
    np.testing.assert_array_equal(out, np.asarray(jstep(
        jnp.asarray(codes), jnp.asarray(acc), jnp.asarray(pf),
        jnp.asarray(ref_ids.reshape(-1)), jnp.asarray(ref_gid.reshape(-1)))))


@pytest.mark.parametrize("n", [2, 3, 8])
def test_device_union_over_shards(n):
    """N data shards: ``np.unique``'s values and exact counts, and the JAX
    ``device_union`` (per-device counts capped at 2) on N devices."""
    rng = np.random.default_rng(20 + n)
    ids = np.concatenate([
        rng.integers(0, ALL_ONES, 5000, dtype=np.uint64).astype(np.uint32),
        rng.integers(0, 300, 3000).astype(np.uint32),
        np.full(3, ALL_ONES, np.uint32),
        np.full(2, 1 << 31, np.uint32)])
    rng.shuffle(ids)
    m = mesh.make_mesh(n, 1, "cpu")
    vals, counts = mesh.device_union(ids, m, return_counts=True)
    want_v, want_c = np.unique(ids, return_counts=True)
    np.testing.assert_array_equal(vals, want_v)
    np.testing.assert_array_equal(counts, want_c)
    np.testing.assert_array_equal(mesh.device_union(ids, m), want_v)
    jm = jax_mesh.make_mesh(n_data=n, n_db=1)
    jv, jc = jax_mesh.device_union(ids, jm, return_counts=True)
    np.testing.assert_array_equal(vals, jv)
    # the JAX counts sum each device's count capped at 2: they agree on
    # which values occur once, what ``set -q`` keeps
    np.testing.assert_array_equal(counts == 1, jc == 1)
    assert (jc <= counts).all()
    assert mesh.device_union(ids[:0], m).size == 0


def test_make_mesh_layout():
    """Shards row-major, all on the CPU, every row local in one process;
    the layout is recorded; bad sizes raise."""
    from metakssd_tpu_torch.utils import TIMER
    m = mesh.make_mesh(2, 3, "cpu")
    assert (m.n_data, m.n_db, m.local_rows) == (2, 3, [0, 1])
    assert [(s.data, s.db, s.rank, str(s.device)) for s in m.row(1)] == \
        [(1, j, 0, "cpu") for j in range(3)]
    assert TIMER.meta["mesh"] == "2x3 over 1 process"
    assert mesh.make_mesh(None, 1, "cpu").n_data == 1
    with pytest.raises(ValueError):
        mesh.make_mesh(0, 1, "cpu")


# ---------------------------------------------------------------------------
# the CLI, byte for byte
# ---------------------------------------------------------------------------

def _files(root: str) -> dict:
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = sorted(x for x in dirs if not x.startswith("."))
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _same(a: str, b: str) -> None:
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb) and fa
    for f in fa:
        assert fa[f] == fb[f], f


@pytest.mark.parametrize("case", ["dist_mesh8", "dist_A_mesh2",
                                  "profile_mesh2", "dist_P_mesh2",
                                  "dist_ckpt_mesh3", "dist_byread_mesh2"])
def test_cli_mesh_matches_jax(art, case):
    """``--mesh`` in the port's CLI writes the JAX CLI's files, also with
    ``-P`` (the piped stream is sharded), ``--ckpt`` (per-file snapshots,
    no batching) and ``--byread`` (which, as in the JAX package, takes no
    shards)."""
    tmp, shufp = art["tmp"], art["shuf"]
    a, b = str(tmp / f"jax_{case}"), str(tmp / f"port_{case}")
    argv = {"dist_mesh8": ["dist", "-L", shufp, "--mesh", "8", art["g"]],
            "dist_A_mesh2": ["dist", "-L", shufp, "-A", "--mesh", "2",
                             art["fq"]],
            "profile_mesh2": ["profile", "-L", shufp, "-r", art["ref"],
                              "--mesh", "2", art["fq"]],
            "dist_P_mesh2": ["dist", "-L", shufp, "-P", "cat", "--mesh",
                             "2", art["fq"]],
            "dist_ckpt_mesh3": ["dist", "-L", shufp, "--ckpt", "--mesh", "3",
                                art["g"]],
            "dist_byread_mesh2": ["dist", "-L", shufp, "--byread", "--mesh",
                                  "2", art["fq"]]}[case]
    assert jax_cli.main(argv + ["-o", a]) == 0
    assert cli.main(argv + ["-o", b, "--device", "cpu"]) == 0
    _same(a, b)


def _tsv(main, argv) -> bytes:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().encode()


@pytest.mark.parametrize("case", ["dist_r2", "dist_r4", "composite4",
                                  "composite_b4", "profile4"])
def test_cli_shard_db_matches_jax(art, case):
    """``--shard-db`` above 1 in the port's CLI writes the JAX CLI's
    files, and the port's serial run's."""
    tmp, shufp = art["tmp"], art["shuf"]
    a, b, c = (str(tmp / f"{w}_{case}") for w in ("jax", "port", "serial"))
    n = case[-1]
    if case.startswith("dist_r"):
        for main, out, extra in ((jax_cli.main, a, ["--shard-db", n]),
                                 (cli.main, b, ["--shard-db", n, "--device",
                                                "cpu"]),
                                 (cli.main, c, ["--device", "cpu"])):
            assert main(["dist", "-r", art["ref"], "-o", out, *extra,
                         art["dup"]]) == 0
        _same(a, b)
        _same(c, b)
        return
    if case == "profile4":
        base = ["profile", "-L", shufp, "-r", art["ref"], art["fq"]]
        assert jax_cli.main(base + ["-o", a, "--shard-db", n]) == 0
        assert cli.main(base + ["-o", b, "--shard-db", n, "--device",
                                "cpu"]) == 0
        assert cli.main(base + ["-o", c, "--device", "cpu"]) == 0
        _same(a, b)
        _same(c, b)
        return
    base = ["composite", "-r", art["ref"], "-q", art["qko"]]
    if case == "composite_b4":
        for main, out, extra in ((jax_cli.main, a, ["--shard-db", n]),
                                 (cli.main, b, ["--shard-db", n, "--device",
                                                "cpu"])):
            assert main(base + ["-b", "-o", out, *extra]) == 0
        _same(a, b)
        return
    composite._INDEX_CACHE.clear()
    want = _tsv(jax_cli.main, base + ["--shard-db", n])
    assert want and want == _tsv(cli.main, base + ["--shard-db", n,
                                                   "--device", "cpu"])
    assert want == _tsv(cli.main, base + ["--device", "cpu"])
    assert [k[4][:2] for k in composite._INDEX_CACHE if k[3]] == [(1, 4)]
    jax_composite.wait_staging()


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """K12S6L2 (k - drlevel > 8, so the golden route, off the kernels'):
    six 40 kbp genomes sketched by the JAX CLI as the reference and a
    1,603-read fastq from genome 2."""
    tmp = tmp_path_factory.mktemp("mesh_wide")
    shufp, _ = _shuf(tmp, 20, (12, 6, 2))
    rng = np.random.default_rng(1)
    gdir = tmp / "g"
    gdir.mkdir()
    genomes = [random_seq(rng, 40_000) for _ in range(6)]
    for i, g in enumerate(genomes):
        write_fasta(str(gdir / f"g{i}.fa"), [g])
    fq = str(tmp / "r.fq")
    write_fastq(fq, reads_from_genome(np.random.default_rng(3), genomes[2],
                                      1603, 120))
    ref = str(tmp / "ref")
    assert jax_cli.main(["dist", "-L", shufp, "-o", ref, str(gdir)]) == 0
    return {"tmp": tmp, "shuf": shufp, "g": str(gdir), "fq": fq,
            "ref": ref}


@pytest.mark.parametrize("case", ["dist_mesh3", "profile_mesh2"])
def test_cli_mesh_wide_matches_jax_serial(wide, case):
    """``--mesh`` at (12, 6, 2): each shard takes the golden route, and
    the files are the JAX CLI's without ``--mesh`` (the JAX CLI itself
    raises under ``--mesh`` there, ``metakssd_tpu/ops/sketch_xla.py:173``,
    a difference kept on purpose)."""
    a, b = str(wide["tmp"] / f"jax_{case}"), str(wide["tmp"] / f"port_{case}")
    argv, n = {"dist_mesh3": (["dist", "-L", wide["shuf"], wide["g"]], "3"),
               "profile_mesh2": (["profile", "-L", wide["shuf"], "-r",
                                  wide["ref"], wide["fq"]], "2")}[case]
    assert jax_cli.main(argv + ["-o", a]) == 0
    assert cli.main(argv + ["-o", b, "--mesh", n, "--device", "cpu"]) == 0
    _same(a, b)
