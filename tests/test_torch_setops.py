"""The port's set algebra against the JAX package, byte for byte, on the
CPU.

``parallel.mesh.device_union`` must equal ``np.unique`` and the JAX
``mesh.device_union`` (values and counts).  ``cli set -u/-q/-s/-i/-g/-c/-P
--device cpu`` must write the directories and stdout of ``metakssd_tpu``'s
CLI, on one component and on sixteen, against the host route and the
``MKSSD_DEVICE_SETOPS=1`` route of the JAX package alike; ``dist`` given
several sketch dirs must combine them as the JAX CLI does; and the
MarkerDB chain (``dist`` -> ``set -g`` -> ``set -q`` -> ``set -i`` ->
``composite -q`` / ``-q -b``) must give the same TSVs and ``.abv`` files.
"""

import os

import numpy as np
import pytest

from metakssd_tpu import cli as jax_cli
from metakssd_tpu.formats.costat import CoStat
from metakssd_tpu.formats.shuf import make_shuf, write_shuf
from metakssd_tpu.params import SketchParams
from metakssd_tpu.parallel import mesh as jax_mesh

from metakssd_tpu_torch import cli
from metakssd_tpu_torch.parallel import mesh

from tests.util import random_seq, reads_from_genome, write_fasta, \
    write_fastq

ALL_ONES = 0xFFFFFFFF
TAXA = [(101, "Escherichia_coli"), (0, None), (101, "Escherichia_coli"),
        (202, "Bacillus_subtilis")]


def _union_case(name: str) -> np.ndarray:
    rng = np.random.default_rng(len(name) + 7)
    if name == "empty":
        return np.zeros(0, np.uint32)
    if name == "all_equal":
        return np.full(1000, 12345, np.uint32)
    if name == "high_bit":            # u32 keys >= 2^31 beside small ones
        return np.concatenate([
            rng.integers(1 << 31, 1 << 32, 5000, dtype=np.uint64),
            rng.integers(0, 1000, 5000, dtype=np.uint64)]).astype(np.uint32)
    if name.startswith("all_ones"):
        ones = 1 if name == "all_ones_once" else 2
        return np.concatenate([rng.integers(0, 1 << 32, 3000,
                                            dtype=np.uint64).astype(np.uint32),
                               np.full(ones, ALL_ONES, np.uint32)])
    if name == "dup_heavy":
        return rng.integers(0, 1 << 12, 1 << 16, dtype=np.uint32)
    return rng.integers(0, 1 << 32, 100_001,                # odd size
                        dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("name", ["empty", "all_equal", "high_bit",
                                  "all_ones_once", "all_ones_twice",
                                  "dup_heavy", "odd_size"])
def test_device_union_matches(name):
    """Values and exact counts equal np.unique's; the JAX union on the
    8-device CPU mesh gives the same values, and counts (capped at 2 per
    device, then summed) that are 1 exactly where the port's are."""
    ids = _union_case(name)
    want_v, want_c = np.unique(ids, return_counts=True)
    got = mesh.device_union(ids, "cpu")
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want_v)
    got_v, got_c = mesh.device_union(ids, "cpu", return_counts=True)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_c, want_c)
    m = jax_mesh.make_mesh(n_db=1)
    np.testing.assert_array_equal(jax_mesh.device_union(ids, m), got)
    jv, jc = jax_mesh.device_union(ids, m, return_counts=True)
    np.testing.assert_array_equal(jv, got_v)
    np.testing.assert_array_equal(jc == 1, got_c == 1)
    assert (jc <= got_c).all()
    if name.startswith("all_ones"):
        ones = 2 if name == "all_ones_twice" else 1
        assert got[-1] == ALL_ONES and got_c[-1] == ones


def _same_dir(a: str, b: str) -> None:
    fa = sorted(f for f in os.listdir(a) if not f.startswith("."))
    fb = sorted(f for f in os.listdir(b) if not f.startswith("."))
    assert fa == fb and fa
    for f in fa:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f


def _both(capsys, jax_argv, port_argv):
    """Run the JAX CLI and the port's CLI; return their stdouts."""
    assert jax_cli.main(jax_argv) == 0
    a = capsys.readouterr().out
    assert cli.main(port_argv) == 0
    return a, capsys.readouterr().out


@pytest.fixture(scope="module", params=["one_comp", "sixteen_comps"])
def set_dirs(request, tmp_path_factory):
    """The genomes of tests/test_setops.py (overlapping, so every set
    operation is non-trivial), sketched by the JAX CLI at K8S5L2 with
    one component or, at --component_sz 5, sixteen; their pan and
    uniq_pan by the JAX CLI; and a taxon file with a taxid-0 genome."""
    tmp = tmp_path_factory.mktemp(f"torch_setops_{request.param}")
    rng = np.random.default_rng(0)
    gdir = tmp / "genomes"
    gdir.mkdir()
    base = random_seq(rng, 20000)
    seqs = [base, base[:10000] + random_seq(rng, 10000),
            random_seq(rng, 20000), base[5000:15000] + random_seq(rng, 5000)]
    for i, s in enumerate(seqs):
        write_fasta(str(gdir / f"g{i}.fa"), [s])
    shufp = str(tmp / "t.shuf")
    write_shuf(shufp, make_shuf(SketchParams(k=8, subk=5, drlevel=2),
                                seed=31))
    cs = ["--component_sz", "5"] if request.param == "sixteen_comps" else []
    co = str(tmp / "co")
    assert jax_cli.main(["dist", "-L", shufp, "-o", co, *cs, str(gdir)]) == 0
    assert CoStat.read(co).comp_num == (16 if cs else 1)
    pan, upan = str(tmp / "pan"), str(tmp / "upan")
    assert jax_cli.main(["set", "-u", "-o", pan, co]) == 0
    assert jax_cli.main(["set", "-q", "-o", upan, co]) == 0
    taxf = str(tmp / "tax.tsv")
    with open(taxf, "w") as f:
        f.writelines(f"{t}\t{n}\n" if n else f"{t}\n" for t, n in TAXA)
    return tmp, co, pan, upan, taxf


def _set_args(verb: str, co, pan, upan, taxf) -> list:
    return {"-u": ["-u", co], "-q": ["-q", co], "-s": ["-s", upan, co],
            "-i": ["-i", upan, co], "-g": ["-g", taxf, co],
            "-c": ["-c", pan, upan], "-P": ["-P", co]}[verb]


@pytest.mark.parametrize("verb", ["-u", "-q", "-s", "-i", "-g", "-c", "-P"])
def test_set_verb_matches_jax_cli(set_dirs, verb, capsys):
    tmp, co, pan, upan, taxf = set_dirs
    args = _set_args(verb, co, pan, upan, taxf)
    tag = verb[1:]
    a, b = str(tmp / f"jax_{tag}"), str(tmp / f"port_{tag}")
    out_a, out_b = _both(capsys, ["set", "-o", a, *args],
                         ["set", "-o", b, "--device", "cpu", *args])
    assert out_a == out_b
    if verb == "-P":
        assert out_b.count("\n") == 4 and not os.path.exists(b)
        return
    _same_dir(a, b)
    if verb == "-g":
        assert CoStat.read(b).names == ["101_Escherichia_coli",
                                        "202_Bacillus_subtilis"]


@pytest.mark.parametrize("verb", ["-u", "-q"])
def test_set_union_matches_jax_device_route(set_dirs, verb, capsys,
                                            monkeypatch):
    """The JAX package's device union (MKSSD_DEVICE_SETOPS=1, the 8-device
    CPU mesh) writes the files the port writes."""
    tmp, co, *_ = set_dirs
    a, b = str(tmp / f"jaxdev_{verb[1:]}"), str(tmp / f"portdev_{verb[1:]}")
    monkeypatch.setenv("MKSSD_DEVICE_SETOPS", "1")
    _both(capsys, ["set", verb, "-o", a, co],
          ["set", verb, "-o", b, "--device", "cpu", co])
    _same_dir(a, b)


def test_set_without_operation_prints_usage(set_dirs, capsys):
    co = set_dirs[1]
    assert jax_cli.main(["set", co]) == 1
    a = capsys.readouterr().out
    assert cli.main(["set", "--device", "cpu", co]) == 1
    assert capsys.readouterr().out == a and "-u, -q, -i or -s" in a


@pytest.mark.parametrize("case", ["shuf_mismatch", "taxfile_count"])
def test_set_errors_are_one_line(set_dirs, case, capsys):
    tmp, co, pan, upan, taxf = set_dirs
    if case == "shuf_mismatch":
        other = str(tmp / "other_shuf_pan")
        st = CoStat.read(upan)
        os.makedirs(other, exist_ok=True)
        CoStat(st.shuf_id + 1, st.koc, st.kmerlen, st.dim_rd_len,
               st.comp_num, st.all_ctx_ct, st.ctx_ct, st.names).write(other)
        argv = ["set", "-s", other, "-o", str(tmp / "x"), "--device", "cpu",
                co]
        want = "sketching id not match"
    else:
        bad = str(tmp / "short_tax.tsv")
        with open(bad, "w") as f:
            f.writelines(f"{t}\t{n}\n" for t, n in TAXA[::2] * 3)
        argv = ["set", "-g", bad, "-o", str(tmp / "y"), "--device", "cpu",
                co]
        want = "does not match taxfile"
    assert cli.main(argv) == 1
    err = capsys.readouterr().err
    assert want in err and "Traceback" not in err


@pytest.mark.parametrize("kind", ["sketches", "abundance"])
def test_dist_combines_sketch_dirs(tmp_path, kind, capsys):
    """dist -o out <dir> <dir> ... concatenates the genomes (and, for
    abundance sketches, their counts) as the JAX CLI does."""
    rng = np.random.default_rng(8)
    shufp = str(tmp_path / "t.shuf")
    write_shuf(shufp, make_shuf(SketchParams(k=8, subk=5, drlevel=2),
                                seed=9))
    dirs = []
    for i in range(3):
        g = random_seq(rng, 15000)
        if kind == "abundance":
            src = str(tmp_path / f"r{i}.fq")
            write_fastq(src, reads_from_genome(rng, g, 300, 100))
            flags = ["-A"]
        else:
            src = str(tmp_path / f"g{i}.fa")
            write_fasta(src, [g])
            flags = []
        dirs.append(str(tmp_path / f"co{i}"))
        assert jax_cli.main(["dist", "-L", shufp, *flags, "-o", dirs[-1],
                             src]) == 0
    a, b = str(tmp_path / "jax_comb"), str(tmp_path / "port_comb")
    _both(capsys, ["dist", "-o", a, *dirs],
          ["dist", "-o", b, "--device", "cpu", *dirs])
    _same_dir(a, b)
    st = CoStat.read(b)
    assert st.infile_num == 3 and st.koc == (kind == "abundance")


def test_markerdb_chain_matches(tmp_path, capsys):
    """The reference's MarkerDB chain with no oracle: every directory,
    the profile TSV and the abundance vectors equal the JAX CLI's."""
    rng = np.random.default_rng(0)
    gdir = tmp_path / "genomes"
    gdir.mkdir()
    species = [random_seq(rng, 30000) for _ in range(3)]
    for s, base in enumerate(species):
        for v in range(2):
            write_fasta(str(gdir / f"sp{s}_v{v}.fa"),
                        [base[:20000] + random_seq(rng, 10000)])
    shufp = str(tmp_path / "t.shuf")
    write_shuf(shufp, make_shuf(SketchParams(k=8, subk=5, drlevel=2),
                                seed=55))
    reads = (reads_from_genome(rng, species[0], 2000, 100)
             + reads_from_genome(rng, species[2], 500, 100))
    fq = str(tmp_path / "sample.fq")
    write_fastq(fq, reads)
    taxf = str(tmp_path / "grp.tsv")
    with open(taxf, "w") as f:
        f.writelines(f"{s + 1}\tspecies_{s}\n" for s in range(3)
                     for _ in range(2))

    def chain(tool, tag, dev):
        d = {k: str(tmp_path / f"{tag}_{k}")
             for k in ("sk", "pan", "uq", "db", "qco", "abv")}
        run = [tool.main(["dist", "-L", shufp, "-o", d["sk"], *dev,
                          str(gdir)]),
               tool.main(["set", "-g", taxf, "-o", d["pan"], *dev, d["sk"]]),
               tool.main(["set", "-q", "-o", d["uq"], *dev, d["pan"]]),
               tool.main(["set", "-i", d["uq"], "-o", d["db"], *dev,
                          d["pan"]]),
               tool.main(["dist", "-L", shufp, "-A", "-o", d["qco"], *dev,
                          fq])]
        capsys.readouterr()
        run.append(tool.main(["composite", "-r", d["db"], "-q", d["qco"],
                              *dev]))
        tsv = capsys.readouterr().out
        run.append(tool.main(["composite", "-r", d["db"], "-q", d["qco"],
                              "-b", "-o", d["abv"], *dev]))
        assert run == [0] * len(run)
        return d, tsv

    ja, tsv_a = chain(jax_cli, "jax", [])
    po, tsv_b = chain(cli, "port", ["--device", "cpu"])
    for k in ("sk", "pan", "uq", "db", "qco", "abv"):
        _same_dir(ja[k], po[k])
    assert tsv_a == tsv_b
    rows = [ln.split("\t") for ln in tsv_b.splitlines()]
    assert {r[1] for r in rows} == {"1_species_0", "3_species_2"}
