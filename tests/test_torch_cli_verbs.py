"""The rest of the port's CLI against ``metakssd_tpu.cli``, on the CPU.

``shuffle``, ``reverse``, every ``postprocess`` subcommand and ``primer``
must print and write what the JAX CLI does; ``dist`` with ``-k``,
``--seed``, a level ``-L`` (or none), ``-u`` and ``--keepcofile`` must
write byte-identical directories; and the README quickstart, run through
``metakssd_tpu_torch.cli`` (``--device cpu`` where the verb takes it),
must leave every artifact the JAX CLI leaves, byte for byte.
"""

import contextlib
import os
import shlex

import numpy as np
import pytest

from metakssd_tpu import cli as jax_cli
from metakssd_tpu.formats.shuf import make_shuf, write_shuf
from metakssd_tpu.params import SketchParams

from metakssd_tpu_torch import cli

from tests.test_postprocess import COMPOSITE_TSV
from tests.test_readme_quickstart import _quickstart_commands
from tests.util import random_genome_with_repeats, random_seq, \
    reads_from_genome, write_fasta, write_fastq


def _tree(root: str) -> dict:
    """{relative path: bytes} of every file under ``root``, hidden
    directories (the MarkerDB staging sidecars) left out."""
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = sorted(x for x in dirs if not x.startswith("."))
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _same_tree(a: str, b: str) -> None:
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb) and ta
    for f in ta:
        assert ta[f] == tb[f], f


def _both(capsys, jax_argv, port_argv):
    """Run the JAX CLI and the port's CLI; return their stdouts."""
    assert jax_cli.main(jax_argv) == 0
    a = capsys.readouterr().out
    assert cli.main(port_argv) == 0
    return a, capsys.readouterr().out


@pytest.mark.parametrize("flags", [["-k", "9", "-s", "6", "-l", "3"],
                                   ["--usedefault", "-k", "9", "-l", "3"]])
def test_shuffle_matches(tmp_path, flags, capsys):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    out_a, out_b = _both(capsys, ["shuffle", *flags, "-o", a, "--seed", "4"],
                         ["shuffle", *flags, "-o", b, "--seed", "4"])
    assert out_a == out_b and "shuf_id" in out_b
    with open(a + ".shuf", "rb") as x, open(b + ".shuf", "rb") as y:
        assert x.read() == y.read()


@pytest.mark.parametrize("byreads", [False, True])
def test_reverse_matches(tmp_path, byreads, capsys):
    """reverse of a sixteen-component sketch dir, and reverse -b of a
    per-read sketch (made by the port's CLI)."""
    rng = np.random.default_rng(13)
    gdir = tmp_path / "g"
    gdir.mkdir()
    for i in range(2):
        write_fasta(str(gdir / f"x{i}.fa"),
                    [random_seq(rng, 12000), random_seq(rng, 8000)])
    shufp = str(tmp_path / "t.shuf")
    write_shuf(shufp, make_shuf(SketchParams(k=8, subk=5, drlevel=2),
                                seed=13))
    co = str(tmp_path / "co")
    flags = ["--byread"] if byreads else ["--component_sz", "5"]
    src = str(gdir / "x0.fa") if byreads else str(gdir)
    if byreads:
        assert cli.main(["dist", "-L", shufp, *flags, "-o", co, "--device",
                         "cpu", src]) == 0
    else:
        assert jax_cli.main(["dist", "-L", shufp, *flags, "-o", co,
                             src]) == 0
    a, b = str(tmp_path / "rev_jax"), str(tmp_path / "rev_port")
    b_flag = ["-b"] if byreads else []
    out_a, out_b = _both(capsys,
                         ["reverse", "-L", shufp, *b_flag, "-o", a, co],
                         ["reverse", "-L", shufp, *b_flag, "-o", b, co])
    assert out_a == out_b
    if byreads:
        assert out_b.count(">read") == 2 and not os.path.exists(b)
    else:
        _same_tree(a, b)
        assert sorted(os.listdir(b)) == ["x0.fa", "x1.fa"]


def _pp_inputs(tmp) -> dict:
    files = {
        "comp.tsv": "".join(COMPOSITE_TSV),
        "nodes.tsv": "2\tsuperkingdom\t1\tBacteria\n"
                     "10\tphylum\t2\tProteobacteria\n"
                     "11\tphylum\t2\tFirmicutes\n"
                     "100\tspecies\t10\tEscherichia coli\n"
                     "101\tspecies\t11\tBacillus subtilis\n"
                     "102\tspecies\t11\tVibrio x\n",
        "psid.tsv": "17\t100\n33\t101\n77\t102\n",
        "psid.list": "17_Escherichia coli\n33_Bacillus subtilis\n",
        "gtdb.list": "d__Bacteria;p__Proteobacteria;c__Gamma;o__Ent;f__Entb;"
                     "g__Escherichia;s__Escherichia coli\n"
                     "d__Bacteria;p__Firmicutes;c__Bacilli;o__Bac;f__Bacil;"
                     "g__Bacillus;s__Bacillus subtilis\n",
        "abv.tsv": "#Sample\tCosineXY\nSRR001.fastq.abv\t0.98\n"
                   "SRR999.abv\t0.55\n",
        "meta.csv": "run,proj,sample,organism\n"
                    "SRR001,PRJ1,SAMN1,Homo sapiens gut\n",
        "t.csv": "id1,a,b\nid2,c,d\nid3,e,f\nid2,x,y\n",
        "sel.tsv": "id2\tmeta\nid9\tzz\nid1\n",
    }
    for name, text in files.items():
        (tmp / name).write_text(text)
    return {k: str(tmp / k) for k in files}


@pytest.mark.parametrize("sub", ["poisson", "cami", "krona", "abv-metadata",
                                 "csv-subset", "ordcsv-subset", "primer"])
def test_postprocess_and_primer_match(tmp_path, sub, capsys):
    f = _pp_inputs(tmp_path)
    argv = {"poisson": ["postprocess", "poisson", f["comp.tsv"],
                        "--shkm-thr", "6"],
            "cami": ["postprocess", "cami", f["comp.tsv"], f["psid.tsv"],
                     f["nodes.tsv"], "--shkm-thr", "18", "--low-thr", "1"],
            "krona": ["postprocess", "krona", f["psid.list"], f["gtdb.list"]],
            "abv-metadata": ["postprocess", "abv-metadata", f["abv.tsv"],
                             f["meta.csv"]],
            "csv-subset": ["postprocess", "csv-subset", f["t.csv"],
                           f["sel.tsv"]],
            "ordcsv-subset": ["postprocess", "ordcsv-subset", f["t.csv"],
                              f["sel.tsv"]],
            "primer": ["primer"]}[sub]
    out_a, out_b = _both(capsys, argv, argv)
    assert out_a == out_b and out_b.strip()


@pytest.fixture(scope="module")
def genome_inputs(tmp_path_factory):
    """Three fasta genomes with duplicated segments (so -u drops k-mers)
    and two fastq read sets."""
    tmp = tmp_path_factory.mktemp("torch_cli_dist")
    rng = np.random.default_rng(17)
    gdir = tmp / "genomes"
    gdir.mkdir()
    for i in range(3):
        write_fasta(str(gdir / f"g{i}.fa"),
                    [random_genome_with_repeats(rng, 24000)])
    fqs = []
    for i in range(2):
        fqs.append(str(tmp / f"r{i}.fq"))
        write_fastq(fqs[-1], reads_from_genome(
            rng, random_seq(rng, 12000), 500, 100))
    shufp = str(tmp / "t.shuf")
    write_shuf(shufp, make_shuf(SketchParams(k=8, subk=5, drlevel=2),
                                seed=19))
    return tmp, str(gdir), fqs, shufp


@pytest.mark.parametrize("case", ["level", "k_level", "no_L", "dedup_files",
                                  "dedup_one", "keepcofile", "keepcofile_koc",
                                  "keepcofile_one"])
def test_dist_options_match(genome_inputs, case, capsys):
    """A level -L (or none) writes default.shuf and the sketches from it;
    -u keeps multiplicity-1 k-mers of fasta input in the batched and the
    per-file path; --keepcofile keeps each file's {i}.co.{c}[.a]."""
    tmp, gdir, fqs, shufp = genome_inputs
    g0 = os.path.join(gdir, "g0.fa")
    flags, src = {
        "level": (["-L", "2", "--seed", "5"], [gdir]),
        "k_level": (["-k", "9", "-L", "3", "--seed", "7"], [gdir]),
        "no_L": (["--seed", "3"], [g0]),
        "dedup_files": (["-L", shufp, "-u"], [gdir]),
        "dedup_one": (["-L", shufp, "-u"], [g0]),
        "keepcofile": (["-L", shufp, "--keepcofile"], [gdir]),
        "keepcofile_koc": (["-L", shufp, "-A", "--keepcofile"], fqs),
        "keepcofile_one": (["-L", shufp, "--keepcofile"], [g0]),
    }[case]
    a, b = str(tmp / f"jax_{case}"), str(tmp / f"port_{case}")
    _both(capsys, ["dist", *flags, "-o", a, *src],
          ["dist", *flags, "-o", b, "--device", "cpu", *src])
    _same_tree(a, b)
    names = os.listdir(b)
    if case in ("level", "k_level", "no_L"):
        assert "default.shuf" in names
    if case.startswith("keepcofile"):
        assert "0.co.0" in names
        assert ("0.co.0.a" in names) == (case == "keepcofile_koc")


def test_sketch_then_search_keepcofile(genome_inputs, capsys):
    """dist -r with fasta queries and --keepcofile keeps the sketched
    queries in <outdir>/qry.co, as the JAX CLI does."""
    tmp, gdir, _, shufp = genome_inputs
    ref = str(tmp / "sts_ref")
    assert cli.main(["dist", "-L", shufp, "-o", ref, "--device", "cpu",
                     gdir]) == 0
    q = [os.path.join(gdir, "g1.fa")]
    a, b = str(tmp / "jax_sts"), str(tmp / "port_sts")
    _both(capsys, ["dist", "-r", ref, "-L", shufp, "--keepcofile", "-o", a,
                   *q],
          ["dist", "-r", ref, "-L", shufp, "--keepcofile", "-o", b,
           "--device", "cpu", *q])
    _same_tree(a, b)
    assert os.path.isdir(os.path.join(b, "qry.co"))


def test_composite_shard_db_raises(genome_inputs, capsys):
    """composite --shard-db 2, which raised before the port had more than
    one shard, prints the JAX CLI's report, with and without ``-b`` (the
    .abv files too), against a MarkerDB of the two read sets."""
    tmp, gdir, fqs, shufp = genome_inputs
    ref, qry = str(tmp / "sd_ref"), str(tmp / "sd_qry")
    assert cli.main(["dist", "-L", shufp, "-o", ref, "--device", "cpu",
                     *fqs]) == 0
    assert cli.main(["dist", "-L", shufp, "-A", "-o", qry, "--device",
                     "cpu", fqs[0]]) == 0
    capsys.readouterr()
    a, b = _both(capsys, ["composite", "-r", ref, "-q", qry, "--shard-db",
                          "2"],
                 ["composite", "-r", ref, "-q", qry, "--shard-db", "2",
                  "--device", "cpu"])
    assert a and a == b
    va, vb = str(tmp / "sd_jax_abv"), str(tmp / "sd_port_abv")
    _both(capsys, ["composite", "-r", ref, "-q", qry, "-b", "-o", va,
                   "--shard-db", "2"],
          ["composite", "-r", ref, "-q", qry, "-b", "-o", vb, "--shard-db",
           "2", "--device", "cpu"])
    _same_tree(va, vb)


def test_profile_shard_db_raises(genome_inputs, capsys):
    """profile --shard-db 2 writes the JAX CLI's sketch and TSVs, against
    a MarkerDB of the genomes and the two read sets."""
    tmp, gdir, fqs, shufp = genome_inputs
    ref = str(tmp / "psd_ref")
    assert cli.main(["dist", "-L", shufp, "-o", ref, "--device", "cpu",
                     gdir, *fqs]) == 0
    a, b = str(tmp / "psd_jax"), str(tmp / "psd_port")
    _both(capsys, ["profile", "-L", shufp, "-r", ref, "-o", a, "--shard-db",
                   "2", fqs[0]],
          ["profile", "-L", shufp, "-r", ref, "-o", b, "--shard-db", "2",
           "--device", "cpu", fqs[0]])
    _same_tree(a, b)
    with open(os.path.join(b, "species_coverage.tsv")) as f:
        assert "r0.fq" in f.read()


_DEVICE_VERBS = ("dist", "set", "composite", "profile")


def _quickstart_data(root) -> None:
    """The fixture data of tests/test_readme_quickstart.py."""
    rng = np.random.default_rng(31)
    gdir = root / "genomes"
    gdir.mkdir()
    genomes = [random_seq(rng, 400_000) for _ in range(3)]
    for i, g in enumerate(genomes):
        write_fasta(str(gdir / f"sp{i}.fa"), [g])
    reads = (reads_from_genome(rng, genomes[0], 6000, 150)
             + reads_from_genome(rng, genomes[1], 2500, 150))
    write_fastq(str(root / "sample1.fastq"), reads)
    (root / "data").mkdir()
    (root / "data" / "psid2ncbi.tsv").write_text(
        "".join(f"genomes/sp{i}.fa\t{100 + i}\n" for i in range(3)))
    (root / "data" / "nodes.tsv").write_text(
        "1\tno rank\t1\troot\n"
        + "".join(f"{100 + i}\tspecies\t1\tSpecies_{i}\n" for i in range(3)))


def _run_quickstart(main, root, port: bool, monkeypatch, capsys) -> None:
    monkeypatch.chdir(root)
    for cmd in _quickstart_commands():
        parts = shlex.split(cmd)
        redirect = None
        if ">" in parts:
            gt = parts.index(">")
            redirect = parts[gt + 1]
            parts = parts[:gt]
        argv = parts[3:]          # strip "python -m metakssd_tpu.cli"
        if argv[0] == "shuffle":
            argv += ["--seed", "11"]     # the same .shuf on both sides
        if port and argv[0] in _DEVICE_VERBS:
            argv += ["--device", "cpu"]
        if redirect:
            with open(redirect, "w") as f, contextlib.redirect_stdout(f):
                rc = main(argv)
        else:
            rc = main(argv)
        capsys.readouterr()
        assert rc == 0, f"quickstart command failed: {argv}"


def test_readme_quickstart_through_port(tmp_path, monkeypatch, capsys):
    """Every README quickstart command through the port's CLI: every file
    it leaves is byte-identical to the JAX CLI's run on the same data."""
    roots = {}
    for side, main in (("jax", jax_cli.main), ("port", cli.main)):
        roots[side] = tmp_path / side
        roots[side].mkdir()
        _quickstart_data(roots[side])
        _run_quickstart(main, roots[side], side == "port", monkeypatch,
                        capsys)
    _same_tree(str(roots["jax"]), str(roots["port"]))
    for art in ("L3K11.shuf", "markerdb/cofiles.stat", "species_coverage.tsv",
                "abundance.tsv", "profile_out/abundance.tsv",
                "sample1.profile", "markerdb/abundance_Vec/sample1.fastq.abv",
                "markerdb/abundance_Vec.abm"):
        assert os.path.getsize(roots["port"] / art) > 0, art
