"""The port's ``profile`` slice against the JAX package, byte for byte,
on the CPU.

Stage I (the batched multi-fasta MarkerDB build and the streaming ``-A``
fastq sketch) must write sketch directories byte-identical to
``metakssd_tpu.pipeline.run_stage1``; ``profile_fastq`` and ``cli
profile --device cpu`` must write ``species_coverage.tsv`` and
``abundance.tsv`` byte-identical to ``metakssd_tpu.profile_e2e``.  A
subprocess runs the slice with no jax loaded.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from metakssd_tpu import cli as jax_cli
from metakssd_tpu import composite as jax_composite
from metakssd_tpu import pipeline as jax_pipeline
from metakssd_tpu import profile_e2e as jax_profile_e2e
from metakssd_tpu.formats.shuf import make_shuf, read_shuf, write_shuf
from metakssd_tpu.params import SketchParams

from metakssd_tpu_torch import cli, pipeline, profile_e2e
from metakssd_tpu_torch.device import resolve_device

from tests.util import random_seq, reads_from_genome, write_fasta, \
    write_fastq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_tree(a: str, b: str) -> None:
    """Every file of sketch dir ``a`` is byte-identical in ``b``
    (the staging sidecars are not part of the sketch)."""
    fa = sorted(f for f in os.listdir(a) if not f.startswith("."))
    fb = sorted(f for f in os.listdir(b) if not f.startswith("."))
    assert fa == fb and fa
    for f in fa:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f


def _same_files(a: str, b: str, names=("species_coverage.tsv",
                                       "abundance.tsv")) -> None:
    for f in names:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    """6 genomes, the JAX package's MarkerDB of them, and a fastq sampled
    from three of them (with N bases and a poly-A read)."""
    tmp = tmp_path_factory.mktemp("torch_e2e")
    rng = np.random.default_rng(21)
    gdir = tmp / "genomes"
    gdir.mkdir()
    genomes = [random_seq(rng, 30_000) for _ in range(6)]
    for i, g in enumerate(genomes):
        write_fasta(str(gdir / f"sp{i}.fa"), [g[:17_000], g[17_000:]])
    shufp = str(tmp / "t.shuf")
    write_shuf(shufp, make_shuf(SketchParams(k=8, subk=5, drlevel=2),
                                seed=22))
    refdir = str(tmp / "markerdb")
    jax_pipeline.run_stage1(jax_pipeline.organize_infiles([str(gdir)]),
                            read_shuf(shufp), refdir)
    reads = (reads_from_genome(rng, genomes[0], 1500, 120)
             + reads_from_genome(rng, genomes[2], 600, 120, err=0.01)
             + reads_from_genome(rng, genomes[3], 250, 120))
    reads[::50] = [r[:40] + "N" + r[41:] for r in reads[::50]]
    reads.append("A" * 120)
    fq = str(tmp / "sample.fq")
    write_fastq(fq, reads)
    return tmp, shufp, str(gdir), refdir, fq


def test_batched_markerdb_build_matches(slice_setup):
    tmp, shufp, gdir, refdir, _ = slice_setup
    out = str(tmp / "port_markerdb")
    pipeline.run_stage1(jax_pipeline.organize_infiles([gdir]),
                        read_shuf(shufp), out, device="cpu")
    _same_tree(refdir, out)


def test_streaming_abundance_sketch_matches(slice_setup, monkeypatch):
    tmp, shufp, _, _, fq = slice_setup
    shuf = read_shuf(shufp)
    opts = jax_pipeline.SketchOptions(abundance=True)
    ref = str(tmp / "jax_qry")
    jax_pipeline.run_stage1([fq], shuf, ref, opts)
    # several stream batches, so the per-batch device path repeats
    monkeypatch.setattr(pipeline, "STREAM_BATCH_BASES", 50_000)
    out = str(tmp / "port_qry")
    pipeline.run_stage1([fq], shuf, out, opts, device="cpu")
    _same_tree(ref, out)


def test_profile_fastq_matches(slice_setup):
    tmp, shufp, _, refdir, fq = slice_setup
    ref = str(tmp / "jax_prof")
    jax_profile_e2e.profile_fastq([fq], refdir, shufp, ref)
    out = str(tmp / "port_prof")
    rep = profile_e2e.profile_fastq([fq], refdir, shufp, out, device="cpu")
    for st in ("e2e.sketch", "e2e.profile", "e2e.poisson"):
        assert st in rep["stages"]
    _same_files(ref, out)
    with open(os.path.join(out, "abundance.tsv")) as f:
        rows = [ln.split("\t") for ln in f.read().splitlines()]
    assert {os.path.basename(r[1]) for r in rows} == \
        {"sp0.fa", "sp2.fa", "sp3.fa"}


def test_cli_dist_and_profile_match(slice_setup, capsys):
    tmp, shufp, gdir, refdir, fq = slice_setup
    db = str(tmp / "cli_markerdb")
    assert cli.main(["dist", "-L", shufp, "-o", db, "--device", "cpu",
                     gdir]) == 0
    _same_tree(refdir, db)
    ref = str(tmp / "jax_prof_cli")
    jax_profile_e2e.profile_fastq([fq], refdir, shufp, ref)
    out = str(tmp / "port_prof_cli")
    assert cli.main(["profile", "-L", shufp, "-r", refdir, "-o", out,
                     "--device", "cpu", fq]) == 0
    _same_files(ref, out)


def test_binvec_abundance_vectors_match(slice_setup):
    """The ``binvec`` branch of the profiling loop writes the same
    ``.abv`` abundance vector as the JAX package."""
    from metakssd_tpu_torch import composite
    tmp, shufp, _, refdir, fq = slice_setup
    qry = str(tmp / "binvec_qry")
    jax_pipeline.run_stage1([fq], read_shuf(shufp), qry,
                            jax_pipeline.SketchOptions(abundance=True))
    ref, out = str(tmp / "jax_abv"), str(tmp / "port_abv")
    jax_composite.get_species_abundance(refdir, qry, outdir=ref,
                                        binvec=True)
    composite.get_species_abundance(refdir, qry, outdir=out, binvec=True,
                                    device="cpu")
    name = os.path.basename(fq) + ".abv"
    with open(os.path.join(ref, name), "rb") as a, \
            open(os.path.join(out, name), "rb") as b:
        data = a.read()
        assert data and data == b.read()


@pytest.mark.parametrize("flag", [["--mesh", "2"]])
def test_unported_options_raise(slice_setup, flag, capsys):
    """``dist --mesh 2``, which raised before the port had it, writes the
    JAX CLI's sketch dir and the port's serial one, byte for byte."""
    tmp, shufp, gdir, _, _ = slice_setup
    dirs = [str(tmp / f"mesh_{k}") for k in ("jax", "port", "serial")]
    assert jax_cli.main(["dist", "-L", shufp, "-o", dirs[0], *flag,
                         gdir]) == 0
    assert cli.main(["dist", "-L", shufp, "-o", dirs[1], "--device", "cpu",
                     *flag, gdir]) == 0
    assert cli.main(["dist", "-L", shufp, "-o", dirs[2], "--device", "cpu",
                     gdir]) == 0
    capsys.readouterr()
    for other in dirs[1:]:
        names = sorted(os.listdir(dirs[0]))
        assert names and names == sorted(os.listdir(other))
        for f in names:
            with open(os.path.join(dirs[0], f), "rb") as a, \
                    open(os.path.join(other, f), "rb") as b:
                assert a.read() == b.read(), f


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_slice_runs_without_jax(slice_setup):
    """The port never imports jax nor the JAX package: a fresh
    interpreter runs dist, profile, dist -r (sketch search), the MarkerDB
    chain (set -g/-q/-i/-u), composite -b/-i/-s/--dense, shuffle and
    reverse on the CPU, then checks sys.modules."""
    from metakssd_tpu import dist as jax_dist
    from metakssd_tpu_torch import composite
    tmp, shufp, gdir, refdir, fq = slice_setup
    # both packages may have staged this MarkerDB in the background
    jax_composite.wait_staging()
    composite.wait_staging()
    ref = str(tmp / "jax_prof_nojax")
    jax_profile_e2e.profile_fastq([fq], refdir, shufp, ref)
    ref_search = str(tmp / "jax_search_nojax")
    jax_dist.run_dist_search(refdir, refdir, ref_search, use_device=False)
    out = str(tmp / "nojax")
    taxf = str(tmp / "nojax_tax.tsv")
    with open(taxf, "w") as f:
        f.writelines(f"{1 + i // 2}\tsp{i // 2}\n" for i in range(6))
    code = textwrap.dedent(f"""
        import sys
        from metakssd_tpu_torch import cli
        def run(*argv):
            assert cli.main(list(argv)) == 0, argv
        cpu = ("--device", "cpu")
        run("dist", "-L", {shufp!r}, "-o", {out + "_db"!r}, *cpu, {gdir!r})
        run("profile", "-L", {shufp!r}, "-r", {refdir!r}, "-o", {out!r},
            *cpu, {fq!r})
        run("dist", "-r", {out + "_db"!r}, "-o", {out + "_search"!r}, *cpu,
            {out + "_db"!r})
        run("set", "-g", {taxf!r}, "-o", {out + "_pan"!r}, *cpu,
            {out + "_db"!r})
        run("set", "-q", "-o", {out + "_uq"!r}, *cpu, {out + "_pan"!r})
        run("set", "-i", {out + "_uq"!r}, "-o", {out + "_mk"!r}, *cpu,
            {out + "_pan"!r})
        run("set", "-u", "-o", {out + "_u"!r}, *cpu, {out + "_db"!r})
        run("composite", "-r", {out + "_mk"!r}, "-q", {out + "/qry.co"!r},
            "-b", *cpu)
        run("composite", "-r", {out + "_mk"!r}, "-i", *cpu)
        for dense in ((), ("--dense",)):
            run("composite", "-r", {out + "_mk"!r}, "-s", "1", *dense, *cpu,
                "sample.fq.abv")
        run("shuffle", "-k", "8", "-s", "5", "-l", "2", "--seed", "1",
            "-o", {out + "_shuf"!r})
        run("reverse", "-L", {shufp!r}, "-o", {out + "_rev"!r},
            {out + "_mk"!r})
        assert "jax" not in sys.modules, "jax was imported"
        assert not [m for m in sys.modules
                    if m.split(".")[0] == "metakssd_tpu"], "JAX package"
        print("NOJAX-OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NOJAX-OK" in proc.stdout
    _same_tree(refdir, out + "_db")
    _same_files(ref, out)
    _same_files(ref_search, out + "_search", names=("distance.out",))
