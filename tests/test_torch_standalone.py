"""The port stands alone: ``metakssd_tpu_torch`` and ``chip_smoke.py``
import neither jax nor the JAX package ``metakssd_tpu``, nor the
``tests`` package.

An AST scan of every source finds no such import, and a fresh interpreter
that imports every port module and then runs the CLI verbs on the CPU
ends with neither in ``sys.modules``.
"""

import ast
import glob
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = sorted(
    os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "metakssd_tpu_torch", "**", "*.py"),
        recursive=True)) + ["chip_smoke.py"]
# the test helpers are not part of the port either (chip_smoke.py puts
# tests/ on its path for ranks.py alone)
FORBIDDEN = ("jax", "metakssd_tpu", "tests")


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("rel", SOURCES)
def test_source_imports_neither_jax_nor_jax_package(rel):
    with open(os.path.join(REPO, rel)) as f:
        tree = ast.parse(f.read(), rel)
    bad = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_every_module_and_verb_runs_standalone(tmp_path):
    """Import every port module, then run shuffle, dist (stage I, with
    --byread, -P and --ckpt, and the sketch search, also --shard-db 2),
    profile (also --shard-db 1 --ckpt and --mesh 2 --shard-db 2), set
    -g/-q/-i/-u, composite -b/-i/-s (sparse and --dense) and -q
    --shard-db 1, reverse (also -b), postprocess and primer with
    ``--device cpu``."""
    code = textwrap.dedent(f"""
        import importlib, os, pkgutil, sys
        import numpy as np
        import metakssd_tpu_torch
        for m in pkgutil.walk_packages(metakssd_tpu_torch.__path__,
                                       "metakssd_tpu_torch."):
            importlib.import_module(m.name)
        from metakssd_tpu_torch import cli
        from tests.util import (random_seq, reads_from_genome, write_fasta,
                                write_fastq)
        t = {str(tmp_path)!r}
        rng = np.random.default_rng(31)
        os.makedirs(t + "/g")
        genomes = [random_seq(rng, 20_000) for _ in range(4)]
        for i, g in enumerate(genomes):
            write_fasta(f"{{t}}/g/sp{{i}}.fa", [g])
        write_fastq(t + "/s.fq", reads_from_genome(rng, genomes[1], 800, 100))
        with open(t + "/tax.tsv", "w") as f:
            f.writelines(f"{{1 + i // 2}}\\tsp{{i // 2}}\\n" for i in range(4))

        def run(*argv):
            assert cli.main(list(argv)) == 0, argv
        cpu = ("--device", "cpu")
        run("shuffle", "-k", "8", "-s", "5", "-l", "2", "--seed", "1",
            "-o", t + "/L2")
        run("dist", "-L", t + "/L2.shuf", "-o", t + "/db", *cpu, t + "/g")
        run("profile", "-L", t + "/L2.shuf", "-r", t + "/db", "-o",
            t + "/prof", *cpu, t + "/s.fq")
        run("profile", "-L", t + "/L2.shuf", "-r", t + "/db", "-o",
            t + "/prof1", "--shard-db", "1", "--ckpt", *cpu, t + "/s.fq")
        run("profile", "-L", t + "/L2.shuf", "-r", t + "/db", "-o",
            t + "/prof2", "--mesh", "2", "--shard-db", "2", *cpu,
            t + "/s.fq")
        run("dist", "-L", t + "/L2.shuf", "--byread", "-o", t + "/br", *cpu,
            t + "/s.fq")
        run("reverse", "-L", t + "/L2.shuf", "-b", "-o", t + "/rb", t + "/br")
        run("dist", "-L", t + "/L2.shuf", "-P", "cat", "--ckpt", "-o",
            t + "/piped", *cpu, t + "/s.fq")
        run("dist", "-r", t + "/db", "-o", t + "/search", *cpu, t + "/db")
        run("dist", "-r", t + "/db", "-o", t + "/search2", "--shard-db", "2",
            *cpu, t + "/db")
        run("set", "-g", t + "/tax.tsv", "-o", t + "/pan", *cpu, t + "/db")
        run("set", "-q", "-o", t + "/uq", *cpu, t + "/pan")
        run("set", "-i", t + "/uq", "-o", t + "/mk", *cpu, t + "/pan")
        run("set", "-u", "-o", t + "/u", *cpu, t + "/db")
        run("composite", "-r", t + "/mk", "-q", t + "/prof/qry.co", "-b",
            *cpu)
        run("composite", "-r", t + "/mk", "-q", t + "/prof/qry.co",
            "--shard-db", "1", *cpu)
        run("composite", "-r", t + "/mk", "-i", *cpu)
        for dense in ((), ("--dense",)):
            run("composite", "-r", t + "/mk", "-s", "1", *dense, *cpu,
                "s.fq.abv")
        run("reverse", "-L", t + "/L2.shuf", "-o", t + "/rev", t + "/mk")
        run("postprocess", "poisson", t + "/prof/species_coverage.tsv")
        run("primer")
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "metakssd_tpu")]
        assert not loaded, loaded
        print("STANDALONE-OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "STANDALONE-OK" in proc.stdout
    for f in ("db/cofiles.stat", "prof/abundance.tsv", "search/distance.out",
              "mk/cofiles.stat", "mk/abundance_Vec.abm", "br/combco.index.0",
              "piped/combco.0"):
        assert os.path.getsize(tmp_path / f) > 0, f
    for f in ("species_coverage.tsv", "abundance.tsv"):
        assert (tmp_path / "prof" / f).read_bytes() == \
            (tmp_path / "prof1" / f).read_bytes(), f
