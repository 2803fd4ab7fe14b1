"""Two processes of the port joined by ``MKSSD_COORDINATOR`` over gloo, on
the CPU: the verbs of ``__graft_entry__._mh_worker`` (``dist --mesh 8``,
``dist -r --shard-db 4``, ``composite --shard-db 4``, ``set -u``, ``set
-g``, and ``set -q``) run in both, and every file from both ranks must be
byte-identical to the serial run's; ``dist --mesh 2``, ``dist -r
--shard-db 2`` and ``set -u`` in a job of one rank, whose collectives
cross the gloo group all the same.  Then the join's failures: a malformed
or dead coordinator and missing variables give exit code 1 and one line
within the timeout, and a rank that fails fails the whole job.
"""

import contextlib
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from metakssd_tpu_torch import cli
from metakssd_tpu_torch.formats.shuf import make_shuf, write_shuf
from metakssd_tpu_torch.params import SketchParams
from metakssd_tpu_torch.probes.collectives_check import read_report
from tests.ranks import ROOT, free_port, run_ranks
from tests.util import random_seq

JOB_TIMEOUT = 120                 # seconds one process of a job may take


def _tree(root: str) -> dict:
    """{name: bytes} of the files of ``root`` (hidden entries left out)."""
    out = {}
    for f in sorted(os.listdir(root)):
        p = os.path.join(root, f)
        if not f.startswith(".") and os.path.isfile(p):
            with open(p, "rb") as fh:
                out[f] = fh.read()
    return out


@pytest.fixture(scope="module")
def mh_inputs(tmp_path_factory):
    """The inputs of ``__graft_entry__._mh_write_inputs`` and the serial
    run of every verb, through the port on the CPU."""
    d = str(tmp_path_factory.mktemp("mh"))
    rng = np.random.default_rng(5)
    gdir = os.path.join(d, "g")
    os.makedirs(gdir)
    genomes = [random_seq(rng, 20000) for _ in range(3)]
    for i, g in enumerate(genomes):
        with open(os.path.join(gdir, f"g{i}.fa"), "w") as f:
            f.write(f">g{i}\n{g}\n")
    with open(os.path.join(d, "q.fa"), "w") as f:
        f.write(">q\n" + genomes[0][:8000] + "\n")
    with open(os.path.join(d, "r.fq"), "w") as f:
        for i in range(600):
            s = int(rng.integers(0, 20000 - 100))
            f.write(f"@r{i}\n{genomes[0][s:s + 100]}\n+\n{'I' * 100}\n")
    with open(os.path.join(d, "tax.tsv"), "w") as f:
        f.write("101\tTaxA\n101\tTaxA\n202\tTaxB\n")
    shufp = os.path.join(d, "t.shuf")
    write_shuf(shufp, make_shuf(SketchParams(k=8, subk=5, drlevel=2),
                                seed=9))
    cpu = ["--device", "cpu"]
    p = {k: os.path.join(d, k) for k in ("co_serial", "qco", "qko", "g",
                                         "tax.tsv", "t.shuf")}
    for argv in (["dist", "-L", shufp, "-o", p["co_serial"], gdir],
                 ["dist", "-L", shufp, "-o", p["qco"],
                  os.path.join(d, "q.fa")],
                 ["dist", "-L", shufp, "-A", "-o", p["qko"],
                  os.path.join(d, "r.fq")],
                 ["dist", "-r", p["co_serial"], "-o",
                  os.path.join(d, "dist_serial"), p["qco"]],
                 ["set", "-u", "-o", os.path.join(d, "set_serial"),
                  p["co_serial"]],
                 ["set", "-g", p["tax.tsv"], "-o",
                  os.path.join(d, "grp_serial"), p["co_serial"]],
                 ["set", "-q", "-o", os.path.join(d, "uq_serial"),
                  os.path.join(d, "grp_serial")]):
        assert cli.main(argv + cpu) == 0
    with open(os.path.join(d, "comp_serial.tsv"), "w") as f, \
            contextlib.redirect_stdout(f):
        assert cli.main(["composite", "-r", p["co_serial"], "-q", p["qko"],
                         *cpu]) == 0
    return d


def _steps(d: str) -> list:
    """The verbs of one rank, each writing its own ``*_p{rank}`` output."""
    cpu = ["--device", "cpu"]

    def j(*a):
        return os.path.join(d, *a)
    return [
        (["dist", "-L", j("t.shuf"), "--mesh", "8", "-o", j("co_p{rank}"),
          j("g"), *cpu], None),
        (["dist", "-r", j("co_serial"), "--shard-db", "4", "-o",
          j("dist_p{rank}"), j("qco"), *cpu], None),
        (["composite", "-r", j("co_serial"), "-q", j("qko"), "--shard-db",
          "4", *cpu], j("comp_p{rank}.tsv")),
        (["set", "-u", "-o", j("set_p{rank}"), j("co_serial"), *cpu], None),
        (["set", "-g", j("tax.tsv"), "-o", j("grp_p{rank}"), j("co_serial"),
          *cpu], None),
        (["set", "-q", "-o", j("uq_p{rank}"), j("grp_serial"), *cpu], None),
    ]


def test_two_processes_byte_identical(mh_inputs):
    d = mh_inputs
    run_ranks(_steps(d), 2, os.path.join(d, "logs"), JOB_TIMEOUT)
    for r in range(2):
        for serial, mine in (("co_serial", f"co_p{r}"),
                             ("dist_serial", f"dist_p{r}"),
                             ("set_serial", f"set_p{r}"),
                             ("grp_serial", f"grp_p{r}"),
                             ("uq_serial", f"uq_p{r}")):
            a, b = _tree(os.path.join(d, serial)), _tree(os.path.join(d, mine))
            assert sorted(a) == sorted(b) and a, (serial, mine)
            for f in a:
                assert a[f] == b[f], f"rank {r}: {mine}/{f} differs"
        with open(os.path.join(d, "comp_serial.tsv"), "rb") as x, \
                open(os.path.join(d, f"comp_p{r}.tsv"), "rb") as y:
            text = x.read()
            assert text and text == y.read(), f"rank {r}: composite tsv"


def test_one_rank_job_crosses_the_group(mh_inputs):
    """One joined process (``MKSSD_NPROCS=1``) on the CPU: ``dist --mesh
    2``, ``dist -r --shard-db 2`` and ``set -u`` write the serial run's
    files, and each rank's TIMER report names gloo and counts gloo calls
    above 0: with a group joined the collectives cross it, one rank
    included."""
    d = mh_inputs
    cpu = ["--device", "cpu"]

    def j(*a):
        return os.path.join(d, *a)
    steps = [(["dist", "-L", j("t.shuf"), "--mesh", "2", "-o", j("co_one"),
               j("g"), *cpu], None),
             (["dist", "-r", j("co_serial"), "--shard-db", "2", "-o",
               j("dist_one"), j("qco"), *cpu], None),
             (["set", "-u", "-o", j("set_one"), j("co_serial"), *cpu], None)]
    logs = j("one_logs")
    run_ranks(steps, 1, logs, JOB_TIMEOUT,
              env=dict(os.environ, MKSSD_LOG="json"))
    for serial, mine in (("co_serial", "co_one"), ("dist_serial", "dist_one"),
                         ("set_serial", "set_one")):
        a, b = _tree(j(serial)), _tree(j(mine))
        assert sorted(a) == sorted(b) and a, (serial, mine)
        for f in a:
            assert a[f] == b[f], f"{mine}/{f} differs"
    for i in range(len(steps)):
        meta = read_report(os.path.join(logs, f"step{i}_rank0.log"))["meta"]
        assert meta["collectives"] == "gloo (1 rank, --device cpu)"
        counts = meta["collective_counts"]
        assert counts["gloo_calls"] > 0 and counts["gloo_bytes"] > 0, meta
        assert counts["nccl_calls"] == 0, meta


def test_failing_rank_fails_the_job(mh_inputs):
    """Rank 1's query dir does not exist: it exits 1 before its first
    collective and leaves the process group, so rank 0's sum fails on the
    closed connection rather than wait, and the job fails at once."""
    d = mh_inputs
    steps = [(["dist", "-r", os.path.join(d, "co_serial"), "--shard-db",
               "2", "-o", os.path.join(d, "fail_p{rank}"),
               os.path.join(d, "qco{rank}"), "--device", "cpu"], None)]
    os.makedirs(os.path.join(d, "qco0"), exist_ok=True)
    for f in os.listdir(os.path.join(d, "qco")):
        src = os.path.join(d, "qco", f)
        if os.path.isfile(src):
            with open(src, "rb") as a, \
                    open(os.path.join(d, "qco0", f), "wb") as b:
                b.write(a.read())
    t0 = time.time()
    env = dict(os.environ, MKSSD_COORD_TIMEOUT="60")
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited 1"):
        run_ranks(steps, 2, os.path.join(d, "fail_logs"), JOB_TIMEOUT,
                  env=env)
    assert time.time() - t0 < 60


def _cli(tmp_path, env) -> tuple[subprocess.CompletedProcess, float]:
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "metakssd_tpu_torch.cli", "set", "-c",
         str(tmp_path)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    return r, time.time() - t0


@pytest.fixture()
def worker_env():
    """A rank-1 environment whose coordinator (rank 0) never starts."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env.update({"MKSSD_COORDINATOR": f"127.0.0.1:{port}",
                "MKSSD_NPROCS": "2", "MKSSD_PROCID": "1",
                "MKSSD_COORD_TIMEOUT": "5"})
    return env


@pytest.mark.parametrize("case", ["malformed", "missing_vars", "dead"])
def test_coordinator_failure_clean_error(tmp_path, worker_env, case):
    """As ``tests/test_multihost.py`` holds the JAX CLI: one line on
    stderr, exit code 1, within the 5 s timeout (plus the interpreter's
    start)."""
    env = dict(worker_env)
    want = {"malformed": "host:port", "missing_vars": "MKSSD_NPROCS",
            "dead": "unreachable"}[case]
    if case == "malformed":
        env["MKSSD_COORDINATOR"] = "host0"
    elif case == "missing_vars":
        del env["MKSSD_PROCID"]
    r, dt = _cli(tmp_path, env)
    lines = r.stderr.strip().splitlines()
    assert r.returncode == 1, r.stderr[-500:]
    assert len(lines) == 1 and want in lines[0] and \
        lines[0].startswith("metakssd_tpu_torch: multi-host join failed"), \
        r.stderr[-500:]
    assert dt < 60, f"join took {dt:.0f}s: timeout not honored"


_JOB = (
    "import sys, time, numpy as np\n"
    "from metakssd_tpu_torch.parallel import mesh\n"
    "assert mesh.init_distributed()\n"
    "n, r = mesh.world()\n"
    "time.sleep(float(sys.argv[1]) * r)\n"
    "a = np.arange(3 * r, dtype=np.uint64) + (1 << 40)\n"
    "got = mesh.gather_arrays(a)\n"
    "assert [g.tolist() for g in got] == "
    "[[], [(1 << 40) + i for i in range(3)]], got\n"
    "assert got[1].dtype == np.uint64\n"
    "s = mesh.all_sum(np.array([r + 1, -5], np.int64))\n"
    "assert s.tolist() == [3, -10], s\n"
    "m = mesh.make_mesh(3, 2, 'cpu')\n"
    "assert (m.n_data, m.local_rows) == (4, [2 * r, 2 * r + 1])\n"
    "mesh.leave_distributed(True)\n"
    "print('ok', r)\n")


def _two_ranks(tmp_path, lag: float, env: dict) -> None:
    """Run ``_JOB`` in two joined processes, rank 1 ``lag`` seconds late
    to the first collective; both must print ok and exit 0."""
    script = tmp_path / "job.py"
    script.write_text(_JOB)
    port = free_port()
    procs = []
    for r in range(2):
        e = dict(env, MKSSD_COORDINATOR=f"127.0.0.1:{port}",
                 MKSSD_NPROCS="2", MKSSD_PROCID=str(r), PYTHONPATH=ROOT)
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(lag)], env=e, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=JOB_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"ok {r}" in out, out[-2000:]


def test_join_and_collectives(tmp_path):
    """Two joined processes: ``gather_arrays`` returns every rank's array
    (different sizes and dtypes, one empty) in rank order, and
    ``all_sum`` the int64 sum, on both ranks."""
    _two_ranks(tmp_path, 0.0, dict(os.environ))


def test_collectives_outlast_join_budget(tmp_path):
    """``MKSSD_COORD_TIMEOUT`` bounds the join alone: with a 5 s budget, a
    rank that reaches the first collective 15 s after the other still
    meets it, as the JAX package's ``initialization_timeout`` allows."""
    _two_ranks(tmp_path, 15.0, dict(os.environ, MKSSD_COORD_TIMEOUT="5"))
