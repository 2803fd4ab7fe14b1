"""Run CLI commands as one multi-process job on this host.

``run_ranks`` runs each command of a list as N ``python -m
metakssd_tpu_torch.cli`` processes joined by ``MKSSD_COORDINATOR`` on
127.0.0.1 (a free port per command), as a launcher on N hosts starts one
process per host with the three ``MKSSD_*`` variables.  ``{rank}`` in a
command or its stdout path becomes the process's rank, so each can write
its own output dirs.  A process that exits nonzero, or one that passes the
timeout, fails the whole job: the others get GRACE seconds to exit (their
collectives fail on the closed connections), those still running are
killed, and RuntimeError names every rank that failed, in rank order, with
the tail of its log.

Imported by the multi-process tests and by ``chip_smoke.py`` (which puts
this directory on ``sys.path``).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRACE = 10.0       # seconds the other ranks get to exit once one has failed


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(steps: list, nprocs: int, logdir: str, timeout: float,
              env: dict | None = None) -> float:
    """Run ``steps`` (``[(argv, stdout path or None), ...]``) in order,
    each in ``nprocs`` joined processes that may take ``timeout`` seconds;
    returns the job's seconds.  Each process's stderr (and its stdout
    where no path is given) goes to ``logdir/step{i}_rank{r}.log``."""
    os.makedirs(logdir, exist_ok=True)
    t0 = time.time()
    for i, (argv, out) in enumerate(steps):
        _run_step(i, argv, out, nprocs, logdir, timeout, env)
    return time.time() - t0


def _run_step(i: int, argv: list, out: str | None, nprocs: int,
              logdir: str, timeout: float, env: dict | None) -> None:
    port = free_port()
    procs, logs, files = [], [], []
    t0 = time.time()
    try:
        for r in range(nprocs):
            e = dict(os.environ if env is None else env)
            e.update(MKSSD_COORDINATOR=f"127.0.0.1:{port}",
                     MKSSD_NPROCS=str(nprocs), MKSSD_PROCID=str(r))
            logs.append(os.path.join(logdir, f"step{i}_rank{r}.log"))
            log = open(logs[-1], "w")
            files.append(log)
            stdout = log
            if out:
                stdout = open(out.replace("{rank}", str(r)), "w")
                files.append(stdout)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "metakssd_tpu_torch.cli",
                 *[a.replace("{rank}", str(r)) for a in argv]],
                cwd=ROOT, env=e, stdout=stdout, stderr=log))
        while True:
            codes = [p.poll() for p in procs]
            if any(rc not in (None, 0) for rc in codes):
                # the others' collectives now fail too; let them exit, so
                # that every rank that failed is named, not only the first
                # one seen (a rank may still be tearing down)
                codes = _settle(procs, GRACE)
                raise RuntimeError("\n".join(
                    f"rank {r} of {nprocs} exited {rc} in {argv[0]}:\n"
                    f"{_tail(logs[r])}" if rc is not None else
                    f"rank {r} of {nprocs} still running {argv[0]} "
                    f"{GRACE}s after a rank failed (killed)"
                    for r, rc in enumerate(codes) if rc != 0))
            if all(rc == 0 for rc in codes):
                return
            if time.time() - t0 > timeout:
                r = codes.index(None)
                raise RuntimeError(
                    f"rank {r} of {nprocs} still running {argv[0]} after "
                    f"{timeout}s:\n{_tail(logs[r])}")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()


def _settle(procs: list, grace: float) -> list:
    """Exit codes once every process has exited or ``grace`` seconds have
    passed (None for one still running)."""
    end = time.time() + grace
    for p in procs:
        try:
            p.wait(timeout=max(0.0, end - time.time()))
        except subprocess.TimeoutExpired:
            pass
    return [p.poll() for p in procs]


def _tail(path: str, nbytes: int = 3000) -> str:
    with open(path, "rb") as f:
        f.seek(max(0, os.path.getsize(path) - nbytes))
        return f.read().decode(errors="replace")
