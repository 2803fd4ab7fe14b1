"""The join's choice of backend and the collectives' tensor forms
(``metakssd_tpu_torch/parallel/mesh.py``), on the CPU.

Two processes over gloo run ``probes/collectives_check`` with ``--device
cpu``: the tensor forms of ``gather_arrays`` and ``all_sum`` equal the
numpy forms and numpy's answer (sizes 0, 1 and 1000, unequal across
ranks; uint8, int32, uint32, int64, uint64).  The backend is a pure
function of every rank's (host, card): distinct cards give NCCL, a shared
card, a rank without one and ``--device cpu`` give gloo.  A join that
needs NCCL and cannot have it (NCCL unavailable, or its group failing to
form) exits 1 with the one-line join error and leaves no group behind: it
never carries on over gloo.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from metakssd_tpu_torch import cli
from metakssd_tpu_torch.parallel import mesh
from tests.ranks import ROOT, free_port

TIMEOUT = 120                     # seconds a process may take


def test_tensor_collectives_match_numpy_over_gloo():
    port = free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, MKSSD_COORDINATOR=f"127.0.0.1:{port}",
                   MKSSD_NPROCS="2", MKSSD_PROCID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "metakssd_tpu_torch.probes."
             "collectives_check", "--device", "cpu", "--sizes", "0,1,1000"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-2000:]
        assert f"collectives ok rank {r} gloo (2 ranks, --device cpu)" in out


@pytest.mark.parametrize("layout,device,want", [
    ([("h", 0, "GPU-a")], "cuda", ("nccl", "nccl (1 rank, 1 card)")),
    ([("h", 0, "GPU-a"), ("h", 1, "GPU-b")], "cuda",
     ("nccl", "nccl (2 ranks, 2 cards)")),
    # one card index on two hosts: two cards
    ([("h0", 0, "GPU-a"), ("h1", 0, "GPU-b")], "cuda",
     ("nccl", "nccl (2 ranks, 2 cards)")),
    ([("h", 0, "GPU-a"), ("h", 0, "GPU-a")], "cuda",
     ("gloo", "gloo (2 ranks share cuda:0)")),
    ([("h", 0, "GPU-a"), ("h", 1, "GPU-b"), ("h", 0, "GPU-a")], "cuda",
     ("gloo", "gloo (2 ranks share cuda:0)")),
    ([("h", 0, "GPU-a"), ("h", None, None)], "cuda",
     ("gloo", "gloo (2 ranks, a rank holds no card)")),
    ([("h", 0, "GPU-a"), ("h", 1, "GPU-b")], "cpu",
     ("gloo", "gloo (2 ranks, --device cpu)")),
    ([("h", None, None)], "cpu", ("gloo", "gloo (1 rank, --device cpu)")),
    ([("h", 0, "GPU-a"), ("h", 1, "GPU-b")], None,
     ("gloo", "gloo (2 ranks, no device)")),
])
def test_choose_backend(layout, device, want):
    assert mesh.choose_backend(layout, device) == want


@pytest.mark.parametrize("fault", ["unavailable", "group_fails"])
def test_join_needing_nccl_fails_without_it(tmp_path, monkeypatch, capsys,
                                            fault):
    """One rank that holds a card (stubbed: this host has none) asks for
    ``--device cuda``, so the layout says NCCL; without it the CLI prints
    the one-line join error, exits 1, runs no verb and leaves no group."""
    monkeypatch.setattr(mesh, "_local_card",
                        lambda device, rank: (0, "GPU-stub"))
    if fault == "unavailable":
        monkeypatch.setattr(tdist, "is_nccl_available", lambda: False)
        want = "NCCL is not available"
    else:
        monkeypatch.setattr(tdist, "is_nccl_available", lambda: True)

        def refuse(*a, **k):
            raise RuntimeError("ncclInvalidUsage: stub\nsecond line")
        monkeypatch.setattr(tdist, "new_group", refuse)
        want = "ncclInvalidUsage: stub"
    monkeypatch.setenv("MKSSD_COORDINATOR", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("MKSSD_NPROCS", "1")
    monkeypatch.setenv("MKSSD_PROCID", "0")
    monkeypatch.setenv("MKSSD_COORD_TIMEOUT", "30")
    out = str(tmp_path / "pan")
    rc = cli.main(["set", "-u", "-o", out, str(tmp_path), "--device",
                   "cuda"])
    err = capsys.readouterr().err.strip().splitlines()
    assert rc == 1
    assert len(err) == 1 and err[0].startswith(
        "metakssd_tpu_torch: multi-host join failed") and want in err[0], err
    assert not tdist.is_initialized()
    assert mesh.collectives_backend() is None and mesh.world() == (1, 0)
    assert not os.path.exists(out)


def test_collectives_without_a_group_are_the_identity():
    """No join: each collective returns its input (int64 for the sum)
    and counts nothing."""
    mesh.reset_collectives()
    a = np.arange(5, dtype=np.uint32)
    t = torch.from_numpy(a)
    assert np.array_equal(mesh.gather_arrays(a)[0], a)
    assert mesh.gather_arrays(t)[0] is t
    assert mesh.all_sum(t).dtype == torch.int64
    assert mesh.all_sum(a).dtype == np.int64
    assert set(mesh.COLLECTIVES.values()) == {0}
