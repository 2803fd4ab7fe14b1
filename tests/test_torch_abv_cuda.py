"""The dense abv gather kernel (``csrc/abv.cu``, ``mkssd_abv_gather``) on
the card against its plain twin and against float64 NumPy; the dense
route's text on the card (through the text kernel the postings route
shares) against ``--device cpu``, byte for byte.

Every test here carries the ``cuda`` marker and skips where there is no
CUDA device.  The module imports neither jax nor the JAX package, so on a
GPU machine:

    python -m pytest -m cuda tests/test_torch_abv_cuda.py
"""

import io
import os
import re

import numpy as np
import pytest
import torch

from metakssd_tpu_torch.formats.abv import AbvIndex, write_abv_file
from metakssd_tpu_torch.ops import _build, dense_abv
from metakssd_tpu_torch.utils import TIMER

pytestmark = pytest.mark.cuda

N_ROWS = 301                 # not a multiple of the block's 32 rows
N_SPECIES = 5000
GAP = 1e-6                   # relative above 1, as the harness's gaps


def _tile() -> int:
    """The kernel's shared-memory tile of query columns, from its source."""
    src = os.path.join(os.path.dirname(dense_abv.__file__), os.pardir,
                       "csrc", "abv.cu")
    with open(src) as f:
        return int(re.search(r"constexpr int kTile = (\d+);", f.read())[1])


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def db(cuda):
    """(float32 matrix, its rows' L2 norms): rows of 1-600 species with a
    1/rank prevalence, lognormal percentages summing to 100, two empty."""
    rng = np.random.default_rng(3)
    prev = 1.0 / np.arange(1, N_SPECIES + 1)
    prev /= prev.sum()
    mat = np.zeros((N_ROWS, N_SPECIES), np.float32)
    for r in range(N_ROWS):
        if r in (7, N_ROWS - 1):
            continue
        nd = int(rng.integers(1, 600))
        d = rng.choice(N_SPECIES, nd, replace=False, p=prev)
        pct = rng.lognormal(0.0, 1.0, nd)
        mat[r, d] = (pct / pct.sum() * 100).astype(np.float32)
    y_l2n = np.sqrt((mat.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    return mat, y_l2n


def _queries(case: str, mat: np.ndarray) -> np.ndarray:
    rng = np.random.default_rng(len(case))

    def spread(nd):
        row = np.zeros(N_SPECIES, np.float32)
        row[rng.choice(N_SPECIES, nd, replace=False)] = rng.random(nd) + 0.1
        return row / row.sum() * 100
    if case == "empty":
        return np.zeros((1, N_SPECIES), np.float32)
    if case == "all":
        return spread(N_SPECIES)[None]
    if case == "over_tile":
        return spread(_tile() + 1000)[None]
    if case == "batch5":
        return np.vstack([spread(1), mat[3], np.zeros(N_SPECIES, np.float32),
                          spread(700), spread(_tile() * 2)])
    assert case == "self"
    return mat[[0, 5, 100, N_ROWS - 2]].copy()


def _reference_f64(mat, y_l2n, q, mode):
    """The reference tool's measures over the species both vectors hold,
    in float64 (``abv_gather_plain``'s docstring); 0 off the overlap."""
    x = q.astype(np.float64)[:, None, :]
    y = mat.astype(np.float64)[None, :, :]
    both = (x != 0) & (y != 0)
    if mode == 2:
        m = np.sqrt(np.where(both, (y - x) ** 2, 0.0).sum(2))
    elif mode == 1:
        m = (np.where(both, np.abs(y - x), 0.0).sum(2) + 200.0
             - np.where(both, x, 0.0).sum(2) - np.where(both, y, 0.0).sum(2))
    else:
        with np.errstate(invalid="ignore", divide="ignore"):
            m = np.where(both, x * y, 0.0).sum(2) / (
                np.sqrt((x * x).sum(2)) * y_l2n.astype(np.float64)[None])
    over = both.any(2)
    return np.where(over, m, 0.0), over


def _gap(got, want) -> float:
    if got.size == 0:
        return 0.0
    return float((np.abs(got.astype(np.float64) - want)
                  / np.maximum(np.abs(want), 1.0)).max())


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("case", ["empty", "all", "over_tile", "batch5",
                                  "self"])
def test_gather_matches_twin_and_float64(cuda, db, case, mode, monkeypatch):
    """The kernel through ``abv_search_batch`` against the twin on the CPU
    and float64: overlap exact, measure within 1e-6; one launch a call,
    counted in ``_build.LAUNCHES``, and the twin never called for the
    card's DB."""
    mat, y_l2n = db
    q = _queries(case, mat)
    on_card = dense_abv.DenseAbv([f"s{i}" for i in range(N_ROWS)],
                                 torch.from_numpy(mat).to(cuda),
                                 torch.from_numpy(y_l2n).to(cuda))
    on_cpu = dense_abv.DenseAbv(on_card.names, torch.from_numpy(mat),
                                torch.from_numpy(y_l2n))
    pm, po = dense_abv.abv_search_batch(on_cpu, q, mode=mode)

    def refuse(*a, **k):
        raise AssertionError("the card's DB reached the plain twin")
    monkeypatch.setattr(dense_abv, "abv_gather_plain", refuse)
    before = _build.LAUNCHES["abv_gather"]
    columns = TIMER.counters.get("abv.columns", 0)
    m, o = dense_abv.abv_search_batch(on_card, q, mode=mode)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["abv_gather"] == before + 1
    assert TIMER.counters["abv.columns"] == columns + np.count_nonzero(q)
    want_m, want_o = _reference_f64(mat, y_l2n, q, mode)
    assert m.shape == o.shape == (q.shape[0], N_ROWS)
    np.testing.assert_array_equal(o, po)
    np.testing.assert_array_equal(o, want_o)
    assert _gap(m[o], pm[o]) < GAP and _gap(m[o], want_m[o]) < GAP
    assert (m[~o] == 0.0).all() and np.isfinite(m).all()
    if case == "empty":
        assert not o.any()
    if case in ("all", "over_tile"):
        assert np.count_nonzero(q) > _tile()
    if case == "all":
        assert o[0].sum() == N_ROWS - 2
    if case == "self":
        ids = [0, 5, 100, N_ROWS - 2]
        assert o[range(4), ids].all()
        if mode == 2:
            assert (m[range(4), ids] == 0.0).all()


def test_gather_launch_checks(cuda, db):
    """The wrapper raises on what the kernel does not take, before any
    launch: a CSR on another device, a wrong dtype, an unknown mode."""
    mat, y_l2n = db
    dbt = torch.from_numpy(mat).to(cuda)
    yt = torch.from_numpy(y_l2n).to(cuda)
    off = torch.tensor([0, 2], dtype=torch.int32, device=cuda)
    cols = torch.tensor([1, 4], dtype=torch.int32, device=cuda)
    vals = torch.tensor([1.0, 2.0], dtype=torch.float32, device=cuda)
    before = _build.LAUNCHES["abv_gather"]
    with pytest.raises(ValueError):
        dense_abv.abv_gather(dbt, yt, off.cpu(), cols, vals, 2)
    with pytest.raises(ValueError):
        dense_abv.abv_gather(dbt, yt, off, cols.long(), vals, 2)
    with pytest.raises(ValueError):
        dense_abv.abv_gather(dbt, yt, off, cols, vals, 3)
    assert _build.LAUNCHES["abv_gather"] == before
    m, o = dense_abv.abv_gather(dbt, yt, off, cols, vals, 2)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["abv_gather"] == before + 1
    assert m.shape == (1, N_ROWS)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_dense_text_on_the_card_equals_cpu(cuda, db, tmp_path, mode):
    """``composite -s <mode> --dense`` text on ``cuda`` and ``cpu``, byte
    for byte, from an index of the DB's rows and five query files
    (``batch5``: one species, a DB row, an empty vector, 700 species,
    two tiles); on the card one gather launch, every line formatted
    there by the text kernel (``abv.format.card`` equal to
    ``abv.lines``, ``abv.format.host`` 0), one call of it a query that
    has lines."""
    mat = db[0]
    sp, smp = np.nonzero(mat.T)             # species-major, samples ascending
    AbvIndex([f"S{r:04d}.abv" for r in range(N_ROWS)],
             np.sqrt((mat.astype(np.float64) ** 2).sum(1)),
             np.cumsum(np.bincount(sp, minlength=N_SPECIES)).astype(np.int32),
             smp.astype(np.int32), mat[smp, sp]).write(str(tmp_path))
    qpaths = []
    for i, row in enumerate(_queries("batch5", mat)):
        qpaths.append(str(tmp_path / f"q{i}.abv"))
        nz = np.flatnonzero(row).astype(np.int32)
        write_abv_file(qpaths[-1], nz, row[nz])
    got = {}
    for dev in ("cpu", "cuda"):
        TIMER.reset()
        before = dict(_build.LAUNCHES)
        out = io.StringIO()
        dense_abv.abv_search_dense(str(tmp_path), qpaths, mode, out=out,
                                   device=dev)
        got[dev] = out.getvalue()
        launches = {k: _build.LAUNCHES[k] - before[k]
                    for k in ("abv_gather", "abv_format_lines")}
    assert got["cuda"] == got["cpu"] and got["cpu"].count("#Sample") == 5
    blocks = got["cuda"].split("#Sample\t")[1:]
    assert launches == {"abv_gather": 1, "abv_format_lines": sum(
        b.count("\n") > 1 for b in blocks)}
    assert launches["abv_format_lines"] == 4
    assert TIMER.counters["abv.format.card"] == TIMER.counters["abv.lines"] \
        > 5
    assert TIMER.counters.get("abv.format.host", 0) == 0
