"""Batched dense abundance-vector search on a device: the port of
``metakssd_tpu/ops/dense_abv.py``.

The abv database becomes a dense [nsamples, nspecies] float32 matrix on
the named device (``state.dense_abv_from_index``); every query of a call
is searched at once.  ``abv_search_batch`` hands the queries to the
gather as CSR (each query's sorted nonzero species and their values) and
reads each DB row only at those columns: on the card the hand-written
kernel ``mkssd_abv_gather`` (``csrc/abv.cu``), for a DB on the CPU its
plain twin ``abv_gather_plain``, the same formula in PyTorch.  For a
query x and a sample y, over the species both hold (the reference tool's
``abv_search``, command_composite.c:299-319): the overlap (any such
species), L2 = sqrt(sum (x - y)^2), L1 = 200 + sum (|x - y| - x - y) and
cosine = sum x * y / (|x| * y_l2n), each sum in float64 and rounded once
to float32.  The JAX package computes the same measures with masked
matmuls over the whole matrix, so the port's L2 at a query's own sample
is 0 where the JAX package's is the root of a rounding residue
(ROADMAP.md section 3).  ``abv_search_batch_cosine`` (top-k cosine, on no
CLI route) stays a ``torch.matmul`` in full float32 (TF32 off: its
10-bit mantissa on percentages up to 100 breaks the 2e-3 bound the dense
search is held to).

The text output follows ``_abv_search_dense_impl``: samples sharing no
dimension with a query are not reported, values may differ from the
sparse path (``metakssd_tpu.composite.abv_search``) in the last float
ulps, and ties are broken by sample id; it is ranked and written by
``ops/abv_text``, with the names staged once per cached DB.

Each call of ``abv_search_dense`` is one ``TIMER`` stage ``abv.search``
holding the stages of its parts (``utils.StageTimer``, which under an
active ``torch.profiler`` puts them on the clock of the device's
kernels): ``abv.db``
(and ``abv.stage`` on a cache miss: the DB and its names), ``abv.queries``,
``abv.batch`` (all of ``abv_search_batch``: ``abv.measure``, the upload of
the queries' CSR and the gather; ``abv.readback``), and per query
``abv.rank`` and ``abv.format``; counters ``abv.queries``, ``abv.lines``
(the text's data lines), and on the card ``abv.columns`` (query nonzeros
the gather read; its launches are ``_build.LAUNCHES["abv_gather"]``),
``abv.format.card`` (lines formatted there) and ``abv.format.host``
(lines of queries whose text fell back to the host writer).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys

import numpy as np
import torch

from metakssd_tpu_torch.device import resolve_device
from metakssd_tpu_torch.formats.abv import (BINVEC_DIRNAME, AbvIndex,
                                            index_cache_key, read_abv_file)
from metakssd_tpu_torch.ops import _build
from metakssd_tpu_torch.ops.abv_text import HEADERS, StagedNames, rank_order
from metakssd_tpu_torch.state import dense_abv_from_index
from metakssd_tpu_torch.utils import TIMER


@dataclasses.dataclass
class DenseAbv:
    """Dense [nsamples, nspecies] float32 matrix of an abv database, and
    its samples' L2 norms (float32), on one device."""
    names: list[str]
    mat: torch.Tensor
    y_l2n: torch.Tensor


@contextlib.contextmanager
def _fp32_matmul():
    """Full-precision float32 matmuls (no TF32) inside the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _cosine(db, y_l2n, q) -> torch.Tensor:
    dot = q @ db.T
    xnorm = torch.sqrt(torch.sum(q * q, dim=1, keepdim=True))
    return dot / (xnorm * y_l2n[None, :])


def _dense_cosine_topk(db, y_l2n, q, k: int):
    return torch.topk(_cosine(db, y_l2n, q), k, dim=1)


def abv_search_batch_cosine(dense: DenseAbv, queries: np.ndarray,
                            top_k: int = 10):
    """Batched cosine search over the dense DB: (scores, ids) numpy."""
    q = torch.from_numpy(np.asarray(queries, np.float32)).to(dense.mat.device)
    with _fp32_matmul():
        scores, ids = _dense_cosine_topk(dense.mat, dense.y_l2n, q,
                                         min(top_k, len(dense.names)))
    return scores.cpu().numpy(), ids.cpu().numpy()


def query_csr(queries: np.ndarray) -> tuple[np.ndarray, ...]:
    """The [B, S] float32 queries as CSR: (offsets int32 [B + 1], sorted
    column ids int32, values float32) of each row's nonzeros."""
    flat = np.ascontiguousarray(queries, dtype=np.float32).ravel()
    # one pass over a flat mask: np.nonzero of a 2-D array is ~10x slower
    at = np.flatnonzero(flat != 0)
    rows, cols = np.divmod(at, queries.shape[1])
    offsets = np.zeros(queries.shape[0] + 1, dtype=np.int32)
    np.cumsum(np.bincount(rows, minlength=queries.shape[0]),
              out=offsets[1:])
    return offsets, cols.astype(np.int32), flat[at]


def abv_gather_plain(db: torch.Tensor, y_l2n: torch.Tensor,
                     offsets: torch.Tensor, cols: torch.Tensor,
                     vals: torch.Tensor, mode: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``mkssd_abv_gather``'s formula in plain PyTorch: (measure float32
    [B, N], overlap bool [B, N]) of the CSR queries against ``db``, each
    query's columns gathered (``db[:, cols]``) and summed in float64 where
    both vectors are nonzero; 0 where a sample shares no species."""
    b = offsets.numel() - 1
    measure = torch.zeros((b, db.shape[0]), dtype=torch.float32,
                          device=db.device)
    overlap = torch.zeros((b, db.shape[0]), dtype=torch.bool,
                          device=db.device)
    for i in range(b):
        lo, hi = int(offsets[i]), int(offsets[i + 1])
        x = vals[lo:hi].to(torch.float64)
        y = db[:, cols[lo:hi].long()].to(torch.float64)
        both = y != 0
        if mode == 2:
            m = torch.sqrt(torch.where(both, (x - y) ** 2, 0.0).sum(1))
        elif mode == 1:
            m = 200.0 + torch.where(both, torch.abs(x - y) - x - y,
                                    0.0).sum(1)
        else:
            m = torch.where(both, x * y, 0.0).sum(1) / (
                torch.sqrt(torch.sum(x * x)) * y_l2n.to(torch.float64))
        overlap[i] = both.any(1)
        measure[i] = torch.where(overlap[i], m, 0.0).to(torch.float32)
    return measure, overlap


def _check(db, y_l2n, offsets, cols, vals, mode: int) -> None:
    if mode not in (0, 1, 2):
        raise ValueError(f"no abv measure of mode {mode}: 0 cosine, 1 L1, "
                         "2 L2")
    if db.dtype != torch.float32 or db.dim() != 2 or \
            not db.is_contiguous():
        raise ValueError("the DB must be a contiguous 2-D float32 tensor")
    for name, t, dtype, n in (("y_l2n", y_l2n, torch.float32, db.shape[0]),
                              ("offsets", offsets, torch.int32, None),
                              ("cols", cols, torch.int32, None),
                              ("vals", vals, torch.float32, cols.numel())):
        _build.check_1d(name, t, dtype, db.device)
        if n is not None and t.numel() != n:
            raise ValueError(f"{name} holds {t.numel()} entries, not {n}")
    if offsets.numel() < 1:
        raise ValueError("offsets must hold B + 1 entries")


def abv_gather(db: torch.Tensor, y_l2n: torch.Tensor, offsets: torch.Tensor,
               cols: torch.Tensor, vals: torch.Tensor, mode: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(measure float32 [B, N], overlap bool [B, N]) of B queries given as
    CSR (``query_csr``: offsets from 0, each query's column ids sorted and
    in [0, S), nonzero values), on ``db``'s device: ``mkssd_abv_gather``
    on a card, ``abv_gather_plain`` on the CPU.  mode: 0 cosine, 1 L1,
    2 L2."""
    _check(db, y_l2n, offsets, cols, vals, mode)
    if db.device.type == "cpu":
        return abv_gather_plain(db, y_l2n, offsets, cols, vals, mode)
    if db.device.type != "cuda":
        raise ValueError(f"no abv gather kernel for device {db.device}")
    b = offsets.numel() - 1
    measure = torch.empty((b, db.shape[0]), dtype=torch.float32,
                          device=db.device)
    overlap = torch.empty((b, db.shape[0]), dtype=torch.bool,
                          device=db.device)
    if b == 0 or db.numel() == 0:
        return measure.zero_(), overlap.zero_()
    lib = _build.library()
    stream = torch.cuda.current_stream(db.device).cuda_stream
    with _build.card_of(db):
        err = lib.mkssd_abv_gather(
            db.data_ptr(), db.shape[0], db.shape[1], offsets.data_ptr(),
            cols.data_ptr(), vals.data_ptr(), b, y_l2n.data_ptr(), mode,
            measure.data_ptr(), overlap.data_ptr(), stream)
    _build.raise_on(err, "mkssd_abv_gather")
    _build.LAUNCHES["abv_gather"] += 1
    TIMER.count("abv.columns", cols.numel())
    return measure, overlap


def abv_search_batch(dense: DenseAbv, queries: np.ndarray, mode: int = 0
                     ) -> tuple[np.ndarray, np.ndarray]:
    """All-measure batched search with the reference's semantics: returns
    (measure [B, N], overlap mask [B, N]) as numpy; samples sharing no
    dimension with a query are masked out by the overlap (their measure
    reads 0).  mode: 0 cosine, 1 L1, 2 L2 (sqrt)."""
    with TIMER.stage("abv.batch"):
        db = dense.mat
        q = np.asarray(queries, np.float32)
        if q.ndim != 2 or q.shape[1] != db.shape[1]:
            raise ValueError(f"queries of shape {q.shape} against a DB of "
                             f"{db.shape[1]} species")
        offsets, cols, vals = query_csr(q)
        with TIMER.stage("abv.measure"):
            # one upload: offsets, column ids and the values' bits
            packed = torch.from_numpy(np.concatenate(
                [offsets, cols, vals.view(np.int32)])).to(db.device)
            b, nnz = q.shape[0], cols.size
            measure, overlap = abv_gather(
                db, dense.y_l2n, packed[:b + 1], packed[b + 1:b + 1 + nnz],
                packed[b + 1 + nnz:].view(torch.float32), mode)
        with TIMER.stage("abv.readback"):
            return measure.cpu().numpy(), overlap.cpu().numpy()


_DENSE_CACHE: dict = {}


def _dense_db(refdir: str, device):
    """(AbvIndex, nspecies, DenseAbv, StagedNames) of ``refdir`` on
    ``device``, cached by ``index_cache_key``."""
    with TIMER.stage("abv.db"):
        key = index_cache_key(refdir, device)
        got = _DENSE_CACHE.get(key)
        if got is None:
            with TIMER.stage("abv.stage"):
                idx = AbvIndex.read(refdir)
                nspecies = int(idx.abmi.size)
                got = (idx, nspecies,
                       dense_abv_from_index(idx, nspecies, device),
                       StagedNames.stage(idx.names, device))
            _DENSE_CACHE[key] = got
        return got


def abv_search_dense(refdir: str, queries: list[str], mode: int = 0,
                     out=None, *, device) -> None:
    """``composite -s <mode> --dense``: the output format of
    ``metakssd_tpu.composite.abv_search``, with every query searched in
    one batched call on ``device``."""
    out = out or sys.stdout
    with TIMER.stage("abv.search"):
        dev = resolve_device(device)
        _, nspecies, dense, names = _dense_db(refdir, dev)
        qmat = []
        with TIMER.stage("abv.queries"):
            for qpath in queries:
                if not qpath.endswith(".abv"):
                    print(f"argument {qpath} is not a .abv file, skipped")
                    continue
                qpath2 = (os.path.join(refdir, BINVEC_DIRNAME, qpath)
                          if "/" not in qpath else qpath)
                qi, qp = read_abv_file(qpath2)
                row = np.zeros(nspecies, dtype=np.float32)
                row[qi] = qp
                qmat.append(row)
        if not qmat:
            return
        TIMER.count("abv.queries", len(qmat))
        measure, overlap = abv_search_batch(dense, np.stack(qmat),
                                            mode=mode)
        for b in range(len(qmat)):
            with TIMER.stage("abv.rank"):
                ids = np.nonzero(overlap[b])[0]
                vals = measure[b, ids]
                order = rank_order(vals, ids)
                if mode == 0:
                    order = order[::-1]
            with TIMER.stage("abv.format"):
                out.write(f"#Sample\t{HEADERS[mode]}\n")
                if names.write(out, ids[order],
                               vals[order].astype(np.float64)):
                    TIMER.count("abv.format.card", ids.size)
                elif names.card is not None:
                    TIMER.count("abv.format.host", ids.size)
            TIMER.count("abv.lines", ids.size)
