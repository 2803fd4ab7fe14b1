"""Batched dense abundance-vector search on a device: the port of
``metakssd_tpu/ops/dense_abv.py``.

The abv database becomes a dense [nsamples, nspecies] float32 matrix on
the named device (``state.dense_abv_from_index``); every query of a call
is searched at once.  Cosine and the overlap-L2 are masked matmuls, as in
the JAX package, which computes them outside any Pallas kernel; here they
are ``torch.matmul`` in full float32 (TF32 off: its 10-bit mantissa on
percentages up to 100 breaks the 2e-3 bound the dense search is held to).
L1 is chunked over queries and species so its broadcast temporary stays
under ``L1_TEMP_BYTES``.

The text output follows ``_abv_search_dense_impl``: samples sharing no
dimension with a query are not reported, values may differ from the
sparse path (``metakssd_tpu.composite.abv_search``) in the last float
ulps, and ties are broken by sample id.

Each call of ``abv_search_dense`` is one ``TIMER`` stage ``abv.search``
holding the stages of its parts (``utils.StageTimer``, which under an
active ``torch.profiler`` puts them on the clock of the device's
kernels): ``abv.db``
(and ``abv.stage`` on a cache miss), ``abv.queries``, ``abv.batch`` (all
of ``abv_search_batch``: ``abv.mask``, ``abv.measure``,
``abv.readback``), ``abv.names``, and per query ``abv.rank`` and
``abv.format``; counters ``abv.queries`` and ``abv.lines`` (the text's
data lines).
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
                                            read_abv_file)
from metakssd_tpu_torch.io import native as native_io
from metakssd_tpu_torch.state import dense_abv_from_index
from metakssd_tpu_torch.utils import TIMER

L1_CHUNK = 512                # species per L1 step (``_dense_l1``'s chunk)
L1_TEMP_BYTES = 1 << 30       # bound on the [B, N, chunk] L1 temporary


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


def _dense_l2_overlap(db: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The reference's L2 (the sum over *overlapping* dims of (x-y)^2) as
    three masked matmuls: sum x^2[y!=0] + sum y^2[x!=0] - 2<x,y>.  A query
    equal to a DB vector leaves a rounding residue that may be negative,
    whose sqrt is NaN, as in the JAX package (ROADMAP.md section 3)."""
    with TIMER.stage("abv.mask"):
        ymask = (db != 0).to(torch.float32)
    qmask = (q != 0).to(torch.float32)
    dot = q @ db.T
    q2y = (q * q) @ ymask.T
    y2x = qmask @ (db * db).T
    return q2y + y2x - 2.0 * dot


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


def _dense_l1(db: torch.Tensor, q: torch.Tensor, chunk: int = L1_CHUNK,
              temp_bytes: int = L1_TEMP_BYTES) -> torch.Tensor:
    """The full L1 distance [B, N] by species-chunked broadcasting; this
    equals the reference's overlap L1 plus its complement term because
    the vectors sum to 100 (command_composite.c:299-319).  Species chunks
    add up in order, as the JAX scan does; queries go ``qb`` at a time so
    that the [qb, N, chunk] temporary stays under ``temp_bytes``."""
    n, s = db.shape
    qb = max(1, temp_bytes // (4 * max(n, 1) * chunk))
    acc = torch.zeros((q.shape[0], n), dtype=torch.float32, device=db.device)
    for lo in range(0, q.shape[0], qb):
        part = acc[lo:lo + qb]
        for c0 in range(0, s, chunk):
            d = db[:, c0:c0 + chunk]
            x = q[lo:lo + qb, c0:c0 + chunk]
            part += torch.sum(torch.abs(x[:, None, :] - d[None, :, :]), dim=2)
    return acc


def abv_search_batch(dense: DenseAbv, queries: np.ndarray, mode: int = 0
                     ) -> tuple[np.ndarray, np.ndarray]:
    """All-measure batched search with the reference's semantics: returns
    (measure [B, N], overlap mask [B, N]) as numpy; samples sharing no
    dimension with a query are masked out by the overlap.  mode: 0 cosine,
    1 L1, 2 L2 (sqrt)."""
    with TIMER.stage("abv.batch"):
        db = dense.mat
        q = torch.from_numpy(np.asarray(queries, np.float32)).to(db.device)
        with _fp32_matmul():
            with TIMER.stage("abv.mask"):
                ymask = (db != 0).to(torch.float32)
            qmask = (q != 0).to(torch.float32)
            overlap = (qmask @ ymask.T) > 0
            del ymask
            with TIMER.stage("abv.measure"):
                if mode == 0:
                    measure = _cosine(db, dense.y_l2n, q)
                elif mode == 1:
                    measure = _dense_l1(db, q)
                else:
                    measure = torch.sqrt(_dense_l2_overlap(db, q))
        with TIMER.stage("abv.readback"):
            return measure.cpu().numpy(), overlap.cpu().numpy()


_DENSE_CACHE: dict = {}


def _dense_db(refdir: str, device):
    """(AbvIndex, nspecies, DenseAbv) of ``refdir`` on ``device``, cached
    by (refdir, index mtime, device)."""
    with TIMER.stage("abv.db"):
        abm = os.path.join(refdir, "abundance_Vec.abm")
        key = (os.path.abspath(refdir),
               os.path.getmtime(abm) if os.path.exists(abm) else 0,
               str(device))
        got = _DENSE_CACHE.get(key)
        if got is None:
            with TIMER.stage("abv.stage"):
                idx = AbvIndex.read(refdir)
                nspecies = int(idx.abmi.size)
                got = (idx, nspecies,
                       dense_abv_from_index(idx, nspecies, device))
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
        idx, nspecies, dense = _dense_db(refdir, dev)
        qmat, qnames = [], []
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
                qnames.append(qpath)
        if not qmat:
            return
        TIMER.count("abv.queries", len(qnames))
        measure, overlap = abv_search_batch(dense, np.stack(qmat),
                                            mode=mode)
        hdr = {0: "CosineXY", 1: "L1norm", 2: "L2norm"}[mode]
        with TIMER.stage("abv.names"):
            names_arr = np.asarray(idx.names, dtype=object)
            names_blob = names_off = None
            if native_io.available():
                enc = [n.encode() for n in idx.names]
                names_off = np.zeros(len(enc) + 1, dtype=np.int64)
                np.cumsum([len(b) for b in enc], out=names_off[1:])
                names_blob = b"".join(enc)
        for b in range(len(qnames)):
            with TIMER.stage("abv.rank"):
                ids = np.nonzero(overlap[b])[0]
                vals = measure[b, ids]
                order = np.argsort(vals, kind="stable")
                if mode == 0:
                    order = order[::-1]
            with TIMER.stage("abv.format"):
                out.write(f"#Sample\t{hdr}\n")
                buf = None
                if names_blob is not None:
                    buf = native_io.format_name_float_lines(
                        names_blob, names_off, ids[order],
                        vals[order].astype(np.float64))
                if buf is not None:
                    out.write(buf.decode())
                else:
                    # the same "%f" lines, formatted in bulk
                    sv = np.char.mod("%f\n", vals[order].astype(np.float64))
                    lines = names_arr[ids[order]] + "\t" + \
                        sv.astype(object)
                    out.write("".join(lines.tolist()))
            TIMER.count("abv.lines", ids.size)
