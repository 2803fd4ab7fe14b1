"""The plain reference of ``composite -s <mode>``: the reference tool's abv
search (``abv_search``, command_composite.c:217-348) written out posting
by posting in plain PyTorch, from the index's arrays.

It imports neither package nor any kernel.  For a query (species and
percentages in its ``.abv`` file's order) it walks each species'
postings in index order, adding the mode's term to the sample's float32
accumulator one posting at a time (float32 scalars, one rounding an
operation), and notes the walk position at which each sample is first
touched.  The text ranks the touched samples, taken in first-touch order,
by a stable sort on the float32 measure (reversed for cosine) and prints
``%f``.  Tests hold ``ops/abv_postings`` to it at small sizes.
"""

from __future__ import annotations

import math

import torch

HEADERS = {0: "CosineXY", 1: "L1norm", 2: "L2norm"}


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def walk(abmi, abm_idx, abm_pct, n_samples: int, qsp, qpct, mode: int
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(measure float32 [N], touch int64 [N]) of one query: the float32
    sum before the mode's final step (L1 with its ``(200 - xsum) - ysum``
    added in float32), and the walk position of each sample's first
    posting; -1 and 0 where the sample shares no species."""
    starts = [0] + [int(v) for v in abmi]
    acc = [_f32(0.0) for _ in range(n_samples)]
    xs = [_f32(0.0) for _ in range(n_samples)]
    ys = [_f32(0.0) for _ in range(n_samples)]
    touch = [-1] * n_samples
    pos = 0
    for sp, x in zip([int(v) for v in qsp], [_f32(float(v)) for v in qpct]):
        for p in range(starts[sp], starts[sp + 1]):
            s = int(abm_idx[p])
            y = _f32(float(abm_pct[p]))
            if mode == 2:
                d = y - x
                acc[s] = acc[s] + d * d
            elif mode == 1:
                t = torch.abs(y.double() - x.double()).float()
                acc[s] = acc[s] + t
                xs[s] = xs[s] + x
                ys[s] = ys[s] + y
            else:
                acc[s] = acc[s] + y * x
            if touch[s] < 0:
                touch[s] = pos
            pos += 1
    measure = torch.zeros(n_samples, dtype=torch.float32)
    for s in range(n_samples):
        if touch[s] >= 0:
            m = acc[s]
            if mode == 1:
                m = m + ((_f32(200.0) - xs[s]) - ys[s])
            measure[s] = m
    return measure, torch.tensor(touch, dtype=torch.int64)


def text(names, y_l2n, measure, touch, qpct, mode: int) -> str:
    """One query's block of ``composite -s <mode>`` from its ``walk``."""
    ids = sorted((s for s in range(len(names)) if int(touch[s]) >= 0),
                 key=lambda s: int(touch[s]))
    val = {s: float(measure[s]) for s in ids}
    if mode == 0:
        xl2n = _f32(0.0)
        for v in qpct:
            x = _f32(float(v))
            xl2n = xl2n + x * x
        for s in ids:
            val[s] = float(_f32(val[s] / (math.sqrt(float(xl2n))
                                          * float(y_l2n[s]))))
    order = sorted(ids, key=lambda s: val[s])       # stable
    if mode == 0:
        order.reverse()
    out = [f"#Sample\t{HEADERS[mode]}\n"]
    for s in order:
        v = math.sqrt(val[s]) if mode == 2 else val[s]
        out.append(f"{names[s]}\t{v:f}\n")
    return "".join(out)


def search(abmi, abm_idx, abm_pct, names, y_l2n, qsp, qpct, mode: int
           ) -> tuple[torch.Tensor, torch.Tensor, str]:
    """(measure, touch, text) of one query against the index."""
    measure, touch = walk(abmi, abm_idx, abm_pct, len(names), qsp, qpct,
                          mode)
    return measure, touch, text(names, y_l2n, measure, touch, qpct, mode)
