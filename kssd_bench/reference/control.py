"""The control of the abv comparison: the search computed in the nearest
precision below the one the configuration states, which has to come out
as not correct.

The program computes in float32 with TF32 off.  For a measure that is
matrix products (cosine, L2) the step below is TF32; for L1, an
elementwise chain where TF32 has no meaning, it is bfloat16.  The control
puts in the program's place its own ``abv_search_batch`` fed with every
input of the measure rounded to that precision (round to nearest even to
10 or 7 mantissa bits, as the tensor cores round TF32 inputs), products
and sums in float32: a copy of the dense database so rounded, and each
call's queries.  The staged database itself is left as it is.
"""

from __future__ import annotations

import dataclasses

import numpy as np

DROP_BITS = {"tf32": 13, "bf16": 16}


def round_mantissa_(t, drop: int, rows: int = 1024):
    """Round a float32 torch tensor in place to 23 - ``drop`` mantissa
    bits, ``rows`` rows at a time."""
    import torch
    flat = t.view(t.shape[0], -1) if t.dim() > 1 else t.view(1, -1)
    for r0 in range(0, flat.shape[0], rows):
        v = flat[r0:r0 + rows].view(torch.int32)
        v.add_(((v >> drop) & 1) + ((1 << (drop - 1)) - 1))
        v.bitwise_and_(-(1 << drop))
    return t


def round_mantissa_np(a: np.ndarray, drop: int) -> np.ndarray:
    v = np.ascontiguousarray(a, dtype=np.float32).view(np.int32).copy()
    v += ((v >> drop) & 1) + ((1 << (drop - 1)) - 1)
    v &= np.int32(-(1 << drop))
    return v.view(np.float32)


def install(session, precision: str):
    """Put the control in the place of ``session``'s program search;
    returns a function that takes it out again."""
    drop = DROP_BITS[precision]
    orig = session._orig
    copies = {}

    def control(dense, queries, mode=0):
        if id(dense) not in copies:
            copies.clear()
            copies[id(dense)] = dataclasses.replace(
                dense, mat=round_mantissa_(dense.mat.clone(), drop))
        return orig(copies[id(dense)], round_mantissa_np(queries, drop),
                    mode=mode)

    session._orig = control

    def uninstall():
        session._orig = orig
        copies.clear()
    return uninstall
