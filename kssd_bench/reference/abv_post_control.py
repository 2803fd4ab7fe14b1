"""The control of the postings comparison (``abv_post_check``): the search
computed in the nearest precision below the one the configuration
states, which has to come out as not correct.

The program sums in float32.  The control puts in its place its own
``postings_search_batch`` fed with every input of the measure rounded to
bfloat16 (``control.round_mantissa_``: round to nearest even, 7 mantissa
bits): a copy of the staged percentages so rounded, and each call's query
percentages; sums and ranking as the program's.  The staged index itself
is left as it is.  ``calibrate_postings.py`` runs it.
"""

from __future__ import annotations

import dataclasses

from kssd_bench.reference.control import (DROP_BITS, round_mantissa_,
                                          round_mantissa_np)


def install(session, precision: str):
    """Put the control in the place of ``session``'s program search;
    returns a function that takes it out again."""
    drop = DROP_BITS[precision]
    orig = session._orig
    copies = {}

    def control(staged, queries, mode=0):
        if id(staged) not in copies:
            copies.clear()
            copies[id(staged)] = dataclasses.replace(
                staged, pct=round_mantissa_(staged.pct.clone(), drop))
        return orig(copies[id(staged)],
                    [(sp, round_mantissa_np(pc, drop)) for sp, pc in queries],
                    mode=mode)

    session._orig = control

    def uninstall():
        session._orig = orig
        copies.clear()
    return uninstall
