"""Sketch parameterisation for K-mer Substring Space Decomposition.

Replicates the derived-constant computations of the reference engine
(``seq2co_global_var_initial``, reference iseq2comem.c:54-86) as a frozen
dataclass so every kernel gets the same bit-level semantics.

Terminology (matching the KSSD papers / reference code):
  * ``k``        — *half* context length; a k-mer spans ``2k`` bases.
  * ``subk``     — half substring (inner sub-context) length.
  * ``drlevel``  — dimensionality-reduction level; expected sampling rate
                   is ``16**-drlevel``.
  * the 4k-bit 2-bit-encoded k-mer splits as
    ``[ left outer ctx | inner substring | right outer ctx ]`` with
    ``outctx = k - subk`` bases on each side and ``2*subk`` bases inside.
"""

from __future__ import annotations

import dataclasses
import math

# Compile-time macros of the reference become runtime config here
# (reference global_basic.h:35-43, Makefile:5-10).
COMPONENT_SZ = 8        # components split the id space into 16**COMPONENT_SZ
MIN_SUBCTX_DIM_SMP_SZ = 4096   # reference command_shuffle.h:20
LD_FCTR = 0.6           # reference global_basic.h:44
MIN_KM_S = 6            # composite: min shared k-mers (command_composite.c:577)


def add_len_drlevel2subk() -> int:
    """Extra half-bases subk must exceed drlevel by (command_shuffle.c:166-172)."""
    return math.ceil(math.log2(MIN_SUBCTX_DIM_SMP_SZ) / 4)


@dataclasses.dataclass(frozen=True)
class SketchParams:
    """All derived constants for one sketching configuration."""

    k: int = 8
    subk: int = 5
    drlevel: int = 2
    shuf_id: int = 0
    # Reference compile-time macro COMPONENT_SZ as runtime config; the id
    # space per component is 16**component_sz.
    component_sz: int = COMPONENT_SZ

    # --- derived (reference iseq2comem.c:54-86) ---
    @property
    def outctx(self) -> int:            # half_outctx_len
        return self.k - self.subk

    @property
    def kmer_len(self) -> int:          # TL: bases per k-mer
        return 2 * self.k

    @property
    def domask(self) -> int:
        return ((1 << (4 * self.subk)) - 1) << (2 * self.outctx)

    @property
    def undomask(self) -> int:
        return ((1 << (2 * self.outctx)) - 1) << (2 * (self.k + self.subk))

    @property
    def dim_start(self) -> int:
        return 0

    @property
    def dim_end(self) -> int:
        subspace = 1 << (4 * (self.subk - self.drlevel))
        return max(subspace, MIN_SUBCTX_DIM_SMP_SZ)

    @property
    def shuf_len(self) -> int:
        return 1 << (4 * self.subk)

    @property
    def comp_code_bits(self) -> int:
        kd = self.k - self.drlevel
        return 4 * (kd - self.component_sz) if kd > self.component_sz else 0

    @property
    def component_num(self) -> int:
        return 1 << self.comp_code_bits

    def validate(self) -> None:
        if not (self.subk <= self.k):
            raise ValueError("half-context k must be >= half-substring subk")
        if self.subk >= 8:
            raise ValueError("subk must be < 8")
        if self.drlevel < 0 or self.drlevel > self.subk:
            raise ValueError("drlevel must be in [0, subk]")
        if self.k > 16:
            raise ValueError("k > 16 would overflow the 64-bit tuple")

    @classmethod
    def for_drlevel(cls, k: int, drlevel: int, shuf_id: int = 0) -> "SketchParams":
        """Derive subk from drlevel as the reference CLI does
        (command_dist.c:270: subk = drlevel + add_len_drlevel2subk())."""
        return cls(k=k, subk=drlevel + add_len_drlevel2subk(),
                   drlevel=drlevel, shuf_id=shuf_id)
