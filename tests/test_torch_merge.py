"""The port's sorted-set membership (``metakssd_tpu_torch/ops/merge.py``,
K3's plain version on the CPU) against the JAX package, bit for bit.

Each case runs ``metakssd_tpu.ops.merge.sorted_membership`` twice: through
the Pallas kernel in interpret mode, as ``tests/test_merge.py`` runs it,
and through its host fallback.  The port must equal both exactly.
Needles of 0xFFFFFFFF, which the Pallas kernel never reports as members
(it pads with that value), are compared with the fallback only.
"""

import numpy as np
import pytest
import torch

from metakssd_tpu.ops import merge as jax_merge

from metakssd_tpu_torch.ops import merge

ALL_ONES = np.uint32(0xFFFFFFFF)


def _sorted_u32(rng, lo, hi, n):
    return np.sort(rng.integers(lo, hi, n, dtype=np.uint64)
                   .astype(np.uint32))


def _case(name: str):
    """(haystack, values, needles) of one case, from a numpy seed."""
    rng = np.random.default_rng(CASES.index(name) + 100)
    if name == "random":
        hay = np.unique(rng.integers(0, 1 << 26, 50_000, dtype=np.uint32))
        hits = rng.choice(hay, 3000, replace=False)
        needles = np.sort(np.concatenate(
            [hits, rng.integers(0, 1 << 26, 5000, dtype=np.uint32)]))
    elif name == "dense_overflow":
        # clustered haystack: some needle blocks span more than 2W entries
        hay = np.unique(np.concatenate([
            rng.integers(0, 1 << 14, 40_000, dtype=np.uint32),
            rng.integers(1 << 28, 1 << 29, 10_000, dtype=np.uint32)]))
        needles = np.sort(np.concatenate([
            np.array([0, 1, 2], dtype=np.uint32),
            rng.integers(1 << 28, 1 << 29, 4096, dtype=np.uint32)]))
    elif name == "below_block":
        hay = np.unique(rng.integers(0, 1 << 20, 500, dtype=np.uint32))
        needles = _sorted_u32(rng, 0, 1 << 20, 300)
    elif name == "duplicates":
        hay = np.unique(rng.integers(0, 1 << 24, 20_000, dtype=np.uint32))
        hits = rng.choice(hay, 2500)
        needles = np.sort(np.concatenate(
            [hits, hits[:800], rng.integers(0, 1 << 24, 2000,
                                            dtype=np.uint32)]))
    elif name == "high_keys":
        # keys on both sides of 2^31: the int32 bit view misorders them
        hay = np.unique(_sorted_u32(rng, 0, 0xFFFFFFFF, 30_000))
        hits = rng.choice(hay, 2000, replace=False)
        needles = np.sort(np.concatenate(
            [hits, _sorted_u32(rng, 0, 0xFFFFFFFF, 3000)]))
        assert (hay >= 1 << 31).any() and (needles >= 1 << 31).any()
    elif name == "empty_haystack":
        hay = np.zeros(0, np.uint32)
        needles = np.arange(10, dtype=np.uint32)
    else:                                   # empty_needles
        hay = np.arange(100, dtype=np.uint32)
        needles = np.zeros(0, np.uint32)
    values = rng.integers(1, 1 << 32, hay.size, dtype=np.uint64) \
        .astype(np.uint32)
    return hay, values, needles


CASES = ["random", "dense_overflow", "below_block", "duplicates",
         "high_keys", "empty_haystack", "empty_needles"]


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == bool and got[1].dtype == np.uint32


@pytest.mark.parametrize("name", CASES)
def test_membership_matches_pallas_and_fallback(name):
    hay, values, needles = _case(name)
    got = merge.sorted_membership(hay, values, needles)
    _assert_same(got, jax_merge.sorted_membership(
        hay, values, needles, use_pallas=True, interpret=True))
    _assert_same(got, jax_merge.sorted_membership(
        hay, values, needles, use_pallas=False))
    # values=None: every value is 0, as in the JAX package
    got0 = merge.sorted_membership(hay, None, needles)
    _assert_same(got0, jax_merge.sorted_membership(
        hay, None, needles, use_pallas=False))


@pytest.mark.parametrize("name", ["random", "high_keys", "dense_overflow"])
def test_identity_static_haystack(name):
    """Identity mode: a hit's value is its haystack position."""
    hay, _, needles = _case(name)
    got = merge.sorted_membership(merge.StaticHaystack(hay), None, needles)
    jax_hay = jax_merge.StaticHaystack(hay)
    _assert_same(got, jax_merge.sorted_membership(
        jax_hay, None, needles, use_pallas=True, interpret=True))
    _assert_same(got, jax_merge.sorted_membership(
        jax_hay, None, needles, use_pallas=False))
    m, v = got
    np.testing.assert_array_equal(hay[v[m]], needles[m])


@pytest.mark.parametrize("present", [True, False])
def test_all_ones_needle_follows_fallback(present):
    """0xFFFFFFFF is a member when the haystack holds it (the host
    fallback's set semantics), in values and identity mode."""
    rng = np.random.default_rng(7)
    hay = np.unique(_sorted_u32(rng, 1 << 31, 0xFFFFFFFF, 3000))
    if present:
        hay = np.append(hay, ALL_ONES)
    values = rng.integers(0, 1 << 32, hay.size, dtype=np.uint64) \
        .astype(np.uint32)
    needles = np.sort(np.concatenate(
        [rng.choice(hay, 2500), np.full(3, ALL_ONES)]))
    got = merge.sorted_membership(hay, values, needles)
    _assert_same(got, jax_merge.sorted_membership(hay, values, needles,
                                                  use_pallas=False))
    assert got[0][-1] == present
    got = merge.sorted_membership(merge.StaticHaystack(hay), None, needles)
    _assert_same(got, jax_merge.sorted_membership(
        jax_merge.StaticHaystack(hay), None, needles, use_pallas=False))


def test_member_tensor_contract():
    """The wrapper takes int32 tensors of u32 bits and returns int32
    member and value; it raises on other dtypes, mixed devices and
    devices without a kernel."""
    hay = merge.u32_tensor(np.array([1, 5, 0x80000000, 0xFFFFFFFE],
                                    np.uint32))
    nd = merge.u32_tensor(np.array([0, 5, 0x80000000, 0xFFFFFFFF],
                                   np.uint32))
    m, v = merge.member(hay, None, nd)
    assert m.dtype == torch.int32 and v.dtype == torch.int32
    assert m.tolist() == [0, 1, 1, 0] and v.tolist() == [0, 1, 2, 0]
    with pytest.raises(ValueError, match="int32"):
        merge.member(hay.to(torch.int64), None, nd)
    with pytest.raises(ValueError, match="lies on"):
        merge.member(hay.to("meta"), None, nd)
    with pytest.raises(ValueError, match="no membership kernel"):
        merge.member(hay.to("meta"), None, nd.to("meta"))
    with pytest.raises(ValueError, match="align"):
        merge.member(hay, hay[:2], nd)
