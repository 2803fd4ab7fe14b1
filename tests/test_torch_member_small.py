"""K3's groups launch (``csrc/member.cu`` ``member_groups_kernel``, the
launch ``mkssd_member`` takes for small needle counts), mirrored in numpy
and held to numpy, the port's plain versions and the JAX package, on the
CPU; and the rule that chooses between K3's two launches.

* ``_groups_search`` runs the kernel's steps for every needle in
  lockstep: a group of GROUP lanes a needle, the bucket's pair of table
  entries, rounds of PROBES keys (two a lane: every key of a range of at
  most PROBES, else PROBES evenly spaced ones), the two ballots' count of
  probes below the needle, and the key of the probe at that count taken
  by the shuffle's lane and slot.  Its lower bounds and hits must equal
  ``np.searchsorted``, ``merge.member_plain`` and the JAX package's
  ``sorted_membership`` (host fallback, and the Pallas kernel in
  interpret mode on the profile-like haystack), in identity and values
  mode, on sorted and shuffled needles, over haystacks like the profile's
  match (one shard of ``profile --shard-db 4``: 62,277 uniform keys, about
  15 a bucket), a skewed one, one below 16 keys (no table), one holding
  0xFFFFFFFF, one whose keys have every top bit 0 and an empty one.
* ``merge.member_launch`` and ``merge.GROUPS_MAX_NEEDLES`` must be the
  source's rule and constant, and give the shapes PERF.md times the
  launch the source's head names for them.  (On the card,
  ``tests/test_torch_member_cuda.py`` holds both launches to
  ``member_plain`` and the rule to ``mkssd_member_launch``.)
"""

import os
import re

import numpy as np
import pytest
import torch

from metakssd_tpu.ops import merge as jax_merge

from metakssd_tpu_torch.ops import merge, probe

ALL_ONES = 0xFFFFFFFF
GROUP = 16                       # lanes a needle (kGroup)
PROBES = 2 * GROUP               # keys a group reads a round (kProbes)
SOURCE = os.path.join(os.path.dirname(merge.__file__), os.pardir, "csrc",
                      "member.cu")


def _u32(rng, lo, hi, n):
    return rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32)


def _source_constant(name: str) -> str:
    with open(SOURCE) as f:
        m = re.search(rf"constexpr [a-z ]+ {name} = ([^;]+);", f.read())
    assert m, name
    return m.group(1)


def test_mirror_constants_are_the_source():
    """The mirror's group width and probes a round are the kernel's."""
    assert int(_source_constant("kGroup")) == GROUP
    assert _source_constant("kProbes") == "2 * kGroup"


def _groups_search(keys: np.ndarray, ix, needles: np.ndarray):
    """The groups launch's steps in numpy, every needle in lockstep.
    Returns (lower bound, hit, rounds of the longest search)."""
    n = keys.size
    k = keys.astype(np.int64)
    x = needles.astype(np.int64)
    if n == 0:
        lo, hi = np.zeros_like(x), np.zeros_like(x)
    elif ix.nb == 0:                      # no table: one bucket
        lo, hi = np.zeros_like(x), np.full_like(x, n)
    else:                                 # one address for the group
        t = ix.table.numpy().view(np.uint32).astype(np.int64)
        b = x >> ix.shift
        inside = b < ix.nb                # else above every key: [n, n)
        bc = np.minimum(b, ix.nb - 1)
        lo, hi = np.where(inside, t[bc], n), np.where(inside, t[bc + 1], n)
    # ku: the last key read at or above the needle, -1 for ~x (no u32)
    base, length, ku = lo, hi - lo, np.full_like(x, -1)
    rows = np.arange(x.size)
    sub = np.arange(GROUP)
    rounds = 0
    while (length > 0).any():             # __any_sync over the warp
        rounds += 1
        live = length > 0
        nprobe = np.minimum(length, PROBES)
        # probe j = sub + r * GROUP of slot r: [needle, r, sub]
        j = (sub[None, None, :] + GROUP * np.arange(2)[None, :, None])
        L, B = length[:, None, None], base[:, None, None]
        pos = np.where(L <= PROBES, B + j, B + (j + 1) * L // (PROBES + 1))
        valid = j < nprobe[:, None, None]
        key = np.where(valid, k[np.clip(pos, 0, max(n - 1, 0))], 0)
        lt = valid & (key < x[:, None, None])
        # two ballots, each shifted to the group's 16 lanes and counted
        c = lt[:, 0].sum(axis=1) + lt[:, 1].sum(axis=1)
        flat = lt.reshape(x.size, PROBES)
        assert (flat == (np.arange(PROBES) < c[:, None])).all(), \
            "the probes below the needle are not a prefix"
        # the shuffle: slot c >= GROUP, lane c & (GROUP - 1)
        kc = key[rows, (c >= GROUP).astype(int), c & (GROUP - 1)]

        def at(jj):                       # probe jj's position
            jj = np.clip(jj, 0, PROBES - 1)
            return pos[rows, jj // GROUP, jj % GROUP]
        new_lo = np.where(c == 0, base, at(c - 1) + 1)
        end = np.where(c == nprobe, base + length, at(c))
        ku = np.where(live & (c < nprobe), kc, ku)
        base = np.where(live, new_lo, base)
        length = np.where(live, end - new_lo, length)
    return base, ku == x, rounds


HAYS = ["profile_shard", "skewed", "fifteen_keys", "all_ones",
        "small_keys", "empty"]
PROFILE_SHARD = 62_277           # keys of one profile --shard-db 4 shard


def _hay(name: str) -> np.ndarray:
    rng = np.random.default_rng(HAYS.index(name) + 700)
    if name == "profile_shard":
        hay = np.unique(_u32(rng, 0, 1 << 32, PROFILE_SHARD + 64))
        return np.sort(rng.choice(hay, PROFILE_SHARD, replace=False))
    if name == "skewed":              # 30K keys in one bucket's range
        return np.unique(np.concatenate([_u32(rng, 0, 1 << 16, 30_000),
                                         _u32(rng, 1 << 31, 1 << 32,
                                              20_000)]))
    if name == "fifteen_keys":        # below 16 keys: no table
        return np.unique(_u32(rng, 0, 1 << 32, 15))
    if name == "all_ones":
        return np.append(np.unique(_u32(rng, 0, ALL_ONES, 30_000)),
                         np.uint32(ALL_ONES))
    if name == "small_keys":          # K8S5L2-like ids: top bits all 0
        return np.unique(_u32(rng, 0, 1 << 20, 40_000))
    return np.zeros(0, np.uint32)


def _needles(hay: np.ndarray, name: str, order: str) -> np.ndarray:
    """About the profile's count (5,636, nearly all hits there), half hits
    elsewhere, with 0xFFFFFFFF, 0 and the keys' neighbours."""
    rng = np.random.default_rng(HAYS.index(name) + 800)
    n = 5636
    hits = rng.choice(hay, n - 200 if name == "profile_shard" else n // 2) \
        if hay.size else np.zeros(0, np.uint32)
    k = hay.astype(np.int64)
    near = np.concatenate([k[:50] - 1, k[-50:] + 1, [0, ALL_ONES]]) \
        if hay.size else np.array([0, ALL_ONES])
    near = near[(near >= 0) & (near <= ALL_ONES)].astype(np.uint32)
    x = np.concatenate([hits, near, _u32(rng, 0, 1 << 32, n - hits.size)])
    if name == "small_keys":          # most misses inside the keys' range
        x = np.concatenate([x, _u32(rng, 0, 1 << 20, 3000)])
    x = np.sort(x.astype(np.uint32))
    return rng.permutation(x) if order == "shuffled" else x


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("identity", [False, True])
@pytest.mark.parametrize("name", HAYS)
def test_groups_mirror_matches(name, identity, order):
    hay = _hay(name)
    x = _needles(hay, name, order)
    rng = np.random.default_rng(HAYS.index(name) + 900)
    values = _u32(rng, 1, 1 << 32, hay.size)
    h, nd = merge.u32_tensor(hay), merge.u32_tensor(x)
    ix = merge.build_index(h)
    assert (ix.nb == 0) == (hay.size < 16)
    pos, hit, rounds = _groups_search(hay, ix, x)

    lb = np.searchsorted(hay.astype(np.int64), x.astype(np.int64))
    want_hit = (lb < hay.size) & \
        (hay[np.minimum(lb, max(hay.size - 1, 0))] == x if hay.size
         else np.zeros(x.size, bool))
    np.testing.assert_array_equal(pos, lb)
    np.testing.assert_array_equal(hit, want_hit)
    # the kernel's outputs from its lower bounds and hits
    pos_c = np.minimum(pos, max(hay.size - 1, 0))
    if identity:
        value = np.where(hit, pos, 0).astype(np.uint32)
    else:
        value = np.where(hit, values[pos_c] if hay.size else 0,
                         0).astype(np.uint32)
    v = None if identity else merge.u32_tensor(values)
    pm, pv = merge.member_plain(h, v, nd)
    np.testing.assert_array_equal(pm.numpy().astype(bool), hit)
    np.testing.assert_array_equal(pv.numpy().view(np.uint32), value)

    jax_hay = jax_merge.StaticHaystack(hay) if identity else hay
    jm, jv = jax_merge.sorted_membership(
        jax_hay, None if identity else values, x, use_pallas=False)
    np.testing.assert_array_equal(jm, hit)
    np.testing.assert_array_equal(jv, value)
    if name == "profile_shard" and order == "sorted":
        # the TPU kernel itself, in interpret mode (it never reports
        # 0xFFFFFFFF, which it pads with)
        pal_m, pal_v = jax_merge.sorted_membership(
            hay, np.arange(hay.size, dtype=np.uint32) if identity
            else values, x, use_pallas=True, interpret=True)
        keep = x != ALL_ONES
        np.testing.assert_array_equal(pal_m[keep], hit[keep])
        np.testing.assert_array_equal(pal_v[keep], value[keep])

    if name == "profile_shard":       # about 15 keys a bucket: one round
        sizes = np.diff(ix.table.numpy().view(np.uint32).astype(np.int64))
        assert 14 < sizes.mean() < 16 and rounds <= 2
        assert hit.mean() > 0.9
    if name == "skewed":              # narrowing rounds ran
        assert rounds >= 3
    if name == "all_ones":
        assert hit[x == ALL_ONES].all()
    if name in ("fifteen_keys", "empty"):
        assert rounds <= 1
    if name == "small_keys":          # needles above every key: b >= nb
        assert ((x.astype(np.int64) >> ix.shift) >= ix.nb).any()
    assert hit.any() == bool(hay.size)


def test_launch_rule_is_the_source():
    """merge's copy of the threshold is the kernel's, and its rule is
    the source's: the groups launch up to it, the blocks launch past."""
    assert int(_source_constant("kGroupsMaxNeedles")) == \
        merge.GROUPS_MAX_NEEDLES
    with open(SOURCE) as f:
        text = f.read()
    assert "return nn <= kGroupsMaxNeedles ? kLaunchGroups : kLaunchBlocks;" \
        in text
    assert merge.K3_LAUNCH_CODES == {
        "blocks": int(re.search(r"kLaunchBlocks = (\d)", text).group(1)),
        "groups": int(re.search(r"kLaunchGroups = (\d)", text).group(1))}


# (needles, launch) of the calls PERF.md times (chip_smoke.py's records
# and probes/bench_member.SHAPES), and around the threshold
RULE_CASES = [
    ("profile --shard-db 1", 5636, "groups"),
    ("profile --shard-db 4, one shard", 5636, "groups"),
    ("dist -r --shard-db 4, one shard", 1_000_033, "blocks"),
    ("4M x 1M", 1 << 20, "blocks"),
    ("dist batch", 128 * 4096, "blocks"),
    ("set -s", 65_600 * 1024, "blocks"),
    ("one needle", 1, "groups"),
    ("threshold - 1", merge.GROUPS_MAX_NEEDLES - 1, "groups"),
    ("threshold", merge.GROUPS_MAX_NEEDLES, "groups"),
    ("threshold + 1", merge.GROUPS_MAX_NEEDLES + 1, "blocks"),
]


@pytest.mark.parametrize("shape,nn,want", RULE_CASES,
                         ids=[c[0] for c in RULE_CASES])
def test_launch_rule(shape, nn, want):
    assert merge.member_launch(nn) == want, shape


def test_member_refuses_unknown_launch():
    """A launch that K3 does not have is refused on every device; a named
    one gives the plain results on the CPU."""
    h = merge.u32_tensor(np.arange(100, dtype=np.uint32) * 3)
    nd = merge.u32_tensor(np.arange(50, dtype=np.uint32))
    with pytest.raises(ValueError, match="no K3 launch"):
        merge.member(h, None, nd, launch="warps")
    for launch in ("blocks", "groups", None):
        m, v = merge.member(h, None, nd, launch=launch)
        pm, pv = merge.member_plain(h, None, nd)
        assert torch.equal(m, pm) and torch.equal(v, pv)


@pytest.mark.parametrize("dtype", [torch.int8, torch.uint16])
def test_vector_floor_alignment_check(dtype):
    """The int8/uint16 floor kernel reads 16 bytes a load: a tile tensor
    at a 16-byte aligned base passes the wrapper's check at any row, a
    view one element off is refused."""
    big = torch.zeros(2 * 40 * probe.LANES + 64, dtype=dtype)
    off = (-big.data_ptr() % 16) // big.element_size()
    n = 2 * 40 * probe.LANES
    good = big[off:off + n].view(2, 40, probe.LANES)
    for row0 in (0, 1, 3, 39):
        probe.check_vector_rows(good, row0)
    bad = big[off + 1:off + 1 + n].view(2, 40, probe.LANES)
    with pytest.raises(ValueError, match="16-byte"):
        probe.check_vector_rows(bad, 0)
    # the plain version on the CPU takes any view
    assert torch.equal(probe.floor(bad, 0, 40),
                       probe.floor_plain(bad.clone(), 0, 40))
