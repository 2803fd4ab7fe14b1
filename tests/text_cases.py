"""Values and names for the tests of the ranked-text formatter
(``metakssd_tpu_torch/ops/abv_text.py``), on the CPU and on the card."""

import numpy as np

NEXT_ABOVE = float(np.nextafter(9e12, np.inf))

# printed by the formatter: ties at the seventh decimal, -0.0, negatives
# that print -0.000000, subnormals, values of every mode's range and the
# largest magnitude it takes (9e12)
PRINTED = [0.0, -0.0, 0.0078125, -0.0078125, 5e-7, 1.5e-6, 2.5e-6, 3.5e-6,
           -1e-7, -4e-7, -5e-7, -5.000001e-7, 5e-324, -5e-324,
           2.2250738585072014e-308, 1e-300, 0.1, 0.5, 1.0, 99.9999995,
           123456.7890125, 141.42135623730951, 200.0, 1e12, 1e12 + 0.5,
           float(np.nextafter(9e12, 0)), 9e12, -9e12]

# flagged, so that the host writer prints the query: magnitudes from the
# smallest above 9e12 to the largest double, and the values not finite
FLAGGED = [NEXT_ABOVE, -NEXT_ABOVE, 1e15, 1e16, 1e17, 1e18, -1e18,
           1.7976931348623157e308, np.inf, -np.inf, np.nan]


def mode_values(mode: int, n: int, rng) -> np.ndarray:
    """``n`` printed values (float64) as ``abv_postings.rank`` gives them
    in ``mode``: cosine a float32 in [0, 1], L1 a float32 in [-1e-5, 200]
    (near-equal vectors round below 0), L2 the root of a float32 sum up
    to 20,000."""
    u = rng.random(n)
    if mode == 0:
        return u.astype(np.float32).astype(np.float64)
    if mode == 1:
        return (u * 200.00001 - 1e-5).astype(np.float32).astype(np.float64)
    return np.sqrt((u * 20000).astype(np.float32).astype(np.float64))


def names_of_lengths(n: int, rng, longest: int = 64) -> list[str]:
    """``n`` names of 0 to ``longest`` characters, one of them not ASCII."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789._-"))
    names = ["".join(letters[rng.integers(0, letters.size, k)])
             for k in rng.integers(0, longest + 1, n)]
    names[n // 2] = "sample-é.abv"
    return names
