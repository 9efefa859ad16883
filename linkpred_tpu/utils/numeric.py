"""Small numeric helpers shared across the package.

Includes the reference's prime helpers (`/root/reference/inc/_cmath.hxx:
100-146`) for parity: there they size open-addressing hash capacities; the
sort-based engine never needs a prime capacity, so these are host-side
utility functions only.
"""
from __future__ import annotations

__all__ = ["next_pow2", "is_prime", "next_prime", "random_prime"]


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()


def is_prime(x: int) -> bool:
    """6k±1 trial division (`_cmath.hxx:106-116`)."""
    x = int(x)
    if x <= 3:
        return x > 1
    if x % 2 == 0 or x % 3 == 0:
        return False
    i = 5
    while i * i <= x:
        if x % i == 0 or x % (i + 2) == 0:
            return False
        i += 6
    return True


def next_prime(x: int) -> int:
    """Smallest prime strictly greater than ``x`` (`_cmath.hxx:124-128`)."""
    x = int(x)
    while True:
        x += 1
        if is_prime(x):
            return x


def random_prime(begin: int, end: int, rng) -> int:
    """A random prime in [begin, end], or ``end + 1`` when 128 draws find
    none (`_cmath.hxx:138-146` — same bounded-attempts contract).  ``rng`` is
    a ``numpy.random.Generator``."""
    for _ in range(128):
        a = int(rng.integers(begin, end + 1))
        if is_prime(a):
            return a
    return end + 1
