"""Small numeric helpers.

TPU-native counterpart of the reference's ``stereomatch/numeric.py``
(reference: stereomatch/numeric.py:5-26).  The reference needs power-of-two
disparity counts because its CUDA reduction trees require them
(src/winners_take_all.cu:65-75, src/semiglobal_gpu.cu:70-79).  The TPU build
has no such constraint, but the helpers remain useful: the disparity axis maps
to TPU vector lanes (width 128), so rounding D up to a power of two / lane
multiple keeps tiles dense.
"""

from __future__ import annotations


def is_power_of_two(num: int) -> bool:
    """True when ``num`` is a positive power of two."""
    return (num != 0) and (num & (num - 1) == 0)


def next_power_of_2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    if n == 0:
        return 1
    if is_power_of_two(n):
        return n
    count = 0
    while n > 0:
        n >>= 1
        count += 1
    return 1 << count


def round_up_to_multiple(n: int, multiple: int) -> int:
    """Round ``n`` up to the nearest multiple of ``multiple``."""
    return ((n + multiple - 1) // multiple) * multiple


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)
