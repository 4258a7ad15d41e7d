"""Small numeric helpers, and the float32 arithmetic of XLA's CPU backend
(:func:`fma`, :func:`exp_f32`, :func:`prefix_sum_w`,
:func:`pairwise_sum_last`) that the plain versions reproduce.

TPU-native counterpart of the reference's ``stereomatch/numeric.py``
(reference: stereomatch/numeric.py:5-26).  The reference needs power-of-two
disparity counts because its CUDA reduction trees require them
(src/winners_take_all.cu:65-75, src/semiglobal_gpu.cu:70-79).  The TPU build
has no such constraint, but the helpers remain useful: the disparity axis maps
to TPU vector lanes (width 128), so rounding D up to a power of two / lane
multiple keeps tiles dense.
"""

from __future__ import annotations

import torch


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


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32, as a fused multiply-add.

    XLA's CPU backend contracts a product feeding an add into one FMA,
    and the CUDA kernels do the same with ``__fmaf_rn``; torch has no
    FMA operator.  The product of two float32 values is exact in
    float64, so only the sum rounds before the final cast (a double
    rounding that differs from one rounding only when the float64 sum
    lands exactly halfway between two float32 values).
    """
    return torch.addcmul(c.to(torch.float64), a.to(torch.float64),
                         b.to(torch.float64)).to(torch.float32)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float32 tensor, as XLA's CPU
    backend and numpy compute it, on every device.

    ``torch.sqrt`` on the CPU is within one unit in the last place but
    not always the nearest value (about one value in 150 is off, in
    float32 and in float64, and which ones can change between calls as
    the work is split among threads).  So its result is only the first
    guess: of it and its two float32 neighbours, the one kept is the one
    whose rounding interval holds sqrt(x), decided by squaring the
    interval's ends in float64, where a 25-bit midpoint's square is
    exact."""
    x = x.to(torch.float32)
    y = torch.sqrt(x)
    x64 = x.to(torch.float64)
    up = torch.nextafter(y, torch.full_like(y, float("inf")))
    mid = (y.to(torch.float64) + up.to(torch.float64)) * 0.5
    y = torch.where(mid * mid < x64, up, y)
    down = torch.nextafter(y, torch.zeros_like(y))
    mid = (y.to(torch.float64) + down.to(torch.float64)) * 0.5
    return torch.where(mid * mid > x64, down, y)


# XLA's CPU compiler rewrites a cumulative reduce_window into a scan over
# blocks of this many elements (the ReduceWindowRewriter's base length).
_SCAN_BASE = 16


def prefix_sum_w(plane: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over axis 1 of an [H, N] float32 plane, in
    the association of ``jnp.cumsum`` on XLA's CPU backend: the axis is
    zero-padded to blocks of 16; each block is summed in order; the block
    totals are scanned the same way, recursively; each element then adds
    the exclusive scan of the totals before its block.  Elementwise adds
    only, so the card gives the CPU's values (``torch.cumsum`` on the
    card takes another association)."""
    height, n = plane.shape
    if n <= _SCAN_BASE:
        out = plane.clone()
        for k in range(1, n):
            out[:, k].add_(out[:, k - 1])
        return out
    blocks = -(-n // _SCAN_BASE)
    padded = plane.new_zeros((height, blocks * _SCAN_BASE))
    padded[:, :n] = plane
    inner = padded.view(height, blocks, _SCAN_BASE)
    for k in range(1, _SCAN_BASE):
        inner[:, :, k].add_(inner[:, :, k - 1])
    totals = prefix_sum_w(inner[:, :, -1].contiguous())
    exclusive = torch.cat([plane.new_zeros((height, 1)), totals[:, :-1]],
                          dim=1)
    out = inner + exclusive[:, :, None]
    return out.view(height, blocks * _SCAN_BASE)[:, :n]


def pairwise_sum_last(v: torch.Tensor) -> torch.Tensor:
    """Sum along the last axis in a fixed association, the JAX package's
    ``pairwise_sum_last``: zero-pad the axis to a power of two, then fold
    it in half with elementwise adds until one element is left.  The
    association depends on the axis length alone, so a row band gives
    the per-row sums of the whole image bit for bit, and the card gives
    the CPU's (``torch.sum`` picks its own reduction tree)."""
    n = v.shape[-1]
    p = 1 << max((n - 1).bit_length(), 0)
    if p != n:
        v = torch.cat([v, v.new_zeros(v.shape[:-1] + (p - n,))], dim=-1)
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


# Cephes' single-precision exp: the range limits, log2(e), ln(2) in two
# parts, and the polynomial's coefficients, highest power first.
_EXP_LIMITS = (-87.8, 88.8)
_LOG2E = 1.44269504088896341
_LN2 = (0.693359375, -2.12194440e-4)
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of a float32 tensor as XLA's CPU backend computes it.

    XLA emits Cephes' polynomial for ``exp``, its products feeding sums
    contracted into fused multiply-adds (:func:`fma`), and runs with
    denormal results flushed to zero.  It differs from ``torch.exp`` in
    the last place for about one argument in ten, so the plain versions
    that weigh by an exponential (the weighted median, the fast global
    smoother) take this one: the same values as the JAX package on the
    CPU, and the same values on every device.  Arguments are clamped to
    [-87.8, 88.8]; NaN stays NaN.
    """
    def const(value):
        return torch.tensor(value, dtype=torch.float32, device=x.device)

    x = x.to(torch.float32).clamp(*_EXP_LIMITS)
    n = torch.floor(fma(x, const(_LOG2E), const(0.5))).clamp(-127, 127)
    r = fma(n, const(-_LN2[0]), x)
    r = fma(n, const(-_LN2[1]), r)
    p = fma(r, const(_EXP_POLY[0]), const(_EXP_POLY[1]))
    for coef in _EXP_POLY[2:]:
        p = fma(p, r, const(coef))
    y = 1.0 + fma(p, r * r, r)
    # 2^n from its exponent bits (n = -127 gives 0, as XLA's does).
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = y * scale
    return torch.where(out < torch.finfo(torch.float32).tiny, 0.0, out)
