"""Small numeric helpers, and the float32 arithmetic of XLA's CPU backend
(:func:`fma`, :func:`exp_f32`, :func:`log_f32`, :func:`log1p_f32`,
:func:`prefix_sum_w`, :func:`pairwise_sum_last`) that the plain versions
reproduce.

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
        return torch.full((), value, dtype=torch.float32, device=x.device)

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


# Cephes' single-precision log: sqrt(1/2), the polynomial's coefficients
# (highest power first) and ln(2) in two parts.
_SQRTHF = 0.707106781186547524
_LOG_POLY = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
             -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
             2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q = (-2.12194440e-4, 0.693359375)
_MIN_NORMAL = 1.1754943508222875e-38


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of a float32 tensor as XLA's CPU backend computes it:
    Cephes' polynomial in three interleaved Horner chains, the products
    feeding sums contracted into fused multiply-adds as LLVM contracts
    them (measured against ``jnp.log`` under ``jit``).  Denormal inputs
    are flushed to zero: 0 and a denormal give -inf, +inf gives +inf, a
    negative input NaN."""
    def const(value):
        return torch.full((), value, dtype=torch.float32, device=x.device)

    x = x.to(torch.float32)
    m = torch.maximum(x, const(_MIN_NORMAL))
    bits = m.view(torch.int32)
    exponent = (bits >> 23) - 0x7F
    # The mantissa in [0.5, 1): the exponent bits replaced by 0.5's.
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    e = 1.0 + exponent.to(torch.float32)
    low = m < const(_SQRTHF)
    e = e - low.to(torch.float32)
    m = (m - 1.0) + torch.where(low, m, const(0.0))
    x2 = m * m
    x3 = x2 * m
    p = _LOG_POLY
    y = fma(fma(m, const(p[0]), const(p[1])), m, const(p[2]))
    y1 = fma(fma(m, const(p[3]), const(p[4])), m, const(p[5]))
    y2 = fma(fma(m, const(p[6]), const(p[7])), m, const(p[8]))
    y = fma(fma(y, x3, y1), x3, y2)
    y = fma(y, x3, const(_LOG_Q[0]) * e)
    out = fma(const(-0.5), x2, m) + y
    out = fma(const(_LOG_Q[1]), e, out)
    out = torch.where(x.abs() < _MIN_NORMAL, const(float("-inf")), out)
    out = torch.where(x == float("inf"), const(float("inf")), out)
    return torch.where((x <= -_MIN_NORMAL) | x.isnan(), const(float("nan")),
                       out)


# Cephes' log1p rational approximation for |x| < sqrt(2) - 1: numerator
# and denominator coefficients, highest power first.
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """log(1 + x) of a float32 tensor as XLA's CPU backend computes it:
    ``log_f32(x + 1)`` from sqrt(2) - 1 up, below it x - x^2/2 + x^3 P/Q
    with Cephes' rational P/Q in fused Horner steps (measured against
    ``jnp.log1p`` under ``jit``)."""
    def const(value):
        return torch.full((), value, dtype=torch.float32, device=x.device)

    def horner(coefficients):
        acc = const(0.0)
        for c in coefficients:
            acc = fma(acc, x, const(c))
        return acc

    x = x.to(torch.float32)
    x2 = x * x
    ratio = horner(_LOG1P_NUM) / horner(_LOG1P_DEN)
    small = x + fma(const(-0.5), x2, (x * x2) * ratio)
    return torch.where(x.abs() < const(_LOG1P_SMALL), small, log_f32(x + 1.0))
