"""Cost-volume construction, plain PyTorch versions.

Port of ``stereomatch_tpu/ops/cost.py`` (``shifted_right_stack``,
``_box_sum``, ``_diff_cost_volume``, ``ssd_cost_volume``,
``sad_cost_volume``, ``census_transform``,
``census_hamming_cost_volume``, ``birchfield_cost_volume``,
``zncc_cost_volume``, ``zncc_cost_from_padded``) and the texture grids
that ``cost.SSDTexture`` compares.  These run on any device.  The SSD/SAD
volumes are the oracle of the CUDA kernel in ``ops/ssd_cuda.py``;
``cost.SSD``/``cost.SAD``/``cost.SSDTexture`` choose between the two.
Census, Birchfield and ZNCC have no kernel of their own (the JAX package
computes them in XLA, with no Pallas kernel), so they run as plain
PyTorch on the card too.

ZNCC's sums are elementwise adds in fixed orders: the prefix planes
take XLA's CPU cumsum association (``utils.numeric.prefix_sum_w``), the
image means ``pairwise_sum_last``'s, every box the sequential window
order below; no ``torch.sum`` or ``torch.cumsum``, whose trees differ
between the CPU and the card.  The JAX package sums the volume's row
box of ZNCC as a banded matrix product where H <= 512; on XLA's CPU
that product equals the sequential sum bit for bit at small heights
(the tests' shapes) and departs from it in the last place on about 2%
of cells at 375 rows.

Semantics (reference ``src/ssd.cu:15-81``):
  - the window along each axis is half-open, [i-k, i+k): 2k taps,
    realised with zero padding (k before, k-1 after), which equals
    window clipping because the summand is non-negative;
  - the w < d wedge is zeroed before the box sum (so the column window's
    lower bound becomes max(c-k, d)) and set to +inf (int32 max for the
    integer chain) after it.

Summation order: each box sum is 2k explicit shifted adds in window
order, the H axis first and then the W axis.  That is the association
XLA's ``reduce_window`` takes on the CPU, so these volumes equal the JAX
oracle's bit for bit; the CUDA kernel keeps the same order.  No
cumulative sum (its cancellation changes the values) and no
convolution (cuDNN's default TF32 truncates the mantissa).

A bfloat16 volume takes the float32 chain and rounds each cost once to
nearest even as it is cast (``+inf`` stays ``+inf``), where XLA's
``astype`` rounds it (``stereomatch_tpu/ops/cost.py:189,269``); images of
any accepted dtype, bf16 included, are widened to the compute dtype
first.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.numeric import fma, pairwise_sum_last, prefix_sum_w, sqrt_f32


def _inf_value(dtype: torch.dtype):
    """+inf for float dtypes, the max value for integer dtypes."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def compute_dtype(cost_dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype of the window sums for a cost dtype."""
    return torch.float32 if cost_dtype.is_floating_point else torch.int32


def shifted_right_stack(right: torch.Tensor, max_disparity: int,
                        disparity_offset: int = 0) -> torch.Tensor:
    """S[h, w, d] = right[h, w - d - offset], zero where the source column
    is negative.  ``right`` may have any width ([H, W+1] prefix planes
    too)."""
    width = right.shape[1]
    w_idx = torch.arange(width, device=right.device)[:, None]
    d_idx = torch.arange(max_disparity, device=right.device)[None, :]
    src = w_idx - d_idx - disparity_offset
    gathered = right[:, src.clamp(min=0)]                    # [H, W, D]
    return torch.where(src >= 0, gathered,
                       torch.zeros((), dtype=right.dtype,
                                   device=right.device))


def _box_sum(volume: torch.Tensor, kernel_size: int,
             axes: tuple) -> torch.Tensor:
    """Separable clipped box sum over the half-open window [i-k, i+k).

    Per axis: zero-pad (k, k-1), then add the 2k shifted views in window
    order — the association of XLA's reduce_window on the CPU.
    """
    k = kernel_size
    for ax in axes:
        n = volume.shape[ax]
        before = list(volume.shape)
        before[ax] = k
        after = list(volume.shape)
        after[ax] = k - 1
        padded = torch.cat([volume.new_zeros(before), volume,
                            volume.new_zeros(after)], dim=ax)
        acc = padded.narrow(ax, 0, n).clone()
        for t in range(1, 2 * k):
            acc.add_(padded.narrow(ax, t, n))
        volume = acc
    return volume


def _diff_cost_volume(left: torch.Tensor, right: torch.Tensor, *,
                      max_disparity: int, kernel_size: int,
                      cost_dtype: torch.dtype,
                      absolute: bool) -> torch.Tensor:
    """Shared body of the SSD / SAD windowed-difference cost volumes."""
    cdt = compute_dtype(cost_dtype)
    left_c = left.to(cdt)
    right_c = right.to(cdt)

    shifted = shifted_right_stack(right_c, max_disparity)    # [H, W, D]
    diff = left_c[:, :, None] - shifted
    term = diff.abs() if absolute else diff * diff

    # Zero out w < d so the column window's lower bound becomes
    # max(c - k, d) (ssd.cu:40-42).
    w_idx = torch.arange(left.shape[1], device=left.device)[:, None]
    d_idx = torch.arange(max_disparity, device=left.device)[None, :]
    valid = (w_idx >= d_idx)[None]
    term = torch.where(valid, term, torch.zeros((), dtype=cdt,
                                                device=left.device))
    cost = _box_sum(term, kernel_size, axes=(0, 1))
    return torch.where(valid, cost.to(cost_dtype),
                       torch.tensor(_inf_value(cost_dtype), dtype=cost_dtype,
                                    device=left.device))


def ssd_cost_volume(left: torch.Tensor, right: torch.Tensor, *,
                    max_disparity: int, kernel_size: int = 7,
                    cost_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sum-of-squared-differences cost volume [H, W, D], plain PyTorch.

    For each pixel and disparity d <= c, the sum over the clipped window
    of (L[r, c] - R[r, c - d])^2; +inf (int32 max) where d > c.
    """
    return _diff_cost_volume(left, right, max_disparity=max_disparity,
                             kernel_size=kernel_size, cost_dtype=cost_dtype,
                             absolute=False)


def sad_cost_volume(left: torch.Tensor, right: torch.Tensor, *,
                    max_disparity: int, kernel_size: int = 7,
                    cost_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sum-of-absolute-differences cost volume [H, W, D], plain PyTorch:
    the SSD window and validity with an L1 summand."""
    return _diff_cost_volume(left, right, max_disparity=max_disparity,
                             kernel_size=kernel_size, cost_dtype=cost_dtype,
                             absolute=True)


def census_transform(image: torch.Tensor, window_size: int = 5
                     ) -> torch.Tensor:
    """Census descriptor per pixel: one bit per window neighbour, set when
    neighbour < centre, in row-major window order from bit 0.

    ``window_size`` must be odd.  Up to 5x5 (24 bits) the result is an
    [H, W] int32 code plane; larger windows give [H, W, n_words] stacked
    int32 planes (7x7 -> 48 bits -> 2 words).  Out-of-image neighbours
    read as 0.  Bit 31 of a word is its sign bit.

    All neighbours are compared at once (a handful of launches on the
    card, not one per neighbour); the bits of a word are distinct powers
    of two, so their int32 sum is their OR and cannot overflow.
    """
    if window_size % 2 == 0:
        raise ValueError(f"window_size must be odd (got {window_size})")
    img = image.to(torch.float32)
    height, width = img.shape
    half = window_size // 2
    if half == 0:
        return torch.zeros((height, width), dtype=torch.int32,
                           device=image.device)
    padded = torch.nn.functional.pad(img, (half, half, half, half))
    neighbors = torch.stack(
        [padded[half + dy:half + dy + height, half + dx:half + dx + width]
         for dy in range(-half, half + 1) for dx in range(-half, half + 1)
         if dy or dx], dim=-1)                          # [H, W, n_bits]
    bits = (neighbors < img[:, :, None]).to(torch.int32)
    n_bits = bits.shape[-1]
    n_words = -(-n_bits // 32)
    bits = torch.nn.functional.pad(bits, (0, n_words * 32 - n_bits))
    shifts = torch.arange(32, dtype=torch.int32, device=image.device)
    words = (bits.view(height, width, n_words, 32) << shifts).sum(
        dim=-1, dtype=torch.int32)
    if n_bits <= 32:
        return words[:, :, 0]
    return words


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 (sign bit included), as int32.

    torch has no popcount.  SWAR: pair, nibble and byte sums.  ``>>`` on
    int32 is arithmetic, so every shift is followed by a mask whose top
    bits are zero, which makes it a logical shift; from the nibble step
    on every value is non-negative, and the byte sums are folded with
    shifts and adds, so nothing overflows.
    """
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def census_hamming_cost_volume(left: torch.Tensor, right: torch.Tensor, *,
                               max_disparity: int, window_size: int = 5,
                               kernel_size: int = 1,
                               cost_dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """Hamming distance between census codes as an [H, W, D] volume.

    cost[y, x, d] = popcount(census(L)[y, x] XOR census(R)[y, x - d]),
    summed over the code words, box-summed over the SSD window when
    ``kernel_size > 1``; +inf (int32 max) where d > x.
    """
    cl = census_transform(left, window_size)
    cr = census_transform(right, window_size)
    if cl.ndim == 2:
        cl, cr = cl[..., None], cr[..., None]

    ham = None
    for w in range(cl.shape[-1]):
        shifted = shifted_right_stack(cr[..., w], max_disparity)
        pc = popcount32(cl[..., w][:, :, None] ^ shifted)
        ham = pc if ham is None else ham + pc

    w_idx = torch.arange(left.shape[1], device=left.device)[:, None]
    d_idx = torch.arange(max_disparity, device=left.device)[None, :]
    valid = (w_idx >= d_idx)[None]
    cost = torch.where(valid, ham, torch.zeros((), dtype=ham.dtype,
                                               device=left.device))
    if kernel_size > 1:
        cost = _box_sum(cost.to(compute_dtype(cost_dtype)), kernel_size,
                        axes=(0, 1))
    # Pixelwise distances go to the cost dtype in one cast: they are
    # integers of at most 32 bits a word, exact in float32, so rounding
    # them straight to bf16 equals XLA's cast through float32.
    return torch.where(valid, cost.to(cost_dtype),
                       torch.tensor(_inf_value(cost_dtype), dtype=cost_dtype,
                                    device=left.device))


def _valid_wedge(width: int, max_disparity: int, disparity_offset: int,
                 device) -> torch.Tensor:
    """[1, W, D] bool: column w holds disparity d + offset (w >= d +
    offset)."""
    w_idx = torch.arange(width, device=device)[:, None]
    d_idx = torch.arange(max_disparity, device=device)[None, :]
    return (w_idx >= d_idx + disparity_offset)[None]


# --------------------------------------------------------------------------
# Birchfield-Tomasi
# --------------------------------------------------------------------------

def _birchfield_match_cost(left: torch.Tensor, right: torch.Tensor,
                           max_disparity: int,
                           disparity_offset: int = 0) -> torch.Tensor:
    """Per-pixel Birchfield-Tomasi dissimilarity m[h, p, d] of float32
    images, each scanline with a zero one-pixel border (the reference's
    shared-memory body, ``src/birchfield_cost.cu:95-135``)."""
    height, width = left.shape
    zeros_col = left.new_zeros((height, 1))
    lpad = torch.cat([zeros_col, left, zeros_col], dim=1)      # [H, W+2]
    rpad = torch.cat([zeros_col, right, zeros_col], dim=1)
    l_c = left
    l_m = lpad[:, :width]                                       # L[p-1]
    l_p = lpad[:, 2:]                                           # L[p+1]

    # R[p - d] and its neighbours: clamped gathers into the padded
    # scanline, rpad[i] = R[i-1].
    p_idx = torch.arange(width, device=left.device)[:, None]
    d_idx = torch.arange(max_disparity, device=left.device)[None, :]
    centre = p_idx - d_idx - disparity_offset + 1
    r_c = rpad[:, centre.clamp(0, width + 1)]                   # [H, W, D]
    r_m = rpad[:, (centre - 1).clamp(0, width + 1)]
    r_p = rpad[:, (centre + 1).clamp(0, width + 1)]

    la = 0.5 * (l_c + l_m)
    lb = 0.5 * (l_c + l_p)
    ra = 0.5 * (r_c + r_m)
    rb = 0.5 * (r_c + r_p)

    l_c3 = l_c[:, :, None]
    la3, lb3 = la[:, :, None], lb[:, :, None]
    lmin = torch.minimum(torch.minimum(la3, lb3), l_c3)
    lmax = torch.maximum(torch.maximum(la3, lb3), l_c3)
    rmin = torch.minimum(torch.minimum(ra, rb), r_c)
    rmax = torch.maximum(torch.maximum(ra, rb), r_c)

    zero = torch.zeros((), dtype=left.dtype, device=left.device)
    term_l = torch.maximum(torch.maximum(zero, l_c3 - rmax), rmin - l_c3)
    term_r = torch.maximum(torch.maximum(zero, r_c - lmax), lmin - r_c)
    return torch.minimum(term_l, term_r)                        # [H, W, D]


def birchfield_cost_volume(left: torch.Tensor, right: torch.Tensor, *,
                           max_disparity: int, kernel_size: int = 4,
                           disparity_offset: int = 0) -> torch.Tensor:
    """Birchfield-Tomasi sampling-insensitive cost volume [H, W, D],
    float32 whatever the images' dtype: the per-pixel dissimilarity
    summed over the scanline window [x-k, x+k) clipped to [d, W), +inf
    where d + offset > x (``src/birchfield_cost.cu:153-181``).  Rows
    never mix, so a row band gives the whole image's rows."""
    left_f = left.to(torch.float32)
    right_f = right.to(torch.float32)
    m = _birchfield_match_cost(left_f, right_f, max_disparity,
                               disparity_offset)
    valid = _valid_wedge(left.shape[1], max_disparity, disparity_offset,
                         left.device)
    m = torch.where(valid, m, torch.zeros((), device=left.device))
    cost = _box_sum(m, kernel_size, axes=(1,))
    return torch.where(valid, cost,
                       torch.tensor(float("inf"), device=left.device))


# --------------------------------------------------------------------------
# ZNCC
# --------------------------------------------------------------------------

# The variance floor of ZNCC (the JAX package's ``eps`` default, which no
# caller there changes).
ZNCC_EPS = 1e-6


def _zncc_stack(left_f: torch.Tensor, shifted: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """The six windowed summands of the ZNCC statistics, stacked
    [count, sum_L, sum_L2, sum_R, sum_R2, sum_LR], each masked by the
    (column, disparity) validity.  ``shifted`` is zero where invalid."""
    v = torch.broadcast_to(valid, shifted.shape).to(torch.float32)
    l3 = left_f[:, :, None] * v
    return torch.stack([v, l3, l3 * left_f[:, :, None], shifted,
                        shifted * shifted, left_f[:, :, None] * shifted])


def _zncc_combine(sums, valid: torch.Tensor,
                  cost_dtype: torch.dtype) -> torch.Tensor:
    """Window statistics -> ZNCC cost ``1 - ncc`` in [0, 2], +inf outside
    ``valid``.  A window whose variance product's root is at most
    ``ZNCC_EPS`` has the neutral cost 1."""
    n, s_l, s_ll, s_r, s_rr, s_lr = sums
    n_safe = torch.clamp_min(n, 1.0)
    cov = s_lr - s_l * s_r / n_safe
    var_l = torch.clamp_min(s_ll - s_l * s_l / n_safe, 0.0)
    var_r = torch.clamp_min(s_rr - s_r * s_r / n_safe, 0.0)
    denom = sqrt_f32(var_l * var_r)
    ncc = torch.where(denom > ZNCC_EPS,
                      cov / torch.clamp_min(denom, ZNCC_EPS),
                      torch.zeros((), device=denom.device))
    cost = 1.0 - ncc
    return torch.where(valid, cost.to(cost_dtype),
                       torch.tensor(float("inf"), dtype=cost_dtype,
                                    device=cost.device))


def image_sum(img: torch.Tensor) -> torch.Tensor:
    """Sum of an [H, W] image in a fixed association: per-row sums, then
    the sum of the [H] vector, each by ``pairwise_sum_last``.  A row
    band's row sums are the whole image's, so the row-sharded path
    reproduces this scalar bit for bit from its tiles' row sums."""
    return pairwise_sum_last(pairwise_sum_last(img.to(torch.float32)))


def stable_image_mean(img: torch.Tensor) -> torch.Tensor:
    """Global mean with the association of :func:`image_sum`, over
    H * W: the JAX package's ``stable_image_mean`` called on its own."""
    return image_sum(img) / (img.shape[0] * img.shape[1])


def _cumsum_pads(width: int) -> bool:
    """Whether XLA's CPU cumsum over ``width`` columns pads the axis to
    its blocks of 16 (``utils.numeric.prefix_sum_w``): a width above one
    block and not a multiple of it."""
    return width > 16 and width % 16 != 0


def _centred(img: torch.Tensor, total: torch.Tensor, size: int, *,
             fused: bool) -> torch.Tensor:
    """``img`` minus its mean ``total / size`` as XLA's CPU backend
    computes it inside the jitted ZNCC: the division by the constant
    size becomes a product with its float32 reciprocal, and where the
    subtraction shares a fusion with the padding of a cumulative sum
    (``fused``, :func:`_cumsum_pads`: the prefix planes' input), that
    product feeds the subtraction as one fused multiply-add.  Measured
    against the JAX package on the CPU at widths 9-1280."""
    recip = torch.tensor(float(np.float32(1) / np.float32(size)),
                         dtype=torch.float32, device=img.device)
    total = total.to(img.device)
    if fused:
        return fma(-total, recip, img)
    return img - total * recip


def _rowboxed_prefix(img: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """[H, W+1] row-box-summed column prefix of a plane: RBS[r, j] = the
    sum over the window rows [r-k, r+k) of the plane's columns x < j, so
    a window's column sum over [a, b) is RBS[r, b] - RBS[r, a]."""
    prefix = torch.cat([img.new_zeros((img.shape[0], 1)), prefix_sum_w(img)],
                       dim=1)
    return _box_sum(prefix, kernel_size, axes=(0,))


def _window_ends(plane: torch.Tensor, kernel_size: int):
    """(upper, lower) per-column reads of an [H, W+1] plane:
    upper[., c] = plane[., min(c+k, W)], lower[., c] = plane[., max(c-k,
    0)]."""
    width = plane.shape[-1] - 1
    c = torch.arange(width, device=plane.device)
    return (plane[..., (c + kernel_size).clamp(max=width)],
            plane[..., (c - kernel_size).clamp(min=0)])


def _zncc_prefix_volume(left: tuple, right: tuple,
                        rows_n: torch.Tensor, *, max_disparity: int,
                        kernel_size: int, disparity_offset: int,
                        cost_dtype: torch.dtype) -> torch.Tensor:
    """The prefix-plane ZNCC of centred images with ``rows_n`` [H] window
    rows a row.  ``left`` and ``right`` are pairs of [H, W] float32
    planes, rows outside the image zero: the image centred for the prefix
    planes and the image centred for the sum_LR product
    (:func:`_centred`).

    Of the six window statistics only sum_LR couples both images per
    disparity and takes a volume box pass; sum_L and sum_L2 are prefix
    differences of the row-boxed left planes (the window's left end
    max(c-k, d) reads the column plane or the disparity plane), sum_R
    and sum_R2 the same planes of the right image read at shifted
    columns (a negative column reads 0, the clip), and the count is
    rows x columns, exact small integers."""
    k, d, off = kernel_size, max_disparity, disparity_offset
    (left_p, left_c), (right_p, right_c) = left, right
    height, width = left_c.shape
    dev = left_c.device
    w_idx = torch.arange(width, device=dev)[:, None]
    delta = torch.arange(d, device=dev)[None, :] + off
    valid = (w_idx >= delta)[None]
    cols_n = torch.clamp_min((w_idx + k).clamp(max=width)
                             - torch.maximum(w_idx - k, delta), 0
                             ).to(torch.float32)
    n = rows_n[:, None, None] * cols_n[None]

    cmask = ((w_idx - k) >= delta)[None]

    def left_stat(img):
        rbs = _rowboxed_prefix(img, k)                       # [H, W+1]
        upper, lower = _window_ends(rbs, k)
        at_d = rbs[:, off:off + d]                           # [H, D]
        return upper[:, :, None] - torch.where(cmask, lower[:, :, None],
                                               at_d[:, None, :])

    def right_stat(img):
        rbs = _rowboxed_prefix(img, k)
        g = shifted_right_stack(rbs, d, off)                 # [H, W+1, D]
        c = torch.arange(width, device=dev)
        upper = g[:, (c + k).clamp(max=width)]
        lower = torch.where((c >= k)[None, :, None],
                            g[:, (c - k).clamp(min=0)],
                            torch.zeros((), device=dev))
        return upper - lower

    s_l = left_stat(left_p)
    s_ll = left_stat(left_p * left_p)
    s_r = right_stat(right_p)
    s_rr = right_stat(right_p * right_p)
    shifted = shifted_right_stack(right_c, d, off)
    s_lr = _box_sum(left_c[:, :, None] * shifted, k, axes=(0, 1))
    return _zncc_combine((n, s_l, s_ll, s_r, s_rr, s_lr), valid,
                         cost_dtype)


def _check_float(cost_dtype: torch.dtype) -> None:
    if not cost_dtype.is_floating_point:
        raise ValueError("zncc cost requires a float cost_dtype "
                         f"(got {cost_dtype})")


def zncc_cost_volume(left: torch.Tensor, right: torch.Tensor, *,
                     max_disparity: int, kernel_size: int = 7,
                     cost_dtype: torch.dtype = torch.float32,
                     disparity_offset: int = 0) -> torch.Tensor:
    """Zero-mean normalised cross-correlation cost volume [H, W, D]:
    ``1 - zncc`` over the SSD window (clipped [i-k, i+k) rows, columns
    [max(c-k, d), min(c+k, W))), +inf where d + offset > c.  Computes
    float32 and casts once to ``cost_dtype`` (float32 or bfloat16).

    Both images are centred by their global means first (the sums of
    :func:`image_sum`, centred as XLA compiles it: :func:`_centred`); the
    prefix-plane formulation (:func:`_zncc_prefix_volume`) follows.
    Widths with W <= k, or a disparity range past the [H, W+1] prefix
    plane, take the stacked formulation of the six statistics, as the
    JAX package does."""
    _check_float(cost_dtype)
    k = kernel_size
    height, width = left.shape
    left_f = left.to(torch.float32)
    right_f = right.to(torch.float32)
    if width <= k or width + 1 < disparity_offset + max_disparity:
        shifted = shifted_right_stack(right_f, max_disparity,
                                      disparity_offset)
        valid = _valid_wedge(width, max_disparity, disparity_offset,
                             left.device)
        sums = _box_sum(_zncc_stack(left_f, shifted, valid), k, axes=(1, 2))
        return _zncc_combine(sums, valid, cost_dtype)
    size, fused = height * width, _cumsum_pads(width)
    pairs = [tuple(_centred(img, image_sum(img), size, fused=f)
                   for f in (fused, False)) for img in (left_f, right_f)]
    r_idx = torch.arange(height, device=left.device)
    rows_n = (torch.clamp_max(r_idx + k, height)
              - torch.clamp_min(r_idx - k, 0)).to(torch.float32)
    return _zncc_prefix_volume(*pairs, rows_n,
                               max_disparity=max_disparity, kernel_size=k,
                               disparity_offset=disparity_offset,
                               cost_dtype=cost_dtype)


def zncc_cost_from_padded(left_padded: torch.Tensor,
                          right_padded: torch.Tensor, *,
                          pad_before: int, pad_after: int,
                          max_disparity: int, kernel_size: int = 7,
                          row_valid: torch.Tensor,
                          left_total: torch.Tensor,
                          right_total: torch.Tensor, image_size: int,
                          cost_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """ZNCC of a row band carrying ``pad_before``/``pad_after`` halo rows,
    cropped to the band: [Hp - pad_before - pad_after, W, D].

    With (k, k-1) halos it equals the band's rows of
    :func:`zncc_cost_volume` bit for bit, given what the band cannot
    see: the whole images' :func:`image_sum` (``left_total``,
    ``right_total``) and pixel count (``image_size``), from which both
    centre as the whole image does, and ``row_valid`` ([Hp] bool, True
    for rows inside the image), so that rows outside the image are zero
    after centring and stay out of the window count.  Every cross-row sum is then the
    same window of the same values in the same order as on the whole
    image.  (The JAX package's counterpart takes the means; the port
    takes the sums, because the centring XLA compiles depends on the sum
    and the size, see :func:`_centred`.)
    """
    _check_float(cost_dtype)
    k = kernel_size
    if pad_before > k or pad_after > k - 1:
        raise ValueError("halos wider than the window change the semantics")
    hp, width = left_padded.shape
    height = hp - pad_before - pad_after
    if width <= k or width + 1 < max_disparity:
        raise ValueError(
            f"zncc_cost_from_padded needs width > kernel_size and "
            f"max_disparity <= width + 1 (got W={width}, k={k}, "
            f"D={max_disparity})")
    dev = left_padded.device
    left_f = left_padded.to(torch.float32)
    right_f = right_padded.to(torch.float32)
    real = row_valid.to(device=dev, dtype=torch.bool)
    rows_real = real.to(torch.float32)
    zero = torch.zeros((), device=dev)
    pairs = [tuple(torch.where(real[:, None],
                               _centred(img, total, image_size, fused=f),
                               zero)
                   for f in (_cumsum_pads(width), False))
             for img, total in ((left_f, left_total),
                                (right_f, right_total))]
    rows_n = _box_sum(rows_real, k, axes=(0,))
    cost = _zncc_prefix_volume(*pairs, rows_n, max_disparity=max_disparity,
                               kernel_size=k, disparity_offset=0,
                               cost_dtype=cost_dtype)
    return cost[pad_before:pad_before + height]


# --------------------------------------------------------------------------
# SSD over textures
# --------------------------------------------------------------------------

def texture_grids(left_texture, right_texture):
    """The two images an SSD over textures compares: each texture sampled
    at every integer pixel centre (``TextureImage.sample_grid``), float32.
    Normalised coordinates are refused, as the reference refuses them."""
    from ..texture import TextureImage

    if not (isinstance(left_texture, TextureImage)
            and isinstance(right_texture, TextureImage)):
        raise TypeError("SSDTexture expects TextureImage inputs")
    if (left_texture.use_normalized_coords
            or right_texture.use_normalized_coords):
        raise RuntimeError(
            "Texture coordinates can't be normalized for this implementation")
    return left_texture.sample_grid(), right_texture.sample_grid()
