"""Cost-volume construction, plain PyTorch versions.

Port of ``stereomatch_tpu/ops/cost.py`` (``shifted_right_stack``,
``_box_sum``, ``_diff_cost_volume``, ``ssd_cost_volume``,
``sad_cost_volume``, ``census_transform``,
``census_hamming_cost_volume``).  These run on any device.  The SSD/SAD
volumes are the oracle of the CUDA kernel in ``ops/ssd_cuda.py``;
``cost.SSD``/``cost.SAD`` choose between the two.  The census cost has
no kernel of its own (the JAX package computes it in XLA, with no Pallas
kernel), so it runs as plain PyTorch on the card too.

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

import torch


def _inf_value(dtype: torch.dtype):
    """+inf for float dtypes, the max value for integer dtypes."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def compute_dtype(cost_dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype of the window sums for a cost dtype."""
    return torch.float32 if cost_dtype.is_floating_point else torch.int32


def shifted_right_stack(right: torch.Tensor,
                        max_disparity: int) -> torch.Tensor:
    """S[h, w, d] = right[h, w - d], zero where w - d < 0."""
    width = right.shape[1]
    w_idx = torch.arange(width, device=right.device)[:, None]
    d_idx = torch.arange(max_disparity, device=right.device)[None, :]
    src = w_idx - d_idx
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
