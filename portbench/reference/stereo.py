"""SSD and census costs, 8-path SGM with the adaptive P2, and WTA.

Every function takes a batch: images [B, H, W] (float32 intensities,
here 8-bit levels) and volumes [B, H, W, D] float32, on any device.

* SSD (upstream ``src/ssd.cu``): for d <= x the sum of
  (L[r, c] - R[r, c - d])^2 over the half-open window rows [y-k, y+k),
  columns [max(x-k, d), x+k), clipped to the image; +inf where d > x.
  From 8-bit images every term and sum is an integer below 2^24, so the
  sums are taken exactly in int64 and cast to float32 without rounding.
* Census (Zabih and Woodfill): a bit for each neighbour of a square
  window that is darker than the centre, neighbours outside the image
  reading 0; the cost is the Hamming distance between the codes of
  L[y, x] and R[y, x - d], +inf where d > x.
* SGM (Hirschmuller 2005, upstream ``src/semiglobal.cpp:137-152``),
  each path in its normalised form
      n = L(p - r) - min_d L(p - r)
      L(p, d) = C(p, d) + min(n[d], n[d-1] + P1, n[d+1] + P1, P2')
      P2' = max(P1, P2 / |I(p) - I(p - r)|)        (|dI| = 0: +inf)
  with L = C where the path enters the image, and the eight paths
  summed in float32 in the order of ``PATHS``.
* WTA: the first disparity of least cost.
"""

from __future__ import annotations

from typing import Mapping

import torch

# The eight path directions r = (dy, dx) in the order they are summed.
PATHS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, -1), (1, -1),
         (-1, 1))

INF = float("inf")


def _window_sum(values: torch.Tensor, dim: int, k: int) -> torch.Tensor:
    """Exact sums of the half-open windows [i-k, i+k) along ``dim``,
    clipped to the axis, of an int64 tensor."""
    n = values.shape[dim]
    prefix = torch.cumsum(values, dim=dim)
    zero = torch.zeros_like(values.narrow(dim, 0, 1))
    prefix = torch.cat([zero, prefix], dim=dim)          # prefix[i] = sum[:i]
    idx = torch.arange(n, device=values.device)
    hi = (idx + k).clamp(max=n)
    lo = (idx - k).clamp(min=0)
    return prefix.index_select(dim, hi) - prefix.index_select(dim, lo)


def _valid(width: int, max_disparity: int, device) -> torch.Tensor:
    x = torch.arange(width, device=device)[:, None]
    d = torch.arange(max_disparity, device=device)[None, :]
    return x >= d                                        # [W, D]


def _shifted(right: torch.Tensor, max_disparity: int) -> torch.Tensor:
    """S[..., y, x, d] = right[..., y, x - d] (0 where x < d)."""
    width = right.shape[-1]
    src = (torch.arange(width, device=right.device)[:, None]
           - torch.arange(max_disparity, device=right.device)[None, :])
    gathered = right[..., src.clamp(min=0)]
    return torch.where(src >= 0, gathered, torch.zeros_like(gathered))


def ssd_volume(left: torch.Tensor, right: torch.Tensor, max_disparity: int,
               kernel_size: int) -> torch.Tensor:
    """[B, H, W, D] float32 SSD costs of 8-bit images (see the module)."""
    out = []
    valid = _valid(left.shape[-1], max_disparity, left.device)
    for l_img, r_img in zip(left, right):
        li = l_img.round().to(torch.int64)
        ri = r_img.round().to(torch.int64)
        diff = li[:, :, None] - _shifted(ri, max_disparity)
        term = torch.where(valid, diff * diff, torch.zeros_like(diff))
        box = _window_sum(_window_sum(term, 0, kernel_size), 1, kernel_size)
        if int(box.max()) >= 2 ** 24:
            raise ValueError("SSD sums past 2^24 are not exact in float32")
        out.append(torch.where(valid, box.to(torch.float32),
                               torch.full((), INF, device=left.device)))
    return torch.stack(out)


def census_codes(image: torch.Tensor, window: int) -> torch.Tensor:
    """[..., H, W] int64 census codes of a ``window`` x ``window`` square
    (at most 63 neighbours)."""
    half = window // 2
    if window % 2 == 0 or window * window - 1 > 63:
        raise ValueError(f"census window {window} is not odd or past 63 bits")
    height, width = image.shape[-2:]
    padded = torch.nn.functional.pad(image, (half, half, half, half))
    code = torch.zeros(image.shape, dtype=torch.int64, device=image.device)
    bit = 0
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            if dy == 0 and dx == 0:
                continue
            neighbour = padded[..., half + dy:half + dy + height,
                               half + dx:half + dx + width]
            code |= (neighbour < image).to(torch.int64) << bit
            bit += 1
    return code


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative int64 values below 2^63."""
    table = torch.tensor([bin(i).count("1") for i in range(256)],
                         dtype=torch.int64, device=x.device)
    count = torch.zeros_like(x)
    for byte in range(8):
        count += table[(x >> (8 * byte)) & 255]
    return count


def census_volume(left: torch.Tensor, right: torch.Tensor,
                  max_disparity: int, window: int) -> torch.Tensor:
    """[B, H, W, D] float32 Hamming costs of the census codes."""
    out = []
    valid = _valid(left.shape[-1], max_disparity, left.device)
    for l_img, r_img in zip(left, right):
        cl = census_codes(l_img, window)
        cr = _shifted(census_codes(r_img, window), max_disparity)
        ham = _popcount64(cl[:, :, None] ^ cr).to(torch.float32)
        out.append(torch.where(valid, ham,
                               torch.full((), INF, device=left.device)))
    return torch.stack(out)


def _path(cost: torch.Tensor, image: torch.Tensor, p1: torch.Tensor,
          p2: torch.Tensor, dy: int, dx: int,
          adaptive: bool = True) -> torch.Tensor:
    """L along direction (dy, dx) for a batch: [B, H, W, D] float32."""
    if dy == 0:
        # Scan along W; each step is a column [B, H, D].
        vol, img, step = cost.transpose(1, 2), image.transpose(1, 2), dx
        shift = 0
    else:
        vol, img, step = cost, image, dy
        shift = dx
    out = torch.empty_like(vol)
    n = vol.shape[2]                                      # lanes of a step
    lanes = torch.arange(n, device=vol.device)
    source = lanes - shift
    enters = ((source < 0) | (source >= n))[None, :, None]   # [1, N, 1]
    source = source.clamp(0, n - 1)
    inf_col = torch.full(vol.shape[:1] + (n, 1), INF, device=vol.device)
    order = range(vol.shape[1]) if step > 0 else range(vol.shape[1] - 1,
                                                       -1, -1)
    prev = prev_img = None
    for s in order:
        c = vol[:, s]                                     # [B, N, D]
        i = img[:, s]                                     # [B, N]
        if prev is None:
            cur = c
        else:
            before = prev[:, source]
            before_img = prev_img[:, source]
            n_prev = before - before.amin(dim=-1, keepdim=True)
            p2_adj = (torch.maximum(p1, p2 / (i - before_img).abs())
                      if adaptive else torch.maximum(p1, p2).expand_as(i))
            lower = torch.cat([inf_col, n_prev[..., :-1]], dim=-1)
            upper = torch.cat([n_prev[..., 1:], inf_col], dim=-1)
            band = torch.minimum(torch.minimum(n_prev, lower + p1),
                                 torch.minimum(upper + p1, p2_adj[..., None]))
            cur = torch.where(enters, c, c + band)
        out[:, s] = cur
        prev, prev_img = cur, i
    return out.transpose(1, 2) if dy == 0 else out


def semiglobal(cost: torch.Tensor, image: torch.Tensor, penalty1: float,
               penalty2: float, paths=PATHS,
               adaptive: bool = True) -> torch.Tensor:
    """The sum of the path costs, [B, H, W, D] float32.  ``paths`` and
    ``adaptive=False`` (P2' = max(P1, P2) everywhere) exist to plant
    faults; the reference itself is the default."""
    p1 = torch.full((), penalty1, dtype=torch.float32, device=cost.device)
    p2 = torch.full((), penalty2, dtype=torch.float32, device=cost.device)
    total = None
    for dy, dx in paths:
        path = _path(cost, image, p1, p2, dy, dx, adaptive)
        total = path if total is None else total + path
        del path
    return total


def winner_takes_all(volume: torch.Tensor) -> torch.Tensor:
    """[B, H, W] int32: the first disparity of least cost."""
    d = torch.arange(volume.shape[-1], device=volume.device)
    least = volume.amin(dim=-1, keepdim=True)
    first = torch.where(volume == least, d, volume.shape[-1])
    return first.amin(dim=-1).to(torch.int32)


# The ``estimator`` keys this reference models, with the values it
# takes where a key is left out; any other key is refused, since the
# reference would silently compute something else.
MODELLED = {"cost": "ssd", "kernel_size": None, "census_window": 5,
            "aggregation": "sgm", "penalty1": 0.1, "penalty2": 0.2,
            "reducer": "wta", "cost_dtype": "float32"}


def disparity(config: Mapping, left: torch.Tensor,
              right: torch.Tensor, **sgm) -> torch.Tensor:
    """[B, H, W] int32 disparities of a configuration's pipeline (its
    ``max_disparity`` and ``estimator`` options), from float32 images
    [B, H, W] of 8-bit levels.  Volumes are float32 whatever the
    configuration's ``cost_dtype``: the reference is the float32 chain.
    ``sgm`` goes to ``semiglobal`` (faults only)."""
    unknown = sorted(set(config["estimator"]) - set(MODELLED))
    if unknown:
        raise ValueError(f"the reference does not model {unknown}")
    opts = dict(MODELLED, **config["estimator"])
    d = int(config["max_disparity"])
    if opts["cost"] == "ssd":
        volume = ssd_volume(left, right, d, int(opts["kernel_size"] or 7))
    elif opts["cost"] == "census":
        if int(opts["kernel_size"] or 1) != 1:
            raise ValueError("the reference's census cost is pixelwise")
        volume = census_volume(left, right, d, int(opts["census_window"]))
    else:
        raise ValueError(f"no reference for cost {opts['cost']!r}")
    if opts["aggregation"] == "sgm":
        volume = semiglobal(volume, left, float(opts["penalty1"]),
                            float(opts["penalty2"]), **sgm)
    elif opts["aggregation"] is not None:
        raise ValueError(
            f"no reference for aggregation {opts['aggregation']!r}")
    if opts["reducer"] != "wta":
        raise ValueError(f"no reference for reducer {opts['reducer']!r}")
    return winner_takes_all(volume)
