"""A rectangular census, Hamming costs, 8-path SGM with either P2 form,
and WTA: the pipeline of KITTI census + SGM deployments (Hernandez-Juarez
et al., arXiv:1610.04121: a 9x7 census and SGM with constant penalties).

Every function takes a batch: images [B, H, W] (float32 intensities,
here 8-bit levels) and volumes [B, H, W, D] float32, on any device.

* Census (Zabih and Woodfill) over a window of ``height`` rows by
  ``width`` columns, both odd: a bit for each neighbour darker than the
  centre, neighbour k of the window in row-major order (rows top to
  bottom, each row left to right, the centre skipped) setting bit k of
  one int64 code; neighbours outside the image read 0.  At most 63
  neighbours (9 by 7: 62).
* Hamming: cost[y, x, d] = popcount(code_L[y, x] XOR code_R[y, x - d]),
  +inf where d > x.  Integers of at most 63, exact in float32.
* SGM: ``stereo.semiglobal``, Hirschmuller's eight normalised paths
  summed in float32 in ``stereo.PATHS`` order, with P2' = max(P1, P2 /
  |dI|) (``adaptive_p2`` true) or the constant P2' = max(P1, P2).
  With integer penalties every path cost and sum is an integer below
  2^24, so the float32 chain is exact.
* WTA: the first disparity of least cost.

Plain PyTorch in float32 and int64: no kernel of the program, no TF32.
"""

from __future__ import annotations

from typing import Mapping

import torch

from portbench.reference import stereo

# The ``estimator`` keys this reference models, with the values it takes
# where a key is left out; any other key is refused, since the reference
# would silently compute something else.
MODELLED = {"cost": "census", "census_window": 5, "census_height": None,
            "kernel_size": 1, "aggregation": "sgm", "adaptive_p2": True,
            "penalty1": 0.1, "penalty2": 0.2, "reducer": "wta",
            "cost_dtype": "float32"}


def census_codes(image: torch.Tensor, width: int,
                 height: int) -> torch.Tensor:
    """[..., H, W] int64 census codes of a ``height`` x ``width`` window
    (rows x columns)."""
    if width % 2 == 0 or height % 2 == 0 or width < 1 or height < 1:
        raise ValueError(f"census window {width}x{height} is not odd")
    if width * height - 1 > 63:
        raise ValueError(f"census window {width}x{height} is past 63 bits")
    half_w, half_h = width // 2, height // 2
    rows, cols = image.shape[-2:]
    padded = torch.nn.functional.pad(image, (half_w, half_w, half_h, half_h))
    code = torch.zeros(image.shape, dtype=torch.int64, device=image.device)
    bit = 0
    for dy in range(-half_h, half_h + 1):
        for dx in range(-half_w, half_w + 1):
            if dy == 0 and dx == 0:
                continue
            neighbour = padded[..., half_h + dy:half_h + dy + rows,
                               half_w + dx:half_w + dx + cols]
            code |= (neighbour < image).to(torch.int64) << bit
            bit += 1
    return code


def census_volume(left: torch.Tensor, right: torch.Tensor,
                  max_disparity: int, width: int,
                  height: int) -> torch.Tensor:
    """[B, H, W, D] float32 Hamming costs of the census codes."""
    out = []
    valid = stereo._valid(left.shape[-1], max_disparity, left.device)
    inf = torch.full((), stereo.INF, device=left.device)
    for l_img, r_img in zip(left, right):
        cl = census_codes(l_img, width, height)
        cr = stereo._shifted(census_codes(r_img, width, height),
                             max_disparity)
        ham = stereo._popcount64(cl[:, :, None] ^ cr).to(torch.float32)
        out.append(torch.where(valid, ham, inf))
        del cl, cr, ham
    return torch.stack(out)


def disparity(config: Mapping, left: torch.Tensor,
              right: torch.Tensor, **sgm) -> torch.Tensor:
    """[B, H, W] int32 disparities of a configuration's pipeline (its
    ``max_disparity`` and ``estimator`` options), from float32 images
    [B, H, W] of 8-bit levels.  Volumes are float32 whatever the
    configuration's ``cost_dtype``: the reference is the float32 chain.
    ``sgm`` goes to ``stereo.semiglobal`` (``paths``: faults only)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    unknown = sorted(set(config["estimator"]) - set(MODELLED))
    if unknown:
        raise ValueError(f"the reference does not model {unknown}")
    opts = dict(MODELLED, **config["estimator"])
    if opts["cost"] != "census":
        raise ValueError(f"no census reference for cost {opts['cost']!r}")
    if int(opts["kernel_size"] or 1) != 1:
        raise ValueError("the reference's census cost is pixelwise")
    if opts["reducer"] != "wta":
        raise ValueError(f"no reference for reducer {opts['reducer']!r}")
    width = int(opts["census_window"])
    height = width if opts["census_height"] is None \
        else int(opts["census_height"])
    volume = census_volume(left, right, int(config["max_disparity"]),
                           width, height)
    if opts["aggregation"] == "sgm":
        sgm.setdefault("adaptive", bool(opts["adaptive_p2"]))
        volume = stereo.semiglobal(volume, left, float(opts["penalty1"]),
                                   float(opts["penalty2"]), **sgm)
    elif opts["aggregation"] is not None:
        raise ValueError(
            f"no reference for aggregation {opts['aggregation']!r}")
    return stereo.winner_takes_all(volume)
