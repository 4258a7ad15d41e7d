"""Whether the window's answers are correct.

Each kept disparity (the sample of ``window.drive``) is compared with
the plain reference's disparity of the same uint8 frame, recomputed
from the pool on the device in blocks of frames.  The reference is the
one the configuration names (``registry.reference_disparity``).  Two
numbers are compared, each with its limit:

* ``mismatch_worst``: over the kept frames, the largest share of a
  frame's pixels whose disparity differs from the reference's; its
  limit is the configuration's ``limits.mismatch_worst``;
* ``frames_lost``: frames handed over and never yielded, or yielded out
  of order; limit 0.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, NamedTuple, Sequence

import numpy as np

from .scenes import Pair
from .window import Kept

BLOCK = 4


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def reference_disparities(torch, reference: Callable, config: Mapping,
                          pool: Sequence[Pair], indices: List[int],
                          device) -> Dict[int, np.ndarray]:
    """{pool index: int32 [H, W]} of the reference, in blocks."""
    out = {}
    for start in range(0, len(indices), BLOCK):
        block = indices[start:start + BLOCK]
        left = torch.stack([torch.from_numpy(pool[i].left) for i in block])
        right = torch.stack([torch.from_numpy(pool[i].right) for i in block])
        with torch.no_grad():
            disp = reference(
                config, left.to(device).to(torch.float32),
                right.to(device).to(torch.float32))
        for i, d in zip(block, disp.cpu().numpy()):
            out[i] = d
        del left, right, disp
    return out


def mismatch(answer: np.ndarray, expected: np.ndarray) -> float:
    """Share of pixels whose disparity differs (1 for a wrong shape)."""
    if answer.shape != expected.shape:
        return 1.0
    return float(np.count_nonzero(answer != expected)) / expected.size


class Verdict(NamedTuple):
    checks: List[Check]
    shares: List[float]   # each kept frame's mismatch
    failed: int           # frames lost, and kept frames over the limit


def judge(torch, reference: Callable, config: Mapping,
          pool: Sequence[Pair], kept: List[Kept], handed: int, yielded: int,
          misplaced: int, device) -> Verdict:
    refs = reference_disparities(
        torch, reference, config, pool,
        sorted({k.index % len(pool) for k in kept}),
        device)
    shares = [mismatch(k.disparity, refs[k.index % len(pool)]) for k in kept]
    limit = float(config["limits"]["mismatch_worst"])
    lost = handed - yielded + misplaced
    checks = [Check("mismatch_worst", max(shares) if shares else 1.0, limit),
              Check("frames_lost", float(lost), 0.0)]
    return Verdict(checks, shares,
                   lost + sum(share > limit for share in shares))
