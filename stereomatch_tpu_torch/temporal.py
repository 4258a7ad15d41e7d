"""Temporal disparity tracking for stereo video, the counterpart of
``stereomatch_tpu/temporal.py``: per-frame census band refinement
anchored on the previous frame's disparity, with keyframes on a fixed
cadence and whenever the anchor drifts.

Between frames almost every pixel moves by far less than the search
range, so a tracked frame re-scores only ``2r + 1`` census candidates
around frame t-1's disparity (``pyramid.band_refine_census``): no cost
aggregation, two census transforms and the band's minimum.  The failure
signal is the winning Hamming distance: when the anchor is stale (a
scene cut, motion past the band) the best candidate in the band is no
better than random bits, and the fraction of poor winners jumps.

The drift decision needs that fraction on the host, one read a tracked
frame.  On the card the disparity's copy to pinned host memory starts
beside it (``copy_to_host_async`` in the JAX package), so the read waits
for one transfer window, not two, and :meth:`TemporalPipeline.host_disparity`
hands the landed copy out.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops.refine import median_filter_3x3
from .pipeline import Device, Image, as_tensor
from .pyramid import band_refine_census
from .utils import validation


def poor_counts(best_cost: torch.Tensor, poor_bits: int) -> torch.Tensor:
    """[poor, scorable] pixel counts as float32: the scorable pixels are
    those with x > 0 (column 0 has no candidate), the poor ones those
    whose band winner has at least ``poor_bits`` differing census bits.
    Integers below 2^24, so tiles' counts sum exactly in any order."""
    x = torch.arange(best_cost.shape[-1], device=best_cost.device)
    scorable = (x > 0).expand(best_cost.shape)
    poor = (best_cost >= poor_bits) & scorable
    return torch.stack([poor.sum(), scorable.sum()]).to(torch.float32)


def poor_fraction(counts: torch.Tensor) -> torch.Tensor:
    """The drift statistic from :func:`poor_counts`: float32 counts
    divided, as the JAX package divides its int32 sums."""
    return counts[0] / counts[1].clamp(min=1.0)


class TemporalPipeline:
    """Stateful video estimator: keyframe pipeline plus band tracking.

    ``estimate(left, right)`` carries state between calls: the first
    frame, every ``keyframe_interval``-th, any frame of another geometry
    and any frame whose drift statistic exceeds ``drift_threshold`` run
    the full ``keyframe`` pipeline; every other frame re-scores ``2 *
    band_radius + 1`` census candidates around the previous disparity.

    Args:
      max_disparity: full search range.
      keyframe: any object with ``estimate(left, right)``; default the
        full-resolution census + SGM + WTA (``create_pipeline``), or with
        a ``mesh`` the equivalent ``parallel.ShardedPipeline``.
      band_radius: tracked-frame search half-width.
      keyframe_interval: hard keyframe cadence (0: drift only).
      drift_threshold: keyframe when this fraction of pixels wins its
        band with >= ``poor_bits`` differing census bits.
      poor_bits: default (window_size**2 - 1) // 3, 8 for the 5x5 window.
      median: 3x3-median the tracked disparity.
      penalty1/penalty2/backend: the default keyframe's SGM.
      mesh: optional (batch, tile) ``parallel.Mesh``: independent streams
        over the batch axis ([B, H, W] stacks in and out), image rows over
        the tile axis (``parallel/temporal_sharded.py``).  The keyframe
        schedule is shared: a drift keyframe fires when any stream's poor
        fraction exceeds the threshold.  One process's mesh: a mesh over
        several raises NotImplementedError.
      device: where a frame runs without a mesh: the card unless
        ``"cpu"`` is asked for.
    """

    def __init__(self, max_disparity: int, *,
                 keyframe=None,
                 band_radius: int = 6,
                 window_size: int = 5,
                 keyframe_interval: int = 16,
                 drift_threshold: float = 0.06,
                 poor_bits: Optional[int] = None,
                 median: bool = True,
                 penalty1: float = 0.1, penalty2: float = 0.2,
                 backend: str = "auto",
                 mesh=None,
                 device: Device = "cuda"):
        if band_radius < 1:
            raise ValueError("band_radius must be >= 1")
        if not 0.0 < drift_threshold <= 1.0:
            raise ValueError("drift_threshold must be in (0, 1]")
        self.max_disparity = max_disparity
        self.band_radius = band_radius
        self.window_size = window_size
        self.keyframe_interval = keyframe_interval
        self.drift_threshold = drift_threshold
        n_neighbour_bits = window_size * window_size - 1
        self.poor_bits = (poor_bits if poor_bits is not None
                          else max(n_neighbour_bits // 3, 1))
        self.median = median
        self.mesh = mesh
        self.device = device
        if mesh is not None and mesh.spans_processes:
            raise NotImplementedError(
                "TemporalPipeline over a mesh of several processes: its "
                "keyframe decision reads every stream's drift fraction on "
                "this host each frame (the JAX package's TemporalPipeline "
                "fetches it with np.asarray, which refuses an array "
                "spanning another process's devices); call "
                "parallel.make_temporal_track_sharded, which returns each "
                "process's shards, or give each process its own mesh")
        if keyframe is None:
            if mesh is not None:
                from .parallel import ShardedPipeline
                keyframe = ShardedPipeline(
                    mesh, max_disparity, cost="census", aggregation="sgm",
                    reducer="wta", penalty1=penalty1, penalty2=penalty2,
                    backend=backend)
            else:
                from .cli_common import create_pipeline
                keyframe = create_pipeline(
                    "census", "wta", "sgm", max_disparity=max_disparity,
                    penalty1=penalty1, penalty2=penalty2, backend=backend,
                    device=device)
        self.keyframe = keyframe
        if mesh is not None:
            from .parallel.temporal_sharded import make_temporal_track_sharded
            self._track_fn = make_temporal_track_sharded(
                mesh, max_disparity=max_disparity, band_radius=band_radius,
                window_size=window_size, poor_bits=self.poor_bits,
                median=median)
        else:
            self._track_fn = self._track
        self.reset()

    def reset(self) -> None:
        """Drop tracking state; the next frame is a keyframe."""
        self._prev = None
        self._host = None
        self._squeeze = False
        self._frame_index = 0
        self.keyframes = 0
        self.drift_keyframes = 0

    def _track(self, left, right, prev):
        disp, best_cost = band_refine_census(
            left.to(torch.float32), right.to(torch.float32), prev,
            band_radius=self.band_radius, max_disparity=self.max_disparity,
            window_size=self.window_size, return_best_cost=True)
        if self.median:
            disp = median_filter_3x3(disp)
        return disp, poor_fraction(poor_counts(best_cost, self.poor_bits))

    def _inputs(self, left_image, right_image):
        if self.mesh is None:
            left = as_tensor(left_image, self.device)
            right = as_tensor(right_image, self.device)
            validation.check_stereo_pair(left, right)
            return left, right, False
        from .parallel.mesh import BATCH_AXIS
        from .parallel.sharded import _as_frames
        left, right = _as_frames(left_image), _as_frames(right_image)
        squeeze = left.ndim == 2
        if squeeze:
            # One stream: rows shard over the tile axis, under a batch
            # axis of 1.
            if self.mesh.shape[BATCH_AXIS] != 1:
                raise ValueError(
                    "2-D frames in mesh mode need a batch axis of 1 (got "
                    f"{self.mesh.shape[BATCH_AXIS]}); pass [B, H, W] stacks "
                    "to use batch parallelism")
            left, right = left[None], right[None]
        if left.ndim != 3 or left.shape != right.shape:
            raise ValueError("mesh mode takes matching [B, H, W] stacks")
        return left, right, squeeze

    def _to_host(self, disp, poor_frac):
        """Both results' copies to the host, started together (pinned
        memory on the card); returns the poor fractions as numpy, having
        waited for both."""
        if not disp.is_cuda:
            self._host = disp
            return poor_frac.numpy()
        host = torch.empty(disp.shape, dtype=disp.dtype, pin_memory=True)
        frac = torch.empty(poor_frac.shape, dtype=poor_frac.dtype,
                           pin_memory=True)
        host.copy_(disp, non_blocking=True)
        frac.copy_(poor_frac, non_blocking=True)
        torch.cuda.current_stream(disp.device).synchronize()
        self._host = host
        return frac.numpy()

    def estimate(self, left_image: Image, right_image: Image) -> torch.Tensor:
        """The next frame's disparity: [H, W] int32 on the pipeline's
        device ([B, H, W] on the mesh's first device in mesh mode)."""
        left, right, squeeze = self._inputs(left_image, right_image)
        due = (self._prev is None
               or (self.keyframe_interval > 0
                   and self._frame_index % self.keyframe_interval == 0))
        if not due and tuple(self._prev.shape) != tuple(left.shape):
            due = True                     # geometry changed mid-stream
        if not due:
            disp, poor_frac = self._track_fn(left, right, self._prev)
            if float(np.max(self._to_host(disp, poor_frac))) \
                    > self.drift_threshold:
                self.drift_keyframes += 1
                due = True
        if due:
            disp = self.keyframe.estimate(left, right)
            self._host = None
            self.keyframes += 1

        self._prev = disp
        self._squeeze = squeeze
        self._frame_index += 1
        return disp[0] if squeeze else disp

    def host_disparity(self) -> torch.Tensor:
        """The last frame's disparity on the host, as ``estimate``
        returned it: a tracked frame's copy has landed already (it
        travelled beside the drift statistic); a keyframe's is copied
        now."""
        if self._prev is None:
            raise RuntimeError("run estimate() before host_disparity()")
        if self._host is None:
            self._host = self._prev.cpu()
        return self._host[0] if self._squeeze else self._host
