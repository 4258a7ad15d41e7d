"""Disparity to metric depth and 3-D point clouds, the counterpart of
``stereomatch_tpu/reconstruction.py``.

Middlebury calibration conventions (calib.txt ``cam0``, ``baseline``,
``doffs``):

    Z = baseline * focal / (disparity + doffs)

Pixels whose raw disparity is not positive and finite (0 is the unknown
marker), or whose disparity + doffs is not positive, are invalid: depth
0, and no point in the PLY.  The maps are float32 PyTorch on the
disparity's device, with every scalar in float32 as the JAX package's
are; the PLY writer and reader are host-side numpy.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .pipeline import as_tensor, host_array


class CameraIntrinsics:
    """Pinhole intrinsics of the rectified left camera plus stereo geometry.

    Attributes:
        focal: focal length in pixels (fx == fy after rectification).
        cx, cy: principal point in pixels.
        baseline: stereo baseline (any length unit; depth comes out in it).
        doffs: x-principal-point difference cx1 - cx0 added to disparities.
    """

    def __init__(self, focal: float, cx: float, cy: float,
                 baseline: float, doffs: float = 0.0):
        self.focal = float(focal)
        self.cx = float(cx)
        self.cy = float(cy)
        self.baseline = float(baseline)
        self.doffs = float(doffs)

    @classmethod
    def from_middlebury_calib(cls, path) -> "CameraIntrinsics":
        """Read cam0/baseline/doffs from a Middlebury calib.txt, whose
        matrix line looks like ``cam0=[f 0 cx; 0 f cy; 0 0 1]``."""
        props: Dict[str, str] = {}
        with open(path, "r", encoding="ascii") as f:
            for line in f:
                if "=" in line:
                    name, value = line.split("=", 1)
                    props[name.strip()] = value.strip()
        if "cam0" not in props:
            raise ValueError(f"{path}: no cam0 matrix in calib file")
        nums = [float(v) for v in re.findall(r"[-+0-9.eE]+", props["cam0"])]
        if len(nums) != 9:
            raise ValueError(f"{path}: cam0 is not a 3x3 matrix: "
                             f"{props['cam0']!r}")
        focal, cx, cy = nums[0], nums[2], nums[5]
        return cls(focal=focal, cx=cx, cy=cy,
                   baseline=float(props.get("baseline", 1.0)),
                   doffs=float(props.get("doffs", 0.0)))

    def __repr__(self) -> str:
        return (f"CameraIntrinsics(focal={self.focal}, cx={self.cx}, "
                f"cy={self.cy}, baseline={self.baseline}, "
                f"doffs={self.doffs})")


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def _depth_map(raw: torch.Tensor, intrinsics: CameraIntrinsics):
    dev = raw.device
    raw = raw.to(torch.float32)
    disp = raw + _f32(intrinsics.doffs, dev)
    valid = torch.isfinite(raw) & (raw > 0) & (disp > 0)
    depth = (_f32(intrinsics.focal, dev) * _f32(intrinsics.baseline, dev)
             / disp.clamp_min(1e-12))
    return torch.where(valid, depth, 0.0)


def depth_from_disparity(disparity,
                         intrinsics: CameraIntrinsics) -> torch.Tensor:
    """[H, W] float32 metric depth (baseline units); invalid disparities
    give 0.  Integer or float disparities, numpy or tensors."""
    return _depth_map(as_tensor(disparity), intrinsics)


def reproject_disparity(disparity,
                        intrinsics: CameraIntrinsics) -> torch.Tensor:
    """[H, W, 3] camera-frame points (x right, y down, z forward); invalid
    pixels come back as the origin with z == 0."""
    disparity = as_tensor(disparity)
    depth = _depth_map(disparity, intrinsics)
    height, width = disparity.shape
    dev = depth.device
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32,
                                         device=dev),
                            torch.arange(width, dtype=torch.float32,
                                         device=dev), indexing="ij")
    focal = _f32(intrinsics.focal, dev)
    x3 = (xs - _f32(intrinsics.cx, dev)) * depth / focal
    y3 = (ys - _f32(intrinsics.cy, dev)) * depth / focal
    return torch.stack([x3, y3, depth], dim=-1)


def write_ply(path, points, colors=None, mask=None,
              max_depth: Optional[float] = None) -> int:
    """Write a binary little-endian PLY point cloud; returns the number of
    points written.

    Args:
        path: output file.
        points: [..., 3] float points (from :func:`reproject_disparity`).
        colors: optional [..., 3] uint8 or [...] grayscale values matching
            the leading shape of ``points``.
        mask: optional boolean keep-mask over the leading shape, on top
            of the validity filter (z > 0, finite).
        max_depth: optional far-plane cut.
    """
    points = host_array(points).astype(np.float32)
    lead_shape = points.shape[:-1]
    pts = points.reshape(-1, 3)
    keep = np.isfinite(pts).all(axis=1) & (pts[:, 2] > 0)
    if max_depth is not None:
        keep &= pts[:, 2] <= max_depth
    if mask is not None:
        keep &= host_array(mask).astype(bool).reshape(-1)
    pts = pts[keep]

    rgb = None
    if colors is not None:
        rgb = host_array(colors)
        if rgb.shape == lead_shape:                       # grayscale
            rgb = np.repeat(rgb.reshape(-1, 1), 3, axis=1)
        elif rgb.shape == lead_shape + (3,):
            rgb = rgb.reshape(-1, 3)
        else:
            raise ValueError(f"colors shape {rgb.shape} does not match "
                             f"points {lead_shape}")
        if rgb.dtype != np.uint8:
            scale = 255.0 if float(rgb.max(initial=0.0)) <= 1.0 else 1.0
            rgb = np.clip(rgb * scale, 0, 255).astype(np.uint8)
        rgb = rgb[keep]

    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if rgb is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.empty(pts.shape[0], dtype=fields)
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    if rgb is not None:
        rec["red"], rec["green"], rec["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {pts.shape[0]}",
              "property float x", "property float y", "property float z"]
    if rgb is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())
    return int(pts.shape[0])


def read_ply(path) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read back a PLY written by :func:`write_ply`: (points [N, 3]
    float32, colours [N, 3] uint8 or None)."""
    with open(path, "rb") as f:
        lines = []
        while True:
            line = f.readline().decode("ascii").strip()
            lines.append(line)
            if line == "end_header":
                break
        n = int(next(line for line in lines
                     if line.startswith("element vertex")).split()[-1])
        has_rgb = "property uchar red" in lines
        fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
        if has_rgb:
            fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        rec = np.frombuffer(f.read(), dtype=fields, count=n)
    pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=1)
    rgb = (np.stack([rec["red"], rec["green"], rec["blue"]], axis=1)
           if has_rgb else None)
    return pts, rgb
