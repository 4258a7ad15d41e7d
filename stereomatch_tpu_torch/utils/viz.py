"""Visualization helpers for disparity maps, a copy of
``stereomatch_tpu/utils/viz.py`` that needs neither matplotlib nor PIL.

The colormap is matplotlib's ``"rainbow"`` rebuilt from its definition:
a ``LinearSegmentedColormap`` of N = 256 entries whose red, green and
blue are |2x - 0.5|, sin(pi x) and cos(pi x / 2) at x = linspace(0, 1,
256), clipped to [0, 1], looked up as ``Colormap.__call__`` does (x * N,
truncated, N - 1 at x = 1, NaN to the transparent-black "bad" colour).
``colorize_disparity`` then scales by 255 and truncates to uint8, so it
gives matplotlib's colours exactly.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_N = 256


def _rainbow_lut() -> np.ndarray:
    """[N, 3] float64 RGB of matplotlib's "rainbow" (``_cm.py``'s
    gnuplot functions 33, 13 and 10)."""
    x = np.linspace(0, 1, _N)
    lut = np.stack([np.abs(2 * x - 0.5), np.sin(x * np.pi),
                    np.cos(x * np.pi / 2)], axis=1)
    return np.clip(lut, 0, 1)


def normalize_disparity(disparity: np.ndarray,
                        max_disparity: int = None) -> np.ndarray:
    """Scale a disparity image to [0, 1] float32."""
    disparity = np.asarray(disparity, np.float32)
    if max_disparity is None:
        max_disparity = max(float(disparity.max()), 1.0)
    return np.clip(disparity / float(max_disparity), 0.0, 1.0)


def colorize_disparity(disparity: np.ndarray,
                       max_disparity: int = None,
                       cmap: str = "rainbow") -> np.ndarray:
    """Disparity -> RGB uint8 through the colormap ``cmap`` (only
    "rainbow", the one the CLIs use)."""
    if cmap != "rainbow":
        raise ValueError(f"unknown colormap {cmap!r}; the port has "
                         f"'rainbow' only")
    lut = _rainbow_lut()
    xa = normalize_disparity(disparity, max_disparity) * np.float32(_N)
    xa[xa == _N] = _N - 1
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        index = xa.astype(int)
    index[bad] = 0
    rgb = lut[np.clip(index, 0, _N - 1)]
    rgb[bad] = 0.0
    return (rgb * 255).astype(np.uint8)


def save_depthmap(disparity, path, max_disparity: int = None) -> Path:
    """Save a disparity image as a colorized PNG; returns the path written."""
    from ..io import png
    path = Path(path)
    if path.suffix.lower() != ".png":
        path = path.with_suffix(".png")
    path.parent.mkdir(parents=True, exist_ok=True)
    return png.write(path, colorize_disparity(np.asarray(disparity),
                                              max_disparity))
