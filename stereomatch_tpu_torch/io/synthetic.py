"""Procedural stereo scenes with exact ground truth.

The reference evaluates on downloaded Middlebury data only; these
generators make evaluation possible with zero network access — including
physically-modeled occlusions, the property that makes real stereo data
hard.  They double as the test suite's fixtures (tests/conftest.py) and
back ``stm-eval --synthetic``.
"""

from __future__ import annotations

import numpy as np


def smooth_texture(rng, height: int, width: int) -> np.ndarray:
    """Smooth but feature-rich random texture in [0, 1]."""
    noise = rng.standard_normal((height, width)).astype(np.float32)
    texture = noise.copy()
    for _ in range(3):
        texture = (texture
                   + np.roll(texture, 1, 0) + np.roll(texture, -1, 0)
                   + np.roll(texture, 1, 1) + np.roll(texture, -1, 1)) / 5.0
    texture += 0.15 * noise  # keep high-frequency detail for matching
    texture -= texture.min()
    texture /= max(texture.max(), 1e-6)
    return texture


def patterned_texture(rng, height: int, width: int,
                      base: float = 0.5) -> np.ndarray:
    """Piecewise-smooth, real-image-like surface texture in [0, 1].

    Unlike :func:`smooth_texture` (smoothed noise — featureful for
    matching but edge-free for guidance), this models what guide-aware
    stages (CVF/WMF/FGS) actually exploit in real imagery: a per-surface
    ``base`` intensity (so depth boundaries between surfaces coincide
    with intensity edges), a smooth illumination gradient, two crossed
    low-amplitude sinusoidal gratings (orientation biased off-vertical so
    intensity varies along the epipolar x axis — matchability), and
    low-amplitude high-frequency detail.  Interiors stay smooth at
    guide-affinity scale while remaining matchable.
    """
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    gx = float(rng.uniform(-0.15, 0.15))
    gy = float(rng.uniform(-0.15, 0.15))
    grad = gx * xx / max(width, 1) + gy * yy / max(height, 1)
    out = np.float32(base) + grad
    theta = float(rng.uniform(-0.6, 0.6))
    for dt in (0.0, np.pi / 2):
        freq = float(rng.uniform(0.25, 0.7))
        phase = float(rng.uniform(0, 2 * np.pi))
        out = out + np.float32(0.05) * np.sin(
            freq * (np.cos(theta + dt) * xx + np.sin(theta + dt) * yy)
            + phase).astype(np.float32)
    out = out + 0.025 * rng.standard_normal(
        (height, width)).astype(np.float32)
    return np.clip(out, 0.02, 0.98).astype(np.float32)


def _surface_levels(rng, n: int):
    """n well-separated base intensities in shuffled order, so every
    surface boundary is an intensity edge of >= ~0.2."""
    levels = np.linspace(0.12, 0.9, max(n, 2)).astype(np.float32)
    rng.shuffle(levels)
    return [float(v) for v in levels[:n]]


def stereo_pair(height: int, width: int, max_disparity: int, seed: int = 7):
    """Flat-warp scene: every left pixel has a perfect right match.

    Returns (left, right, gt_disparity) float32/float32/int32, with
    left[y, x] = right[y, x - gt[y, x]].  Good for anchoring matching
    accuracy; it cannot exercise occlusion handling (see
    :func:`stereo_pair_occluded`).
    """
    rng = np.random.default_rng(seed)
    texture = smooth_texture(rng, height, width + max_disparity)

    # Layered ground-truth disparity: background plane + boxes.
    gt = np.full((height, width), max(max_disparity // 8, 1), np.int32)
    for _ in range(4):
        h0 = int(rng.integers(0, max(height - 8, 1)))
        w0 = int(rng.integers(0, max(width - 8, 1)))
        bh = int(rng.integers(height // 6 + 1, height // 2 + 2))
        bw = int(rng.integers(width // 6 + 1, width // 2 + 2))
        d = int(rng.integers(1, max_disparity - 1))
        gt[h0:h0 + bh, w0:w0 + bw] = d

    # Guarantee d <= x validity near the left edge.
    xs = np.arange(width)[None, :]
    gt = np.minimum(gt, np.maximum(xs, 0)).astype(np.int32)

    right = texture[:, max_disparity:].astype(np.float32)
    xr = xs - gt
    left = np.take_along_axis(texture[:, max_disparity:], xr, axis=1)
    return left.astype(np.float32), right.astype(np.float32), gt


def stereo_pair_occluded(height: int, width: int, max_disparity: int,
                         seed: int = 7, n_boxes: int = 3,
                         texture: str = "noise"):
    """Occlusion-aware scene: layered right-view compositing.

    Two depth layers are modeled physically: textured foreground boxes
    composited over a wider background strip in the RIGHT view, and a
    LEFT view assembled per layer.  Left background pixels whose
    right-view correspondence is covered by a nearer box have *no*
    matching right content — true occlusions, with an exact mask.

    ``texture`` selects the surface model: "noise" (smoothed random —
    the round-1/2 scenes; matchable but the guide image carries no
    usable edge structure, so guide-aware stages measure at a
    disadvantage) or "textured" (:func:`patterned_texture` — per-surface
    base intensities + smooth interiors, the regime CVF/WMF/FGS are
    built for; same occlusion model either way).

    Returns (left, right, gt_disparity, occluded) — occluded[y, x] True
    where the left pixel is invisible to the right camera (matching there
    is unsolvable; evaluate bad-pixel on ~occluded, and use the mask as
    ground truth for left-right-consistency tests).
    """
    if texture not in ("noise", "textured"):
        raise ValueError(f"unknown texture model {texture!r}; expected "
                         "'noise' or 'textured'")
    rng = np.random.default_rng(seed)
    d_bg = max(max_disparity // 8, 1)
    if texture == "textured":
        levels = _surface_levels(rng, n_boxes + 1)
        strip = patterned_texture(rng, height, width + max_disparity,
                                  base=levels[0])
        surface = lambda h, w, i: patterned_texture(rng, h, w,
                                                    base=levels[i + 1])
    else:
        strip = smooth_texture(rng, height, width + max_disparity)
        surface = lambda h, w, i: smooth_texture(rng, h, w)

    # RIGHT view: background + boxes painted nearest-last.
    right = strip[:, max_disparity:].copy()
    d_right = np.full((height, width), d_bg, np.int32)
    boxes = []
    for i in range(n_boxes):
        r0 = int(rng.integers(0, max(height - 8, 1)))
        c0 = int(rng.integers(0, max(width - 8, 1)))
        bh = int(rng.integers(height // 6 + 1, height // 2 + 2))
        bw = int(rng.integers(width // 6 + 1, width // 2 + 2))
        bh, bw = min(bh, height - r0), min(bw, width - c0)
        d_f = int(rng.integers(d_bg + 1, max_disparity - 1))
        boxes.append((d_f, r0, c0, bh, bw, surface(bh, bw, i)))
    boxes.sort(key=lambda b: b[0])          # nearest (largest d) last
    for d_f, r0, c0, bh, bw, tex in boxes:
        right[r0:r0 + bh, c0:c0 + bw] = tex
        d_right[r0:r0 + bh, c0:c0 + bw] = d_f

    # LEFT view: background first (sampling the strip, which extends past
    # the right image's left edge), then boxes shifted right by their
    # disparity, nearest last.
    xs = np.arange(width)[None, :]
    left = np.take_along_axis(
        strip, np.clip(xs - d_bg + max_disparity, 0, None)
        * np.ones((height, 1), np.int32), axis=1).astype(np.float32)
    gt = np.full((height, width), d_bg, np.int32)
    for d_f, r0, c0, bh, bw, tex in boxes:
        l0 = c0 + d_f
        l1 = min(l0 + bw, width)
        if l1 <= l0:
            continue
        left[r0:r0 + bh, l0:l1] = tex[:, :l1 - l0]
        gt[r0:r0 + bh, l0:l1] = d_f

    # Occlusions: the left pixel's right-view point is covered by a nearer
    # surface (or falls off the image).
    xr = xs - gt
    occluded = xr < 0
    xr_safe = np.clip(xr, 0, width - 1)
    occluded = occluded | (np.take_along_axis(
        d_right, xr_safe * np.ones((height, 1), np.int32), axis=1) > gt)
    gt = np.minimum(gt, np.maximum(xs, 0)).astype(np.int32)
    return (left.astype(np.float32), right.astype(np.float32), gt,
            occluded)


def stereo_sequence(height: int, width: int, max_disparity: int,
                    n_frames: int, seed: int = 7, motion: int = 2,
                    pan: int = 1):
    """Temporally coherent flat-warp sequence with exact per-frame truth.

    One texture strip pans ``pan`` px/frame (so both views change every
    frame) while layered boxes drift up to ``motion`` px/frame in the
    image plane and step their disparity every other frame — smooth
    inter-frame disparity change, the regime a temporal band tracker
    (:class:`~stereomatch_tpu.temporal.TemporalPipeline`) must hold onto.

    Returns a list of ``(left, right, gt_disparity)`` triples with the
    same flat-warp guarantee as :func:`stereo_pair`:
    left[y, x] = right[y, x - gt[y, x]].
    """
    rng = np.random.default_rng(seed)
    strip = smooth_texture(rng, height, width + max_disparity)
    d_bg = max(max_disparity // 8, 1)
    boxes = []
    for _ in range(4):
        r0 = int(rng.integers(0, max(height - 8, 1)))
        c0 = int(rng.integers(0, max(width - 8, 1)))
        bh = int(rng.integers(height // 6 + 1, height // 2 + 2))
        bw = int(rng.integers(width // 6 + 1, width // 2 + 2))
        d = int(rng.integers(1, max_disparity - 1))
        vr = int(rng.integers(-motion, motion + 1))
        vc = int(rng.integers(-motion, motion + 1))
        vd = int(rng.integers(-1, 2))
        boxes.append((r0, c0, bh, bw, d, vr, vc, vd))

    xs = np.arange(width)[None, :]
    frames = []
    for t in range(n_frames):
        tex = np.roll(strip, t * pan, axis=1)[:, max_disparity:]
        gt = np.full((height, width), d_bg, np.int32)
        for r0, c0, bh, bw, d, vr, vc, vd in boxes:
            r = int(np.clip(r0 + t * vr, 0, height - 1))
            c = int(np.clip(c0 + t * vc, 0, width - 1))
            dt = int(np.clip(d + (t // 2) * vd, 1, max_disparity - 1))
            gt[r:r + bh, c:c + bw] = dt
        gt = np.minimum(gt, np.maximum(xs, 0)).astype(np.int32)
        left = np.take_along_axis(tex, xs - gt, axis=1)
        frames.append((left.astype(np.float32), tex.astype(np.float32), gt))
    return frames
