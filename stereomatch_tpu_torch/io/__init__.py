"""Host-side I/O and rectification.  ``data`` (PFM/PNM parsing, the
Middlebury and KITTI datasets) and ``synthetic`` (the generated scenes)
are numpy-only copies of the JAX package's modules, so the port runs
where JAX is not installed; ``calibration`` warps images with PyTorch."""

from . import calibration, data, synthetic

__all__ = ["calibration", "data", "synthetic"]
