"""Host-side I/O and rectification.  ``data`` (PFM/PNM/PNG reading, the
Middlebury and KITTI datasets), ``capture`` (cameras, video files, Y4M
streams, image sequences) and ``synthetic`` (the generated scenes) are
copies of the JAX package's modules, so the port runs where JAX is not
installed; ``png`` is the port's own PNG codec (the JAX package reads
PNG through PIL); ``calibration`` warps images with PyTorch."""

from . import calibration, capture, data, png, synthetic

__all__ = ["calibration", "capture", "data", "png", "synthetic"]
