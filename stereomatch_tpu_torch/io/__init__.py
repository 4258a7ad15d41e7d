"""Host-side I/O and rectification.  ``data`` (PFM/PNM/PNG reading, the
Middlebury and KITTI datasets) and ``synthetic`` (the generated scenes)
are numpy-only copies of the JAX package's modules, so the port runs
where JAX is not installed; ``png`` is the port's own PNG codec (the JAX
package reads PNG through PIL); ``calibration`` warps images with
PyTorch."""

from . import calibration, data, png, synthetic

__all__ = ["calibration", "data", "png", "synthetic"]
