"""Host-side I/O and rectification.  ``data`` (PFM/PNM/PNG reading, the
Middlebury and KITTI datasets), ``capture`` (cameras, video files, Y4M
streams, image sequences) and ``synthetic`` (the generated scenes) are
copies of the JAX package's modules, so the port runs where JAX is not
installed; ``png`` is the port's own PNG codec (the JAX package reads
PNG through PIL); ``calibration`` warps images with PyTorch.  The names
the JAX package's ``io`` exports are re-exported here; PIL and OpenCV
stay imported only inside the functions that need them."""

from . import calibration, capture, data, png, synthetic
from .calibration import StereoRectifier, warp_perspective
from .capture import (ImageSequenceCapture, StereoCapture, StereoCaptureImage,
                      split_side_by_side, to_grayscale_array)
from .data import (KittiDataset, MiddleburyDataset, load_image,
                   parse_middlebury_calib, read_pfm, write_pfm)

__all__ = ["ImageSequenceCapture", "KittiDataset", "MiddleburyDataset",
           "StereoCapture", "StereoCaptureImage", "StereoRectifier",
           "calibration", "capture", "data", "load_image",
           "parse_middlebury_calib", "png", "read_pfm",
           "split_side_by_side", "synthetic", "to_grayscale_array",
           "warp_perspective", "write_pfm"]
