"""The plain reference the benchmark judges the program against.

Plain PyTorch, written from the published algorithms and independent of
``stereomatch_tpu_torch`` (which it never imports) and of JAX.  It
recomputes each frame from the uint8 pair the capture handed over.
"""

from .stereo import (census_volume, disparity, semiglobal, ssd_volume,
                     winner_takes_all)

__all__ = ["census_volume", "disparity", "semiglobal", "ssd_volume",
           "winner_takes_all"]
