"""The program's own counters of the window's run.

``stereomatch_tpu_torch.stream.LAST_STATS`` holds the ``StreamStats`` of
the last ``run`` to finish in the process, kept after the estimator is
freed.  A metric reads it only where it is the window's run: its frame
count is the window's.  A program without it (one older than its stage
stamps and counters) gives None, and so do the metrics that read it.
"""

from __future__ import annotations


def window_stats(record: dict):
    """``LAST_STATS`` where its frames are the window's yielded frames,
    else None."""
    from stereomatch_tpu_torch import stream
    stats = getattr(stream, "LAST_STATS", None)
    if stats is None or stats.frames != len(record.get("yield_t") or ()):
        return None
    return stats
