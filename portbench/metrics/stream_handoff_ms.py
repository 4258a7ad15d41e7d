"""stream_handoff_ms: for each batch, the time from its fetch thread's
return from the batch's event to ``run`` holding the result, while
``run`` waited (the host widening and the hand-off between threads:
``StreamStats.handoff_s / frames``, part of the fetch wait), in ms a
frame.  None unless the program's last run is the window's."""

from portbench import program_stats


def read(record):
    stats = program_stats.window_stats(record)
    if stats is None or not stats.frames or not hasattr(stats, "handoff_s"):
        return None
    return stats.handoff_s / stats.frames * 1e3
