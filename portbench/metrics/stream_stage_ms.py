"""stream_stage_ms: the stream's host time a frame filling the pinned
staging buffer, the wait on the slot's event included
(``StreamStats.stage_s / frames``, the ``stm/stream/stage`` spans: the
part of ``stream_dispatch_ms`` that is not the enqueue), in ms.  None
unless the program's last run is the window's."""

from portbench import program_stats


def read(record):
    stats = program_stats.window_stats(record)
    if stats is None or not stats.frames or not hasattr(stats, "stage_s"):
        return None
    return stats.stage_s / stats.frames * 1e3
