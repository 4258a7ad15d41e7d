"""program_ops_per_frame: the device operations the program enqueued for
the window's frames, over the frames it ran (``StreamStats.device_ops /
frames_run``): each replay's graph nodes and its copies in and out, and
each batch's uploads, widenings, narrowing and copy to the host; the
stage stamps of a traced run left out.  None where a frame ran eagerly,
or unless the program's last run is the window's."""

from portbench import program_stats


def read(record):
    stats = program_stats.window_stats(record)
    if (stats is None or getattr(stats, "device_ops", None) is None
            or not stats.frames_run):
        return None
    return stats.device_ops / stats.frames_run
