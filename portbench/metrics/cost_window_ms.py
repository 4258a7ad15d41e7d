"""cost_window_ms: device ms a frame of the cost stage inside the
window's own replays, from the program's stage stamps
(``StreamStats.stage_device_s["cost"] / frames_stamped``: the
card's global timer before and after the stage, in the frames replayed
while the profiler slice recorded).  None unless the program's last run
(``stereomatch_tpu_torch.stream.LAST_STATS``) is the window's."""

from portbench import program_stats


def read(record):
    stats = program_stats.window_stats(record)
    if stats is None or not getattr(stats, "frames_stamped", 0):
        return None
    return stats.stage_device_s["cost"] / stats.frames_stamped * 1e3
