"""census_codes_window_ms: device ms a frame from the start of the cost
stage to the end of the census codes of both images, inside the
window's own replays (``StreamStats.stage_device_s["census_codes"] /
frames_stamped``: the card's global timer at the frame's first stamp
and at the stamp the census cost makes after its codes, in the frames
replayed while the profiler slice recorded).  None unless the program's
last run is the window's and its frames carried that stamp (a census
cost in a program that makes it)."""

from portbench import program_stats


def read(record):
    stats = program_stats.window_stats(record)
    if stats is None or not getattr(stats, "frames_stamped", 0):
        return None
    codes = stats.stage_device_s.get("census_codes")
    if codes is None:
        return None
    return codes / stats.frames_stamped * 1e3
