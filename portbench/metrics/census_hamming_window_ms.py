"""census_hamming_window_ms: device ms a frame from the stamp after the
census codes to the end of the cost stage, the Hamming volume, inside
the window's own replays (``(StreamStats.stage_device_s["cost"] -
stage_device_s["census_codes"]) / frames_stamped``).  With
``census_codes_window_ms`` it sums to ``cost_window_ms``.  None where
``census_codes_window_ms`` is."""

from portbench import program_stats


def read(record):
    stats = program_stats.window_stats(record)
    if stats is None or not getattr(stats, "frames_stamped", 0):
        return None
    codes = stats.stage_device_s.get("census_codes")
    if codes is None:
        return None
    return (stats.stage_device_s["cost"] - codes) / stats.frames_stamped * 1e3
