"""latency_p50_ms: the median, over every frame of the window, of the
time from the capture handing the frame over to ``run`` yielding its
disparity on the host (host clock)."""

from portbench import stats


def read(record):
    lat = stats.latencies_ms(record.get("read_t", []),
                             record.get("yield_t", []))
    return stats.percentile(lat, 50) if lat else None
