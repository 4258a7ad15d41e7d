"""latency_p95_ms: the 95th percentile of the same latencies as
``latency_p50_ms``, over every frame of the window."""

from portbench import stats


def read(record):
    lat = stats.latencies_ms(record.get("read_t", []),
                             record.get("yield_t", []))
    return stats.percentile(lat, 95) if lat else None
