"""fps: frames yielded in the window over the window's time, from the
first hand-over to the last disparity (host clock)."""

from portbench import stats


def read(record):
    if not record.get("yield_t"):
        return None
    return stats.rate(record["read_t"], record["yield_t"])
