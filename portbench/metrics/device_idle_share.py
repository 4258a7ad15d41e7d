"""device_idle_share: 100 x (1 - the union of the device's operations
over the profiler slice's wall time), in percent."""


def read(record):
    trace = record.get("trace")
    if not trace or not trace.get("window_s"):
        return None
    return (1.0 - trace["busy_s"] / trace["window_s"]) * 100.0
