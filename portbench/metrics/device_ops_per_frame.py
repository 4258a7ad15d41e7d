"""device_ops_per_frame: kernels, copies and sets on the device in the
profiler's slice of the window, over the frames yielded in it."""


def read(record):
    trace = record.get("trace")
    if not trace or not trace.get("frames"):
        return None
    return trace["device_ops"] / trace["frames"]
