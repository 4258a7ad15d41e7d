"""stream_dispatch_ms: the stream layer's host time to stage, upload and
enqueue a frame: ``StreamStats.dispatch_s`` of the window's run over its
frames, in ms (the program's host clock)."""


def read(record):
    stream = record.get("stream") or {}
    if not stream.get("frames"):
        return None
    return stream["dispatch_s"] / stream["frames"] * 1e3
