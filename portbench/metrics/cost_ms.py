"""cost_ms: device ms a frame of the cost stage of the pipeline the
stream replays, from the profiler's trace of a chain of eager calls on
the cell's frames after the window (``portbench/stages.py``)."""


def read(record):
    return (record.get("stages_ms") or {}).get("cost")
