"""setup_s: from the process's start to the window's first frame:
imports, the kernels' build or load, the frame pool, the estimator,
its graph capture and the warm-up (host clock)."""


def read(record):
    return record.get("setup_s")
