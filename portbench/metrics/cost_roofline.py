"""cost_roofline: the least time the card could take for the cost
stage (its bytes once over the memory rate, or its operations over the
float32 rate, whichever is larger; ``portbench/work.py``) over
``cost_ms``, in percent."""

from portbench import work


def read(record):
    ms = (record.get("stages_ms") or {}).get("cost")
    return work.roofline_pct("cost", record["config"], ms)
