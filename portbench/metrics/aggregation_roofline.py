"""aggregation_roofline: the least time the card could take for the
aggregation stage (its bytes once over the memory rate, or its operations over the
float32 rate, whichever is larger; ``portbench/work.py``) over
``aggregation_ms``, in percent."""

from portbench import work


def read(record):
    ms = (record.get("stages_ms") or {}).get("aggregation")
    return work.roofline_pct("aggregation", record["config"], ms)
