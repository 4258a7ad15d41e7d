"""Device time of a frame's stages, from the profiler's trace.

After the window, the pipeline the stream replays runs each stage
eagerly on the cell's device-resident frames: a chain of ``CHAIN``
calls under ``torch.profiler``, after as many unmarked calls that let
the profiler's device tracing start.  A stage's time is the union of the
device operations inside the chain's ``trace.MARKER`` range, over the
calls: device busy time, without the host's gaps between launches.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from . import trace

CHAIN = 20
FRAMES = 4


def _traced_ms(torch, fn, inputs: List[tuple]) -> Optional[float]:
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    fn(*inputs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(CHAIN):
            fn(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
        with record_function(trace.MARKER):
            for i in range(CHAIN):
                fn(*inputs[i % len(inputs)])
            torch.cuda.synchronize()
    reduced = trace.reduce_slice(trace.from_profiler(prof.events()))
    return None if reduced is None else reduced.busy_s * 1e3 / CHAIN


def time_stages(torch, pipeline, pairs: Sequence,
                device) -> Dict[str, float]:
    """{stage: device ms a frame} of ``pipeline``'s cost, aggregation (if
    any) and reduce over up to ``FRAMES`` uint8 pairs moved to
    ``device``; a stage whose trace holds nothing is left out."""
    images = [(torch.from_numpy(p.left).to(device).to(torch.float32),
               torch.from_numpy(p.right).to(device).to(torch.float32))
              for p in pairs[:FRAMES]]
    out = {"cost": _traced_ms(torch, pipeline.cost, images)}
    volumes = [(pipeline.cost(left, right), left) for left, right in images]
    if pipeline.aggregation is not None:
        out["aggregation"] = _traced_ms(torch, pipeline.aggregation,
                                        volumes)
        volumes = [(pipeline.aggregation(vol, left), left)
                   for vol, left in volumes]
    out["reduce"] = _traced_ms(torch, pipeline.disparity_reduce,
                               [(vol,) for vol, _ in volumes])
    torch.cuda.synchronize()
    return {stage: ms for stage, ms in out.items() if ms is not None}
