"""The micro-group count resolvers of ``repro.core.pipeline`` that the
planner's decode cost model reads (``costmodel.decode_step_time``), so
that it never reports a count the execution path would refuse.  The
pipeline itself (stages, the interleaved 1F1B schedule) is ROADMAP.md
A8."""
from __future__ import annotations

# what the serving engine and the launchers refuse a pipeline with
PIPE_ITEM = "ROADMAP.md A8, pipeline decode (decode_stream)"


def _resolve_divisor(local_batch: int, cap: int, requested: int,
                     what: str) -> int:
    """Shared micro-count resolution: the requested value must divide the
    per-shard batch (raises otherwise); auto (0) takes the largest divisor
    up to ``cap``."""
    local = max(local_batch, 1)
    if requested:
        if requested < 1 or local % requested:
            raise ValueError(
                f"{what} {requested} must be a positive divisor of the "
                f"per-shard batch {local}")
        return requested
    n = min(local, max(cap, 1))
    while n > 1 and local % n:
        n -= 1
    return max(n, 1)


def resolve_decode_micro(local_batch: int, pp: int, virtual_stages: int = 1,
                         requested: int = 0) -> int:
    """Decode micro-group count: the requested value (validated), else the
    largest divisor of the slot batch up to ``pp * v`` — exactly enough
    in-flight micro-groups to fill the pipe.  More would re-stream each
    stage's (memory-bound) weights extra times per engine step; fewer
    leaves stages idle."""
    return _resolve_divisor(local_batch, pp * max(virtual_stages, 1),
                            requested, "decode micro-group count")
