"""Host cost of the port's telemetry on the hot paths, on the host's
CPU (no card needed): a ``torch.profiler.record_function`` range entered
and left with no profiler recording, the gated ``obs.phase_scope`` that
the schedules use instead, ``obs.tracing.scoped`` (the entry ranges),
and the recorder calls of one engine tick (a JSONL-sinking ``Recorder``
and the disabled ``NULL``).

    PYTHONPATH=src python3 tools/range_cost.py [--n 200000]

Prints one JSON object of microseconds per call.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch

from repro_torch import obs
from repro_torch.obs import tracing


def _per_call(fn, n: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    n = ap.parse_args(argv).n
    x = torch.ones(4)

    def record_function():
        with torch.profiler.record_function("tmp.oases.row_matmul"):
            pass

    def phase_scope():
        with obs.phase_scope("tmp.oases.row_matmul"):
            pass

    def scoped():
        tracing.scoped("tmp.oases.gather_matmul", lambda t: t, x)

    with tempfile.TemporaryDirectory() as d:
        rec = obs.Recorder(d)

        def tick(r):
            # an engine tick's records: four gauges, a step time, a
            # counter (TTFT only on a request's first token)
            def run():
                r.gauge("serving.queue_depth", 3)
                r.gauge("serving.slot_occupancy", 0.5)
                r.gauge("serving.free_pages", 100)
                r.gauge("serving.prefix_hit_rate", 0.25)
                r.observe("serving.decode_step_s", 0.05)
                r.counter("serving.decoded_tokens", 8)
            return run

        out = {
            "record_function_us": _per_call(record_function, n),
            "phase_scope_idle_us": _per_call(phase_scope, n),
            "scoped_idle_us": _per_call(scoped, n),
            "tick_records_sink_us": _per_call(tick(rec), n // 10),
            "tick_records_null_us": _per_call(tick(obs.NULL), n),
            "torch": torch.__version__,
        }
        rec.close()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
