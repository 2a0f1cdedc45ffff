"""Unified telemetry subsystem of the port (``repro.obs`` in PyTorch).

* :class:`Recorder` — counters / gauges / histograms, structured events,
  wall-clock spans; JSONL sink + in-memory ring buffer; a
  :class:`NullRecorder` disabled mode whose calls cost well under a
  microsecond (the hot paths are instrumented unconditionally);
* :func:`phase_scope` / :func:`trace_annotation` — ``torch.profiler``
  ranges that name the TMP gather/compute/reduce chunks and the host's
  step and tick in a profile;
* :class:`OverlapProbe` — the runtime overlap-efficiency probe: measured
  exposed-communication fraction per layer group, residual against the
  calibrated cost model, and the ``calibration_stale`` drift signal;
* ``python -m repro_torch.obs.report`` — render a run's JSONL into
  per-phase breakdown tables.

The record names, kinds and tags are JAX's letter for letter.
"""
from repro_torch.obs.recorder import (NULL, NullRecorder,  # noqa: F401
                                      Recorder, configure, get_recorder,
                                      set_recorder)
from repro_torch.obs.tracing import phase_scope, trace_annotation  # noqa: F401

__all__ = [
    "Recorder", "NullRecorder", "NULL",
    "configure", "get_recorder", "set_recorder",
    "phase_scope", "trace_annotation",
    "OverlapProbe", "plan_group_model",
]


def __getattr__(name):
    # probe pulls in the cost model; keep the base import light
    if name in ("OverlapProbe", "plan_group_model"):
        from repro_torch.obs import probe
        return getattr(probe, name)
    raise AttributeError(name)
