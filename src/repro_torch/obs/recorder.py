"""Structured telemetry core (the port's copy of ``repro.obs.recorder``,
pure Python): counters / gauges / histograms, events, and wall-clock
spans, with a JSONL sink, an in-memory ring buffer, and a
near-zero-overhead disabled mode.

Design constraints (why this is not "just logging"):

* **Hot-path safe.**  The trainer calls the recorder every step, the
  serving engine every tick.  A record is one small dict appended to a
  bounded deque plus (when a sink directory is configured) one buffered
  JSON line — no locks on the read path, one lock around the buffered
  file writes (the async checkpointer, ROADMAP.md A4, will report write
  latency from its worker thread).  With telemetry disabled the
  :class:`NullRecorder` methods are bare early-returns, well under a
  microsecond per call
  (guarded by tests/test_torch_obs.py::test_null_recorder_overhead).
* **Self-describing.**  Every record is one JSONL line validated by
  :mod:`repro_torch.obs.schema`; ``python -m repro_torch.obs.report``
  renders a run's
  per-phase breakdown from the files alone — no live process needed.
* **Familiar console output.**  Events carry an optional human-readable
  ``msg``; a console sink prints it verbatim, so the pre-telemetry
  ``log_fn``/``print`` strings survive unchanged while the structured
  payload rides along in the JSONL.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

KINDS = ("counter", "gauge", "histogram", "event", "span")

# samples kept per histogram for percentile queries (summary() /
# report.py); a bounded deque so a million-step run cannot grow without
# limit — percentiles over the most recent window are what an operator
# wants anyway
HIST_WINDOW = 8192


class _NullSpan:
    """Reusable no-op context manager (no per-call allocation)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """The disabled-mode recorder: every method is a bare early return.

    A single shared instance (:data:`NULL`) is the process default, so
    instrumented hot paths cost one attribute lookup + one no-op call
    when telemetry is off."""

    enabled = False
    out_dir: Optional[str] = None

    def counter(self, name, value=1, **tags):
        pass

    def gauge(self, name, value, **tags):
        pass

    def observe(self, name, value, **tags):
        pass

    def event(self, name, msg="", **tags):
        pass

    def span(self, name, **tags):
        return _NULL_SPAN

    def flush(self):
        pass

    def close(self):
        pass

    def summary(self):
        return {}


NULL = NullRecorder()


class _Span:
    """Timing context manager: records a ``span`` with ``dur_s`` on exit
    (perf_counter — monotonic, so an NTP slew mid-span cannot produce a
    negative duration)."""

    __slots__ = ("_rec", "name", "tags", "_t0")

    def __init__(self, rec: "Recorder", name: str, tags: Dict):
        self._rec = rec
        self.name = name
        self.tags = tags

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._rec._emit("span", self.name,
                        dur_s=time.perf_counter() - self._t0,
                        tags=self.tags or None)
        return False


class Recorder:
    """Structured telemetry recorder.

    ``out_dir``: directory for the JSONL sink (``telemetry.jsonl`` is
    appended; the directory is created).  ``None`` keeps records
    in-memory only (ring buffer + aggregates) — the launch default, so
    instrumentation is always safe to call.

    ``console``: optional callable for human-readable event lines (the
    pre-telemetry ``log_fn``); non-event records never hit the console.

    ``flush_every``: JSONL lines buffered between file flushes.  Must be
    positive — a zero/negative interval would either busy-flush or never
    flush, both silent misconfigurations (launch/serve.py forwards its
    ``--telemetry-flush`` flag here).

    ``ring_size``: bounded in-memory record history (most recent wins) —
    the crash-dump / in-process-inspection view.
    """

    enabled = True

    def __init__(self, out_dir: Optional[str] = None, *,
                 ring_size: int = 2048, flush_every: int = 64,
                 console: Optional[Callable[[str], None]] = None,
                 clock: Callable[[], float] = time.time):
        if flush_every <= 0:
            raise ValueError(
                f"telemetry flush interval must be a positive number of "
                f"records, got {flush_every} — use flush_every=1 for "
                f"write-through, or leave the default (64)")
        if ring_size <= 0:
            raise ValueError(f"ring_size must be positive, got {ring_size}")
        self.out_dir = out_dir
        self.console = console
        self.clock = clock
        self.flush_every = flush_every
        self.ring: deque = deque(maxlen=ring_size)
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, deque] = {}
        self._lock = threading.Lock()
        self._buf: List[str] = []
        self._file = None
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            self._file = open(os.path.join(out_dir, "telemetry.jsonl"), "a")

    # ---- emit paths ------------------------------------------------------
    def _emit(self, kind: str, name: str, *, value=None, dur_s=None,
              msg=None, tags=None):
        rec = {"ts": self.clock(), "kind": kind, "name": name}
        if value is not None:
            rec["value"] = value
        if dur_s is not None:
            rec["dur_s"] = dur_s
        if msg:
            rec["msg"] = msg
        if tags:
            rec["tags"] = tags
        self.ring.append(rec)
        if self._file is not None:
            with self._lock:
                self._buf.append(json.dumps(rec))
                if len(self._buf) >= self.flush_every:
                    self._flush_locked()
        return rec

    def counter(self, name: str, value: float = 1, **tags):
        """Monotonic count (events seen, tokens decoded, restarts)."""
        self.counters[name] = self.counters.get(name, 0) + value
        self._emit("counter", name, value=value, tags=tags or None)

    def gauge(self, name: str, value: float, **tags):
        """Point-in-time level (queue depth, slot occupancy, loss)."""
        self.gauges[name] = value
        self._emit("gauge", name, value=value, tags=tags or None)

    def observe(self, name: str, value: float, **tags):
        """Histogram sample (step time, decode latency, TTFT)."""
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = deque(maxlen=HIST_WINDOW)
        h.append(value)
        self._emit("histogram", name, value=value, tags=tags or None)

    def event(self, name: str, msg: str = "", **tags):
        """Discrete occurrence with structured payload and an optional
        human-readable line (printed by the console sink verbatim, so
        existing log output stays familiar)."""
        self._emit("event", name, msg=msg, tags=tags or None)
        if self.console is not None:
            self.console(msg if msg else
                         f"[{name}] " + " ".join(f"{k}={v}"
                                                 for k, v in tags.items()))

    def span(self, name: str, **tags) -> _Span:
        """``with rec.span("phase"): ...`` — wall-clock span record."""
        return _Span(self, name, tags)

    # ---- lifecycle -------------------------------------------------------
    def _flush_locked(self):
        if self._buf and self._file is not None:
            self._file.write("\n".join(self._buf) + "\n")
            self._file.flush()
            self._buf = []

    def flush(self):
        if self._file is not None:
            with self._lock:
                self._flush_locked()

    def close(self):
        if self._file is not None:
            with self._lock:
                self._flush_locked()
                self._file.close()
                self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ---- in-process queries ---------------------------------------------
    def percentile(self, name: str, q: float) -> Optional[float]:
        """q in [0, 100] over the histogram's retained window (nearest-rank
        on the sorted samples; None when the histogram is empty)."""
        h = self.hists.get(name)
        if not h:
            return None
        xs = sorted(h)
        idx = min(int(round(q / 100.0 * (len(xs) - 1))), len(xs) - 1)
        return xs[idx]

    def summary(self) -> Dict:
        """Aggregated view: counters, last gauges, histogram p50/p90/p99."""
        hist = {}
        for name, h in self.hists.items():
            if not h:
                continue
            hist[name] = {
                "count": len(h),
                "mean": sum(h) / len(h),
                "p50": self.percentile(name, 50),
                "p90": self.percentile(name, 90),
                "p99": self.percentile(name, 99),
            }
        return {"counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": hist}


# --------------------------------------------------------------------------
# process-global recorder (planner / kernels instrumentation reaches it
# without threading a parameter through every call chain)
# --------------------------------------------------------------------------
_GLOBAL: object = NULL


def get_recorder():
    """The process-global recorder (NullRecorder unless configured)."""
    return _GLOBAL


def set_recorder(rec) -> object:
    """Install ``rec`` as the process-global recorder; returns the
    previous one (tests restore it)."""
    global _GLOBAL
    prev, _GLOBAL = _GLOBAL, (rec if rec is not None else NULL)
    return prev


def configure(out_dir: Optional[str] = None, **kw) -> Recorder:
    """Build a :class:`Recorder` and install it globally (the launchers'
    ``--telemetry <dir>`` entry point)."""
    rec = Recorder(out_dir, **kw)
    set_recorder(rec)
    return rec
