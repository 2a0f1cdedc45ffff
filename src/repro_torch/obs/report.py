"""Render a telemetry run's JSONL into per-phase breakdown tables —
the reproduction's own Fig. 2, from the files alone (no live process).
The port's copy of ``repro.obs.report``: the same text for the same
records.

    python -m repro_torch.obs.report <telemetry-dir | telemetry.jsonl>
    python -m repro_torch.obs.report <dir> --validate    # schema gate

Sections:

* **phases** — every histogram/span metric: count, mean, p50/p90/p99 and
  the share of total accounted wall time (the per-phase breakdown);
* **overlap** — the runtime overlap-efficiency probe's per-layer-group
  events: predicted vs measured exposed-communication fraction and the
  residual against the calibrated cost model;
* **serving** — the serving path's own dashboard when ``serving.*``
  metrics are present: throughput, mean/percentile TTFT, prefix-cache hit
  rate, speculative accept rate, page-pool level and admission
  backpressure;
* **counters / gauges** — run totals and last-seen levels;
* **events** — the notable trail (faults, replans, calibration_stale,
  planner decisions), newest last.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List


def load(path: str) -> List[Dict]:
    """Parse all records from a telemetry.jsonl file or a directory
    containing one (or several — merged in name order)."""
    files = []
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            if name.endswith(".jsonl"):
                files.append(os.path.join(path, name))
        if not files:
            raise FileNotFoundError(f"no .jsonl telemetry files in {path}")
    else:
        files = [path]
    records = []
    for f in files:
        with open(f) as fh:
            for ln in fh:
                ln = ln.strip()
                if ln:
                    records.append(json.loads(ln))
    return records


def _pct(xs: List[float], q: float) -> float:
    ys = sorted(xs)
    return ys[min(int(round(q / 100.0 * (len(ys) - 1))), len(ys) - 1)]


def _fmt_s(v: float) -> str:
    if v >= 1.0:
        return f"{v:.2f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.1f}ms"
    return f"{v * 1e6:.0f}us"


def _table(headers: List[str], rows: List[List[str]]) -> str:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    def line(cells):
        return "  ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip()
    out = [line(headers), line(["-" * w for w in widths])]
    out.extend(line(r) for r in rows)
    return "\n".join(out)


def _serving_section(hists: Dict[str, List[float]],
                     counters: Dict[str, float],
                     gauges: Dict[str, float]) -> List[List[str]]:
    """The serving path's dashboard rows (empty when the run emitted no
    ``serving.*`` metrics): throughput and TTFT from the histograms,
    cache efficiency and backpressure from the gauges/counters."""
    if not any(n.startswith("serving.")
               for n in (*hists, *counters, *gauges)):
        return []
    rows: List[List[str]] = []
    if "serving.tok_per_s" in gauges:
        rows.append(["throughput (tok/s)",
                     f"{gauges['serving.tok_per_s']:.1f}"])
    if "serving.decoded_tokens" in counters:
        rows.append(["decoded tokens",
                     f"{counters['serving.decoded_tokens']:g}"])
    ttft = hists.get("serving.ttft_s")
    if ttft:
        rows.append(["TTFT mean / p90",
                     f"{_fmt_s(sum(ttft) / len(ttft))} / "
                     f"{_fmt_s(_pct(ttft, 90))}"])
    steps = hists.get("serving.decode_step_s")
    if steps:
        rows.append(["decode step p50 / p99",
                     f"{_fmt_s(_pct(steps, 50))} / "
                     f"{_fmt_s(_pct(steps, 99))}"])
    if "serving.prefix_hit_rate" in gauges:
        rows.append(["prefix-cache hit rate",
                     f"{gauges['serving.prefix_hit_rate']:.1%}"])
    if "serving.spec_accept_rate" in gauges:
        rows.append(["speculative accept rate",
                     f"{gauges['serving.spec_accept_rate']:.1%}"])
    if "serving.free_pages" in gauges:
        rows.append(["free KV pages (last)",
                     f"{gauges['serving.free_pages']:g}"])
    if "serving.admission_deferred" in counters:
        rows.append(["admissions deferred (cache full)",
                     f"{counters['serving.admission_deferred']:g}"])
    if "serving.slot_occupancy" in gauges:
        rows.append(["slot occupancy (last)",
                     f"{gauges['serving.slot_occupancy']:.1%}"])
    return rows


def render(records: List[Dict]) -> str:
    hists: Dict[str, List[float]] = {}
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    overlap_rows: List[Dict] = []
    events: List[Dict] = []
    for r in records:
        kind = r.get("kind")
        if kind == "histogram":
            hists.setdefault(r["name"], []).append(float(r["value"]))
        elif kind == "span":
            hists.setdefault(r["name"], []).append(float(r["dur_s"]))
        elif kind == "counter":
            counters[r["name"]] = counters.get(r["name"], 0) \
                + float(r["value"])
        elif kind == "gauge":
            gauges[r["name"]] = float(r["value"])
        elif kind == "event":
            if r["name"] == "overlap.group":
                overlap_rows.append(r.get("tags") or {})
            events.append(r)

    parts: List[str] = []
    if hists:
        totals = {n: sum(v) for n, v in hists.items()}
        grand = sum(totals.values()) or 1.0
        rows = []
        for name in sorted(hists, key=lambda n: -totals[n]):
            xs = hists[name]
            rows.append([name, str(len(xs)), _fmt_s(sum(xs) / len(xs)),
                         _fmt_s(_pct(xs, 50)), _fmt_s(_pct(xs, 90)),
                         _fmt_s(_pct(xs, 99)), _fmt_s(totals[name]),
                         f"{totals[name] / grand:5.1%}"])
        parts.append("== per-phase breakdown ==\n" + _table(
            ["phase", "count", "mean", "p50", "p90", "p99", "total",
             "share"], rows))
    if overlap_rows:
        rows = []
        for t in overlap_rows:
            rows.append([
                str(t.get("group", "?")), str(t.get("schedule", "?")),
                str(t.get("layers", "?")),
                f"{float(t.get('predicted_exposed_frac', 0)):.1%}",
                f"{float(t.get('measured_exposed_frac', 0)):.1%}",
                f"{float(t.get('residual', 0)):+.0%}",
            ])
        parts.append(
            "== overlap efficiency (exposed-communication fraction) ==\n"
            + _table(["group", "schedule", "layers", "predicted",
                      "measured", "residual"], rows))
    serving_rows = _serving_section(hists, counters, gauges)
    if serving_rows:
        parts.append("== serving ==\n" + _table(["metric", "value"],
                                                serving_rows))
    if counters:
        rows = [[n, f"{v:g}"] for n, v in sorted(counters.items())]
        parts.append("== counters ==\n" + _table(["counter", "total"], rows))
    if gauges:
        rows = [[n, f"{v:g}"] for n, v in sorted(gauges.items())]
        parts.append("== gauges (last) ==\n" + _table(["gauge", "value"],
                                                      rows))
    notable = [e for e in events
               if e["name"] != "overlap.group"]
    if notable:
        rows = []
        for e in notable[-20:]:
            tags = e.get("tags") or {}
            detail = e.get("msg") or " ".join(f"{k}={v}"
                                              for k, v in tags.items())
            rows.append([e["name"], detail[:100]])
        parts.append("== events (last 20) ==\n" + _table(["event",
                                                          "detail"], rows))
    if not parts:
        return "(no telemetry records)"
    return "\n\n".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a telemetry run's JSONL into per-phase "
                    "breakdown tables")
    ap.add_argument("path", help="telemetry directory or .jsonl file")
    ap.add_argument("--validate", action="store_true",
                    help="validate every record against the schema and "
                         "exit non-zero on a violation (CI gate)")
    args = ap.parse_args(argv)
    records = load(args.path)
    if args.validate:
        from repro_torch.obs.schema import SchemaError, validate_record
        try:
            for i, rec in enumerate(records):
                validate_record(rec)
        except SchemaError as e:
            print(f"schema violation at record {i + 1}: {e}",
                  file=sys.stderr)
            return 1
        print(f"{len(records)} telemetry records OK")
        return 0
    print(render(records))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
