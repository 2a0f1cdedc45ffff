"""Telemetry record schema: one JSONL line per record (the port's copy of
``repro.obs.schema``, the same checks and messages).

Kept as a hand-rolled validator (no jsonschema dependency in the image):
``launch/train.py --steps 3 --telemetry DIR`` -> ``python -m
repro_torch.obs.report DIR --validate`` and tests/test_torch_obs.py both
run every emitted line through :func:`validate_record`, so the schema IS
enforced, just without the library.

Record shape::

    {"ts": <float unix-seconds>,
     "kind": "counter" | "gauge" | "histogram" | "event" | "span",
     "name": "<dotted.metric.name>",
     # kind-dependent:
     "value": <number>,          # counter / gauge / histogram
     "dur_s": <number >= 0>,     # span
     "msg": "<human line>",      # event (optional)
     "tags": {str: str|num|bool|null}}   # optional, flat
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.obs.recorder import KINDS

_NUM = (int, float)


class SchemaError(ValueError):
    pass


def validate_record(rec: Dict) -> Dict:
    """Validate one parsed JSONL record; returns it, raises
    :class:`SchemaError` naming the violated field otherwise."""
    if not isinstance(rec, dict):
        raise SchemaError(f"record is not an object: {rec!r}")
    for req in ("ts", "kind", "name"):
        if req not in rec:
            raise SchemaError(f"missing required field {req!r}: {rec!r}")
    if not isinstance(rec["ts"], _NUM):
        raise SchemaError(f"ts must be numeric: {rec['ts']!r}")
    kind = rec["kind"]
    if kind not in KINDS:
        raise SchemaError(f"unknown kind {kind!r} (valid: {KINDS})")
    if not isinstance(rec["name"], str) or not rec["name"]:
        raise SchemaError(f"name must be a non-empty string: {rec!r}")
    if kind in ("counter", "gauge", "histogram"):
        if not isinstance(rec.get("value"), _NUM):
            raise SchemaError(f"{kind} record needs a numeric value: {rec!r}")
    if kind == "span":
        if not isinstance(rec.get("dur_s"), _NUM) or rec["dur_s"] < 0:
            raise SchemaError(f"span record needs dur_s >= 0: {rec!r}")
    if "msg" in rec and not isinstance(rec["msg"], str):
        raise SchemaError(f"msg must be a string: {rec!r}")
    tags = rec.get("tags")
    if tags is not None:
        if not isinstance(tags, dict):
            raise SchemaError(f"tags must be an object: {rec!r}")
        for k, v in tags.items():
            if not isinstance(k, str):
                raise SchemaError(f"tag key must be a string: {k!r}")
            if v is not None and not isinstance(v, (str, bool) + _NUM):
                raise SchemaError(
                    f"tag value must be scalar (str/num/bool/null), got "
                    f"{k}={v!r}")
    allowed = {"ts", "kind", "name", "value", "dur_s", "msg", "tags"}
    extra = set(rec) - allowed
    if extra:
        raise SchemaError(f"unknown fields {sorted(extra)}: {rec!r}")
    return rec


def validate_lines(lines) -> List[Dict]:
    """Validate an iterable of JSONL strings; returns the parsed records."""
    import json
    out = []
    for i, ln in enumerate(lines):
        ln = ln.strip()
        if not ln:
            continue
        try:
            rec = json.loads(ln)
        except ValueError as e:
            raise SchemaError(f"line {i + 1} is not valid JSON: {e}")
        try:
            out.append(validate_record(rec))
        except SchemaError as e:
            raise SchemaError(f"line {i + 1}: {e}")
    return out
