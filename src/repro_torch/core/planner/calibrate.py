"""Per-host cached planner calibration, the port's copy of
``repro.core.planner.calibrate`` (ROADMAP item 3 / AMP §2210.07297: cost
models only transfer when calibrated per cluster).

:func:`calibrated_hw` is the launcher's default path to a planner
:class:`~repro_torch.core.planner.costmodel.HWConfig`: it runs the
``HWConfig.measure_fields`` micro-benches on the card once per host and
memoizes the raw measurements in a JSON cache keyed by a host
fingerprint (hostname, device name and count, torch and CUDA versions),
so repeated planner invocations pay the profiling cost once.

Caller ``overrides`` are applied ON TOP of the cached measurements at
load time (they are never baked into the cache): calibrate the chip, keep
the caller's cluster description (``n_chips``, ``node_size``...).

Escape hatches:

* ``--no-calibrate`` on the launcher — the H100_80GB_HBM3 fixture, no
  profiling (the CPU has no card to calibrate);
* ``REPRO_NO_CALIBRATE=1`` — same, for test/CI environments;
* ``REPRO_CAL_CACHE=<dir>`` — relocate the cache (default
  ``~/.cache/repro-oases``, the JAX package's directory; the port's files
  are ``torchcal-*.json``, JAX's ``hwcal-*.json``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional

from repro_torch.core.planner.costmodel import H100_80GB_HBM3, HWConfig

_ENV_DISABLE = "REPRO_NO_CALIBRATE"
_ENV_CACHE = "REPRO_CAL_CACHE"
_MEM_CACHE: Dict[str, Dict[str, float]] = {}    # fingerprint -> fields


def host_fingerprint() -> str:
    """Identity of the measurement: same fingerprint == same expected
    micro-bench results.  The device name and count catch accelerator
    changes; the torch and CUDA versions catch library changes (cuBLAS
    picks the product's kernel)."""
    import platform as _platform

    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    kind = torch.cuda.get_device_name(0).replace(" ", "_") if n else "cpu"
    return "-".join([
        _platform.node() or "unknown-host",
        kind,
        f"d{n}",
        f"torch{torch.__version__}",
        f"cuda{torch.version.cuda}",
    ])


def cache_dir() -> str:
    return os.environ.get(_ENV_CACHE) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro-oases")


def cache_path(fingerprint: Optional[str] = None) -> str:
    fp = fingerprint or host_fingerprint()
    safe = "".join(c if (c.isalnum() or c in "._-") else "_" for c in fp)
    # "torchcal-": never the JAX package's "hwcal-" file in the same dir
    return os.path.join(cache_dir(), f"torchcal-{safe}.json")


def _load(path: str, fingerprint: str) -> Optional[Dict[str, float]]:
    try:
        with open(path) as f:
            rec = json.load(f)
        if rec.get("fingerprint") != fingerprint:
            return None
        fields = rec.get("fields")
        return dict(fields) if isinstance(fields, dict) else None
    except (OSError, ValueError):
        return None


def _store(path: str, fingerprint: str, fields: Dict[str, float]) -> None:
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"fingerprint": fingerprint, "time": time.time(),
                       "fields": fields}, f, indent=1)
        os.replace(tmp, path)       # atomic: concurrent runs never tear
    except OSError:
        pass                        # cache is an optimization, not a need


def _merge(fields: Dict[str, float], overrides) -> HWConfig:
    merged = {**fields, **overrides}
    if merged.get("node_size") and merged.get("n_chips"):
        merged["node_size"] = min(int(merged["node_size"]),
                                  int(merged["n_chips"]))
    return HWConfig(**merged)


def fixture_hw(**overrides) -> HWConfig:
    """The :data:`~repro_torch.core.planner.costmodel.H100_80GB_HBM3`
    fixture under ``overrides`` (``node_size`` clamped to ``n_chips``),
    with no measurement: ``--no-calibrate``."""
    return _merge(dataclasses.asdict(H100_80GB_HBM3), overrides)


def calibrated_hw(*, cache: bool = True, max_devices: int = 8,
                  repeats: int = 5, **overrides) -> HWConfig:
    """A measurement-calibrated :class:`HWConfig` for this host, cached.

    ``overrides`` win over (cached or fresh) measurements and are applied
    at load time.  With ``REPRO_NO_CALIBRATE`` set the measurements are
    skipped entirely and the overrides configure the H100 fixture
    (:func:`fixture_hw`; JAX configures its stock TPU ``HWConfig``) — the
    launcher's ``--no-calibrate`` equivalent for environments where even
    a cached profile is unwanted.
    """
    if os.environ.get(_ENV_DISABLE):
        return fixture_hw(**overrides)
    fp = host_fingerprint()
    fields = _MEM_CACHE.get(fp) if cache else None
    if fields is None and cache:
        fields = _load(cache_path(fp), fp)
    if fields is None:
        fields = HWConfig.measure_fields(max_devices=max_devices,
                                         repeats=repeats)
        if cache:
            _store(cache_path(fp), fp, fields)
    if cache:
        _MEM_CACHE[fp] = dict(fields)
    return _merge(fields, overrides)


def describe(hw: HWConfig) -> Dict[str, object]:
    """Loggable view of a calibrated config (floats rounded to 3 s.f.)."""
    out = {}
    for k, v in dataclasses.asdict(hw).items():
        out[k] = float(f"{v:.3g}") if isinstance(v, float) else v
    return out
