"""Runtime overlap-efficiency probe (the port's copy of
``repro.obs.probe``, on the port's cost model: the same arithmetic).

The paper's speedup claim is "TMP communication hides under compute";
the planner *predicts* how much hides (``costmodel.overlapped_time`` and
the per-schedule exposed-cost terms of ``estimate_iteration``); this
probe measures it online:

1. :func:`plan_group_model` mirrors the cost model's per-schedule pass
   formulas per executable layer group (``models/params.plan_groups``,
   the groups the trainer runs a per-layer plan in), yielding per-group
   compute
   seconds, physical collective seconds, and the *predicted* exposed-
   communication fraction.
2. :class:`OverlapProbe.report` takes a *measured* iteration time (the
   trainer's median step wall time), subtracts the modeled compute floor
   to get the measured exposed-communication total, attributes it to
   groups by their collective-seconds share, and emits per-group
   ``overlap.group`` events carrying measured vs predicted exposed
   fraction and the residual against the calibrated model's prediction.
3. Residual drift beyond ``stale_threshold`` emits a
   ``calibration_stale`` event pointing at the per-host calibration
   cache (``core/planner/calibrate.py``) — AMP's observation that cost
   models drift per cluster, checked at the end of every run with a
   telemetry sink.

The group model covers the layer stack (the planner's Eq. 3 domain);
embedding/head/edge costs live in the residual by construction, which is
why the stale threshold defaults loose — the signal is *drift*, not
absolute agreement.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.recorder import NULL


@dataclass(frozen=True)
class GroupModel:
    """Modeled per-layer-group quantities (whole iteration: fwd + bwd)."""
    label: str                  # e.g. "g0:attn[8/oases]x12"
    kind: str
    schedule: str
    degree: object              # int | (dx, dy)
    layers: int
    compute_s: float            # modeled compute floor (comm fully hidden)
    comm_s: float               # physical collective seconds (all passes)
    predicted_s: float          # schedule-aware predicted group time

    @property
    def predicted_exposed_s(self) -> float:
        return max(self.predicted_s - self.compute_s, 0.0)

    @property
    def predicted_exposed_frac(self) -> float:
        return self.predicted_exposed_s / self.comm_s if self.comm_s else 0.0


def _group_pass(items, split: int, dkey: str, ckey: str, cykey: str) -> float:
    """One pass (fwd or bwd) over a group's blocks — the same per-schedule
    branches as ``costmodel.estimate_iteration``'s pass_time, with the
    trailing overlap-run cool-down exposed at the group boundary (the
    conservatism grouped execution actually shows at transitions)."""
    from repro_torch.core.planner import costmodel as cm
    total = 0.0
    prev_c = 0.0
    for nc, degree, sched in items:
        d = getattr(nc, dkey)[0]
        c = getattr(nc, ckey)[0]
        if split > 1 and sched in ("oases", "merak"):
            total += max(d, prev_c) + max(d, c)
            prev_c = c
        elif sched == "fused":
            dx, _dy = cm._dxy(degree)
            c_y = getattr(nc, cykey)[0]
            total += prev_c
            total += cm.overlapped_time_2d(split * d, split * (c - c_y),
                                           split * c_y, dx - 1)
            prev_c = 0.0
        elif sched == "wang":
            total += prev_c
            prev_c = 0.0
            total += split * d + c / max(split * 2, 1) + c * 0.1
        else:
            total += prev_c
            total += split * d + split * c
            prev_c = 0.0
    return total + prev_c


def plan_group_model(cfg, shape, hp, hw, degrees: Sequence,
                     schedules: Optional[Sequence[str]] = None
                     ) -> List[GroupModel]:
    """Per-executable-layer-group cost decomposition of a concrete plan.

    ``degrees`` must be concrete (the caller resolves mesh-following
    ``None`` entries to the mesh's model-group size before probing)."""
    from repro_torch.core.planner import costmodel as cm
    from repro_torch.models import params as prm

    split = max(hp.split, 1)
    blocks = cm.layer_blocks(cfg, shape)
    scheds = (list(schedules) if schedules is not None
              else [hp.schedule] * cfg.num_layers)
    out: List[GroupModel] = []
    li = 0
    for gi, g in enumerate(prm.plan_groups(cfg, list(degrees), scheds)):
        items = []
        compute = comm = 0.0
        for layer in blocks[li:li + g.count]:
            for blk in layer:
                nc = cm.node_costs(cfg, blk, shape, hp, hw, [g.degree])
                items.append((nc, g.degree, g.schedule))
                compute += split * (nc.d_f[0] + nc.d_b[0])
                comm += split * (nc.c_f[0] + nc.c_b[0])
        li += g.count
        predicted = (_group_pass(items, split, "d_f", "c_f", "c_f_y")
                     + _group_pass(items, split, "d_b", "c_b", "c_b_y"))
        dxs = cm._dkey(g.degree)
        out.append(GroupModel(
            label=f"g{gi}:{g.kind}[{dxs}/{g.schedule}]x{g.count}",
            kind=g.kind, schedule=g.schedule, degree=g.degree,
            layers=g.count, compute_s=compute, comm_s=comm,
            predicted_s=predicted))
    return out


class OverlapProbe:
    """Measured-vs-modeled overlap accounting over a run's layer groups.

    ``stale_threshold``: relative model residual beyond which a
    ``calibration_stale`` event fires (default 0.5 — the group model
    deliberately excludes embedding/head/edge terms, so the useful signal
    is drift over time, not absolute agreement)."""

    def __init__(self, groups: Sequence[GroupModel], *,
                 stale_threshold: float = 0.5,
                 hw_note: str = ""):
        self.groups = list(groups)
        self.stale_threshold = stale_threshold
        self.hw_note = hw_note

    @classmethod
    def for_run(cls, cfg, shape, hp, hw, degrees,
                schedules=None, **kw) -> "OverlapProbe":
        return cls(plan_group_model(cfg, shape, hp, hw, degrees, schedules),
                   **kw)

    def report(self, measured_iter_s: float, recorder=None, *,
               step: Optional[int] = None) -> Dict:
        """Decompose one measured iteration time; emits telemetry through
        ``recorder`` (one ``overlap.group`` event per group, overall
        gauges, and ``calibration_stale`` on drift) and returns the
        decomposition for in-process consumers/tests."""
        rec = recorder if recorder is not None else NULL
        compute_t = sum(g.compute_s for g in self.groups)
        comm_t = sum(g.comm_s for g in self.groups)
        model_t = sum(g.predicted_s for g in self.groups)
        if comm_t <= 0.0 or model_t <= 0.0:
            rec.event("overlap.skip",
                      msg="[overlap] no collective communication in this "
                          "plan — probe has nothing to measure",
                      step=step)
            return {"groups": [], "skipped": "no-comm"}
        # the comm seconds the run failed to hide: measured time above the
        # modeled compute floor, clamped into [0, total collective time]
        exposed_t = min(max(measured_iter_s - compute_t, 0.0), comm_t)
        rows = []
        for g in self.groups:
            share = g.comm_s / comm_t
            meas_exposed = exposed_t * share
            meas_frac = meas_exposed / g.comm_s
            meas_s = g.compute_s + meas_exposed
            residual = (meas_s - g.predicted_s) / g.predicted_s \
                if g.predicted_s > 0 else 0.0
            row = {"group": g.label, "kind": g.kind,
                   "schedule": g.schedule, "layers": g.layers,
                   "compute_s": g.compute_s, "comm_s": g.comm_s,
                   "predicted_exposed_frac": g.predicted_exposed_frac,
                   "measured_exposed_frac": meas_frac,
                   "residual": residual}
            rows.append(row)
            rec.event("overlap.group", step=step, **{
                k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in row.items()})
        overall_meas_frac = exposed_t / comm_t
        overall_residual = (measured_iter_s - model_t) / model_t
        rec.gauge("overlap.measured_exposed_frac", overall_meas_frac,
                  step=step)
        rec.gauge("overlap.model_residual", overall_residual, step=step)
        stale = abs(overall_residual) > self.stale_threshold
        if stale:
            rec.event(
                "calibration_stale",
                msg=(f"[overlap] measured iteration {measured_iter_s*1e3:.1f}"
                     f" ms vs modeled {model_t*1e3:.1f} ms "
                     f"(residual {overall_residual:+.0%} > "
                     f"±{self.stale_threshold:.0%}) — the calibrated cost "
                     f"model looks stale for this host; re-run calibration "
                     f"(core/planner/calibrate.calibrated_hw; delete the "
                     f"torchcal cache under REPRO_CAL_CACHE or "
                     f"~/.cache/repro-oases)"
                     + (f" [{self.hw_note}]" if self.hw_note else "")),
                step=step, residual=round(overall_residual, 4),
                threshold=self.stale_threshold)
        return {"groups": rows,
                "measured_iter_s": measured_iter_s,
                "modeled_iter_s": model_t,
                "compute_s": compute_t, "comm_s": comm_t,
                "measured_exposed_frac": overall_meas_frac,
                "model_residual": overall_residual,
                "calibration_stale": stale}
