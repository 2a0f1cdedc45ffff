"""Training loop on one rank of a rank mesh (the core of
``repro.runtime.trainer``): weights, optimizer state, the step loop over
``make_batch``, straggler detection and structured telemetry
(:mod:`repro_torch.obs`: per-step records and, with a sink, the
end-of-run overlap probe).  Checkpointing, heartbeats, failure injection
and elastic re-meshing are not ported yet (ROADMAP.md A4; the elastic
runtime, A11)."""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch import obs
from repro_torch.configs.base import ArchConfig, ShapeConfig, TrainHParams
from repro_torch.core.comm import Comm, SoloComm
from repro_torch.core.plan import ParallelPlan
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import steps as steps_mod
from repro_torch.models import params as prm
from repro_torch.optim import adamw


@dataclass
class StragglerDetector:
    alpha: float = 0.1
    z_threshold: float = 3.0
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    warmup: int = 5                  # steps before the z-test arms
    slow_steps: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        if self.n >= self.warmup:
            sd = math.sqrt(self.var) if self.var > 0 else 1e-9
            z = (dt - self.mean) / sd
            slow = z > self.z_threshold
        else:
            slow = False
        delta = dt - self.mean
        self.mean += self.alpha * delta
        self.var = (1 - self.alpha) * (self.var + self.alpha * delta * delta)
        self.n += 1
        if slow:
            self.slow_steps.append((step, dt))
        return slow


class Trainer:
    """``Trainer(cfg, hp, global_batch=, seq_len=)`` on the card (default;
    raises without one) or ``device="cpu"``.  ``params`` (whole weights,
    for example JAX's through :func:`repro_torch.models.params.from_flat`)
    are moved to the device; without them :meth:`train` draws whole
    weights from its seed.  ``comm``: this rank's communicators (a
    :class:`~repro_torch.core.comm.MeshComm`, or one 1-D model group's
    Comm; None: one rank); the trainer keeps this rank's shard of the
    weights in the step's layout (the attention weights whole under ring
    attention, ``hp.seq_shard``; a per-layer plan's groups), and only
    rank 0 logs.  ``plan``: the executable
    :class:`~repro_torch.core.plan.ParallelPlan` to train under (JAX's
    ``Trainer(plan=...)``): checked against the mesh and projected onto
    ``hp`` and its per-layer degrees and schedules
    (:func:`~repro_torch.launch.steps.unpack_plan`,
    :func:`~repro_torch.launch.steps.plan_layers`), refusing what the
    port cannot run.

    ``telemetry``: the :mod:`repro_torch.obs` recorder (JAX's default: an
    in-memory ``Recorder`` whose console is ``log_fn``, so the familiar
    ``[trainer]`` lines keep printing; ``obs.NULL`` disables it, a
    JSONL-sinking ``Recorder`` persists the run and turns on the
    end-of-run overlap probe).  ``probe_hw``: the probe's
    :class:`~repro_torch.core.planner.costmodel.HWConfig` (None:
    ``calibrated_hw`` for the group, as JAX's trainer; a launcher whose
    ranks share a card resolves it before they start)."""

    def __init__(self, cfg: ArchConfig, hp: TrainHParams, *,
                 global_batch: int, seq_len: int,
                 device: Optional[Union[str, torch.device]] = None,
                 params: Optional[Dict[str, Any]] = None,
                 log_fn: Optional[Callable[[str], None]] = print,
                 comm: Optional[Comm] = None,
                 plan: Optional[ParallelPlan] = None,
                 telemetry=None, probe_hw=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.comm = comm or SoloComm()
        degrees = schedules = None
        if plan is not None:
            steps_mod.check_plan(cfg, plan, steps_mod.plan_mesh(self.comm))
            degrees, schedules, _, hp = steps_mod.plan_layers(cfg, hp, plan)
        self.plan = plan
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.log = log_fn if self.comm.rank == 0 else None
        self.rec = (telemetry if telemetry is not None
                    else obs.Recorder(console=self.log))
        self.probe_hw = probe_hw
        self.straggler = StragglerDetector()
        self.step_fn = steps_mod.build_train_step(
            cfg, hp, global_batch=global_batch, seq_len=seq_len,
            comm=self.comm, degrees=degrees, schedules=schedules)
        self.hp = self.step_fn.hp
        self.params = None if params is None else self._own(params)
        self.opt_state: Optional[Dict[str, Any]] = None

    def _own(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's shard of the whole (stacked) weights in the step's
        layout (``ModelLayout.shard``) on this trainer's device, as
        trainable leaves."""
        shard = self.step_fn.layout.shard(params, self.comm.rank)
        return prm.unflatten({k: t.to(self.device).requires_grad_()
                              for k, t in prm.flatten(shard).items()})

    def ctx_shape(self):
        """[B, context_len, context_dim or d_model] of a cross-attention
        config's stub context (JAX's ``trainer.py:431-435``), else None."""
        cfg = self.cfg
        if not cfg.context_len:
            return None
        return (self.global_batch, cfg.context_len,
                cfg.context_dim or cfg.d_model)

    def batch(self, dcfg: DataConfig, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in make_batch(dcfg, step,
                                       self.ctx_shape()).items()}

    def _overlap_report(self, step: int):
        """End-of-run overlap-efficiency probe (:mod:`repro_torch.obs.
        probe`): decompose the median measured step time against the
        calibrated cost model's per-layer-group prediction and emit
        overlap.group / residual / calibration_stale telemetry.  Only runs
        when the recorder has a JSONL sink (``--telemetry``): on a cache
        miss ``calibrated_hw`` times the card, a cost the default
        in-memory recorder must never pay."""
        if getattr(self.rec, "out_dir", None) is None:
            return
        h = getattr(self.rec, "hists", {}).get("trainer.step_time_s")
        if not h or len(h) < 2:
            return
        xs = sorted(list(h)[1:])        # drop the first (build) step
        med = xs[len(xs) // 2]
        try:
            from repro_torch.core.planner.calibrate import (calibrated_hw,
                                                            describe)
            hw = (self.probe_hw if self.probe_hw is not None
                  else calibrated_hw(n_chips=max(self.comm.size, 1)))
            plan = self.plan or ParallelPlan.from_hparams(
                self.hp, self.cfg.num_layers)
            base = self.step_fn.ctx      # None: the whole model group
            whole = (base.tp, base.tp_y) if base.is_2d else base.tp_total
            degrees = [whole if d is None else d for d in plan.degrees]
            probe = obs.OverlapProbe.for_run(
                self.cfg, ShapeConfig("probe", self.seq_len,
                                      self.global_batch, "train"),
                self.hp, hw, degrees, list(plan.schedules),
                hw_note=describe(hw))
            probe.report(med, self.rec, step=step)
        except Exception as e:   # the probe must never kill a finished run
            self.rec.event("overlap.error",
                           msg=f"[overlap] probe failed: {e!r}")

    def train(self, total_steps: int, *, seed: int = 0) -> Dict:
        """Run steps ``[done, total_steps)``; returns ``final_step``, the
        per-step ``losses`` and ``step_times`` (s, host clock around a step
        that ends when its loss reaches the host), ``slow_steps`` and, on
        the card, ``device_step_ms`` (CUDA events around each step)."""
        if self.params is None:
            self.params = self._own(
                prm.init_params(self.cfg, seed=seed, device=self.device,
                                max_pos=self.seq_len))
        if self.opt_state is None:
            self.opt_state = adamw.init_opt_state(self.params)
        dcfg = DataConfig(global_batch=self.global_batch,
                          seq_len=self.seq_len,
                          vocab_size=self.cfg.vocab_size,
                          microbatch=self.hp.microbatch)
        losses, step_times, device_ms = [], [], []
        cuda = self.device.type == "cuda"
        step = start = self.opt_state["step"]
        try:
            for step in range(start, total_steps):
                batch = self.batch(dcfg, step)
                if cuda:
                    events = [torch.cuda.Event(enable_timing=True)
                              for _ in range(2)]
                    events[0].record()
                t0 = time.perf_counter()
                with obs.trace_annotation("train_step"):
                    metrics = self.step_fn(self.params, self.opt_state,
                                           batch)
                    if cuda:
                        events[1].record()
                    loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                if cuda:
                    device_ms.append(events[0].elapsed_time(events[1]))
                self.comm.check()
                self.rec.observe("trainer.step_time_s", dt, step=step)
                self.rec.gauge("trainer.tokens_per_s",
                               self.global_batch * self.seq_len / dt,
                               step=step)
                self.rec.gauge("trainer.loss", loss, step=step)
                if self.straggler.observe(step, dt):
                    self.rec.event(
                        "trainer.straggler", step=step,
                        dt_s=round(dt, 4),
                        ewma_s=round(self.straggler.mean, 4),
                        msg=f"[straggler] step {step} took {dt:.2f}s "
                            f"(ewma {self.straggler.mean:.2f}s)")
                losses.append(loss)
                step_times.append(dt)
                if step % 10 == 0:
                    self.rec.event(
                        "trainer.step", step=step,
                        msg=f"[trainer] step {step} loss {loss:.4f} "
                            f"{dt * 1e3:.0f} ms")
            self._overlap_report(step)
        finally:
            self.rec.flush()
        out = {"final_step": self.opt_state["step"], "losses": losses,
               "slow_steps": self.straggler.slow_steps,
               "step_times": step_times}
        if cuda:
            out["device_step_ms"] = device_ms
        return out
