"""Dry run of one (arch x shape) cell: the port's counterpart of
``repro.launch.dryrun``.

JAX's dry run compiles a cell on 512 placeholder devices and walks the
compiled HLO.  The port has no HLO: it builds rank 0's training step
(``launch/steps.build_train_step``) on the cell's rank mesh
(``launch/mesh.resolve_launch``) with a :class:`~repro_torch.core.comm.
MeshComm` of counting communicators, no process spawned, and traces one
step on fake tensors (``launch/hlo_cost.py``): nothing is allocated on a
card or in host memory, so the trace is not a CPU run of the main path.
The record has JAX's keys and roofline terms, with the H100 SXM's
data-sheet rates, apart from two keys that name a tool or a chip:
``xla_cost`` is ``torch_cost`` (``FlopCounterMode``'s total with the
kernel units' work added, the cross-check of the counter:
:func:`torch_cost`) and ``mem.fits_16GB`` is ``mem.fits_80GB``.

``python -m repro_torch.launch.dryrun --arch gpt-h2048 --shape train_4k
--mesh-shape 1x2 --no-calibrate --out d.jsonl`` writes one record;
``--sweep`` runs every cell of the port's archs in subprocesses.
Refused, each naming its ROADMAP.md item (``launch/steps._refusal``):
a mesh with a ``data`` axis above 1 (A4; JAX's default 16 x 16 ``single``
mesh is one, so the port runs its model group, ``1x16``, and says so in
``mesh_shape``), ``--pp`` or ``--virtual-stages`` above 1 (A8), the
``prefill_32k`` and ``decode_32k`` shapes (A5: the dry run traces the
training step only, not ``lm.prefill`` or the decode step) and per-layer
seqs (A9).  ``--calibrate``, the default as in
JAX, measures the card for the joint plan; without one it raises, and the
caller passes ``--no-calibrate``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import (CROSS_ATTN, GLOBAL_ATTN, LOCAL_ATTN,
                                      RGLRU, SHAPES, SSD, ArchConfig,
                                      ShapeConfig, TrainHParams)
from repro_torch.configs.registry import ASSIGNED, get_config
from repro_torch.core.axes import RankMesh, mesh_info
from repro_torch.core.comm import trace_mesh
from repro_torch.launch import hlo_cost
from repro_torch.launch.mesh import resolve_launch
from repro_torch.launch.steps import (_refusal, build_train_step,
                                      check_plan, plan_layers, resolve_hp)

# H100 SXM5 data-sheet figures (NVIDIA H100 Tensor Core GPU datasheet,
# SXM column); the roofline's rates, not a measurement
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s
PEAK_FLOPS_BY_DTYPE = {"bf16": 989e12, "f16": 989e12,
                       "f32": 67e12,   # FP32 (cuBLAS without TF32)
                       "f64": 67e12}   # FP64 tensor core
HBM_BW = 3.35e12             # bytes/s, HBM3
LINK_BW = 450e9              # bytes/s, NVLink 4 each direction (900 GB/s both)
HBM_CAP = 80e9               # bytes


def sub_quadratic(cfg: ArchConfig) -> bool:
    """No layer is global attention (JAX's ``ArchConfig.sub_quadratic``)."""
    return all(k in (RGLRU, SSD, LOCAL_ATTN) for k in cfg.layer_pattern)


def applicable_shapes(cfg: ArchConfig):
    """JAX's ``applicable_shapes``: long_500k needs sub-quadratic layers."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if sub_quadratic(cfg):
        out.append(SHAPES["long_500k"])
    return out


def param_count(cfg: ArchConfig) -> int:
    """JAX's ``ArchConfig.param_count`` (the 6ND model flops' N)."""
    hd, d = cfg.resolved_head_dim, cfg.d_model
    per_layer = 0
    for kind in cfg.layer_pattern:
        p = 2 * d
        if kind in (GLOBAL_ATTN, LOCAL_ATTN, CROSS_ATTN):
            p += (d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
                  + cfg.num_heads * hd * d)
            if kind == CROSS_ATTN:
                p *= 2
        elif kind == RGLRU:
            w = cfg.rglru_width or d
            p += 2 * d * w + w * d + 3 * w + 2 * w * cfg.window // cfg.window
        elif kind == SSD:
            dinner = cfg.ssm_expand * d
            nheads = dinner // cfg.ssm_headdim
            p += d * (2 * dinner + 2 * cfg.ssm_state + nheads)
            p += dinner * d + dinner + 2 * cfg.ssm_state
        if cfg.moe is not None:
            p += d * cfg.moe.num_experts + cfg.moe.num_experts * 3 * d \
                * cfg.d_ff
        elif kind != SSD or cfg.d_ff:
            p += 3 * d * cfg.d_ff
        per_layer += p
    total = round(cfg.num_layers * per_layer / len(cfg.layer_pattern))
    total += cfg.padded_vocab() * d
    if not cfg.tie_embeddings:
        total += cfg.padded_vocab() * d
    if cfg.encoder_layers:
        enc = 2 * d + 2 * (d * cfg.num_heads * hd + d * cfg.num_kv_heads * hd)
        enc += cfg.num_heads * hd * d + 3 * d * cfg.d_ff
        total += cfg.encoder_layers * enc
    return int(total)


def active_param_count(cfg: ArchConfig) -> int:
    """Active params per token (MoE: top_k of num_experts)."""
    full = param_count(cfg)
    if cfg.moe is None:
        return full
    per = cfg.num_layers * 3 * cfg.d_model * cfg.d_ff
    return int(full - per * cfg.moe.num_experts + per * cfg.moe.top_k)


def model_flops_per_chip(cfg, shape, n_chips: int) -> float:
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n_active * tokens          # fwd + bwd
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n_active * tokens
    else:                                        # decode: one token per seq
        total = 2.0 * n_active * shape.global_batch
    return total / n_chips


def parse_degrees(spec: str):
    """'8,4x2,16' -> [8, (4, 2), 16] (validated; see launch/mesh.py)."""
    from repro_torch.launch.mesh import parse_degrees as _parse
    return _parse(spec)


def terms_s(hc: hlo_cost.HloCost) -> Dict[str, float]:
    """JAX's three roofline terms; the products at each dtype's peak (the
    port's f32 head runs on the CUDA cores, not at the bf16 rate)."""
    by = hc.dot_by_dtype or {"bf16": hc.dot_flops}
    return {"compute_s": sum(v / PEAK_FLOPS_BY_DTYPE.get(k, PEAK_FLOPS)
                             for k, v in by.items()),
            "memory_s": hc.hbm_bytes / HBM_BW,
            "collective_s": hc.collective_link_bytes / LINK_BW}


def torch_cost(hc: hlo_cost.HloCost) -> Dict:
    """JAX's ``xla_cost`` over the whole step, from a trace without
    ``plain`` (:func:`trace_step`'s default).  ``FlopCounterMode`` does
    not see inside a kernel unit (the trace returns the unit's outputs
    unfilled), so the units' ``bounds.py`` work (``kernel_units``) is added
    to its count of the rest: ``flops`` equals ``hlo.dot_flops`` when the
    two agree on every product outside the units.  No independent byte
    count exists: ``bytes accessed`` is the counter's, ops outside the
    units plus the units' work."""
    unit_dot = sum(u.get("dot", 0.0) for u in hc.units.values())
    unit_bytes = sum(u.get("bytes", 0.0) for u in hc.units.values())
    return {"flops": hc.torch_flops + unit_dot,
            "bytes accessed": hc.plain_hbm_bytes + unit_bytes,
            "kernel_units": {"flops": unit_dot, "bytes accessed": unit_bytes}}


def _fake_state(cfg: ArchConfig, layout, rank: int, batch_shape):
    """This rank's params (its shards of zero weights), AdamW state and an
    int32 batch, made as fake tensors under the running tracer."""
    from repro_torch.models import params as prm
    from repro_torch.optim import adamw
    wdt = prm.DTYPES[cfg.dtype]
    whole = {k: torch.zeros(s.shape, dtype=torch.float32 if s.f32 else wdt)
             for k, s in prm.model_specs(cfg).items()}
    shard = layout.shard(prm.unflatten(whole), rank)
    params = prm.unflatten({k: t.clone().requires_grad_()
                            for k, t in prm.flatten(shard).items()})
    opt = adamw.init_opt_state(params)
    batch = {k: torch.zeros(batch_shape, dtype=torch.int32)
             for k in ("tokens", "labels")}
    return params, opt, batch


def trace_step(cfg: ArchConfig, hp: TrainHParams, *, global_batch: int,
               seq_len: int, mesh: RankMesh, rank: int = 0, degrees=None,
               schedules=None, plain: bool = False,
               extrapolate: bool = True) -> Tuple[hlo_cost.HloCost, object]:
    """-> (HloCost, the step function) of one training step of rank
    ``rank`` of ``mesh``.  With ``extrapolate`` and more than three
    microbatches, three are traced and the counts extrapolated
    (:meth:`~repro_torch.launch.hlo_cost.Tracer.run`); the batch argument
    is whole either way."""
    from repro_torch.models import lm
    info = mesh_info(mesh)
    hp = resolve_hp(hp, global_batch, seq_len=seq_len, d_model=cfg.d_model,
                    num_layers=cfg.num_layers, tp=info.tp)
    n = max(hp.microbatch, 1)
    n_trace = 3 if extrapolate and n > 3 else n
    with hlo_cost.Tracer(default_group=info.tp, plain=plain) as tr:
        comm = trace_mesh(mesh, rank, hlo_cost.record) \
            if mesh.size > 1 else None
        step = build_train_step(
            cfg, dataclasses.replace(hp, microbatch=n_trace),
            global_batch=global_batch // n * n_trace, seq_len=seq_len,
            comm=comm, degrees=degrees, schedules=schedules)
        shape = ((n, global_batch // n, seq_len) if n > 1
                 else (global_batch, seq_len))
        params, opt, batch = _fake_state(cfg, step.layout, rank, shape)
        tr.run(step, params, opt, batch,
               micro=(lm, "train_loss", n) if n_trace != n else None)
    step.hp = hp
    return tr.cost(), step


def run_cell(arch: Union[str, ArchConfig],
             shape_name: Union[str, ShapeConfig], *, multi_pod: bool = False,
             schedule: str = "oases", fine_remat: bool = True,
             planner_degrees=None, seq_parallel: bool = False,
             seq_shard: int = 1,
             split: int = 2, microbatch: int = 0,
             mesh_shape: str = "", tmp_layout: str = "auto",
             pp: int = 1, virtual_stages: int = 1, hw=None,
             plan_file: str = "", save_plan: str = "",
             plan_only: bool = False, remat: bool = True,
             rank: int = 0) -> dict:
    """JAX's ``run_cell`` for rank ``rank`` of the cell's rank mesh.
    ``arch`` and ``shape_name`` may be an ArchConfig (a depth cut) and a
    ShapeConfig (a measured cell's batch and sequence); ``remat`` False
    turns recomputation off (JAX's dry run always recomputes)."""
    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES[shape_name])
    rec = {
        "arch": cfg.name, "shape": shape.name,
        "mesh": "multi" if multi_pod else "single",
        "schedule": schedule, "fine_remat": fine_remat,
        "planner": planner_degrees is not None,
        "tmp_layout": tmp_layout, "pp": pp,
    }
    if shape.name in SHAPES and shape.name not in {
            s.name for s in applicable_shapes(cfg)}:
        rec["status"] = "SKIP"
        rec["reason"] = ("full-attention arch: long_500k requires "
                         "sub-quadratic attention (DESIGN.md)")
        return rec
    if cfg.is_encdec or CROSS_ATTN in cfg.layer_pattern:
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port's dry run does not trace "
            f"encoders or cross attention yet: no stub context enters the "
            f"traced step (ROADMAP.md A10b, the dry run of encoder and "
            f"cross-attention archs)")

    t0 = time.perf_counter()
    hp = TrainHParams(schedule=schedule, remat=remat, fine_remat=fine_remat,
                      seq_parallel=seq_parallel, seq_shard=seq_shard,
                      split=split, microbatch=microbatch,
                      tmp_layout=tmp_layout)
    # JAX's 16 x 16 single mesh has 16 data ranks (A4): the port runs its
    # model group; the multi-pod mesh adds a pod axis of data ranks
    if multi_pod:
        mesh_shape = mesh_shape or "2x16"
    spec = mesh_shape or ("factored" if planner_degrees else "1x16")
    tp = 16 if spec == "factored" else 1
    mesh, pplan = resolve_launch(cfg, hp, mesh=spec, tp=tp,
                                 plan_file=plan_file)
    if (planner_degrees is not None or pp > 1) and not plan_file:
        from repro_torch.core.plan import ParallelPlan
        pplan = ParallelPlan.from_hparams(
            hp, cfg.num_layers, degrees=planner_degrees, pp=pp,
            mesh_shape=mesh.shape, mesh_axes=mesh.axis_names)
    rec["mesh_shape"] = "x".join(map(str, mesh.shape))
    rec["plan"] = pplan.summary()
    if save_plan:
        pplan.save(save_plan)
        print(f"[plan] wrote {save_plan}: {pplan.summary()}")
    rec["microbatch"] = microbatch
    if plan_only:
        rec["status"] = "PLAN_ONLY"
        rec["n_chips"] = mesh.size
        return rec
    refuse = _refusal(pplan, mesh)
    if pp > 1:
        refuse(f"pp={pp} pipeline stages", "A8")
    if virtual_stages > 1:
        refuse(f"{virtual_stages} virtual pipeline stages", "A8")
    if shape.kind != "train":
        refuse(f"the {shape.name} shape: the dry run traces the training "
               f"step only, not the prefill or the decode step", "A5")
    check_plan(cfg, pplan, mesh)
    degrees, schedules, _, hp = plan_layers(cfg, hp, pplan)
    if hw is not None:
        # profile-guided planning: the calibrated card's joint PP x TMP
        # search, recorded beside the traced terms of this cell
        from repro_torch.core.planner.ilp import plan_joint
        jp = plan_joint(cfg, shape, hp, hw, virtual_stages=virtual_stages)
        rec["calibrated_joint_plan"] = {
            "pp": jp.pp, "n_micro": jp.n_micro,
            "degrees": [list(d) if isinstance(d, tuple) else d
                        for d in jp.degrees],
            "predicted_ms": round(jp.predicted_s * 1e3, 3),
            "bubble_fraction": round(jp.bubble_fraction, 4),
        }
        print(f"calibrated joint plan: {jp.summary()}")
    t_lower = time.perf_counter() - t0
    hc, step = trace_step(cfg, hp, global_batch=shape.global_batch,
                          seq_len=shape.seq_len, mesh=mesh, rank=rank,
                          degrees=degrees, schedules=schedules)
    t_compile = time.perf_counter() - t0 - t_lower
    rec["microbatch"] = step.hp.microbatch

    n_chips = mesh.size
    terms = terms_s(hc)
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_chip(cfg, shape, n_chips)
    m = hc.mem
    arg_b, tmp_b = m["argument_bytes"], m["temp_bytes"]
    out_b, alias_b = m["output_bytes"], m["alias_bytes"]
    rec.update({
        "status": "OK",
        "n_chips": n_chips,
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_compile, 1),
        "mem": {"argument_bytes": arg_b, "temp_bytes": tmp_b,
                "output_bytes": out_b, "alias_bytes": alias_b,
                "peak_est_bytes": arg_b + tmp_b + out_b - alias_b,
                "fits_80GB": bool(arg_b + tmp_b + out_b - alias_b < HBM_CAP)},
        "torch_cost": torch_cost(hc),
        "hlo": hc.to_dict(),
        "terms_s": terms,
        "dominant": dominant,
        "model_flops_per_chip": mf,
        "useful_flops_ratio": mf / hc.dot_flops if hc.dot_flops else 0.0,
        "roofline_fraction": (
            mf / PEAK_FLOPS) / max(terms.values()) if max(terms.values()) else 0.0,
    })
    return rec


def _sweep(args):
    cells = []
    archs = args.arch.split(",") if args.arch else ASSIGNED
    shapes = args.shape.split(",") if args.shape else list(SHAPES)
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])
    for a in archs:
        for s in shapes:
            for m in meshes:
                cells.append((a, s, m))
    done = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done[(r["arch"], r["shape"], r["mesh"],
                          r.get("schedule", "oases"))] = r
                except json.JSONDecodeError:
                    pass
    for a, s, m in cells:
        key = (a, s, m, args.schedule)
        if key in done and done[key].get("status") in ("OK", "SKIP") \
                and not args.force:
            print(f"[cached] {key} {done[key]['status']}")
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", a, "--shape", s, "--mesh", m,
               "--schedule", args.schedule, "--out", args.out]
        if not args.fine_remat:
            cmd.append("--no-fine-remat")
        if not args.calibrate:
            cmd.append("--no-calibrate")
        print(f"[run] {a} x {s} x {m} ...", flush=True)
        t0 = time.perf_counter()
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
            tail = (p.stdout + p.stderr).strip().splitlines()[-3:]
            print(f"   -> rc={p.returncode} {time.perf_counter()-t0:.0f}s "
                  + (" | ".join(tail) if p.returncode else ""), flush=True)
            if p.returncode:
                with open(args.out, "a") as f:
                    f.write(json.dumps({
                        "arch": a, "shape": s, "mesh": m,
                        "schedule": args.schedule, "status": "ERROR",
                        "error": "\n".join(tail)}) + "\n")
        except subprocess.TimeoutExpired:
            print("   -> TIMEOUT", flush=True)
            with open(args.out, "a") as f:
                f.write(json.dumps({
                    "arch": a, "shape": s, "mesh": m,
                    "schedule": args.schedule, "status": "TIMEOUT"}) + "\n")


def calibrated_card_hw():
    """The calibrated HWConfig of the card (``--calibrate``); raises
    without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("--calibrate measures the card and no CUDA device "
                           "is present: pass --no-calibrate")
    from repro_torch.core.planner.calibrate import calibrated_hw, describe
    hw = calibrated_hw()
    print("calibrated HWConfig (profile-guided planner inputs):")
    print(json.dumps(describe(hw), indent=1))
    return hw


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description="dry run of one rank's step")
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--schedule", default="oases")
    ap.add_argument("--no-fine-remat", dest="fine_remat", action="store_false")
    ap.add_argument("--split", type=int, default=2)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--seq-shard", type=int, default=1,
                    help="ring-attention sequence shards per attention "
                         "layer (must equal the model group size)")
    ap.add_argument("--degrees", default="",
                    help="comma-separated per-layer TMP degrees (planner "
                         "mode); 'AxB' entries are 2D, e.g. 8,4x2,16")
    ap.add_argument("--tmp-layout", default="auto",
                    choices=["auto", "1d", "2d"],
                    help="partition layout (1d classic / 2d hybrid / auto)")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="force the gradient-accumulation microbatch count "
                         "(0 = auto)")
    ap.add_argument("--mesh-shape", default="",
                    help="the rank mesh, e.g. 1x16 or 1x4x4 (default: the "
                         "model group of JAX's 16 x 16 mesh, 1x16)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline-parallel stages (refused: ROADMAP.md A8)")
    ap.add_argument("--virtual-stages", type=int, default=1,
                    help="interleaved-1F1B virtual stages (refused: A8)")
    ap.add_argument("--calibrate", action="store_true", default=True,
                    help="profile-guided planner inputs (the DEFAULT: the "
                         "card's calibrated HWConfig; needs a card)")
    ap.add_argument("--no-calibrate", dest="calibrate",
                    action="store_false",
                    help="skip the card's calibration and the joint plan")
    ap.add_argument("--plan", default="", metavar="plan.json",
                    help="dry-run an executable ParallelPlan file "
                         "(overrides the legacy parallelism flags)")
    ap.add_argument("--save-plan", default="", metavar="out.json",
                    help="write the resolved ParallelPlan for later "
                         "--plan runs")
    ap.add_argument("--plan-only", action="store_true",
                    help="resolve the mesh + plan (and --save-plan/"
                         "--plan round-trip) without tracing")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--out", default="results/dryrun.jsonl")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    if args.sweep:
        _sweep(args)
        return

    hw_cal = None
    if args.calibrate and not args.plan_only:
        hw_cal = calibrated_card_hw()

    degrees = parse_degrees(args.degrees) if args.degrees else None
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])
    for m in meshes:
        try:
            rec = run_cell(args.arch, args.shape, multi_pod=(m == "multi"),
                           schedule=args.schedule, fine_remat=args.fine_remat,
                           planner_degrees=degrees, split=args.split,
                           seq_parallel=args.seq_parallel,
                           seq_shard=args.seq_shard,
                           microbatch=args.microbatch,
                           mesh_shape=args.mesh_shape,
                           tmp_layout=args.tmp_layout,
                           pp=args.pp,
                           virtual_stages=args.virtual_stages,
                           hw=hw_cal,
                           plan_file=args.plan, save_plan=args.save_plan,
                           plan_only=args.plan_only)
        except Exception:
            rec = {"arch": args.arch, "shape": args.shape, "mesh": m,
                   "schedule": args.schedule, "status": "ERROR",
                   "error": traceback.format_exc()[-2000:]}
            print(traceback.format_exc())
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps({k: rec[k] for k in rec
                          if k not in ("hlo", "torch_cost")}, indent=1))


if __name__ == "__main__":
    main()
