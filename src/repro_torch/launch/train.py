"""Training launcher of the PyTorch port: AdamW steps of one model on a
mesh of rank processes (``--mesh``, ``--tp``), on the card (default) or
the CPU.

    # on the GPU (builds the CUDA kernels at the first step)
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-h2048 \\
        --steps 8 --batch 8 --seq 1024 --microbatch 2

    # two ranks under the fused schedule (processes sharing one card)
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-h2048 \\
        --tp 2 --schedule fused --steps 4 --batch 8 --seq 1024 --microbatch 2

    # ring attention over two ranks (sequence sharded; implies SP)
    PYTHONPATH=src python -m repro_torch.launch.train --tp 2 --seq-shard 2 \\
        --steps 3 --batch 4 --seq 4096 --microbatch 2

    # CPU smoke with the plain PyTorch versions of the kernels
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 2 --tp 2 --schedule oases

    # a per-layer plan on the factored mesh (t1, t2) of four ranks: layers
    # at degree 4 and at degree 2 (whose two groups of two split the batch)
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 2 --tp 4 --mesh factored --plan p.json

    # the 2-D layout: heads and d_ff over model_x, d_model over model_y
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 2 --mesh 1x2x2 --tmp-layout 2d

    # the Oases planner: calibrate the card, solve the ILP for this
    # workload, train under the plan and write it; then replay the file
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-h2048 \\
        --steps 3 --batch 8 --seq 1024 --microbatch 2 --schedule megatron \\
        --no-remat --planner --save-plan plan.json
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-h2048 \\
        --steps 3 --batch 8 --seq 1024 --no-remat --plan plan.json

    # structured telemetry (JSONL) and its report
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 3 --tp 2 --telemetry tel
    PYTHONPATH=src python -m repro_torch.obs.report tel [--validate]

The mesh (:mod:`repro_torch.launch.mesh`) sets the ranks: ``auto`` is
the 1-D ``(1, --tp)`` mesh, ``factored`` splits ``--tp`` into binary
t-axes (per-layer degrees and 2-D degrees mix there), ``1xM`` and
``1xMxxMy`` are explicit 1-D and 2-D meshes (M or Mx x My ranks; ``--tp``
then 1 or that size), and a ``--plan`` file's recorded mesh is rebuilt.
With more than one rank the launcher spawns one process per rank
(:mod:`repro_torch.launch.ranks`): gloo on the CPU, the port's peer
collectives on the card, over each sub-group the plan uses.  Prints the
JSON of ``repro.launch.train`` (``final_step``, ``first_loss``,
``last_loss``, ``slow_steps``), from
rank 0, with the plan's summary (``plan``), the planner's prediction
(``predicted_ms``, under ``--planner``) and, on the card, each step's
device time (``device_step_ms``, CUDA events); :func:`main` returns it.

Every run executes a :class:`~repro_torch.core.plan.ParallelPlan`
(:func:`repro_torch.launch.mesh.resolve_launch`): the flags desugared,
a ``--plan`` file, or under ``--planner`` the ILP's decision
(:mod:`repro_torch.core.planner`), calibrated on the card by default
(``--no-calibrate``: the H100_80GB_HBM3 fixture; the CPU has no card to
calibrate).  The launcher resolves the plan once, in its own process,
before the ranks start, and hands it to every rank.  Plans mix
degrees (1-D up to the mesh's model group; 2-D ``(dx, dy)``) and
schedules per layer on one data rank (``launch/steps.py::check_plan``);
a ``data`` axis above 1, pipelines and per-layer ring-attention seqs
raise, naming ROADMAP.md A4, A8 and A9, and the MoE, SSD and RG-LRU
families at more than one rank A10c.  Under ``--planner`` on a mesh
that is not factored a plan of mixed degrees is printed and the uniform
layout trains (JAX's rule).  Sequence parallelism without ring attention
is reachable through ``TrainHParams(seq_parallel=True)`` (JAX's CLI has
no flag for it either).

``--telemetry DIR`` appends the run's records to ``DIR/telemetry.jsonl``
(:mod:`repro_torch.obs`): the planner's, written by the launcher's
process and flushed before any rank starts, then rank 0's (the trainer's
per-step records and the end-of-run overlap probe); ranks above 0 record
in memory only, and no two processes hold the file open at once.  The
probe's hardware is resolved once here, as ``--planner``'s: calibrated
on the card (cached per host) or, under ``--no-calibrate``, the fixture.
Data parallelism, pipelines, checkpoints and fault injection are not
offered yet.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch


def _train(comm, device, args, cfg, hp, plan, probe_hw=None) -> dict:
    """One rank's run (the whole run at tp=1) under the resolved plan.
    With ``--telemetry`` the run records into the launcher's recorder at
    tp=1 and into rank 0's own, appending to the same file, at tp > 1
    (the launcher closed its file before the ranks started)."""
    from repro_torch import obs
    from repro_torch.runtime import Trainer

    # f32 products stay full f32 on the card (no TF32), as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    telemetry = None
    if args.telemetry and comm is None:
        telemetry = obs.get_recorder()
    elif args.telemetry and comm.rank == 0:
        telemetry = obs.configure(args.telemetry,
                                  flush_every=args.telemetry_flush,
                                  console=print)
    trainer = Trainer(cfg, hp, global_batch=args.batch, seq_len=args.seq,
                      device=device, comm=comm, plan=plan,
                      telemetry=telemetry, probe_hw=probe_hw)
    try:
        res = trainer.train(args.steps, seed=args.seed)
    finally:
        if telemetry is not None and comm is not None:
            telemetry.close()
    out = {"final_step": res["final_step"],
           "first_loss": res["losses"][0], "last_loss": res["losses"][-1],
           "slow_steps": len(res["slow_steps"])}
    if "device_step_ms" in res:
        out["device_step_ms"] = res["device_step_ms"]
    return out


def _planner_hw(args, n: int):
    """The planner's HWConfig for ``n`` ranks: calibrated on the card
    (cached per host), or the H100_80GB_HBM3 fixture under
    ``--no-calibrate``.  Either way the link terms are the fixture's."""
    from repro_torch.core.planner.calibrate import (calibrated_hw, describe,
                                                    fixture_hw)
    if args.calibrate:
        hw = calibrated_hw(n_chips=n)
        print(f"planner: calibrated hw {describe(hw)}; link terms from "
              f"H100_80GB_HBM3 (one card has no link to measure)")
    else:
        hw = fixture_hw(n_chips=n)
        print(f"planner: H100_80GB_HBM3 fixture {describe(hw)} "
              f"(--no-calibrate)")
    return hw


def _probe_hw(args, n: int):
    """The overlap probe's HWConfig, resolved in this process before any
    rank shares the card, as :func:`_planner_hw` resolves the planner's
    (``calibrated_hw`` memoizes: after ``--planner`` it is the same
    config).  On the CPU without ``--no-calibrate`` there is no card to
    calibrate: None, and the trainer calls ``calibrated_hw`` itself (which
    honours ``REPRO_NO_CALIBRATE``; without it the probe records its
    failure as ``overlap.error``)."""
    if args.calibrate and args.device == "cpu":
        return None
    from repro_torch.core.planner.calibrate import calibrated_hw, fixture_hw
    if args.calibrate:
        return calibrated_hw(n_chips=n)
    return fixture_hw(n_chips=n)


def _resolve(args):
    """-> (cfg, hp, mesh, plan, predicted_ms or None): the flags, a
    ``--plan`` file or the planner's decision as one ParallelPlan on one
    rank mesh, resolved and checked in this process before any rank
    exists.  ``hp`` is the flags' (its auto microbatch resolved), not yet
    projected through the plan."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig, TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.core.axes import mesh_info
    from repro_torch.launch.mesh import resolve_launch
    from repro_torch.launch.steps import check_plan, resolve_hp

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced().replace(dtype="float32")
        if cfg.context_dim:
            # the reduced context_dim (64) does not meet c_wk, which reads
            # d_model (128); the full configs have context_dim == d_model
            cfg = cfg.replace(context_dim=cfg.d_model)
    hp = TrainHParams(schedule=args.schedule, remat=not args.no_remat,
                      fine_remat=not args.coarse_remat,
                      use_planner=args.planner, tmp_layout=args.tmp_layout,
                      learning_rate=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 1),
                      microbatch=args.microbatch, seq_shard=args.seq_shard)
    mesh, plan = resolve_launch(cfg, hp, mesh=args.mesh, tp=args.tp or 1,
                                plan_file=args.plan)
    info = mesh_info(mesh)
    # the port's microbatch 0 is "auto": resolve it before planning, so the
    # cost model and the plan written carry the count the steps run
    hp = resolve_hp(hp, args.batch, seq_len=args.seq, d_model=cfg.d_model,
                    num_layers=cfg.num_layers, tp=info.tp)
    if not args.plan:
        plan = dataclasses.replace(plan, microbatch=hp.microbatch)
    predicted_ms = None
    if args.planner and not args.plan:
        from repro_torch.core.planner import plan as plan_search
        pr = plan_search(cfg, ShapeConfig("cli", args.seq, args.batch,
                                          "train"),
                         hp, _planner_hw(args, mesh.size),
                         layout=args.tmp_layout,
                         options=tuple(n for n in (2, 4, 8, 16)
                                       if n <= info.tp) or (info.tp,),
                         schedules="auto"
                         if args.planner_schedules == "auto" else None,
                         seq=args.planner_seq)
        print(f"planner: {pr.summary()}")
        predicted_ms = pr.predicted_s * 1e3
        runs_here = all(d in (None, info.tp) for d in pr.plan.degrees)
        if info.factored or pr.plan.planned_degrees is None or runs_here:
            plan = dataclasses.replace(plan, layers=pr.plan.layers)
        else:
            print("planner: mesh is not factored — plan shown for "
                  "inspection only, training uses the uniform layout")
    # refuse what the port cannot run before any rank exists; each rank's
    # Trainer projects hp through the plan
    if args.tp and args.tp != info.tp:
        raise ValueError(f"{plan.summary()}: its mesh {mesh.shape} "
                         f"{mesh.axis_names} has a model group of {info.tp} "
                         f"ranks: run it with --tp {info.tp}")
    check_plan(cfg, plan, mesh)
    if args.save_plan:
        plan.save(args.save_plan)
        print(f"[plan] wrote {args.save_plan}: {plan.summary()}")
    return cfg, hp, mesh, plan, predicted_ms


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    from repro_torch.core.schedule import SCHEDULES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config in float32")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0,
                    help="gradient-accumulation steps (0 = auto)")
    ap.add_argument("--seq-shard", type=int, default=1,
                    help="ring-attention sequence shards per attention "
                         "layer (power of two; must equal --tp)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--tp", type=int, default=None,
                    help="model-group ranks (processes) of an auto or "
                         "factored mesh (default 1; with an explicit mesh "
                         "or a plan file's mesh, their model group)")
    ap.add_argument("--mesh", default="auto",
                    help="auto (1 x --tp) | factored (binary t-axes of "
                         "--tp: per-layer degrees) | 1xM | 1xMxxMy (2-D "
                         "model_x x model_y)")
    ap.add_argument("--schedule", default="oases", choices=SCHEDULES)
    ap.add_argument("--no-remat", action="store_true",
                    help="keep every activation (no recomputation)")
    ap.add_argument("--coarse-remat", "--no-fine-remat",
                    dest="coarse_remat", action="store_true",
                    help="recompute whole layers, collectives included")
    ap.add_argument("--tmp-layout", default="auto",
                    choices=["auto", "1d", "2d"],
                    help="partition layout: 1d (classic), 2d (hybrid "
                         "model_x*model_y), auto (follow the mesh; the "
                         "planner searches both spaces)")
    ap.add_argument("--planner", action="store_true",
                    help="the plan from the ILP (degrees in (2, 4, 8, 16) "
                         "up to the mesh's model group, or that group)")
    ap.add_argument("--calibrate", action="store_true", default=True,
                    help="profile-guided --planner inputs (the DEFAULT: "
                         "the card's measured bf16 rate, memory rate and "
                         "capacity, cached per host)")
    ap.add_argument("--no-calibrate", dest="calibrate",
                    action="store_false",
                    help="plan with the H100_80GB_HBM3 fixture instead "
                         "(the CPU has no card to calibrate)")
    ap.add_argument("--plan", default="", metavar="plan.json",
                    help="execute a ParallelPlan file (planner output / "
                         "--save-plan, of either package); overrides the "
                         "parallelism flags in one shot")
    ap.add_argument("--save-plan", default="", metavar="out.json",
                    help="write the resolved ParallelPlan (desugared "
                         "flags or the ILP decision under --planner) for "
                         "later --plan runs")
    ap.add_argument("--planner-schedules", default="current",
                    choices=["current", "auto"],
                    help="--planner search space: degrees under the "
                         "--schedule ('current') or the full per-layer "
                         "(degree, schedule) space of the paper ('auto')")
    ap.add_argument("--planner-seq", default="none",
                    choices=["none", "auto"],
                    help="--planner seq axis: 'auto' lets the ILP shard "
                         "long sequences over KV rings per attention "
                         "layer instead of (only) sharding heads")
    ap.add_argument("--telemetry", default="", metavar="DIR",
                    help="write structured telemetry (JSONL) under DIR; "
                         "render with `python -m repro_torch.obs.report "
                         "DIR`. Also enables the end-of-run "
                         "overlap-efficiency probe (measured vs modeled "
                         "exposed comm)")
    ap.add_argument("--telemetry-flush", type=int, default=64,
                    metavar="N",
                    help="JSONL records buffered between file flushes "
                         "(must be positive; 1 = write-through)")
    args = ap.parse_args(argv)
    if args.telemetry and args.telemetry_flush <= 0:
        raise SystemExit(
            f"--telemetry-flush must be a positive number of records, "
            f"got {args.telemetry_flush} (use 1 for write-through)")
    return args


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from repro_torch import obs

    args = parse_args(argv)
    rec = prev = None
    if args.telemetry:
        # global install: the planner's records reach it through
        # obs.get_recorder(); console=print keeps the familiar log lines
        rec = obs.Recorder(args.telemetry, flush_every=args.telemetry_flush,
                           console=print)
        prev = obs.set_recorder(rec)
    try:
        cfg, hp, mesh, plan, predicted_ms = _resolve(args)
        run = (args, cfg, hp, plan,
               _probe_hw(args, mesh.size) if args.telemetry else None)
        if mesh.size > 1:
            from repro_torch.launch import train as this  # picklable by name
            from repro_torch.launch.ranks import run_ranks
            if rec is not None:
                rec.close()     # rank 0 appends to the file next
            out = run_ranks(this._train, device=args.device, args=run,
                            timeout=3600,
                            mesh=(mesh.shape, mesh.axis_names))[0]
        else:
            from repro_torch.core.device import resolve_device
            out = _train(None, resolve_device(args.device), *run)
    finally:
        if rec is not None:
            rec.close()
            obs.set_recorder(prev)
    out["plan"] = plan.summary()
    if predicted_ms is not None:
        out["predicted_ms"] = predicted_ms
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
