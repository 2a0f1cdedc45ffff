"""Serving launcher of the PyTorch port: random requests through the
continuous-batching engine, on the card (default) or the CPU, on one
rank or a mesh of rank processes, with or without a draft model.  The
cache is dense unless ``--paged`` is given, as in ``repro.launch.serve``;
every assigned arch serves at one rank (whisper's and llama's cross
layers read the zero context JAX's engine holds), the dense
global-attention archs on a mesh.

    # on the GPU (builds the CUDA kernels at the first step)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-serve-h4096 \
        --slots 8 --max-seq 2048 --paged --prefix-cache
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
        --slots 8 --max-seq 2048          # dense: local rings, post-norms

    # 2-way TMP (two rank processes; on one card they share it) with the
    # fused collective-matmul exits, and a draft model proposing 3 tokens
    # (at the default 4 slots of 128: 24.7 GB peak a rank on an H100)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-serve-h4096 \
        --mesh 1x2 --schedule fused --draft gpt-draft-h2048 --spec-k 3

    # CPU smoke with the plain PyTorch versions of the kernels
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --paged --page-size 8 --prefix-cache
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --arch recurrentgemma-9b
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --mesh 1x2 --schedule fused --draft internlm2-1.8b --spec-k 3
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --mesh 1x2x2 --schedule oases       # the 2-D layout on 4 ranks

    # execute a saved ParallelPlan (train.py --save-plan, or this
    # launcher's --save-plan); print the latency planner's serving plan
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --plan plan.json
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --print-plan commodity

    # structured telemetry (JSONL: TTFT, decode step, queue depth, slot
    # occupancy, free pages, prefix hit rate, accept rate) and its report
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --telemetry tel
    PYTHONPATH=src python -m repro_torch.obs.report tel

``--mesh`` is ``auto`` (one rank), ``1xM`` or ``1xMxxMy`` (the 2-D
layout); a ``--plan`` file's recorded mesh is rebuilt.  Above one rank
the launcher spawns one process per rank (:mod:`repro_torch.launch.
ranks`: gloo on the CPU, the port's peer collectives on the card), each
runs the engine on its shards (random weights drawn a leaf at a time,
each rank keeping its shards) and rank 0's stats are printed, on the
card with every rank's peak device memory (``rank_peak_gb``).  A ``data``
axis above 1, ``--pp`` and ``--decode-micro`` above 0 are refused
(ROADMAP.md A5 and A8); ``--seq-shard`` is recorded in the plan only, as
in JAX (decode serves head-sharded).  Prints the engine's stats as JSON,
with the mesh, the schedule and the plan's summary.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    from repro_torch.core.schedule import SCHEDULES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config in float32")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--prefill-len", type=int, default=0,
                    help="longest admissible prompt; 0 = max_seq // 2")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--schedule", default="oases", choices=list(SCHEDULES),
                    help="TMP overlap schedule of the decode's products "
                         "('fused' rings the exits over the slot batch)")
    ap.add_argument("--mesh", default="auto",
                    help="auto (one rank) | 1xM | 1xMxxMy (2D hybrid, "
                         "e.g. 1x2x2): one rank process per mesh rank")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages (not ported: ROADMAP.md A8)")
    ap.add_argument("--tmp-layout", default="auto",
                    choices=["auto", "1d", "2d"])
    ap.add_argument("--seq-shard", type=int, default=1,
                    help="recorded in the resolved plan for provenance; "
                         "decode itself always serves head-sharded (the "
                         "KV ring is a training/prefill layout)")
    ap.add_argument("--decode-micro", type=int, default=0,
                    help="decode micro-group count on a pipeline mesh "
                         "(pipelines are not ported: ROADMAP.md A8; any "
                         "value above 0 is refused)")
    ap.add_argument("--plan", default="", metavar="plan.json",
                    help="execute a ParallelPlan file (e.g. from train.py "
                         "--save-plan); overrides the parallelism flags "
                         "and rebuilds its recorded mesh")
    ap.add_argument("--save-plan", default="", metavar="out.json",
                    help="write the resolved serving ParallelPlan")
    ap.add_argument("--print-plan", default="",
                    choices=["", "commodity", "nvlink"],
                    help="print the latency-objective serving plan "
                         "(plan(objective='latency')) for this arch on a "
                         "fixture HWConfig before serving")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: global layers' k/v in a shared "
                         "page pool with per-slot block tables; admission "
                         "becomes reservation-based with cache-full "
                         "backpressure (default: the dense per-slot cache)")
    ap.add_argument("--pages", type=int, default=0,
                    help="physical pages in the pool incl. the null page "
                         "(0 = auto: every slot can still reach max_seq)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (max_seq must divide evenly)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="reuse cached prompt blocks across requests; "
                         "requires --paged")
    ap.add_argument("--draft", default="", metavar="CONFIG",
                    help="draft model config for speculative decoding "
                         "(e.g. gpt-draft-h2048; reduced alongside "
                         "--reduced); pair with --spec-k")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="draft tokens proposed per speculative round "
                         "(greedy acceptance is token-identical to "
                         "undrafted decode)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--telemetry", default="", metavar="DIR",
                    help="write structured telemetry (JSONL) under DIR: "
                         "TTFT, per-token decode latency, queue depth, "
                         "slot occupancy; render with `python -m "
                         "repro_torch.obs.report DIR`")
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


def _configs(args):
    from repro_torch.configs.registry import get_config

    cfg = get_config(args.arch)
    draft = get_config(args.draft) if args.draft else None
    if args.reduced:
        cfg = cfg.reduced().replace(dtype="float32")
        if draft is not None:
            draft = draft.reduced().replace(dtype="float32")
    return cfg, draft


def _resolve(args):
    """-> (cfg, draft, mesh, plan): the flags or a ``--plan`` file as one
    ParallelPlan on one rank mesh, checked before any rank exists; the
    latency planner's serving plan printed under ``--print-plan``."""
    from repro_torch.configs.base import ShapeConfig, TrainHParams
    from repro_torch.core.pipeline import PIPE_ITEM
    from repro_torch.launch.mesh import resolve_launch

    if args.decode_micro > 0:
        raise NotImplementedError(
            f"--decode-micro {args.decode_micro}: decode micro-groups run "
            f"on a pipeline mesh ({PIPE_ITEM})")
    cfg, draft = _configs(args)
    if args.print_plan:
        from repro_torch.core.planner import (COMMODITY_25GBE, NVLINK_BOX,
                                              plan)
        hw = COMMODITY_25GBE if args.print_plan == "commodity" else NVLINK_BOX
        shape = ShapeConfig("serve_cli", args.max_seq, args.slots, "decode")
        pr = plan(cfg, shape, TrainHParams(schedule=args.schedule), hw,
                  options=tuple(n for n in (2, 4, 8, 16)
                                if n <= hw.n_chips) or (hw.n_chips,),
                  objective="latency")
        print(f"latency planner ({args.print_plan}): {pr.summary()}")
    hp = TrainHParams(schedule=args.schedule, tmp_layout=args.tmp_layout,
                      seq_shard=args.seq_shard)
    mesh, pplan = resolve_launch(cfg, hp, mesh=args.mesh, pp=args.pp,
                                 plan_file=args.plan,
                                 save_plan=args.save_plan)
    return cfg, draft, mesh, pplan


def _serve(comm, device, args, cfg, draft, pplan):
    """One rank's engine (the whole run at one rank) -> (stats, prefill
    length, every request's tokens).  With ``--telemetry`` rank 0 records
    into the file (the launcher's recorder at one rank); ranks above 0
    record in memory."""
    from repro_torch import obs
    from repro_torch.serving import Request, ServingEngine

    # f32 products stay full f32 on the card (no TF32), as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    telemetry = None
    if args.telemetry and comm is not None:
        telemetry = (obs.configure(args.telemetry,
                                   flush_every=args.telemetry_flush,
                                   console=print)
                     if comm.rank == 0 else obs.Recorder())
    try:
        eng = ServingEngine(cfg, comm, slots=args.slots,
                            max_seq=args.max_seq,
                            prefill_len=args.prefill_len or None,
                            plan=pplan, paged=args.paged, pages=args.pages,
                            page_size=args.page_size,
                            prefix_cache=args.prefix_cache, draft=draft,
                            spec_k=args.spec_k, device=device,
                            telemetry=telemetry)
        eng.load(seed=args.seed)
        rng = np.random.default_rng(args.seed)
        reqs = []
        for i in range(args.requests):
            hi = max(min(12, eng.prefill_len + 1), 2)
            plen = int(rng.integers(min(4, hi - 1), hi))
            r = Request(rid=i,
                        prompt=rng.integers(3, cfg.vocab_size, plen,
                                            dtype=np.int32),
                        max_new_tokens=args.max_new_tokens)
            reqs.append(r)
            eng.submit(r)
        stats = eng.run_until_drained()
    finally:
        if telemetry is not None:
            telemetry.close()
    stats["device"] = str(eng.device)
    stats["schedule"] = eng.ctx.schedule
    if eng.device.type == "cuda":
        stats["peak_gb"] = torch.cuda.max_memory_allocated(eng.device) / 1e9
    return stats, eng.prefill_len, [r.out_tokens for r in reqs]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from repro_torch import obs

    args = parse_args(argv)
    rec = prev = None
    if args.telemetry:
        # global install: the engine resolves it on each tick
        rec = obs.Recorder(args.telemetry, flush_every=args.telemetry_flush,
                           console=print)
        prev = obs.set_recorder(rec)
    try:
        cfg, draft, mesh, pplan = _resolve(args)
        run = (args, cfg, draft, pplan)
        if mesh.size > 1:
            from repro_torch.launch import serve as this  # picklable by name
            from repro_torch.launch.ranks import run_ranks
            if rec is not None:
                rec.close()     # rank 0 appends to the file next
            outs = run_ranks(this._serve, device=args.device, args=run,
                             timeout=3600,
                             mesh=(mesh.shape, mesh.axis_names))
            if any(o[2] != outs[0][2] for o in outs):
                raise RuntimeError("the ranks' tokens differ")
            stats, prefill_len, tokens = outs[0]
            if "peak_gb" in stats:   # ranks that share a card add up
                stats["rank_peak_gb"] = [o[0]["peak_gb"] for o in outs]
        else:
            from repro_torch.core.device import resolve_device
            stats, prefill_len, tokens = _serve(
                None, resolve_device(args.device), *run)
    finally:
        if rec is not None:
            rec.close()
            obs.set_recorder(prev)
    out = {**stats,
           "mesh": dict(zip(mesh.axis_names, mesh.shape)),
           "plan": pplan.summary(),
           "prefill_len": prefill_len,
           "sample_output": tokens[0][:8]}
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
