"""Training launcher of the PyTorch port: AdamW steps of one model on a
1-D tensor-parallel group of ``--tp`` ranks, on the card (default) or the
CPU.

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

With ``--tp`` N > 1 the launcher spawns N rank processes
(:mod:`repro_torch.launch.ranks`): gloo on the CPU, the port's peer
collectives on the card.  Prints the JSON of ``repro.launch.train``
(``final_step``, ``first_loss``, ``last_loss``, ``slow_steps``), from
rank 0.  Sequence parallelism without ring attention is reachable
through ``TrainHParams(seq_parallel=True)`` (JAX's CLI has no flag for
it either).  Data parallelism, the planner, checkpoints, telemetry and
fault injection are not offered yet.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch


def _train(comm, device, args) -> dict:
    """One rank's run (the whole run at tp=1)."""
    from repro_torch.configs.base import TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.runtime import Trainer

    # f32 products stay full f32 on the card (no TF32), as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced().replace(dtype="float32")
    hp = TrainHParams(schedule=args.schedule, remat=not args.no_remat,
                      fine_remat=not args.coarse_remat,
                      learning_rate=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 1),
                      microbatch=args.microbatch, seq_shard=args.seq_shard)
    trainer = Trainer(cfg, hp, global_batch=args.batch, seq_len=args.seq,
                      device=device, comm=comm)
    res = trainer.train(args.steps, seed=args.seed)
    return {"final_step": res["final_step"],
            "first_loss": res["losses"][0], "last_loss": res["losses"][-1],
            "slow_steps": len(res["slow_steps"])}


def main(argv: Optional[Sequence[str]] = None):
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
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks (processes)")
    ap.add_argument("--schedule", default="oases", choices=SCHEDULES)
    ap.add_argument("--no-remat", action="store_true",
                    help="keep every activation (no recomputation)")
    ap.add_argument("--coarse-remat", action="store_true",
                    help="recompute whole layers, collectives included")
    args = ap.parse_args(argv)

    if args.tp > 1:
        from repro_torch.launch import train as this  # picklable by name
        from repro_torch.launch.ranks import run_ranks
        out = run_ranks(this._train, args.tp, device=args.device,
                        args=(args,), timeout=3600)[0]
    else:
        from repro_torch.core.device import resolve_device
        out = _train(None, resolve_device(args.device), args)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
