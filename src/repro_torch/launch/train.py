"""Training launcher of the PyTorch port: AdamW steps of one model on one
device, on the card (default) or the CPU.

    # on the GPU (builds the CUDA kernels at the first step)
    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-h2048 \\
        --steps 8 --batch 8 --seq 1024 --microbatch 2

    # CPU smoke with the plain PyTorch versions of the kernels
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 2

Prints the JSON of ``repro.launch.train`` (``final_step``, ``first_loss``,
``last_loss``, ``slow_steps``).  Mesh, schedule, planner, checkpoint,
telemetry and fault-injection flags are not offered yet.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch


def main(argv: Optional[Sequence[str]] = None):
    from repro_torch.configs.base import TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.runtime import Trainer

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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    # f32 products stay full f32 on the card (no TF32), as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced().replace(dtype="float32")
    hp = TrainHParams(learning_rate=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 1),
                      microbatch=args.microbatch)
    trainer = Trainer(cfg, hp, global_batch=args.batch, seq_len=args.seq,
                      device=args.device)
    res = trainer.train(args.steps, seed=args.seed)
    print(json.dumps({
        "final_step": res["final_step"],
        "first_loss": res["losses"][0], "last_loss": res["losses"][-1],
        "slow_steps": len(res["slow_steps"]),
    }, indent=1))


if __name__ == "__main__":
    main()
