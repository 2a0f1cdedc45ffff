"""Serving launcher of the PyTorch port: random requests through the
continuous-batching engine, on the card (default) or the CPU.  The cache is
dense unless ``--paged`` is given, as in ``repro.launch.serve``; every
assigned arch serves (whisper's and llama's cross layers read the zero
context JAX's engine holds).

    # on the GPU (builds the CUDA kernels at the first step)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-serve-h4096 \
        --slots 8 --max-seq 2048 --paged --prefix-cache
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
        --slots 8 --max-seq 2048          # dense: local rings, post-norms

    # CPU smoke with the plain PyTorch versions of the kernels
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --paged --page-size 8 --prefix-cache
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --arch recurrentgemma-9b

    # structured telemetry (JSONL: TTFT, decode step, queue depth, slot
    # occupancy, free pages, prefix hit rate) and its report
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --telemetry tel
    PYTHONPATH=src python -m repro_torch.obs.report tel

Prints the engine's stats as JSON.  Mesh, pipeline, plan and draft flags
of ``repro.launch.serve`` are not offered yet (ROADMAP.md A5).
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch


def main(argv: Optional[Sequence[str]] = None):
    from repro_torch import obs

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

    telemetry = prev = None
    if args.telemetry:
        if args.telemetry_flush <= 0:
            raise SystemExit(
                f"--telemetry-flush must be a positive number of records, "
                f"got {args.telemetry_flush} (use 1 for write-through)")
        # global install: the engine resolves it on each tick
        telemetry = obs.Recorder(args.telemetry,
                                 flush_every=args.telemetry_flush,
                                 console=print)
        prev = obs.set_recorder(telemetry)
    try:
        stats, eng, reqs = _serve(args)
    finally:
        if telemetry is not None:
            telemetry.close()
            obs.set_recorder(prev)
    print(json.dumps({**stats,
                      "device": str(eng.device),
                      "prefill_len": eng.prefill_len,
                      "sample_output": reqs[0].out_tokens[:8]}, indent=1))


def _serve(args):
    """-> (stats, engine, requests): random requests through the engine."""
    from repro_torch.configs.registry import get_config
    from repro_torch.serving import Request, ServingEngine

    # f32 products stay full f32 on the card (no TF32), as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced().replace(dtype="float32")
    eng = ServingEngine(cfg, slots=args.slots, max_seq=args.max_seq,
                        prefill_len=args.prefill_len or None,
                        paged=args.paged, pages=args.pages,
                        page_size=args.page_size,
                        prefix_cache=args.prefix_cache, device=args.device)
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
    return eng.run_until_drained(), eng, reqs


if __name__ == "__main__":
    main()
