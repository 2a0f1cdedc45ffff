#!/usr/bin/env python3
"""Chip smoke of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc/`` with
   ``nvcc`` for ``sm_90a``; print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, at the
   serving path's shapes, in f32 (TF32 off) and bf16, and time kernel,
   plain version, the one PyTorch call that computes the same function
   (a yardstick only; the port never calls it) and the card's bound.
3. Whole-slice consistency: ``gpt-serve-h4096`` at full width and 2
   layers in f32 through the port's ``ServingEngine`` on the card (kernels)
   and on the CPU (plain versions) from the same weights: tokens must be
   identical and KV pools (page 0 aside) agree within 1e-4.
4. Serve ``gpt-serve-h4096`` at full width and depth in bf16 (8 slots,
   max_seq 2048, page 16, prefix cache on, 16 requests); each kernel's
   launches over this phase must be steps x 64 (paged decode) and
   steps x 129 (RMSNorm).  After step 470 (8 active slots at positions
   up to ~470), 4 of its steps are timed plainly and 4 under ``torch.profiler``:
   device time against host wall per step.
5. Training kernels against their plain versions on the card, in f32
   (TF32 off) and bf16: flash attention forward (out, lse) and backward
   (dq, dk, dv) at the training shapes (b 4, s 1024, 32 heads of 64;
   GQA 16/8 heads of 128; softcap 30 with window 256; ragged s 1000) and
   the RMSNorm forward and backward at 4096 x 2048, each timed with its bound, its
   plain version and, where one PyTorch call computes the same function,
   that call (a yardstick only).
6. Training consistency: ``gpt-h2048`` at full width and 2 layers in f32,
   batch 2, seq 256, from the same weights on the card (kernels) and on
   the CPU (plain versions): loss within 1e-5 relative and every gradient
   leaf within ``grads_err`` 1e-4.
7. Train ``gpt-h2048`` at full width and depth in bf16 through the port's
   ``Trainer`` (batch 8, seq 1024, 2 microbatches, 8 AdamW steps): finite
   losses, every leaf's gradient present and finite after the first step,
   launches of steps x 2 x 24 (flash forward and backward) and
   steps x 2 x 49 (RMSNorm forward and backward); step time, tokens/s,
   MFU, peak memory and a ``torch.profiler`` window of one step.

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# flop/s by input type (bf16 on the tensor cores; f32 outside them)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

ARCH = "gpt-serve-h4096"
PAGED_TOL = {"float32": (2e-5, 1e-5), "bfloat16": (1e-5, 2 ** -7)}
RMS_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-6, 2 ** -7)}
POOL_TOL = 1e-4          # f32 KV pools, card vs CPU, through 2 layers
# flash attention, kernel vs plain version, (atol, rtol): f32 sums in
# another order (out, lse; gradients sum up to g * s terms); bf16 results
# are cast from f32 in both, so one bf16 ulp (rtol 2**-7)
FLASH_TOL = {"float32": {"out": (1e-5, 1e-5), "lse": (1e-5, 1e-5),
                         "grad": (1e-4, 1e-4)},
             "bfloat16": {"out": (1e-5, 2 ** -7), "lse": (1e-5, 1e-5),
                          "grad": (1e-4, 2 ** -7)}}
# RMSNorm backward: dx as the forward; dscale sums 4096 rows of O(1)
# terms in another order (f32 in both dtypes)
RMS_BWD_TOL = {"float32": {"dx": (1e-5, 1e-5), "dscale": (1e-3, 1e-5)},
               "bfloat16": {"dx": (1e-5, 2 ** -7), "dscale": (1e-3, 1e-5)}}
# kernels that serving (no autograd) must never launch
SERVE_ONLY = {"rmsnorm_bwd": 0, "flash_attention": 0,
              "flash_attention_bwd": 0}
TRAIN_ARCH = "gpt-h2048"
LOSS_RTOL = 1e-5         # f32 loss, card vs CPU, 2 layers
GRADS_TOL = 1e-4         # grads_err, card vs CPU
H100_BF16_FLOPS = 989e12  # MFU denominator (dense bf16 peak)
# the serve phase is profiled after this many steps: all 8 slots are then
# active, at positions up to ~470 (mean ~330; the run's longest is 528)
PROFILE_AT = 470


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of one call over ``iters`` calls, each between two
    CUDA events.  Each call is queued behind a ~1 ms device sleep, so the
    host has enqueued the whole call before the start event runs: the time
    excludes the Python and launch cost of issuing it (which the decode
    step pays on the host; phase 4's profile measures that share)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(got, want, atol: float, rtol: float):
    """(max |got - want|, whether every element is within atol + rtol|want|)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool((diff <= atol + rtol * w.abs()).all())
    return float(diff.max()), ok


# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"[build] {_build.LIB_NAME} from {sorted(p.name for p in _build.CSRC.glob('*.cu'))} "
          f"in {build_s:.1f} s (nvcc {_build.ARCH_FLAGS[1]})")
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return {"build_s": build_s, "card": card}


def _paged_inputs(*, b, h, kvh, hd, page, nb, dtype, pos, inactive, seed):
    import torch
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    npages = b * nb + 1
    q = torch.randn(b, 1, h, hd, generator=gen, device=dev).to(dtype)
    kp = torch.randn(npages, page, kvh, hd, generator=gen, device=dev).to(dtype)
    vp = torch.randn(npages, page, kvh, hd, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(npages - 1, generator=gen, device=dev) + 1
    tables = perm.reshape(b, nb).to(torch.int32)
    tables[inactive] = 0
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    return q, kp, vp, tables.contiguous(), pos_t


def _paged_bound_ms(q, kp, tables, pos, page, dtype_name):
    """Bytes: each distinct K/V row (page, offset) that a slot maps at a
    position <= pos, read once (an inactive slot's all-zero table maps
    only rows of null page 0), plus q, out, tables and pos.  Operations:
    q.k and p.v over every position <= pos of every slot."""
    import torch
    b, _, h, hd = q.shape
    kvh = kp.shape[2]
    nb = tables.shape[1]
    elt = q.element_size()
    rows, positions = [], 0
    for s, p in enumerate(pos.tolist()):
        n = min(int(p), nb * page - 1) + 1
        t = torch.arange(n, device=tables.device)
        rows.append(tables[s, t // page].long() * page + t % page)
        positions += n
    distinct = int(torch.unique(torch.cat(rows)).numel())
    nbytes = (2 * distinct * kvh * hd * elt + 2 * q.numel() * elt
              + tables.numel() * 4 + pos.numel() * 4)
    flops = 4 * positions * h * hd
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), distinct


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import paged_flash_decode

    results = {"paged_decode": [], "rmsnorm": []}
    page, nb, b = 16, 128, 8
    pos = [0, 15, 16, 1023, 1024, 2047, 777, 1500]   # slot 6 inactive
    cases = [
        dict(name="main", h=32, kvh=32, hd=128, softcap=0.0),
        dict(name="gqa", h=32, kvh=8, hd=64, softcap=0.0),
        dict(name="softcap", h=32, kvh=32, hd=128, softcap=30.0),
        dict(name="gqa_g2_hd32", h=32, kvh=16, hd=32, softcap=0.0),
        dict(name="gqa_g8", h=64, kvh=8, hd=128, softcap=0.0),
    ]
    for case in cases:
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            q, kp, vp, tables, pos_t = _paged_inputs(
                b=b, h=case["h"], kvh=case["kvh"], hd=case["hd"],
                page=page, nb=nb, dtype=dtype, pos=pos, inactive=6, seed=1)
            sc = case["softcap"]
            out = paged_flash_decode(q, kp, vp, tables, pos_t, softcap=sc)
            want = ref.paged_decode_attention_ref(q, kp, vp, tables, pos_t,
                                                  softcap=sc)
            torch.cuda.synchronize()
            atol, rtol = PAGED_TOL[dname]
            err, ok = max_err(out, want, atol, rtol)
            row = dict(case=case["name"], dtype=dname, b=b, h=case["h"],
                       kvh=case["kvh"], hd=case["hd"], page=page, nb=nb,
                       softcap=sc, max_abs_err=err, atol=atol, rtol=rtol)
            row["ms"] = time_ms(lambda: paged_flash_decode(
                q, kp, vp, tables, pos_t, softcap=sc))
            row["plain_ms"] = time_ms(lambda: ref.paged_decode_attention_ref(
                q, kp, vp, tables, pos_t, softcap=sc), iters=20)
            row["bound_ms"], row["bound_by"], row["kv_rows"] = (
                _paged_bound_ms(q, kp, tables, pos_t, page, dname))
            row["library_ms"] = None
            if sc == 0.0:
                # yardstick: one SDPA call on the KV already gathered
                # (gather untimed); the g query heads of a kv head are its
                # g query rows, so GQA needs no repeated KV
                kvh, g, hd = case["kvh"], case["h"] // case["kvh"], case["hd"]
                kg = ref.gather_pages(kp, tables).transpose(1, 2)
                vg = ref.gather_pages(vp, tables).transpose(1, 2)
                qh = q.reshape(b, kvh, g, hd)
                mask = (torch.arange(kg.shape[2], device="cuda")[None, :]
                        <= pos_t.long()[:, None])[:, None, None, :]
                lib_out = F.scaled_dot_product_attention(qh, kg, vg,
                                                         attn_mask=mask)
                row["library_err"] = float(
                    (lib_out.reshape(want.shape).float() - want.float())
                    .abs().max())
                row["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qh, kg, vg, attn_mask=mask))
                del kg, vg
            print(f"[paged_decode] {json.dumps(row)}")
            require(ok, f"paged_decode {case['name']} {dname}: max abs err "
                        f"{err} beyond atol {atol} + rtol {rtol}")
            results["paged_decode"].append(row)
            del q, kp, vp, out, want

    for rows in (8, 8192):
        for dname in ("float32", "bfloat16"):
            results["rmsnorm"].append(_rmsnorm_row(rows, 4096, dname))
    return results


def _rmsnorm_row(rows: int, d: int, dname: str) -> dict:
    """The RMSNorm forward kernel on [rows, d] against its plain version,
    timed beside its bound, the plain version and ``F.rms_norm``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm

    dtype = getattr(torch, dname)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = (torch.randn(rows, d, generator=gen, device="cuda") * 3).to(dtype)
    s = torch.randn(d, generator=gen, device="cuda") * 0.1
    out = rmsnorm(x, s, eps=1e-5)
    want = ref.rmsnorm_ref(x, s, 1e-5)
    torch.cuda.synchronize()
    atol, rtol = RMS_TOL[dname]
    err, ok = max_err(out, want, atol, rtol)
    w = (1.0 + s).to(dtype)
    bound = _bound(2 * rows * d * x.element_size() + d * 4, 4 * rows * d,
                   dname)
    row = dict(rows=rows, d=d, dtype=dname, max_abs_err=err, atol=atol,
               rtol=rtol, ms=time_ms(lambda: rmsnorm(x, s, eps=1e-5)),
               plain_ms=time_ms(lambda: ref.rmsnorm_ref(x, s, 1e-5)),
               bound_ms=bound[0], bound_by=bound[1],
               library_ms=time_ms(lambda: F.rms_norm(x, (d,), weight=w,
                                                     eps=1e-5)))
    print(f"[rmsnorm] {json.dumps(row)}")
    require(ok, f"rmsnorm rows={rows} d={d} {dname}: max abs err {err} "
                f"beyond atol {atol} + rtol {rtol}")
    return row


def _consistency_requests(np, vocab):
    """8 requests over 4 slots; even ones share a 20-token prefix (it ends
    mid-block with page 16), so the second wave hits and copies on write."""
    rng = np.random.default_rng(11)
    shared = rng.integers(3, vocab, 20).astype(np.int32)
    out = []
    for i in range(8):
        tail = rng.integers(3, vocab, int(rng.integers(3, 12))).astype(np.int32)
        out.append(np.concatenate([shared, tail]) if i % 2 == 0 else tail)
    return out


def phase_consistency():
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import params as prm
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config(ARCH).replace(num_layers=2, dtype="float32")
    params_cpu = prm.init_params(cfg, seed=0, device=torch.device("cpu"))
    params_gpu = {"blocks": [{k: v.to("cuda") for k, v in
                              params_cpu["blocks"][0].items()}],
                  **{k: params_cpu[k].to("cuda")
                     for k in ("embed", "final_ln", "lm_head")}}
    prompts = _consistency_requests(np, cfg.vocab_size)
    runs = {}
    for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
        eng = ServingEngine(cfg, slots=4, max_seq=128, page_size=16,
                            prefix_cache=True, device=dev)
        eng.load(params=params)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        _build.reset_launches()
        t0 = time.perf_counter()
        stats = eng.run_until_drained()
        runs[dev] = dict(eng=eng, reqs=reqs, stats=stats,
                         launches=dict(_build.LAUNCHES),
                         s=time.perf_counter() - t0)
    g, c = runs["cuda"], runs["cpu"]
    steps = g["stats"]["steps"]
    require(g["launches"] == {**SERVE_ONLY, "paged_decode": steps * 2,
                              "rmsnorm": steps * 5},
            f"card run launched {g['launches']} in {steps} steps")
    require(not any(c["launches"].values()),
            f"CPU run launched kernels: {c['launches']}")
    for rg, rc in zip(g["reqs"], c["reqs"]):
        require(rg.done and rc.done and rg.out_tokens == rc.out_tokens,
                f"request {rg.rid}: card tokens {rg.out_tokens} != CPU "
                f"tokens {rc.out_tokens}")
    require(g["eng"].stats == c["eng"].stats,
            f"stats differ: {g['eng'].stats} vs {c['eng'].stats}")
    require(g["stats"]["prefix_hits"] >= 1 and g["stats"]["paged"]["cow"] >= 1,
            f"consistency run did not exercise prefix reuse and COW: "
            f"{g['stats']}")
    pool_err = 0.0
    for key in ("k", "v"):
        a = g["eng"].state["blocks"][0][key][:, 1:].cpu()
        b = c["eng"].state["blocks"][0][key][:, 1:]
        pool_err = max(pool_err, float((a - b).abs().max()))
    require(pool_err <= POOL_TOL,
            f"KV pools differ by {pool_err} (tolerance {POOL_TOL})")
    out = dict(layers=cfg.num_layers, d_model=cfg.d_model, dtype="float32",
               steps=g["stats"]["steps"], prefix_hits=g["stats"]["prefix_hits"],
               cow=g["stats"]["paged"]["cow"], pool_max_abs_err=pool_err,
               pool_tol=POOL_TOL, tokens=[r.out_tokens for r in g["reqs"]],
               card_s=g["s"], cpu_s=c["s"])
    print(f"[consistency] {json.dumps(out)}")
    return out


def _serve_requests(np, vocab, n=16):
    """Prompts of 64-512 tokens; even requests share a 256-token prefix."""
    rng = np.random.default_rng(0)
    shared = rng.integers(3, vocab, 256).astype(np.int32)
    out = []
    for i in range(n):
        if i % 2 == 0:
            tail = rng.integers(3, vocab, int(rng.integers(16, 257)))
            out.append(np.concatenate([shared, tail.astype(np.int32)]))
        else:
            out.append(rng.integers(3, vocab, int(rng.integers(64, 513)))
                       .astype(np.int32))
    return out


def phase_serve():
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.serving import Request, ServingEngine

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(ARCH)
    eng = ServingEngine(cfg, slots=8, max_seq=2048, page_size=16,
                        prefix_cache=True)
    require(eng.device.type == "cuda", f"engine chose {eng.device}")
    t0 = time.perf_counter()
    eng.load(seed=0)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    reqs = [Request(rid=i, prompt=p, max_new_tokens=32)
            for i, p in enumerate(_serve_requests(np, cfg.vocab_size))]
    for r in reqs:
        eng.submit(r)
    _build.reset_launches()
    t0 = time.perf_counter()
    eng.run_until_drained(max_steps=PROFILE_AT)
    profile, profiled = _profile_steps(eng)
    stats = eng.run_until_drained()
    wall_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    steps = stats["steps"]
    peak = torch.cuda.max_memory_allocated()
    n_layers = cfg.num_layers
    require(launches["paged_decode"] == steps * n_layers,
            f"paged_decode launched {launches['paged_decode']} times in "
            f"{steps} steps (expected {steps * n_layers})")
    require(launches["rmsnorm"] == steps * (2 * n_layers + 1),
            f"rmsnorm launched {launches['rmsnorm']} times in {steps} steps "
            f"(expected {steps * (2 * n_layers + 1)})")
    require(all(launches[k] == 0 for k in SERVE_ONLY),
            f"serving launched training kernels: {launches}")
    vp = cfg.padded_vocab()
    for r in reqs:
        require(r.done and 1 <= len(r.out_tokens) <= 32
                and all(0 <= t < vp for t in r.out_tokens),
                f"request {r.rid}: done={r.done} tokens={r.out_tokens}")
    for key in ("k", "v"):
        pool = eng.state["blocks"][0][key]
        for i in range(n_layers):
            require(bool(torch.isfinite(pool[i]).all()),
                    f"non-finite {key} pool in layer {i}")
    # the profiled steps are slowed by the profiler: left out of the
    # per-step times (they stay in the wall)
    step_ms = [1e3 * s for i, s in enumerate(eng.step_s)
               if i not in range(*profiled)]
    out = dict(arch=ARCH, dtype=cfg.dtype, layers=n_layers,
               d_model=cfg.d_model, slots=8, max_seq=2048, page_size=16,
               pages=eng.paged.pages, requests=len(reqs),
               prompt_tokens=stats["prompt_tokens"],
               decoded_tokens=stats["decoded_tokens"], steps=steps,
               prefix_hits=stats["prefix_hits"],
               prefix_hit_tokens=stats["prefix_hit_tokens"],
               cow=stats["paged"]["cow"], wall_s=wall_s,
               decoded_tok_per_s=stats["decoded_tokens"] / wall_s,
               step_ms_median=statistics.median(step_ms),
               step_ms_p10=float(np.percentile(step_ms, 10)),
               step_ms_p90=float(np.percentile(step_ms, 90)),
               load_s=load_s, peak_mem_gb=peak / 1e9, launches=launches,
               sample_output=reqs[0].out_tokens[:8])
    print(f"[serve] {json.dumps(out)}")
    print(f"[profile] {json.dumps(profile)}")
    out["profile"] = profile
    return out


def _profile_steps(eng, steps: int = 4):
    """Where a decode step's time goes, at the serve phase's own positions:
    host wall per step over ``steps`` steps run plainly, then the device
    time of the kernels launched by the next ``steps`` steps under
    ``torch.profiler``.  ``idle_share`` = 1 - device / wall, with the wall
    of the plain steps.  Returns the summary and the range of
    ``eng.step_s`` the profiler slowed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    at_step = eng.stats["steps"]
    act = [int(eng.pos[s]) for s in range(eng.slots)
           if eng.active[s] is not None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    n0 = len(eng.step_s)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_prof_ms = 1e3 * (time.perf_counter() - t0) / steps
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels.append((us, evt.count, evt.key))
    kernels.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels) / 1e3 / steps
    return dict(
        at_step=at_step, steps=steps, active_slots=len(act),
        positions_mean=sum(act) / max(len(act), 1),
        positions_max=max(act, default=0),
        wall_ms_per_step=wall_ms,
        wall_ms_per_step_profiled=wall_prof_ms,
        device_ms_per_step=device_ms if kernels else "not measured",
        idle_share=(1 - device_ms / wall_ms) if kernels
        else "not measured",
        launches_per_step=sum(k[1] for k in kernels) / steps,
        top=[dict(name=k[2][:90], ms_per_step=k[0] / 1e3 / steps,
                  calls_per_step=k[1] / steps) for k in kernels[:14]]
    ), (n0, n0 + steps)


def _visible_pairs(s, causal, window):
    """(query, key) pairs the mask leaves visible, per head."""
    import numpy as np
    i = np.arange(s)
    lo = np.zeros(s, np.int64) if window is None else np.maximum(
        i - window + 1, 0)
    hi = i + 1 if causal else np.full(s, s)
    return int((hi - lo).sum())


def _bound(nbytes, flops, dname):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dname]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _check_all(name, pairs, tol):
    """pairs: {label: (got, want)}; tol: {label: (atol, rtol)} -> errors."""
    errs = {}
    for label, (got, want) in pairs.items():
        atol, rtol = tol[label]
        errs[label], ok = max_err(got, want, atol, rtol)
        require(ok, f"{name} {label}: max abs err {errs[label]} beyond "
                    f"atol {atol} + rtol {rtol}")
    return errs


def phase_train_kernels():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd

    results = {"flash_attention": [], "flash_attention_bwd": [],
               "rmsnorm": [], "rmsnorm_bwd": []}
    cases = [
        dict(name="main", b=4, s=1024, h=32, kvh=32, hd=64),
        dict(name="gqa", b=4, s=1024, h=16, kvh=8, hd=128),
        dict(name="softcap_window", b=4, s=1024, h=32, kvh=32, hd=64,
             softcap=30.0, window=256),
        dict(name="ragged", b=4, s=1000, h=32, kvh=32, hd=64),
    ]
    for case in cases:
        b, s_, h, kvh, hd = (case[k] for k in ("b", "s", "h", "kvh", "hd"))
        kw = dict(causal=True, window=case.get("window"),
                  softcap=case.get("softcap", 0.0))
        plain_lib = not kw["softcap"] and kw["window"] is None
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            gen = torch.Generator(device="cuda").manual_seed(3)
            q, dout = (torch.randn(b, s_, h, hd, generator=gen,
                                   device="cuda").to(dtype)
                       for _ in range(2))
            k, v = (torch.randn(b, s_, kvh, hd, generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            out, lse = flash_attention_fwd(q, k, v, **kw)
            want_out, want_lse = ref.flash_attention_ref(q, k, v, **kw)
            grads = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            want_grads = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                     **kw)
            torch.cuda.synchronize()
            tol = FLASH_TOL[dname]
            ferr = _check_all(f"flash {case['name']} {dname}",
                              {"out": (out, want_out),
                               "lse": (lse, want_lse)},
                              {"out": tol["out"], "lse": tol["lse"]})
            berr = _check_all(f"flash_bwd {case['name']} {dname}",
                              dict(zip(("dq", "dk", "dv"),
                                       zip(grads, want_grads))),
                              {g: tol["grad"] for g in ("dq", "dk", "dv")})
            elt = q.element_size()
            pairs = _visible_pairs(s_, True, kw["window"]) * b * h
            lse_bytes = b * h * s_ * 4
            # reads q, k, v; writes out and lse; q.k and p.v per visible pair
            fwd_bound = _bound(2 * (q.numel() + k.numel()) * elt + lse_bytes,
                               4 * hd * pairs, dname)
            # reads q, k, v, out, dout and lse; writes dq, dk, dv.  The
            # four products the gradient needs (dP, dV, dQ, dK): the
            # recomputation of S is this design's choice, not the work's
            bwd_bound = _bound(4 * (q.numel() + k.numel()) * elt + lse_bytes,
                               8 * hd * pairs, dname)
            common = dict(case=case["name"], dtype=dname, b=b, s=s_, h=h,
                          kvh=kvh, hd=hd, window=kw["window"],
                          softcap=kw["softcap"], visible_pairs=pairs)
            frow = dict(common, max_abs_err=max(ferr.values()), errs=ferr,
                        tol=tol["out"],
                        ms=time_ms(lambda: flash_attention_fwd(q, k, v, **kw)),
                        plain_ms=time_ms(lambda: ref.flash_attention_ref(
                            q, k, v, **kw), iters=10),
                        bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
                        library_ms=None)
            brow = dict(common, max_abs_err=max(berr.values()), errs=berr,
                        tol=tol["grad"],
                        ms=time_ms(lambda: flash_attention_bwd(
                            q, k, v, out, lse, dout, **kw)),
                        plain_ms=time_ms(lambda: ref.flash_attention_bwd_ref(
                            q, k, v, out, lse, dout, **kw), iters=10),
                        bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
                        library_ms=None)
            if plain_lib:
                # yardstick: SDPA in its own [b, h, s, hd] layout
                # (transposes untimed); backward alone via retain_graph
                qt, kt, vt, dot = (t.transpose(1, 2).contiguous()
                                   for t in (q, k, v, dout))
                sdpa = dict(is_causal=True, enable_gqa=kvh != h)
                frow["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                           **sdpa))
                qg, kg, vg = (t.detach().requires_grad_()
                              for t in (qt, kt, vt))
                lo = F.scaled_dot_product_attention(qg, kg, vg, **sdpa)
                frow["library_err"] = float(
                    (lo.detach().transpose(1, 2).float()
                     - want_out.float()).abs().max())
                brow["library_ms"] = time_ms(lambda: torch.autograd.grad(
                    lo, (qg, kg, vg), dot, retain_graph=True))
                del qt, kt, vt, dot, qg, kg, vg, lo
            print(f"[flash_attention] {json.dumps(frow)}")
            print(f"[flash_attention_bwd] {json.dumps(brow)}")
            results["flash_attention"].append(frow)
            results["flash_attention_bwd"].append(brow)
            del q, k, v, dout, out, lse, want_out, want_lse, grads, want_grads
            torch.cuda.empty_cache()

    # the training path's norms: x [b*s, d] = [4096, 2048], forward and
    # backward
    rows, d = 4096, 2048
    for dname in ("float32", "bfloat16"):
        results["rmsnorm"].append(_rmsnorm_row(rows, d, dname))
        dtype = getattr(torch, dname)
        gen = torch.Generator(device="cuda").manual_seed(4)
        x = (torch.randn(rows, d, generator=gen, device="cuda") * 3
             ).to(dtype)
        dy = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
        sc = torch.randn(d, generator=gen, device="cuda") * 0.1
        dx, dsc = rmsnorm_bwd(x, sc, dy, eps=1e-5)
        want_dx, want_dsc = ref.rmsnorm_bwd_ref(x, sc, dy, 1e-5)
        torch.cuda.synchronize()
        errs = _check_all(f"rmsnorm_bwd {dname}",
                          {"dx": (dx, want_dx), "dscale": (dsc, want_dsc)},
                          RMS_BWD_TOL[dname])
        elt = x.element_size()
        bound = _bound(3 * rows * d * elt + 2 * d * 4, 12 * rows * d, dname)
        xr = x.detach().requires_grad_()
        sr = sc.detach().requires_grad_()
        ly = F.rms_norm(xr, (d,), weight=(1.0 + sr).to(dtype), eps=1e-5)
        row = dict(rows=rows, d=d, dtype=dname, max_abs_err=max(errs.values()),
                   errs=errs, tol=RMS_BWD_TOL[dname],
                   ms=time_ms(lambda: rmsnorm_bwd(x, sc, dy, eps=1e-5)),
                   plain_ms=time_ms(lambda: ref.rmsnorm_bwd_ref(
                       x, sc, dy, 1e-5)),
                   bound_ms=bound[0], bound_by=bound[1],
                   library_ms=time_ms(lambda: torch.autograd.grad(
                       ly, (xr, sr), dy, retain_graph=True)))
        print(f"[rmsnorm_bwd] {json.dumps(row)}")
        results["rmsnorm_bwd"].append(row)
    return results


def grads_err(g1: dict, g2: dict) -> float:
    """``tests/_scripts/runner.py:174``: per leaf, max abs difference over
    the max abs value of ``g1``; the worst leaf."""
    return max(float((g1[k] - g2[k]).abs().max())
               / (float(g1[k].abs().max()) + 1e-8) for k in g1)


def phase_train_consistency():
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import _build
    from repro_torch.models import lm
    from repro_torch.models import params as prm

    cfg = get_config(TRAIN_ARCH).replace(num_layers=2, dtype="float32")
    base = prm.init_params(cfg, seed=0, device=torch.device("cpu"))
    batch = make_batch(DataConfig(global_batch=2, seq_len=256,
                                  vocab_size=cfg.vocab_size), 0)
    runs = {}
    for dev in ("cuda", "cpu"):
        params = prm.unflatten({k: t.to(dev).requires_grad_() for k, t in
                                 prm.flatten(base).items()})
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        _build.reset_launches()
        t0 = time.perf_counter()
        loss, _ = lm.train_loss(cfg, params, tb, TrainHParams())
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[dev] = dict(loss=loss.item(), s=time.perf_counter() - t0,
                         launches=dict(_build.LAUNCHES),
                         grads={k: t.grad.detach().cpu() for k, t in
                                prm.flatten(params).items()})
    g, c = runs["cuda"], runs["cpu"]
    n = cfg.num_layers
    want = {"paged_decode": 0, "rmsnorm": 2 * n + 1,
            "rmsnorm_bwd": 2 * n + 1, "flash_attention": n,
            "flash_attention_bwd": n}
    require(g["launches"] == want,
            f"card pass launched {g['launches']}, expected {want}")
    require(not any(c["launches"].values()),
            f"CPU pass launched kernels: {c['launches']}")
    loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    gerr = grads_err(c["grads"], g["grads"])
    out = dict(arch=TRAIN_ARCH, layers=n, d_model=cfg.d_model,
               dtype="float32", batch=2, seq=256, loss_card=g["loss"],
               loss_cpu=c["loss"], loss_rel_err=loss_rel,
               loss_rtol=LOSS_RTOL, grads_err=gerr, grads_tol=GRADS_TOL,
               worst_leaf=max(c["grads"], key=lambda k: grads_err(
                   {k: c["grads"][k]}, {k: g["grads"][k]})),
               card_s=g["s"], cpu_s=c["s"])
    print(f"[train_consistency] {json.dumps(out)}")
    require(loss_rel <= LOSS_RTOL,
            f"loss card {g['loss']} vs CPU {c['loss']}: rel {loss_rel}")
    require(gerr <= GRADS_TOL, f"grads_err {gerr} > {GRADS_TOL}")
    return out


def _train_model_flops(cfg, batch, seq):
    """6 x matmul weights (embedding table excluded, head included) x
    tokens, plus causal attention's 3 x 2 b s^2 d per layer."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    per_layer = (d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
                 + cfg.num_heads * hd * d + 3 * d * cfg.d_ff)
    weights = cfg.num_layers * per_layer + d * cfg.padded_vocab()
    return (6 * weights * batch * seq
            + cfg.num_layers * 3 * 2 * batch * seq * seq * d)


def phase_train():
    import numpy as np
    import torch
    from repro_torch.configs.base import TrainHParams
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import params as prm
    from repro_torch.runtime import Trainer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN_ARCH)
    steps, batch, seq, micro = 8, 8, 1024, 2
    hp = TrainHParams(learning_rate=3e-4, total_steps=steps,
                      warmup_steps=max(steps // 20, 1), microbatch=micro)
    tr = Trainer(cfg, hp, global_batch=batch, seq_len=seq, log_fn=None)
    require(tr.device.type == "cuda", f"trainer chose {tr.device}")
    _build.reset_launches()
    first = tr.train(1, seed=0)
    leaves = prm.flatten(tr.params)
    bad = [k for k, t in leaves.items()
           if t.grad is None or not bool(torch.isfinite(t.grad).all())]
    require(not bad, f"missing or non-finite gradients after step 1: {bad}")
    rest = tr.train(steps, seed=0)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = first["losses"] + rest["losses"]
    times = first["step_times"] + rest["step_times"]
    require(len(losses) == steps and all(np.isfinite(losses)),
            f"losses {losses}")
    n, passes = cfg.num_layers, steps * micro
    want = {"paged_decode": 0, "rmsnorm": passes * (2 * n + 1),
            "rmsnorm_bwd": passes * (2 * n + 1),
            "flash_attention": passes * n, "flash_attention_bwd": passes * n}
    require(launches == want, f"train launched {launches}, expected {want}")
    step_ms = [1e3 * t for t in times[2:]]
    med = statistics.median(step_ms)
    flops = _train_model_flops(cfg, batch, seq)
    out = dict(arch=TRAIN_ARCH, dtype=cfg.dtype, layers=n,
               d_model=cfg.d_model, params=sum(t.numel() for t in
                                               leaves.values()),
               batch=batch, seq=seq, microbatch=micro, steps=steps,
               losses=losses, step_ms=[1e3 * t for t in times],
               step_ms_median=med, tokens_per_s=batch * seq / (med / 1e3),
               model_tflop_per_step=flops / 1e12,
               mfu=flops / (med / 1e3) / H100_BF16_FLOPS,
               peak_mem_gb=peak / 1e9, launches=launches)
    print(f"[train] {json.dumps(out)}")
    out["profile"] = _profile_train_step(tr)
    print(f"[train_profile] {json.dumps(out['profile'])}")
    return out


def _profile_train_step(tr):
    """One more step (not counted above) under ``torch.profiler``: device
    busy time against the host wall of the step, and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import DataConfig
    dcfg = DataConfig(global_batch=tr.global_batch, seq_len=tr.seq_len,
                      vocab_size=tr.cfg.vocab_size,
                      microbatch=tr.hp.microbatch)
    batch = tr.batch(dcfg, tr.opt_state["step"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.step_fn(tr.params, tr.opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels.append((us, evt.count, evt.key))
    kernels.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels) / 1e3
    return dict(
        wall_ms_profiled=wall_ms,
        device_ms=device_ms if kernels else "not measured",
        idle_share=(1 - device_ms / wall_ms) if kernels else "not measured",
        kernel_launches=sum(k[1] for k in kernels),
        top=[dict(name=k[2][:90], ms=k[0] / 1e3, calls=k[1])
             for k in kernels[:16]])


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "runs on a CUDA GPU only", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              f"run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    # f32 phases compare full-f32 products: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device_name": torch.cuda.get_device_name(0)}
    report["build"] = phase_build()
    report["kernels"] = phase_kernels()
    report["consistency"] = phase_consistency()
    report["serve"] = phase_serve()
    report["train_kernels"] = phase_train_kernels()
    report["train_consistency"] = phase_train_consistency()
    report["train"] = phase_train()
    report["total_s"] = time.perf_counter() - t0

    main_paged = next(r for r in report["kernels"]["paged_decode"]
                      if r["case"] == "main" and r["dtype"] == "bfloat16")
    main_rms = next(r for r in report["kernels"]["rmsnorm"]
                    if r["rows"] == 8 and r["dtype"] == "bfloat16")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    launches = report["serve"]["launches"]
    train_launches = report["train"]["launches"]

    def main_case(kernel, **want):
        return next(r for r in report["train_kernels"][kernel]
                    if all(r[k] == v for k, v in want.items()))

    train_rms = main_case("rmsnorm", dtype="bfloat16")

    train_rows = [
        ("rmsnorm_bwd", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:16",
         main_case("rmsnorm_bwd", dtype="bfloat16")),
        ("flash_attention", "flash_attention.cu",
         "src/repro/kernels/flash_attention.py:30",
         main_case("flash_attention", case="main", dtype="bfloat16")),
        ("flash_attention_bwd", "flash_attention.cu",
         "src/repro/kernels/flash_attention.py:30",
         main_case("flash_attention_bwd", case="main", dtype="bfloat16")),
    ]
    line = {"kernels": [
        dict(name="paged_decode", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_decode.cu",
             replaces="src/repro/kernels/flash_attention.py:146",
             launches=launches["paged_decode"],
             **{k: main_paged[k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms")}),
        dict(name="rmsnorm", route="cuda",
             source="src/repro_torch/kernels/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm.py:16",
             launches=launches["rmsnorm"] + train_launches["rmsnorm"],
             launches_by_path={"serve": launches["rmsnorm"],
                               "train": train_launches["rmsnorm"]},
             **{k: main_rms[k] for k in keys},
             at_train_shape={k: train_rms[k] for k in ("rows", "d") + keys}),
    ] + [dict(name=name, route="cuda",
              source=f"src/repro_torch/kernels/csrc/{src}",
              replaces=replaces, launches=train_launches[name],
              **{k: row[k] for k in keys})
         for name, src, replaces, row in train_rows]}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"[total] {report['total_s']:.1f} s")
    print(report["build"]["card"])
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
