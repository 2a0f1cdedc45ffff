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
    from repro_torch.kernels.rmsnorm import rmsnorm

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

    d = 4096
    for rows in (8, 8192):
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            gen = torch.Generator(device="cuda").manual_seed(2)
            x = (torch.randn(rows, d, generator=gen, device="cuda") * 3
                 ).to(dtype)
            s = torch.randn(d, generator=gen, device="cuda") * 0.1
            out = rmsnorm(x, s, eps=1e-5)
            want = ref.rmsnorm_ref(x, s, 1e-5)
            torch.cuda.synchronize()
            atol, rtol = RMS_TOL[dname]
            err, ok = max_err(out, want, atol, rtol)
            w = (1.0 + s).to(dtype)
            elt = x.element_size()
            nbytes = 2 * rows * d * elt + d * 4
            t_bytes = nbytes / PEAK_BYTES
            t_ops = 4 * rows * d / PEAK_FLOPS[dname]
            row = dict(rows=rows, d=d, dtype=dname, max_abs_err=err,
                       atol=atol, rtol=rtol,
                       ms=time_ms(lambda: rmsnorm(x, s, eps=1e-5)),
                       plain_ms=time_ms(lambda: ref.rmsnorm_ref(x, s, 1e-5)),
                       bound_ms=1e3 * max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       library_ms=time_ms(lambda: F.rms_norm(
                           x, (d,), weight=w, eps=1e-5)))
            print(f"[rmsnorm] {json.dumps(row)}")
            require(ok, f"rmsnorm rows={rows} {dname}: max abs err {err} "
                        f"beyond atol {atol} + rtol {rtol}")
            results["rmsnorm"].append(row)
    return results


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
    require(g["launches"]["paged_decode"] == g["stats"]["steps"] * 2
            and g["launches"]["rmsnorm"] == g["stats"]["steps"] * 5,
            f"card run launched {g['launches']} in {g['stats']['steps']} steps")
    require(c["launches"] == {"paged_decode": 0, "rmsnorm": 0},
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
    report["total_s"] = time.perf_counter() - t0

    main_paged = next(r for r in report["kernels"]["paged_decode"]
                      if r["case"] == "main" and r["dtype"] == "bfloat16")
    main_rms = next(r for r in report["kernels"]["rmsnorm"]
                    if r["rows"] == 8 and r["dtype"] == "bfloat16")
    launches = report["serve"]["launches"]
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
             launches=launches["rmsnorm"],
             **{k: main_rms[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")}),
    ]}
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
