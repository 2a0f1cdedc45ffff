"""Where the RG-LRU kernels' time goes on the card, and whether their
branch-free reciprocal, square root and quotient are IEEE's.

``PYTHONPATH=src python3 tools/rglru_ablation.py`` (GPU only) compiles
``src/repro_torch/kernels/csrc/rglru.cu`` as it is and three ablated
copies of it, each into its own library under ``build/rglru_ablation/``
(raising if the kernel no longer holds the text an ablation replaces),
and times the forward (the
tile-start states kept) and the backward of each at recurrentgemma-9b's
slice (b 2 x s 4096 x w 4096), bf16 and f32, median of 30 calls:

- ``cheap_gates``: the gates from multiply-adds alone (no exp, reciprocal
  or square root), the rest of both kernels unchanged;
- ``no_chain_rule``: the backward writes dh as dx and sums stand-ins, with
  no chain rule through the gates;
- ``skeleton``: both: what the loads, the scans, the folds, the barriers
  and the stores cost.

The ablated copies compute wrong results on purpose; only their times are
read.  It also checks the kernels' ``rcp_rn``, ``sqrt_rn`` and ``div_rn``
(copied out of ``csrc/rglru.cu``) bit for bit against ``__frcp_rn``,
``__fsqrt_rn`` and ``__fdiv_rn``: the reciprocal at every f32 in
[1, 2^126), the square root at every f32 in [1e-6, 1], and the quotient
at 2^30 hashed samples (not every pair) with the divisor in [1e-3, 1] and
the dividend, of either sign, in [2^-40, 2^41) in magnitude.
Prints one JSON line per row and writes ``chiprun_out/rglru_ablation.json``.
"""
from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.kernels import _build

SHAPE = (2, 4096, 4096)
OUT = _build.BUILD_DIR.parent / "rglru_ablation"

_GATES = ('''  r = sigmoid(fmaf(xf, ch.wa, ch.ba));
  i = sigmoid(fmaf(xf, ch.wx, ch.bx));
  const float log_a = ch.nsp * r;
  a = expf(log_a);
  const float e2 = expf(2.f * log_a);
  const float m = 1.f - e2;
  q = sqrt_rn(fmaxf(m, 1e-6f));''', '''  r = fmaf(xf, ch.wa * 0.01f, 0.5f);
  i = fmaf(xf, ch.wx * 0.01f, 0.5f);
  const float log_a = ch.nsp * r;
  a = fmaf(log_a, 0.001f, 0.99f);
  const float e2 = a * a;
  const float m = 1.f - e2;
  q = fmaf(m, -0.5f, 1.f);''')
_CHAIN = ('''        const float dq = dh * (i[l] * xf);
        const float dhq = dh * q[l];
        const float di = dhq * xf;
        // dm = dq / (2 q) where the clamp does not bind, and 2 e2 dm =
        // c2 (dq / q) bit for bit (the factors 2 and 1/2 are exact)
        const float dlog_a = dh * hp * a[l] - c2[l] * div_rn(dq, q[l]);
        const float dza = dlog_a * ch.nsp * r[l] * (1.f - r[l]);
        const float dzx = di * i[l] * (1.f - i[l]);
        const T v = repro::from_float<T>(fmaf(dza, ch.wa, fmaf(dzx, ch.wx, dhq * i[l])));''',
          '''        const float dza = dh * hp, dzx = dh * xf, dlog_a = dh;
        const T v = repro::from_float<T>(dh);''')
ABLATIONS: Dict[str, List[Tuple[str, str]]] = {
    "kernel": [], "cheap_gates": [_GATES], "no_chain_rule": [_CHAIN],
    "skeleton": [_GATES, _CHAIN]}

_MATH_CHECK = r'''
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>
%(functions)s
__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16; x *= 0x7feb352dU; x ^= x >> 15; x *= 0x846ca68bU; x ^= x >> 16;
  return x;
}
__global__ void check(uint32_t sq_lo, unsigned long long* bad) {
  const uint32_t one = 0x3f800000U, two126 = 0x7e800000U, q_lo = 0x3a83126fU;
  unsigned long long b0 = 0, b1 = 0, b2 = 0;
  const uint32_t stride = gridDim.x * blockDim.x;
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  for (uint32_t i = t; i < two126 - one; i += stride) {
    const float x = __uint_as_float(one + i);
    b0 += __float_as_uint(rcp_rn(x)) != __float_as_uint(__frcp_rn(x));
  }
  for (uint32_t i = t; i <= one - sq_lo; i += stride) {
    const float m = __uint_as_float(sq_lo + i);
    b1 += __float_as_uint(sqrt_rn(m)) != __float_as_uint(__fsqrt_rn(m));
  }
  for (uint32_t i = t; i < (1U << 30); i += stride) {
    const uint32_t h = mix(i), g = mix(i ^ 0x9e3779b9U);
    // any sign, exponents 2^-40 .. 2^40; the divisor in [1e-3, 1]
    const float a = __uint_as_float((h & 0x807fffffU) | ((87U + g %% 81U) << 23));
    const float b = __uint_as_float(q_lo + mix(g) %% (one - q_lo + 1U));
    b2 += __float_as_uint(div_rn(a, b)) != __float_as_uint(__fdiv_rn(a, b));
  }
  atomicAdd(bad, b0);
  atomicAdd(bad + 1, b1);
  atomicAdd(bad + 2, b2);
}
extern "C" int math_check(unsigned long long* host) {
  unsigned long long* bad;
  float lo = 1e-6f;
  uint32_t sq_lo;
  memcpy(&sq_lo, &lo, 4);
  if (cudaMalloc(&bad, 3 * sizeof(unsigned long long)) != cudaSuccess) return 1;
  cudaMemset(bad, 0, 3 * sizeof(unsigned long long));
  check<<<132 * 16, 256>>>(sq_lo, bad);
  const cudaError_t e = cudaDeviceSynchronize();
  cudaMemcpy(host, bad, 3 * sizeof(unsigned long long), cudaMemcpyDeviceToHost);
  cudaFree(bad);
  return static_cast<int>(e);
}
'''
MATH_COUNTS = {"rcp_rn": 0x7e800000 - 0x3f800000,
               "sqrt_rn": 0x3f800000 - 0x358637bd + 1, "div_rn": 1 << 30}


def ablated(name: str) -> str:
    """csrc/rglru.cu with ablation ``name``'s substitutions; raises if the
    source no longer holds a substitution's text."""
    src = (_build.CSRC / "rglru.cu").read_text()
    for old, new in ABLATIONS[name]:
        if src.count(old) != 1:
            raise ValueError(f"rglru_ablation {name}: csrc/rglru.cu no longer "
                             f"holds the text to replace:\n{old}")
        src = src.replace(old, new)
    return src


def math_functions() -> str:
    """``rcp_rn``, ``sqrt_rn`` and ``div_rn`` as csrc/rglru.cu defines
    them."""
    src = (_build.CSRC / "rglru.cu").read_text()
    m = re.search(r"__device__ __forceinline__ float rcp_rn\(.*?\n}\n.*?"
                  r"float div_rn\(.*?\n}\n", src, re.S)
    if not m:
        raise ValueError("csrc/rglru.cu no longer defines rcp_rn .. div_rn")
    return m.group(0)


def _compile(jobs: Dict[str, Tuple[Path, List[str]]]) -> Dict[str, Path]:
    """nvcc, one process a library, all started together."""
    nvcc = _build.nvcc_path()
    procs = {name: (lib, subprocess.Popen(
        [nvcc, *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
         "-shared", "-I", str(_build.CSRC), *srcs, "-o", str(lib)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (lib, srcs) in jobs.items()}
    for name, (_lib, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
    return {name: lib for name, (lib, _p) in procs.items()}


def _time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
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


def main() -> int:
    import torch

    from repro_torch.kernels.rglru import tiles
    if not torch.cuda.is_available():
        print("rglru_ablation: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in ABLATIONS:
        src = OUT / f"rglru_{name}.cu"
        src.write_text(ablated(name))
        jobs[name] = (OUT / f"librglru_{name}.so", [str(src)])
    check_src = OUT / "math_check.cu"
    check_src.write_text(_MATH_CHECK % {"functions": math_functions()})
    jobs["math_check"] = (OUT / "libmath_check.so", [str(check_src)])
    libs = {name: ctypes.CDLL(str(lib))
            for name, lib in _compile(jobs).items()}

    rows = []
    bad = (ctypes.c_ulonglong * 3)()
    rc = libs.pop("math_check").math_check(bad)
    row = dict(row="math_check", rc=rc,
               mismatches=dict(zip(MATH_COUNTS, map(int, bad))),
               of=MATH_COUNTS)
    print(json.dumps(row), flush=True)
    rows.append(row)
    for lib in libs.values():
        for fn in ("repro_rglru_fwd", "repro_rglru_bwd"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
    b, s, w = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(9)
    for dtype in (torch.bfloat16, torch.float32):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")
        x, dy = rnd(b, s, w).to(dtype), rnd(b, s, w).to(dtype)
        gates = (rnd(w), 0.5 * rnd(w), rnd(w), 0.5 * rnd(w), rnd(w))
        code = (_build.DTYPE_BF16 if dtype == torch.bfloat16
                else _build.DTYPE_F32)
        y, dx = torch.empty_like(x), torch.empty_like(x)
        h0 = torch.empty(b, tiles(s), w, device="cuda")
        part = torch.empty(5, b, w, device="cuda")
        dg = torch.empty(5, w, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        g = [t.data_ptr() for t in gates]
        for name, lib in libs.items():
            def fwd():
                _build.check(lib.repro_rglru_fwd(
                    x.data_ptr(), *g, y.data_ptr(), h0.data_ptr(), None, b,
                    s, w, code, stream), "rglru_ablation fwd")

            def bwd():
                _build.check(lib.repro_rglru_bwd(
                    x.data_ptr(), *g, h0.data_ptr(), dy.data_ptr(),
                    dx.data_ptr(), part.data_ptr(), dg.data_ptr(), b, s, w,
                    code, stream), "rglru_ablation bwd")
            fwd()
            row = dict(row=name, dtype=str(dtype).split(".")[1], shape=SHAPE,
                       fwd_ms=_time_ms(fwd), bwd_ms=_time_ms(bwd),
                       device=torch.cuda.get_device_name(0))
            print(json.dumps(row), flush=True)
            rows.append(row)
    out = Path(__file__).resolve().parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "rglru_ablation.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
