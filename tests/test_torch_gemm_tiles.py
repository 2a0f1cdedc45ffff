"""The arithmetic, operand layouts and path rule of the bf16 GEMM tile on
the tensor cores (``csrc/gemm_tc.cuh``), stated in plain torch and held to
the port's plain versions and to the JAX kernels.

The tile takes bf16 operands, sums each 64-deep k block of the product in
f32, adds the blocks in f32 and casts once.  :func:`gemm_tile_emulation`
does the same on the CPU (the card's sums run in another order, so it pins
the roundings, not the bits).  It must stay within the card's gates for a
bf16 product against the plain version (``chip_smoke.py``'s ``_mm_tol``
for the tile and ring matmuls, ``FAMILY_TOL``/``FAMILY_RTOL`` for the
grouped matmul) and within the same gates of JAX's Pallas kernels in
interpret mode.  The backward's products read the tensors training holds:
dx = dy w^T with w as a K-major B, dw = x^T dy with x as an MN-major A
(:func:`repro_torch.kernels.moe_gmm.kernel_operands`), held to
``jax.grad`` of the expert einsum.  Inputs are made with numpy from a
seed.
"""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import importlib.util
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import collective_matmul as jcm
from repro.kernels import ops as jops
from repro_torch.kernels import _build, autotune
from repro_torch.kernels import collective_matmul as tcm
from repro_torch.kernels import moe_gmm as tmg
from repro_torch.kernels.ref import moe_gmm_ref, tile_matmul_ref

ROOT = Path(__file__).resolve().parents[1]
K_BLOCK = 64


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


def gemm_tile_emulation(a: torch.Tensor, b: torch.Tensor, *,
                        ta: bool = False, tb: bool = False) -> torch.Tensor:
    """op(a) @ op(b) with the tensor-core tile's roundings: bf16 operands
    (2-D, or 3-D with the expert first), f32 sums of each 64-deep k block,
    the blocks added in f32 in k order, one cast to bf16.  ``ta`` / ``tb``
    read a / b transposed in their last two dims, as the tile reads an
    MN-major A and a K-major B."""
    af, bf = a.float(), b.float()
    if ta:
        af = af.transpose(-1, -2)
    if tb:
        bf = bf.transpose(-1, -2)
    k = af.shape[-1]
    acc = None
    for k0 in range(0, k, K_BLOCK):
        part = torch.matmul(af[..., k0:k0 + K_BLOCK],
                            bf[..., k0:k0 + K_BLOCK, :])
        acc = part if acc is None else acc + part
    return acc.to(torch.bfloat16)


def _within(got, want, atol, rtol):
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= atol + rtol * w.abs()).all())


def _family_gate(want):
    """chip_smoke.py phase 14's bf16 gate of the grouped matmul."""
    return (SMOKE.FAMILY_TOL * float(want.float().abs().max()),
            SMOKE.FAMILY_RTOL["bfloat16"])


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32)).bfloat16()


# (m, k, n): the k blocks ragged (k not a multiple of 64), m and n not
# tile multiples, one k block
TILE_CASES = [(96, 200, 136), (130, 64, 72), (64, 520, 256)]


@pytest.mark.parametrize("m,k,n", TILE_CASES)
def test_tile_emulation_within_the_plain_versions_gate(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = _bf16(rng, m, k)
    w = _bf16(rng, k, n, scale=k ** -0.5)
    got = gemm_tile_emulation(x, w)
    atol, rtol = SMOKE._mm_tol(k, "bfloat16")
    assert _within(got, tile_matmul_ref(x, w), atol, rtol)


# (e, c, d, f): granite's widths cut down, a capacity the 128-row tile
# does not divide (250, as phase 14's `ragged` case), and k = c in dw
GMM_CASES = [(3, 250, 96, 64), (2, 128, 192, 40)]


@pytest.mark.parametrize("e,c,d,f", GMM_CASES)
def test_gmm_emulation_within_the_plain_versions_gate(e, c, d, f):
    rng = np.random.default_rng(e * c + d)
    x, dy = _bf16(rng, e, c, d), _bf16(rng, e, c, f)
    w = _bf16(rng, e, d, f, scale=0.05)
    for got, want in (
            (gemm_tile_emulation(x, w), moe_gmm_ref(x, w)),
            (gemm_tile_emulation(dy, w, tb=True),
             moe_gmm_ref(dy, w.transpose(1, 2))),
            (gemm_tile_emulation(x, dy, ta=True),
             moe_gmm_ref(x.transpose(1, 2), dy))):
        assert _within(got, want, *_family_gate(want))


def test_emulation_within_the_gates_of_the_jax_kernels():
    """JAX's Pallas kernels (interpret mode) at shapes their blocks
    divide, under the same gates."""
    rng = np.random.default_rng(3)
    m, k, n = 128, 256, 128
    x = _bf16(rng, m, k)
    w = _bf16(rng, k, n, scale=k ** -0.5)
    jt = np.array(jcm.pallas_tile_matmul(
        jnp.asarray(x.float().numpy(), jnp.bfloat16),
        jnp.asarray(w.float().numpy(), jnp.bfloat16), block_m=64,
        block_n=64, block_k=64, interpret=True).astype(jnp.float32))
    atol, rtol = SMOKE._mm_tol(k, "bfloat16")
    assert _within(gemm_tile_emulation(x, w), torch.from_numpy(jt), atol,
                   rtol)
    e, c, d, f = 2, 128, 256, 128
    xg, wg = _bf16(rng, e, c, d), _bf16(rng, e, d, f, scale=0.05)
    jg = torch.from_numpy(np.array(jops.moe_gmm(
        jnp.asarray(xg.float().numpy(), jnp.bfloat16),
        jnp.asarray(wg.float().numpy(), jnp.bfloat16), block_c=64,
        block_f=64, block_k=128, interpret=True).astype(jnp.float32)))
    assert _within(gemm_tile_emulation(xg, wg), jg, *_family_gate(jg))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_layouts_match_jax_grad(dtype):
    """dx and dw as one launch each would read them: on the tensor-core
    path (bf16) x, w and dy as they lie, with the layout flags; on the
    CUDA-core path (f32) transposed copies without flags.  Either way
    op(a) @ op(b) and ``moe_gmm_bwd``'s CPU path equal ``jax.grad`` of
    ``ecd,edf->ecf`` (C = 250, a capacity the tile does not divide)."""
    rng = np.random.default_rng(11)
    e, c, d, f = 2, 250, 64, 40
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w = (0.05 * rng.standard_normal((e, d, f))).astype(np.float32)
    dy = rng.standard_normal((e, c, f)).astype(np.float32)
    tx, tw, tdy = (torch.from_numpy(v).to(dtype) for v in (x, w, dy))
    jx, jw, jdy = (jnp.asarray(v.float().numpy()) for v in (tx, tw, tdy))
    gx, gw = jax.grad(lambda x, w: jnp.sum(
        jnp.einsum("ecd,edf->ecf", x, w) * jdy), argnums=(0, 1))(jx, jw)
    gx, gw = torch.from_numpy(np.array(gx)), torch.from_numpy(np.array(gw))
    tc = dtype == torch.bfloat16
    dx_ops = tmg.kernel_operands(tdy, tw, tb=True)
    dw_ops = tmg.kernel_operands(tx, tdy, ta=True)
    for (a, b, ta, tb, path), src, flags, want in (
            (dx_ops, (tdy, tw), (False, True), gx),
            (dw_ops, (tx, tdy), (True, False), gw)):
        assert path == (autotune.WGMMA if tc else autotune.CUDA_CORE)
        # no copy on the tensor-core path; flags cleared on the other
        assert ((a.data_ptr(), b.data_ptr())
                == (src[0].data_ptr(), src[1].data_ptr())) == tc
        assert (ta, tb) == (flags if tc else (False, False))
        got = gemm_tile_emulation(a, b, ta=ta, tb=tb) if tc else \
            moe_gmm_ref(a, b)
        if tc:
            assert _within(got, want, *_family_gate(want))
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    dx, dw = tmg.moe_gmm_bwd(tx, tw, tdy)
    for got, want in ((dx, gx), (dw, gw)):
        if tc:
            assert _within(got, want, *_family_gate(want))
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    assert _build.LAUNCHES["moe_gmm"] == 0


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_path_rule():
    """Granite's grouped products (forward, dx, dw) and the ring's
    per-step products at gpt-h2048's and internlm2-1.8b's exits take the
    tensor-core tile; 999 x 1001 x 997 and a base off 16 bytes take the
    mma.sync tile; f32 the CUDA-core tile."""
    e, c, d, f = 40, 1024, 1536, 512
    x, w, dy = _meta(e, c, d), _meta(e, d, f), _meta(e, c, f)
    for ops in ((x, w), (dy, w), (x, dy)):
        assert autotune.gemm_path(*ops) == autotune.WGMMA
    # ring exits at tp 2 and 4, x [rows, k_local] @ w [k_local, d]: the
    # attention and MLP exits of gpt-h2048 and internlm2-1.8b (both d 2048,
    # MLP 8192)
    for k_full, dd in ((2048, 2048), (8192, 2048)):
        for tp in (2, 4):
            k = k_full // tp
            assert autotune.gemm_path(_meta(4096, k), _meta(k, dd)) \
                == autotune.WGMMA
            assert autotune.shape_path(k, dd, torch.bfloat16) \
                == autotune.WGMMA
    assert autotune.gemm_path(_meta(999, 1001), _meta(1001, 997)) \
        == autotune.MMA_SYNC
    assert autotune.shape_path(1001, 997, torch.bfloat16) \
        == autotune.MMA_SYNC
    flat = torch.zeros(64 * 64 + 1, dtype=torch.bfloat16)
    off = flat[1:].view(64, 64)
    assert off.is_contiguous() and off.data_ptr() % 16 == 2
    assert autotune.gemm_path(off, flat[:4096].view(64, 64)) \
        == autotune.MMA_SYNC
    assert autotune.aligned16(off).data_ptr() % 16 == 0
    assert autotune.gemm_path(_meta(64, 64, dtype=torch.float32),
                              _meta(64, 64, dtype=torch.float32)) \
        == autotune.CUDA_CORE


def test_autotune_candidates_fit_and_the_key_carries_the_tile_version(
        tmp_path, monkeypatch):
    src = (_build.CSRC / "gemm_tc.cuh").read_text()
    stages = int(re.search(r"kStages = (\d+);", src).group(1))
    bm = int(re.search(r"constexpr int kBM = (\d+);", src).group(1))
    bk = int(re.search(r"constexpr int kBK = (\d+);", src).group(1))
    assert stages == autotune.TC_STAGES
    assert {b[0] for b in autotune.TC_BLOCKS} == {bm}
    assert {b[2] for b in autotune.TC_BLOCKS} == {bk}
    for m, k, n in ((2048, 4096, 2048), (1024, 1536, 512), (64, 64, 64),
                    (999, 1001, 997)):
        for path, itemsize in ((autotune.WGMMA, 2), (autotune.MMA_SYNC, 2),
                               (autotune.CUDA_CORE, 4)):
            cands = autotune.candidates(m, k, n, itemsize=itemsize,
                                        path=path)
            assert cands
            for c in cands:
                assert autotune.smem_bytes(*c, itemsize=itemsize, path=path) \
                    <= autotune.SMEM_BUDGET_BYTES
                if path == autotune.WGMMA:
                    assert c in autotune.TC_BLOCKS
    cache = tmp_path / "tiles.json"
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(cache))
    # a pick stored for the earlier tile, under the earlier key, is not read
    cache.write_text(json.dumps({"cpu|m2048k1024n2048|bfloat16": [64, 64,
                                                                  32]}))
    assert autotune.tuned_blocks(2048, 1024, 2048, torch.bfloat16) \
        == autotune.TC_DEFAULT_BLOCKS
    keys = [k for k in json.loads(cache.read_text()) if "m2048k1024" in k]
    assert f"cpu|{autotune.TILE_VERSION}|wgmma|m2048k1024n2048|bfloat16" \
        in keys


def test_wrappers_refuse_what_neither_tile_takes():
    """The checks that run before a launch (on a CUDA tensor the wrappers
    run them after the device test; here on CPU tensors)."""
    bf = torch.zeros(64, 64, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="one dtype"):
        tcm._check_pair("tile_matmul", bf, bf.float())
    with pytest.raises(TypeError, match="f32 or bf16"):
        tcm._check_pair("tile_matmul", bf.half(), bf.half())
    with pytest.raises(ValueError, match="contiguous"):
        tcm._check_pair("matmul_reducescatter", bf, bf.t())
    with pytest.raises(ValueError, match="shapes"):
        tcm._check_pair("tile_matmul", bf, bf[:32])
    tcm._check_pair("tile_matmul", bf, bf)
    a = torch.zeros(2, 250, 64, dtype=torch.bfloat16)
    b = torch.zeros(2, 64, 40, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="one dtype"):
        tmg._gmm_check("moe_gmm", a, b.float())
    with pytest.raises(ValueError, match="contiguous"):
        tmg._gmm_check("moe_gmm", a, b.transpose(1, 2), tb=True)
    with pytest.raises(ValueError, match="not \\[E, M, K\\]"):
        tmg._gmm_check("moe_gmm", a, b, ta=True)
    tmg._gmm_check("moe_gmm", a, b)
    tmg._gmm_check("moe_gmm", a, torch.zeros(2, 40, 64, dtype=torch.bfloat16),
                   tb=True)
    tmg._gmm_check("moe_gmm", a, torch.zeros(2, 250, 40,
                                             dtype=torch.bfloat16), ta=True)
