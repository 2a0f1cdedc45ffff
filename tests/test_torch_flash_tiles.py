"""The arithmetic of the bf16 flash-attention forward tile on the tensor
cores (``csrc/flash_fwd_tc.cuh``), stated in plain torch and held to the
port's plain version and to the JAX kernel.

The tile takes bf16 q, k and v; sums Q K^T in f32 and scales it after the
product; folds 64-key tiles into an f32 online softmax; and adds P V with
P as two bf16 halves, ``P_hi = bf16(P)`` and ``P_lo = bf16(P - P_hi)``,
each its own product into the f32 O.  :func:`tile_emulation` does the
same on the CPU (the card's sums run in another order, so it pins the
roundings, not the bits).  It must stay within the card's gate for a bf16
flash forward against the plain version (``chip_smoke.py``'s
``FLASH_TOL["bfloat16"]``: out one bf16 ulp, lse 1e-5) and within one
bf16 ulp of JAX's Pallas kernel in interpret mode; P rounded once to bf16
does not stay within that gate.  Inputs are made with numpy from a seed.
"""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels.ref import flash_attention_ref

KEY_TILE = 64
# chip_smoke.py FLASH_TOL["bfloat16"]: (atol, rtol) for out and lse
BF16_TOL = {"out": (1e-5, 2 ** -7), "lse": (1e-5, 1e-5)}

# (hd, s, h, kvh, window, softcap): every head dim the tile is built for,
# GQA, ragged s (not a multiple of the 64-key tile), window, softcap
CASES = [
    (32, 160, 2, 1, None, 0.0),
    (64, 128, 2, 2, None, 0.0),
    (64, 150, 2, 1, 48, 30.0),
    (128, 160, 2, 1, None, 0.0),
    (128, 100, 1, 1, 32, 0.0),
    (256, 160, 2, 1, None, 0.0),
    (256, 130, 2, 1, 64, 50.0),
]


def _case_id(c):
    hd, s, h, kvh, window, softcap = c
    return f"hd{hd}-s{s}-h{h}kv{kvh}-w{window}-cap{softcap:g}"


def tile_emulation(q, k, v, *, causal=True, window=None, softcap=0.0,
                   scale=None, split_p=True):
    """bf16 q [b, s, h, hd], k, v [b, s, kvh, hd] -> (out [b, s, h, hd]
    bf16, lse [b, h, s] f32) with the tensor-core tile's roundings;
    ``split_p=False`` rounds P to bf16 once instead."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    qf = q.float().permute(0, 2, 1, 3)                       # [b, h, s, hd]
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    m = torch.full((b, h, s), -1e30)
    l = torch.zeros(b, h, s)
    o = torch.zeros(b, h, s, hd)
    qpos = torch.arange(s)[:, None]
    for k0 in range(0, s, KEY_TILE):
        k1 = min(k0 + KEY_TILE, s)
        kpos = torch.arange(k0, k1)[None, :]
        sc = torch.matmul(qf, kf[:, :, k0:k1].transpose(-1, -2)) * scale
        if softcap:
            sc = softcap * torch.tanh(sc / softcap)
        vis = torch.ones(s, k1 - k0, dtype=torch.bool)
        if causal:
            vis &= kpos <= qpos
        if window is not None:
            vis &= kpos > qpos - window
        sc = torch.where(vis, sc, torch.tensor(-torch.inf))
        mx = torch.maximum(m, sc.amax(dim=-1))
        corr = torch.exp(m - mx)
        p = torch.exp(sc - mx[..., None])
        l = l * corr + p.sum(dim=-1)
        m = mx
        o = o * corr[..., None]
        p_hi = p.bfloat16().float()
        o = o + torch.matmul(p_hi, vf[:, :, k0:k1])
        if split_p:
            p_lo = (p - p_hi).bfloat16().float()
            o = o + torch.matmul(p_lo, vf[:, :, k0:k1])
    lf = torch.clamp(l, min=1e-30)
    out = (o / lf[..., None]).to(torch.bfloat16).permute(0, 2, 1, 3)
    return out.contiguous(), m + torch.log(lf)


def _inputs(hd, s, h, kvh, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16)
        for shape in ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd)))


def _within(got, want, atol, rtol):
    """(max |got - want|, whether every element is within atol + rtol
    |want|), as chip_smoke.py's gate reads it."""
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), bool((diff <= atol + rtol * want.float().abs())
                                   .all())


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tile_emulation_within_the_plain_versions_gate(case):
    hd, s, h, kvh, window, softcap = case
    q, k, v = _inputs(hd, s, h, kvh)
    kw = dict(causal=True, window=window, softcap=softcap)
    out, lse = tile_emulation(q, k, v, **kw)
    want_out, want_lse = flash_attention_ref(q, k, v, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    for name, got, want in (("out", out, want_out), ("lse", lse, want_lse)):
        err, ok = _within(got, want, *BF16_TOL[name])
        assert ok, f"{name}: max abs err {err} beyond {BF16_TOL[name]}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tile_emulation_within_one_ulp_of_jax(case):
    hd, s, h, kvh, window, softcap = case
    q, k, v = _inputs(hd, s, h, kvh, seed=1)
    kw = dict(causal=True, window=window, softcap=softcap)
    out, _ = tile_emulation(q, k, v, **kw)
    jargs = [jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
             for t in (q, k, v)]
    want = torch.from_numpy(np.array(
        jops.flash_attention(*jargs, interpret=True, **kw)
        .astype(jnp.float32)))
    err, ok = _within(out, want, *BF16_TOL["out"])
    assert ok, f"out: max abs err {err} beyond {BF16_TOL['out']}"


def test_p_rounded_once_misses_the_gate():
    """The reason for the split: with P rounded once to bf16, ``out``
    leaves one bf16 ulp of the plain version."""
    q, k, v = _inputs(128, 160, 2, 1)
    out, _ = tile_emulation(q, k, v, split_p=False)
    want, _ = flash_attention_ref(q, k, v)
    _, ok = _within(out, want, *BF16_TOL["out"])
    assert not ok


def test_forward_kernel_refuses_unaligned_bf16():
    """The tile's tensor maps need 16-byte-aligned q, k, v: the forward's
    checks refuse a contiguous bf16 view at another offset with a message
    (on a CUDA tensor the wrapper runs them before the launch), and take
    aligned bf16 and f32 at any offset."""
    from repro_torch.kernels.flash_attention import _kernel_check
    n = 2 * 64 * 2 * 64
    flat = torch.zeros(n + 1, dtype=torch.bfloat16)
    q = flat[1:].view(2, 64, 2, 64)
    assert q.is_contiguous() and q.data_ptr() % 16 == 2
    k = v = flat[:n].view(2, 64, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _kernel_check((q, k, v), tma=3)
    _kernel_check((q, k, v))                 # no tensor maps
    _kernel_check((k, k, v), tma=3)
    f32 = torch.zeros(n + 1)[1:].view(2, 64, 2, 64)
    _kernel_check((f32, f32, f32), tma=3)
