"""The arithmetic of the bf16 flash-attention backward tiles on the tensor
cores (``csrc/flash_bwd_tc.cuh``), stated in plain torch and held to the
port's plain version and to ``jax.grad`` of JAX's attention.

The tiles take bf16 q, k, v, dout and the forward's bf16 out and f32 lse;
delta = rowsum(dout * out) in f32; per 64-row q tile and 64-key tile they
sum S = Q K^T and dP = dO V^T in f32 and scale S after the product, cap
it, mask it, form P = exp(S - lse) and dS = P (dP - delta) (times
1 - tanh^2 under a softcap) in f32, and add dV += P^T dO, dK += dS^T Q and
dQ += dS K with P and dS as two bf16 halves each, ``hi = bf16(x)`` and
``lo = bf16(x - hi)``, each its own product into the f32 sum; dK and dQ
are scaled once at the end.  :func:`bwd_tile_emulation` does the same on
the CPU (the card sums in another order, so it pins the roundings, not
the bits).  It must stay within the card's gate for a bf16 flash backward
against the plain version (``chip_smoke.py``'s
``FLASH_TOL["bfloat16"]["grad"]``: atol 1e-4, one bf16 ulp) and near
``jax.grad`` of ``chunked_attention``; P or dS rounded once to bf16 does
not stay within that gate.  Inputs are made with numpy from a seed.
"""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref

TILE = 64
# chip_smoke.py FLASH_TOL["bfloat16"]["grad"]: (atol, rtol) for dq, dk, dv
GRAD_TOL = (1e-4, 2 ** -7)
# against jax.grad in f32 of the same bf16 inputs: the tiles (and the
# plain version, as far) take delta = rowsum(dout * out) from the
# forward's bf16 out, JAX from its f32 out, which moves every dS of a row
# by up to a bf16 ulp of out; that puts dq and dk up to ~1.6e-2 from
# JAX's at these magnitudes (|grad| < ~8), near-zero elements included
JAX_TOL = (2e-2, 2 ** -7)

# (hd, s, h, kvh, window, softcap): every head dim the tiles are built
# for, GQA, ragged s (not a multiple of 64), s under one tile, window,
# softcap
CASES = [
    (32, 160, 2, 1, None, 0.0),
    (64, 128, 2, 2, None, 0.0),
    (64, 150, 3, 1, 48, 30.0),
    (128, 160, 2, 1, None, 0.0),
    (128, 40, 2, 1, 16, 30.0),
    (128, 100, 1, 1, 32, 0.0),
    (256, 160, 2, 1, None, 0.0),
    (256, 130, 2, 1, 64, 50.0),
]
# for jax.grad (~3.5 s of XLA compilation each): hd 64 and 256, a group
# of 3, ragged s, window and softcap between them
JAX_CASES = [CASES[2], CASES[7]]


def _case_id(c):
    hd, s, h, kvh, window, softcap = c
    return f"hd{hd}-s{s}-h{h}kv{kvh}-w{window}-cap{softcap:g}"


def _halves(x, split):
    """x as the bf16 values its products take: [hi, lo], or [bf16(x)]."""
    hi = x.bfloat16().float()
    return [hi, (x - hi).bfloat16().float()] if split else [hi]


def bwd_tile_emulation(q, k, v, out, lse, dout, *, causal=True, window=None,
                       softcap=0.0, scale=None, split_p=True, split_ds=True):
    """bf16 q, dout, out [b, s, h, hd], k, v [b, s, kvh, hd], f32 lse
    [b, h, s] -> bf16 (dq, dk, dv) with the tensor-core tiles' roundings;
    ``split_p=False`` rounds P to bf16 once for dV, ``split_ds=False`` dS
    for dK and dQ."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = hd ** -0.5 if scale is None else scale

    def heads(t, rep=1):                            # -> [b, h, s, hd] f32
        return t.float().permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)

    qf, dof, of = heads(q), heads(dout), heads(out)
    kf, vf = heads(k, g), heads(v, g)
    delta = (dof * of).sum(dim=-1)
    dq, dk, dv = (torch.zeros(b, h, s, hd) for _ in range(3))
    for q0 in range(0, s, TILE):
        q1 = min(q0 + TILE, s)
        qpos = torch.arange(q0, q1)[:, None]
        for k0 in range(0, s, TILE):
            k1 = min(k0 + TILE, s)
            kpos = torch.arange(k0, k1)[None, :]
            vis = torch.ones(q1 - q0, k1 - k0, dtype=torch.bool)
            if causal:
                vis &= kpos <= qpos
            if window is not None:
                vis &= kpos > qpos - window
            if not vis.any():
                continue
            sc = torch.matmul(qf[:, :, q0:q1],
                              kf[:, :, k0:k1].transpose(-1, -2)) * scale
            dt = 1.0
            if softcap:
                th = torch.tanh(sc / softcap)
                sc, dt = softcap * th, 1.0 - th * th
            p = torch.where(vis, torch.exp(sc - lse[:, :, q0:q1, None]),
                            torch.zeros(()))
            dp = torch.matmul(dof[:, :, q0:q1],
                              vf[:, :, k0:k1].transpose(-1, -2))
            ds = p * dt * (dp - delta[:, :, q0:q1, None])
            for ph in _halves(p, split_p):
                dv[:, :, k0:k1] += torch.matmul(ph.transpose(-1, -2),
                                                dof[:, :, q0:q1])
            for dh in _halves(ds, split_ds):
                dk[:, :, k0:k1] += torch.matmul(dh.transpose(-1, -2),
                                                qf[:, :, q0:q1])
                dq[:, :, q0:q1] += torch.matmul(dh, kf[:, :, k0:k1])

    def back(t, mul, kv):
        if kv:                                # the g q heads of a kv head
            t = t.reshape(b, kvh, g, s, hd).sum(dim=2)
        return (t * mul).permute(0, 2, 1, 3).to(torch.bfloat16).contiguous()

    return back(dq, scale, False), back(dk, scale, True), back(dv, 1.0, True)


def _inputs(hd, s, h, kvh, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16)
        for shape in ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd),
                      (b, s, h, hd)))


def _within(got, want, atol, rtol):
    """(max |got - want|, whether every element is within atol + rtol
    |want|), as chip_smoke.py's gate reads it."""
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), bool((diff <= atol + rtol * want.float().abs())
                                   .all())


def _grads(case, seed=0, **split):
    """(tile emulation's, plain version's) (dq, dk, dv) of one case, from
    the plain forward's out and lse, and the inputs."""
    hd, s, h, kvh, window, softcap = case
    q, k, v, dout = _inputs(hd, s, h, kvh, seed=seed)
    kw = dict(causal=True, window=window, softcap=softcap)
    out, lse = flash_attention_ref(q, k, v, **kw)
    got = bwd_tile_emulation(q, k, v, out, lse, dout, **kw, **split)
    want = flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    return got, want, (q, k, v, dout)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_bwd_tile_emulation_within_the_plain_versions_gate(case):
    got, want, (q, k, v, _) = _grads(case)
    for name, g, w, like in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == like.shape
        err, ok = _within(g, w, *GRAD_TOL)
        assert ok, f"{name}: max abs err {err} beyond {GRAD_TOL}"


@pytest.mark.parametrize("case", JAX_CASES, ids=_case_id)
def test_bwd_tile_emulation_near_jax_grad(case):
    hd, s, h, kvh, window, softcap = case
    got, _, inputs = _grads(case, seed=1)
    q, k, v, dout = (t.float().numpy() for t in inputs)
    kw = dict(causal=True, window=window, softcap=softcap)
    jgrads = jax.grad(lambda q, k, v: jnp.sum(jax_chunked(q, k, v, **kw)
                                              * dout),
                      argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for name, g, w in zip(("dq", "dk", "dv"), got, jgrads):
        err, ok = _within(g, torch.from_numpy(np.array(w)), *JAX_TOL)
        assert ok, f"{name}: max abs err {err} beyond {JAX_TOL}"


@pytest.mark.parametrize("grad,split", [("dv", dict(split_p=False)),
                                        ("dk", dict(split_ds=False)),
                                        ("dq", dict(split_ds=False))])
def test_rounding_once_misses_the_gate(grad, split):
    """The reason for the splits: with P (dV's product) or dS (dK's and
    dQ's) rounded once to bf16, that gradient leaves the gate; the other
    gradients, still split, stay within it."""
    got, want, _ = _grads((128, 160, 2, 1, None, 0.0), **split)
    oks = {name: _within(g, w, *GRAD_TOL)[1]
           for name, g, w in zip(("dq", "dk", "dv"), got, want)}
    missed = {"dv": {"dv"}, "dk": {"dk", "dq"}, "dq": {"dk", "dq"}}[grad]
    assert {n for n, ok in oks.items() if not ok} == missed


def test_backward_kernel_refuses_unaligned_bf16():
    """The backward tiles' tensor maps read q, k, v and dout: its checks
    refuse a contiguous bf16 view of any of them at an offset that is not
    16-byte aligned (on a CUDA tensor the wrapper runs them before the
    launch), and take an unaligned out (read without a map) and aligned
    bf16 or f32 at any offset."""
    from repro_torch.kernels.flash_attention import _kernel_check
    n = 2 * 64 * 2 * 64
    flat = torch.zeros(n + 1, dtype=torch.bfloat16)
    bad = flat[1:].view(2, 64, 2, 64)
    good = flat[:n].view(2, 64, 2, 64)
    assert bad.is_contiguous() and bad.data_ptr() % 16 == 2
    lse = torch.zeros(2, 2, 64)
    for i in range(4):                          # q, k, v, dout
        tensors = [good] * 5
        tensors[i] = bad
        with pytest.raises(ValueError, match="16-byte aligned"):
            _kernel_check(tuple(tensors), (lse,), tma=4)
    _kernel_check((good,) * 4 + (bad,), (lse,), tma=4)      # out
    _kernel_check((good,) * 5, (lse,), tma=4)
    f32 = torch.zeros(n + 1)[1:].view(2, 64, 2, 64)
    _kernel_check((f32,) * 5, (lse,), tma=4)
