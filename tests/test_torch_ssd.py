"""The port's Mamba2 SSD family against the JAX package on the CPU: the
plain chunked SSD and its sequential oracle, the causal depthwise conv,
the plain chunked backward (the SSD backward kernel's plain version)
against ``jax.grad`` and against autograd in f64, the SSD kernel's
autograd Function (its CPU path), the reduced
``mamba2-130m`` loss and every gradient leaf under ``megatron`` and
``oases`` with fine and coarse recomputation, the trainer, the launcher,
and the refusals (tp > 1, serving).  Inputs from numpy, handed to both
frameworks.

Tolerances: the chunked SSD and the conv 1e-5 (f32 sums in another
order); the chunked form against the sequential oracle 1e-5 relative to
the largest |y| (a different algorithm); loss 1e-5 relative and
``grads_err`` <= 1e-4 (``tests/_scripts/runner.py``'s formula); trainer
losses 1e-4 relative over 3 steps; the plain backward 1e-5 of each
gradient's largest |value| against ``jax.grad`` (f32 sums in another
order) and 1e-10 relative against autograd of the plain forward in f64
(the same sums in f64).
"""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_family as fam
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import rglru as jrglru
from repro.models import ssd as jssd
from repro_torch.kernels import _build
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd as tssd
from repro_torch.kernels.ssd import SSDFunction, ssd, ssd_bwd, ssd_fwd
from repro_torch.models import params as tprm
from repro_torch.models.rglru import depthwise_conv1d
from repro_torch.models.ssd import ssd_chunked, ssd_sequential

ARCH = "mamba2-130m"


def _inputs(b, s, h, p, n, seed=7, dt_shift=0.0):
    """The JAX kernel test's scales: x 0.5 N(0, 1), dt softplus(N(0, 1) +
    dt_shift), A_log 0.1 N(0, 1), B and C 0.3 N(0, 1), D 1 + 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (0.5 * rng.standard_normal((b, s, h, p))).astype(f), \
        np.log1p(np.exp(rng.standard_normal((b, s, h))
                        + dt_shift)).astype(f), \
        (0.1 * rng.standard_normal(h)).astype(f), \
        (0.3 * rng.standard_normal((b, s, n))).astype(f), \
        (0.3 * rng.standard_normal((b, s, n))).astype(f), \
        (1.0 + 0.1 * rng.standard_normal(h)).astype(f)


# (b, s, h, p, n, chunk): one chunk shorter than the default (s < chunk),
# several chunks, a chunk that is no power of two
SHAPES = [(2, 48, 3, 16, 8, 128), (1, 128, 2, 32, 16, 64),
          (2, 256, 4, 64, 32, 128), (1, 96, 2, 8, 4, 24)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_ssd_chunked_matches_jax(b, s, h, p, n, chunk):
    """y and the final state against JAX's ``ssd_chunked``; y against the
    Pallas kernel in interpret mode (chunk min(chunk, s)) and against the
    sequential oracle ``ref.ssd_ref``, with the port's own oracle."""
    ins = _inputs(b, s, h, p, n)
    y, st = ssd_chunked(*map(torch.from_numpy, ins), chunk=chunk)
    jy, jst = jssd.ssd_chunked(*map(jnp.asarray, ins), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=1e-5,
                               rtol=0)
    ky = jops.ssd(*map(jnp.asarray, ins), chunk=min(chunk, s),
                  interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ky), atol=1e-5, rtol=0)
    ry, rst = jref.ssd_ref(*map(jnp.asarray, ins))
    sy, sst = ssd_sequential(*map(torch.from_numpy, ins))
    scale = float(np.abs(np.asarray(ry)).max())
    np.testing.assert_allclose(sy.numpy(), np.asarray(ry), atol=1e-5 * scale,
                               rtol=0)
    np.testing.assert_allclose(sst.numpy(), np.asarray(rst), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=1e-5 * scale,
                               rtol=0)
    # the kernel wrapper's CPU path is the plain chunked y
    np.testing.assert_array_equal(
        ssd_fwd(*map(torch.from_numpy, ins), chunk=chunk).numpy(), y.numpy())


@pytest.mark.parametrize("with_state", [False, True])
def test_depthwise_conv1d_matches_jax(with_state):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 17, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    kw = {"state": st} if with_state else {}
    y, ns = depthwise_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                             **{k: torch.from_numpy(v) for k, v in kw.items()})
    jy, jns = jrglru.depthwise_conv1d(jnp.asarray(x), jnp.asarray(w),
                                      **{k: jnp.asarray(v)
                                         for k, v in kw.items()})
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ns.numpy(), np.asarray(jns))


def _jax_grads(ins, dy, chunk, argnums=tuple(range(6))):
    def jf(*a):
        return jnp.sum(jssd.ssd_chunked(*a, chunk=chunk)[0] * dy)
    return jax.jit(jax.grad(jf, argnums=argnums))(*map(jnp.asarray, ins))


def _cotangent(ins, seed=12):
    return np.random.default_rng(seed).standard_normal(
        ins[0].shape).astype(np.float32)


# the gradient tests' steps: dt = softplus(N(0, 1) - 2) ~ 0.13, the
# mixer's scale (chip_smoke.py ``_ssd_inputs``).  At dt ~ 0.7 a chunk of
# 128 decays by ~e^-90: JAX masks exp(la_i - la_j) after the exp, so the
# masked pairs overflow to inf and ``jax.grad`` gives NaN there (the
# port's versions mask before the exp)
DT_SHIFT = -2.0


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_ssd_bwd_ref_matches_jax(b, s, h, p, n, chunk):
    """The plain chunked backward, every gradient against ``jax.grad`` of
    JAX's ``ssd_chunked`` within 1e-5 of its largest |value|."""
    ins = _inputs(b, s, h, p, n, seed=3, dt_shift=DT_SHIFT)
    dy = _cotangent(ins)
    got = tref.ssd_bwd_ref(*map(torch.from_numpy, ins), torch.from_numpy(dy),
                           chunk=chunk)
    for name, g, jg in zip(("dx", "ddt", "dA_log", "dB", "dC", "dD"), got,
                           _jax_grads(ins, dy, chunk)):
        want = np.asarray(jg)
        assert g.dtype == torch.float32 and g.shape == want.shape, name
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5 * scale,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_ssd_bwd_ref_matches_f64_autograd(b, s, h, p, n, chunk):
    """In f64, the plain backward against autograd of the plain forward
    (the chunked form, f64 throughout) within 1e-10 relative."""
    ins = [torch.from_numpy(a.astype(np.float64))
           for a in _inputs(b, s, h, p, n, seed=4)]
    dy = torch.from_numpy(_cotangent(ins, seed=5).astype(np.float64))
    leaves = [t.clone().requires_grad_() for t in ins]
    y, _ = ssd_chunked(*leaves, chunk=chunk)
    want = torch.autograd.grad(y, leaves, dy)
    got = tref.ssd_bwd_ref(*ins, dy, chunk=chunk)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert float((g - w).abs().max() / w.abs().max()) <= 1e-10


def test_ssd_bwd_cpu_path_reaches_no_forward(monkeypatch):
    """The Function's CPU backward is the plain backward: it calls neither
    ``ssd_chunked`` nor any other forward of the SSD."""
    ins = [torch.from_numpy(a).requires_grad_()
           for a in _inputs(1, 64, 2, 8, 4, seed=6)]
    y = ssd(*ins, chunk=16)

    def refuse(*a, **k):
        raise AssertionError("the backward reached a forward")
    for name in ("ssd_chunked", "ssd_ref", "ssd_sequential"):
        monkeypatch.setattr(tref, name, refuse)
    monkeypatch.setattr(tssd, "ssd_ref", refuse)
    y.sum().backward()
    assert all(t.grad is not None for t in ins)
    assert _build.LAUNCHES["ssd_bwd"] == 0


def test_ssd_function_honours_needs_input_grad():
    """Only the inputs that need a gradient get one, each equal to the
    plain backward's (the CPU path), and against JAX's."""
    ins = _inputs(2, 64, 3, 16, 8, seed=8)
    dy = _cotangent(ins, seed=9)
    need = (False, True, True, False, True, False)
    ts = [torch.from_numpy(a).requires_grad_(g) for a, g in zip(ins, need)]
    (ssd(*ts, chunk=32) * torch.from_numpy(dy)).sum().backward()
    full = ssd_bwd(*map(torch.from_numpy, ins), torch.from_numpy(dy),
                   chunk=32)
    argnums = tuple(i for i, g in enumerate(need) if g)
    jg = iter(_jax_grads(ins, dy, 32, argnums))
    for t, g, want in zip(ts, need, full):
        if not g:
            assert t.grad is None
            continue
        np.testing.assert_array_equal(t.grad.numpy(), want.numpy())
        j = np.asarray(next(jg))
        np.testing.assert_allclose(t.grad.numpy(), j,
                                   atol=1e-5 * float(np.abs(j).max()), rtol=0)


def test_ssd_function_grads_match_jax():
    """The Function's CPU path (forward: the plain version; backward: the
    plain backward ``ssd_bwd_ref``) against ``jax.grad`` of JAX's
    ``ssd_chunked``, in every input, for a random cotangent."""
    ins = _inputs(2, 96, 3, 16, 8, seed=11)
    dy = np.random.default_rng(12).standard_normal(ins[0].shape).astype(
        np.float32)

    def jf(*a):
        return jnp.sum(jssd.ssd_chunked(*a, chunk=32)[0] * dy)

    jg = jax.jit(jax.grad(jf, argnums=tuple(range(6))))(
        *map(jnp.asarray, ins))
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    y = ssd(*ts, chunk=32)
    assert y.grad_fn is not None and "SSDFunction" in type(y.grad_fn).__name__
    (y * torch.from_numpy(dy)).sum().backward()
    for t, g in zip(ts, jg):
        scale = float(np.abs(np.asarray(g)).max())
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=1e-5 * scale, rtol=0)
    # inputs that need no gradient get none
    x = torch.from_numpy(ins[0]).requires_grad_()
    out = SSDFunction.apply(x, *map(torch.from_numpy, ins[1:]), 32)
    out.sum().backward()
    assert x.grad is not None


def test_ssd_wrapper_checks_shapes_and_devices():
    ins = [torch.from_numpy(a) for a in _inputs(1, 64, 2, 8, 4)]
    with pytest.raises(ValueError, match="divide by chunk"):
        ssd_fwd(*ins, chunk=48)
    with pytest.raises(ValueError, match="do not match"):
        ssd_fwd(ins[0], ins[1][:, :, :1], *ins[2:])
    with pytest.raises(ValueError, match="same CUDA device"):
        ssd_fwd(ins[0].to("meta"), *ins[1:])
    with pytest.raises(ValueError, match="is not like x"):
        ssd_bwd(*ins, ins[0][:, :32], chunk=16)
    with pytest.raises(ValueError, match="same CUDA device"):
        ssd_bwd(*ins, ins[0].to("meta"), chunk=16)
    assert _build.LAUNCHES["ssd"] == 0 and _build.LAUNCHES["ssd_bwd"] == 0


@pytest.mark.parametrize("variant", fam.VARIANTS,
                         ids=lambda v: "-".join(map(str, v.values())))
def test_mamba2_loss_and_grads_match_jax(variant):
    """Reduced mamba2-130m (2 SSD layers, d 128, 8 heads of 32, state 16,
    tied embeddings), batch 4, seq 64 (one chunk of 64)."""
    (jl, jaux, jg), (tl, taux, tg) = fam.loss_and_grads(ARCH, variant)
    assert set(tg) == set(jg)
    assert "['lm_head']" not in tg
    assert taux == jaux == 0.0
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert fam.grads_err(jg, tg) <= 1e-4


def test_mamba2_trainer_matches_jax(tmp_path):
    jlosses, tr, res = fam.trainer_losses(ARCH, tmp_path)
    assert res["final_step"] == 3
    np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-4)
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in tprm.flat_leaves(tr.params))


def test_mamba2_launcher_cpu(capsys):
    out = fam.launcher_cpu(ARCH, capsys)
    assert out["final_step"] == 2
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])


def test_mamba2_refuses_tp_and_serving():
    _, tcfg = fam.cfgs(ARCH)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A10"):
        tprm.check_tp(tcfg, 2)
    fam.serves(tcfg)
    tprm.check_tp(tcfg, 1)
