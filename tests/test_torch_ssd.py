"""The port's Mamba2 SSD family against the JAX package on the CPU: the
plain chunked SSD and its sequential oracle, the causal depthwise conv,
the SSD kernel's autograd Function (its CPU path), the reduced
``mamba2-130m`` loss and every gradient leaf under ``megatron`` and
``oases`` with fine and coarse recomputation, the trainer, the launcher,
and the refusals (tp > 1, serving).  Inputs from numpy, handed to both
frameworks.

Tolerances: the chunked SSD and the conv 1e-5 (f32 sums in another
order); the chunked form against the sequential oracle 1e-5 relative to
the largest |y| (a different algorithm); loss 1e-5 relative and
``grads_err`` <= 1e-4 (``tests/_scripts/runner.py``'s formula); trainer
losses 1e-4 relative over 3 steps.
"""
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
from repro_torch.kernels.ssd import SSDFunction, ssd, ssd_fwd
from repro_torch.models import params as tprm
from repro_torch.models.rglru import depthwise_conv1d
from repro_torch.models.ssd import ssd_chunked, ssd_sequential
from repro_torch.serving import ServingEngine

ARCH = "mamba2-130m"


def _inputs(b, s, h, p, n, seed=7):
    """The JAX kernel test's scales: x 0.5 N(0, 1), dt softplus(N(0, 1)),
    A_log 0.1 N(0, 1), B and C 0.3 N(0, 1), D 1 + 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (0.5 * rng.standard_normal((b, s, h, p))).astype(f), \
        np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f), \
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


def test_ssd_function_grads_match_jax():
    """The Function's CPU path (forward: the plain version; backward: the
    plain version replayed under autograd) against ``jax.grad`` of JAX's
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
    assert _build.LAUNCHES["ssd"] == 0


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
    with pytest.raises(NotImplementedError, match="ROADMAP.md A10"):
        ServingEngine(tcfg, slots=2, max_seq=32, device="cpu")
    tprm.check_tp(tcfg, 1)
