"""The port's MoE family against the JAX package on the CPU: the plain
grouped matmul against the Pallas kernel in interpret mode, the router,
the capacity and the dispatch positions, the MoE FFN and its gradients,
the grouped-matmul Function's gradients (its CPU path), the reduced
``granite-moe-3b-a800m`` loss, aux and every gradient leaf under
``megatron`` and ``oases`` (split 2: each sub-batch routes and sizes its
capacity alone) with fine and coarse recomputation, the trainer, the
launcher, the flash kernels' admission of granite's group of 3, and the
refusals (tp > 1, serving).  Inputs from numpy, handed to both frameworks.

Tolerances: products and the FFN 1e-5 (f32 sums in another order);
routing decisions identical and the aux within 1e-6; loss 1e-5 relative
and ``grads_err`` <= 1e-4 (``tests/_scripts/runner.py``'s formula);
trainer losses 1e-4 relative over 3 steps.
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
from repro.models import moe as jmoe
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels.moe_gmm import grouped_matmul, moe_gmm
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tprm

ARCH = "granite-moe-3b-a800m"


@pytest.mark.parametrize("e,c,d,f", [(2, 128, 256, 128), (4, 24, 64, 32),
                                     (3, 8, 512, 64)])
def test_moe_gmm_plain_matches_jax(e, c, d, f):
    """The plain version against the Pallas kernel (interpret mode) and
    JAX's oracle; the wrapper's CPU path is the plain version."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w = (0.05 * rng.standard_normal((e, d, f))).astype(np.float32)
    got = moe_gmm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jops.moe_gmm(jnp.asarray(x), jnp.asarray(w),
                                     interpret=True)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(jref.moe_gmm_ref(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-5, rtol=0)
    assert _build.LAUNCHES["moe_gmm"] == 0


def test_grouped_matmul_grads_match_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 10, 16)).astype(np.float32)
    w = rng.standard_normal((3, 16, 12)).astype(np.float32)
    dy = rng.standard_normal((3, 10, 12)).astype(np.float32)
    jgx, jgw = jax.grad(lambda x, w: jnp.sum(
        jnp.einsum("ecd,edf->ecf", x, w) * dy), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    y = grouped_matmul(tx, tw)
    assert "GroupedMatmulFunction" in type(y.grad_fn).__name__
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), atol=1e-5)


@pytest.mark.parametrize("t,k,e,factor", [(64, 2, 4, 1.25), (200, 8, 40, 1.25),
                                          (50, 2, 4, 0.3)])
def test_route_capacity_dispatch_match_jax(t, k, e, factor):
    """Experts, weights and the kept mask identical (the last case
    overflows the capacity), aux within 1e-6."""
    rng = np.random.default_rng(t)
    x = rng.standard_normal((t, 32)).astype(np.float32)
    rw = (0.3 * rng.standard_normal((32, e))).astype(np.float32)
    jw, je, jaux = jmoe.route(jnp.asarray(x), jnp.asarray(rw), k)
    tw, te, taux = tmoe.route(torch.from_numpy(x), torch.from_numpy(rw), k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    assert abs(taux.item() - float(jaux)) <= 1e-6
    cap = tmoe.capacity(t, k, e, factor)
    assert cap == jmoe.capacity(t, k, e, factor)
    jpos, jkeep = jmoe._dispatch_positions(je.reshape(-1), e, cap)
    tpos, tkeep = tmoe.dispatch_positions(te.reshape(-1), e, cap)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    if factor < 1:
        assert not tkeep.all()


def test_moe_ffn_and_grads_match_jax():
    """The FFN (``tmp`` sharding at tp=1) and its gradients in x and every
    weight, with some choices dropped by the capacity."""
    rng = np.random.default_rng(4)
    b, s, d, e, f, k = 2, 24, 32, 4, 16, 2
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    p = {"router": (0.3 * rng.standard_normal((d, e))).astype(np.float32),
         "w1": (0.1 * rng.standard_normal((e, d, f))).astype(np.float32),
         "w3": (0.1 * rng.standard_normal((e, d, f))).astype(np.float32),
         "w2": (0.1 * rng.standard_normal((e, f, d))).astype(np.float32)}
    kw = dict(num_experts=e, top_k=k, cap_factor=0.8)

    def jf(x, p):
        y, aux = jmoe.moe_ffn(x, p, sharding="tmp", tp_axes=(), **kw)
        return jnp.sum(y * jnp.cos(y)) + aux, (y, aux)

    (_, (jy, jaux)), (jgx, jgp) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()})
    tx = torch.from_numpy(x).requires_grad_()
    tp = {n: torch.from_numpy(v).requires_grad_() for n, v in p.items()}
    y, aux = tmoe.moe_ffn(tx, tp, **kw)
    (torch.sum(y * torch.cos(y)) + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5)
    assert abs(aux.item() - float(jaux)) <= 1e-6
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5)
    for n in p:
        np.testing.assert_allclose(tp[n].grad.numpy(), np.asarray(jgp[n]),
                                   atol=1e-5, err_msg=n)


@pytest.mark.parametrize("variant", fam.VARIANTS,
                         ids=lambda v: "-".join(map(str, v.values())))
def test_granite_loss_aux_and_grads_match_jax(variant):
    """Reduced granite-moe-3b-a800m (2 layers, d 128, 4 q / 2 kv heads of
    32, 4 experts of d_ff 64, top 2), batch 4, seq 64."""
    (jl, jaux, jg), (tl, taux, tg) = fam.loss_and_grads(ARCH, variant)
    assert set(tg) == set(jg)
    assert jaux > 0
    assert abs(taux - jaux) <= 1e-6
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert fam.grads_err(jg, tg) <= 1e-4


def test_granite_trainer_matches_jax(tmp_path):
    jlosses, tr, res = fam.trainer_losses(ARCH, tmp_path)
    assert res["final_step"] == 3
    np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-4)
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in tprm.flat_leaves(tr.params))


def test_granite_launcher_cpu(capsys):
    out = fam.launcher_cpu(ARCH, capsys)
    assert out["final_step"] == 2
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])


def test_granite_refuses_tp_and_serving():
    _, tcfg = fam.cfgs(ARCH)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A10"):
        tprm.check_tp(tcfg, 2)
    fam.serves(tcfg)


class _Launched(Exception):
    pass


@pytest.mark.parametrize("h,kvh,hd,admitted", [
    (24, 8, 64, True), (6, 2, 32, True), (12, 4, 128, True),
    (24, 8, 48, False)])
def test_flash_kernel_checks_admit_any_group(monkeypatch, h, kvh, hd,
                                             admitted):
    """The training kernels take any h that kvh divides (granite's 24 q /
    8 kv heads, a group of 3): with the device test forced to "CUDA", the
    wrapper's checks pass and it reaches the library (stubbed here); an
    uncompiled head dim still raises."""
    monkeypatch.setattr(_build, "on_cpu", lambda what, *t: False)

    def library():
        raise _Launched
    monkeypatch.setattr(_build, "library", library)
    q = torch.zeros(1, 16, h, hd)
    k = torch.zeros(1, 16, kvh, hd)
    if admitted:
        with pytest.raises(_Launched):
            tflash.flash_attention_fwd(q, k, k)
    else:
        with pytest.raises(ValueError, match="hd in"):
            tflash.flash_attention_fwd(q, k, k)
