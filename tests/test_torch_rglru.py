"""The port's RG-LRU hybrid (recurrentgemma-9b) against the JAX package on
the CPU: the plain RG-LRU against JAX's ``ref.rglru_ref`` and the Pallas
kernel in interpret mode (``ops.rglru``), its plain backward and the
kernel's autograd Function (its CPU path) against ``jax.grad`` of
``rglru_scan``, the reduced ``recurrentgemma-9b`` loss and every gradient
leaf under ``megatron`` and ``oases`` with fine and coarse recomputation,
the trainer, the launcher, and the refusals (tp > 1, serving).  Inputs
import _torch_threads  # noqa: F401  (one torch thread: see the module)
from numpy, handed to both frameworks.

The model cases replace ``reduced()``'s 6 layers by 8 and run seq 128:
6 layers are two whole (rglru, rglru, local) blocks and leave the tail
unrun, and ``reduced()``'s window of 64 masks nothing at a sequence of 64
(a key is visible while ``k_pos > q_pos - window``).  8 layers are two
blocks and a tail of two RG-LRU layers; at seq 128 the window hides the
keys more than 63 positions back.

Tolerances: the RG-LRU forward 1e-5 of the largest |y| in f32 (the TPU
kernel's sequential walk against JAX's associative scan, f32 sums in
another order), one bf16 ulp (rtol 2**-7) in bf16, where both round the
same f32 state once; its gradients 1e-5 of each one's largest |value|
(f32); loss 1e-5 relative and ``grads_err`` <= 1e-4
(``tests/_scripts/runner.py``'s formula); trainer losses 1e-4 relative
over 3 steps.
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
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (RGLRU_GATES, rglru_bwd_ref, rglru_ref,
                                    rglru_states_ref)
from repro_torch.kernels.rglru import (RGLRUFunction, rglru, rglru_bwd,
                                      rglru_fwd)
from repro_torch.models import params as tprm
from repro_torch.models.rglru import rglru_scan

ARCH = "recurrentgemma-9b"
LAYERS = 8          # two (rglru, rglru, local) blocks and a tail of two
SEQ = 128           # longer than reduced()'s window of 64
BF16_ULP = 2 ** -7


def _inputs(b, s, w, seed=7):
    """x ~ N(0, 1) and gate vectors that spread the decay a over (0, 1):
    w_a, w_x ~ N(0, 1), b_a, b_x ~ 0.5 N(0, 1), a_param ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, s, w)).astype(f)
    gates = {"w_a": rng.standard_normal(w), "b_a": 0.5 * rng.standard_normal(w),
             "w_x": rng.standard_normal(w), "b_x": 0.5 * rng.standard_normal(w),
             "a_param": rng.standard_normal(w)}
    return x, {k: v.astype(f) for k, v in gates.items()}


def _bf16_np(x):
    """x rounded to bf16, as f32 numpy (the value both frameworks see)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


# (b, s, w): JAX's block sizes (64 steps, 512 channels) fit whole, a
# sequence shorter than a block, and several blocks of both
SHAPES = [(2, 128, 96), (1, 40, 64), (1, 192, 1024)]


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,w", SHAPES)
def test_rglru_ref_matches_jax(b, s, w, dname):
    """y against JAX's ``ref.rglru_ref`` (the associative scan) and the
    Pallas kernel in interpret mode; h_last (the rounded last y) against
    the Pallas kernel's, and in f32 against ``ref.rglru_ref``'s f32
    state."""
    x, gates = _inputs(b, s, w)
    if dname == "bfloat16":
        x = _bf16_np(x)
    tdt, jdt = getattr(torch, dname), getattr(jnp, dname)
    y, h_last = rglru_ref(torch.from_numpy(x).to(tdt),
                          {k: torch.from_numpy(v) for k, v in gates.items()})
    assert y.dtype == tdt and h_last.dtype == torch.float32
    jg = {k: jnp.asarray(v) for k, v in gates.items()}
    ry, rh = jref.rglru_ref(jnp.asarray(x, jdt), jg)
    ky, kh = jops.rglru(jnp.asarray(x, jdt), jg, interpret=True)
    yf = y.float().numpy()
    rtol = BF16_ULP if dname == "bfloat16" else 0.0
    for want in (ry, ky):
        want = np.asarray(want.astype(jnp.float32))
        atol = 1e-5 * float(np.abs(want).max())
        np.testing.assert_allclose(yf, want, atol=atol, rtol=rtol)
    kh = np.asarray(kh)
    np.testing.assert_allclose(h_last.numpy(), kh,
                               atol=1e-5 * float(np.abs(kh).max()),
                               rtol=rtol)
    np.testing.assert_array_equal(h_last.numpy(), yf[:, -1])
    if dname == "float32":
        rh = np.asarray(rh)
        np.testing.assert_allclose(h_last.numpy(), rh,
                                   atol=1e-5 * float(np.abs(rh).max()),
                                   rtol=0)
    # the kernel wrapper's CPU path is the plain version
    ty, _ = rglru_fwd(torch.from_numpy(x).to(tdt),
                      tuple(torch.from_numpy(gates[k]) for k in RGLRU_GATES))
    np.testing.assert_array_equal(ty.float().numpy(), yf)


def _jax_grads(x, gates, dy):
    def f(x, g):
        return jnp.sum(jrglru.rglru_scan(x, g)[0] * dy)

    gx, gg = jax.jit(jax.grad(f, argnums=(0, 1)))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in gates.items()})
    return [np.asarray(gx)] + [np.asarray(gg[k]) for k in RGLRU_GATES]


def _assert_close_each(got, want):
    for name, g, w in zip(("x",) + RGLRU_GATES, got, want):
        np.testing.assert_allclose(
            g, w, atol=1e-5 * float(np.abs(w).max()), rtol=0, err_msg=name)


@pytest.mark.parametrize("b,s,w", [(2, 96, 48), (1, 200, 32)])
def test_rglru_backward_matches_jax_grad(b, s, w):
    """The plain backward and the Function's gradients (its CPU path) in x
    and all five gate vectors against ``jax.grad`` of JAX's
    ``rglru_scan``, for a random cotangent, f32."""
    x, gates = _inputs(b, s, w, seed=11)
    dy = np.random.default_rng(12).standard_normal(x.shape).astype(
        np.float32)
    want = _jax_grads(x, gates, dy)
    tg = {k: torch.from_numpy(v) for k, v in gates.items()}
    xt = torch.from_numpy(x)
    h = rglru_states_ref(xt, tg)
    got = rglru_bwd_ref(xt, tg, h, torch.from_numpy(dy))
    _assert_close_each([t.numpy() for t in got], want)

    leaves = [xt.clone().requires_grad_()] + [
        tg[k].clone().requires_grad_() for k in RGLRU_GATES]
    y = rglru_scan(leaves[0], dict(zip(RGLRU_GATES, leaves[1:])))
    assert y.grad_fn is not None \
        and "RGLRUFunction" in type(y.grad_fn).__name__
    (y * torch.from_numpy(dy)).sum().backward()
    _assert_close_each([t.grad.numpy() for t in leaves], want)
    # the plain backward is the Function's on the CPU, bit for bit
    for t, g in zip(leaves, got):
        np.testing.assert_array_equal(t.grad.numpy(), g.numpy())


def test_rglru_function_keeps_states_only_for_gradients(monkeypatch):
    """The forward asks for the tile-start states only when a gradient is
    wanted, and keeps [b, tiles(s), w] of them, not the state of every
    step; with the gates needing none, x's gradient alone flows."""
    import repro_torch.kernels.rglru as krglru
    asked = []
    fwd = krglru.rglru_fwd

    def spy(x, gates, *, states=False):
        y, h0 = fwd(x, gates, states=states)
        asked.append((states, None if h0 is None else tuple(h0.shape)))
        return y, h0

    monkeypatch.setattr(krglru, "rglru_fwd", spy)
    x, gates = _inputs(1, 300, 16, seed=3)
    tg = {k: torch.from_numpy(v) for k, v in gates.items()}
    with torch.no_grad():
        y, h_last = rglru(torch.from_numpy(x), tg)
    assert y.grad_fn is None and h_last.shape == (1, 16)
    xt = torch.from_numpy(x).requires_grad_()
    out = RGLRUFunction.apply(xt, *(tg[k] for k in RGLRU_GATES))
    assert [t.shape for t in out.grad_fn.saved_tensors] \
        == [xt.shape] + [(16,)] * 5 + [(1, krglru.tiles(300), 16)]
    out.sum().backward()
    assert asked == [(False, None), (True, (1, 5, 16))]
    assert xt.grad is not None and xt.grad.shape == xt.shape


def test_rglru_wrapper_checks_shapes_and_devices():
    """Shapes, the tile-start states' shape and type, and devices; on the
    CPU nothing counts as a launch."""
    x, gates = _inputs(1, 200, 8)
    xt = torch.from_numpy(x)
    g = tuple(torch.from_numpy(gates[k]) for k in RGLRU_GATES)
    with pytest.raises(ValueError, match="do not match"):
        rglru_fwd(xt, g[:4] + (g[4][:4],))
    with pytest.raises(ValueError, match="same CUDA device"):
        rglru_fwd(xt.to("meta"), g)
    _, h0 = rglru_fwd(xt, g, states=True)
    assert h0.shape == (1, 4, 8) and h0.dtype == torch.float32
    dy = torch.ones_like(xt)
    with pytest.raises(ValueError, match="must be"):   # every step's states
        rglru_bwd(xt, g, rglru_states_ref(xt, dict(zip(RGLRU_GATES, g))),
                  dy)
    with pytest.raises(ValueError, match="must be"):
        rglru_bwd(xt, g, h0.double(), dy)
    with pytest.raises(ValueError, match="same CUDA device"):
        rglru_bwd(xt, g, h0.to("meta"), dy)
    assert len(rglru_bwd(xt, g, h0, dy)) == 6
    assert _build.LAUNCHES["rglru"] == 0 and _build.LAUNCHES["rglru_bwd"] == 0


@pytest.mark.parametrize("variant", fam.VARIANTS,
                         ids=lambda v: "-".join(map(str, v.values())))
def test_recurrentgemma_loss_and_grads_match_jax(variant):
    """Reduced recurrentgemma-9b at 8 layers (d 128, 4 q heads and 1 kv
    head of 32, RG-LRU width 128, window 64, tied embeddings, the sqrt(d)
    embedding scale), batch 4, seq 128."""
    (jl, jaux, jg), (tl, taux, tg) = fam.loss_and_grads(
        ARCH, variant, s=SEQ, num_layers=LAYERS)
    assert set(tg) == set(jg)
    assert "['tail'][1]['a_param']" in tg and "['lm_head']" not in tg
    assert taux == jaux == 0.0
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert fam.grads_err(jg, tg) <= 1e-4


def test_recurrentgemma_trainer_matches_jax(tmp_path):
    jlosses, tr, res = fam.trainer_losses(ARCH, tmp_path, num_layers=LAYERS)
    assert res["final_step"] == 3
    np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-4)
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in tprm.flat_leaves(tr.params))


def test_recurrentgemma_launcher_cpu(capsys):
    out = fam.launcher_cpu(ARCH, capsys)
    assert out["final_step"] == 2
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])


def test_recurrentgemma_layout_and_refusals():
    """The stacked blocks and the tail of JAX's ``stack_layout``; tp > 1
    and serving raise, naming their ROADMAP.md items."""
    _, tcfg = fam.cfgs(ARCH, num_layers=LAYERS)
    assert tprm.stack_layout(tcfg) == (2, ("rglru", "rglru", "local"),
                                       ["rglru", "rglru"])
    params = tprm.init_params(tcfg, seed=0)
    assert [len(b) for b in params["blocks"]] == [14, 14, 9]
    assert params["blocks"][0]["conv"].shape == (2, 4, 128)
    assert params["tail"][0]["w_a"].dtype == torch.float32
    assert bool((params["tail"][1]["a_param"] == -1.0).all())
    assert tprm.unflatten(tprm.flatten(params)).keys() == params.keys()
    with pytest.raises(NotImplementedError, match="ROADMAP.md A10c"):
        tprm.check_tp(tcfg, 2)
    fam.serves(tcfg)
    tprm.check_tp(tcfg, 1)
