"""The dense and MoE architectures of the port's seventeenth slice against
the JAX package on the CPU: the reduced ``gemma2-9b`` (local and global
layers, post-norms, attention and final softcaps, tied embeddings, the
sqrt(d) embedding scale), ``granite-8b`` and ``internlm2-20b`` (dense
GQA, global) and ``moonshot-v1-16b-a3b`` (MoE, 64 experts reduced to 4,
top 2), loss and every gradient leaf under ``megatron`` without
recomputation and ``oases`` with fine recomputation (split 2); and the
plain flash attention at ``sk != sq`` and non-causal, forward against
JAX's Pallas kernel in interpret mode and backward against ``jax.grad``
of ``chunked_attention``.  Inputs from numpy, handed to both frameworks.

Weights: JAX's init with every zero-initialised leaf (the norm scales)
drawn from one numpy seed (``_torch_family.perturbed``), the same arrays
on both sides.  For a dense model JAX's schedules are one function of
the weights, so one JAX pass (``megatron``, no recomputation) is the
reference of both port variants; an MoE ``oases`` sub-batch routes and
sizes its capacity alone, so the MoE case compiles JAX under each
variant.

gemma2 runs at seq 128: ``reduced()``'s window of 64 masks nothing at the
harness's seq 64 (a key is visible while ``k_pos > q_pos - window``); and
at 2 of the reduced 4 layers, one (local, global) pattern.

Tolerances: loss 1e-5 relative and ``grads_err`` <= 1e-4
(``tests/_scripts/runner.py``'s formula); the flash forward and backward
1e-5 absolute in f32 (f32 sums in another order; the plain version scales
q in f32 as the TPU kernel does, ``chunked_attention`` in q's dtype: the
same in f32).
"""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_family as fam
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (flash_attention,
                                                flash_attention_bwd,
                                                flash_attention_fwd)
from repro_torch.models import lm as tlm
from repro_torch.models import params as tprm
from repro_torch.configs.base import TrainHParams

MEGATRON = dict(schedule="megatron", remat=False)
OASES = dict(schedule="oases", fine_remat=True)
VARIANTS = {"megatron": MEGATRON, "oases_fine": OASES}
# arch -> (seq, replaced fields, the JAX variants compiled: one reference
# for a dense model); gemma2 at one (local, global) pattern of the reduced
# two
CASES = {"gemma2-9b": (128, dict(num_layers=2), ("megatron",)),
         "granite-8b": (64, {}, ("megatron",)),
         "internlm2-20b": (64, {}, ("megatron",)),
         "moonshot-v1-16b-a3b": (64, {}, ("megatron", "oases_fine"))}


@functools.lru_cache(maxsize=None)
def _results(arch):
    """variant -> (JAX (loss, aux, grads), port (loss, aux, grads))."""
    s, replace, jax_variants = CASES[arch]
    out = {}
    if len(jax_variants) == 1:
        want, got = fam.against_jax(arch, VARIANTS[jax_variants[0]],
                                    list(VARIANTS.values()), s=s,
                                    perturb=True, **replace)
        return dict(zip(VARIANTS, ((want, g) for g in got)))
    for name in jax_variants:
        out[name] = fam.loss_and_grads(arch, VARIANTS[name], s=s,
                                       perturb=True, **replace)
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", list(CASES))
def test_loss_and_grads_match_jax(arch, variant):
    (jl, jaux, jg), (tl, taux, tg) = _results(arch)[variant]
    assert set(tg) == set(jg)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert abs(taux - jaux) <= 1e-6
    assert fam.grads_err(jg, tg) <= 1e-4
    assert all(np.any(g) for g in tg.values())


def test_gemma2_layout_and_softcaps():
    """gemma2's leaves: ``pn1`` and ``pn2`` in each of the two pattern
    positions, no ``lm_head`` (tied); the reduced window is shorter than
    the parity cases' seq; both softcaps are set, and the final one reaches
    the loss (the loss without it differs)."""
    jcfg, tcfg = fam.cfgs("gemma2-9b")
    assert (tcfg.window, tcfg.attn_softcap, tcfg.final_softcap) == (
        64, 50.0, 30.0) and CASES["gemma2-9b"][0] > tcfg.window
    assert tcfg.layer_pattern == ("local", "global")
    specs = tprm.model_specs(tcfg)
    for j in (0, 1):
        assert specs[f"['blocks'][{j}]['pn1']"].f32
        assert f"['blocks'][{j}]['pn2']" in specs
    assert "['lm_head']" not in specs
    flat = fam.perturbed({k: np.zeros(s.shape, np.float32) if s.scale == 0
                          else np.full(s.shape, 0.02, np.float32)
                          for k, s in specs.items()})
    batch = {k: torch.from_numpy(v)
             for k, v in fam.make_batch(tcfg, 2, 16).items()}
    losses = [tlm.train_loss(cfg, tprm.from_flat(cfg, flat), batch,
                             TrainHParams(**MEGATRON))[0].item()
              for cfg in (tcfg, tcfg.replace(final_softcap=0.0))]
    assert losses[0] != losses[1]


# (b, sq, sk, h, kvh, hd, causal): more queries than keys, fewer, GQA
FLASH_CASES = [(2, 64, 16, 4, 2, 32, False), (2, 64, 16, 4, 4, 32, True),
               (1, 40, 100, 8, 2, 64, False), (2, 40, 100, 4, 1, 32, True)]


def _flash_inputs(b, sq, sk, h, kvh, hd, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, hd)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, hd)).astype(np.float32),
            rng.standard_normal((b, sq, h, hd)).astype(np.float32))


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "b{}-sq{}-sk{}-h{}-kvh{}-hd{}-"
                         "causal{}".format(*c))
def test_flash_cross_shapes_match_jax(case):
    """The plain flash forward (the wrapper's CPU path) at sk != sq
    against the Pallas kernel in interpret mode, its lse against the
    log-sum-exp of the visible scores; the plain backward and the autograd
    Function against ``jax.grad`` of ``chunked_attention`` (JAX's model
    path; the Pallas kernel has no backward)."""
    b, sq, sk, h, kvh, hd, causal = case
    q, k, v, dout = _flash_inputs(b, sq, sk, h, kvh, hd)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    out, lse = flash_attention_fwd(tq, tk, tv, causal=causal)
    assert out.shape == (b, sq, h, hd) and lse.shape == (b, h, sq)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    sc = np.einsum("bqkgd,btkd->bkgqt",
                   q.reshape(b, sq, kvh, h // kvh, hd) * hd ** -0.5, k)
    if causal:
        sc = np.where(np.arange(sk)[None, :] <= np.arange(sq)[:, None], sc,
                      -np.inf)
    want_lse = np.log(np.exp(sc).sum(-1)).reshape(b, h, sq)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=0)

    jgrads = jax.grad(lambda q, k, v: jnp.sum(jattn.chunked_attention(
        q, k, v, causal=causal) * dout), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal=causal)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    (flash_attention(*leaves, causal=causal) * tdo).sum().backward()
    for got, fn_grad, want in zip(grads, leaves, jgrads):
        assert got.shape == fn_grad.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(fn_grad.grad.numpy(), got.numpy(),
                                   atol=0, rtol=0)
    assert _build.LAUNCHES["flash_attention"] == 0
    assert _build.LAUNCHES["flash_attention_bwd"] == 0
