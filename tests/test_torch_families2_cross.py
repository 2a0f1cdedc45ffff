"""The cross-attention architectures of the port's seventeenth slice
against the JAX package on the CPU: the reduced ``llama-3.2-vision-11b``
(self-attention layers and a cross layer against a stub context, the
``tanh`` gate) and ``whisper-small`` (the encoder over the stub frames,
the decoder's ``pos_embed``, every decoder layer cross-attending), loss
and every gradient leaf under ``megatron`` without recomputation and
``oases`` with fine recomputation (split 2: each sub-batch attends to its
own rows of the context); ``whisper-small``'s trainer against JAX's for 3
steps; the launcher on the CPU; and the refusals (tp > 1, serving, the
dry run).  Inputs from numpy, handed to both frameworks.

Weights: JAX's init with every zero-initialised leaf drawn from one numpy
seed (``_torch_family.perturbed``: the norm scales, the encoder's among
them, and ``c_gate`` about 0.5), the same arrays on both sides.  At
init ``c_gate`` is 0: ``tanh(c_gate) = 0`` would hide the cross path
(the loss would not depend on the context, every ``c_w*`` and encoder
gradient would be 0), so the cases assert those gradients are non-zero.
The context enters at d_model (JAX's ``tests/test_smoke_archs.py``
does the same: the reduced ``context_dim`` of 64 does not meet ``c_wk``,
which reads d_model); the trainer case replaces ``context_dim`` by
d_model on both sides (full size has ``context_dim == d_model``).
llama-3.2-vision runs 5 of the reduced 10 layers: one whole pattern,
its one cross layer.  JAX's schedules are one function of the weights
for these models, so one JAX pass (``megatron``) is the reference of both
port variants.

Tolerances: loss 1e-5 relative and ``grads_err`` <= 1e-4
(``tests/_scripts/runner.py``'s formula); trainer losses 1e-4 relative
over 3 steps.
"""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import functools

import numpy as np
import pytest
import torch

import _torch_family as fam
from repro_torch.launch import dryrun as tdry
from repro_torch.models import params as tprm

MEGATRON = dict(schedule="megatron", remat=False)
VARIANTS = {"megatron": MEGATRON,
            "oases_fine": dict(schedule="oases", fine_remat=True)}
# arch -> (batch, seq, replaced fields, the leaves whose gradient the
# cross path alone gives)
CASES = {
    "llama-3.2-vision-11b": (2, 32, dict(num_layers=5),
                             ("c_ln", "c_wq", "c_wk", "c_wv", "c_wo",
                              "c_gate")),
    "whisper-small": (4, 64, {}, ("c_wk", "c_gate", "['encoder']")),
}


@functools.lru_cache(maxsize=None)
def _results(arch):
    b, s, replace, _ = CASES[arch]
    want, got = fam.against_jax(arch, MEGATRON, list(VARIANTS.values()),
                                b=b, s=s, perturb=True, **replace)
    return dict(zip(VARIANTS, ((want, g) for g in got)))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", list(CASES))
def test_cross_loss_and_grads_match_jax(arch, variant):
    (jl, jaux, jg), (tl, taux, tg) = _results(arch)[variant]
    assert set(tg) == set(jg)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert taux == jaux == 0.0
    assert fam.grads_err(jg, tg) <= 1e-4
    cross = [k for k in tg if any(n in k for n in CASES[arch][3])]
    assert cross and all(np.any(tg[k]) for k in cross), cross
    assert all(np.any(g) for g in tg.values())


def test_whisper_layout():
    """whisper's tree: the decoder ``pos_embed`` of max(seq, 2048) rows,
    the encoder's ``pos_embed`` [context_len, d], its stacked GLOBAL_ATTN
    layers and final norm; every decoder layer a cross layer."""
    _, tcfg = fam.cfgs("whisper-small")
    params = tprm.init_params(tcfg, seed=0, max_pos=64)
    assert params["pos_embed"].shape == (2048, 128)
    enc = params["encoder"]
    assert enc["pos_embed"].shape == (tcfg.context_len, 128)
    assert enc["blocks"]["wq"].shape == (2, 128, 128)
    assert enc["final_ln"].dtype == torch.float32
    assert "c_gate" in params["blocks"][0] and "c_gate" not in enc["blocks"]
    assert bool((params["blocks"][0]["c_gate"] == 0).all())
    flat = tprm.flatten(params)
    assert list(flat) == list(tprm.model_specs(tcfg))
    assert tprm.unflatten(flat).keys() == params.keys()
    assert len(tprm.encoder_layers(params)) == 2
    static, per_layer = tprm.split_layer_flat(tcfg, flat)
    assert "['encoder']['blocks']['wq']" in static and len(per_layer) == 2
    assert set(tprm.pack_layer_flat(tcfg, static, per_layer)) == set(flat)


def test_whisper_trainer_matches_jax(tmp_path):
    jlosses, tr, res = fam.trainer_losses("whisper-small", tmp_path,
                                          perturb=True, context_dim=128)
    assert res["final_step"] == 3
    np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-4)
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in tprm.flat_leaves(tr.params))


def test_whisper_launcher_cpu(capsys):
    out = fam.launcher_cpu("whisper-small", capsys)
    assert out["final_step"] == 2
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-small",
                                  "gemma2-9b"])
def test_refusals(arch):
    """tp > 1 (A10c; gemma2 as a local-attention model) and the dry run
    of encoder and cross archs (A10b) raise, naming their ROADMAP.md
    items; tp=1 trains; the dense engine serves at tp=1 (A5)."""
    _, tcfg = fam.cfgs(arch)
    tprm.check_tp(tcfg, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A10c"):
        tprm.check_tp(tcfg, 2)
    fam.serves(tcfg)
    if arch != "gemma2-9b":
        with pytest.raises(NotImplementedError, match="ROADMAP.md A10b"):
            tdry.run_cell(tcfg, "train_4k")
