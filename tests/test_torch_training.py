"""The port's training slice against the JAX package on the CPU: the loss
and every gradient leaf of ``build_train_loss``, the chunked cross
entropy, AdamW, the synthetic data, the whole trainer and the launcher.
Reduced f32 configs on a 1x1 mesh, inputs from numpy or from JAX's own
init, handed to both frameworks.

Tolerances: loss 1e-5 relative and ``grads_err`` <= 1e-4 (the formula of
``tests/_scripts/runner.py``: per leaf, max abs difference over the max
abs value), f32 sums in another order; AdamW state 1e-6; trainer losses
1e-4 relative over 3 steps.
"""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainHParams as JTrainHParams
from repro.configs.registry import get_config as jax_get_config
from repro.core import compat
from repro.core import tmp as jtmp
from repro.core.axes import mesh_info
from repro.data import pipeline as jpipe
from repro.models import lm as jlm
from repro.models import params as jprm
from repro.optim import adamw as jadamw
from repro.runtime import Trainer as JTrainer
from repro_torch.configs.base import TrainHParams
from repro_torch.configs.registry import get_config
from repro_torch.core import tmp as ttmp
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models import params as tprm
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import Trainer


def _mesh():
    return compat.make_mesh((1, 1), ("data", "model"),
                            axis_types=compat.auto_axis_types(2))


def _cfgs(arch):
    return (jax_get_config(arch).reduced().replace(dtype="float32"),
            get_config(arch).reduced().replace(dtype="float32"))


def _jax_flat(tree):
    return {jax.tree_util.keystr(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def grads_err(g1: dict, g2: dict) -> float:
    """``tests/_scripts/runner.py:174``."""
    return max(float(np.max(np.abs(g1[k] - g2[k])))
               / (float(np.max(np.abs(g1[k]))) + 1e-8) for k in g1)


def _trainable(params):
    for t in tprm.flat_leaves(params):
        t.requires_grad_()
    return params


@pytest.mark.parametrize("arch", ["gpt-h1024", "internlm2-1.8b"])
def test_train_loss_and_grads_match_jax(arch):
    """Reduced gpt-h1024 (MHA, hd 32) and internlm2-1.8b (GQA 4/2), batch
    4, seq 64, default hyper-parameters, JAX's init."""
    jcfg, tcfg = _cfgs(arch)
    b, s = 4, 64
    loss_fn, specs, _ = jlm.build_train_loss(
        jcfg, _mesh(), JTrainHParams(), global_batch=b, seq_len=s)
    p = jprm.init_params(specs, jax.random.PRNGKey(0))
    rng = np.random.default_rng(42)
    batch = {k: rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
             for k in ("tokens", "labels")}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with compat.set_mesh(_mesh()):
        jloss = float(jax.jit(loss_fn)(p, jb)[0])
        jgrads = _jax_flat(jax.jit(jax.grad(
            lambda p, b: loss_fn(p, b)[0]))(p, jb))

    params = _trainable(tprm.from_flat(tcfg, jprm.tree_to_flat(p)))
    loss, aux = tlm.train_loss(tcfg, params,
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()}, TrainHParams())
    loss.backward()
    grads = {k: t.grad.numpy() for k, t in tprm.flatten(params).items()}
    assert aux.item() == 0.0
    assert set(grads) == set(jgrads)
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)
    assert grads_err(jgrads, grads) <= 1e-4


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_xent_chunks_match_jax(softcap):
    """Two checkpointed chunks of 100 tokens plus a remainder of 56; the
    loss sum, the count and the gradients in x and the head."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 64, 32)).astype(np.float32)
    head = (rng.standard_normal((32, 300)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 300, (4, 64)).astype(np.int32)

    def jloss(x, head):
        return jtmp.vocab_parallel_xent(x, head, jnp.asarray(labels), (),
                                        chunk=100, softcap=softcap)

    (jl, jn), (gx, gh) = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(
        jnp.asarray(x), jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(head).requires_grad_()
    ls, n = ttmp.vocab_parallel_xent(tx, th, torch.from_numpy(labels),
                                     chunk=100, softcap=softcap)
    ls.backward()
    assert float(n) == float(jn) == 256.0
    assert abs(ls.item() - float(jl)) <= 1e-5 * abs(float(jl))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), atol=1e-5)


def test_adamw_matches_jax():
    """Two AdamW steps with the same grads (large enough to clip) on the
    reduced internlm2 tree: params, master, m, v and the grad norm."""
    jcfg, tcfg = _cfgs("internlm2-1.8b")
    specs = jprm.model_specs(jcfg, mesh_info(_mesh()))
    p = jprm.init_params(specs, jax.random.PRNGKey(1))
    flat = jprm.tree_to_flat(p)
    rng = np.random.default_rng(6)
    gflat = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in flat.items()} for _ in range(2)]
    cfg_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)

    jopt = {"master": jax.tree_util.tree_map(
        lambda w: w.astype(jnp.float32), p),
        "m": jax.tree_util.tree_map(jnp.zeros_like, p),
        "v": jax.tree_util.tree_map(jnp.zeros_like, p),
        "step": jnp.zeros((), jnp.int32), "err": None}
    params = tprm.from_flat(tcfg, flat)
    topt = tadamw.init_opt_state(params)
    names = list(tprm.flatten(params))
    for g in gflat:
        p, jopt, jnorm = jadamw.apply_updates(
            p, jprm.tree_from_flat(specs, g), jopt,
            jadamw.AdamWConfig(**cfg_kw))
        tnorm = tadamw.apply_updates(
            params, [torch.from_numpy(g[k]) for k in names], topt,
            tadamw.AdamWConfig(**cfg_kw))
        assert abs(float(tnorm) - float(jnorm)) <= 1e-5 * float(jnorm)
        assert float(jnorm) > 1.0                 # the clip is active
    assert topt["step"] == int(jopt["step"]) == 2
    for tree, mine in ((p, tprm.flatten(params)),
                       (jopt["master"], dict(zip(names, topt["master"]))),
                       (jopt["m"], dict(zip(names, topt["m"]))),
                       (jopt["v"], dict(zip(names, topt["v"])))):
        ref = jprm.tree_to_flat(tree)
        for k in names:
            np.testing.assert_allclose(mine[k].detach().numpy(), ref[k],
                                       atol=1e-6, rtol=0, err_msg=k)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A4"):
        tadamw.apply_updates(params, [], topt, tadamw.AdamWConfig(),
                             compress=True)


@pytest.mark.parametrize("microbatch", [0, 2])
def test_make_batch_is_bit_identical(microbatch):
    kw = dict(global_batch=4, seq_len=48, vocab_size=512,
              microbatch=microbatch)
    for step in (0, 7):
        mine = tpipe.make_batch(tpipe.DataConfig(**kw), step)
        ref = jpipe.make_batch(jpipe.DataConfig(**kw), step)
        assert set(mine) == set(ref)
        for k in ref:
            assert mine[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(mine[k], ref[k])


def test_trainer_losses_match_jax(tmp_path):
    """3 steps of the whole trainer, gradient accumulation over 2
    microbatches, from JAX's initial weights."""
    jcfg, tcfg = _cfgs("gpt-h1024")
    kw = dict(learning_rate=1e-3, warmup_steps=1, microbatch=2)
    jtr = JTrainer(jcfg, _mesh(), JTrainHParams(**kw), global_batch=4,
                   seq_len=32, ckpt_dir=str(tmp_path / "ckpt"),
                   log_fn=lambda msg: None)
    p0, _, _ = jtr.init_state(seed=0)
    jres = jtr.train(3, seed=0)

    tr = Trainer(tcfg, TrainHParams(**kw), global_batch=4, seq_len=32,
                 device="cpu", log_fn=None,
                 params=tprm.from_flat(tcfg, jprm.tree_to_flat(p0)))
    res = tr.train(3)
    assert res["final_step"] == 3 and len(res["step_times"]) == 3
    np.testing.assert_allclose(res["losses"], jres["losses"], rtol=1e-4)
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in tprm.flat_leaves(tr.params))


def test_train_launcher_cpu(capsys):
    ttrain.main(["--reduced", "--device", "cpu", "--steps", "2",
                 "--batch", "2", "--seq", "32"])
    text = capsys.readouterr().out
    out = json.loads(text[text.index("{"):])
    assert out["final_step"] == 2 and out["slow_steps"] == 0
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])


def test_trainer_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg = _cfgs("gpt-h1024")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tcfg, TrainHParams(), global_batch=2, seq_len=16)
