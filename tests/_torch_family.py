"""Shared harness of ``tests/test_torch_ssd.py``,
``tests/test_torch_moe.py`` and ``tests/test_torch_rglru.py``: a reduced
f32 config (with further fields replaced where a test says so) run through JAX's
``build_train_loss`` (value and gradient under ``jax.jit`` on a 1x1 mesh)
and through the port's ``train_loss`` from the same weights and batch, the
two trainers side by side, and the launcher on the CPU."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import TrainHParams as JTrainHParams
from repro.configs.registry import get_config as jax_get_config
from repro.core import compat
from repro.models import lm as jlm
from repro.models import params as jprm
from repro.runtime import Trainer as JTrainer
from repro_torch.configs.base import TrainHParams
from repro_torch.configs.registry import get_config
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models import params as tprm
from repro_torch.runtime import Trainer

# the schedule and recomputation variants held against JAX: one pass
# (megatron) and two sub-batches (oases, split 2: each routes and sizes
# its expert capacity alone), under fine and coarse recomputation
VARIANTS = [dict(schedule="megatron", fine_remat=True),
            dict(schedule="megatron", fine_remat=False),
            dict(schedule="oases", fine_remat=True),
            dict(schedule="oases", fine_remat=False)]


def mesh():
    return compat.make_mesh((1, 1), ("data", "model"),
                            axis_types=compat.auto_axis_types(2))


def cfgs(arch, **replace):
    """(JAX's, the port's) reduced f32 ``arch``, ``replace`` applied."""
    kw = dict(dtype="float32", **replace)
    return (jax_get_config(arch).reduced().replace(**kw),
            get_config(arch).reduced().replace(**kw))


def jax_flat(tree):
    return {jax.tree_util.keystr(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def grads_err(g1: dict, g2: dict) -> float:
    """``tests/_scripts/runner.py:174``."""
    return max(float(np.max(np.abs(g1[k] - g2[k])))
               / (float(np.max(np.abs(g1[k]))) + 1e-8) for k in g1)


def loss_and_grads(arch, hp_kw, b=4, s=64, **replace):
    """-> (JAX (loss, aux, flat grads), port (loss, aux, flat grads)) of
    the reduced f32 ``arch`` (``replace`` applied) at batch b x s, JAX's
    init from key 0, tokens and labels from numpy seed 42."""
    jcfg, tcfg = cfgs(arch, **replace)
    loss_fn, specs, _ = jlm.build_train_loss(
        jcfg, mesh(), JTrainHParams(**hp_kw), global_batch=b, seq_len=s)
    p = jprm.init_params(specs, jax.random.PRNGKey(0))
    rng = np.random.default_rng(42)
    batch = {k: rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
             for k in ("tokens", "labels")}
    with compat.set_mesh(mesh()):
        (jl, jaux), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            p, {k: jnp.asarray(v) for k, v in batch.items()})
    params = tprm.from_flat(tcfg, jprm.tree_to_flat(p))
    for t in tprm.flat_leaves(params):
        t.requires_grad_()
    loss, aux = tlm.train_loss(tcfg, params,
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()},
                               TrainHParams(**hp_kw))
    loss.backward()
    grads = {k: t.grad.numpy() for k, t in tprm.flatten(params).items()}
    return ((float(jl), float(jaux), jax_flat(jg)),
            (loss.item(), aux.item(), grads))


def trainer_losses(arch, tmp_path, steps=3, **replace):
    """-> (JAX trainer losses, port trainer, its losses): ``steps`` steps
    from JAX's initial weights, 2 microbatches, batch 4 x 32."""
    jcfg, tcfg = cfgs(arch, **replace)
    kw = dict(learning_rate=1e-3, warmup_steps=1, microbatch=2)
    jtr = JTrainer(jcfg, mesh(), JTrainHParams(**kw), global_batch=4,
                   seq_len=32, ckpt_dir=str(tmp_path / "ckpt"),
                   log_fn=lambda msg: None)
    p0, _, _ = jtr.init_state(seed=0)
    jres = jtr.train(steps, seed=0)
    tr = Trainer(tcfg, TrainHParams(**kw), global_batch=4, seq_len=32,
                 device="cpu", log_fn=None,
                 params=tprm.from_flat(tcfg, jprm.tree_to_flat(p0)))
    res = tr.train(steps)
    return jres["losses"], tr, res


def launcher_cpu(arch, capsys) -> dict:
    """The launcher at ``--reduced --device cpu`` for 2 steps."""
    ttrain.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps",
                 "2", "--batch", "2", "--seq", "32"])
    text = capsys.readouterr().out
    return json.loads(text[text.index("{"):])
