"""JAX's 1-device training loss and gradients of a reduced f32 config, the
oracle ``tests/test_torch_plans.py`` and ``tests/test_torch_2d.py`` hold
the port's per-layer plans and 2-D layout to (the same oracle
``tests/_scripts/plan_equivalence.py`` and ``equivalence_2d.py`` hold
JAX's own grouped and 2-D runs to)."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import TrainHParams
from repro.configs.registry import get_config
from repro.core import compat
from repro.models import lm
from repro.models import params as prm


def grads_err(g1: dict, g2: dict) -> float:
    """``tests/_scripts/runner.py:174``."""
    return max(float(np.max(np.abs(g1[k] - g2[k])))
               / (float(np.max(np.abs(g1[k]))) + 1e-8) for k in g1)


def reduced(arch, **kw):
    return get_config(arch).reduced().replace(dtype="float32", **kw)


def oracle(arch: str, batch: int, seq: int, seed: int = 42, **kw) -> dict:
    """Loss and flat gradients of JAX's ``build_train_loss`` on a 1x1 mesh
    (default hyper-parameters, JAX's init from key 0), the flat weights
    and the batch (tokens and labels drawn from ``seed``); ``kw``
    replaces fields of the reduced config."""
    cfg = reduced(arch, **kw)
    mesh = compat.make_mesh((1, 1), ("data", "model"),
                            axis_types=compat.auto_axis_types(2))
    loss_fn, specs, _ = lm.build_train_loss(
        cfg, mesh, TrainHParams(), global_batch=batch, seq_len=seq)
    p = prm.init_params(specs, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    data = {k: rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
            for k in ("tokens", "labels")}
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    with compat.set_mesh(mesh):
        loss = float(jax.jit(loss_fn)(p, jb)[0])
        grads = prm.tree_to_flat(jax.jit(jax.grad(
            lambda p, b: loss_fn(p, b)[0]))(p, jb))
    return dict(flat=prm.tree_to_flat(p), batch=data, loss=loss,
                grads=grads)
