"""Shared harness of ``tests/test_torch_ssd.py``,
``tests/test_torch_moe.py``, ``tests/test_torch_rglru.py`` and
``tests/test_torch_families2*.py``: a reduced f32 config (with further
fields replaced where a test says so) run through JAX's
``build_train_loss`` (value and gradient under ``jax.jit`` on a 1x1 mesh)
and through the port's ``train_loss`` from the same weights and batch, the
two trainers side by side, and the launcher on the CPU.

Cross-attention configs get a stub context ``ctx`` [b, context_len,
d_model] (JAX's ``tests/test_smoke_archs.py`` feeds it at d_model, where
the reduced ``context_dim`` is 64).  ``perturb`` draws every leaf that
JAX initialises to zero (the norm scales, ``c_gate``) from one numpy
seed, the same arrays on both sides: at init ``tanh(c_gate) = 0`` hides
the whole cross path (no ``c_w*`` or encoder gradient) and every norm is
``1 + 0``."""
import json
from unittest import mock

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


def perturbed(flat: dict, seed: int = 11) -> dict:
    """``flat`` (JAX's ``tree_to_flat``) with every all-zero leaf drawn
    from numpy ``seed``: ``c_gate`` 0.5 + 0.1 N(0, 1) (tanh 0.46), the
    rest 0.1 N(0, 1), in flat order."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        if np.any(v):
            out[k] = v
            continue
        r = 0.1 * rng.standard_normal(v.shape)
        out[k] = (r + 0.5 if k.endswith("['c_gate']") else r).astype(v.dtype)
    return out


def numpy_params(specs, seed: int = 0) -> dict:
    """Flat weights (JAX's ``keystr`` names) of a JAX ``model_specs`` tree
    drawn with numpy from ``seed``, in place of ``init_params`` (whose
    per-leaf draws take seconds on the CPU): N(0, scale) where JAX draws,
    JAX's constant where it sets one (-1 in f32 gate and decay leaves, 1
    otherwise), and every leaf JAX zeroes drawn as :func:`perturbed` draws
    it.  f32 leaves; ``jprm.tree_from_flat(specs, flat)`` makes JAX's
    tree, ``from_flat`` the port's."""
    rng = np.random.default_rng(seed)
    flat = {}
    for kp, sp in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=jprm.is_spec)[0]:
        if sp.scale == 0.0:
            v = np.zeros(sp.shape)
        elif sp.scale == -1.0:
            v = np.full(sp.shape, -1.0 if sp.dtype == jnp.float32 else 1.0)
        else:
            v = rng.standard_normal(sp.shape) * sp.scale
        flat[jax.tree_util.keystr(kp)] = v.astype(np.float32)
    return perturbed(flat, seed=seed + 11)


def make_batch(cfg, b, s, seed=42) -> dict:
    """Tokens and labels from numpy ``seed``; for a cross-attention
    config also the context [b, context_len, d_model], N(0, 1)."""
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
             for k in ("tokens", "labels")}
    if cfg.context_len:
        batch["ctx"] = rng.standard_normal(
            (b, cfg.context_len, cfg.d_model)).astype(np.float32)
    return batch


def loss_and_grads(arch, hp_kw, b=4, s=64, perturb=False, **replace):
    """-> (JAX (loss, aux, flat grads), port (loss, aux, flat grads)) of
    the reduced f32 ``arch`` (``replace`` applied) at batch b x s, JAX's
    init from key 0 (:func:`perturbed` with ``perturb``), the batch from
    numpy seed 42 (:func:`make_batch`)."""
    want, (got,) = against_jax(arch, hp_kw, [hp_kw], b, s, perturb,
                               **replace)
    return want, got


def against_jax(arch, jax_hp, port_hps, b=4, s=64, perturb=False,
                **replace):
    """-> (JAX (loss, aux, flat grads) under ``jax_hp``, [port (loss,
    aux, flat grads) under each of ``port_hps``]) from the same weights
    and batch (:func:`loss_and_grads`)."""
    jcfg, tcfg = cfgs(arch, **replace)
    loss_fn, specs, _ = jlm.build_train_loss(
        jcfg, mesh(), JTrainHParams(**jax_hp), global_batch=b, seq_len=s)
    p = jprm.init_params(specs, jax.random.PRNGKey(0))
    if perturb:
        p = jprm.tree_from_flat(p, perturbed(jprm.tree_to_flat(p)))
    batch = make_batch(jcfg, b, s)
    with compat.set_mesh(mesh()):
        (jl, jaux), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            p, {k: jnp.asarray(v) for k, v in batch.items()})
    flat = jprm.tree_to_flat(p)
    got = []
    for hp_kw in port_hps:
        params = tprm.from_flat(tcfg, flat, max_pos=s)
        for t in tprm.flat_leaves(params):
            t.requires_grad_()
        loss, aux = tlm.train_loss(tcfg, params,
                                   {k: torch.from_numpy(v)
                                    for k, v in batch.items()},
                                   TrainHParams(**hp_kw))
        loss.backward()
        got.append((loss.item(), aux.item(),
                    {k: t.grad.numpy()
                     for k, t in tprm.flatten(params).items()}))
    return (float(jl), float(jaux), jax_flat(jg)), got


def trainer_losses(arch, tmp_path, steps=3, perturb=False, **replace):
    """-> (JAX trainer losses, port trainer, its losses): ``steps`` steps
    from JAX's initial weights (:func:`perturbed` with ``perturb``), 2
    microbatches, batch 4 x 32; a cross-attention config trains on each
    trainer's own stub context (the same numpy draws)."""
    jcfg, tcfg = cfgs(arch, **replace)
    kw = dict(learning_rate=1e-3, warmup_steps=1, microbatch=2)
    jtr = JTrainer(jcfg, mesh(), JTrainHParams(**kw), global_batch=4,
                   seq_len=32, ckpt_dir=str(tmp_path / "ckpt"),
                   log_fn=lambda msg: None)
    init = jprm.init_params
    if perturb:
        def init(specs, key, init=init):
            p = init(specs, key)
            return jprm.tree_from_flat(p, perturbed(jprm.tree_to_flat(p)))
    with mock.patch.object(jprm, "init_params", init):
        p0, _, _ = jtr.init_state(seed=0)
        jres = jtr.train(steps, seed=0)
    tr = Trainer(tcfg, TrainHParams(**kw), global_batch=4, seq_len=32,
                 device="cpu", log_fn=None,
                 params=tprm.from_flat(tcfg, jprm.tree_to_flat(p0),
                                       max_pos=32))
    res = tr.train(steps)
    return jres["losses"], tr, res


def serves(tcfg, **kw):
    """The port's dense engine on the CPU serves ``tcfg``: one request of
    4 prompt tokens and up to 2 new ones drains -> the request."""
    from repro_torch.serving import Request, ServingEngine
    eng = ServingEngine(tcfg, slots=2, max_seq=32, device="cpu", **kw)
    eng.load(seed=0)
    req = Request(rid=0, prompt=np.arange(3, 7, dtype=np.int32),
                  max_new_tokens=2)
    eng.submit(req)
    stats = eng.run_until_drained()
    assert req.done and 1 <= len(req.out_tokens) <= 2
    assert stats["decoded_tokens"] == len(req.out_tokens)
    return req


def launcher_cpu(arch, capsys) -> dict:
    """The launcher at ``--reduced --device cpu`` for 2 steps."""
    ttrain.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps",
                 "2", "--batch", "2", "--seq", "32"])
    text = capsys.readouterr().out
    return json.loads(text[text.index("{"):])


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| over max |want| (f32)."""
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (
        float(np.max(np.abs(want))) + 1e-8)


def check_state(got: dict, want: dict, tol: float, what: str):
    """Two flat decode states: the same leaves and shapes, each within
    ``tol`` of ``want`` relative to its largest magnitude."""
    assert set(got) == set(want), what
    for k, w in want.items():
        assert got[k].shape == w.shape, (what, k)
        err = rel_err(got[k], w)
        assert err <= tol, f"{what} {k}: {err}"


def serve_requests(vocab, n, plen, new, seed):
    """``n`` requests (rid, prompt, max new tokens): prompts of
    2..``plen`` tokens, up to ``new`` new tokens each, from numpy
    ``seed``."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(3, vocab, int(rng.integers(2, plen + 1)))
             .astype(np.int32), int(rng.integers(2, new + 1)))
            for i in range(n)]


def drain(eng, reqs, cls):
    """Submit ``reqs`` as ``cls`` requests and drain ``eng`` -> (the
    requests, its stats)."""
    rs = [cls(rid=i, prompt=p, max_new_tokens=m) for i, p, m in reqs]
    for r in rs:
        eng.submit(r)
    return rs, eng.run_until_drained()


def engines_agree(jeng, teng, reqs, tol: float):
    """JAX's and the port's dense engines drain ``reqs``: the same tokens
    and stats, and decode states within ``tol`` (:func:`check_state`)."""
    from repro.serving import Request as JRequest
    from repro_torch.serving import Request
    jreqs, jstats = drain(jeng, reqs, JRequest)
    treqs, tstats = drain(teng, reqs, Request)
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and jr.done
        assert tr.out_tokens == jr.out_tokens, tr.rid
    assert teng.stats == jeng.stats
    assert "paged" not in tstats and "paged" not in jstats
    check_state(tprm.state_to_flat(teng.state), jax_flat(jeng.state), tol,
                f"{teng.cfg.name} engine")



# JAX's serving gate (``tests/_scripts/serving_equivalence.py``): 4 slots
# of 48 positions, 6 requests of 6 new tokens
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_REQUESTS, SERVE_NEW = 4, 48, 6, 6


def gate_prompts(vocab):
    """The gate's prompts: 3-7 tokens from numpy seed 123."""
    rng = np.random.default_rng(123)
    return [rng.integers(3, vocab, int(rng.integers(3, 8)), dtype=np.int32)
            for _ in range(SERVE_REQUESTS)]


def shared_prefix_prompts(vocab):
    """The gate's prompts sharing block-aligned and mid-block prefixes
    (page 8)."""
    rng = np.random.default_rng(7)
    base = rng.integers(3, vocab, 12, dtype=np.int32)
    out = []
    for i in range(SERVE_REQUESTS):
        keep = (6, 12, 9, 12, 6, 9)[i]
        tail = rng.integers(3, vocab, 3 + (i % 3), dtype=np.int32)
        out.append(np.concatenate([base[:keep], tail]).astype(np.int32))
    return out
