"""Repairs of the port's training step and communicator, held to the JAX
package and to the formulas they replace, on the CPU:

* the automatic microbatch count (``resolve_hp``) stretches the
  activation budget by the model group's size under sequence parallelism
  and ring attention, as JAX's does, and ``build_train_step`` passes the
  group's size in;
* without accumulation the step hands the parameters' ``.grad`` tensors
  to the update as they are (no f32 copy), with accumulation it sums into
  f32 buffers made once; the updated weights and optimizer state are bit
  for bit those of the former formula (every gradient copied to f32);
* ``Comm.reduce_scatter`` on gloo ranks (the plain all-reduce and slice)
  equals the rank-order f32 sum's chunk bit for bit at tp 2 and 4.
"""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import copy

import pytest
import torch

import _torch_ranks
from repro.configs.base import TrainHParams as JTrainHParams
from repro.launch import steps as jsteps
from repro_torch.configs.base import TrainHParams
from repro_torch.configs.registry import get_config
from repro_torch.core.comm import SoloComm
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import steps
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import lm
from repro_torch.models.params import flat_leaves, init_params
from repro_torch.optim import adamw

# (seq_parallel, seq_shard) of a run; seq_shard is the group size or 1
LAYOUTS = [(False, 1), (True, 1), (False, "tp"), (True, "tp")]
BATCHES = (1, 2, 6, 8, 16, 32, 64)
SEQS = (512, 1024, 4096, 8192, 32768)
# (d_model, layers): internlm2-1.8b, recurrentgemma-9b, mamba2-130m
MODELS = ((2048, 24), (4096, 38), (768, 24))


def _layout(tp, sp, shard):
    return dict(seq_parallel=sp, seq_shard=tp if shard == "tp" else 1)


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("layout", LAYOUTS,
                         ids=lambda v: f"sp{int(v[0])}-shard{v[1]}")
def test_resolve_hp_matches_jax(tp, layout):
    """The port's and JAX's ``resolve_hp`` pick the same microbatch count
    over batch x seq x model, at one data-parallel rank."""
    kw = _layout(tp, *layout)
    for b in BATCHES:
        for s in SEQS:
            for d, n in MODELS:
                mine = steps.resolve_hp(TrainHParams(**kw), b, seq_len=s,
                                        d_model=d, num_layers=n, tp=tp)
                want = jsteps.resolve_hp(JTrainHParams(**kw), "train", b, 1,
                                         seq_len=s, d_model=d, num_layers=n,
                                         tp=tp)
                assert mine.microbatch == want.microbatch, (b, s, d, n)


def test_build_train_step_passes_the_group_size():
    """internlm2-1.8b at seq 4096, batch 8, ring attention over 2 ranks:
    JAX accumulates over 1 microbatch (the budget stretched 2-fold), and
    so does the step built over a group of 2; a set count is kept."""
    cfg = get_config("internlm2-1.8b")
    group = SoloComm()
    group.size = 2
    hp = TrainHParams(seq_shard=2)
    want = jsteps.resolve_hp(JTrainHParams(seq_shard=2), "train", 8, 1,
                             seq_len=4096, d_model=cfg.d_model,
                             num_layers=cfg.num_layers, tp=2)
    step = steps.build_train_step(cfg, hp, global_batch=8, seq_len=4096,
                                  comm=group)
    assert step.hp.microbatch == want.microbatch == 1
    kept = steps.build_train_step(cfg, TrainHParams(seq_shard=2,
                                                    microbatch=4),
                                  global_batch=8, seq_len=4096, comm=group)
    assert kept.hp.microbatch == 4


def _former_step(cfg, hp, params, opt_state, batch, n, ocfg, update):
    """The step's former formula: every microbatch's gradients copied to
    f32 and summed, divided by n, then the ``update``."""
    leaves = flat_leaves(params)
    micro = ([{k: t[i] for k, t in batch.items()} for i in range(n)]
             if n > 1 else [batch])
    grads = None
    for mb in micro:
        for w in leaves:
            w.grad = None
        loss, _ = lm.train_loss(cfg, params, mb, hp)
        loss.backward()
        if grads is None:
            grads = [w.grad.float() for w in leaves]
        else:
            for acc, w in zip(grads, leaves):
                acc.add_(w.grad)
    if n > 1:
        for acc in grads:
            acc.div_(n)
    update(params, grads, opt_state, ocfg)


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_train_step_matches_former_f32_copy(dname, micro, monkeypatch):
    """Two steps of the reduced internlm2-1.8b: weights, master weights
    and moments bit for bit the former formula's; at microbatch 1 the
    update gets each leaf's own ``.grad`` in the leaf's dtype."""
    cfg = get_config("internlm2-1.8b").reduced().replace(dtype=dname)
    hp = TrainHParams(schedule="megatron", remat=False, microbatch=micro,
                      learning_rate=1e-2, warmup_steps=1, total_steps=4)
    ocfg = adamw.AdamWConfig(learning_rate=1e-2, weight_decay=0.1,
                             warmup_steps=1, total_steps=4)
    params = init_params(cfg, seed=0)
    for t in flat_leaves(params):
        t.requires_grad_()
    former = copy.deepcopy(params)
    opt, former_opt = (adamw.init_opt_state(p) for p in (params, former))
    seen = []
    update = adamw.apply_updates

    def spy(p, grads, *a, **kw):
        seen.append([(g is w.grad, g.dtype == w.dtype)
                     for g, w in zip(grads, flat_leaves(p))])
        return update(p, grads, *a, **kw)

    monkeypatch.setattr(adamw, "apply_updates", spy)
    step = steps.build_train_step(cfg, hp, global_batch=4, seq_len=32)
    for i in range(2):
        batch = {k: torch.from_numpy(v) for k, v in make_batch(
            DataConfig(global_batch=4, seq_len=32, vocab_size=cfg.vocab_size,
                       microbatch=micro), i).items()}
        step(params, opt, batch)
        _former_step(cfg, hp, former, former_opt, batch, micro, ocfg, update)
    for a, b in zip(flat_leaves(params), flat_leaves(former)):
        assert torch.equal(a, b)
    for key in ("master", "m", "v"):
        for a, b in zip(opt[key], former_opt[key]):
            assert torch.equal(a, b)
    assert len(seen) == 2
    if micro == 1:
        assert all(own and same for own, same in seen[0])
    else:
        assert not any(own for own, _ in seen[0])


@pytest.fixture(scope="module")
def scatter_runs():
    cases = [("float32", (4, 8, 6), 1), ("bfloat16", (4, 8, 6), 1),
             ("float32", (8, 3), 0), ("bfloat16", (2, 3, 8), -1)]
    return {tp: run_ranks(_torch_ranks.reduce_scatter_cases, tp,
                          device="cpu", args=(cases,), timeout=300,
                          threads=1)
            for tp in (2, 4)}


@pytest.mark.parametrize("tp", [2, 4])
def test_reduce_scatter_on_gloo_ranks_is_the_sliced_sum(scatter_runs, tp):
    for rank, res in enumerate(scatter_runs[tp]):
        for (dname, shape, dim), r in res.items():
            want = list(shape)
            want[dim] //= tp
            assert r["equal"] and r["err"] == 0.0, (rank, dname, shape, r)
            assert r["shape"] == tuple(want) and r["calls"] == 1
