"""Rank bodies of ``tests/test_torch_tmp.py``: each runs inside one rank
process of ``repro_torch.launch.ranks.run_ranks`` (gloo on the CPU) and
returns numpy results to the test.  No JAX here: the ranks import the
port only."""
import numpy as np
import torch

from repro_torch.configs.base import TrainHParams
from repro_torch.configs.registry import get_config
from repro_torch.kernels import collective_matmul as cm
from repro_torch.kernels import ref
from repro_torch.models import lm
from repro_torch.models import params as prm
from repro_torch.core import tmp as tmpc
from repro_torch.core.schedule import TmpCtx


def reduced(arch):
    return get_config(arch).reduced().replace(dtype="float32")


def model_variants(comm, device, arch, flat, batch, variants):
    """Loss, this rank's flat grads and the comm counts of the forward
    and the backward, per (schedule, remat, fine_remat) variant."""
    cfg = reduced(arch)
    full = prm.from_flat(cfg, flat)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for sched, remat, fine in variants:
        params = prm.shard_params(cfg, full, comm.rank, comm.size)
        for t in prm.flat_leaves(params):
            t.requires_grad_()
        hp = TrainHParams(schedule=sched, remat=remat, fine_remat=fine)
        ctx = TmpCtx(comm, schedule=sched)
        comm.reset_counts()
        loss, _ = lm.train_loss(cfg, params, tb, hp, ctx)
        fwd = dict(comm.counts)
        comm.reset_counts()
        loss.backward()
        bwd = dict(comm.counts)
        out[(sched, remat, fine)] = dict(
            loss=loss.item(), fwd=fwd, bwd=bwd,
            grads={k: t.grad.numpy().copy()
                   for k, t in prm.flatten(params).items()})
    return out


def _shards(x, w, rank, size):
    k = x.shape[-1] // size
    sl = slice(rank * k, (rank + 1) * k)
    return x[..., sl].contiguous(), w[sl].contiguous()


def _err(a, b):
    return float((a.float() - b.float()).abs().max()
                 / (b.float().abs().max() + 1e-6))


def collective_cases(comm, device, cases):
    """The ring decomposition against the reference paths (forward, and
    the fused exit's gradients against megatron's), per (dtype, b, s, k,
    d) case; x and w whole on every rank, K sharded."""
    out = {}
    for dname, b, s, k, d in cases:
        dtype = getattr(torch, dname)
        rng = np.random.default_rng(7)
        xf = torch.from_numpy(rng.standard_normal((b, s, k))
                              .astype(np.float32)).to(dtype)
        wf = torch.from_numpy((0.1 * rng.standard_normal((k, d)))
                              .astype(np.float32)).to(dtype)
        x, w = _shards(xf, wf, comm.rank, comm.size)
        n = comm.size
        r = {}
        r["ar"] = _err(cm.fused_matmul_allreduce(x, w, comm, scatter_dim=1),
                       cm.matmul_allreduce_ref(x, w, comm))
        r["ar_backend"] = cm.backend(comm, s)
        if s % n == 0:
            r["rs"] = _err(cm.ring_matmul_reducescatter(x, w, comm, 1),
                           cm.matmul_reducescatter_ref(x, w, comm, 1))
            # the kernel wrapper on CPU tensors (the ring decomposition)
            # against the plain version from every rank's inputs
            xs, ws = zip(*[_shards(xf, wf, i, n) for i in range(n)])
            plain = ref.matmul_reducescatter_all_ranks_ref(
                [t.transpose(0, 1).reshape(-1, t.shape[-1]) for t in xs],
                list(ws), n)[comm.rank].reshape(s // n, b, d)
            r["rs_plain"] = _err(cm.matmul_reducescatter(x, w, comm, 1),
                                 plain.transpose(0, 1))
            chunk = x.narrow(1, comm.rank * (s // n), s // n)
            r["ag"] = _err(cm.ring_allgather(chunk, comm, 1),
                           comm.all_gather(chunk, 1))
        else:
            try:
                cm._dispatch_rs(x, w, comm, 1)
                r["rs_raises"] = ""
            except ValueError as e:
                r["rs_raises"] = str(e)
        # gradients: fused exit against megatron's g (all-reduce forward,
        # identity backward) under loss sum(tanh(y))
        grads = {}
        for name in ("fused", "megatron"):
            xg = x.clone().requires_grad_()
            wg = w.clone().requires_grad_()
            if name == "fused":
                y = cm.fused_matmul_allreduce(xg, wg, comm, scatter_dim=1)
            else:
                y = tmpc.reduce_from_tmp(torch.matmul(xg, wg), comm)
            torch.tanh(y.float()).sum().backward()
            grads[name] = (xg.grad, wg.grad)
        r["grad"] = max(_err(a, b) for a, b in zip(grads["fused"],
                                                   grads["megatron"]))
        out[(dname, b, s, k, d)] = r
    return out


def trainer_losses(comm, device, arch, flat, kw, steps):
    """The port's Trainer on this rank's shards."""
    from repro_torch.runtime import Trainer
    cfg = reduced(arch)
    tr = Trainer(cfg, TrainHParams(**kw), global_batch=4, seq_len=32,
                 device=device, log_fn=None, comm=comm,
                 params=prm.from_flat(cfg, flat))
    res = tr.train(steps)
    ok = all(t.grad is not None and bool(torch.isfinite(t.grad).all())
             for t in prm.flat_leaves(tr.params))
    return dict(losses=res["losses"], grads_ok=ok,
                final_step=res["final_step"])


def everything(comm, device, jobs):
    """Run several bodies in one spawn: {name: (fn name, args)}."""
    return {name: globals()[fn](comm, device, *args)
            for name, (fn, args) in jobs.items()}


def fail_on_rank_one(comm, device):
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    if comm.rank == 1:
        raise ValueError("rank 1 gives up")
    return comm.all_reduce(torch.ones(4))
