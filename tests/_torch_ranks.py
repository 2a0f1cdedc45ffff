"""Rank bodies of ``tests/test_torch_tmp.py``, ``tests/test_torch_sp.py``,
``tests/test_torch_plans.py`` and ``tests/test_torch_2d.py``: each runs
inside one rank process of
``repro_torch.launch.ranks.run_ranks`` (gloo on the CPU) and returns numpy
results to the test.  No JAX here: the ranks import the port only."""
import time

import numpy as np
import torch

from repro_torch.configs.base import TrainHParams
from repro_torch.configs.registry import get_config
from repro_torch.kernels import collective_matmul as cm
from repro_torch.kernels import ref
from repro_torch.kernels import ring_attention as ra
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


def _np(t):
    return t.detach().float().numpy().copy()


def ring_cases(comm, device, cases, arrays):
    """The port's ring attention (the plain ring) on this rank's sequence
    shard of each case: out, lse and the gradients of ``sum(out * do)``."""
    n, r = comm.size, comm.rank
    out = {}
    for name, opts in cases.items():
        dtype = getattr(torch, opts["dtype"])
        s = arrays[f"{name}/q"].shape[1]
        sl = slice(r * s // n, (r + 1) * s // n)
        q, k, v, do = (torch.from_numpy(arrays[f"{name}/{t}"][:, sl]).to(dtype)
                       for t in ("q", "k", "v", "do"))
        pos = torch.from_numpy(arrays[f"{name}/pos"][:, sl])
        kw = dict(causal=True, window=opts["window"], softcap=opts["softcap"])
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        o = ra.ring_attention(qg, kg, vg, comm=comm, q_positions=pos,
                              kv_positions=pos, **kw)
        (o.float() * do.float()).sum().backward()
        _, lse = ra.ring_forward(q, k, v, comm, q_positions=pos,
                                 kv_positions=pos,
                                 scale=q.shape[-1] ** -0.5, **kw)
        out[name] = dict(out=_np(o), lse=_np(lse), dq=_np(qg.grad),
                         dk=_np(kg.grad), dv=_np(vg.grad))
    return out


def _grads(fn, *xs):
    """(outputs, grads of ``sum(tanh(out))`` summed over the outputs)."""
    xs = [x.detach().clone().requires_grad_() for x in xs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum(torch.tanh(o.float()).sum() for o in outs).backward()
    return [o.detach() for o in outs], [x.grad for x in xs]


def sp_collective_cases(comm, device, cases):
    """The SP collectives and the SP pair of the fused collective-matmul
    against their reference paths, forward and gradients, per (dtype, b,
    s, k, d) case; every rank draws every rank's inputs from one seed.
    Losses are ``sum(tanh(y))`` on every rank (the group's loss is their
    sum)."""
    n, r = comm.size, comm.rank
    ctx = TmpCtx(comm, seq_parallel=True)
    out = {}
    for dname, b, s, k, d in cases:
        dtype = getattr(torch, dname)
        rng = np.random.default_rng(9)

        def draw(*shape, scale=1.0):
            return torch.from_numpy((scale * rng.standard_normal(shape))
                                    .astype(np.float32)).to(dtype)
        xs = [draw(b, s // n, k) for _ in range(n)]     # sequence chunks
        ps = [draw(b, s, k) for _ in range(n)]          # partial products
        xfull = draw(b, s, k)                           # replicated
        xk = [draw(b, s, k // n) for _ in range(n)]     # K-sharded inputs
        w1 = [draw(k, d // n, scale=0.1) for _ in range(n)]
        w2 = [draw(k, d // n, scale=0.1) for _ in range(n)]
        wr = [draw(k // n, d, scale=0.1) for _ in range(n)]
        res = {}

        # the SP entry (sp_all_gather) + a column-parallel product: the
        # gathered x's cotangent sums every rank's partial one
        def ag(x):
            return torch.matmul(ctx.gather_seq(x), w1[r])
        (y,), (g,) = _grads(ag, xs[r])
        full = torch.cat(xs, 1).requires_grad_()
        sum(torch.tanh(torch.matmul(full, w).float()).sum()
            for w in w1).backward()
        res["ag"] = max(_err(y, torch.matmul(full.detach(), w1[r])),
                        _err(g, full.grad.chunk(n, 1)[r]))

        # the SP exit's collective (sp_reduce_scatter) of partial sums:
        # this rank's chunk of the sum
        (y,), (g,) = _grads(ctx.reduce, ps[r])
        tot = torch.stack([p.float() for p in ps]).requires_grad_()
        chunks = tot.sum(0).to(dtype).chunk(n, 1)
        sum(torch.tanh(c.float()).sum() for c in chunks).backward()
        res["rs"] = max(_err(y, chunks[r].detach()), _err(g, tot.grad[r]))

        # batch_split of a replicated tensor (shard_seq): whole cotangent
        # on every rank
        (y,), (g,) = _grads(ctx.shard_seq, xfull)
        want = 1 - torch.tanh(xfull.float()) ** 2
        res["split"] = max(_err(y, xfull.chunk(n, 1)[r]), _err(g, want))

        # fused matmul -> reduce-scatter against the product and
        # sp_reduce_scatter (the reference path), forward and gradients
        (yf,), gf = _grads(lambda x, w: cm.fused_matmul_reducescatter(
            x, w, comm, 1), xk[r], wr[r])
        (yr,), gr = _grads(lambda x, w: tmpc.sp_reduce_scatter(
            torch.matmul(x, w), comm, 1), xk[r], wr[r])
        res["fused_rs"] = max([_err(yf, yr)] + [_err(a, c)
                                                for a, c in zip(gf, gr)])

        # all-gather -> matmul, two weights on one gather, against
        # sp_all_gather and plain products
        yf, gf = _grads(lambda x, a, c: cm.fused_allgather_matmul(
            x, (a, c), comm, 1), xs[r], w1[r], w2[r])
        yr, gr = _grads(lambda x, a, c: tuple(
            torch.matmul(tmpc.sp_all_gather(x, comm, 1), w)
            for w in (a, c)), xs[r], w1[r], w2[r])
        res["fused_ag"] = max([_err(a, c) for a, c in zip(yf, yr)]
                              + [_err(a, c) for a, c in zip(gf, gr)])
        out[(dname, b, s, k, d)] = res
    return out


def sp_model_variants(comm, device, arch, flat, batch, variants):
    """Loss, this rank's flat gradients (before the step's all-reduce of
    the partial leaves), the comm counts of the forward and the backward
    and the ring forward's calls in each, per variant (schedule, remat,
    fine_remat, seq_parallel, seq_shard)."""
    cfg = reduced(arch)
    full = prm.from_flat(cfg, flat)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    calls = [0]
    ring_forward = ra.ring_forward

    def counted(*a, **kw):
        calls[0] += 1
        return ring_forward(*a, **kw)
    ra.ring_forward = counted
    out = {}
    try:
        for sched, remat, fine, sp, shard in variants:
            hp = TrainHParams(schedule=sched, remat=remat, fine_remat=fine,
                              seq_parallel=sp, seq_shard=shard)
            params = prm.shard_params(cfg, full, comm.rank, comm.size,
                                      seq_shard=shard)
            for t in prm.flat_leaves(params):
                t.requires_grad_()
            ctx = lm.train_ctx(cfg, hp, comm, tb["tokens"].shape[1])
            comm.reset_counts()
            calls[0] = 0
            loss, _ = lm.train_loss(cfg, params, tb, hp, ctx)
            fwd, fwd_calls = dict(comm.counts), calls[0]
            comm.reset_counts()
            calls[0] = 0
            loss.backward()
            out[(sched, remat, fine, sp, shard)] = dict(
                loss=loss.item(), fwd=fwd, bwd=dict(comm.counts),
                ring_calls=(fwd_calls, calls[0]),
                grads={k: t.grad.numpy().copy()
                       for k, t in prm.flatten(params).items()})
    finally:
        ra.ring_forward = ring_forward
    return out


def barrier_wait(comm, device, delay_s):
    """Seconds this rank spent in ``comm.barrier()`` when the last rank
    arrives ``delay_s`` late."""
    if comm.rank == comm.size - 1:
        time.sleep(delay_s)
    t0 = time.perf_counter()
    comm.barrier()
    return time.perf_counter() - t0


def everything(comm, device, jobs):
    """Run several bodies in one spawn: {name: (fn name, args)}."""
    return {name: globals()[fn](comm, device, *args)
            for name, (fn, args) in jobs.items()}


def fail_on_rank_one(comm, device):
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    if comm.rank == 1:
        raise ValueError("rank 1 gives up")
    return comm.all_reduce(torch.ones(4))


def reduce_scatter_cases(comm, device, cases):
    """``comm.reduce_scatter`` against the plain version from every rank's
    inputs (the rank-order f32 sum, cast once, then this rank's chunk),
    per (dtype, shape, dim) case: (max abs difference, bitwise equal).
    Every rank draws all ranks' inputs from one seed."""
    out = {}
    n = comm.size
    for dname, shape, dim in cases:
        rng = np.random.default_rng(9)
        xs = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
              .to(getattr(torch, dname)) for _ in range(n)]
        before = comm.counts["reduce_scatter"]
        got = comm.reduce_scatter(xs[comm.rank], dim)
        want = ref.all_reduce_ref(xs).chunk(n, dim)[comm.rank]
        out[(dname, shape, dim)] = dict(
            err=float((got.float() - want.float()).abs().max()),
            equal=bool(torch.equal(got, want)), shape=tuple(got.shape),
            calls=comm.counts["reduce_scatter"] - before)
    return out


def plan_variants(comm, device, arch, flat, batch, variants, cfg_kw=None):
    """Per named variant ``{"degrees", "schedules", "schedule",
    "layout", "remat", "fine"}`` (all optional) on this rank's mesh:
    the loss, this rank's flat gradients in the variant's layout (before
    the step's sums), the comm counts of the forward and the backward,
    and the normalized layout (degrees, schedules) to gather them by.
    ``cfg_kw`` replaces fields of the reduced config."""
    from repro_torch.launch import steps
    cfg = reduced(arch).replace(**(cfg_kw or {}))
    full = prm.from_flat(cfg, flat)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for name, kw in variants.items():
        hp = TrainHParams(schedule=kw.get("schedule", "oases"),
                          remat=kw.get("remat", True),
                          fine_remat=kw.get("fine", True),
                          tmp_layout=kw.get("layout", "auto"))
        setup = steps.train_setup(cfg, hp, seq_len=tb["tokens"].shape[1],
                                  comm=comm, degrees=kw.get("degrees"),
                                  schedules=kw.get("schedules"))
        params = setup.layout.shard(full, comm.rank)
        for t in prm.flat_leaves(params):
            t.requires_grad_()
        comm.reset_counts()
        loss, _ = lm.train_loss(cfg, params, tb, setup.hp, setup.ctx,
                                setup.groups)
        fwd = dict(comm.counts)
        comm.reset_counts()
        loss.backward()
        out[name] = dict(
            loss=loss.item(), fwd=fwd, bwd=dict(comm.counts),
            layout=(setup.layout.degrees, setup.layout.schedules),
            grads={k: t.grad.numpy().copy()
                   for k, t in prm.flatten(params).items()})
    return out


def plan_trainer(comm, device, arch, flat, kw, plan, steps, batch, seq):
    """The Trainer under a plan (its dict) from whole weights: losses, the
    grad norms, and this rank's weights and optimizer state as raw bits
    after the last step."""
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.runtime import Trainer
    cfg = reduced(arch)
    tr = Trainer(cfg, TrainHParams(**kw), global_batch=batch, seq_len=seq,
                 device=device, log_fn=None, comm=comm,
                 params=prm.from_flat(cfg, flat),
                 plan=ParallelPlan.from_dict(plan))
    res = tr.train(steps)

    def bits(t):
        return t.detach().float().numpy().view(np.uint32).copy()
    st = tr.opt_state
    return dict(losses=res["losses"],
                weights={k: bits(t) for k, t in
                         prm.flatten(tr.params).items()},
                master=[bits(t) for t in st["master"]],
                m=[bits(t) for t in st["m"]])


def split_raises(comm, device, arch, degrees, batch):
    """The message of the step builder's refusal of a batch the extra
    data-parallel ranks of a group do not divide."""
    from repro_torch.launch import steps
    try:
        steps.build_train_step(reduced(arch), TrainHParams(microbatch=1),
                               global_batch=batch, seq_len=16, comm=comm,
                               degrees=degrees)
    except ValueError as e:
        return str(e)
    return ""


def serve_cases(comm, device, arch, flat, dflat, cases):
    """Per named case ``{"prompts", "new", ...engine options}`` (a
    ``"draft": True`` case serves with the reduced ``arch`` as its draft
    on ``dflat``'s weights and ``spec_k`` 3): the tokens of every request
    through this rank's ``ServingEngine`` on its shards of ``flat``, the
    engine's stats and the comm counts of the drain."""
    from repro_torch.serving import Request, ServingEngine
    cfg = reduced(arch)
    full = prm.from_flat(cfg, flat)
    dfull = prm.from_flat(cfg, dflat)
    out = {}
    for name, kw in cases.items():
        kw = dict(kw)
        ps, new = kw.pop("prompts"), kw.pop("new")
        if kw.pop("draft", False):
            kw.update(draft=cfg, spec_k=3)
        eng = ServingEngine(cfg, comm, slots=4, max_seq=48, device="cpu",
                            **kw)
        eng.load(params=eng.layout.shard(full, eng.rank),
                 draft_params=(eng.draft_layout.shard(dfull, eng.rank)
                               if eng.spec_k else None))
        reqs = [Request(rid=i, prompt=p, max_new_tokens=new)
                for i, p in enumerate(ps)]
        comm.reset_counts()
        for r in reqs:
            eng.submit(r)
        stats = eng.run_until_drained()
        out[name] = dict(tokens=[r.out_tokens for r in reqs],
                         stats=stats, counts=dict(comm.counts))
    return out
