"""The plain versions of the norm, attention and RG-LRU kernels keep f64
inputs in f64 (``repro_torch.kernels.ref.wide``), so that a whole model
can run in f64 on the CPU as the witness of ``chip_smoke.py``'s
recurrentgemma phase: each against autograd of a direct f64 formula,
and the reduced recurrentgemma-9b's f64 pass against its f32 one.

Tolerances: 1e-10 of each result's largest |value| for the f64 formulas
(the same sums in another order, in f64); 1e-5 of each leaf's largest
|value| between the f32 and the f64 model passes (``grads_err``, the
f32 rounding of five small layers).
"""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import numpy as np
import pytest
import torch

from repro_torch.configs.base import TrainHParams
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.kernels import ref
from repro_torch.models import lm
from repro_torch.models import params as prm

F64_TOL = 1e-10


def _f64(rng, *shape, scale=1.0):
    return torch.from_numpy(scale * rng.standard_normal(shape))


def _close(got, want, name):
    assert got.dtype == torch.float64, (name, got.dtype)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= F64_TOL, (name, err)


def _grads(fn, leaves, dy):
    leaves = [t.clone().requires_grad_() for t in leaves]
    out = fn(*leaves)
    (out * dy).sum().backward()
    return out.detach(), [t.grad for t in leaves]


def _case_rmsnorm(rng):
    x, scale, dy = _f64(rng, 6, 40), _f64(rng, 40, scale=0.1), _f64(rng, 6, 40)

    def formula(x, scale):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-5) \
            * (1.0 + scale)
    want, (wdx, wds) = _grads(formula, [x, scale], dy)
    _close(ref.rmsnorm_ref(x, scale), want, "y")
    dx, ds = ref.rmsnorm_bwd_ref(x, scale, dy)
    _close(dx, wdx, "dx")
    _close(ds, wds, "dscale")


def _case_flash(rng):
    b, s, h, kvh, hd, window = 2, 300, 4, 2, 16, 70
    q, k, v, dout = (_f64(rng, b, s, n, hd) for n in (h, kvh, kvh, h))
    scale = hd ** -0.5
    qi = torch.arange(s)[:, None]
    kj = torch.arange(s)[None, :]
    valid = (kj <= qi) & (kj > qi - window)

    def scores(q, k):
        kk = k.repeat_interleave(h // kvh, dim=2)
        sc = torch.einsum("bqhd,bkhd->bhqk", q * scale, kk)
        return torch.where(valid, sc, torch.full_like(sc, ref.NEG_INF))

    def formula(q, k, v):
        p = torch.softmax(scores(q, k), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p,
                            v.repeat_interleave(h // kvh, dim=2))
    want, (wdq, wdk, wdv) = _grads(formula, [q, k, v], dout)
    out, lse = ref.flash_attention_ref(q, k, v, window=window)
    _close(out, want, "out")
    _close(lse, torch.logsumexp(scores(q, k), dim=-1), "lse")
    dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                             window=window)
    for name, got, w in (("dq", dq, wdq), ("dk", dk, wdk), ("dv", dv, wdv)):
        _close(got, w, name)


def _case_rglru(rng):
    b, s, w = 2, 40, 24
    x, dy = _f64(rng, b, s, w), _f64(rng, b, s, w)
    gates = [_f64(rng, w), _f64(rng, w, scale=0.5), _f64(rng, w),
             _f64(rng, w, scale=0.5), _f64(rng, w)]

    def formula(x, w_a, b_a, w_x, b_x, a_param):
        r = torch.sigmoid(x * w_a + b_a)
        i = torch.sigmoid(x * w_x + b_x)
        log_a = -ref.RGLRU_C * torch.nn.functional.softplus(a_param) * r
        q = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6))
        a, g = torch.exp(log_a), q * (i * x)
        h, hs = torch.zeros_like(x[:, 0]), []
        for t in range(s):
            h = a[:, t] * h + g[:, t]
            hs.append(h)
        return torch.stack(hs, dim=1)
    want, wgrads = _grads(formula, [x, *gates], dy)
    gd = dict(zip(ref.RGLRU_GATES, gates))
    h = ref.rglru_states_ref(x, gd)
    _close(h, want, "h")
    got = ref.rglru_bwd_ref(x, gd, h, dy)
    for name, g, wg in zip(("x",) + ref.RGLRU_GATES, got, wgrads):
        _close(g, wg, f"d{name}")


@pytest.mark.parametrize("case", [_case_rmsnorm, _case_flash, _case_rglru],
                         ids=["rmsnorm", "flash_attention", "rglru"])
def test_plain_versions_keep_f64(case):
    case(np.random.default_rng(5))


def test_recurrentgemma_f64_pass_on_cpu():
    """The reduced recurrentgemma-9b at 5 layers (a block and a tail of
    two), batch 2, seq 96 (longer than the window of 64): an f64 pass from
    the f32 weights gives f64 gradients for every leaf, within 1e-5 of the
    f32 pass's."""
    cfg = get_config("recurrentgemma-9b").reduced().replace(
        num_layers=5, dtype="float32")
    base = prm.init_params(cfg, seed=0, device=torch.device("cpu"))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        DataConfig(global_batch=2, seq_len=96,
                   vocab_size=cfg.vocab_size), 0).items()}
    hp = TrainHParams(schedule="megatron", remat=False)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        params = prm.unflatten({k: t.detach().to(dtype).requires_grad_()
                                for k, t in prm.flatten(base).items()})
        loss, _ = lm.train_loss(cfg, params, batch, hp)
        loss.backward()
        runs[dtype] = (loss, {k: t.grad for k, t in
                              prm.flatten(params).items()})
    (l32, g32), (l64, g64) = runs[torch.float32], runs[torch.float64]
    assert l64.dtype == torch.float64
    assert all(g.dtype == torch.float64 for g in g64.values())
    assert abs(l32.item() - l64.item()) <= 1e-6 * abs(l64.item())
    for k, g in g64.items():
        err = float((g32[k].double() - g).abs().max() / (g.abs().max() + 1e-8))
        assert err <= 1e-5, (k, err)
