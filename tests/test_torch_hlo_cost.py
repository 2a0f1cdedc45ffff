"""The port's step-cost counter (``repro_torch.launch.hlo_cost``) case by
case with JAX's ``tests/test_hlo_cost.py``: products in loops and nested
loops, a loop-free product against ``FlopCounterMode`` and against JAX's
walker on the same function, the ring factors of every collective kind at
groups 2 and 4 against JAX's ``_collective_cost``, ``roofline_seconds``
against JAX's, a slice copied into a stacked buffer charged the slice,
and each kernel wrapper charged its ``kernels/bounds.py`` work as one
unit, not its plain version's intermediates.  Counts are exact."""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.launch import hlo_cost as jhc
from repro_torch.core.comm import TraceComm
from repro_torch.kernels import bounds
from repro_torch.kernels import collective_matmul as cm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_gmm import grouped_matmul
from repro_torch.kernels.rglru import rglru
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd import ssd
from repro_torch.launch import hlo_cost


def _jax_cost(f, *args):
    return jhc.analyze(jax.jit(f).lower(*args).compile().as_text())


def test_loop_trip_count_flops():
    """8 products in a Python loop count 8 times, as JAX's scan of 8."""
    def f(w, x):
        for _ in range(8):
            x = torch.tanh(x @ w)
        return x.sum()

    c = hlo_cost.analyze(f, torch.ones(128, 128), torch.ones(128, 128))
    assert c.dot_flops == c.plain_dot_flops == c.torch_flops \
        == 8 * 2 * 128 ** 3

    def g(w, x):
        def body(c, _):
            return jnp.tanh(c @ w), None
        y, _ = lax.scan(body, x, None, length=8)
        return jnp.sum(y)

    assert _jax_cost(g, jnp.ones((128, 128)), jnp.ones((128, 128))) \
        .dot_flops == c.dot_flops


def test_loop_free_matches_flop_counter_and_jax():
    def f(a, b):
        return torch.tanh(a @ b).sum()

    c = hlo_cost.analyze(f, torch.ones(256, 512), torch.ones(512, 128))
    assert c.dot_flops == c.torch_flops == 2 * 256 * 512 * 128
    assert c.dot_flops == _jax_cost(lambda a, b: jnp.sum(jnp.tanh(a @ b)),
                                    jnp.ones((256, 512)),
                                    jnp.ones((512, 128))).dot_flops


def test_nested_loop_multiplication():
    def f(w, x):
        for _ in range(8):
            for _ in range(4):
                x = x @ w
        return x.sum()

    c = hlo_cost.analyze(f, torch.ones(64, 64), torch.ones(64, 64))
    assert c.dot_flops == 32 * 2 * 64 ** 3

    def g(w, x):
        def outer(c, _):
            def inner(c2, _):
                return c2 @ w, None
            c2, _ = lax.scan(inner, c, None, length=4)
            return c2, None
        y, _ = lax.scan(outer, x, None, length=8)
        return jnp.sum(y)

    assert _jax_cost(g, jnp.ones((64, 64)), jnp.ones((64, 64))).dot_flops \
        == c.dot_flops


# (Comm op, JAX's kind, the payload's shape given x [128, 256] on n ranks)
COMM_OPS = [
    ("all_reduce", "all-reduce", lambda n: (128, 256)),
    ("all_gather", "all-gather", lambda n: (128 * n, 256)),
    ("reduce_scatter", "reduce-scatter", lambda n: (128 // n, 256)),
    ("ring_shift", "collective-permute", lambda n: (128, 256)),
]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op,kind,payload", COMM_OPS,
                         ids=[o[0] for o in COMM_OPS])
def test_collective_ring_factors_match_jax(op, kind, payload, n):
    """A TraceComm op's result shape, and its payload and link bytes
    against JAX's ``_collective_cost`` of the same HLO op."""
    def f(x):
        comm = TraceComm(1, n, hlo_cost.record)
        if op == "all_reduce":
            return comm.all_reduce(x)
        if op == "ring_shift":
            return comm.ring_shift(x)
        return getattr(comm, op)(x, 0)

    with hlo_cost.Tracer(default_group=n) as tr:
        x = torch.zeros(128, 256)
        out = tr.run(f, x)
        assert tuple(out.shape) == payload(n)
    c = tr.cost()
    groups = ",".join(map(str, range(n)))
    dims = ",".join(map(str, payload(n)))
    want = jhc._collective_cost(jhc.Op("c", kind, f"f32[{dims}]{{1,0}}",
                                       f"%p0), replica_groups={{{{{groups}}}}}"),
                                n)
    assert c.collective_counts == {kind: 1}
    assert (c.collective_payload_bytes, c.collective_link_bytes) == want
    assert c.collective_by_kind == {kind: want[1]}
    assert c.hbm_bytes == 2 * want[0]


def test_roofline_seconds_matches_jax():
    kw = dict(dot_flops=2e12, hbm_bytes=1e9, collective_link_bytes=5e9)
    c, j = hlo_cost.HloCost(**kw), jhc.HloCost(**kw)
    for args in (dict(), dict(mxu_eff=0.25)):
        r = c.roofline_seconds(peak_flops=1e12, hbm_bw=1e10, link_bw=1e9,
                               **args)
        assert r == j.roofline_seconds(peak_flops=1e12, hbm_bw=1e10,
                                       link_bw=1e9, **args)
    assert c.roofline_seconds(peak_flops=1e12, hbm_bw=1e10, link_bw=1e9) \
        == {"compute_s": 2.0, "comm_s": 5.0, "serial_s": 7.0,
            "overlapped_s": 5.0}
    assert c.to_dict().keys() == j.to_dict().keys()


def test_slice_copy_charged_the_slice():
    """A loop writing one row of a [64, 128] buffer per step costs the
    rows, not the buffer each step (JAX's ``test_dus_inplace_not_
    overcounted``): the zeros, 64 row copies (read and write) and the
    final sum."""
    def f(x):
        buf = torch.zeros(64, 128)
        for i in range(64):
            buf[i].copy_(x)
        return buf.sum()

    c = hlo_cost.analyze(f, torch.ones(128))
    row, whole = 128 * 4, 64 * 128 * 4
    assert c.hbm_bytes == whole + 64 * 2 * row + whole + 4
    assert c.hbm_bytes < 0.5 * 64 * whole
    # the in-place update of an argument is its alias bytes
    assert c.mem["argument_bytes"] == row and c.mem["alias_bytes"] == 0

    def g(w):
        with torch.no_grad():
            for i in range(4):
                w[i].mul_(2.0)
        return w.sum()

    c = hlo_cost.analyze(g, torch.ones(4, 32))
    assert c.mem["alias_bytes"] == c.mem["argument_bytes"] == 4 * 32 * 4
    # each row read and written once, then the sum reads the buffer
    assert c.hbm_bytes == 4 * 2 * 32 * 4 + 4 * 32 * 4 + 4


def _rng(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _gates(w):
    return {k: _rng(w, seed=i) * 0.5 for i, k in enumerate(
        ("w_a", "b_a", "w_x", "b_x", "a_param"))}


# (case, the function of leaf tensors, the leaves, the units it runs with
# each one's bounds work: (unit, bytes, product flops, other operations))
def _unit_cases():
    b, s, h, kvh, hd = 2, 64, 4, 2, 32
    q, k, v = _rng(b, s, h, hd), _rng(b, s, kvh, hd, seed=1), \
        _rng(b, s, kvh, hd, seed=2)
    pairs = bounds.visible_pairs(s)
    (ffb, fff), (fbb, fbf) = bounds.flash_work(b, s, h, kvh, hd, pairs, 4)
    x, sc = _rng(64, 128), _rng(128) * 0.1
    e, c_, d, f = 4, 16, 32, 24
    xg, wg = _rng(e, c_, d), _rng(e, d, f, seed=3)
    gb, gf = bounds.moe_gmm_work(e, c_, d, f, 4)
    dxb, dxf = bounds.moe_gmm_work(e, c_, f, d, 4)
    dwb, dwf = bounds.moe_gmm_work(e, d, c_, f, 4)
    sb, ss, sh, sp, sn = 1, 64, 2, 16, 8
    sx = _rng(sb, ss, sh, sp)
    sdt = torch.full((sb, ss, sh), 0.1)
    sa, sB, sC, sD = _rng(sh) * 0.1, _rng(sb, ss, sn, seed=4), \
        _rng(sb, ss, sn, seed=5), _rng(sh, seed=6)
    ssb, ssf = bounds.ssd_work(sb, ss, sh, sp, sn, ss, 4)
    sbb, sbf = bounds.ssd_bwd_work(sb, ss, sh, sp, sn, ss, 4)
    rx = _rng(2, 40, 16)
    rb, ro = bounds.rglru_work(2, 40, 16, 4)
    rbb, rbo = bounds.rglru_bwd_work(2, 40, 16, 4)
    nb, no = bounds.rmsnorm_work(64, 128, 4)
    nbb, nbo = bounds.rmsnorm_bwd_work(64, 128, 4)
    mb, mf = bounds.gemm_work(64, 128, 32, 4)
    return [
        ("rmsnorm", lambda x, s: rmsnorm(x, s), (x, sc),
         [("rmsnorm", nb, 0, no), ("rmsnorm_bwd", nbb, 0, nbo)]),
        ("flash_attention",
         lambda q, k, v: flash_attention(q, k, v), (q, k, v),
         [("flash_attention", ffb, fff, 0),
          ("flash_attention_bwd", fbb, fbf, 0)]),
        ("moe_gmm", grouped_matmul, (xg, wg),
         [("moe_gmm", gb, gf, 0), ("moe_gmm_bwd", dxb + dwb, dxf + dwf, 0)]),
        ("ssd", lambda *t: ssd(*t, chunk=64), (sx, sdt, sa, sB, sC, sD),
         [("ssd", ssb, ssf, 0), ("ssd_bwd", sbb, sbf, 0)]),
        ("rglru", lambda x, *g: rglru(x, dict(zip(
            ("w_a", "b_a", "w_x", "b_x", "a_param"), g)))[0],
         (rx, *_gates(16).values()),
         [("rglru", rb, 0, ro), ("rglru_bwd", rbb, 0, rbo)]),
        # the wrapper by its module's name, as a caller reaches it
        ("tile_matmul", lambda a, w: cm.tile_matmul(a, w),
         (x, _rng(128, 32)), [("tile_matmul", mb, mf, 0)]),
    ]


UNIT_CASES = _unit_cases()


@pytest.mark.parametrize("case", UNIT_CASES, ids=[c[0] for c in UNIT_CASES])
def test_kernel_unit_charged_bounds_work(case):
    """Forward and backward of each kernel wrapper: one call of each unit
    at its bounds work, nothing of its plain version in the roofline
    count; the plain version's products are counted as executed with
    ``plain=True``, and the unit's empty outputs take the plain version's
    shapes (the roofline count is the same either way)."""
    _, fn, leaves, want = case
    grad = want[-1][0].endswith("_bwd")

    def step(*ts):
        y = fn(*ts)
        if grad:
            y.float().square().sum().backward()
        return y

    costs = []
    for plain in (False, True):
        args = [t.clone().requires_grad_(grad) for t in leaves]
        costs.append(hlo_cost.analyze(step, *args, plain=plain))
    fast, full = costs
    assert fast.units == full.units == {
        u: {"calls": 1, "bytes": nb, "dot": fl, "ops": ops}
        for u, nb, fl, ops in want}
    unit_dot = sum(fl for _, _, fl, _ in want)
    unit_bytes = sum(nb for _, nb, _, _ in want)
    # outside the units the two traces run the same ops
    assert fast.dot_flops == full.dot_flops
    assert fast.dot_flops - unit_dot == fast.plain_dot_flops
    assert fast.hbm_bytes - unit_bytes == fast.plain_hbm_bytes
    assert full.plain_dot_flops >= fast.plain_dot_flops
    assert full.plain_hbm_bytes > fast.plain_hbm_bytes
    # the plain version's temporaries stay out of the unit's memory (its
    # outputs may be views of larger buffers: the SSD's gradients)
    assert fast.mem["temp_bytes"] <= full.mem["temp_bytes"]


def test_trace_leaves_no_fake_tensor_behind():
    """The rope cache is cleared around a trace: a real forward after a
    trace, and a trace after a real forward, both run."""
    from repro_torch.models.attention import rope
    x, pos = _rng(1, 8, 2, 16), torch.arange(8)
    want = rope(x, pos, 10000.0)
    hlo_cost.analyze(lambda x, p: rope(x, p, 10000.0), x, pos)
    assert torch.equal(rope(x, pos, 10000.0), want)
