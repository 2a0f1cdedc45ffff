"""The order of operations of the RG-LRU kernels (``csrc/rglru.cu``),
stated in plain torch and held to the port's plain versions and to the
JAX package.

A block owns ``LANES`` channels of one batch row for the whole sequence
and walks time in tiles of ``TILE = WARPS x STEPS`` steps; in a tile,
warp k owns the sub-chunk of ``STEPS`` steps from ``k * STEPS``.
Forward, per tile: each sub-chunk's summary from h = 0 (A = the product
of its a's, H = its end state); its incoming state = the tile's carry
folded with the summaries of the sub-chunks before it, in sub-chunk
order; its steps walked again from there; the last sub-chunk's end state
is the next tile's carry, and the carry entering each tile is what the
forward keeps for the backward.  Backward, tiles from the last to the
first: the tile's h recomputed from its saved state by the forward's own
code (:func:`tile_forward`); each sub-chunk's D (its gradient walked back
import _torch_threads  # noqa: F401  (one torch thread: see the module)
from 0, times its first a) folded with the same A from the carry of the
tile after, in reverse sub-chunk order; dh walked back per step and the
chain rule per element; each thread's five gate-gradient sums over its
steps (tiles from the last, steps from the last), then the block's warps
in warp order, then the batch rows in order.  Rows past s read as 0, as
the kernels' zero-filled tile rows.  :func:`fwd_emulation` and
:func:`bwd_emulation` pin the structure, not the card's bits (its exp,
division and fused multiply-adds round otherwise).

Tolerances: ``chip_smoke.py``'s gates for the kernels against the plain
versions (``FAMILY_TOL`` 1e-5 of each result's largest |value|; bf16
y and dx one bf16 ulp, ``FAMILY_RTOL``); against JAX as
``tests/test_torch_rglru.py`` (y 1e-5 of the largest |y| and one bf16
ulp; f32 gradients 1e-5 of each one's largest |value|).  Inputs are made
with numpy from a seed.
"""
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import rglru as jrglru
from repro_torch.kernels import _build, bounds
from repro_torch.kernels import rglru as krglru
from repro_torch.kernels.ref import (RGLRU_C, RGLRU_GATES, _rglru_terms,
                                    rglru_bwd_ref, rglru_states_ref, wide)

ROOT = Path(__file__).resolve().parents[1]
LANES, WARPS, STEPS = 32, 8, 8
TILE = WARPS * STEPS


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


def _tiled(t: torch.Tensor, j: int) -> torch.Tensor:
    """Tile j of a padded [b, nt * TILE, w] tensor as [b, WARPS, STEPS, w]:
    warp k's sub-chunk in row k."""
    b, _, w = t.shape
    return t[:, j * TILE:(j + 1) * TILE].reshape(b, WARPS, STEPS, w)


def _padded(t: torch.Tensor, nt: int) -> torch.Tensor:
    """``wide(t)`` with zero rows up to nt * TILE steps."""
    return F.pad(wide(t), (0, 0, 0, nt * TILE - t.shape[1]))


def tile_forward(a, g, carry):
    """One tile of the forward: a, g [b, WARPS, STEPS, w], the carry
    entering it [b, w] -> (each sub-chunk's incoming state [b, WARPS, w],
    the tile's states [b, WARPS, STEPS, w], the carry out)."""
    A, H = torch.ones_like(a[:, :, 0]), torch.zeros_like(a[:, :, 0])
    for l in range(STEPS):                 # the summaries from h = 0
        H = a[:, :, l] * H + g[:, :, l]
        A = A * a[:, :, l]
    h_in, h = [], carry
    for k in range(WARPS):                 # the fold, in sub-chunk order
        h_in.append(h)
        h = A[:, k] * h + H[:, k]
    h = h_in = torch.stack(h_in, 1)
    hs = []
    for l in range(STEPS):                 # the walk from the folded state
        h = a[:, :, l] * h + g[:, :, l]
        hs.append(h)
    hs = torch.stack(hs, 2)
    return h_in, hs, hs[:, WARPS - 1, STEPS - 1]


def fwd_emulation(x, gates):
    """-> (y in x's dtype, h [b, s, w] f32, the tile-start states
    [b, nt, w]) in the forward kernel's order."""
    b, s, w = x.shape
    nt = krglru.tiles(s)
    t = _rglru_terms(_padded(x, nt), gates)
    carry = t["a"].new_zeros(b, w)
    hs, states = [], []
    for j in range(nt):
        states.append(carry)
        _, h, carry = tile_forward(_tiled(t["a"], j), _tiled(t["g"], j),
                                   carry)
        hs.append(h.reshape(b, TILE, w))
    h = torch.cat(hs, 1)[:, :s]
    return h.to(x.dtype), h, torch.stack(states, 1)


def bwd_emulation(x, gates, states, dy):
    """-> ((dx in x's dtype, the five f32 [w] gate gradients), the h the
    backward recomputed [b, s, w]) in the backward kernel's order."""
    b, s, w = x.shape
    nt = krglru.tiles(s)
    xf, dyf = _padded(x, nt), _padded(dy, nt)
    t = _rglru_terms(xf, gates)
    carry = xf.new_zeros(b, w)
    sums = xf.new_zeros(5, b, WARPS, w)     # a thread's five sums
    dx = torch.empty_like(xf)
    h_all = torch.empty_like(xf)
    w_a, w_x = wide(gates["w_a"]), wide(gates["w_x"])
    for j in reversed(range(nt)):
        a, dyj, xj = _tiled(t["a"], j), _tiled(dyf, j), _tiled(xf, j)
        r, i, q, e2, m = (_tiled(t[k], j) for k in ("r", "i", "q", "e2", "m"))
        c2 = torch.where(m > 1e-6, e2, torch.zeros_like(e2))
        h_in, h, _ = tile_forward(a, _tiled(t["g"], j), states[:, j])
        h_all[:, j * TILE:(j + 1) * TILE] = h.reshape(b, TILE, w)
        A, D = torch.ones_like(carry[:, None]).expand_as(a[:, :, 0]), 0.0
        for l in range(STEPS):
            A = A * a[:, :, l]
        for l in reversed(range(STEPS)):
            D = a[:, :, l] * (dyj[:, :, l] + D)
        nxt, n = [None] * WARPS, carry
        for k in reversed(range(WARPS)):   # the fold, from the last
            nxt[k] = n
            n = A[:, k] * n + D[:, k]
        nxt = torch.stack(nxt, 1)
        h_prev = torch.cat([h_in[:, :, None], h[:, :, :-1]], 2)
        dxt = torch.empty_like(a)
        for l in reversed(range(STEPS)):
            dh = dyj[:, :, l] + nxt
            nxt = a[:, :, l] * dh
            xl, il, ql, rl = xj[:, :, l], i[:, :, l], q[:, :, l], r[:, :, l]
            dq = dh * (il * xl)
            dhq = dh * ql
            # 2 e2 dm = c2 (dq / q): the clamp's mask in c2
            dlog_a = dh * h_prev[:, :, l] * a[:, :, l] \
                - c2[:, :, l] * (dq / ql)
            dza = dlog_a * (-RGLRU_C * t["sp"]) * rl * (1.0 - rl)
            dzx = dhq * xl * il * (1.0 - il)
            dxt[:, :, l] = dza * w_a + (dzx * w_x + dhq * il)
            for n_, term in enumerate((dza * xl, dza, dzx * xl, dzx,
                                       dlog_a * rl)):
                sums[n_] = sums[n_] + term
        carry = nxt[:, 0]
        dx[:, j * TILE:(j + 1) * TILE] = dxt.reshape(b, TILE, w)
    sums[4] = -RGLRU_C * sums[4]           # the a_param sum's factor -8
    block = torch.zeros_like(sums[:, :, 0])
    for k in range(WARPS):                 # the block's warps, in order
        block = block + sums[:, :, k]
    dgates = torch.zeros_like(block[:, 0])
    for bi in range(b):                    # the batch rows, in order
        dgates = dgates + block[:, bi]
    dgates[4] = dgates[4] * torch.sigmoid(wide(gates["a_param"]))
    return ((dx[:, :s].to(x.dtype), *dgates.unbind(0)),
            h_all[:, :s])


def _inputs(b, s, w, seed=7):
    """x ~ N(0, 1), dy ~ N(0, 1) and gate vectors that spread the decay a
    over (0, 1): w_a, w_x ~ N(0, 1), b_a, b_x ~ 0.5 N(0, 1), a_param ~
    N(0, 1); f32 numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, s, w)).astype(f)
    gates = {"w_a": rng.standard_normal(w),
             "b_a": 0.5 * rng.standard_normal(w),
             "w_x": rng.standard_normal(w),
             "b_x": 0.5 * rng.standard_normal(w),
             "a_param": rng.standard_normal(w)}
    dy = rng.standard_normal((b, s, w)).astype(f)
    return x, {k: v.astype(f) for k, v in gates.items()}, dy


def _torch(x, gates, dy, dname):
    dt = getattr(torch, dname)
    return (torch.from_numpy(x).to(dt),
            {k: torch.from_numpy(v) for k, v in gates.items()},
            torch.from_numpy(dy).to(dt))


def _gate(name, got, want, dname):
    """``chip_smoke.py``'s ``_family_check``: FAMILY_TOL of want's largest
    |value|, FAMILY_RTOL[dname]."""
    atol = SMOKE.FAMILY_TOL * float(want.float().abs().max())
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=atol, rtol=SMOKE.FAMILY_RTOL[dname],
                               err_msg=name)


# (b, s, w): ragged in time and channels, several tiles, one tile cut
# short, a sequence shorter than a sub-chunk, and more than one block
SHAPES = [(2, 300, 40), (1, 1000, 33), (3, 77, 16), (2, 9, 24),
          (1, 256, 70)]


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,w", SHAPES)
def test_rglru_emulation_matches_plain_versions(b, s, w, dname):
    """y, the tile-start states, dx and the five gate gradients within the
    card's gates; the backward's recomputed h is the forward's, bit for
    bit; the wrapper's CPU states are the emulation's within the gate."""
    x, gates, dy = _torch(*_inputs(b, s, w), dname)
    y, h, states = fwd_emulation(x, gates)
    want_h = rglru_states_ref(x, gates)
    _gate("y", y, want_h.to(x.dtype), dname)
    _gate("h", h, want_h, "float32")
    assert states.shape == (b, krglru.tiles(s), w)
    _gate("states", states, krglru.tile_states(want_h), "float32")
    grads, h_bwd = bwd_emulation(x, gates, states, dy)
    assert torch.equal(h_bwd, h)
    want = rglru_bwd_ref(x, gates, want_h, dy)
    for name, got, ref_ in zip(("x",) + RGLRU_GATES, grads, want):
        assert got.dtype == ref_.dtype
        _gate(f"d{name}", got, ref_, dname if name == "x" else "float32")
    _, h0 = krglru.rglru_fwd(x, tuple(gates[k] for k in RGLRU_GATES),
                             states=True)
    _gate("wrapper states", h0, states, "float32")


# JAX's kernel takes s a multiple of its 64-step blocks (or shorter) and
# w of its 512-channel blocks (or narrower)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,w", [(1, 384, 33), (3, 64, 16)])
def test_rglru_emulation_matches_jax(b, s, w, dname):
    """y against JAX's ``ref.rglru_ref`` (the associative scan) and the
    Pallas kernel in interpret mode."""
    xn, gates, dy = _inputs(b, s, w, seed=5)
    x, tg, _ = _torch(xn, gates, dy, dname)
    y, _, _ = fwd_emulation(x, tg)
    jg = {k: jnp.asarray(v) for k, v in gates.items()}
    jx = jnp.asarray(x.float().numpy(), getattr(jnp, dname))
    rtol = 2 ** -7 if dname == "bfloat16" else 0.0
    for want in (jref.rglru_ref(jx, jg)[0],
                 jops.rglru(jx, jg, interpret=True)[0]):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(y.float().numpy(), want,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   rtol=rtol)


@pytest.mark.parametrize("b,s,w", [(2, 300, 40), (1, 140, 33)])
def test_rglru_emulation_matches_jax_grad(b, s, w):
    """dx and the five gate gradients against ``jax.grad`` of JAX's
    ``rglru_scan`` for a random cotangent, f32."""
    xn, gates, dyn = _inputs(b, s, w, seed=11)

    def f(x, g):
        return jnp.sum(jrglru.rglru_scan(x, g)[0] * dyn)

    gx, gg = jax.jit(jax.grad(f, argnums=(0, 1)))(
        jnp.asarray(xn), {k: jnp.asarray(v) for k, v in gates.items()})
    want = [np.asarray(gx)] + [np.asarray(gg[k]) for k in RGLRU_GATES]
    x, tg, dy = _torch(xn, gates, dyn, "float32")
    _, _, states = fwd_emulation(x, tg)
    grads, _ = bwd_emulation(x, tg, states, dy)
    for name, got, ref_ in zip(("x",) + RGLRU_GATES, grads, want):
        np.testing.assert_allclose(got.numpy(), ref_,
                                   atol=1e-5 * float(np.abs(ref_).max()),
                                   rtol=0, err_msg=name)


def test_rglru_kernel_source_states_the_emulated_geometry():
    """The geometry constants the emulation mirrors, in the kernel's
    source and in its wrapper."""
    src = (_build.CSRC / "rglru.cu").read_text()
    for name, value in (("LANES", LANES), ("WARPS", WARPS),
                        ("STEPS", STEPS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "constexpr int TILE = WARPS * STEPS;" in src
    assert (krglru.LANES, krglru.WARPS, krglru.STEPS, krglru.TILE,
            bounds.RGLRU_TILE) == (LANES, WARPS, STEPS, TILE, TILE)
    assert [krglru.tiles(s) for s in (1, 64, 65, 4096)] == [1, 1, 2, 64]
    h = torch.arange(2 * 200 * 3, dtype=torch.float32).reshape(2, 200, 3)
    st = krglru.tile_states(h)
    assert st.shape == (2, 4, 3) and not st[:, 0].any()
    assert torch.equal(st[:, 1:], h[:, [63, 127, 191]])


def test_rglru_bounds_count_tile_states_and_the_mufu_floor():
    """The saved states are the tile-start states (2 MB each way at the
    slice, not 134 MB); the special-function floor is results over 16 a
    clock on each of 132 SMs, beside the bytes bound and not in it."""
    assert bounds.rglru_states_bytes(2, 4096, 4096) == 2 * 4 * 2 * 64 * 4096
    assert bounds.rglru_states_bytes(3, 77, 1001) == 2 * 4 * 3 * 2 * 1001
    n = 2 * 4096 * 4096
    assert bounds.mufu_ms(16 * 132 * 1.98e9) == pytest.approx(1e3)
    assert bounds.mufu_ms(7 * n) == pytest.approx(0.05617, rel=1e-3)
    assert bounds.mufu_ms(8 * n, clock_hz=1.755e9) \
        == pytest.approx(0.07243, rel=1e-3)
    fwd, bwd = bounds.rglru(), bounds.rglru_bwd()
    assert fwd["bound_by"] == bwd["bound_by"] == "bytes"
    assert fwd["bound_ms"] == pytest.approx(0.04009, rel=1e-3)
    assert bwd["bound_ms"] == pytest.approx(0.06015, rel=1e-3)
    assert fwd["mufu_ms"] == bounds.mufu_ms(bounds.RGLRU_MUFU["forward"] * n)
    assert bwd["states_bytes"] == bounds.rglru_states_bytes(2, 4096, 4096)


def test_smoke_reports_the_rglru_kernels():
    """Phase 1 parses ptxas's report of every RG-LRU instance (a spill
    fails the run), and phase 17 counts each instance's SASS
    instructions and special-function ones."""
    assert sorted(SMOKE.RGLRU_KERNELS) == [
        "rglru_bwd_kernel<bf16>", "rglru_bwd_kernel<f32>",
        "rglru_fwd_kernel<bf16>", "rglru_fwd_kernel<f32>",
        "rglru_sum_kernel<5>"]
    fwd = ("_ZN12_GLOBAL__N_116rglru_fwd_kernelI13__nv_bfloat16EEvPKT_"
           "NS_5GatesEPS2_PfNS_4DimsE")
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 90 registers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116"
        "rglru_sum_kernelILi5EEEvPKfS2_Pfii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 16 registers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116"
        "rglru_bwd_kernelIfEEvPKT_S3_PKfNS_5GatesEPS1_PfNS_4DimsE' for "
        "'sm_90a'",
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 128 registers",
    ])
    rep = SMOKE._kernel_report(log, SMOKE._RGLRU_NAMES)
    assert sorted(rep) == ["rglru_bwd_kernel<f32>", "rglru_fwd_kernel<bf16>",
                           "rglru_sum_kernel<5>"]
    assert rep["rglru_bwd_kernel<f32>"]["spill_stores"] == 8
    assert not SMOKE._kernel_report(log, SMOKE._SSD_NORM_NAMES)
    sass = "\n".join([
        f"\t\tFunction : {fwd}",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
        "        /*0010*/                   MUFU.EX2 R3, R3 ;",
        "        /*0020*/               @P0 MUFU.RCP R4, R5 ;",
        "        /*0030*/              @!P1 FFMA R2, R3, R4, R5 ;",
        "        /*0040*/                   NOP ;",
        "\t\tFunction : _ZN12_GLOBAL__N_19other_kernelEv",
        "        /*0000*/                   MUFU.EX2 R3, R3 ;",
    ])
    assert SMOKE._sass_counts(sass, SMOKE._RGLRU_NAMES) == {
        "rglru_fwd_kernel<bf16>": {"instructions": 4, "mufu": 2}}


def test_kernels_line_rglru_rows_carry_only_measured_numbers():
    """The kernels line's RG-LRU rows: the slice's bf16 numbers, the
    forward's time without the states and the backward's states bytes
    beside them; phase 17's MUFU floor, a reckoning, stays in its rows."""
    def row(**extra):
        return {**dict(case="slice", dtype="bfloat16", b=2, s=4096, w=4096,
                       max_abs_err=0.0, ms=0.1, plain_ms=1.0, bound_ms=0.04,
                       bound_by="bytes", library_ms=None, mufu_floor_ms=0.06,
                       ms_stateless=0.09, states_bytes=4194304), **extra}
    other = row(case="odd")
    report = {"hybrid_kernels": {"rglru": [other, row()],
                                 "rglru_bwd": [other, row(ms=0.2)]}}
    fwd, bwd = SMOKE._kernels_line(report)["kernels"]
    assert (fwd["name"], bwd["name"]) == ("rglru", "rglru_bwd")
    assert fwd["replaces"] == bwd["replaces"] \
        == "src/repro/kernels/rglru.py:23"
    assert (fwd["ms"], fwd["ms_stateless"], bwd["ms"],
            bwd["states_bytes"]) == (0.1, 0.09, 0.2, 4194304)
    assert "states_bytes" not in fwd and "ms_stateless" not in bwd
    assert not any("mufu" in k for k in (*fwd, *bwd))
    assert fwd["shape"] == {"b": 2, "s": 4096, "w": 4096}
