"""The order of operations of the paged decode kernel
(``csrc/paged_decode.cu``) and of the RMSNorm backward kernel
(``csrc/rmsnorm.cu``), stated in plain torch and held to the port's plain
versions and to the JAX package.

Paged decode: the sequence of a slot is cut into splits of ``pps`` pages
(:func:`repro_torch.kernels.flash_attention.paged_splits`); a split that
starts past ``pos`` does nothing; each split folds chunks of tokens into
an f32 online softmax with one max and one rescale a chunk; the splits'
(m, l, acc) are merged in split order.  :func:`paged_emulation` does the
same on the CPU (the card's sums inside a chunk run in another order, so
it pins the structure, not the bits).  Tolerances: f32 1e-5 abs against
the plain version and JAX's Pallas kernel in interpret mode (sums in
another order, as ``tests/test_torch_kernels.py``); bf16 the card's gate
``PAGED_TOL["bfloat16"]`` (one bf16 ulp after the one cast).

RMSNorm backward: a group of warps walks rows ``group, group + groups,
...`` (:func:`repro_torch.kernels.rmsnorm.bwd_geometry`), each thread
summing its columns' ``dy * x * r`` in row order; a block adds its groups
in order into one partial row; the partial rows are summed per column by
8 lanes of blocks (``k, k + 8, ...``), the lanes added in order.
:func:`rmsnorm_bwd_emulation` does the same.  Tolerances: the card's gate
``RMS_BWD_TOL`` against the plain version; against ``jax.grad`` of
``repro.core.tmp.rms_norm`` 1e-5 for dx and 1e-4 for dscale (a sum of
rows of O(1) terms in another order).  Inputs are made with numpy from a
seed.
"""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import importlib.util
import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tmp as jtmp
from repro.kernels.flash_attention import paged_flash_decode as jax_paged
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rmsnorm as trms
from repro_torch.kernels.ref import paged_decode_attention_ref, rmsnorm_bwd_ref

ROOT = Path(__file__).resolve().parents[1]
NEG_INF = -1e30


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


def paged_chunk(hd: int, elt: int) -> int:
    """Tokens a stage of the kernel's shared-memory ring holds: 8 KB of K
    rows, at least 16 and at most 64 (``Geo::CHUNK``)."""
    return min(max(8192 // (hd * elt), 16), 64)


def paged_emulation(q, k_pages, v_pages, tables, pos, *, softcap=0.0,
                    scale=None, splits=None, chunk=None):
    """q [b, 1, h, hd]; k_pages/v_pages [P, page, kvh, hd]; tables [b, nb];
    pos [b] -> [b, 1, h, hd] in q's dtype, in the kernel's order: splits of
    ``splits = (pps, nsplit)`` (default :func:`paged_splits`), chunks of
    ``chunk`` tokens (default :func:`paged_chunk`), the splits merged in
    order; a pair with one active split is written from it directly."""
    b, _, h, hd = q.shape
    _, page, kvh, _ = k_pages.shape
    g, nb = h // kvh, tables.shape[1]
    scale = hd ** -0.5 if scale is None else scale
    pps, nsplit = splits or tfa.paged_splits(b, kvh, page, nb)
    assert nsplit == -(-nb // pps)
    chunk = chunk or paged_chunk(hd, q.element_size())
    kflat = k_pages.reshape(-1, kvh, hd)
    vflat = v_pages.reshape(-1, kvh, hd)
    out = torch.empty(b, kvh, g, hd)
    span = pps * page
    for bi in range(b):
        last = min(int(pos[bi]), nb * page - 1)
        n_active = 1 if last < 0 else last // span + 1
        qf = q[bi, 0].float().reshape(kvh, g, hd) * scale
        parts = []
        for sp in range(n_active):
            t0 = sp * span
            t1 = min(t0 + span, last + 1)
            m = torch.full((kvh, g), NEG_INF)
            l = torch.zeros(kvh, g)
            acc = torch.zeros(kvh, g, hd)
            for c0 in range(t0, t1, chunk):
                t = torch.arange(c0, min(c0 + chunk, t1))
                rows = tables[bi, t // page].long() * page + t % page
                k, v = kflat[rows].float(), vflat[rows].float()
                s = torch.einsum("kgd,nkd->kgn", qf, k)
                if softcap:
                    s = softcap * torch.tanh(s / softcap)
                mx = torch.maximum(m, s.amax(dim=-1))
                corr = torch.exp(m - mx)
                p = torch.exp(s - mx[..., None])
                l = l * corr + p.sum(dim=-1)
                acc = acc * corr[..., None] + torch.einsum("kgn,nkd->kgd",
                                                           p, v)
                m = mx
            parts.append((m, l, acc))
        if n_active == 1:
            _, lsum, o = parts[0]
        else:
            mx = torch.stack([p_[0] for p_ in parts]).amax(dim=0)
            lsum = torch.zeros(kvh, g)
            o = torch.zeros(kvh, g, hd)
            for m_s, l_s, acc_s in parts:
                c = torch.exp(m_s - mx)
                lsum = lsum + l_s * c
                o = o + acc_s * c[..., None]
        out[bi] = o / torch.clamp(lsum, min=1e-30)[..., None]
    return out.reshape(b, 1, h, hd).to(q.dtype)


# slots: pos 0; the last position of page 0 and the first of page 1; the
# last position of split 0 and the first of split 1 (splits of 2 pages of
# 4); the first of split 2; a pos beyond nb * page - 1 (clamped to the last
# position); an inactive slot whose all-zero table maps the null page only
PAGE, NB, PPS = 4, 6, 2
POS = [0, 3, 4, 7, 8, 16, 30, 5]
INACTIVE = 7


def _paged_case(g, hd, kvh=2, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    b = len(POS)
    npages = (b - 1) * NB + 1
    q = rng.standard_normal((b, 1, g * kvh, hd)).astype(np.float32)
    kp = rng.standard_normal((npages, PAGE, kvh, hd)).astype(np.float32)
    vp = rng.standard_normal((npages, PAGE, kvh, hd)).astype(np.float32)
    tables = np.zeros((b, NB), np.int32)
    perm = rng.permutation(np.arange(1, npages)).astype(np.int32)
    active = [i for i in range(b) if i != INACTIVE]
    tables[active] = perm.reshape(b - 1, NB)
    pos = np.array(POS, np.int32)
    arrays = (q, kp, vp, tables, pos)
    tensors = tuple(torch.from_numpy(a) for a in arrays)
    return arrays, (*(t.to(dtype) for t in tensors[:3]), *tensors[3:])


def _within(got, want, atol, rtol):
    """(max |got - want|, whether every element is within atol + rtol
    |want|), as chip_smoke.py's gate reads it."""
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), bool((diff <= atol + rtol * want.float().abs())
                                   .all())


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_paged_emulation_matches_plain_version(g, hd):
    """Splits of 2 pages, chunks of 3 tokens (so chunks cut pages and
    splits), and the kernel's own chunk: f32 within 1e-5 of the plain
    version."""
    _, (q, kp, vp, tables, pos) = _paged_case(g, hd)
    want = paged_decode_attention_ref(q, kp, vp, tables, pos)
    for chunk in (3, None):
        got = paged_emulation(q, kp, vp, tables, pos,
                              splits=(PPS, -(-NB // PPS)), chunk=chunk)
        assert got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("g,hd,softcap,pps", [
    (1, 128, 0.0, 2), (2, 32, 30.0, 2), (4, 64, 0.0, 1), (8, 128, 30.0, 3)])
def test_paged_emulation_matches_jax(g, hd, softcap, pps):
    arrays, (q, kp, vp, tables, pos) = _paged_case(g, hd, seed=1)
    got = paged_emulation(q, kp, vp, tables, pos, softcap=softcap,
                          splits=(pps, -(-NB // pps)), chunk=3).numpy()
    kernel = np.asarray(jax_paged(*(jnp.asarray(a) for a in arrays),
                                  softcap=softcap, interpret=True))
    np.testing.assert_allclose(got, kernel, atol=1e-5, rtol=0)
    want = paged_decode_attention_ref(q, kp, vp, tables, pos, softcap=softcap)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("g,hd", [(1, 128), (8, 64)])
def test_paged_emulation_bf16_within_the_cards_gate(g, hd):
    """bf16 K/V and q, f32 sums, one cast: within PAGED_TOL['bfloat16'] of
    the plain version, as the card's rows must be."""
    _, (q, kp, vp, tables, pos) = _paged_case(g, hd, dtype=torch.bfloat16,
                                              seed=2)
    got = paged_emulation(q, kp, vp, tables, pos, softcap=30.0,
                          splits=(PPS, -(-NB // PPS)))
    want = paged_decode_attention_ref(q, kp, vp, tables, pos, softcap=30.0)
    assert got.dtype == torch.bfloat16
    err, ok = _within(got, want, *SMOKE.PAGED_TOL["bfloat16"])
    assert ok, f"max abs err {err} beyond {SMOKE.PAGED_TOL['bfloat16']}"


def test_paged_splits_is_a_function_of_the_shapes():
    assert list(inspect.signature(tfa.paged_splits).parameters) == [
        "b", "kvh", "page", "nb"]
    # chip_smoke.py phase 2 (and phase 4's engine): 8 slots, page 16,
    # 128 blocks -> 16 splits of 128 positions at 8, 16 or 32 kv heads
    for kvh in (8, 16, 32):
        assert tfa.paged_splits(8, kvh, 16, 128) == (8, 16)
    # one slot of one kv head: a page a split, to fill the card
    assert tfa.paged_splits(1, 1, 16, 128) == (1, 128)
    # a small batch splits down to one page a split
    assert tfa.paged_splits(5, 2, 8, 4) == (1, 4)
    for b in (1, 3, 8, 64):
        for kvh in (1, 8, 32):
            for page in (1, 7, 16, 64):
                for nb in (1, 5, 128, 513):
                    pps, nsplit = tfa.paged_splits(b, kvh, page, nb)
                    assert (nsplit - 1) * pps < nb <= nsplit * pps
                    # at most SPLIT_POSITIONS positions, up to whole pages
                    assert pps == 1 or (pps - 1) * page < tfa.SPLIT_POSITIONS
                    if b * kvh * nb <= tfa.SPLIT_BLOCKS:
                        assert pps == 1


def test_paged_kernel_source_states_the_emulated_geometry():
    """The chunk and split constants the emulation mirrors."""
    src = (_build.CSRC / "paged_decode.cu").read_text()
    assert "C0 = 8192 / (HD * static_cast<int>(sizeof(T)))" in src
    assert "CHUNK = C0 < 16 ? 16 : (C0 > 64 ? 64 : C0)" in src
    assert "nsplit != (nb + pps - 1) / pps" in src
    assert [paged_chunk(hd, 2) for hd in (32, 64, 128)] == [64, 64, 32]
    assert [paged_chunk(hd, 4) for hd in (32, 64, 128)] == [64, 32, 16]


def rmsnorm_bwd_emulation(x, scale, dy, eps=1e-5, geometry=None):
    """(dx in x's dtype, dscale f32) in the backward kernel's order of
    operations at ``geometry = (warps a row, rows a block, blocks)``."""
    d = x.shape[-1]
    xf = x.float().reshape(-1, d)
    dyf = dy.float().reshape(-1, d)
    rows = xf.shape[0]
    wpr, rpb, nblocks = geometry or trms.bwd_geometry(rows, d)
    w = 1.0 + scale.float()
    ss = (xf * xf).sum(dim=-1, keepdim=True)
    dot = (xf * (w * dyf)).sum(dim=-1, keepdim=True)
    r = torch.rsqrt(ss / d + eps)
    mdot = dot / d
    dx = r * (w * dyf - xf * (r * r) * mdot)
    terms = dyf * xf * r
    partial = torch.zeros(nblocks, d)
    groups = nblocks * rpb
    for blk in range(nblocks):
        for grp in range(rpb):
            acc = torch.zeros(d)
            for row in range(blk * rpb + grp, rows, groups):
                acc = acc + terms[row]
            partial[blk] = acc if grp == 0 else partial[blk] + acc
    lanes = torch.zeros(8, d)
    for k in range(8):
        for blk in range(k, nblocks, 8):
            lanes[k] = lanes[k] + partial[blk]
    dscale = lanes[0]
    for k in range(1, 8):
        dscale = dscale + lanes[k]
    return dx.reshape(x.shape).to(x.dtype), dscale


def _norm_case(rows, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(np.float32) * 3.0
    dy = rng.standard_normal((rows, d)).astype(np.float32)
    s = rng.standard_normal(d).astype(np.float32) * 0.1
    return x, dy, s


# (rows, d): the vector path's geometries (d 2048: 8 warps a row, 2 rows a
# block; 768: 3 and 5; 4096: 16 and 1), a ragged d (scalar loads, masked
# columns), a wide row (a block a row), more rows than blocks x groups
NORM_CASES = [(40, 2048), (37, 768), (20, 4096), (33, 1001), (9, 4100),
              (700, 64)]


@pytest.mark.parametrize("rows,d", NORM_CASES)
def test_rmsnorm_bwd_emulation_matches_plain_version(rows, d):
    x, dy, s = _norm_case(rows, d)
    tx, tdy, ts = (torch.from_numpy(a) for a in (x, dy, s))
    dx, dscale = rmsnorm_bwd_emulation(tx, ts, tdy)
    want_dx, want_dscale = rmsnorm_bwd_ref(tx, ts, tdy)
    for name, got, want in (("dx", dx, want_dx),
                            ("dscale", dscale, want_dscale)):
        tol = SMOKE.RMS_BWD_TOL["float32"][name]
        err, ok = _within(got, want, *tol)
        assert ok, f"{name}: max abs err {err} beyond {tol}"


@pytest.mark.parametrize("rows,d", [(40, 2048), (33, 1001), (9, 4100)])
def test_rmsnorm_bwd_emulation_matches_jax(rows, d):
    """Against ``jax.grad`` of JAX's ``rms_norm`` (a vector, a ragged and
    a wide row; each case costs an XLA compile)."""
    x, dy, s = _norm_case(rows, d)
    tx, tdy, ts = (torch.from_numpy(a) for a in (x, dy, s))
    dx, dscale = rmsnorm_bwd_emulation(tx, ts, tdy)
    jdx, jds = jax.grad(
        lambda a, b: jnp.sum(jtmp.rms_norm(a, b) * jnp.asarray(dy)),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(dscale.numpy(), np.asarray(jds), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("rows,d", [(40, 2048), (33, 1001)])
def test_rmsnorm_bwd_emulation_bf16_within_the_cards_gate(rows, d):
    x, dy, s = _norm_case(rows, d, seed=1)
    tx, tdy = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, dy))
    ts = torch.from_numpy(s)
    dx, dscale = rmsnorm_bwd_emulation(tx, ts, tdy)
    want_dx, want_dscale = rmsnorm_bwd_ref(tx, ts, tdy)
    assert dx.dtype == torch.bfloat16 and dscale.dtype == torch.float32
    for name, got, want in (("dx", dx, want_dx),
                            ("dscale", dscale, want_dscale)):
        tol = SMOKE.RMS_BWD_TOL["bfloat16"][name]
        err, ok = _within(got, want, *tol)
        assert ok, f"{name}: max abs err {err} beyond {tol}"


def test_rmsnorm_bwd_geometry():
    """Rows of d <= 4096 fit a group's registers (8 columns a thread);
    at most 16 warps a block; no more blocks than row groups need."""
    assert trms.bwd_geometry(4096, 2048) == (8, 2, 132)
    assert trms.bwd_geometry(4096, 4096) == (16, 1, 132)
    assert trms.bwd_geometry(4096, 1536) == (6, 2, 132)
    assert trms.bwd_geometry(4096, 768) == (3, 5, 132)
    assert trms.bwd_geometry(1000, 1001) == (4, 4, 132)
    assert trms.bwd_geometry(100, 4096) == (16, 1, 100)
    assert trms.bwd_geometry(8, 4096) == (16, 1, 8)
    for rows in (1, 7, 300, 100_000):
        for d in (1, 63, 256, 257, 1001, 4096, 4097, 20_000):
            wpr, rpb, nblocks = trms.bwd_geometry(rows, d)
            assert 1 <= wpr * rpb <= trms.BWD_WARPS
            if d <= trms.BWD_WARPS * 32 * trms.BWD_COLS:
                assert (wpr - 1) * 32 * trms.BWD_COLS < d \
                    <= wpr * 32 * trms.BWD_COLS
            else:
                assert (wpr, rpb) == (trms.BWD_WARPS, 1)
            assert 1 <= nblocks <= min(-(-rows // rpb), trms.BWD_BLOCKS)


def test_rmsnorm_fwd_geometry():
    """The forward holds a row in 32 x 16 bf16 (32 x 8 f32) columns a
    warp, 16 warps a block, a block for every 16 / W rows; wider rows take
    the backward's block a row."""
    assert trms.fwd_geometry(4096, 2048, 2) == (4, 4, 1024)
    assert trms.fwd_geometry(4096, 2048, 4) == (8, 2, 2048)
    assert trms.fwd_geometry(4096, 1536, 2) == (3, 5, 820)
    assert trms.fwd_geometry(4096, 768, 2) == (2, 8, 512)
    assert trms.fwd_geometry(8, 4096, 2) == (8, 2, 4)
    assert trms.fwd_geometry(8, 4096, 4) == (16, 1, 8)
    assert trms.fwd_geometry(1000, 1001, 4) == (4, 4, 250)
    assert trms.fwd_geometry(1000, 8192, 2) == trms.bwd_geometry(1000, 8192)
    for elt in (2, 4):
        cols = 32 * trms.FWD_VECS * 16 // elt        # a warp's columns
        for rows in (1, 7, 300, 100_000):
            for d in (1, 63, 256, 257, 1001, 2048, 4096):
                wpr, rpb, nblocks = trms.fwd_geometry(rows, d, elt)
                assert (wpr - 1) * cols < d <= wpr * cols
                assert 1 <= wpr * rpb <= trms.FWD_WARPS
                assert nblocks == -(-rows // rpb)


def test_smoke_build_report_lists_the_ssd_and_norm_forward_kernels():
    """Phase 1 also parses the SSD kernels' and the RMSNorm forward's
    instances (a template flag as 0 or 1), apart from the other groups."""
    assert len(SMOKE.SSD_NORM_KERNELS) == 18
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116"
        "ssd_state_kernelI13__nv_bfloat16Lb1EEEvPKT_PKfS6_S4_PfS7_iiiii' "
        "for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114"
        "rmsnorm_kernelIfLb0EEEvPKT_PKfPS2_lif' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, 128 bytes smem",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120"
        "ssd_bwd_chunk_kernelIfEEvPKT_PKfS5_S3_S3_S5_S3_S5_S5_S5_PS1_PfS7_"
        "S7_S7_S7_iiiii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 200 registers",
    ])
    rep = SMOKE._kernel_report(log, SMOKE._SSD_NORM_NAMES)
    assert sorted(rep) == ["rmsnorm_kernel<f32,0>",
                           "ssd_bwd_chunk_kernel<f32>",
                           "ssd_state_kernel<bf16,1>"]
    assert set(rep) <= set(SMOKE.SSD_NORM_KERNELS)
    assert not SMOKE._kernel_report(log, SMOKE._CC_NAMES)


def test_smoke_build_report_lists_the_redesigned_kernels():
    """chip_smoke.py phase 1 parses ptxas's report of every instance the
    wrappers can launch, and a spill fails the run."""
    assert len(SMOKE.CC_KERNELS) == 2 * len(tfa.PAGED_HEAD_DIMS) \
        * len(tfa.GROUPS) + 6
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119"
        "paged_decode_kernelI13__nv_bfloat16Li128ELi8EEEvPKT_S4_S4_PKiS6_"
        "PS2_PfPiiiiiiffb' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_1",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 96 registers, 34816 bytes smem",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118"
        "rmsnorm_bwd_kernelIfLb1EEEvPKT_PKfS4_PS2_Pflif' for 'sm_90a'",
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 128 registers, 18432 bytes smem",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123"
        "rmsnorm_bwd_wide_kernelI13__nv_bfloat16EEvPKT_PKfS4_PS2_Pflif' "
        "for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 30 registers, 256 bytes smem",
    ])
    rep = SMOKE._kernel_report(log, SMOKE._CC_NAMES)
    assert sorted(rep) == ["paged_decode_kernel<bf16,128,8>",
                           "rmsnorm_bwd_kernel<f32,1>",
                           "rmsnorm_bwd_wide_kernel<bf16>"]
    assert set(rep) <= set(SMOKE.CC_KERNELS)
    assert rep["rmsnorm_bwd_kernel<f32,1>"]["spill_stores"] == 8
    assert rep["paged_decode_kernel<bf16,128,8>"]["usage"].startswith(
        "Used 96 registers")
    assert not SMOKE._kernel_report(log, SMOKE._TC_NAMES)
    # the tensor-core names keep their form
    tc = SMOKE._kernel_report(
        "Compiling entry function '_ZN5repro19flash_fwd_tc_kernelILi64EEEv'"
        "\n    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
        "\nptxas info    : Used 90 registers", SMOKE._TC_NAMES)
    assert list(tc) == ["flash_fwd_tc_kernel<64>"]
    assert re.fullmatch(r"Used \d+ registers", tc["flash_fwd_tc_kernel<64>"][
        "usage"])
