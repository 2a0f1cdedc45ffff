"""The port's kernels (on the CPU: their plain versions) against the JAX
package's Pallas kernels in interpret mode and their jnp oracles, and
their gradients against ``jax.grad`` of the jnp functions.

Same inputs, made with numpy from a seed, go through both frameworks.
Tolerances: f32 1e-5 abs for attention and its gradients (sums in another
order), 1e-6 for RMSNorm and its gradients; bf16 RMSNorm within one bf16
ulp (rtol 2**-7) after the cast.
"""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tmp as jtmp
from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import paged_flash_decode as jax_paged_flash
from repro.models.attention import chunked_attention as jax_chunked
from repro.models.attention import paged_decode_attention as jax_paged_ref
from repro_torch.core import tmp as ttmp
from repro_torch.core.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (FlashAttentionFunction,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_fwd,
                                                 paged_flash_decode)
from repro_torch.kernels.rmsnorm import RMSNormFunction
from repro_torch.models.attention import chunked_attention


def _paged_case(g, hd, page, kvh=2, nb=4, seed=0):
    """Five slots: pos 0, last of page 0, first of page 1, the last
    position, and a slot with an all-zero table (null page only)."""
    rng = np.random.default_rng(seed)
    b = 5
    npages = (b - 1) * nb + 1
    q = rng.standard_normal((b, 1, g * kvh, hd)).astype(np.float32)
    kp = rng.standard_normal((npages, page, kvh, hd)).astype(np.float32)
    vp = rng.standard_normal((npages, page, kvh, hd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, npages)).astype(np.int32)
    tables = np.zeros((b, nb), np.int32)
    tables[:b - 1] = perm.reshape(b - 1, nb)
    pos = np.array([0, page - 1, page, nb * page - 1, page + 3], np.int32)
    return q, kp, vp, tables, pos


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_paged_decode_matches_jax(g, hd, page, softcap):
    q, kp, vp, tables, pos = _paged_case(g, hd, page)
    got = paged_flash_decode(*(torch.from_numpy(a) for a in
                               (q, kp, vp, tables, pos)),
                             softcap=softcap).numpy()
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tables, pos)]
    kernel = np.asarray(jax_paged_flash(*jargs, softcap=softcap,
                                        interpret=True))
    oracle = np.asarray(jax_paged_ref(*jargs, softcap=softcap))
    assert got.shape == q.shape
    np.testing.assert_allclose(got, kernel, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 50, 128), (100, 256)])
def test_rms_norm_matches_jax(shape, dtype):
    """Row counts (150, 100) are not multiples of the Pallas block (64)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    s = rng.standard_normal(shape[-1]).astype(np.float32) * 0.1
    jx = jnp.asarray(x).astype(dtype)
    kernel = np.asarray(jops.rmsnorm(jx, jnp.asarray(s), interpret=True,
                                     block_rows=64).astype(jnp.float32))
    oracle = np.asarray(jtmp.rms_norm(jx, jnp.asarray(s)).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ttmp.rms_norm(tx, torch.from_numpy(s)).float().numpy()
    assert got.shape == x.shape
    if dtype == "float32":
        tol = dict(atol=1e-6, rtol=1e-6)
    else:
        tol = dict(atol=1e-6, rtol=2 ** -7)
    np.testing.assert_allclose(got, kernel, **tol)
    np.testing.assert_allclose(got, oracle, **tol)


FLASH_CASES = [
    # (g, hd, s, causal, window, softcap); s 100 is ragged against the
    # Pallas block of 32 used below
    (1, 32, 64, True, None, 0.0),
    (2, 64, 100, True, None, 0.0),
    (1, 64, 64, False, None, 0.0),
    (2, 32, 100, True, 16, 0.0),
    (2, 32, 100, True, None, 30.0),
    (1, 32, 80, False, 16, 30.0),
]


def _flash_case(g, hd, s, kvh=2, b=2, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, g * kvh, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    dout = rng.standard_normal((b, s, g * kvh, hd)).astype(np.float32)
    return q, k, v, dout


@pytest.mark.parametrize("g,hd,s,causal,window,softcap", FLASH_CASES)
def test_flash_attention_matches_jax(g, hd, s, causal, window, softcap):
    """Forward against the Pallas kernel (interpret mode) and the jnp
    oracle; gradients of the autograd Function against ``jax.grad`` of
    ``chunked_attention``."""
    q, k, v, dout = _flash_case(g, hd, s)
    kw = dict(causal=causal, window=window, softcap=softcap)
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    kernel = np.asarray(jax_flash(*jargs, block_q=32, block_k=32,
                                  interpret=True, **kw))
    oracle = np.asarray(jax_chunked(*jargs, **kw))
    jgrads = jax.grad(lambda q, k, v: jnp.sum(jax_chunked(q, k, v, **kw)
                                              * dout),
                      argnums=(0, 1, 2))(*jargs)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = chunked_attention(tq, tk, tv, **kw)
    assert isinstance(out.grad_fn, FlashAttentionFunction._backward_cls)
    (out * torch.from_numpy(dout)).sum().backward()
    got = out.detach().numpy()
    assert got.shape == q.shape
    np.testing.assert_allclose(got, kernel, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=1e-5, rtol=0)
    for t, want in zip((tq, tk, tv), jgrads):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)


def test_flash_attention_lse_and_refusals():
    """lse is log-sum-exp of the scores each query sees; positions other
    than arange(s) and shapes that do not match ([b, sq, h, hd] against
    [b, sk, kvh, hd], kvh | h) raise; sk != sq is cross attention."""
    q, k, v, dout = (torch.from_numpy(a) for a in _flash_case(2, 32, 40))
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    qh = q.reshape(2, 40, 2, 2, 32) * 32 ** -0.5
    sc = torch.einsum("bskgd,btkd->bkgst", qh, k)
    sc = sc.masked_fill(torch.ones(40, 40).triu(1).bool(), float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(sc, -1)
                               .reshape(2, 4, 40).numpy(), atol=1e-5)
    with pytest.raises(NotImplementedError, match="is not taken"):
        chunked_attention(q, k, v, q_positions=torch.arange(40) + 3)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(q, k[:1], v[:1])
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(q, k[..., :16], v[..., :16])
    assert flash_attention(q, k[:, :20], v[:, :20],
                           causal=False).shape == q.shape
    with pytest.raises(ValueError, match="same CUDA device"):
        flash_attention_fwd(q.to("meta"), k, v)
    with pytest.raises(ValueError, match="same CUDA device"):
        flash_attention_bwd(q, k, v, out, lse, dout.to("meta"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_gradient_matches_jax(dtype):
    """dx and dscale of the autograd Function against ``jax.grad`` of
    ``core/tmp.rms_norm``; 1e-6 in f32, one bf16 ulp for bf16 dx.  Eight
    rows: dscale sums them in another order than XLA, and the rounding
    of that sum grows with the row count."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 64)).astype(np.float32) * 2.0
    s = rng.standard_normal(64).astype(np.float32) * 0.1
    dy = rng.standard_normal((2, 4, 64)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    jdy = jnp.asarray(dy).astype(dtype)
    gx, gs = jax.grad(lambda x, s: jnp.sum(
        (jtmp.rms_norm(x, s) * jdy).astype(jnp.float32)),
        argnums=(0, 1))(jx, jnp.asarray(s))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    ts = torch.from_numpy(s).requires_grad_()
    y = ttmp.rms_norm(tx, ts)
    assert isinstance(y.grad_fn, RMSNormFunction._backward_cls)
    y.backward(torch.from_numpy(dy).to(y.dtype))
    assert tx.grad.dtype == tx.dtype and ts.grad.dtype == torch.float32
    if dtype == "float32":
        tol = dict(atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(ts.grad.numpy(), np.asarray(gs), **tol)
    else:
        tol = dict(atol=1e-6, rtol=2 ** -7)
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(gx.astype(jnp.float32)), **tol)


def test_cuda_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_refuse_non_cuda_device_mixes():
    """A CUDA launch needs every operand on one CUDA device; a 'meta'
    tensor is neither CPU nor CUDA and must not reach the plain version."""
    q, kp, vp, tables, pos = (torch.from_numpy(a) for a in
                              _paged_case(1, 32, 8))
    with pytest.raises(ValueError, match="same CUDA device"):
        paged_flash_decode(q.to("meta"), kp, vp, tables, pos)
    with pytest.raises(ValueError, match="same CUDA device"):
        ttmp.rms_norm(torch.zeros(2, 8, device="meta"), torch.zeros(8))
    assert _build.LAUNCHES == {"paged_decode": 0, "rmsnorm": 0,
                               "rmsnorm_bwd": 0, "flash_attention": 0,
                               "flash_attention_bwd": 0, "tile_matmul": 0,
                               "ring_matmul_rs": 0, "peer_all_reduce": 0,
                               "peer_all_gather": 0, "ring_attention": 0,
                               "ssd": 0, "ssd_bwd": 0, "moe_gmm": 0,
                               "rglru": 0, "rglru_bwd": 0,
                               "peer_reduce_scatter": 0}


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The build fails loudly (no silent fallback) when nvcc is absent."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
